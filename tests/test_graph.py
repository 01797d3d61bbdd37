import os

import numpy as np
import pytest

from make_fixtures import make
from dashing2_tpu.io import formats


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("fa_graph")
    return make(str(d), n_genomes=10, length=12000)


def run_cli(args):
    from dashing2_tpu.cli import main
    return main(args)


def test_knn_graph_csr(fixtures, tmp_path):
    out = tmp_path / "knn.bin"
    rc = run_cli(["sketch", "-k", "21", "-S", "512", "--topk", "3",
                  "--binary-output", "--cmpout", str(out)] + fixtures)
    assert rc == 0
    indptr, indices, data = formats.read_knn_csr(str(out))
    n = len(fixtures)
    assert len(indptr) == n + 1
    # every node should have neighbors (all genomes are related)
    counts = np.diff(indptr.astype(np.int64))
    assert (counts >= 1).all()
    assert (counts <= 4).all()  # topk=3 plus possible kth ties
    # neighbor similarity values positive, sorted best-first per row
    for i in range(n):
        row = data[int(indptr[i]):int(indptr[i + 1])]
        assert (row > 0).all()
        assert (np.diff(row) <= 1e-6).all()
    # genome 1's top neighbor should be genome 0 or 2 (closest mutants)
    row0 = indices[int(indptr[1]):int(indptr[1 + 1])]
    assert row0[0] in (0, 2)


def test_knn_matches_exact_oracle(fixtures, tmp_path):
    out_lsh = tmp_path / "lsh.bin"
    out_exact = tmp_path / "exact.bin"
    args = ["sketch", "-k", "21", "-S", "512", "--topk", "2",
            "--binary-output"] + fixtures
    run_cli(args + ["--cmpout", str(out_lsh)])
    os.environ["EXACT_KNN"] = "1"
    try:
        run_cli(args + ["--cmpout", str(out_exact)])
    finally:
        del os.environ["EXACT_KNN"]
    ip1, id1, d1 = formats.read_knn_csr(str(out_lsh))
    ip2, id2, d2 = formats.read_knn_csr(str(out_exact))
    # recall: LSH should recover most exact top-2 neighbors
    hits = 0
    total = 0
    n = len(ip1) - 1
    for i in range(n):
        s1 = set(id1[int(ip1[i]):int(ip1[i + 1])].tolist())
        s2 = set(id2[int(ip2[i]):int(ip2[i + 1])].tolist())
        total += len(s2)
        hits += len(s1 & s2)
    assert total > 0
    assert hits / total >= 0.8, (hits, total)


def test_threshold_graph(fixtures, tmp_path):
    out = tmp_path / "thr.bin"
    rc = run_cli(["sketch", "-k", "21", "-S", "512",
                  "--similarity-threshold", "0.5", "--binary-output",
                  "--cmpout", str(out)] + fixtures)
    assert rc == 0
    indptr, indices, data = formats.read_knn_csr(str(out))
    assert (data >= 0.5).all()


def test_dedup_clusters(fixtures, tmp_path):
    # duplicate some genomes so dedup has something to merge
    inputs = fixtures + fixtures[:3]
    out = tmp_path / "dedup.bin"
    rc = run_cli(["sketch", "-k", "21", "-S", "512", "--greedy", "0.95",
                  "--binary-output", "--cmpout", str(out)] + inputs)
    assert rc == 0
    clusters = formats.read_clustering(str(out))
    total = sum(len(c) for c in clusters)
    assert total == len(inputs)
    # the duplicated genomes must share clusters with their originals
    nc = len(clusters)
    assert nc < len(inputs)
    # each duplicated index (10,11,12) in same cluster as (0,1,2)
    member_of = {}
    for ci, c in enumerate(clusters):
        for x in c:
            member_of[int(x)] = ci
    for dup, orig in ((10, 0), (11, 1), (12, 2)):
        assert member_of[dup] == member_of[orig], (dup, orig, clusters)


def test_device_pair_path_matches_host(fixtures, tmp_path, monkeypatch):
    """DASHING2_TPU_PAIR_DEVICE=force routes refine/dedup pair counts
    through the device SWAR engines (pack10/rank-pack16) even on the CPU
    backend; outputs must be byte-identical to the host pair path for
    both the KNN graph and greedy dedup, across default and fastcmp-1
    representations."""
    for args in (
        ["sketch", "-k", "21", "-S", "512", "--topk", "3",
         "--binary-output"],
        ["sketch", "-k", "21", "-S", "512", "--fastcmp", "1",
         "--bbit-sigs", "--topk", "3", "--binary-output"],
        ["sketch", "-k", "21", "-S", "512", "--greedy", "0.95",
         "--binary-output"],
    ):
        host_out = tmp_path / "host.bin"
        dev_out = tmp_path / "dev.bin"
        monkeypatch.delenv("DASHING2_TPU_PAIR_DEVICE", raising=False)
        assert run_cli(args + ["--cmpout", str(host_out)] + fixtures) == 0
        monkeypatch.setenv("DASHING2_TPU_PAIR_DEVICE", "force")
        assert run_cli(args + ["--cmpout", str(dev_out)] + fixtures) == 0
        assert host_out.read_bytes() == dev_out.read_bytes(), args
        # memoized count-matrix route (full self-pairs matrix + flat
        # extraction) must also be byte-identical
        mat_out = tmp_path / "mat.bin"
        monkeypatch.setenv("DASHING2_TPU_PAIR_MATRIX", "force")
        assert run_cli(args + ["--cmpout", str(mat_out)] + fixtures) == 0
        monkeypatch.delenv("DASHING2_TPU_PAIR_MATRIX")
        assert host_out.read_bytes() == mat_out.read_bytes(), args


def test_dedup_human_output(fixtures, tmp_path):
    out = tmp_path / "dedup.txt"
    run_cli(["sketch", "-k", "21", "-S", "256", "--greedy", "0.99",
             "--cmpout", str(out)] + fixtures[:4])
    text = out.read_text()
    assert text.startswith("#Clustering 4 items")
    assert "Cluster-0\t" in text


def test_knn_human_output(fixtures, tmp_path):
    out = tmp_path / "knn.txt"
    run_cli(["sketch", "-k", "21", "-S", "256", "--topk", "2",
             "--cmpout", str(out)] + fixtures[:4])
    lines = out.read_text().splitlines()
    assert lines[0].startswith("#Collection")
    assert len(lines) == 5


def test_myers_edit_distance():
    from dashing2_tpu.cmp.editdist import myers_edit_distance, span_edit_distance
    import random
    random.seed(3)

    def slow(a, b):
        dp = list(range(len(b) + 1))
        for i in range(1, len(a) + 1):
            prev = dp[0]
            dp[0] = i
            for j in range(1, len(b) + 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                            prev + (a[i - 1] != b[j - 1]))
                prev = cur
        return dp[-1]

    for _ in range(30):
        la = random.randint(0, 120)
        lb = random.randint(0, 120)
        a = bytes(random.choice(b"ACGT") for _ in range(la))
        b = bytes(random.choice(b"ACGT") for _ in range(lb))
        assert myers_edit_distance(a, b) == slow(a, b), (a, b)
    # span DP agrees with slow too
    xa = np.array([1, 2, 3, 4, 5], np.uint64)
    xb = np.array([1, 3, 4, 5, 6], np.uint64)
    assert span_edit_distance(xa, xb) == 2


def test_exact_set_topk_bottomk_lsh(fixtures, tmp_path):
    """Use 7 (README:254-267): KNN over exact k-mer sets with bottom-k
    LSH candidate generation."""
    out = tmp_path / "setknn.csr"
    rc = run_cli(["sketch", "-k", "31", "-S", "128", "--set", "--topk", "2",
                  "--binary-output", "--cmpout", str(out)] + fixtures)
    assert rc == 0
    from dashing2_tpu.io.formats import read_knn_csr
    indptr, indices, data = read_knn_csr(str(out))
    assert len(indptr) == len(fixtures) + 1
    assert (data >= 0).all() and (data <= 1).all()
    # closest fixtures (adjacent mutation rates) should be neighbors
    assert 1 in indices[int(indptr[0]):int(indptr[1])]


def test_edit_distance_knn(fixtures, tmp_path):
    """Use 6 (README:241-250): OMH LSH + exact edit-distance refinement."""
    out = tmp_path / "edknn.csr"
    rc = run_cli(["sketch", "-k", "7", "-S", "64", "--parse-by-seq",
                  "--edit-distance", "--compute-edit-distance",
                  "--topk", "2", "--binary-output", "--cmpout", str(out)]
                 + fixtures)
    assert rc == 0
    from dashing2_tpu.io.formats import read_knn_csr
    indptr, indices, data = read_knn_csr(str(out))
    assert (data >= 0).all()


def test_refine_exact_drops_compression(fixtures, tmp_path):
    """--refine-exact: LSH candidates over compressed registers, final
    values re-scored on full registers (refine.cpp:10-16). The refined
    KNN distances must equal the uncompressed run's."""
    base = ["sketch", "-k", "21", "-S", "256", "--topk", "2",
            "--binary-output"]
    o1 = tmp_path / "full.csr"
    o2 = tmp_path / "refined.csr"
    run_cli(base + ["--cmpout", str(o1)] + fixtures)
    run_cli(base + ["--fastcmp", "1", "--refine-exact",
                    "--cmpout", str(o2)] + fixtures)
    from dashing2_tpu.io.formats import read_knn_csr
    p1, i1, d1 = read_knn_csr(str(o1))
    p2, i2, d2 = read_knn_csr(str(o2))
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)  # exact re-scoring == full run


def test_refine_exact_kmer_sets(fixtures, tmp_path):
    """--set --refine-exact: candidates via bottom-k LSH, final values
    from exact sorted-set intersections."""
    out = tmp_path / "setref.csr"
    rc = run_cli(["sketch", "-k", "21", "-S", "128", "--set",
                  "--refine-exact", "--topk", "2", "--binary-output",
                  "--cmpout", str(out)] + fixtures)
    assert rc == 0
    from dashing2_tpu.io.formats import read_knn_csr
    _, _, data = read_knn_csr(str(out))
    assert (data >= 0).all() and (data <= 1).all()


def test_dedup_batched_rounds_match_serial(fixtures, tmp_path):
    """Chunked-round dedup must match chunk=1 (the serial greedy walk)
    on both the LSH and exhaustive paths."""
    import dashing2_tpu.cmp.graph as G
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.sketch.core import sketch_fastx

    inputs = fixtures + fixtures[:4]
    for exhaustive in (False, True):
        # non-binding candidate cap: the round batching preserves the
        # serial result exactly only when the per-item cap is not the
        # binding constraint (see dedup_core docstring)
        opts = Dashing2DistOptions(k=21, sketchsize=256,
                                   min_similarity=0.9, maxcand=1000,
                                   exhaustive_dedup=exhaustive)
        result = sketch_fastx(opts, inputs)
        creps, result = C._prep(opts, result)
        os.environ["DASHING2_TPU_DEDUP_CHUNK"] = "1"
        try:
            ids1, cons1 = G.dedup_core(opts, result, creps)
        finally:
            os.environ["DASHING2_TPU_DEDUP_CHUNK"] = "5"
        try:
            ids2, cons2 = G.dedup_core(opts, result, creps)
        finally:
            del os.environ["DASHING2_TPU_DEDUP_CHUNK"]
        assert ids1 == ids2, exhaustive
        assert cons1 == cons2, exhaustive


def test_dedup_chunk_size_invariance_uncapped(tmp_path, monkeypatch):
    """In the UNCAPPED regime (per-item candidate
    cap not binding) the clustering is invariant across
    DASHING2_TPU_DEDUP_CHUNK — a clustered 64-item corpus (8 families
    x 8 mutated copies) produces the identical (ids, constituents)
    for chunks 1, 3, 17, 64 and 1024. The capped-regime envelope is
    documented with a measured example in README ('dedup batching')."""
    import random

    import dashing2_tpu.cmp.graph as G
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.sketch.core import sketch_fastx

    random.seed(13)
    paths = []
    for fam in range(8):
        base = "".join(random.choice("ACGT") for _ in range(4000))
        for rep in range(8):
            s = list(base)
            for _ in range(rep * 15):
                s[random.randrange(len(s))] = random.choice("ACGT")
            p = str(tmp_path / f"f{fam}r{rep}.fa")
            with open(p, "w") as f:
                f.write(f">f{fam}r{rep}\n{''.join(s)}\n")
            paths.append(p)
    opts = Dashing2DistOptions(k=21, sketchsize=256,
                               min_similarity=0.85, maxcand=10_000)
    result = sketch_fastx(opts, paths)
    creps, result = C._prep(opts, result)
    ref = None
    for chunk in (1, 3, 17, 64, 1024):
        monkeypatch.setenv("DASHING2_TPU_DEDUP_CHUNK", str(chunk))
        got = G.dedup_core(opts, result, creps)
        if ref is None:
            ref = got
        else:
            assert got == ref, f"chunk={chunk} diverged"


def test_lsh_intra_candidates_match_insert_query():
    """intra_candidates must find exactly the pairs that incremental
    insert-then-query would connect (same buckets)."""
    from dashing2_tpu.cmp.lsh import LSHIndex
    rng = np.random.default_rng(0)
    base = rng.normal(size=(1, 64))
    regs = np.repeat(base, 12, axis=0) + np.where(
        rng.random((12, 64)) < 0.3, rng.normal(size=(12, 64)), 0.0)
    regs[6:] = rng.normal(size=(6, 64))  # unrelated tail
    idx = LSHIndex.build(regs, 2)
    items = np.arange(12)
    lo, hi = idx.intra_candidates(items)
    got = set(zip(lo.tolist(), hi.tolist()))
    # reference: incremental insert + query
    ref = set()
    idx2 = LSHIndex.build(regs, 2)
    for i in range(12):
        for c in idx2.query(i, 1000).tolist():
            ref.add((min(c, i), max(c, i)))
        idx2.insert(i, i)
    assert got == ref


def test_seq_editdist_topk(fixtures, tmp_path):
    """--seq minimizer sequences + --topk uses the bottom-k minimizer
    LSH (previously crashed: no index source for FULL_MMER_SEQUENCE)."""
    out = tmp_path / "seqknn.bin"
    rc = run_cli(["sketch", "-k", "21", "-S", "64", "--seq", "--topk", "2",
                  "--exact-kmer-dist", "--binary-output",
                  "--cmpout", str(out)] + fixtures)
    assert rc == 0
    from dashing2_tpu.io import formats
    indptr, indices, data = formats.read_knn_csr(str(out))
    assert len(indptr) == len(fixtures) + 1
    assert (np.diff(indptr.astype(np.int64)) >= 1).all()
    # distances: genome 1's nearest neighbors should include 0 or 2
    row1 = indices[int(indptr[1]):int(indptr[1 + 1])]
    assert row1[0] in (0, 2)
