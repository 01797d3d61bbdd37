"""Multi-host driver tests on the single-process CPU mesh (true
multi-process needs N machines; the per-host logic is exercised by
simulating each host's call)."""

import numpy as np
import pytest

from make_fixtures import make
from dashing2_tpu.config import Dashing2DistOptions
from dashing2_tpu.parallel import distributed as D


def _worker_env():
    """Environment of a dist_worker.py subprocess: one CPU device, and the
    repo root on its import path (the worker runs as a script, so its
    own directory, tests/, is all Python would search)."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("fa_dist")
    return make(str(d), n_genomes=6, length=6000)


def test_shard_paths_balanced_and_disjoint(fixtures):
    seen = []
    for pi in range(3):
        mine, idx = D.shard_paths(fixtures, pi, 3)
        assert len(mine) == 2
        assert [fixtures[i] for i in idx] == mine
        seen.extend(idx)
    assert sorted(seen) == list(range(6))


def test_my_row_range_covers():
    spans = [D.my_row_range(10, pi, 3) for pi in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == 10
    for (a, b), (c, d) in zip(spans, spans[1:]):
        assert b == c


def test_distributed_matches_single_node(fixtures, tmp_path):
    """Simulate every host of a 3-host job in one process; the
    concatenated row blocks must equal the single-node matrix."""
    opts = Dashing2DistOptions(k=21, sketchsize=256)
    n = len(fixtures)
    full_sigs = np.zeros((n, 256))
    full_cards = np.zeros(n)
    covered = np.zeros(n, bool)
    for pi in range(3):
        # simulate host pi: sketch its shard, scatter into the full matrix
        # (in a real multi-process run allgather_sketches does this via
        # process_allgather; single-process it fills only local rows)
        my_groups, my_idx = D.shard_paths(fixtures, pi, 3)
        from dashing2_tpu.sketch.core import sketch_fastx
        local = sketch_fastx(opts, my_groups)
        sigs, cards = D.allgather_sketches(
            local.signatures, local.cardinalities, my_idx, n)
        full_sigs[my_idx] = sigs[my_idx]
        full_cards[my_idx] = cards[my_idx]
        covered[my_idx] = True
    assert covered.all()
    # single-node reference matrix
    from dashing2_tpu.cmp.core import pairwise_matrix
    from dashing2_tpu.result import SketchingResult
    full = SketchingResult(names=list(fixtures))
    full.signatures = full_sigs
    full.cardinalities = full_cards
    ref = np.vstack([b for _, b in pairwise_matrix(opts, full)])

    # per-host row blocks via the driver (single process -> pc=1), so
    # emulate the row split manually
    from dashing2_tpu.cmp.core import _measure_block, _prep
    creps, full = _prep(opts, full)
    rows_all = []
    for pi in range(3):
        lo, hi = D.my_row_range(len(fixtures), pi, 3)
        rows_all.append(_measure_block(opts, full, creps,
                                       np.arange(lo, hi),
                                       np.arange(len(fixtures))))
    got = np.vstack(rows_all)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)


def test_distributed_driver_single_process(fixtures, tmp_path):
    opts = Dashing2DistOptions(k=21, sketchsize=256)
    out = str(tmp_path / "dist.bin")
    block = D.distributed_sketch_cmp(opts, fixtures, outfile=out)
    assert block.shape == (len(fixtures), len(fixtures))
    import glob
    files = glob.glob(out + ".rows.*")
    assert len(files) == 1
    disk = np.fromfile(files[0], np.float32).reshape(len(fixtures), -1)
    np.testing.assert_array_equal(disk, block)


def test_two_process_jax_distributed(fixtures, tmp_path):
    """REAL multi-process: two jax.distributed CPU processes (gloo
    collectives) each sketch their input shard, all-gather sketches via
    multihost_utils.process_allgather, compute their owned row block,
    and write it; the concatenation must equal the single-node matrix."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "dist.bin")
    here = os.path.dirname(__file__)
    env = _worker_env()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "dist_worker.py"),
         str(pid), "2", str(port), out] + list(fixtures),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]

    n = len(fixtures)
    from dashing2_tpu.parallel.distributed import my_row_range
    blocks = []
    for pid in range(2):
        lo, hi = my_row_range(n, pid, 2)
        blk = np.fromfile(f"{out}.rows.{lo}-{hi}", np.float32)
        blocks.append(blk.reshape(hi - lo, n))
    got = np.concatenate(blocks)

    # single-node reference through the production compare path
    from dashing2_tpu.cmp.core import pairwise_matrix
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.sketch.core import sketch_fastx
    opts = Dashing2DistOptions(k=21, sketchsize=128)
    res = sketch_fastx(opts, list(fixtures))
    ref = np.concatenate([b for _, b in pairwise_matrix(opts, res)])
    assert got.shape == ref.shape
    assert np.allclose(got, ref, atol=1e-6), np.abs(got - ref).max()


def test_distributed_lsh_candidates_match_single(fixtures):
    """Column-sharded candidate generation merged across simulated hosts
    must equal a single unsaturated run exactly, and the distributed
    KNN lists must match the single-host graph byte-for-byte."""
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.cmp.graph import _index_source, _refine_lists
    from dashing2_tpu.cmp.lsh import merge_candidate_shards
    from dashing2_tpu.sketch.core import sketch_fastx

    opts = Dashing2DistOptions(k=21, sketchsize=256, num_neighbors=2)
    result = sketch_fastx(opts, list(fixtures))
    creps, result = C._prep(opts, result)
    n = result.n
    idx = _index_source(opts, result, creps)
    ntoquery = min(n - 1, int(2 * 3.5))

    ia1, ib1, c1 = idx.candidate_pairs(max_per_item=ntoquery,
                                       column_shard=(0, 1))
    from dashing2_tpu.cmp.lsh import cap_per_item
    ia1, ib1, c1 = cap_per_item(ia1, ib1, c1, ntoquery)

    shards = [idx.candidate_pairs(max_per_item=ntoquery,
                                  column_shard=(h, 3)) for h in range(3)]
    ia3, ib3, c3 = merge_candidate_shards(shards, n, ntoquery)
    assert np.array_equal(ia1, ia3)
    assert np.array_equal(ib1, ib3)
    assert np.array_equal(c1, c3)

    # end-to-end simulated-host KNN == single-host refine on same pairs
    from dashing2_tpu.parallel.distributed import distributed_neighbor_lists
    lists_d = distributed_neighbor_lists(opts, result, creps,
                                         process_index=0, process_count=3)
    lists_s = _refine_lists(opts, result, creps, ia1, ib1)
    assert lists_d == lists_s


def test_distributed_lsh_candidates_bottomk(fixtures):
    """Sharded bottom-k (exact-mode) candidates merge to the single run."""
    from dashing2_tpu.cmp.lsh import (LSHIndex, cap_per_item,
                                      merge_candidate_shards)
    rng = np.random.default_rng(5)
    uni = rng.integers(0, 300, size=600).astype(np.uint64)
    bk = [np.unique(rng.choice(uni, size=40)) for _ in range(12)]
    idx = LSHIndex.build(np.zeros((0, 0)), 2, bottomk=bk)
    ia1, ib1, c1 = idx.candidate_pairs(max_per_item=4, column_shard=(0, 1))
    ia1, ib1, c1 = cap_per_item(ia1, ib1, c1, 4)
    shards = [idx.candidate_pairs(max_per_item=4, column_shard=(h, 4))
              for h in range(4)]
    ia4, ib4, c4 = merge_candidate_shards(shards, 12, 4)
    assert np.array_equal(ia1, ia4) and np.array_equal(ib1, ib4)
    assert np.array_equal(c1, c4)


def test_two_process_distributed_knn(fixtures, tmp_path):
    """2-process distributed KNN: shards gathered via
    process_allgather, merged identically on both hosts; results must
    match each other AND the simulated-shard single-process run."""
    import os
    import pickle
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "dk")
    here = os.path.dirname(__file__)
    env = _worker_env()
    env["D2_WORKER_MODE"] = "knn"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "dist_worker.py"),
         str(pid), "2", str(port), out] + list(fixtures),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    with open(f"{out}.knn.0", "rb") as f:
        l0 = pickle.load(f)
    with open(f"{out}.knn.1", "rb") as f:
        l1 = pickle.load(f)
    assert l0 == l1

    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.parallel.distributed import distributed_neighbor_lists
    from dashing2_tpu.sketch.core import sketch_fastx
    opts = Dashing2DistOptions(k=21, sketchsize=128, num_neighbors=2)
    result = sketch_fastx(opts, list(fixtures))
    creps, result = C._prep(opts, result)
    ref = distributed_neighbor_lists(opts, result, creps,
                                     process_index=0, process_count=2)
    assert l0 == ref


def test_distributed_dedup_matches_single(fixtures):
    """Simulated-host distributed dedup (column-sharded candidates,
    merged, deterministic replay) must equal the single-host walk over
    the single unsaturated capped candidate set — and the plain
    single-host dedup whenever saturation does not bind."""
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.cmp.graph import _index_source, dedup_core
    from dashing2_tpu.cmp.lsh import default_candidates, merge_candidate_shards
    from dashing2_tpu.parallel.distributed import distributed_dedup
    from dashing2_tpu.sketch.core import sketch_fastx

    opts = Dashing2DistOptions(k=21, sketchsize=128, min_similarity=0.5)
    result = sketch_fastx(opts, list(fixtures))
    creps, result = C._prep(opts, result)
    n = result.n
    maxc = max(default_candidates(n, opts.maxcand) * 4, 64)
    idx = _index_source(opts, result, creps)
    cand1 = merge_candidate_shards(
        [idx.candidate_pairs(max_per_item=maxc, column_shard=(0, 1))],
        n, maxc)
    ref = dedup_core(opts, result, creps, cand_pairs=cand1)
    for pc in (2, 3):
        got = distributed_dedup(opts, result, creps,
                                process_index=0, process_count=pc)
        assert got == ref
    plain = dedup_core(opts, result, creps)
    assert plain == ref  # saturation does not bind on this corpus


def test_two_process_distributed_dedup(fixtures, tmp_path):
    """2-process distributed dedup over gloo: both hosts must emit
    byte-identical clusters, equal to the simulated-shard run."""
    import os
    import pickle
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "dd")
    here = os.path.dirname(__file__)
    env = _worker_env()
    env["D2_WORKER_MODE"] = "dedup"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "dist_worker.py"),
         str(pid), "2", str(port), out] + list(fixtures),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    with open(f"{out}.dedup.0", "rb") as f:
        d0 = pickle.load(f)
    with open(f"{out}.dedup.1", "rb") as f:
        d1 = pickle.load(f)
    assert d0 == d1

    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.parallel.distributed import distributed_dedup
    from dashing2_tpu.sketch.core import sketch_fastx
    opts = Dashing2DistOptions(k=21, sketchsize=128, min_similarity=0.5)
    result = sketch_fastx(opts, list(fixtures))
    creps, result = C._prep(opts, result)
    ref = distributed_dedup(opts, result, creps,
                            process_index=0, process_count=2)
    assert list(d0[0]) == list(ref[0])
    assert [list(x) for x in d0[1]] == [list(x) for x in ref[1]]


def test_distributed_block_swar_route_matches(fixtures):
    """The SWAR row-block engine (_block_matrix_swar_fn: shared rank
    space + rectangular packed counts) must equal the u64 block engine
    for every kind the multi-host driver routes."""
    from dashing2_tpu.cmp.core import (_block_matrix_fn,
                                       _block_matrix_swar_fn, _gb_args)
    from dashing2_tpu.enums import Measure

    rng = np.random.default_rng(17)
    n, m = 120, 128
    for kind, fd, dt in [("full", 8.0, np.uint64),
                         ("eqfull", 8.0, np.uint64),
                         ("ab", 1.0, np.uint64),
                         ("bbit", 2.0, np.uint64),
                         # compressed-register dtypes: direct value
                         # packing (no rank pass) in the swar engine
                         ("ab", 1.0, np.uint8),
                         ("ab", 2.0, np.uint16),
                         ("bbit", 1.0, np.uint8),
                         ("bbit", 2.0, np.uint16)]:
        hi_v = min(int(np.iinfo(dt).max) + 1, 1 << 62)
        data = rng.integers(0, hi_v, size=(n, m)).astype(dt)
        data[rng.random((n, m)) < 0.3] = data[0, 0]
        cards = rng.uniform(1e3, 1e5, size=n)
        gbt, gbinv = _gb_args(1.2, m)
        lo, hi = 30, 80
        f1 = _block_matrix_fn(kind, m, Measure.SIMILARITY, 31, fd)
        a = np.asarray(f1(data[lo:hi], data, cards[lo:hi], cards,
                          np.float64(1.2), gbt, gbinv))
        f2 = _block_matrix_swar_fn(kind, m, Measure.SIMILARITY, 31, fd,
                                   lo, hi)
        b = np.asarray(f2(data, cards[lo:hi], cards, np.float64(1.2),
                          gbt, gbinv))
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6,
                                   err_msg=kind)
