"""End-to-end benchmarks for the five BASELINE.md configurations.

Each config runs the real pipeline (sketch -> compare -> emit) through
the library entry points on generated fixtures and reports wall-clock
phase times, sketching throughput (bases/s) and comparison throughput
(unique pairs/s). Prints one JSON line per config plus a summary line.

Scale knobs (defaults are CI-sized; the README numbers use the env):
  DASHING2_TPU_BENCH_N       genomes for configs 1/2/4/5 (default 200)
  DASHING2_TPU_BENCH_LEN     genome length (default 200_000)
  DASHING2_TPU_BENCH_TOPK_N  genomes for the LSH graph config (default
                             = BENCH_N; the north-star uses 10000)

Usage: python bench_e2e.py [config ...]   (default: all five)
"""

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

N = int(os.environ.get("DASHING2_TPU_BENCH_N", 200))
LEN = int(os.environ.get("DASHING2_TPU_BENCH_LEN", 200_000))
TOPK_N = int(os.environ.get("DASHING2_TPU_BENCH_TOPK_N", N))


def _gen_fastas(d, n, length, seed=7):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from make_fixtures import make
    return make(d, n_genomes=n, length=length, seed=seed)


def _gen_bed_bw(d):
    from dashing2_tpu.io import bigwig as BW
    rng = np.random.default_rng(3)
    beds = []
    for i in range(8):
        p = os.path.join(d, f"iv{i}.bed")
        with open(p, "w") as f:
            pos = np.sort(rng.integers(0, 1_000_000, size=400))
            for s in pos:
                f.write(f"chr1\t{s}\t{s + int(rng.integers(50, 500))}\n")
        beds.append(p)
    del BW
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from test_subcommands import _write_minimal_bigwig
    bws = []
    for i in range(4):
        p = os.path.join(d, f"cov{i}.bw")
        starts = np.sort(rng.choice(9000, size=200, replace=False)) * 100
        iv = [(int(s), int(s) + 100, float(rng.random() + 0.1))
              for s in starts]
        _write_minimal_bigwig(p, intervals=tuple(iv))
        bws.append(p)
    return beds, bws


def _emit(name, **fields):
    print(json.dumps({"config": name, **fields}), flush=True)
    return fields


def _pairs(n):
    return n * (n - 1) / 2


def bench_default(d):
    """Config 1: default OPH SetSketch, all-pairs PHYLIP."""
    from dashing2_tpu.cli import main
    fas = _gen_fastas(os.path.join(d, "c1"), N, LEN)
    out = os.path.join(d, "c1.phy")
    t0 = time.perf_counter()
    rc = main(["sketch", "-k", "31", "-S", "1024", "--cmpout", out] + fas)
    dt = time.perf_counter() - t0
    assert rc == 0
    return _emit("default-setsketch", n=N, seconds=round(dt, 3),
                 bases_per_s=round(N * LEN / dt),
                 pairs_per_s=round(_pairs(N) / dt))


def bench_weighted(d):
    from dashing2_tpu.cli import main
    fas = _gen_fastas(os.path.join(d, "c2"), N, LEN)
    res = {}
    for flag, nm in (("--multiset", "bagminhash"), ("--prob", "probminhash")):
        out = os.path.join(d, f"c2{nm}.bin")
        t0 = time.perf_counter()
        rc = main(["sketch", "-k", "31", "-S", "1024", flag,
                   "--binary-output", "--cmpout", out] + fas)
        dt = time.perf_counter() - t0
        assert rc == 0
        res[nm] = _emit(f"weighted-{nm}", n=N, seconds=round(dt, 3),
                        bases_per_s=round(N * LEN / dt),
                        pairs_per_s=round(_pairs(N) / dt))
    return res


def bench_intervals(d):
    from dashing2_tpu.cli import main
    beds, bws = _gen_bed_bw(d)
    out = os.path.join(d, "c3.phy")
    t0 = time.perf_counter()
    rc = main(["sketch", "-S", "1024", "--bed", "--multiset",
               "--normalize-intervals", "--cmpout", out] + beds)
    dt = time.perf_counter() - t0
    assert rc == 0
    r = _emit("intervals-bed", n=len(beds), seconds=round(dt, 3),
              pairs_per_s=round(_pairs(len(beds)) / dt))
    if bws:
        out = os.path.join(d, "c3b.phy")
        t0 = time.perf_counter()
        rc = main(["sketch", "-S", "1024", "--bigwig", "--multiset",
                   "--normalize-intervals", "--cmpout", out] + bws)
        dt = time.perf_counter() - t0
        assert rc == 0
        _emit("intervals-bigwig", n=len(bws), seconds=round(dt, 3))
    return r


def bench_topk(d):
    from dashing2_tpu.cli import main
    n = TOPK_N
    fas = _gen_fastas(os.path.join(d, "c4"), n, LEN)
    out = os.path.join(d, "c4.bin")
    t0 = time.perf_counter()
    rc = main(["sketch", "-k", "31", "-S", "1024", "--topk", "10",
               "--binary-output", "--cmpout", out] + fas)
    dt = time.perf_counter() - t0
    assert rc == 0
    return _emit("lsh-topk10", n=n, seconds=round(dt, 3),
                 items_per_s=round(n / dt))


def bench_refine_exact(d):
    from dashing2_tpu.cli import main
    n = max(N // 4, 8)
    fas = _gen_fastas(os.path.join(d, "c5"), n, LEN)
    out = os.path.join(d, "c5.bin")
    t0 = time.perf_counter()
    rc = main(["sketch", "-k", "31", "--set", "--topk", "5",
               "--refine-exact", "--binary-output", "--cmpout", out] + fas)
    dt = time.perf_counter() - t0
    assert rc == 0
    r = _emit("set-refine-exact", n=n, seconds=round(dt, 3))
    # minimizer sequences need a window (w > k) or every k-mer becomes a
    # token and the span edit DP is quadratic in full sequence length
    fas_s = _gen_fastas(os.path.join(d, "c5s"), min(n, 12),
                        min(LEN, 20000))
    out = os.path.join(d, "c5s.bin")
    t0 = time.perf_counter()
    rc = main(["sketch", "-k", "31", "-w", "63", "-S", "64", "--seq",
               "--topk", "5", "--exact-kmer-dist", "--binary-output",
               "--cmpout", out] + fas_s)
    dt = time.perf_counter() - t0
    assert rc == 0
    _emit("seq-editdist-knn", n=min(n, 12), seconds=round(dt, 3))
    return r


def bench_northstar(d):
    """The BASELINE.json north-star shape: 10240 genomes x 50 kb,
    `--fastcmp 0.5 --bbit-sigs` condensed f32 all-pairs, plus a greedy
    dedup of the same corpus. NOT in the default set (fixture
    generation alone writes ~520 MB); run with
    `python bench_e2e.py northstar`. Measured 2026-08-20 (round 5):
    WARM repeat 10.3-11.4 s (file-driver native sketch 3.8-5.0 s +
    packed-trapezoid counts pull 3.1-3.8 s + epilogue/emit ~1 s;
    host-state variance +-30% on the shared 1-core VM), process-cold
    43 s with a warm server compile cache; degraded compile-queue
    episodes measured 676-1849 s cold with warm unaffected — absorb
    them with `serve --warm` (bench nsdaemon: worker warmup 60 s,
    then client jobs 16-27 s). History: round 4 18.3 s warm /
    24-94 s cold; round 3 108 s; round 2 380 s. Dedup timing in
    README.md."""
    import resource

    from dashing2_tpu import timing as T
    from dashing2_tpu.cli import main as climain
    n, length = 10240, 50000
    fas = _gen_fastas(os.path.join(d, "ns"), n, length, seed=11)
    lst = os.path.join(d, "ns.txt")
    with open(lst, "w") as f:
        f.write("\n".join(fas) + "\n")
    out = os.path.join(d, "ns.bin")
    T.reset_spans()
    t0 = time.perf_counter()
    rc = climain(["sketch", "-k", "31", "-S", "1024", "--fastcmp", "0.5",
                  "--bbit-sigs", "--binary-output", "--cmpout", out,
                  "-F", lst])
    dt = time.perf_counter() - t0
    spans_cold = {k: round(v, 3) for k, v in sorted(T.spans().items())}
    assert rc == 0
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    # WARM repeat: the same invocation inside one resident process —
    # what a `dashing2-tpu serve` worker sees for repeat jobs. All jit
    # executables (sketch + compare programs) are process-cached, so
    # this is the job's compile-free wall.
    out2 = os.path.join(d, "ns2.bin")
    T.reset_spans()
    t0 = time.perf_counter()
    rc = climain(["sketch", "-k", "31", "-S", "1024", "--fastcmp", "0.5",
                  "--bbit-sigs", "--binary-output", "--cmpout", out2,
                  "-F", lst])
    dt_warm = time.perf_counter() - t0
    # phase breakdown: top-level phases from the
    # CLI `phase()` wrappers + fine-grained spans (sketch ingest-stall /
    # native-oph / merge, cmp dispatch/pull/epilogue, emit write). The
    # fine spans accumulate across threads so overlapped work can sum
    # past the wall; read them as per-resource busy time.
    spans_warm = {k: round(v, 3) for k, v in sorted(T.spans().items())}
    assert rc == 0
    with open(out, "rb") as f1, open(out2, "rb") as f2:
        assert f1.read() == f2.read(), "warm repeat diverged"
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return _emit("northstar-10k", n=n, seconds=round(dt, 3),
                 seconds_warm=round(dt_warm, 3),
                 unique_pairs_per_s=round(_pairs(n) / dt),
                 unique_pairs_per_s_warm=round(_pairs(n) / dt_warm),
                 peak_rss_gb=round(rss, 2),
                 phases_cold=spans_cold, phases_warm=spans_warm)


def bench_blockpath(d):
    """N >= 32768 regime: self-pairs past DASHING2_TPU_SELF_MAX fall to
    the generic row-block path — since round 4 the fused device engine
    (cmp/core._device_block_measures: row gathers + SWAR counts + f32
    epilogue in ONE program, pulls pipelined one block deep). Synthetic
    full-mode signatures (sketching 32k genomes is a different phase;
    this measures the compare + emit path) streamed through the production pairwise_matrix block
    iterator: the symmetric upper trapezoid (2 GB f32 at n=32768)
    crosses device->host. Wall on the GPU: not measured."""
    import resource

    from dashing2_tpu.cmp.core import pairwise_matrix
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.result import SketchingResult

    n = int(os.environ.get("DASHING2_TPU_BENCH_BLOCK_N", 32768))
    m = 1024
    rng = np.random.default_rng(0xb10c)
    res = SketchingResult(names=[f"g{i}" for i in range(n)])
    res.signatures = rng.random((n, m)) + 0.5
    res.cardinalities = rng.random(n) * 1e6 + 10.0
    opts = Dashing2DistOptions(k=31, sketchsize=m)
    # upper_only mirrors the CLI's symmetric emit route (only the upper
    # trapezoids cross device->host); the last column is valid in every
    # block, the lower-left is zeros by contract. Two passes: the first
    # pays the block-program + per-width slice compiles, the second is
    # the steady-state wall.
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        total = 0
        checksum = 0.0
        for lo, blk in pairwise_matrix(opts, res, upper_only=True):
            total += blk.size
            checksum += float(np.asarray(blk[:, -1:]).sum())
        walls.append(time.perf_counter() - t0)
        assert total == n * (n - 1) // 2 or total == n * n, total
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return _emit("blockpath-32k", n=n, seconds=round(walls[0], 3),
                 seconds_warm=round(walls[1], 3),
                 pairs_per_s=round(_pairs(n) / walls[1]),
                 peak_rss_gb=round(rss, 2), checksum=round(checksum, 3))


def bench_knn10k(d):
    """KNN graph (--topk 10) at the north-star width over synthetic
    full-mode signatures, run twice: once with the pair-list gather
    engine (the default) and once with the opt-in memoized count-matrix
    route (DASHING2_TPU_PAIR_MATRIX=force) — identical neighbor lists;
    the A/B says whether the gather engine should stay the default.
    Walls on the GPU: not measured."""
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.cmp.graph import neighbor_graph_main
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.enums import OutputFormat, OutputKind
    from dashing2_tpu.result import SketchingResult

    n = int(os.environ.get("DASHING2_TPU_BENCH_KNN_N", 10240))
    m = 1024
    walls = {}
    outs = {}
    # each route runs twice: the first pass pays that route's one-time
    # compiles (plus, for whichever tag goes first, the shared LSH /
    # packing programs), the second is the steady-state wall — the
    # honest A/B is warm vs warm
    for tag, envval in [("gather", None), ("matrix", "force")]:
        if envval is None:
            os.environ.pop("DASHING2_TPU_PAIR_MATRIX", None)
        else:
            os.environ["DASHING2_TPU_PAIR_MATRIX"] = envval
        for phase in ("cold", "warm"):
            rng = np.random.default_rng(0x4a4a)   # same data every run
            res = SketchingResult(names=[f"g{i}" for i in range(n)])
            res.signatures = rng.random((n, m)) + 0.5
            res.cardinalities = rng.random(n) * 1e6 + 10.0
            out = os.path.join(d, f"knn_{tag}.bin")
            opts = Dashing2DistOptions(
                k=31, sketchsize=m, num_neighbors=10,
                output_kind=OutputKind.KNN_GRAPH,
                output_format=OutputFormat.MACHINE_READABLE,
                outfile_path=out)
            t0 = time.perf_counter()
            neighbor_graph_main(opts, res)
            walls[f"{tag}_{phase}"] = time.perf_counter() - t0
        outs[tag] = open(out, "rb").read()
    os.environ.pop("DASHING2_TPU_PAIR_MATRIX", None)
    assert outs["gather"] == outs["matrix"], "route outputs diverged"
    # the BASELINE scenario's other half: --similarity-threshold graph
    # over the same corpus (NN_GRAPH_THRESHOLD, min_similarity filter)
    rng = np.random.default_rng(0x4a4a)
    res = SketchingResult(names=[f"g{i}" for i in range(n)])
    res.signatures = rng.random((n, m)) + 0.5
    res.cardinalities = rng.random(n) * 1e6 + 10.0
    tout = os.path.join(d, "nnt.bin")
    topts = Dashing2DistOptions(
        k=31, sketchsize=m, min_similarity=0.8,
        output_kind=OutputKind.NN_GRAPH_THRESHOLD,
        output_format=OutputFormat.MACHINE_READABLE, outfile_path=tout)
    t0 = time.perf_counter()
    neighbor_graph_main(topts, res)
    tsec = time.perf_counter() - t0
    assert os.path.getsize(tout) > 0
    return _emit("knn-topk10-10k", n=n,
                 seconds_gather=round(walls["gather_warm"], 3),
                 seconds_matrix=round(walls["matrix_warm"], 3),
                 seconds_gather_cold=round(walls["gather_cold"], 3),
                 seconds_matrix_cold=round(walls["matrix_cold"], 3),
                 items_per_s=round(n / walls["gather_warm"]),
                 seconds_threshold=round(tsec, 3),
                 identical_outputs=True)


def bench_contain(d):
    """contain screening throughput (mash-screen role,
    contain_main.cpp:76-114): build a --save-kmers db over BENCH_N
    references, then screen a multi-hundred-MB query stream; reports
    screened Mbases/s (round-5 producer/consumer native-reader
    pipeline)."""
    from dashing2_tpu.cli import main
    nref = min(N, 64)
    fas = _gen_fastas(os.path.join(d, "cdb"), nref, LEN)
    db = os.path.join(d, "screen")
    rc = main(["sketch", "-k", "31", "-S", "1024", "--save-kmers",
               "-o", db] + fas)
    assert rc == 0
    qn = max(4, min(N // 8, 32))
    qfas = _gen_fastas(os.path.join(d, "cq"), qn, LEN, seed=5)
    out = os.path.join(d, "contain.bin")
    t0 = time.perf_counter()
    rc = main(["contain", "--binary-output", "--cmpout", out,
               db + ".kmer64"] + qfas)
    dt = time.perf_counter() - t0
    assert rc == 0
    qbases = qn * LEN
    return _emit("contain-screen", nref=nref, nquery=qn,
                 seconds=round(dt, 3),
                 screened_mbases_per_s=round(qbases / dt / 1e6, 2))


def bench_northstar_daemon(d):
    """The north-star job through a
    `serve --warm` resident worker. The worker precompiles the compare
    program set at startup (cmp --warm-only 10240 under the job's
    flags); the client is the zero-import dashing2_tpu/client.py (no
    jax import), so the measured client wall IS the job wall. Done
    criterion: process-cold-through-daemon ~= in-process warm.

    One JAX process per card: the worker owns the GPU, so this process
    must not have touched it (run the cell alone: bench_e2e.py
    nsdaemon)."""
    import subprocess

    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        raise RuntimeError("nsdaemon needs a process that holds no "
                           "device: run `python bench_e2e.py nsdaemon` "
                           "on its own")
    n = int(os.environ.get("DASHING2_TPU_BENCH_NS_N", 10240))
    length = 50000
    fas = _gen_fastas(os.path.join(d, "ns"), n, length, seed=11)
    lst = os.path.join(d, "ns.txt")
    with open(lst, "w") as f:
        f.write("\n".join(fas) + "\n")
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "dashing2_tpu")
    sock = os.path.join(d, "d2.sock")
    jobflags = ["-S", "1024", "-k", "31", "--fastcmp", "0.5",
                "--bbit-sigs"]
    t0 = time.perf_counter()
    worker = subprocess.Popen(
        [sys.executable, "-m", "dashing2_tpu.cli", "serve", "--socket",
         sock, "-v", "--warm",
         f"cmp --warm-only {n} " + " ".join(jobflags)])
    try:
        import socket as _socket
        import struct as _struct
        for _ in range(2400):      # warm compile can take minutes cold
            if os.path.exists(sock):
                try:
                    s = _socket.socket(_socket.AF_UNIX,
                                       _socket.SOCK_STREAM)
                    s.connect(sock)
                    msg = b'{"op": "ping"}'
                    s.sendall(_struct.pack("!I", len(msg)) + msg)
                    s.recv(4)
                    s.close()
                    break
                except OSError:
                    pass
            time.sleep(0.5)
        else:
            raise RuntimeError("worker did not come up")
        warmup_wall = time.perf_counter() - t0
        walls = {}
        for tag in ("daemon_cold_client", "daemon_second_job"):
            out = os.path.join(d, f"{tag}.bin")
            env = dict(os.environ)
            env["DASHING2_TPU_DAEMON"] = sock
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, os.path.join(pkg, "client.py"),
                 "sketch"] + jobflags
                + ["--binary-output", "--cmpout", out, "-F", lst],
                env=env)
            walls[tag] = time.perf_counter() - t0
            assert r.returncode == 0
            assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    finally:
        worker.terminate()
        worker.wait(timeout=60)
    return _emit("northstar-daemon", n=n,
                 worker_warmup_s=round(warmup_wall, 3),
                 **{k: round(v, 3) for k, v in walls.items()})


def bench_knnquality(d):
    """recall@10 + wall vs --nlsh and candidate
    budget at the north-star width. Clustered synthetic signatures
    (family centers with graded register mutation — random uniform
    sigs have no neighbor structure to recall) against the exact
    top-10 oracle from the full similarity matrix. Wall covers index
    build + candidates + refine."""
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.cmp.graph import _index_source, _refine_lists
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.result import SketchingResult

    n = int(os.environ.get("DASHING2_TPU_BENCH_KNN_N", 10240))
    m, k10 = 1024, 10
    rng = np.random.default_rng(0xBEAD)
    nf = max(16, n // 64)
    centers = rng.random((nf, m)) + 0.5
    fam = rng.integers(0, nf, n)
    rate = rng.uniform(0.02, 0.6, n)
    sigs = centers[fam].copy()
    mut = rng.random((n, m)) < rate[:, None]
    sigs[mut] = rng.random(int(mut.sum())) + 0.5
    res = SketchingResult(names=[f"g{i}" for i in range(n)])
    res.signatures = sigs
    res.cardinalities = rng.random(n) * 1e6 + 10.0
    opts = Dashing2DistOptions(k=31, sketchsize=m, num_neighbors=k10)
    creps, res = C._prep(opts, res)
    exact = np.zeros((n, k10), np.int64)
    t0 = time.perf_counter()
    for start, blk in C.pairwise_matrix(opts, res):
        blk = np.asarray(blk, np.float32).copy()
        b = blk.shape[0]
        blk[np.arange(b), np.arange(start, start + b)] = -np.inf
        exact[start:start + b] = np.argpartition(
            -blk, k10, axis=1)[:, :k10]
    t_exact = time.perf_counter() - t0
    exact_sets = [set(r.tolist()) for r in exact]
    table = {}
    for nlsh in (1, 2, 3):
        qopts = Dashing2DistOptions(k=31, sketchsize=m,
                                    num_neighbors=k10, nLSH=nlsh)
        for ncand in (11, 35, 70, 140):
            t0 = time.perf_counter()
            idx = _index_source(qopts, res, creps)
            ia, ib, _c = idx.candidate_pairs(max_per_item=ncand)
            lists = _refine_lists(qopts, res, creps, ia, ib)
            wall = time.perf_counter() - t0
            rec = np.mean([
                len(set(nb for _v, nb in lst[:k10]) & exact_sets[i])
                / k10 for i, lst in enumerate(lists)])
            table[f"nlsh{nlsh}_cand{ncand}"] = {
                "recall_at_10": round(float(rec), 4),
                "seconds": round(wall, 3)}
    return _emit("knn-quality-curve", n=n,
                 seconds_exact_oracle=round(t_exact, 3), **table)


def bench_dist2(d):
    """N>=2 hosts line (BASELINE.md north-star: "pairs/sec measured at
    1 chip, 1 host, and N>=2 hosts"): TWO real jax.distributed
    processes (gloo collectives) sketch their input shards, all-gather
    sketches, compute owned row blocks, and write them; the
    concatenation is verified equal to the single-node production
    matrix. The processes run on the CPU backend (the multi-process
    GPU driver has never run) and share this host's cores -- so the
    line validates the scaling MECHANICS and result identity; the
    per-host device rate is the single-device number."""
    import socket
    import subprocess

    n = max(min(N, 64), 16)
    fas = _gen_fastas(os.path.join(d, "d2p"), n, min(LEN, 50000))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(d, "dist.bin")
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    # the worker runs as a script: put the repo root on its import path
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(here)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "dist_worker.py"),
         str(pid), "2", str(port), out] + fas,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
    dt = time.perf_counter() - t0

    from dashing2_tpu.parallel.distributed import my_row_range
    blocks = []
    for pid in range(2):
        lo, hi = my_row_range(n, pid, 2)
        blk = np.fromfile(f"{out}.rows.{lo}-{hi}", np.float32)
        blocks.append(blk.reshape(hi - lo, n))
    got = np.concatenate(blocks)
    from dashing2_tpu.cmp.core import pairwise_matrix
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.sketch.core import sketch_fastx
    opts = Dashing2DistOptions(k=21, sketchsize=128)
    result = sketch_fastx(opts, fas)
    ref = np.concatenate([blk for _, blk in pairwise_matrix(opts, result)])
    assert np.array_equal(got, np.asarray(ref, np.float32))
    return _emit("distributed-2proc", n=n, seconds=round(dt, 3),
                 pairs_per_s=round(_pairs(n) / dt),
                 identical_to_single_host=True)


ALL = {
    "default": bench_default,
    "weighted": bench_weighted,
    "intervals": bench_intervals,
    "topk": bench_topk,
    "refine": bench_refine_exact,
}
EXTRA = {"northstar": bench_northstar, "dist2": bench_dist2,
         "blockpath": bench_blockpath, "knn10k": bench_knn10k,
         "knnquality": bench_knnquality,
         "nsdaemon": bench_northstar_daemon,
         "contain": bench_contain}


def main():
    which = sys.argv[1:] or list(ALL)
    ALL.update(EXTRA)
    d = tempfile.mkdtemp(prefix="d2bench_")
    try:
        for w in which:
            ALL[w](d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
