#!/usr/bin/env python3
"""Smoke test: the sketch-and-compare path on one NVIDIA GPU.

Generates a clustered corpus from --seed -- 10,240 genomes x 50 kb, 512
ancestors x 20 members at 0.1-2 % substitution divergence, the
reference's 10K-genome all-pairs job -- and drives the CLI
(dashing2_tpu.cli.main) through it:

  (a) sketch -k 31 -S 1024 -o SKETCHES            auto sketch engine
  (b) cmp --presketched --fastcmp 0.5 --bbit-sigs  headline nibble job
  (c) cmp --presketched                            full-register gt/lt job
  (d) cmp --presketched --fastcmp 0.5              nibble a/b (eq+gt kernel)
  (e) cmp --presketched --topk 10                  LSH KNN, vs EXACT_KNN=1
  (f) 1,024 genomes sketched again by the device 'sort' engine

For 256 sampled rows x all columns, the counts are recomputed in numpy
from the written sketches and must be bit-identical to the device's; the
estimator is recomputed with the repo's numpy epilogue and compared with
the emitted f32 matrix in ulps. KNN is scored as recall@10 against the
exact lists; the device sketches must equal the native engine's bit for
bit. Each phase prints its wall time, compile (set-up) time, engines and
peak device memory; each comparison prints its difference beside its
tolerance.

  python chip_smoke.py [--seed S]
  python chip_smoke.py --four     # phases (a)-(c) on a 4-GPU mesh vs one GPU

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails. The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Tolerances of the emitted f32 matrices vs the numpy epilogue.
# full: exact. nibble-bbit: 1 ulp -- XLA rewrites the division by the
# constant denominator m(2^b - 1) as a multiplication by its f32
# reciprocal, numpy divides. nibble-ab: absolute, 2 ulps of 1.0 -- XLA
# may contract alpha*g + beta*g into one FMA, so alpha + beta can differ
# from numpy in its last bit, and 1 - (alpha + beta) keeps that absolute
# error while small similarities magnify it in their own ulps.
TOL = {"full": ("ulps", 0), "nibble-bbit": ("ulps", 1),
       "nibble-ab": ("abs", 2.0 ** -22)}
RECALL_MIN = 0.9
# mesh vs one device for the nibble kinds (different XLA graphs may
# contract the f32 epilogue's FMAs differently)
MESH_NIBBLE_RTOL = MESH_NIBBLE_ATOL = 2e-7


@dataclasses.dataclass(frozen=True)
class Size:
    ancestors: int = 512
    members: int = 20
    length: int = 50_000
    sketchsize: int = 1024
    sample_rows: int = 256
    device_sketch: int = 1024
    topk: int = 10


# ----------------------------------------------------------------------
# corpus and readers
# ----------------------------------------------------------------------

def make_corpus(outdir: str, seed: int, size: Size) -> list:
    """ancestors x members FASTA files; member i of a family carries
    substitutions (always to a different base) at a rate drawn from
    [0.1 %, 2 %]. Returns the paths, family by family."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = size.length
    wrap = L % 80 == 0
    paths = []
    for a in range(size.ancestors):
        anc = rng.integers(0, 4, L, dtype=np.uint8)
        fam = np.repeat(anc[None], size.members, axis=0)
        rate = rng.uniform(0.001, 0.02, (size.members, 1))
        hit = rng.random(fam.shape) < rate
        fam[hit] = (fam[hit] + rng.integers(1, 4, hit.sum(),
                                            dtype=np.uint8)) % 4
        for i, codes in enumerate(fam):
            seq = acgt[codes]
            if wrap:
                lines = np.concatenate(
                    [seq.reshape(-1, 80),
                     np.full((L // 80, 1), ord("\n"), np.uint8)], axis=1)
                body = lines.tobytes()
            else:
                body = seq.tobytes() + b"\n"
            p = os.path.join(outdir, f"f{a:04d}_{i:02d}.fa")
            with open(p, "wb") as f:
                f.write(f">fam{a}_m{i}\n".encode() + body)
            paths.append(p)
    return paths


def condensed_rows(flat: np.ndarray, n: int, rows) -> np.ndarray:
    """Rows of the symmetric (n, n) matrix stored as the condensed upper
    triangle (i < j, row-major, no diagonal); the diagonal reads NaN."""
    j = np.arange(n, dtype=np.int64)
    out = np.empty((len(rows), n), np.float32)
    for t, i in enumerate(rows):
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        idx = lo * n - lo * (lo + 1) // 2 + (hi - lo - 1)
        idx[i] = 0
        out[t] = flat[idx]
        out[t, i] = np.nan
    return out


def max_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 ulps between a and b where both are
    finite; NaN positions must agree (else the result is a huge
    sentinel)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return 1 << 40
    fin = ~np.isnan(a)

    def ordered(x):
        i = x[fin].view(np.int32).astype(np.int64)
        return np.where(i < 0, -(1 << 31) - i, i)
    if not fin.any():
        return 0
    return int(np.abs(ordered(a) - ordered(b)).max())


def np_counts(regs: np.ndarray, rows, want_gt: bool, step: int = 8):
    """Plain numpy (eq, gt or None) counts of rows x all rows of a
    register matrix (N, m)."""
    n = regs.shape[0]
    eq = np.empty((len(rows), n), np.int32)
    gt = np.empty((len(rows), n), np.int32) if want_gt else None
    rows = np.asarray(rows)
    for s in range(0, len(rows), step):
        a = regs[rows[s:s + step]][:, None, :]
        eq[s:s + step] = np.count_nonzero(a == regs[None], axis=2)
        if want_gt:
            gt[s:s + step] = np.count_nonzero(a > regs[None], axis=2)
    return eq, gt


def recall_at_k(approx, exact) -> float:
    """Mean over rows of |approx_i & exact_i| / |exact_i| for CSR
    (indptr, indices, data) neighbour lists."""
    ip_a, ix_a, _ = approx
    ip_e, ix_e, _ = exact
    tot = 0.0
    n = len(ip_e) - 1
    for i in range(n):
        e = set(ix_e[ip_e[i]:ip_e[i + 1]].tolist())
        a = set(ix_a[ip_a[i]:ip_a[i + 1]].tolist())
        tot += len(a & e) / max(len(e), 1)
    return tot / max(n, 1)


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit, from a child that stays off
    JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().replace("\n", "; ")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

_COMPILE_EVENTS = ("/jax/core/compile/backend_compile_duration",
                   "/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration")


class Runner:
    """Phase bookkeeping: wall, compile (set-up) seconds, persistent
    cache hits, peak device memory; failures are collected, not
    raised."""

    def __init__(self):
        import jax
        from jax import monitoring
        self.jax = jax
        self.compile_s = 0.0
        self.cache_hits = 0
        self.failed = []
        self.results = {}

        def on_duration(event, duration, *a, **kw):
            if event in _COMPILE_EVENTS:
                self.compile_s += duration

        def on_event(event, *a, **kw):
            if event == "/jax/compilation_cache/cache_hits":
                self.cache_hits += 1
        monitoring.register_event_duration_secs_listener(on_duration)
        monitoring.register_event_listener(on_event)

    def peak(self):
        st = self.jax.devices()[0].memory_stats() or {}
        return st.get("peak_bytes_in_use", "not measured")

    @contextlib.contextmanager
    def phase(self, name: str):
        from dashing2_tpu import timing
        timing.reset_spans()
        info = {}
        c0, h0, t0 = self.compile_s, self.cache_hits, time.perf_counter()
        try:
            yield info
        except Exception as e:
            traceback.print_exc()
            self.failed.append(name)
            info["error"] = f"{type(e).__name__}: {e}"[:300]
        wall = time.perf_counter() - t0
        extra = " ".join(f"{k}={v}" for k, v in info.items())
        print(f"phase {name}: wall_s={wall:.3f} "
              f"compile_s={self.compile_s - c0:.3f} "
              f"cache_hits={self.cache_hits - h0} "
              f"peak_bytes_in_use={self.peak()} {extra}", flush=True)

    def check(self, name: str, value, tol, ok: bool):
        print(f"check {name}: {value} (tolerance {tol}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            self.failed.append(name)


def cli(argv) -> None:
    from dashing2_tpu.cli import main
    rc = main([str(x) for x in argv])
    if rc != 0:
        raise RuntimeError(f"dashing2-tpu {argv[0]} exited {rc}")


def sketch_engine() -> str:
    from dashing2_tpu import timing
    sp = timing.spans()
    if "sketch/native-files" in sp:
        return "native-file-driver"
    if "sketch/native-oph" in sp:
        return "native-chunked"
    if "sketch/dispatch" in sp:
        from dashing2_tpu.ops import sketch_kernels as SK
        from dashing2_tpu.sketch.core import _auto_device_engine
        eng = SK.oph_rows_engine()
        return "device-" + (_auto_device_engine() if eng == "auto" else eng)
    return "host-segments"


def compare_engine(opts, result, creps) -> str:
    """The counts engine and route the routing policy picks for a
    symmetric all-pairs job."""
    from dashing2_tpu import timing
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.ops import pallas_cmp as PC
    kind, data = C._representation(opts, result, creps)
    mode = C._kernel_mode()
    n = len(result.cardinalities)
    # only the u16 counts-pull route opens the cmp/dispatch span
    route = ("counts-pull" if "cmp/dispatch" in timing.spans()
             else "fused-f32")
    if C._multichip_mesh() is not None:
        counts = "mesh-band-sharded"
    elif kind == "nibble-ab":
        counts = ("tri-eq+gt-kernel" if mode == "tri" and
                  PC.tri_self_counts_available(n, 2 * data.shape[1])
                  else "xla-onehot-dots")
    elif kind == "nibble-bbit":
        counts = "xla-onehot-dot"
    else:
        counts = "swar" if C._swar_route(n, mode) else "xla-circulant"
    return f"mode={mode} route={route} counts={counts}"


def load_job(sketches: str, fd: float, bbit: bool, m: int):
    """(opts, result, creps) exactly as `cmp --presketched` builds them
    from the written sketches."""
    from dashing2_tpu.cli import _load_presketched
    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.config import Dashing2DistOptions
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=fd,
                               truncation_method=1 if bbit else 0,
                               sig_ram_limit=20 << 30)
    result = _load_presketched(opts, [sketches])
    creps, result = C._prep(opts, result)
    return opts, result, creps


def reference_rows(opts, result, creps, rows):
    """(kind, numpy counts (c1, c2), eq, gt, f32 measures) for rows x all
    columns, from the sketches alone."""
    from dashing2_tpu.cmp import core as C
    kind, data = C._representation(opts, result, creps)
    m = opts.sketchsize
    if kind.startswith("nibble"):
        regs = C._unpack_nibbles(np.asarray(data))
    else:
        # non-negative f64 registers compare as the numbers themselves
        regs = np.asarray(result.signatures)
    want_gt = kind in ("full", "nibble-ab")
    eq, gt = np_counts(regs, rows, want_gt)
    if want_gt:
        c1, c2 = gt, m - eq - gt
    else:
        c1, c2 = eq, None
    cards = np.asarray(result.cardinalities, np.float64)
    bf = max(creps.b, 1.0 + 1e-9)
    ref = C._measure_epilogue(kind, m, opts.measure, opts.k,
                              opts.fd_level, c1, c2,
                              cards[rows][:, None], cards[None, :],
                              np.float64(bf), np, C._gb_args(bf, m))
    ref = np.asarray(ref, np.float32)
    ref[np.arange(len(rows)), rows] = np.nan
    return kind, eq, gt, ref


def device_counts_rows(opts, result, creps, rows):
    """(eq, gt or None) for rows x all columns from the production
    device count functions the CLI job ran."""
    import jax.numpy as jnp

    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.ops import pallas_cmp as PC
    kind, data = C._representation(opts, result, creps)
    m = opts.sketchsize
    mode = C._kernel_mode()
    r = jnp.asarray(np.asarray(rows, np.int32))
    if kind == "nibble-ab":
        regs = jnp.asarray(C._unpack_nibbles(np.asarray(data)))
        if mode == "tri" and PC.tri_self_counts_available(*regs.shape):
            eq, gt, _ = PC.counts_nibble_tri_self(regs)
        else:
            eq, gt, _ = PC.nibble_dots(regs, regs, True)
        return np.asarray(eq[r]), np.asarray(gt[r])
    eqm = C._self_counts_fn_m(kind, m, opts.fd_level, mode)(
        jnp.asarray(data))
    return np.asarray(eqm[r]).astype(np.int32), None


def check_matrix_job(run: Runner, label: str, sketches: str, out: str,
                     fd: float, bbit: bool, size: Size, rows):
    """Counts bit-identical to numpy; emitted f32 within ULP_TOL."""
    opts, result, creps = load_job(sketches, fd, bbit, size.sketchsize)
    kind, eq, gt, ref = reference_rows(opts, result, creps, rows)
    n = len(result.cardinalities)
    deq, dgt = device_counts_rows(opts, result, creps, rows)
    ok = deq.shape == eq.shape and np.array_equal(deq, eq) and (
        dgt is None or np.array_equal(dgt, gt))
    diff = int(np.abs(deq - eq).max()) if deq.shape == eq.shape else -1
    if dgt is not None and dgt.shape == gt.shape:
        diff = max(diff, int(np.abs(dgt - gt).max()))
    run.check(f"{label} counts ({kind}) device vs numpy",
              f"max_abs_diff={diff}", 0, ok)
    got = condensed_rows(np.fromfile(out, np.float32), n, rows)
    ulps = max_ulps(got, ref)
    fin = ~np.isnan(ref)
    absd = float(np.abs(got[fin] - ref[fin]).max()) \
        if np.array_equal(np.isnan(got), ~fin) else float("inf")
    unit, tol = TOL[kind]
    run.check(f"{label} f32 {kind} vs numpy epilogue",
              f"max_ulps={ulps} max_abs_diff={absd!r}", f"{unit} {tol!r}",
              (ulps if unit == "ulps" else absd) <= tol)


def run_single(run: Runner, work: str, seed: int, size: Size) -> None:
    from dashing2_tpu.io import formats
    corpus = os.path.join(work, "corpus")
    outd = os.path.join(work, "out")
    os.makedirs(outd, exist_ok=True)
    with run.phase("setup") as info:
        t0 = time.perf_counter()
        paths = make_corpus(corpus, seed, size)
        lst = os.path.join(corpus, "list.txt")
        with open(lst, "w") as f:
            f.write("\n".join(paths) + "\n")
        info["corpus_s"] = f"{time.perf_counter() - t0:.3f}"
        info["genomes"] = len(paths)
        info["bases"] = len(paths) * size.length
        from dashing2_tpu import native
        t0 = time.perf_counter()
        native.load_oph_lib()
        native.load_fastx_lib()
        info["native_build_s"] = f"{time.perf_counter() - t0:.3f}"
    n = len(paths)
    rows = np.sort(np.random.default_rng(seed + 1).choice(
        n, min(size.sample_rows, n), replace=False))
    sk = os.path.join(outd, "sketches.bin")
    with run.phase("a-sketch") as info:
        cli(["sketch", "-k", 31, "-S", size.sketchsize, "-o", sk, "-F", lst])
        info["sketch_engine"] = sketch_engine()
        info["items"] = len(formats.read_stacked_signatures(sk)[0])
    jobs = [("b-nibble-bbit", ["--fastcmp", "0.5", "--bbit-sigs"], 0.5, True),
            ("c-full", [], 8.0, False),
            ("d-nibble-ab", ["--fastcmp", "0.5"], 0.5, False)]
    for label, flags, fd, bbit in jobs:
        out = os.path.join(outd, label + ".bin")
        with run.phase(label) as info:
            cli(["cmp", "--presketched", *flags, "--binary-output",
                 "--cmpout", out, sk])
            opts, result, creps = load_job(sk, fd, bbit, size.sketchsize)
            info["engines"] = compare_engine(opts, result, creps)
        with run.phase(label + "-check"):
            check_matrix_job(run, label, sk, out, fd, bbit, size, rows)
    with run.phase("e-knn") as info:
        knn = os.path.join(outd, "knn.csr")
        exact = os.path.join(outd, "knn_exact.csr")
        cli(["cmp", "--presketched", "--topk", size.topk,
             "--binary-output", "--cmpout", knn, sk])
        os.environ["EXACT_KNN"] = "1"
        try:
            cli(["cmp", "--presketched", "--topk", size.topk,
                 "--binary-output", "--cmpout", exact, sk])
        finally:
            del os.environ["EXACT_KNN"]
        rec = recall_at_k(formats.read_knn_csr(knn),
                          formats.read_knn_csr(exact))
        info["engines"] = "lsh+device-pair-counts"
        run.check(f"e recall@{size.topk} vs exact", f"{rec:.6f}",
                  f">= {RECALL_MIN}", rec >= RECALL_MIN)
    with run.phase("f-device-sketch") as info:
        sub = paths[:size.device_sketch]
        lst2 = os.path.join(corpus, "list_sub.txt")
        with open(lst2, "w") as f:
            f.write("\n".join(sub) + "\n")
        sk_nat = os.path.join(outd, "sub_native.bin")
        sk_dev = os.path.join(outd, "sub_sort.bin")
        cli(["sketch", "-k", 31, "-S", size.sketchsize, "-o", sk_nat,
             "-F", lst2])
        os.environ["DASHING2_TPU_OPH_ENGINE"] = "sort"
        try:
            from dashing2_tpu import timing
            timing.reset_spans()
            cli(["sketch", "-k", 31, "-S", size.sketchsize, "-o", sk_dev,
                 "-F", lst2])
            info["sketch_engine"] = sketch_engine()
        finally:
            del os.environ["DASHING2_TPU_OPH_ENGINE"]
        a = formats.read_stacked_signatures(sk_nat)
        b = formats.read_stacked_signatures(sk_dev)
        same = all(np.array_equal(x.view(np.uint64), y.view(np.uint64))
                   for x, y in zip(a, b))
        run.check("f device-sort sketches vs native", f"identical={same}",
                  "bit-identical", same)


def run_four(run: Runner, work: str, seed: int, size: Size) -> None:
    """(a)-(c) routed through the mesh, then the same jobs with
    DASHING2_TPU_MULTICHIP=0, in this process."""
    from dashing2_tpu.io import formats
    corpus = os.path.join(work, "corpus")
    outd = os.path.join(work, "out")
    os.makedirs(outd, exist_ok=True)
    with run.phase("setup") as info:
        paths = make_corpus(corpus, seed, size)
        lst = os.path.join(corpus, "list.txt")
        with open(lst, "w") as f:
            f.write("\n".join(paths) + "\n")
        info["genomes"] = len(paths)
    outs = {}
    for flag in ("1", "0"):
        os.environ["DASHING2_TPU_MULTICHIP"] = flag
        try:
            sk = os.path.join(outd, f"sketches_{flag}.bin")
            with run.phase(f"a-sketch multichip={flag}") as info:
                cli(["sketch", "-k", 31, "-S", size.sketchsize, "-o", sk,
                     "-F", lst])
                info["sketch_engine"] = sketch_engine()
            outs["a", flag] = sk
            for label, flags, fd, bbit in (
                    ("b-nibble-bbit", ["--fastcmp", "0.5", "--bbit-sigs"],
                     0.5, True),
                    ("c-full", [], 8.0, False)):
                out = os.path.join(outd, f"{label}_{flag}.bin")
                with run.phase(f"{label} multichip={flag}") as info:
                    # both routes compare the mesh run's sketches
                    cli(["cmp", "--presketched", *flags, "--binary-output",
                         "--cmpout", out, outs["a", "1"]])
                    o, r, c = load_job(outs["a", "1"], fd, bbit,
                                       size.sketchsize)
                    info["engines"] = compare_engine(o, r, c)
                outs[label, flag] = out
        finally:
            del os.environ["DASHING2_TPU_MULTICHIP"]
    a1 = formats.read_stacked_signatures(outs["a", "1"])
    a0 = formats.read_stacked_signatures(outs["a", "0"])
    same = all(np.array_equal(x.view(np.uint64), y.view(np.uint64))
               for x, y in zip(a1, a0))
    run.check("a mesh vs one-device sketches", f"identical={same}",
              "bit-identical", same)
    for label, exact in (("b-nibble-bbit", False), ("c-full", True)):
        m1 = np.fromfile(outs[label, "1"], np.float32)
        m0 = np.fromfile(outs[label, "0"], np.float32)
        if exact:
            ok = np.array_equal(m1, m0)
            run.check(f"{label} mesh vs one device", f"identical={ok}",
                      "byte-identical", ok)
        else:
            ok = m1.shape == m0.shape and np.allclose(
                m1, m0, rtol=MESH_NIBBLE_RTOL, atol=MESH_NIBBLE_ATOL)
            d = float(np.abs(m1 - m0).max()) if m1.shape == m0.shape \
                else float("inf")
            run.check(f"{label} mesh vs one device",
                      f"max_abs_diff={d} identical={np.array_equal(m1, m0)}",
                      f"rtol=atol={MESH_NIBBLE_RTOL}", ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four", action="store_true",
                    help="run (a)-(c) on a multi-GPU mesh and compare "
                         "with one GPU")
    args = ap.parse_args(argv)
    try:
        import dashing2_tpu  # noqa: F401  (x64 before any other jax use)
        import jax
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}",
              file=sys.stderr)
        return 2
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if args.four and len(devs) < 2:
        print("chip_smoke: --four needs several GPUs", file=sys.stderr)
        return 2
    print(f"device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}", flush=True)
    print(f"card: {card_name_and_power()}", flush=True)
    from dashing2_tpu import compile_cache_dir
    print(f"compile cache: {compile_cache_dir()}", flush=True)
    run = Runner()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    try:
        (run_four if args.four else run_single)(run, work, args.seed, Size())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"total: wall_s={time.perf_counter() - t0:.3f} "
          f"compile_s={run.compile_s:.3f} cache_hits={run.cache_hits}",
          flush=True)
    if run.failed:
        print(f"chip_smoke: FAILED: {', '.join(run.failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
