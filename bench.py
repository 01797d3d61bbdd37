"""Headline benchmark: pairwise register-comparison throughput on one GPU.

Headline config: the COMPLETE production `--fastcmp 0.5 --bbit-sigs`
similarity job (the reference's own fast path: b-bit truncation
cmp_core.cpp:293-320 + the eq-only estimator :495-517) at N=10240
sketches x m=1024 registers: nibble-packed registers -> one-hot int8
counts -> f32 estimator epilogue -> full (N, N) f32 similarity matrix,
all in the production _self_matrix_fn jit -- everything the reference's
cmp phase does between loaded sketches and the values its emitter
writes. Further lines: the nibble a/b job (triangular eq+gt kernel), the
DEFAULT CLI mode (full f64 registers, gt/lt estimator), the u8 b-bit
and a/b jobs, a panel, the pair list and the sketch step, each through
the engine the platform policy (cmp.core._kernel_mode) picks.

Baselines: BASELINE_MEASURED.json holds in-container measurements of
the reference's per-pair SIMD kernels per register width and its
per-base sketch loop (native/cpu_baseline.cpp), projected linearly to
the 32-thread target machine. Every mode's vs_baseline divides by ITS
OWN width's kernel.

Accounting is in UNIQUE pairs: a symmetric all-pairs job over N items is
N(N-1)/2 comparisons (the reference's emitrect walk). Times are host
clock around calls that end in block_until_ready, after a warm-up call
(compilation is not timed); min and median over reps. The benchmark
fails when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

CALIBRATION_CPU_PAIRS_PER_SEC = 1.25e8   # round-1 constant (continuity)

# Dense int8 tensor-core peak by device_kind, NVIDIA H100 data sheet
# (SXM part, without sparsity). An unlisted device is an error.
PEAK_INT8_OPS = {"NVIDIA H100 80GB HBM3": 1979e12}


def _measured_baselines():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED.json")
    try:
        with open(path) as f:
            doc = json.load(f)
        return {k: float(v["projected_32t"])
                for k, v in doc["modes"].items()}
    except (OSError, KeyError, ValueError):
        return {}


BASE = _measured_baselines()


def _denom(mode_key: str) -> float:
    return BASE.get(mode_key, CALIBRATION_CPU_PAIRS_PER_SEC)


def _timed(fn, *args, reps=5):
    """(t_min, t_median) seconds of fn(*args) to block_until_ready,
    after one untimed warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[0], ts[len(ts) // 2]


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def main():
    import dashing2_tpu  # noqa: F401  (x64)
    import jax
    import jax.numpy as jnp

    from dashing2_tpu.cmp import core as C
    from dashing2_tpu.enums import Measure
    from dashing2_tpu.ops import pallas_cmp as PC

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    if dev.device_kind not in PEAK_INT8_OPS:
        raise SystemExit(f"no int8 peak on record for {dev.device_kind!r}")
    peak = PEAK_INT8_OPS[dev.device_kind]
    mode = C._kernel_mode()
    _log(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
         f"engine mode {mode}")
    n, m = 10240, 1024
    rng = np.random.default_rng(0)
    up = n * (n - 1) / 2
    cards = jnp.asarray(rng.uniform(1e5, 1e7, size=n))
    gbt, gbinv = C._gb_args(1.001, m)
    gbt = jnp.asarray(gbt)
    b = jnp.float64(1.001)
    extra = {}

    def fused_time(kind, data, fd, reps=5):
        fn = C._self_matrix_fn_m(kind, m, Measure.SIMILARITY, 31, fd, mode)
        return _timed(fn, data, cards, b, gbt, gbinv, reps=reps)

    # ------------------------------------------------------------------
    # headline: --fastcmp 0.5 --bbit-sigs fused production similarity
    # ------------------------------------------------------------------
    packed = jnp.asarray(rng.integers(0, 256, size=(n, m // 2),
                                      dtype=np.uint16).astype(np.uint8))
    t_ab_min, t_ab_med = fused_time("nibble-ab", packed, 0.5)
    _log(f"fused nibble-ab similarity: {t_ab_min*1e3:.2f} ms (med "
         f"{t_ab_med*1e3:.2f}) = {up/t_ab_min/1e9:.2f} G pairs/s "
         f"({up/t_ab_min/_denom('count_gtlt_nibble'):.1f}x measured CPU)")
    t_head_min, t_head_med = fused_time("nibble-bbit", packed, 0.5)
    _log(f"HEADLINE fused nibble-bbit similarity: {t_head_min*1e3:.2f} ms "
         f"(med {t_head_med*1e3:.2f}) = {up/t_head_min/1e9:.2f} G pairs/s "
         f"({up/t_head_min/_denom('count_eq_nibble'):.1f}x measured CPU)")

    # counts engines alone: the headline's full-square eq dot and the
    # nibble a/b job's triangular eq+gt kernel, as shares of the int8 peak
    nib = jnp.asarray(rng.integers(0, 16, size=(n, m)).astype(np.uint8))
    eq_dot = jax.jit(lambda x: PC.nibble_dots(x, x, False)[0])
    t_eq, _ = _timed(eq_dot, nib)
    share = 2 * n * n * 16 * m / peak / t_eq
    extra["counts_eq_dot_ms"] = round(t_eq * 1e3, 3)
    extra["counts_eq_dot_int8_peak_share"] = round(share, 3)
    _log(f"counts engine (eq dot): {t_eq*1e3:.2f} ms, "
         f"{share*100:.0f}% of the int8 peak")
    if mode == "tri" and PC.tri_self_counts_available(n, m):
        tri = jax.jit(lambda x: PC.tri_counts_tiles(x)[:2])
        t_tri, _ = _timed(tri, nib)
        T, _ = PC._tri_shape(n, PC._TRI_BM)
        macs = (T // 2) * (T + 1) * PC._TRI_BM ** 2 * 16 * m
        share = 2 * macs / peak / t_tri
        extra["counts_tri_kernel_ms"] = round(t_tri * 1e3, 3)
        extra["counts_tri_kernel_int8_peak_share"] = round(share, 3)
        _log(f"counts engine (triangular eq+gt kernel): "
             f"{t_tri*1e3:.2f} ms, {share*100:.0f}% of the int8 peak")

    # ------------------------------------------------------------------
    # DEFAULT CLI mode: full f64 registers, gt/lt estimator
    # ------------------------------------------------------------------
    u64 = jnp.asarray(rng.integers(0, 1 << 62, size=(n, m)
                                   ).astype(np.uint64))
    t_full, t_full_med = fused_time("full", u64, 8.0)
    extra["default_full_pairs_per_sec"] = round(up / t_full)
    extra["default_full_vs_measured_cpu"] = round(
        up / t_full / _denom("count_gtlt_f64"), 2)
    _log(f"DEFAULT full-register fused similarity: {t_full*1e3:.2f} ms "
         f"(med {t_full_med*1e3:.2f}) = {up/t_full/1e9:.2f} G pairs/s")

    # --fastcmp 1 --bbit-sigs (u8 eq) and --fastcmp 1 a/b (u8 gtlt)
    u8 = jnp.asarray(rng.integers(0, 256, size=(n, m)).astype(np.uint8))
    for kind, key, base in (("bbit", "bbit_u8", "count_eq_u8"),
                            ("ab", "ab_u8", "count_gtlt_u8")):
        t, t_med = fused_time(kind, u8, 1.0)
        extra[f"{key}_pairs_per_sec"] = round(up / t)
        extra[f"{key}_vs_measured_cpu"] = round(up / t / _denom(base), 2)
        _log(f"fastcmp-1 {kind} u8 fused similarity: {t*1e3:.2f} ms "
             f"(med {t_med*1e3:.2f}) = {up/t/1e9:.2f} G pairs/s")

    # ------------------------------------------------------------------
    # panel (Q x F) job: full-register kind, 10k refs x 1k queries
    # ------------------------------------------------------------------
    nq = n // 10
    pdata = jnp.asarray(rng.integers(0, 1 << 62, size=(n + nq, m)
                                     ).astype(np.uint64))
    pcards = jnp.asarray(rng.uniform(1e5, 1e7, size=n + nq))
    pfn = C._panel_matrix_fn_m("full", m, Measure.SIMILARITY, 31, 8.0, n,
                               mode)
    t_pn, t_pn_med = _timed(pfn, pdata, pcards, b, gbt, gbinv)
    extra["panel_full_pairs_per_sec"] = round(n * nq / t_pn)
    _log(f"panel full-register {n}x{nq} fused similarity: "
         f"{t_pn*1e3:.2f} ms (med {t_pn_med*1e3:.2f}) = "
         f"{n*nq/t_pn/1e9:.2f} G pairs/s")

    # ------------------------------------------------------------------
    # pair-list counts (the dedup/refine/KNN hot path): 1M pairs
    # ------------------------------------------------------------------
    P = 1 << 20
    ia = jnp.asarray(rng.integers(0, n, size=P).astype(np.int32))
    ib = jnp.asarray(rng.integers(0, n, size=P).astype(np.int32))
    pk16 = C._swar_pack_fn("rank16")(u64)
    fn16 = C._pair_counts_swar_fn("gtlt16", m, 8192)
    t_pl, t_pl_med = _timed(fn16, pk16, ia, ib)
    extra["pairlist_rank16_pairs_per_sec"] = round(P / t_pl)
    _log(f"pair-list counts (rank16 gtlt, 1M pairs): {t_pl*1e3:.2f} ms "
         f"(med {t_pl_med*1e3:.2f}) = {P/t_pl/1e9:.2f} G pairs/s")

    # ------------------------------------------------------------------
    # sketch phase: fused encode+hash+OPH device step, and the native
    # host engine on the same batch
    # ------------------------------------------------------------------
    from dashing2_tpu import hashing as H
    from dashing2_tpu.enums import Alphabet
    from dashing2_tpu.sketch.core import _fused_oph_fn, _hkw_key
    R, L = 256, 32768
    hkw = dict(k=31, w=31, canon=True, alphabet=Alphabet.DNA,
               entmin=False, xormask=H.XORMASK, seed_is_zero=False,
               downsample_threshold=(1 << 64) - 1, chunk_len=L,
               span=31, spacing_offsets=None, rolling=False,
               use128=False)
    fsk = _fused_oph_fn(_hkw_key(hkw), m, H.OPH_DEFAULT_SEED, False,
                        False, "sort")
    codes = jnp.asarray(rng.integers(0, 4, size=(R, L)).astype(np.uint8))
    t_sk, t_sk_med = _timed(fsk, codes, jnp.zeros(1, jnp.uint64), reps=3)
    extra["sketch_gbase_per_sec"] = round(R * L / t_sk / 1e9, 3)
    _log(f"fused sketch step (sort engine): {t_sk*1e3:.2f} ms/batch "
         f"(med {t_sk_med*1e3:.2f}) = {R*L/t_sk/1e9:.3f} Gbase/s")

    from dashing2_tpu import native as NAT
    from dashing2_tpu.sketch.core import _native_oph_rows
    lib = NAT.load_oph_lib()
    if lib is None:
        raise SystemExit("native sketch engine unavailable (no g++?)")
    cnp = np.asarray(codes)
    _native_oph_rows(lib, cnp, hkw, m, H.OPH_DEFAULT_SEED, False)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        _native_oph_rows(lib, cnp, hkw, m, H.OPH_DEFAULT_SEED, False)
        ts.append(time.perf_counter() - t0)
    extra["sketch_native_mbase_per_sec"] = round(cnp.size / min(ts) / 1e6,
                                                 1)
    _log(f"native host sketch engine: {min(ts)*1e3:.1f} ms/batch = "
         f"{cnp.size/min(ts)/1e6:.0f} Mbase/s")

    pps = up / t_head_min
    print(json.dumps({
        "metric": "fastcmp0.5_bbit_similarity_unique_pairs_per_sec",
        "value": round(pps),
        "unit": "pairs/s",
        "vs_baseline": round(pps / _denom("count_eq_nibble"), 2),
        "baseline_source": ("BASELINE_MEASURED.json projected_32t"
                            if BASE else "round-1 calibration constant"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "engine_mode": mode,
        "n": n, "m": m,
        "t_min_ms": round(t_head_min * 1e3, 3),
        "t_median_ms": round(t_head_med * 1e3, 3),
        "nibble_ab_pairs_per_sec": round(up / t_ab_min),
        **extra,
    }))


if __name__ == "__main__":
    main()
