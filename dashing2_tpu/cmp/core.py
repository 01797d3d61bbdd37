"""Comparison core: densify -> compress -> tiled device counts -> measures.

Reference: cmp_core (/root/reference/src/cmp_core.cpp:615-812) and
make_compressed (:209-322). Instead of the reference's per-pair compare()
inside an OpenMP loop, whole row-blocks of the register matrix flow through
the tiled device kernels (ops/cmp_kernels) and the measure transforms run
vectorized on the count matrices (cmp/estimators).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import hashing as H
from ..config import Dashing2DistOptions
from ..enums import KmerSketchResultType, Measure, OutputKind, SketchSpace
from ..ops import cmp_kernels as CK
from ..ops import sketch_kernels as SK
from ..result import SketchingResult
from . import estimators as E

# q values per register width for setsketch quantization
# (cmp_core.cpp:248)
_QLUT = {1.0: 254.3, 2.0: 65534.0, 4.0: 4294967294.0,
         8.0: 18446744073709551615.0, 0.5: 15.4}

_BBIT_SHIFT = {1.0: 58, 2.0: 48, 4.0: 32, 8.0: 0}


@dataclasses.dataclass
class CompressedReps:
    data: Optional[np.ndarray]   # (N, m) small-int regs or (N, m/2) packed nibbles
    a: float = -1.0
    b: float = -1.0
    truncation: int = 0
    nibble_packed: bool = False


def make_compressed(opts: Dashing2DistOptions, sigs: np.ndarray,
                    kmers: Optional[np.ndarray]) -> CompressedReps:
    """Quantize/truncate f64 signatures to fd_level-byte registers
    (cmp_core.cpp:209-322)."""
    fd = opts.fd_level
    if fd >= 8.0 and not opts.sketch_compressed_set:
        return CompressedReps(data=None)
    if opts.sketch_compressed_set:
        # signatures were sketched directly into quantized registers
        return CompressedReps(data=sigs, a=opts.compressed_a,
                              b=opts.compressed_b,
                              truncation=opts.truncation_method)
    nsigs = sigs.size
    if opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE:
        # OMH registers are u64 hashes stored in the signature slot; take
        # low bytes (cmp_core.cpp:228-245)
        sptr = sigs.view(np.uint64).reshape(sigs.shape)
        if fd == 0.5:
            flat = sptr.reshape(-1)
            packed = ((flat[0::2] & np.uint64(0xF))
                      | ((flat[1::2] & np.uint64(0xF)) << np.uint64(4)))
            return CompressedReps(packed.astype(np.uint8).reshape(
                sigs.shape[0], -1), truncation=1, nibble_packed=True)
        dt = {1.0: np.uint8, 2.0: np.uint16, 4.0: np.uint32,
              8.0: np.uint64}[fd]
        return CompressedReps(sptr.astype(dt), truncation=1)
    if opts.truncation_method <= 0:
        q = _QLUT[fd]
        a, b = opts.compressed_a, opts.compressed_b
        if a <= 0 or b <= 0:
            flat = sigs.reshape(-1)
            live = (flat > 0) & (flat != np.finfo(np.float64).max)
            if not live.any():
                raise ValueError("no live registers to calibrate a/b")
            minreg = float(flat[live].min())
            maxreg = float(flat[live].max())
            b, a = E.optimal_parameters(minreg, maxreg, q)
        if a == 0.0 or np.isinf(b):
            bb = dataclasses.replace(opts, truncation_method=1)
            return make_compressed(bb, sigs, kmers)
        logbinv = 1.0 / np.log1p(b - 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            sub = 1.0 - np.log(sigs / a) * logbinv
        if fd == 0.5:
            v = np.clip(sub, 0, int(q) + 1).astype(np.int64)
            flat = v.reshape(-1)
            packed = (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8)
            return CompressedReps(packed.reshape(sigs.shape[0], -1), a=a,
                                  b=b, truncation=0, nibble_packed=True)
        if fd == 8.0:
            v = np.minimum(np.where(sub < 0, np.uint64(0xFFFFFFFFFFFFFFFF),
                                    sub.astype(np.uint64)),
                           np.uint64(0xFFFFFFFFFFFFFFFF))
            return CompressedReps(v, a=a, b=b, truncation=0)
        dt = {1.0: np.uint8, 2.0: np.uint16, 4.0: np.uint32}[fd]
        v = np.clip(np.nan_to_num(sub, nan=0.0, posinf=q + 1, neginf=0.0),
                    0, int(q) + 1).astype(np.int64)
        return CompressedReps(v.astype(dt), a=a, b=b, truncation=0)
    # b-bit truncation (cmp_core.cpp:293-320)
    if fd == 0.5:
        # fused native reg2sig+nibble-pack when the toolchain is up
        # (bit-identical; the numpy chain cost 0.85 s of the
        # north-star's 11 s warm wall), numpy otherwise
        src = (kmers.astype(np.uint64)
               if kmers is not None and kmers.size == nsigs
               else sigs.view(np.uint64).reshape(sigs.shape))
        xorv = (0 if kmers is not None and kmers.size == nsigs
                else H.REG2SIG_XOR)
        nat = _native_helper()
        if nat is not None:
            import ctypes
            flat = np.ascontiguousarray(src).reshape(-1)
            packed = np.empty((flat.size + 1) // 2, np.uint8)
            nat.reg2sig_nibble(
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                flat.size, xorv & 0xFFFFFFFFFFFFFFFF,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            return CompressedReps(packed.reshape(sigs.shape[0], -1),
                                  truncation=1, nibble_packed=True)
    if kmers is not None and kmers.size == nsigs:
        sig64 = H.wanghash(kmers.astype(np.uint64))
    else:
        sig64 = H.reg2sig(sigs.view(np.uint64).reshape(sigs.shape))
    if fd == 0.5:
        flat = sig64.reshape(-1)
        packed = ((flat[0::2] & np.uint64(0xF))
                  | ((flat[1::2] & np.uint64(0xF)) << np.uint64(4)))
        return CompressedReps(packed.astype(np.uint8).reshape(
            sigs.shape[0], -1), truncation=1, nibble_packed=True)
    shift = _BBIT_SHIFT[fd]
    shifted = sig64 >> np.uint64(shift)
    dt = {1.0: np.uint8, 2.0: np.uint16, 4.0: np.uint32, 8.0: np.uint64}[fd]
    return CompressedReps(shifted.astype(dt), truncation=1)


# ----------------------------------------------------------------------
# pairwise matrix computation
# ----------------------------------------------------------------------

def _prep(opts: Dashing2DistOptions, result: SketchingResult
          ) -> Tuple[CompressedReps, SketchingResult]:
    if opts.kmer_result == KmerSketchResultType.ONE_PERM and \
            result.signatures is not None:
        sigs = result.signatures
        m = sigs.shape[1]
        # OPH signatures carry a per-sketch scale -1/(m - n_empty)
        # (oph.h:253). Cross-sketch register comparisons need a UNIFORM
        # scale or equal raw registers compare unequal when the sketches'
        # empty counts differ (a reference pathology visible only for
        # inputs small vs m: densify() fills slots but keeps the skewed
        # scale). Deviation: rescale each row to the canonical -1/m
        # before densifying (README "Documented deviations").
        nempty = (sigs == 0.0).sum(axis=1)
        scale = np.where(nempty > 0, (m - nempty) / m, 1.0)
        if not sigs.flags.writeable:
            # e.g. np.load(..., mmap_mode='r'): the rescale + densify
            # below finalize the result's signatures in place by design
            # (repeat calls are no-ops: after densification nempty == 0)
            sigs = np.array(sigs)
            result.signatures = sigs
        sigs *= scale[:, None]
        kmers = (result.kmers if result.kmers is not None
                 and result.kmers.shape == sigs.shape else None)
        if kmers is not None and not kmers.flags.writeable:
            kmers = np.array(kmers)
            result.kmers = kmers
        SK.oph_densify_rows(sigs, kmers)
    creps = (make_compressed(opts, result.signatures, result.kmers)
             if result.signatures is not None else CompressedReps(data=None))
    return creps, result


# Comparison engines per platform (DASHING2_TPU_KERNEL overrides):
# 'xla' plain XLA (u64-limb circulant, full-square nibble dots); 'swar'
# the SWAR packed-word engines for word registers at any N; 'tri' SWAR
# from N >= 64 plus the triangular eq+gt nibble kernel (ops/pallas_cmp,
# --fastcmp 0.5 a/b jobs). GPU entry from the card's timings at
# N=10240, m=1024 (H100 80GB HBM3, 700 W; PERF.md): full-register job
# SWAR 15.9 ms vs circulant 132 ms, nibble a/b job kernel 4.2 ms vs
# full-square dots 6.2 ms.
_PLATFORM_KERNEL = {"cpu": "xla", "gpu": "tri"}
_KERNEL_MODES = ("xla", "swar", "tri")


def _kernel_mode() -> str:
    """The comparison-engine mode for this process's platform."""
    import os

    import jax
    mode = os.environ.get("DASHING2_TPU_KERNEL", "auto")
    if mode == "auto":
        plat = jax.devices()[0].platform
        if plat not in _PLATFORM_KERNEL:
            raise RuntimeError(
                f"no comparison-engine policy for platform {plat!r}")
        return _PLATFORM_KERNEL[plat]
    if mode not in _KERNEL_MODES:
        raise ValueError(f"DASHING2_TPU_KERNEL={mode!r}: expected one of "
                         f"{', '.join(_KERNEL_MODES)}")
    return mode


def _ordered_bits(opts: Dashing2DistOptions, sigs: np.ndarray) -> np.ndarray:
    """Signatures -> order-preserving unsigned bit patterns. f64 -> u64
    by default; with regt32 (the RegT=float build analogue) registers
    round to f32 and compare as u32 (both sides round identically, so
    the estimator sees the float build's gt/lt counts)."""
    if opts.regt32:
        # same loud failure as f64_to_ordered_u64: a negative signature
        # would silently invert the gt/lt ordering under the u32 view
        if np.signbit(sigs).any():
            raise ValueError("negative signature values cannot be "
                             "order-mapped to u32")
        return sigs.astype(np.float32).view(np.uint32)
    return CK.f64_to_ordered_u64(sigs)


def _ordered_cached(opts: Dashing2DistOptions,
                    result: SketchingResult) -> np.ndarray:
    """_ordered_bits over the FULL signature matrix, computed once per
    (result, regt32) and cached on the result — the generic row-block
    loop would otherwise redo the O(N*m) conversion for every block."""
    key = bool(opts.regt32)
    cache = getattr(result, "_ordered_cache", None)
    if cache is None or cache[0] != key:
        cache = (key, _ordered_bits(opts, result.signatures))
        result._ordered_cache = cache
    return cache[1]


def _unpack_nibbles(x: np.ndarray) -> np.ndarray:
    lo = x & 0xF
    hi = x >> 4
    return np.concatenate([lo, hi], axis=1)


def _counts_int(a: np.ndarray, b: np.ndarray, want_gtlt: bool):
    """(eq, gt, lt) for small-int register matrices via the XLA tiles."""
    if want_gtlt:
        gt, lt = CK.count_gtlt(a, b)
        eq = a.shape[1] - np.asarray(gt) - np.asarray(lt)
        return eq, np.asarray(gt), np.asarray(lt)
    return np.asarray(CK.count_eq(a, b)), None, None


@functools.lru_cache(maxsize=16)
def _block_counts_swar_fn(mode: str, m: int):
    """Jitted (rows x cols) block counts over the cached packed matrix:
    device row gathers + the rectangular SWAR tiles."""
    import jax
    import jax.numpy as jnp

    from ..ops.cmp_kernels import (_EQ_TILES, count_eq_packed,
                                   count_gtlt_packed16)

    @jax.jit
    def f(pk, rows, cols):
        a = jnp.take(pk, rows, axis=0)
        b = jnp.take(pk, cols, axis=0)
        if mode in _EQ_TILES:
            eq = count_eq_packed(a, b, m, mode=mode)
            return eq, eq, eq
        gt, lt = count_gtlt_packed16(a, b, mode=mode)
        return jnp.int32(m) - gt - lt, gt, lt
    return f


def _device_block_counts(opts, result, creps, rows, cols):
    """Row-block counts through the same cached SWAR packings as the
    pair-list path (shared per-result device cache, so block jobs and
    the refine/dedup loops reuse one packed matrix). None -> host
    blocks. Nibble representations keep their one-hot dot engines."""
    import os

    import jax
    import jax.numpy as jnp
    nprod = len(rows) * len(cols)
    force = os.environ.get("DASHING2_TPU_PAIR_DEVICE", "") == "force"
    if not force and (jax.default_backend() == "cpu"
                      or nprod < (1 << 20)):
        return None
    if creps.nibble_packed:
        return None
    info = _rep_device_cache(opts, result, creps)
    if info is None:
        return None
    cache, key, data, want = info
    entry = _prepare_pack_entry(data, want, nprod, cache, key + "_dev")
    if entry[0] != "swar":
        return None
    _, pk, mode, mtrue = entry
    fn = _block_counts_swar_fn(mode, mtrue)
    eq, gt, lt = fn(pk, jnp.asarray(rows.astype(np.int32)),
                    jnp.asarray(cols.astype(np.int32)))
    if want == "eq":
        if _consumes_gtlt(opts, creps):
            # sum-first estimators ('full', 'ab' fd >= 8): eq-only
            # engines feed them exactly via gt' + lt' = m - eq
            eq = np.asarray(eq)
            return None, mtrue - eq, np.zeros_like(eq)
        return np.asarray(eq), None, None
    return None, np.asarray(gt), np.asarray(lt)


@functools.lru_cache(maxsize=32)
def _block_measures_swar_fn(kind: str, pmode: str, mtrue: int, m: int,
                            msr: Measure, k: int, fd: float):
    """Fully-fused row-block engine over the CACHED packed matrix:
    device row gathers -> rectangular SWAR counts -> f32 estimator
    epilogue, one jit, f32 measures out. Unlike _block_matrix_swar_fn
    (the multi-host driver's form, which packs inside the jit and keys
    on static [lo, hi)), this takes runtime row/col index vectors so
    every block of an N > SELF_MAX job shares ONE compiled program and
    one packing. Counts use mtrue (the packed register count); the
    epilogue uses the job's sketchsize m, mirroring the host
    _count_matrices -> _dispatch_measures split exactly (same f32
    epilogues -> bit-identical blocks)."""
    import jax
    import jax.numpy as jnp

    from ..ops.cmp_kernels import count_eq_packed, count_gtlt_packed16

    @jax.jit
    def f(pk, rows, cols, cards, b, gbt, gbinv):
        a = jnp.take(pk, rows, axis=0)
        bb = jnp.take(pk, cols, axis=0)
        if pmode.startswith("gtlt"):
            c1, c2 = count_gtlt_packed16(a, bb, mode=pmode)
        else:
            eq = count_eq_packed(a, bb, mtrue, mode=pmode)
            if kind in ("eqfull", "bbit"):
                c1, c2 = eq, None
            else:
                # sum-first estimators ('full', 'ab' fd >= 8) accept any
                # (gt', lt') with gt' + lt' = mtrue - eq
                c1 = jnp.int32(mtrue) - eq
                c2 = jnp.zeros_like(eq)
        lh = jnp.take(cards, rows)
        rh = jnp.take(cards, cols)
        return _tiled_epilogue(kind, m, msr, k, fd, c1, c2, lh, rh, b,
                               (gbt, gbinv))
    return f


@functools.lru_cache(maxsize=32)
def _block_measures_swar_sharded_fn(kind: str, pmode: str, mtrue: int,
                                    m: int, msr: Measure, k: int,
                                    fd: float, ndev: int, nrows: int):
    """Mesh-sharded form of _block_measures_swar_fn: the block's rows
    shard over the devices (each chip gathers its row slice from the
    replicated packed matrix and compares against all columns, zero
    cross-device communication); the f32 epilogue runs outside the
    shard_map and GSPMD keeps it row-sharded. The caller pads rows to a
    multiple of ndev; the pad is sliced off INSIDE the jit (nrows is
    static) so no padded rows cross device->host."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from ..ops.cmp_kernels import count_eq_packed, count_gtlt_packed16

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))

    @jax.jit
    def f(pk, rows, cols, cards, b, gbt, gbinv):
        a = jnp.take(pk, rows, axis=0)
        bb = jnp.take(pk, cols, axis=0)

        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P("rows", None), P(None, None)),
            out_specs=(P("rows", None), P("rows", None)))
        def counts(ab, ball):
            if pmode.startswith("gtlt"):
                return count_gtlt_packed16(ab, ball, mode=pmode)
            eq = count_eq_packed(ab, ball, mtrue, mode=pmode)
            if kind in ("eqfull", "bbit"):
                return eq, jnp.zeros_like(eq)
            return jnp.int32(mtrue) - eq, jnp.zeros_like(eq)

        c1, c2 = counts(a, bb)
        if not pmode.startswith("gtlt") and kind in ("eqfull", "bbit"):
            c2 = None
        lh = jnp.take(cards, rows)
        rh = jnp.take(cards, cols)
        out = _tiled_epilogue(kind, m, msr, k, fd, c1, c2, lh, rh, b,
                              (gbt, gbinv))
        return out[:nrows]
    return f


def _device_block_measures(opts, result, creps, rows, cols):
    """Fused device f32 measure block, returned as a DEVICE array so
    pairwise_matrix can pipeline the device->host pull of block b
    against block b+1's compute and the consumer's emit of b-1. None ->
    the caller runs _measure_block (host epilogue). With >1 device
    attached the block's rows shard over the mesh
    (_block_measures_swar_sharded_fn)."""
    import os

    import jax
    import jax.numpy as jnp
    nprod = len(rows) * len(cols)
    force = os.environ.get("DASHING2_TPU_PAIR_DEVICE", "") == "force"
    if not force and (jax.default_backend() == "cpu"
                      or nprod < (1 << 20)):
        return None
    if creps.nibble_packed:
        return None
    info = _rep_device_cache(opts, result, creps)
    if info is None:
        return None
    cache, key, data, want = info
    entry = _prepare_pack_entry(data, want, nprod, cache, key + "_dev")
    if entry[0] != "swar":
        return None
    _, pk, pmode, mtrue = entry
    kind, _ = _representation(opts, result, creps)
    ckey = key + "_cards"
    if ckey not in cache:
        cache[ckey] = jnp.asarray(
            np.asarray(result.cardinalities, np.float64))
    bf = max(creps.b, 1.0 + 1e-9)
    gbt, gbinv = _gb_args(bf, opts.sketchsize)
    ndev = len(jax.devices())
    if ndev > 1 and len(rows) >= ndev \
            and os.environ.get("DASHING2_TPU_MULTICHIP", "1") != "0":
        pad = (-len(rows)) % ndev
        rowsp = np.concatenate(
            [rows, np.full(pad, rows[-1], rows.dtype)]) if pad else rows
        fn = _block_measures_swar_sharded_fn(
            kind, pmode, mtrue, opts.sketchsize, opts.measure, opts.k,
            opts.fd_level, ndev, len(rows))
        return fn(pk, jnp.asarray(rowsp.astype(np.int32)),
                  jnp.asarray(cols.astype(np.int32)), cache[ckey],
                  np.float64(bf), gbt, gbinv)
    fn = _block_measures_swar_fn(kind, pmode, mtrue, opts.sketchsize,
                                 opts.measure, opts.k, opts.fd_level)
    return fn(pk, jnp.asarray(rows.astype(np.int32)),
              jnp.asarray(cols.astype(np.int32)), cache[ckey],
              np.float64(bf), gbt, gbinv)


@functools.lru_cache(maxsize=32)
def _block_counts_u16_fn(pmode: str, mtrue: int):
    """Jitted row-block eq counts as u16 (counts-pull variant of
    _block_measures_swar_fn: gathers + SWAR counts on device, epilogue
    on host from the pulled u16 block — see _counts_pull_on)."""
    import jax
    import jax.numpy as jnp

    from ..ops.cmp_kernels import count_eq_packed

    @jax.jit
    def f(pk, rows, cols):
        a = jnp.take(pk, rows, axis=0)
        bb = jnp.take(pk, cols, axis=0)
        return count_eq_packed(a, bb, mtrue, mode=pmode
                               ).astype(jnp.uint16)
    return f


def _device_block_counts_pull(opts, result, creps, rows, cols):
    """(device u16 eq block, host epilogue closure) — the counts-pull
    variant of _device_block_measures, or None -> fused f32 block.
    Same engagement guards; multi-chip meshes keep the f32 sharded
    engine. The closure takes (pulled u16 block, col offset into
    `cols` for upper_only slices)."""
    import os

    import jax
    import jax.numpy as jnp
    nprod = len(rows) * len(cols)
    force = os.environ.get("DASHING2_TPU_PAIR_DEVICE", "") == "force"
    if not force and (jax.default_backend() == "cpu"
                      or nprod < (1 << 20)):
        return None
    if creps.nibble_packed:
        return None
    kind, _ = _representation(opts, result, creps)
    if not _counts_pull_on(kind, opts.measure, opts.sketchsize):
        return None
    _sim_table(kind, opts.sketchsize, opts.k, opts.fd_level)  # warm jit
    ndev = len(jax.devices())
    if ndev > 1 and len(rows) >= ndev \
            and os.environ.get("DASHING2_TPU_MULTICHIP", "1") != "0":
        return None
    info = _rep_device_cache(opts, result, creps)
    if info is None:
        return None
    cache, key, data, want = info
    entry = _prepare_pack_entry(data, want, nprod, cache, key + "_dev")
    if entry[0] != "swar":
        return None
    _, pk, pmode, mtrue = entry
    if not pmode.startswith("eq") or mtrue != opts.sketchsize:
        return None     # the sim table indexes counts in m-space
    dev = _block_counts_u16_fn(pmode, mtrue)(
        pk, jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(cols.astype(np.int32)))
    cards = np.asarray(result.cardinalities, np.float64)
    m, msr, k, fd = opts.sketchsize, opts.measure, opts.k, opts.fd_level
    lh = cards[rows][:, None]
    rhf = cards[cols]

    def epi(eqc: np.ndarray, col_off: int) -> np.ndarray:
        rh = rhf[None, col_off:col_off + eqc.shape[1]]
        return _host_counts_epilogue(kind, m, msr, k, fd, eqc, lh, rh,
                                     mtrue)
    return dev, epi


def _consumes_gtlt(opts: Dashing2DistOptions,
                   creps: CompressedReps) -> bool:
    """True when the representation's estimator takes (gt, lt) count
    inputs ('full' ordered registers; a/b-quantized kinds) rather than
    eq. Note the SUM-FIRST subset ('full', and 'ab' at fd >= 8) accepts
    any (gt', lt') with gt' + lt' = gt + lt — see _swar_pack."""
    if creps.data is not None:
        return creps.truncation <= 0
    return (opts.sspace == SketchSpace.SPACE_SET
            and opts.truncation_method <= 0)


def _count_matrices(opts: Dashing2DistOptions, result: SketchingResult,
                    creps: CompressedReps, rows: np.ndarray,
                    cols: np.ndarray):
    """Compute (eq, gt, lt) int32 count matrices for row-index arrays
    rows x cols. Only the matrices the estimator needs are non-None."""
    dev = _device_block_counts(opts, result, creps, rows, cols)
    if dev is not None:
        return dev
    if creps.data is not None:
        A = creps.data[rows]
        B = creps.data[cols]
        if creps.nibble_packed:
            A = _unpack_nibbles(A)
            B = _unpack_nibbles(B)
        if A.dtype == np.uint64:
            if creps.truncation > 0:
                eq = np.asarray(CK.count_eq(A, B))
                return eq, None, None
            gt, lt = CK.count_gtlt(A, B)
            return None, np.asarray(gt), np.asarray(lt)
        want_gtlt = creps.truncation <= 0
        eq, gt, lt = _counts_int(A, B, want_gtlt)
        if want_gtlt:
            return None, gt, lt
        return eq, None, None
    # full-register path
    sigs = result.signatures
    if opts.sspace == SketchSpace.SPACE_SET and opts.truncation_method <= 0:
        u = _ordered_cached(opts, result)
        gt, lt = CK.count_gtlt(u[rows], u[cols])
        return None, np.asarray(gt), np.asarray(lt)
    use_kmers = (result.kmers is not None
                 and result.kmers.size == sigs.size)
    src = result.kmers if use_kmers else sigs.view(np.uint64).reshape(sigs.shape)
    eq = CK.count_eq(src[rows], src[cols])
    return np.asarray(eq), None, None


def _dispatch_measures(opts: Dashing2DistOptions, creps: CompressedReps,
                       eq, gt, lt, lh, rh, xp=np) -> np.ndarray:
    m = opts.sketchsize
    msr = opts.measure
    k = opts.k
    if creps.data is not None:
        if creps.nibble_packed:
            # f32 estimator variants shared with the device fused path
            # (see _measure_epilogue) so host and device agree
            if creps.truncation > 0:
                return E.bbit_measures32(eq, m, opts.fd_level, lh, rh,
                                         msr, k, xp=xp)
            return E.compressed_ab_measures32(
                gt, lt, m, max(creps.b, 1.0 + 1e-9), opts.fd_level,
                lh, rh, msr, k, xp=xp)
        if creps.truncation > 0:
            return E.bbit_measures32(eq, m, opts.fd_level, lh, rh, msr, k,
                                     xp=xp)
        # f32 g_b epilogue for ALL a/b-quantized widths (see
        # _measure_epilogue "ab" note; README deviation entry)
        return E.compressed_ab_measures32(
            gt, lt, m, max(creps.b, 1.0 + 1e-9), opts.fd_level,
            lh, rh, msr, k, xp=xp, gb_form="complement")
    if gt is not None:
        return E.full_setsketch_measures32(gt, lt, m, lh, rh, msr, k,
                                           xp=xp)
    return E.equality_measures32(eq, m, lh, rh, msr, k, xp=xp)


def _measure_block(opts: Dashing2DistOptions, result: SketchingResult,
                   creps: CompressedReps, rows: np.ndarray,
                   cols: np.ndarray) -> np.ndarray:
    """The full compare() dispatch for a block of pairs -> f32 matrix."""
    cards = result.cardinalities
    lh = cards[rows][:, None]
    rh = cards[cols][None, :]
    if opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE and (
            opts.exact_kmer_dist or opts.measure == Measure.M_EDIT_DISTANCE):
        from .editdist import edit_distances_pairs
        ia = np.repeat(rows, len(cols))
        ib = np.tile(cols, len(rows))
        return edit_distances_pairs(result, ia, ib).reshape(
            len(rows), len(cols)).astype(np.float32)
    if opts.kmer_result == KmerSketchResultType.FULL_MMER_SEQUENCE:
        from .wcompare import mmer_sequence_pairs
        ia = np.repeat(rows, len(cols))
        ib = np.tile(cols, len(rows))
        return mmer_sequence_pairs(opts, result, ia, ib).reshape(
            len(rows), len(cols)).astype(np.float32)
    if opts.kmer_result >= KmerSketchResultType.FULL_MMER_SET:
        from .wcompare import exact_intersections
        isz = exact_intersections(result, rows, cols)
        return E.exact_measures(isz, lh, rh, opts.measure,
                                opts.k).astype(np.float32)
    eq, gt, lt = _count_matrices(opts, result, creps, rows, cols)
    return _dispatch_measures(opts, creps, eq, gt, lt, lh, rh
                              ).astype(np.float32)



def _measure_epilogue(kind: str, m: int, msr: Measure, k: int, fd: float,
                      c1, c2, lh, rh, b, xp, gb=None):
    """Measure math for one count block; c1/c2: (eq, None) or (gt, lt).

    Every kind runs the f32 estimator variants (README deviation: f32
    estimator epilogues); gb = (bit-product table, 1/(1-1/b))
    precomputed on host — see estimators.gb_bit_table. CPU paths use the
    same f32 math, so outputs agree across backends."""
    if kind in ("nibble-ab", "ab"):
        # both a/b-quantized kinds run the f32 g_b epilogue. Nibble keeps
        # the bit-product form (cross-graph bit-stability for the
        # goldens); the wide widths need the complement recurrence
        # (their b is too close to 1 for f32 c_k).
        t, gi = gb if gb is not None else (None, None)
        return E.compressed_ab_measures32(
            c1, c2, m, b, fd, lh, rh, msr, k, xp=xp, table=t, gbinv=gi,
            gb_form="product" if kind == "nibble-ab" else "complement")
    if kind in ("nibble-bbit", "bbit"):
        return E.bbit_measures32(c1, m, fd, lh, rh, msr, k, xp=xp)
    if kind == "full":
        # f32 epilogue (the DEFAULT mode); the emitted matrix is f32
        # regardless (README deviation: f32 estimator epilogues)
        return E.full_setsketch_measures32(c1, c2, m, lh, rh, msr, k,
                                           xp=xp)
    return E.equality_measures32(c1, m, lh, rh, msr, k, xp=xp)


def _tiled_epilogue(kind, m, msr, k, fd, c1, c2, lh_cards, rh_cards, b,
                    gb=None):
    """Traced: counts -> f32 measure matrix, row-tiled for bounded f64
    temporaries (whole-matrix f64 intermediates at n=10k are ~800MB each
    and blow HBM). Rows (lh_cards) and columns (rh_cards) may differ
    (the distributed row-block path)."""
    import jax
    import jax.numpy as jnp
    nr = c1.shape[0]
    nc = c1.shape[1]
    rh = rh_cards[None, :]
    if nr <= 4096:
        return _measure_epilogue(kind, m, msr, k, fd, c1, c2,
                                 lh_cards[:, None], rh, b, jnp, gb
                                 ).astype(jnp.float32)
    TB = 1024
    pad = (-nr) % TB
    c1p = jnp.concatenate([c1, jnp.zeros((pad, nc), c1.dtype)]) if pad else c1
    c2p = (jnp.concatenate([c2, jnp.zeros((pad, nc), c2.dtype)])
           if (c2 is not None and pad) else c2)
    cp = jnp.concatenate([lh_cards, jnp.ones(pad, lh_cards.dtype)]) \
        if pad else lh_cards
    nb = (nr + pad) // TB
    xs = (c1p.reshape(nb, TB, nc),
          (c2p.reshape(nb, TB, nc) if c2 is not None
           else jnp.zeros((nb, 1, 1), jnp.int32)),
          cp.reshape(nb, TB))

    def body(_, x):
        b1, b2, lhb = x
        return None, _measure_epilogue(
            kind, m, msr, k, fd, b1, b2 if c2 is not None else None,
            lhb[:, None], rh, b, jnp, gb).astype(jnp.float32)

    _, ys = jax.lax.scan(body, None, xs)
    return ys.reshape(nb * TB, nc)[:nr]


def _swar_route(n: int, mode: str) -> bool:
    """Static routing decision for the SWAR packed engines: dense
    per-column ranks (< n <= 32767 < 2^15) pack two per u32 word and
    compare wordwise with popcount accumulation, counts bit-identical to
    the u64 limb compares (rank reduction is order-isomorphic per
    column); past the 2^15 single-half rank bound the two-level pack30
    engines carry the route to n < 2^30. 'swar' takes it at any n,
    'tri' from n >= 64, 'xla' never. Representation kind/fd pick the
    pack density INSIDE _swar_pack, not the route."""
    if mode == "swar":
        return n < (1 << 30)
    return mode == "tri" and 64 <= n < (1 << 30)


def _swar_pack(kind: str, data, m: int, fd: float):
    """Traced: registers -> (packed words, band mode, pad-eq excess).

    The eq-only engines make one pass where gt+lt make two, so they
    run wherever the estimator permits:

    * eq kinds (eqfull/bbit): eq IS the consumed count.
    * 'full' and 'ab' with fd >= 8: the f32 epilogues consume gt/lt
      only through the INTEGER sum gt + lt = m - eq (sum-first
      formulation in full_setsketch_measures32 and the fd>=8 branch of
      compressed_ab_measures32), so feeding (m - eq, 0) is
      bit-identical for ANY m.
    * only 'ab' with fd < 8 needs separate gt/lt (g_b applies to alpha
      and beta individually).

    Word density scales with the value bound: ranks/values < 256 pack
    FOUR bytes per word for eq (eq8, 2x the halves density), and u8
    gt/lt packs four-per-word too via the derived-guard byte engine
    (gtlt8). Mid-size ranks ride pack16; the 3-fields-per-word pack10
    engines survive only as a tested legacy engine (their 10-bit field
    extract/recombine chain outweighed the word savings on the
    accelerator this was first tuned on; not measured on the GPU)."""
    import jax.numpy as jnp

    from ..ops.cmp_kernels import dense_ranks, pack8, pack16
    need_gtlt = kind in ("ab", "nibble-ab") and fd < 8.0
    dt = data.dtype
    n = data.shape[0]
    if not need_gtlt:
        # every eq-consuming kind compares the registers themselves, so
        # u8/u16 values pack directly with no rank pass
        if dt == jnp.uint8:
            packed = pack8(data)
            return packed, "eq8", 4 * packed.shape[1] - m
        if dt == jnp.uint16:
            # full 16-bit range: the general zero-half detect
            packed = pack16(data)
            return packed, "eq16", 2 * packed.shape[1] - m
        # u32/u64/ordered-f64: dense ranks (equality-preserving); the
        # rank bound n picks the densest safe packing (two-level 15-bit
        # halves past the 2^15 single-half bound)
        ranks = dense_ranks(data).astype(jnp.uint32)
        if n <= 256:
            packed = pack8(ranks)
            return packed, "eq8", 4 * packed.shape[1] - m
        if n <= 32767:
            packed = pack16(ranks)
            return packed, "eq15", 2 * packed.shape[1] - m
        from ..ops.cmp_kernels import pack30
        packed = pack30(ranks)
        return packed, "eq30", packed.shape[1] - m
    if dt == jnp.uint8:
        # u8 values: byte pack with the derived-guard gt engine
        from ..ops.cmp_kernels import pack8 as _p8
        return _p8(data), "gtlt8", 0
    # u16/u32 ab gtlt: dense ranks (order-isomorphic, < n)
    ranks = dense_ranks(data).astype(jnp.uint32)
    if n <= 32767:
        return pack16(ranks), "gtlt16", 0
    from ..ops.cmp_kernels import pack30
    return pack30(ranks), "gtlt30", 0


def _swar_fused_matrix(kind: str, data, m: int, fd: float, msr: Measure,
                       k: int, b, gb, cards):
    """Traced: the complete SWAR self-pairs job — packed band-tile
    counts, measure epilogue applied PER TILE (half the full-square
    elements; the emulated-f64 estimator on a materialized N^2 count
    matrix costs more than the counts themselves), f32 assembly via the
    circulant row-segment gather. Mirrors the nibble tri fused path."""
    import jax.numpy as jnp

    from ..enums import Measure as M
    from ..ops.cmp_kernels import (_circ_seg_index, _swar_pad_rows,
                                   circ_assemble, circ_self_swar_tiles)
    n = data.shape[0]
    packed, mode8, extra = _swar_pack(kind, data, m, fd)
    t = max(8, min(512, 1 << max(n - 1, 1).bit_length()))
    a = _swar_pad_rows(packed, t)
    npad = a.shape[0]
    nt = npad // t
    nd = nt // 2 + 1
    xs, ys = circ_self_swar_tiles(a, t=t, mode=mode8)
    if mode8.startswith("gtlt"):
        c1l, c2l = xs, ys                 # gt, lt tiles (ab fd<8 only)
        c1u, c2u = ys, xs
    else:
        eq_t = xs - jnp.int32(extra)
        if kind in ("eqfull", "bbit"):
            c1l, c2l = eq_t, None
        else:
            # full / ab fd>=8: (m - eq, 0) — the sum-first f32
            # epilogues consume only gt + lt
            c1l = jnp.int32(m) - eq_t
            c2l = jnp.zeros_like(eq_t)
        c1u, c2u = c1l, c2l               # symmetric per pair
    cpad = (jnp.concatenate([cards, jnp.ones(npad - n, cards.dtype)])
            if npad != n else cards)
    cb = cpad.reshape(nt, t)
    colblk = (jnp.arange(nt)[None, :]
              + jnp.arange(nd)[:, None]) % nt          # (nd, nt)
    cards_cols = jnp.take(cb, colblk.reshape(-1), axis=0
                          ).reshape(nd, nt, t)
    lh = cb[None, :, :, None]                          # (1, nt, t, 1)
    rh = cards_cols[:, :, None, :]                     # (nd, nt, 1, t)
    L = _measure_epilogue(kind, m, msr, k, fd, c1l, c2l, lh, rh, b,
                          jnp, gb).astype(jnp.float32)
    if msr == M.CONTAINMENT:
        # mirror tile [d, bi, i, j] lands (transposed) at
        # full[col_j, row_i]: left item is the COLUMN block's j-th row,
        # so lh varies along j and rh along i
        U = _measure_epilogue(kind, m, msr, k, fd, c1u, c2u,
                              cards_cols[:, :, None, :],
                              cb[None, :, :, None],
                              b, jnp, gb).astype(jnp.float32)
    else:
        U = L
    seg_idx = jnp.asarray(_circ_seg_index(npad, t))
    return circ_assemble(L, U, seg_idx, npad, t)[:n, :n]


# ---------------------------------------------------------------------------
# u16 counts-pull route: for eq-count representations the f32 measure is a
# pure elementwise IEEE-f32 function of (eq count, cardinalities), identical
# whether XLA evaluates it on device or numpy on host — so only u16 eq counts
# need cross the device->host link (HALF the bytes of the f32 matrix).
# POISSON_LLR stays on the f32 route: its log1p differs between libm and
# XLA in the last ulp.
# ---------------------------------------------------------------------------

_COUNTS_PULL_KINDS = ("full", "eqfull", "bbit", "nibble-bbit")
# packed-pull trapezoid slicing granularity (rows): finer slices trim
# the block over-pull toward the condensed n^2/2 floor at no extra
# pulls; 1024 leaves ~(pb/n)/2 overhead
_PACK_PULL_ROWS = 1024


def _counts_pull_on(kind: str, msr: Measure, m: int) -> bool:
    """Counts-pull route eligibility. DASHING2_TPU_PULL_COUNTS: '1'
    (default, accelerator backends), '0' disables, 'force' enables on
    the CPU backend (tests byte-compare the route against the fused f32
    pull).

    SIMILARITY only: the card-dependent measures divide by per-pair
    runtime values, and a device's f32 divide need not be bit-identical
    to IEEE host division. SIMILARITY is cardinality-free — a pure
    function of the eq count — so the host epilogue is an (m+1)-entry
    sim table computed ON DEVICE once (_sim_table): bit-exact for every
    kind by construction, including bbit's /den, which XLA turns into a
    multiply by the reciprocal (1 ulp from numpy's divide). 'ab' kinds
    are excluded (they consume separate gt/lt — two u16 counts carry no
    byte savings over one f32)."""
    import os
    env = os.environ.get("DASHING2_TPU_PULL_COUNTS", "1")
    if env == "0":
        return False
    if kind not in _COUNTS_PULL_KINDS or msr != Measure.SIMILARITY:
        return False
    if m >= (1 << 16):
        return False
    import jax
    return env == "force" or jax.default_backend() != "cpu"


@functools.lru_cache(maxsize=64)
def _sim_table(kind: str, m: int, k: int, fd: float) -> np.ndarray:
    """(m+1,) f32 SIMILARITY values for every possible eq count,
    computed by the DEVICE epilogue itself (one jit over the count
    range, one 4 KB pull) — the host lookup is bit-exact with the fused
    f32 route whatever the backend's divide/FMA lowering does. Safe
    because the products feeding the sim formulas are exact (integer x
    power-of-two scale), so in-graph FMA contraction cannot change the
    fused route's values vs this standalone graph (see
    bbit_measures32's docstring)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f():
        counts = jnp.arange(m + 1, dtype=jnp.int32)[None, :]
        if kind in ("eqfull", "bbit", "nibble-bbit"):
            c1, c2 = counts, None
        else:
            c1 = jnp.int32(m) - counts
            c2 = jnp.zeros_like(c1)
        one = jnp.ones((1, 1), jnp.float64)
        return _measure_epilogue(kind, m, Measure.SIMILARITY, k, fd,
                                 c1, c2, one, one, 0.0, jnp, None
                                 ).astype(jnp.float32)
    return np.asarray(f()).reshape(-1)


def _host_counts_epilogue(kind: str, m: int, msr: Measure, k: int,
                          fd: float, eqc: np.ndarray, lh, rh,
                          comp_m: int) -> np.ndarray:
    """Host epilogue on a pulled u16 eq-count block: SIMILARITY via the
    device-built sim table (bit-exact with the fused f32 route for
    every kind — see _sim_table). lh/rh/comp_m are unused for
    SIMILARITY but kept so card-dependent measures can be added if a
    backend with IEEE divides warrants them."""
    assert msr == Measure.SIMILARITY
    from ..timing import span
    with span("cmp/epilogue"):
        return _sim_table(kind, m, k, fd)[eqc]


@functools.lru_cache(maxsize=16)
def _pack_tri_counts_fn(n: int, block: int, bits: int):
    """Jitted (n, n) u16 counts -> 1-D u8: the CONDENSED upper
    trapezoid (block-row slices [s:s+b, s:], no lower-left bytes at
    all) with two `bits`-wide counts packed into 3 bytes: one pull of
    1.5 B/count instead of block pulls of 2 B/count with block
    over-pull. Whether it pays over PCIe is not measured. Exact
    round-trip: counts <= m < 2^bits, 2*bits <= 24."""
    import jax
    import jax.numpy as jnp

    def f(cmat):
        segs = [cmat[s:min(s + block, n), s:].reshape(-1)
                for s in range(0, n, block)]
        flat = jnp.concatenate(segs)
        if flat.shape[0] % 2:
            flat = jnp.concatenate(
                [flat, jnp.zeros(1, flat.dtype)])
        # 1-D strided slices + byte-PLANE concat (no (T, 2) or (T, 3)
        # minor-dim intermediates)
        v0 = flat[0::2].astype(jnp.uint32)
        v1 = flat[1::2].astype(jnp.uint32)
        x = v0 | (v1 << jnp.uint32(bits))
        return jnp.concatenate([
            (x & jnp.uint32(0xFF)).astype(jnp.uint8),
            ((x >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.uint8),
            ((x >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.uint8)])
    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def _pack_counts2d_fn(b: int, w: int, bits: int):
    """Jitted (b, w) u16 counts -> 1-D u8 byte planes (2 counts per 3
    bytes) — the generic-block form of _pack_tri_counts_fn, used by
    the N>SELF_MAX row-block and panel counts routes. Same layout
    contract as _unpack_tri_counts."""
    import jax
    import jax.numpy as jnp

    def f(cmat):
        flat = cmat.reshape(-1)
        if flat.shape[0] % 2:
            flat = jnp.concatenate([flat, jnp.zeros(1, flat.dtype)])
        v0 = flat[0::2].astype(jnp.uint32)
        v1 = flat[1::2].astype(jnp.uint32)
        x = v0 | (v1 << jnp.uint32(bits))
        return jnp.concatenate([
            (x & jnp.uint32(0xFF)).astype(jnp.uint8),
            ((x >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.uint8),
            ((x >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.uint8)])
    return jax.jit(f)


def _pack_block_counts(dev, post, m: int):
    """Wrap a pending (device u16 counts block, host epilogue) pair so
    only 1.5 B/count cross device->host: pack on device, unpack in the
    wrapped epilogue. No-op (returns inputs) when count bits exceed
    the 2x12-bit budget or DASHING2_TPU_PACK_PULL=0."""
    import os
    bits = int(m).bit_length()
    if 2 * bits > 24 or os.environ.get("DASHING2_TPU_PACK_PULL",
                                       "1") == "0":
        return dev, post
    b, w = int(dev.shape[0]), int(dev.shape[1])

    def post2(buf, cs_off):
        eqc = _unpack_tri_counts(buf, bits, b * w).reshape(b, w)
        return post(eqc, cs_off)
    return _pack_counts2d_fn(b, w, bits)(dev), post2


def _native_helper():
    """The native perf-helper lib (oph_sketch.cpp's reg2sig_nibble /
    unpack_counts24 entries); None when the toolchain is unavailable
    (numpy fallbacks stay bit-identical)."""
    from .. import native as _nat
    try:
        lib = _nat.load_oph_lib()
    except Exception:
        return None
    if lib is None or not hasattr(lib, "unpack_counts24"):
        return None
    return lib


def _unpack_tri_f32(buf: np.ndarray, bits: int, total: int,
                    table: np.ndarray):
    """Fused native unpack + similarity-table lookup: byte planes ->
    (total,) f32 measure values (identical to gathering `table` at the
    unpacked counts — the table IS the epilogue for the counts route's
    SIMILARITY-only measures). None -> caller uses the u16 path."""
    nat = _native_helper()
    if nat is None or table is None:
        return None
    import ctypes
    table = np.ascontiguousarray(table, np.float32)
    buf = np.ascontiguousarray(buf)
    t2 = buf.shape[0] // 3
    out = np.empty(t2 * 2, np.float32)
    nat.unpack_counts24_f32(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t2, bits,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[:total]


def _unpack_tri_counts(buf: np.ndarray, bits: int,
                       total: int) -> np.ndarray:
    """Host inverse of _pack_tri_counts_fn: three concatenated byte
    planes (3T/2,) u8 -> (total,) u16. Native single pass when the
    toolchain is up (the numpy strided-store form measured 1.3 s for
    57M counts on the north-star wall)."""
    t2 = buf.shape[0] // 3
    nat = _native_helper()
    if nat is not None:
        import ctypes
        buf = np.ascontiguousarray(buf)
        out = np.empty(t2 * 2, np.uint16)
        nat.unpack_counts24(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t2,
            bits, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        return out[:total]
    x = buf[:t2].astype(np.uint32) \
        | (buf[t2:2 * t2].astype(np.uint32) << np.uint32(8)) \
        | (buf[2 * t2:].astype(np.uint32) << np.uint32(16))
    out = np.empty(t2 * 2, np.uint16)
    out[0::2] = (x & np.uint32((1 << bits) - 1)).astype(np.uint16)
    out[1::2] = (x >> np.uint32(bits)).astype(np.uint16)
    return out[:total]


@functools.lru_cache(maxsize=64)
def _self_counts_fn_m(kind: str, m: int, fd: float, mode: str):
    """Jitted (data) -> full (n, n) u16 eq-count matrix: the count
    phase of _self_matrix_fn_m with the measure epilogue left to the
    host (counts-pull route)."""
    import jax
    import jax.numpy as jnp

    def f(data):
        if kind.startswith("nibble"):
            from ..ops.pallas_cmp import nibble_dots
            lo = data & jnp.uint8(0xF)
            hi = data >> jnp.uint8(4)
            regs = jnp.concatenate([lo, hi], axis=1)
            eq, _, _ = nibble_dots(regs, regs, want_gtlt=False)
            return eq.astype(jnp.uint16)
        n = data.shape[0]
        if _swar_route(n, mode):
            from ..ops.cmp_kernels import (_circ_seg_index,
                                           _swar_pad_rows, circ_assemble,
                                           circ_self_swar_tiles)
            packed, mode8, extra = _swar_pack(kind, data, m, fd)
            t = max(8, min(512, 1 << max(n - 1, 1).bit_length()))
            a = _swar_pad_rows(packed, t)
            xs, _ = circ_self_swar_tiles(a, t=t, mode=mode8)
            eq_t = (xs - jnp.int32(extra)).astype(jnp.uint16)
            seg_idx = jnp.asarray(_circ_seg_index(a.shape[0], t))
            return circ_assemble(eq_t, eq_t, seg_idx, a.shape[0],
                                 t)[:n, :n]
        return CK.count_eq_self(data).astype(jnp.uint16)
    return jax.jit(f)


def _self_counts_matrix_dev(opts: Dashing2DistOptions,
                            result: SketchingResult,
                            creps: CompressedReps):
    """(device u16 eq-count matrix, host epilogue closure) for the
    counts-pull route of a symmetric all-pairs job, or None -> the
    fused f32 route. Mirrors _self_pairs_matrix_dev's routing guards;
    multi-chip meshes keep the f32 band-sharded engine (their pulls are
    per-device local, not the job wall). The epilogue closure takes
    (pulled u16 block, row start, col start)."""
    kind, data = _representation(opts, result, creps)
    m = opts.sketchsize
    if not _counts_pull_on(kind, opts.measure, m):
        return None
    if _multichip_mesh() is not None:
        return None
    # build the host sim table NOW so the warm pass pre-pays its tiny
    # jit compile too (lazy build would land on the first emitted block)
    table = _sim_table(kind, m, opts.k, opts.fd_level)
    from ..timing import span
    with span("cmp/dispatch"):
        dev = _self_counts_fn_m(kind, m, opts.fd_level,
                                _kernel_mode())(data)
    cards = np.asarray(result.cardinalities, np.float64)
    msr, k, fd = opts.measure, opts.k, opts.fd_level

    def epi(eqc: np.ndarray, rs: int, cs: int) -> np.ndarray:
        lh = cards[rs:rs + eqc.shape[0], None]
        rh = cards[None, cs:cs + eqc.shape[1]]
        return _host_counts_epilogue(kind, m, msr, k, fd, eqc, lh, rh, m)
    return dev, epi, table


def _self_matrix_fn(kind: str, m: int, msr: Measure, k: int, fd: float):
    """One jitted function per (representation kind, measure, shape
    params, engine mode): see _self_matrix_fn_m. The engine mode is part
    of the cache key so flipping DASHING2_TPU_KERNEL between calls never
    serves a stale route."""
    return _self_matrix_fn_m(kind, m, msr, k, fd, _kernel_mode())


@functools.lru_cache(maxsize=64)
def _self_matrix_fn_m(kind: str, m: int, msr: Measure, k: int, fd: float,
                      mode: str):
    """One jitted function per (representation kind, measure, shape
    params): self-pairs counts + the full measure epilogue fused on
    device, so a single call and a single f32 matrix transfer happen
    per all-pairs job."""
    import jax
    import jax.numpy as jnp

    def f(data, cards, b, gbt, gbinv):
        gb = (gbt, gbinv)
        if kind.startswith("nibble"):
            from ..ops.pallas_cmp import (nibble_dots, tri_counts_tiles,
                                          tri_assemble,
                                          tri_pair_blocks,
                                          tri_self_counts_available)
            lo = data & jnp.uint8(0xF)
            hi = data >> jnp.uint8(4)
            regs = jnp.concatenate([lo, hi], axis=1)
            n = regs.shape[0]
            if kind == "nibble-ab" and mode == "tri" \
                    and tri_self_counts_available(n, regs.shape[1]):
                # the triangular eq+gt kernel (half-square work) with the
                # measure epilogue applied PER TILE and the f32 matrix
                # assembled directly — no full count matrices are ever
                # materialized. For symmetric measures the upper
                # triangle is the lower tiles transposed; CONTAINMENT
                # (row-normalized) needs the swapped-epilogue tiles.
                eq_t, gt_t, T, bm, npad = tri_counts_tiles(regs)
                ii, jj = tri_pair_blocks(T)
                cpad = jnp.concatenate(
                    [cards, jnp.ones(npad - n, cards.dtype)]) \
                    if npad != n else cards
                cb = cpad.reshape(T, bm)
                cardB = jnp.take(cb, jnp.asarray(ii), axis=0)  # (P, bm)
                cardS = jnp.take(cb, jnp.asarray(jj), axis=0)
                lt_t = jnp.int32(m) - eq_t - gt_t
                c1l, c2l = gt_t, lt_t
                c1u, c2u = lt_t, gt_t
                L = _measure_epilogue(
                    kind, m, msr, k, fd, c1l, c2l,
                    cardB[:, :, None], cardS[:, None, :], b, jnp, gb
                ).astype(jnp.float32)
                if msr == Measure.CONTAINMENT:
                    U = _measure_epilogue(
                        kind, m, msr, k, fd, c1u, c2u,
                        cardS[:, None, :], cardB[:, :, None], b, jnp, gb
                    ).astype(jnp.float32)
                else:
                    U = L
                return tri_assemble(L, U, T, bm)[:n, :n]
            eq, gt, lt = nibble_dots(regs, regs,
                                     want_gtlt=(kind == "nibble-ab"))
            c1, c2 = (gt, lt) if kind == "nibble-ab" else (eq, None)
        elif _swar_route(data.shape[0], mode):
            return _swar_fused_matrix(kind, data, m, fd, msr, k, b, gb,
                                      cards)
        elif kind in ("ab", "full"):
            c1, c2 = CK.count_gtlt_self(data)
        else:
            c1, c2 = CK.count_eq_self(data), None
        return _tiled_epilogue(kind, m, msr, k, fd, c1, c2, cards, cards,
                               b, gb)

    return jax.jit(f)


def _panel_matrix_fn(kind: str, m: int, msr: Measure, k: int, fd: float,
                     nf: int):
    return _panel_matrix_fn_m(kind, m, msr, k, fd, nf, _kernel_mode())


@functools.lru_cache(maxsize=64)
def _panel_matrix_fn_m(kind: str, m: int, msr: Measure, k: int, fd: float,
                       nf: int, mode: str):
    """Fused panel (Q x F) engine: ONE jitted call computes the whole
    references x queries measure block — counts via the rectangular
    SWAR/one-hot engines (rank space shared across refs+queries,
    computed once over all rows) + the tiled epilogue. Replaces the
    generic per-row-block _measure_block tiling for nq > 0 jobs."""
    import jax
    import jax.numpy as jnp

    def f(data, cards, b, gbt, gbinv):
        gb = (gbt, gbinv)
        from ..ops.cmp_kernels import count_eq_packed, count_gtlt_packed16
        if kind.startswith("nibble"):
            from ..ops.pallas_cmp import nibble_dots
            lo = data & jnp.uint8(0xF)
            hi = data >> jnp.uint8(4)
            regs = jnp.concatenate([lo, hi], axis=1)
            eq, gt, lt = nibble_dots(regs[:nf], regs[nf:],
                                     want_gtlt=(kind == "nibble-ab"))
            c1, c2 = (gt, lt) if kind == "nibble-ab" else (eq, None)
        else:
            # same engine policy as the self-pairs path (_swar_pack):
            # eq-only wherever the estimator consumes only gt + lt
            packed, pmode, extra = _swar_pack(kind, data, m, fd)
            if pmode.startswith("gtlt"):
                c1, c2 = count_gtlt_packed16(packed[:nf], packed[nf:],
                                             mode=pmode)
            else:
                eq = count_eq_packed(packed[:nf], packed[nf:], m,
                                     mode=pmode)
                if kind in ("eqfull", "bbit"):
                    c1, c2 = eq, None
                else:
                    c1 = jnp.int32(m) - eq
                    c2 = jnp.zeros_like(eq)
        return _tiled_epilogue(kind, m, msr, k, fd, c1, c2,
                               cards[:nf], cards[nf:], b, gb)

    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def _panel_counts_fn_m(kind: str, m: int, fd: float, nf: int, mode: str):
    """Jitted (data) -> (nf, nq) u16 eq-count panel: the count phase of
    _panel_matrix_fn_m with the epilogue left to the host (counts-pull
    route, see _counts_pull_on)."""
    import jax
    import jax.numpy as jnp

    from ..ops.cmp_kernels import count_eq_packed

    def f(data):
        if kind.startswith("nibble"):
            from ..ops.pallas_cmp import nibble_dots
            lo = data & jnp.uint8(0xF)
            hi = data >> jnp.uint8(4)
            regs = jnp.concatenate([lo, hi], axis=1)
            eq, _, _ = nibble_dots(regs[:nf], regs[nf:],
                                   want_gtlt=False)
            return eq.astype(jnp.uint16)
        packed, pmode, _extra = _swar_pack(kind, data, m, fd)
        eq = count_eq_packed(packed[:nf], packed[nf:], m, mode=pmode)
        return eq.astype(jnp.uint16)
    return jax.jit(f)


def _panel_counts_matrix_dev(opts: Dashing2DistOptions,
                             result: SketchingResult,
                             creps: CompressedReps, nf: int):
    """(device u16 eq-count panel, host epilogue closure) for the
    counts-pull route of an nq > 0 job, or None -> the fused f32 panel
    engine. The closure takes (pulled u16 block, reference-row start)."""
    kind, data = _representation(opts, result, creps)
    n = len(result.cardinalities)
    if not _panel_available(kind, data, n, nf):
        return None
    m = opts.sketchsize
    if not _counts_pull_on(kind, opts.measure, m):
        return None
    mesh = _multichip_mesh()
    if mesh is not None and nf >= mesh.devices.size:
        return None
    _sim_table(kind, m, opts.k, opts.fd_level)  # pre-pay the table jit
    dev = _panel_counts_fn_m(kind, m, opts.fd_level, nf,
                             _kernel_mode())(data)
    cards = np.asarray(result.cardinalities, np.float64)
    msr, k, fd = opts.measure, opts.k, opts.fd_level
    rh = cards[None, nf:]

    def epi(eqc: np.ndarray, rs: int) -> np.ndarray:
        lh = cards[rs:rs + eqc.shape[0], None]
        return _host_counts_epilogue(kind, m, msr, k, fd, eqc, lh, rh, m)
    return dev, epi


@functools.lru_cache(maxsize=32)
def _panel_matrix_fn_sharded(kind: str, m: int, msr: Measure, k: int,
                             fd: float, nf: int, mode: str, ndev: int):
    """Multi-chip panel engine: the packing/rank pass runs globally
    (rank space shared across refs+queries), then the rectangular
    counts shard by REFERENCE rows over the mesh (queries replicate —
    they are small) with zero cross-device communication; the epilogue
    stays outside the shard_map and GSPMD keeps it row-sharded."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    nfp = -(-nf // ndev) * ndev
    pad = nfp - nf

    def f(data, cards, b, gbt, gbinv):
        gb = (gbt, gbinv)
        from ..ops.cmp_kernels import count_eq_packed, count_gtlt_packed16
        if kind.startswith("nibble"):
            lo = data & jnp.uint8(0xF)
            hi = data >> jnp.uint8(4)
            regs = jnp.concatenate([lo, hi], axis=1)
            refs, qrys = regs[:nf], regs[nf:]
            pmode = "nibble"
        else:
            packed, pmode, _extra = _swar_pack(kind, data, m, fd)
            refs, qrys = packed[:nf], packed[nf:]
        if pad:
            refs = jnp.concatenate(
                [refs, jnp.zeros((pad, refs.shape[1]), refs.dtype)])

        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P("rows", None), P(None, None)),
            out_specs=(P("rows", None), P("rows", None)))
        def counts(refs_blk, q_all):
            if kind.startswith("nibble"):
                from ..ops.pallas_cmp import nibble_dots
                eq, gt, lt = nibble_dots(refs_blk, q_all,
                                         want_gtlt=(kind == "nibble-ab"))
                return (gt, lt) if kind == "nibble-ab" \
                    else (eq, jnp.zeros_like(eq))
            if pmode.startswith("gtlt"):
                return count_gtlt_packed16(refs_blk, q_all, mode=pmode)
            eq = count_eq_packed(refs_blk, q_all, m, mode=pmode)
            if kind in ("eqfull", "bbit", "nibble-bbit"):
                return eq, jnp.zeros_like(eq)
            return jnp.int32(m) - eq, jnp.zeros_like(eq)

        c1, c2 = counts(refs, qrys)
        c1 = c1[:nf]
        # mirror _panel_matrix_fn: eq-consuming kinds pass c2=None to
        # the epilogue; the "m - eq" word kinds keep the zeros array
        if kind == "nibble-bbit" or (
                not kind.startswith("nibble")
                and not pmode.startswith("gtlt")
                and kind in ("eqfull", "bbit")):
            c2 = None
        else:
            c2 = c2[:nf]
        return _tiled_epilogue(kind, m, msr, k, fd, c1, c2,
                               cards[:nf], cards[nf:], b, gb)

    return jax.jit(f)


def _panel_available(kind: str, data, n: int, nf: int) -> bool:
    """Panels ride the fused engine for nibble kinds (one-hot dots) and for the
    word kinds whenever the SWAR route applies (rank space bounded by
    the total row count)."""
    if kind.startswith("nibble"):
        return True
    return _swar_route(n, _kernel_mode())


# the wrapper keeps an lru_cache surface (tests clear it when
# monkeypatching engine availability)
_self_matrix_fn.cache_clear = _self_matrix_fn_m.cache_clear


@functools.lru_cache(maxsize=64)
def _counts_epilogue_fn(kind: str, m: int, msr: Measure, k: int, fd: float,
                        from_eq: bool = False, eq_extra: int = 0):
    """Jitted epilogue over a precomputed full count matrix (the
    multi-chip path). from_eq=False: input is the gt matrix (lt == gt.T,
    eq == m - gt - gt.T by trichotomy). from_eq=True: input is the eq
    matrix from the eq-only sharded bands — exact for every kind whose
    estimator consumes gt/lt only through gt + lt = m - eq (sum-first
    f32 epilogues; NOT 'ab' with fd < 8)."""
    import jax
    import jax.numpy as jnp

    def f(cnt, cards, b, gbt, gbinv):
        if from_eq:
            eq = cnt - jnp.int32(eq_extra)   # halves incl. packing pad
            if kind in ("eqfull", "bbit", "nibble-bbit"):
                c1, c2 = eq, None
            else:
                c1 = jnp.int32(m) - eq
                c2 = jnp.zeros_like(eq)
        elif kind in ("ab", "full", "nibble-ab"):
            c1, c2 = cnt, cnt.T
        else:
            c1, c2 = jnp.int32(m) - cnt - cnt.T, None
        return _tiled_epilogue(kind, m, msr, k, fd, c1, c2, cards, cards,
                               b, (gbt, gbinv))

    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def _block_matrix_fn(kind: str, m: int, msr: Measure, k: int, fd: float):
    """Fused row-block engine: (rows, m) x (N, m) u64 registers -> f32
    measure block in ONE jitted call (counts + epilogue). Used by the
    multi-host driver for its owned row range."""
    import jax

    def f(rows_data, all_data, lh_cards, rh_cards, b, gbt, gbinv):
        if kind in ("ab", "full", "nibble-ab"):
            c1, c2 = CK.count_gtlt(rows_data, all_data)
        else:
            c1, c2 = CK.count_eq(rows_data, all_data), None
        return _tiled_epilogue(kind, m, msr, k, fd, c1, c2,
                               lh_cards, rh_cards, b, (gbt, gbinv))

    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def _block_matrix_swar_fn(kind: str, m: int, msr: Measure, k: int,
                          fd: float, lo: int, hi: int):
    """SWAR variant of the row-block engine: the full register matrix
    packs ONCE under the shared _swar_pack policy (any rank space must
    span every row the block compares against), and the owned rows
    [lo, hi) compare against all rows via the rectangular packed
    engines — eq-only single scans wherever the estimator consumes
    gt/lt only through their sum, density by the value/rank bound.
    Counts are bit-identical to the u64 form at 2-6x the limb rate."""
    import jax
    import jax.numpy as jnp

    def f(all_data, lh_cards, rh_cards, b, gbt, gbinv):
        from ..ops.cmp_kernels import count_eq_packed, count_gtlt_packed16
        packed, pmode, _ = _swar_pack(kind, all_data, m, fd)
        if pmode.startswith("gtlt"):
            c1, c2 = count_gtlt_packed16(packed[lo:hi], packed,
                                         mode=pmode)
        else:
            eq = count_eq_packed(packed[lo:hi], packed, m, mode=pmode)
            if kind in ("eqfull", "bbit", "nibble-bbit"):
                c1, c2 = eq, None
            else:
                c1 = jnp.int32(m) - eq
                c2 = jnp.zeros_like(eq)
        return _tiled_epilogue(kind, m, msr, k, fd, c1, c2,
                               lh_cards, rh_cards, b, (gbt, gbinv))

    return jax.jit(f)


def _gb_args(b: float, m: int):
    """(bit-product table, 1/(1-1/b)) runtime args for the f32 nibble
    epilogue (estimators.gb_bit_table)."""
    return (E.gb_bit_table(b, m),
            np.float32(1.0 / (1.0 - 1.0 / np.float64(b))))


def _multichip_mesh():
    """Mesh over all local devices when more than one is attached and
    multichip routing is not disabled (DASHING2_TPU_MULTICHIP=0)."""
    import os

    import jax
    if os.environ.get("DASHING2_TPU_MULTICHIP", "1") == "0":
        return None
    if jax.device_count() <= 1:
        return None
    from ..parallel.allpairs import make_mesh
    return make_mesh()


def _representation(opts: Dashing2DistOptions, result: SketchingResult,
                    creps: CompressedReps):
    """(kind, data) for the fused device count engines."""
    if creps.data is not None:
        A = creps.data
        if creps.nibble_packed:
            return ("nibble-bbit" if creps.truncation > 0
                    else "nibble-ab"), A
        return ("bbit" if creps.truncation > 0 else "ab"), A
    if opts.sspace == SketchSpace.SPACE_SET and opts.truncation_method <= 0:
        return "full", _ordered_cached(opts, result)
    sigs = result.signatures
    use_kmers = (result.kmers is not None
                 and result.kmers.size == sigs.size)
    return "eqfull", (result.kmers if use_kmers
                      else sigs.view(np.uint64).reshape(sigs.shape))


def _panel_pairs_matrix(opts: Dashing2DistOptions, result: SketchingResult,
                        creps: CompressedReps, nf: int):
    """Full (nf, nq) f32 measure panel via the fused rectangular engine,
    or None when the representation wants the generic block tiling."""
    kind, data = _representation(opts, result, creps)
    n = len(result.cardinalities)
    if not _panel_available(kind, data, n, nf):
        return None
    cards = np.asarray(result.cardinalities, np.float64)
    bf = max(creps.b, 1.0 + 1e-9)
    gbt, gbinv = _gb_args(bf, opts.sketchsize)
    mesh = _multichip_mesh()
    if mesh is not None and nf >= mesh.devices.size:
        fn = _panel_matrix_fn_sharded(
            kind, opts.sketchsize, opts.measure, opts.k, opts.fd_level,
            nf, _kernel_mode(), int(mesh.devices.size))
    else:
        fn = _panel_matrix_fn(kind, opts.sketchsize, opts.measure,
                              opts.k, opts.fd_level, nf)
    return _pull_block(fn(data, cards, np.float64(bf), gbt, gbinv))


def _self_pairs_matrix(opts: Dashing2DistOptions, result: SketchingResult,
                       creps: CompressedReps):
    """Full (n, n) f32 measure matrix (host ndarray) for a symmetric
    all-pairs job — see _self_pairs_matrix_dev."""
    dev = _self_pairs_matrix_dev(opts, result, creps)
    return None if dev is None else _pull_block(dev)


def _self_pairs_matrix_dev(opts: Dashing2DistOptions,
                           result: SketchingResult,
                           creps: CompressedReps):
    """Full (n, n) f32 measure matrix for a symmetric all-pairs job via
    the fused device self-pairs pipeline, returned as a DEVICE array
    (pairwise_matrix's symmetric upper_only route pulls only the
    per-block upper trapezoids — half the device->host bytes). Returns
    None when the representation wants a different engine. With >1 device
    attached the gt counts come from the band-sharded multi-chip kernel
    (parallel.allpairs.sharded_selfpairs) — each chip owns 1/D of the
    unique-pair work — and the measure epilogue runs jitted on the
    replicated count matrix."""
    kind, data = _representation(opts, result, creps)
    cards = np.asarray(result.cardinalities, np.float64)
    bf = max(creps.b, 1.0 + 1e-9)
    b = np.float64(bf)
    gbt, gbinv = _gb_args(bf, opts.sketchsize)
    mesh = _multichip_mesh()
    if mesh is not None:
        from ..parallel.allpairs import sharded_selfpairs
        d = data
        if kind.startswith("nibble"):
            d = _unpack_nibbles(np.asarray(d))
        n = d.shape[0]
        m = opts.sketchsize
        if n < (1 << 30) and _kernel_mode() != "xla":
            # SWAR packed words: 2-6x the u64 limb compare rate and a
            # fraction of the replicated bytes per chip (counts
            # bit-identical — equality survives any injective relabel,
            # order the rank reduction). Same density policy as the
            # single-chip _swar_pack: u8/u16 values pack directly, wider
            # registers rank first, and the value/rank bound picks
            # 4-, 3- or 2-fields-per-word engines. Kinds whose estimator
            # consumes only gt + lt ride eq-only bands (one pass per
            # band instead of two).
            import jax
            import jax.numpy as jnp

            from ..parallel.allpairs import pack_words_np
            dnp = np.asarray(d)
            eq_ok = not (kind in ("ab", "nibble-ab")
                         and opts.fd_level < 8.0)
            if eq_ok:
                if dnp.dtype == np.uint8:
                    vals, pmode = dnp, "eq8"
                elif dnp.dtype == np.uint16:
                    vals, pmode = dnp, "eq16"
                else:
                    vals = np.asarray(jax.jit(CK.dense_ranks)(
                        jnp.asarray(dnp))).astype(np.uint32)
                    pmode = ("eq8" if n <= 256 else
                             "eq15" if n <= 32767 else "eq30")
            elif dnp.dtype == np.uint8:
                vals, pmode = dnp, "gtlt8"
            else:
                vals = np.asarray(jax.jit(CK.dense_ranks)(
                    jnp.asarray(dnp))).astype(np.uint32)
                pmode = ("gtlt16" if n <= 32767 else "gtlt30")
            packed = pack_words_np(vals, pmode)
            cnt = sharded_selfpairs(mesh, packed, mode=pmode)
            fn = _counts_epilogue_fn(
                kind, m, opts.measure, opts.k, opts.fd_level,
                from_eq=eq_ok,
                eq_extra=(CK.FIELDS_PER_WORD[pmode] * packed.shape[1]
                          - d.shape[1]))
        else:
            d64 = (np.asarray(d).astype(np.uint64)
                   if d.dtype != np.uint64 else d)
            cnt = sharded_selfpairs(mesh, d64)
            fn = _counts_epilogue_fn(kind, m, opts.measure, opts.k,
                                     opts.fd_level)
        return fn(cnt, cards, b, gbt, gbinv)
    fn = _self_matrix_fn(kind, opts.sketchsize, opts.measure, opts.k,
                         opts.fd_level)
    return fn(data, cards, b, gbt, gbinv)


@functools.lru_cache(maxsize=8)
def _pair_counts_fn(two_limb: bool, block: int):
    """Jitted pair-list register counts: rows gathered ON DEVICE
    (host fancy-indexing of sketch matrices is memory-bandwidth-bound),
    compared in u32 limbs, reduced
    to (P,) counts. Scans pair blocks so the gathered intermediates
    stay bounded."""
    import jax
    import jax.numpy as jnp

    def f(hi, lo, ia, ib):
        nb = ia.shape[0] // block

        def body(_, idx):
            ja, jb = idx
            ah = jnp.take(hi, ja, axis=0)
            bh = jnp.take(hi, jb, axis=0)
            al = jnp.take(lo, ja, axis=0)
            bl = jnp.take(lo, jb, axis=0)
            if two_limb:
                hi_eq = ah == bh
                gt = ((ah > bh) | (hi_eq & (al > bl))).sum(
                    1, dtype=jnp.int32)
                lt = ((ah < bh) | (hi_eq & (al < bl))).sum(
                    1, dtype=jnp.int32)
                eq = (hi_eq & (al == bl)).sum(1, dtype=jnp.int32)
            else:
                gt = (al > bl).sum(1, dtype=jnp.int32)
                lt = (al < bl).sum(1, dtype=jnp.int32)
                eq = (al == bl).sum(1, dtype=jnp.int32)
            return None, (eq, gt, lt)

        _, (eq, gt, lt) = jax.lax.scan(
            body, None, (ia.reshape(nb, block), ib.reshape(nb, block)))
        return eq.reshape(-1), gt.reshape(-1), lt.reshape(-1)

    return jax.jit(f)


def _swar_pair_block(mode: str, m: int):
    """Per-block (eq, gt, lt) body over packed word rows. Gt modes
    compute both direction tiles, with eq from the trichotomy (pad
    fields are equal on both sides so they never contribute to gt/lt;
    eq = m - gt - lt is exact for the true register count m). Eq modes
    (eq- or sum-consuming representations) run ONE denser eq tile —
    pack8 is 4 fields/word vs the gt packs' 2-3 — returning zeros for
    gt/lt; consumers discard those or derive (m - eq, 0) for the
    sum-first estimators."""
    import jax.numpy as jnp

    from ..ops.cmp_kernels import _EQ_TILES, _GT_TILES, FIELDS_PER_WORD

    if mode in _EQ_TILES:
        tile = _EQ_TILES[mode]
        per = FIELDS_PER_WORD[mode]

        def body(pa, pb):
            eq = tile(pa, pb) - jnp.int32(per * pa.shape[-1] - m)
            z = jnp.zeros_like(eq)
            return eq, z, z
    else:
        from ..ops.cmp_kernels import gtlt_pair_tiles

        def body(pa, pb):
            gt, lt = gtlt_pair_tiles(mode, pa, pb)
            return jnp.int32(m) - gt - lt, gt, lt
    return body


@functools.lru_cache(maxsize=8)
def _pair_counts_swar_fn(mode: str, m: int, block: int):
    """SWAR variant of the pair-list counts: rows of the PACKED word
    matrix gather at 1/4 the limb-split traffic and compare with the
    popcount tiles (_swar_pair_block)."""
    import jax
    import jax.numpy as jnp

    blk = _swar_pair_block(mode, m)

    def f(pk, ia, ib):
        nb = ia.shape[0] // block

        def body(_, idx):
            ja, jb = idx
            return None, blk(jnp.take(pk, ja, axis=0),
                             jnp.take(pk, jb, axis=0))

        _, (eq, gt, lt) = jax.lax.scan(
            body, None, (ia.reshape(nb, block), ib.reshape(nb, block)))
        return eq.reshape(-1), gt.reshape(-1), lt.reshape(-1)

    return jax.jit(f)


@functools.lru_cache(maxsize=8)
def _pair_counts_sharded_fn(kind: str, mode_or_two, m: int, block: int,
                            ndev: int):
    """Mesh-sharded pair-list counts: the pair vector shards across all
    devices while the (small) register matrix replicates — each chip
    scans its share of pair blocks with the same per-block body as the
    single-chip fns, zero cross-device communication. kind='swar' wraps
    the packed popcount tiles (mode_or_two = engine mode), kind='limb'
    the u32 limb compares (mode_or_two = two_limb)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("pairs",))
    if kind == "swar":
        blk = _swar_pair_block(mode_or_two, m)

        def blockfn(pk_or_hi, lo, ja, jb):
            return blk(jnp.take(pk_or_hi, ja, axis=0),
                       jnp.take(pk_or_hi, jb, axis=0))
    else:
        two_limb = bool(mode_or_two)

        def blockfn(hi, lo, ja, jb):
            ah = jnp.take(hi, ja, axis=0)
            bh = jnp.take(hi, jb, axis=0)
            al = jnp.take(lo, ja, axis=0)
            bl = jnp.take(lo, jb, axis=0)
            if two_limb:
                hi_eq = ah == bh
                gt = ((ah > bh) | (hi_eq & (al > bl))).sum(
                    1, dtype=jnp.int32)
                lt = ((ah < bh) | (hi_eq & (al < bl))).sum(
                    1, dtype=jnp.int32)
                eq = (hi_eq & (al == bl)).sum(1, dtype=jnp.int32)
            else:
                gt = (al > bl).sum(1, dtype=jnp.int32)
                lt = (al < bl).sum(1, dtype=jnp.int32)
                eq = (al == bl).sum(1, dtype=jnp.int32)
            return eq, gt, lt

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, None), P(None, None), P("pairs"), P("pairs")),
        out_specs=(P("pairs"), P("pairs"), P("pairs")))
    def step(a, b, ia, ib):
        nb = ia.shape[0] // block

        def body(_, idx):
            ja, jb = idx
            return None, blockfn(a, b, ja, jb)

        _, (eq, gt, lt) = jax.lax.scan(
            body, None, (ia.reshape(nb, block), ib.reshape(nb, block)))
        return eq.reshape(-1), gt.reshape(-1), lt.reshape(-1)

    return jax.jit(step)


@functools.lru_cache(maxsize=8)
def _pair_matrix_build_fn(kind: str, mode: str, m: int):
    """Jitted full self-pairs count-matrix builder for the memoized
    pair-list route. kind='eq' -> (N, N) u16 eq counts; kind='gt' ->
    (N, N) u32 with gt in the low and lt (== gt.T) in the high half —
    one word per pair so extraction moves half the bytes of two
    matrices."""
    import jax
    import jax.numpy as jnp

    from ..ops.cmp_kernels import (count_eq_self_packed,
                                   count_gtlt_self_packed16)

    if kind == "eq":
        def f(pk):
            eq = count_eq_self_packed(pk, m, mode=mode)
            return eq.astype(jnp.uint16).reshape(-1)
    else:
        def f(pk):
            gt = count_gtlt_self_packed16(pk, mode=mode)[0]
            gtu = gt.astype(jnp.uint32)
            return (gtu | (gtu.T << jnp.uint32(16))).reshape(-1)
    return jax.jit(f)


@functools.lru_cache(maxsize=2)
def _pair_take_fn():
    import jax
    import jax.numpy as jnp
    return jax.jit(lambda flat, idx: jnp.take(flat, idx))


def _pair_matrix_route(cache: dict | None, cache_key: str, n: int,
                       npairs: int, m: int) -> bool:
    """Memoized-matrix policy — OPT-IN ONLY, off by default: serving
    pair lists by flat extraction from a prebuilt count matrix lost to
    the gather engine on the accelerator this was first tuned on (not
    measured on the GPU). DASHING2_TPU_PAIR_MATRIX=1 re-enables the
    cumulative-pairs policy, =force skips it (both used by tests)."""
    import os
    if cache is None or n < 2 or m >= 32768:
        return False
    env = os.environ.get("DASHING2_TPU_PAIR_MATRIX", "")
    if env not in ("1", "force"):
        return False
    if n > int(os.environ.get("DASHING2_TPU_PAIR_MATRIX_MAX", 16384)):
        return False
    if (cache_key + "_mat") in cache or env == "force":
        return True
    cum = cache.get(cache_key + "_cum", 0) + npairs
    cache[cache_key + "_cum"] = cum
    return cum >= n * n // 32


def _pair_matrix_counts(entry, ia: np.ndarray, ib: np.ndarray,
                        cache: dict, cache_key: str):
    """Serve a pair list from the memoized full count matrix."""
    import jax.numpy as jnp
    _, pk, pmode, mtrue = entry
    n = int(pk.shape[0])
    kind = "eq" if pmode.startswith("eq") else "gt"
    mat = cache.get(cache_key + "_mat")
    if mat is None:
        mat = _pair_matrix_build_fn(kind, pmode, mtrue)(pk)
        cache[cache_key + "_mat"] = mat
    idx = jnp.asarray((ia.astype(np.int64) * n
                       + ib.astype(np.int64)).astype(np.int32))
    v = np.asarray(_pair_take_fn()(mat, idx)).astype(np.int64)
    if kind == "eq":
        z = np.zeros_like(v)
        return v, z, z
    gt = v & 0xFFFF
    lt = v >> 16
    return np.int64(mtrue) - gt - lt, gt, lt


def _pair_device_wanted(npairs: int) -> bool:
    """Device pair-list counts pay off on an accelerator with enough
    pairs to amortize dispatch; DASHING2_TPU_PAIR_DEVICE=force routes
    through the device engines regardless (CPU integration tests)."""
    import os

    import jax
    if os.environ.get("DASHING2_TPU_PAIR_DEVICE", "") == "force":
        return True
    return jax.default_backend() != "cpu" and npairs >= 2048


@functools.lru_cache(maxsize=4)
def _swar_pack_fn(kind: str):
    """Module-cached jits for the one-time pair-list packing passes
    (inline lambdas would defeat jax's executable cache across results)."""
    import jax
    import jax.numpy as jnp

    from ..ops.cmp_kernels import (dense_ranks, pack8, pack10, pack16,
                                   pack30)
    if kind == "pack10":
        return jax.jit(pack10)
    if kind == "pack8":
        return jax.jit(pack8)
    if kind == "rank30":
        return jax.jit(
            lambda x: pack30(dense_ranks(x).astype(jnp.uint32)))
    return jax.jit(lambda x: pack16(dense_ranks(x).astype(jnp.uint32)))


def _prepare_pack_entry(data, want: str, npairs_hint: int,
                        cache: dict | None, cache_key: str):
    """Device-resident comparison operands for a register matrix,
    cached per (result, representation): a SWAR packing where one
    applies (("swar", packed, mode, m) — u8 values pack directly, wider
    data rank-reduces; the rank30 sort past n=32767 is gated on the job
    size since it costs O(n m log n)) or u32 limb splits
    (("limb", hi, lo, two)) otherwise."""
    import jax.numpy as jnp
    if cache is not None and cache_key in cache:
        return cache[cache_key]
    data = np.asarray(data)
    if data.dtype == np.uint8:
        pk = _swar_pack_fn("pack8")(jnp.asarray(data))
        entry = ("swar", pk, "eq8" if want == "eq" else "gtlt8",
                 data.shape[1])
    elif data.shape[0] <= 32767:
        pk = _swar_pack_fn("rank16")(jnp.asarray(data))
        entry = ("swar", pk, "eq15" if want == "eq" else "gtlt16",
                 data.shape[1])
    elif data.shape[0] < (1 << 30) and npairs_hint >= 65536:
        # past the 2^15 rank bound the rank sort costs O(n m log n) —
        # worth it only when the pair list (or the refine/dedup loop it
        # opens, which reuses the cached packing) is large
        pk = _swar_pack_fn("rank30")(jnp.asarray(data))
        entry = ("swar", pk, "eq30" if want == "eq" else "gtlt30",
                 data.shape[1])
    else:
        if data.dtype == np.uint64:
            hi = (data >> np.uint64(32)).astype(np.uint32)
            lo = data.astype(np.uint32)
            two = True
        else:
            hi, two = None, False
            lo = data if data.dtype == np.uint32 \
                else data.astype(np.uint32)
        lo_dev = jnp.asarray(lo)
        # single-limb: the hi operand is unused in the kernel (DCE'd);
        # pass lo so no extra array ships to the device
        hi_dev = jnp.asarray(hi) if two else lo_dev
        entry = ("limb", hi_dev, lo_dev, two)
    if cache is not None:
        cache[cache_key] = entry
    return entry


def _device_pair_counts(data: np.ndarray, ia: np.ndarray, ib: np.ndarray,
                        block: int = 8192, cache: dict | None = None,
                        cache_key: str = "", want: str = "gtlt"):
    """(eq, gt, lt) int64 vectors for a pair list over any register
    representation, computed on the accelerator. Returns None when the
    host path is preferable (CPU backend or a small pair list). With
    `cache`, the prepared device arrays persist across calls.

    When the registers admit a SWAR packing (u8 values pack 4 bytes per
    word with the derived-guard gt; anything else rank-reduces when
    n <= 32767 — the
    refine/dedup loops reuse the packed matrix across many calls, so
    the one-time rank sort amortizes), gathers move 1/4 the limb-split
    bytes and the compares run as popcount tiles; counts are
    bit-identical (rank reduction is order-isomorphic per column).

    want='eq' (the representation consumes equality counts — b-bit
    truncations, eqfull k-mer sets — or only the sum gt + lt = m - eq:
    'full' and fd>=8 'ab', the sum-first f32 epilogues) selects the
    DENSER eq-only packings (pack8 4-per-word for u8, rank halves with
    the cheap eq15 detect otherwise) and one tile per block instead of
    two; consumers either discard gt/lt or derive (m - eq, 0)."""
    import jax
    import jax.numpy as jnp
    if not _pair_device_wanted(len(ia)):
        return None
    entry = _prepare_pack_entry(data, want, len(ia), cache, cache_key)
    import os
    # memoized count-matrix route: opt-in only (DASHING2_TPU_PAIR_MATRIX
    # in {"1", "force"}) — measured slower than the gather engine, see
    # _pair_matrix_route
    if entry[0] == "swar" \
            and _pair_matrix_route(cache, cache_key, int(entry[1].shape[0]),
                                   len(ia), int(entry[3])):
        return _pair_matrix_counts(entry, ia, ib, cache, cache_key)
    # mesh sharding: with >1 device and enough pairs to fill every
    # chip's first block, the pair vector shards across the mesh (the
    # register matrix is tiny and replicates)
    ndev = len(jax.devices())
    if ndev > 1 and (len(ia) < block * ndev
                     or os.environ.get("DASHING2_TPU_MULTICHIP",
                                       "1") == "0"):
        ndev = 1
    pad = (-len(ia)) % (block * ndev)
    iap = np.concatenate([ia, np.zeros(pad, ia.dtype)]) if pad else ia
    ibp = np.concatenate([ib, np.zeros(pad, ib.dtype)]) if pad else ib
    iaj = jnp.asarray(iap.astype(np.int32))
    ibj = jnp.asarray(ibp.astype(np.int32))
    if entry[0] == "swar":
        _, pk, pmode, mtrue = entry
        if ndev > 1:
            fn = _pair_counts_sharded_fn("swar", pmode, mtrue, block,
                                         ndev)
            eq, gt, lt = fn(pk, pk, iaj, ibj)
        else:
            fn = _pair_counts_swar_fn(pmode, mtrue, block)
            eq, gt, lt = fn(pk, iaj, ibj)
    else:
        _, hi_dev, lo_dev, two = entry
        if ndev > 1:
            fn = _pair_counts_sharded_fn("limb", bool(two), 0, block,
                                         ndev)
            eq, gt, lt = fn(hi_dev, lo_dev, iaj, ibj)
        else:
            fn = _pair_counts_fn(two, block)
            eq, gt, lt = fn(hi_dev, lo_dev, iaj, ibj)
    eq, gt, lt = jax.device_get((eq, gt, lt))
    n = len(ia)
    return (eq[:n].astype(np.int64), gt[:n].astype(np.int64),
            lt[:n].astype(np.int64))


def _rep_device_cache(opts, result, creps):
    """(cache, key, data, want) for the device comparison operands of
    this (result, representation), or None when the representation has
    no register-count form. `want` records which counts the estimator
    consumes (mirrors the discard logic in measure_pairs)."""
    if opts.kmer_result >= KmerSketchResultType.FULL_MMER_SET or (
            opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE):
        return None
    cache = getattr(result, "_pair_dev_cache", None)
    if cache is None:
        cache = {}
        result._pair_dev_cache = cache
    # Cache keys carry the representation PARAMETERS and the source
    # array's identity (the source reference is stored in the entry, so
    # its id() cannot be recycled while cached) — re-measuring the same
    # result under different opts (different truncation/fd_level ->
    # different creps.data) must not serve stale registers.
    if creps.data is not None:
        key = (f"creps-{id(creps.data)}-{int(creps.truncation)}"
               f"-{bool(creps.nibble_packed)}")
        if key not in cache:
            d = np.asarray(creps.data)
            if creps.nibble_packed:
                d = _unpack_nibbles(d)
            # native dtype preserved: _device_pair_counts picks its
            # packing by dtype (u8 -> pack8) and casts for the limb
            # fallback itself
            cache[key] = (creps.data, d)
    elif opts.sspace == SketchSpace.SPACE_SET \
            and opts.truncation_method <= 0:
        key = f"ordered-{bool(opts.regt32)}"
        if key not in cache:
            cache[key] = (None, _ordered_cached(opts, result))
    else:
        key = "eqfull"
        if key not in cache:
            sigs = result.signatures
            use_kmers = (result.kmers is not None
                         and result.kmers.size == sigs.size)
            cache[key] = (None, result.kmers if use_kmers
                          else sigs.view(np.uint64).reshape(sigs.shape))
    # eq-only engines are denser (4 vs 3 fields/word for u8, one tile
    # scan instead of two) and serve every representation whose
    # estimator consumes equality (b-bit truncations, eqfull) OR only
    # the sum gt + lt = m - eq (the sum-first f32 epilogues: 'full' and
    # 'ab' at fd >= 8 — same policy as the self-pairs _swar_pack).
    # Only 'ab' with fd < 8 applies g_b to gt and lt individually.
    want = ("gtlt" if (creps.data is not None and creps.truncation <= 0
                       and opts.fd_level < 8.0)
            else "eq")
    return cache, key, cache[key][1], want


def _pair_counts_cached(opts, result, creps, ia, ib):
    """Device pair counts with the register matrix prepared and pushed
    ONCE per (result, representation) — the refine/dedup loops call
    measure_pairs many times over the same registers, and both the host
    row gathers and repeated device uploads would dominate otherwise."""
    if not _pair_device_wanted(len(ia)):
        return None
    info = _rep_device_cache(opts, result, creps)
    if info is None:
        return None
    cache, key, data, want = info
    return _device_pair_counts(data, ia, ib, cache=cache,
                               cache_key=key + "_dev", want=want)


def measure_pairs(opts: Dashing2DistOptions, result: SketchingResult,
                  creps: CompressedReps, ia: np.ndarray, ib: np.ndarray
                  ) -> np.ndarray:
    """compare() for an explicit pair list -> f32 (P,). Rowwise counts
    (gathered rows compared elementwise) instead of all-pairs tiles."""
    cards = result.cardinalities
    lh = cards[ia]
    rh = cards[ib]
    msr = opts.measure
    k = opts.k
    if opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE and (
            opts.exact_kmer_dist or msr == Measure.M_EDIT_DISTANCE):
        from .editdist import edit_distances_pairs
        return edit_distances_pairs(result, ia, ib).astype(np.float32)
    if opts.kmer_result == KmerSketchResultType.FULL_MMER_SEQUENCE:
        from .wcompare import mmer_sequence_pairs
        return mmer_sequence_pairs(opts, result, ia, ib).astype(np.float32)
    if opts.kmer_result >= KmerSketchResultType.FULL_MMER_SET:
        from .wcompare import exact_intersections_pairs
        isz = exact_intersections_pairs(result, ia, ib)
        return E.exact_measures(isz, lh, rh, msr, k).astype(np.float32)
    eq = gt = lt = None
    dev = _pair_counts_cached(opts, result, creps, ia, ib)
    if dev is not None:
        eq, gt, lt = dev
        if _consumes_gtlt(opts, creps):
            if not (creps.data is not None and opts.fd_level < 8.0):
                # sum-first kinds ('full'; 'ab' fd >= 8) rode the
                # eq-only engines: derive gt' + lt' = m - eq exactly
                eq = np.asarray(eq)
                gt = opts.sketchsize - eq
                lt = np.zeros_like(gt)
            eq = None
        else:
            gt = lt = None
    elif creps.data is not None:
        A = creps.data[ia]
        B = creps.data[ib]
        if creps.nibble_packed:
            lo_a, hi_a = A & 0xF, A >> 4
            lo_b, hi_b = B & 0xF, B >> 4
            A = np.concatenate([lo_a, hi_a], axis=1)
            B = np.concatenate([lo_b, hi_b], axis=1)
        if creps.truncation > 0:
            eq = (A == B).sum(1, dtype=np.int64)
        else:
            gt = (A > B).sum(1, dtype=np.int64)
            lt = (A < B).sum(1, dtype=np.int64)
    else:
        sigs = result.signatures
        if opts.sspace == SketchSpace.SPACE_SET and opts.truncation_method <= 0:
            # gather the pair rows FIRST: converting the whole signature
            # matrix per call costs O(N*m) for an O(P*m) comparison (the
            # dedup/refine loops call this thousands of times)
            A = _ordered_bits(opts, sigs[ia])
            B = _ordered_bits(opts, sigs[ib])
            gt = (A > B).sum(1, dtype=np.int64)
            lt = (A < B).sum(1, dtype=np.int64)
        else:
            use_kmers = (result.kmers is not None
                         and result.kmers.size == sigs.size)
            src = result.kmers if use_kmers else \
                sigs.view(np.uint64).reshape(sigs.shape)
            eq = (src[ia] == src[ib]).sum(1, dtype=np.int64)
    return _dispatch_measures(opts, creps, eq, gt, lt, lh, rh
                              ).astype(np.float32)


def _block_size(opts: Dashing2DistOptions) -> int:
    """Row-block size for the generic pairwise loop: --batch-size, else
    the reference's cache heuristic (cmp_main.cpp:370-388; D2_CACHE_SIZE
    env, 4MiB default) bounded to [64, 4096]. Shared by pairwise_matrix
    and warm_pairwise_cache so the warmed block program's shapes match
    production exactly."""
    import os
    cache = int(os.environ.get("D2_CACHE_SIZE", 4 << 20))
    return opts.cmp_batch_size if opts.cmp_batch_size > 0 else \
        int(min(4096, max(64, cache // max(opts.sketchsize, 1))))


def warm_pairwise_cache(opts: Dashing2DistOptions, n: int,
                        nq: int = 0) -> bool:
    """Pre-compile the fused all-pairs compare program for the job's
    final shapes, from a SYNTHETIC result with the production dtypes.

    Short e2e walls are dominated by one-time per-process XLA compiles
    when the persistent cache misses. The compare-phase program depends only
    on opts + (n, m) + register dtypes — all known before sketching
    starts — so cli._run fires this in a daemon thread alongside the
    sketch phase: the server compiles both programs concurrently and
    the real compare later hits the jit executable cache (same
    lru_cache'd callable, same shapes/dtypes). Synthetic registers
    follow production value ranges (truncation bounds nibble values
    < 16, u8 b-bit spans the full byte, ...), so data-dependent routing
    gates (e.g. _self_pairs_matrix's A.max() check) take the production
    branch. Returns True when a fast-path program was warmed."""
    import os
    self_max = int(os.environ.get("DASHING2_TPU_SELF_MAX", 16384))
    # block-path warms allocate a synthetic (n, m) f64 matrix; cap so a
    # huge job can't blow host memory from the warm thread
    warm_max = int(os.environ.get("DASHING2_TPU_WARM_MAX", 65536))
    counts_path = (opts.kmer_result < KmerSketchResultType.FULL_MMER_SET
                   and opts.sspace != SketchSpace.SPACE_EDIT_DISTANCE)
    nf = n - nq
    span = nf if nq else n
    if not counts_path or not (64 <= n <= warm_max) or span < 64:
        return False
    rng = np.random.default_rng(0x5eed)
    fake = SketchingResult(names=[f"_warm{i}" for i in range(n)])
    # positive, zero-free f64 registers: _prep's densify sees no empty
    # slots and every quantizer (log-based setsketch a/b) stays finite
    fake.signatures = rng.random((n, opts.sketchsize)) + 0.5
    fake.cardinalities = rng.random(n) * 1e3 + 10.0
    fake.nq = nq
    creps, fake = _prep(opts, fake)
    if n > self_max:
        # N > SELF_MAX: warm the fused row-block program (and its
        # one-time rank/pack program) at the production (block, n)
        # shape; the result stays on device and is dropped. The last
        # PARTIAL block compiles separately later — unavoidable, one
        # shape. Measured n=32768: the first real block paid ~189 s of
        # compile+pack that this moves under the sketch phase.
        block = _block_size(opts)
        rows = np.arange(min(block, nf if nq else n))
        cols = np.arange(nf, n) if nq else np.arange(n)
        # warm whichever route production will take (counts-pull wins
        # when eligible — see pairwise_matrix); the byte-pack program
        # for the first (full-width) block compiles here too
        cp = _device_block_counts_pull(opts, fake, creps, rows, cols)
        if cp is not None:
            _pack_block_counts(cp[0], cp[1], opts.sketchsize)
            return True
        return _device_block_measures(opts, fake, creps, rows,
                                      cols) is not None
    if nq:
        out = _panel_counts_matrix_dev(opts, fake, creps, nf)
        if out is None:
            out = _panel_pairs_matrix(opts, fake, creps, nf)
    else:
        # device variant: warming must not pull the (n, n) synthetic
        # matrix (400 MB at n=10240). Warm the route production will
        # take: counts-pull when eligible.
        out = _self_counts_matrix_dev(opts, fake, creps)
        if out is not None:
            # the packed-trapezoid pull program too (result stays on
            # device and is dropped)
            import jax
            bits = int(opts.sketchsize).bit_length()
            if 2 * bits <= 24 \
                    and os.environ.get("DASHING2_TPU_PACK_PULL",
                                       "1") != "0" \
                    and (jax.default_backend() != "cpu"
                         or os.environ.get("DASHING2_TPU_UPPER")
                         == "force"):
                _pack_tri_counts_fn(
                    n, min(_block_size(opts), _PACK_PULL_ROWS),
                    bits)(out[0])
        if out is None:
            out = _self_pairs_matrix_dev(opts, fake, creps)
    return out is not None


def _pull_block(dev) -> np.ndarray:
    """Device->host pull of a 2-D block, split row-wise over several
    concurrent transfer threads (whether that pays over PCIe is not
    measured). DASHING2_TPU_PULL_STREAMS overrides
    (default 4 on accelerators; 1 on the CPU backend where the 'pull'
    is a local copy, unless the env var forces it for tests)."""
    import os

    import jax
    env = os.environ.get("DASHING2_TPU_PULL_STREAMS")
    if env is not None:
        streams = int(env)
    elif jax.default_backend() == "cpu":
        streams = 1
    else:
        streams = 4
    from ..timing import span
    r = int(dev.shape[0])
    if streams <= 1 or r < 2 * streams:
        with span("cmp/pull"):
            return np.asarray(dev)
    import threading
    with span("cmp/pull"):
        bounds = np.linspace(0, r, streams + 1).astype(int)
        parts = [dev[int(bounds[i]):int(bounds[i + 1])]
                 for i in range(streams)]
        out = [None] * streams

        def pull(i):
            out[i] = np.asarray(parts[i])
        th = [threading.Thread(target=pull, args=(i,))
              for i in range(streams)]
        for t in th:
            t.start()
        for t in th:
            t.join()
        return np.concatenate(out, axis=0)


def _expand_upper(arr: np.ndarray, start: int, n: int) -> np.ndarray:
    """Place a pulled upper trapezoid (b, n-start) into a full-width
    (b, n) f32 block; the [:, :start] part is zeros and NEVER read by
    symmetric/PHYLIP consumers (they slice [i+1:] with i >= start)."""
    if arr.shape[1] == n:
        return arr
    out = np.zeros((arr.shape[0], n), np.float32)
    out[:, start:] = arr
    return out


def pairwise_matrix(opts: Dashing2DistOptions, result: SketchingResult,
                    block: int = 0, upper_only: bool = False
                    ) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (first_row_index, block measure matrix f32) covering all rows.

    PANEL: rows = references [0, nf), columns = queries [nf, n).
    Otherwise: full n x n (symmetric emitters slice the upper triangle).

    upper_only=True (symmetric/PHYLIP emit call sites only): blocks are
    still full-width, but only the upper trapezoid [:, start:] crosses
    device->host — the lower-left is zeros. Symmetric consumers never
    read the lower triangle, so this halves the device->host bytes.
    Ignored on host-computed routes (no pull to save)."""
    if block <= 0:
        block = _block_size(opts)
    creps, result = _prep(opts, result)
    n = result.n if result.names else len(result.cardinalities)
    nq = result.nqueries()
    nf = n - nq
    if nq:
        cols = np.arange(nf, n)
        row_end = nf
        upper_only = False
    else:
        cols = np.arange(n)
        row_end = n

    import os
    self_max = int(os.environ.get("DASHING2_TPU_SELF_MAX", 16384))
    counts_path = (opts.kmer_result < KmerSketchResultType.FULL_MMER_SET
                   and not (opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE
                            and (opts.exact_kmer_dist
                                 or opts.measure == Measure.M_EDIT_DISTANCE)))
    if nq == 0 and 64 <= n <= self_max and counts_path \
            and result.signatures is not None:
        cnt = _self_counts_matrix_dev(opts, result, creps)
        if cnt is not None:
            # counts-pull route: u16 eq counts cross device->host (half
            # the f32 bytes), the byte-identical numpy epilogue runs on
            # the pulled block (overlapped with the next block's pull by
            # the emitters' prefetch thread)
            import jax
            devc, epi, sim_tab = cnt
            if upper_only and (jax.default_backend() != "cpu"
                               or os.environ.get("DASHING2_TPU_UPPER")
                               == "force"):
                bits = int(opts.sketchsize).bit_length()
                if 2 * bits <= 24 and os.environ.get(
                        "DASHING2_TPU_PACK_PULL", "1") != "0":
                    # condensed trapezoid, 2 counts per 3 bytes, ONE
                    # pull (see _pack_tri_counts_fn). Packing (and
                    # yielding) at <=1024-row granularity trims the
                    # block-trapezoid over-pull from ~35% to ~9% of
                    # n^2/2 with no extra pulls (one _pull_block
                    # whatever the slicing)
                    pb = min(block, _PACK_PULL_ROWS)
                    sizes = [(s, min(pb, n - s), n - s)
                             for s in range(0, n, pb)]
                    total = sum(b * w for _, b, w in sizes)
                    buf = _pull_block(
                        _pack_tri_counts_fn(n, pb, bits)(devc))
                    # fused native unpack+table-lookup -> f32 measures
                    # in one pass (same table values the epilogue
                    # gathers; SIMILARITY is count-pure so cards are
                    # unused)
                    fv = _unpack_tri_f32(buf, bits, total, sim_tab)
                    vals = (None if fv is not None
                            else _unpack_tri_counts(buf, bits, total))
                    off = 0
                    for s, b, w in sizes:
                        if fv is not None:
                            blk = fv[off:off + b * w].reshape(b, w)
                        else:
                            blk = epi(vals[off:off + b * w]
                                      .reshape(b, w), s, s)
                        off += b * w
                        yield s, _expand_upper(blk, s, n)
                    return
                pending = None
                for start in range(0, n, block):
                    b = min(block, n - start)
                    sl = devc[start:start + b, start:]
                    if pending is not None:
                        yield pending[0], _expand_upper(
                            epi(_pull_block(pending[1]), pending[0],
                                pending[0]), pending[0], n)
                    pending = (start, sl)
                if pending is not None:
                    yield pending[0], _expand_upper(
                        epi(_pull_block(pending[1]), pending[0],
                            pending[0]), pending[0], n)
                return
            cmat = _pull_block(devc)
            for start in range(0, n, block):
                yield start, epi(cmat[start:start + block], start, 0)
            return
        mat = _self_pairs_matrix_dev(opts, result, creps)
        if mat is not None:
            import jax
            if upper_only and (jax.default_backend() != "cpu"
                               or os.environ.get("DASHING2_TPU_UPPER")
                               == "force"):
                # pipeline: dispatch the slice of block b (device-side,
                # async), pull b-1 while it runs
                pending = None
                for start in range(0, n, block):
                    b = min(block, n - start)
                    sl = mat[start:start + b, start:]
                    if pending is not None:
                        yield pending[0], _expand_upper(
                            _pull_block(pending[1]), pending[0], n)
                    pending = (start, sl)
                if pending is not None:
                    yield pending[0], _expand_upper(
                        _pull_block(pending[1]), pending[0], n)
                return
            mat = _pull_block(mat)
            for start in range(0, n, block):
                yield start, mat[start:start + block]
            return
    if nq > 0 and 64 <= n <= self_max and counts_path \
            and result.signatures is not None:
        pc = _panel_counts_matrix_dev(opts, result, creps, nf)
        if pc is not None:
            devp, epi = pc
            bits = int(opts.sketchsize).bit_length()
            if 2 * bits <= 24 and os.environ.get(
                    "DASHING2_TPU_PACK_PULL", "1") != "0":
                pr, pcn = int(devp.shape[0]), int(devp.shape[1])
                buf = _pull_block(
                    _pack_counts2d_fn(pr, pcn, bits)(devp))
                cmat = _unpack_tri_counts(buf, bits,
                                          pr * pcn).reshape(pr, pcn)
            else:
                cmat = _pull_block(devp)
            for start in range(0, nf, block):
                yield start, epi(cmat[start:start + block], start)
            return
        mat = _panel_pairs_matrix(opts, result, creps, nf)
        if mat is not None:
            for start in range(0, nf, block):
                yield start, mat[start:start + block]
            return

    # generic row-block loop (N > SELF_MAX, panels over the cap, exact/
    # edit kinds). Device-eligible representations run the fused
    # counts+epilogue program and pipeline one block: dispatch block b,
    # THEN pull/yield block b-1 — the device computes b while the host
    # pulls b-1 and the consumer formats/emits.
    pending = None   # (start, device block, post) — post=None means f32
    width = len(cols)   # n for symmetric, nq for panels (no trapezoid)

    def _drain(p):
        arr = _pull_block(p[1])
        if p[2] is not None:
            arr = p[2](arr, p[0] if upper_only else 0)
        return p[0], _expand_upper(arr, p[0], width)

    for start in range(0, row_end, block):
        rows = np.arange(start, min(start + block, row_end))
        post = None
        cpull = _device_block_counts_pull(opts, result, creps, rows,
                                          cols)
        if cpull is not None:
            dev, post = cpull
        else:
            dev = _device_block_measures(opts, result, creps, rows, cols)
        if pending is not None:
            yield _drain(pending)
            pending = None
        if dev is None:
            yield start, _measure_block(opts, result, creps, rows, cols)
        else:
            if upper_only:
                dev = dev[:, start:]
            if post is not None:
                # counts block: 2 counts per 3 bytes across the link
                dev, post = _pack_block_counts(dev, post,
                                               opts.sketchsize)
            pending = (start, dev, post)
    if pending is not None:
        yield _drain(pending)
