"""Pairwise register-comparison kernels: count_eq / count_gtlt.

This is the N^2 hot path of the framework (reference: sketch::eq::count_eq
and count_gtlt SIMD kernels, called from src/cmp_core.cpp:372-517 for every
pair). On the device it becomes a matmul-shaped tiled reduction: tiles of rows of
the two register matrices are compared elementwise and reduced over the
register axis, with (TM, TN) integer accumulators.

Exactness for floating-point registers: every register value the framework
produces is non-negative (OPH signatures are -log-transformed, CSetSketch
registers are exponential draws), and for non-negative IEEE doubles the
total order of values equals the unsigned integer order of their bit
patterns. Signatures are therefore bitcast to uint64 once, and all
comparisons run in (hi, lo) uint32 limb pairs — bit-exact eq/gt/lt.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def f64_to_ordered_u64(x: np.ndarray) -> np.ndarray:
    """Bitcast non-negative f64 -> u64 preserving order (host-side)."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    if np.signbit(x).any():
        raise ValueError("ordered bitcast requires non-negative values")
    return x.view(np.uint64)


def _split_u64(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    x = x.astype(jnp.uint64)
    return (x >> jnp.uint64(32)).astype(jnp.uint32), x.astype(jnp.uint32)


def _pad_rows(x: jnp.ndarray, mult: int) -> jnp.ndarray:
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], 0)


def _tile_counts_int(a, b, want_gtlt: bool):
    """a: (TM, m), b: (TN, m) same int dtype. Returns (eq, gt, lt) i32."""
    ae = a[:, None, :]
    be = b[None, :, :]
    eq = (ae == be).sum(-1, dtype=jnp.int32)
    if not want_gtlt:
        return eq, None, None
    gt = (ae > be).sum(-1, dtype=jnp.int32)
    lt = (ae < be).sum(-1, dtype=jnp.int32)
    return eq, gt, lt


def _tile_counts_u64(a_hi, a_lo, b_hi, b_lo, want_gtlt: bool):
    ah = a_hi[:, None, :]
    al = a_lo[:, None, :]
    bh = b_hi[None, :, :]
    bl = b_lo[None, :, :]
    hi_eq = ah == bh
    eq = (hi_eq & (al == bl)).sum(-1, dtype=jnp.int32)
    if not want_gtlt:
        return eq, None, None
    gt = ((ah > bh) | (hi_eq & (al > bl))).sum(-1, dtype=jnp.int32)
    # trichotomy: one fewer mask than computing lt directly
    lt = jnp.int32(a_hi.shape[-1]) - gt - eq
    return eq, gt, lt


@functools.partial(jax.jit, static_argnames=("want_gtlt", "tm", "tn"))
def _pairwise_counts(a: jnp.ndarray, b: jnp.ndarray, *, want_gtlt: bool,
                     tm: int, tn: int):
    """Tiled all-pairs counts. a: (N, m), b: (M, m) of identical integer
    dtype (u8/u16/u32/u64). Returns (eq, gt, lt) int32 (N, M); gt/lt None
    when not requested (represented as zeros to keep a static pytree)."""
    N, m = a.shape
    M = b.shape[0]
    a = _pad_rows(a, tm)
    b = _pad_rows(b, tn)
    nA = a.shape[0] // tm
    nB = b.shape[0] // tn
    is64 = a.dtype == jnp.uint64
    if is64:
        ah, al = _split_u64(a)
        bh, bl = _split_u64(b)
        a_tiles = (ah.reshape(nA, tm, m), al.reshape(nA, tm, m))
        b_tiles = (bh.reshape(nB, tn, m), bl.reshape(nB, tn, m))
    else:
        a_tiles = (a.reshape(nA, tm, m),)
        b_tiles = (b.reshape(nB, tn, m),)

    def j_step(a_tile):
        def body(_, bt):
            if is64:
                eq, gt, lt = _tile_counts_u64(a_tile[0], a_tile[1],
                                              bt[0], bt[1], want_gtlt)
            else:
                eq, gt, lt = _tile_counts_int(a_tile[0], bt[0], want_gtlt)
            if not want_gtlt:
                z = jnp.zeros_like(eq)
                return None, (eq, z, z)
            return None, (eq, gt, lt)
        _, tiles = jax.lax.scan(body, None, b_tiles)
        # tiles: (nB, tm, tn) each
        return tuple(t.transpose(1, 0, 2).reshape(tm, nB * tn) for t in tiles)

    def i_body(_, at):
        return None, j_step(at)
    _, rows = jax.lax.scan(i_body, None, a_tiles)
    out = tuple(r.reshape(nA * tm, nB * tn)[:N, :M] for r in rows)
    return out


# ----------------------------------------------------------------------
# triangular self-pairs path
# ----------------------------------------------------------------------
#
# For a self-comparison lt(i, j) == gt(j, i): only upper-triangle tiles
# need computing — the same N(N-1)/2 pair walk as the reference's
# all-pairs loop (src/emitrect.cpp:269-325) instead of the full square.
# A scan walks the T(T+1)/2 tile coordinates, dynamic-slicing row tiles
# and scattering (gt, lt^T) blocks into the carried full matrix. The
# lt^T write is value-identical to gt on diagonal tiles, so no masking.

@functools.lru_cache(maxsize=8)
def _circ_seg_index(npad: int, t: int) -> np.ndarray:
    """Row-segment gather indices assembling the full (npad, npad) gt
    matrix from src rows = concat([gt_bands, lt_bands^T]).reshape(-1, t).

    Band d, block-row bi computed tile (bi, (bi+d) % nt) with linear id
    k = d*nt + bi; the mirror tile comes from the transposed lt band
    (lt(x, y) == gt(y, x) for self-pairs). Offsets d = 0..nt//2 cover
    every unordered tile pair; at even nt the d = nt/2 band covers its
    pairs twice and either copy is valid."""
    nt = npad // t
    nd = nt // 2 + 1
    K = nd * nt
    tile_of = np.full((nt, nt), -1, np.int64)
    for d in range(nd):
        for bi in range(nt):
            bj = (bi + d) % nt
            k = d * nt + bi
            if tile_of[bi, bj] < 0:
                tile_of[bi, bj] = k          # gt band tile as-is
            if tile_of[bj, bi] < 0:
                tile_of[bj, bi] = K + k      # transposed lt band tile
    x = np.arange(npad)
    return (tile_of[(x // t)[:, None], np.arange(nt)[None, :]] * t
            + (x % t)[:, None]).reshape(-1).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("t",))
def _circ_self_counts(a: jnp.ndarray, seg_idx: jnp.ndarray, *, t: int):
    """Circulant-banded self-pairs gt matrix: nt//2+1 scan steps, each one
    big regular compare of all block-rows against block-rows rolled by d
    (no per-tile scatter; assembly is a row-granular take)."""
    npad, m = a.shape
    nt = npad // t
    nd = nt // 2 + 1
    is64 = a.dtype == jnp.uint64
    parts = _split_u64(a) if is64 else (a,)
    parts3 = tuple(p.reshape(nt, t, m) for p in parts)
    # doubled tile axis so band d is one contiguous dynamic slice
    parts6 = tuple(jnp.concatenate([p, p]) for p in parts3)

    def body(_, d):
        zero = jnp.int32(0)
        rolled = tuple(jax.lax.dynamic_slice(p, (d, zero, zero),
                                             (nt, t, m)) for p in parts6)
        # lt derives from trichotomy (lt = m - gt - eq): the eq mask is
        # one op cheaper than the lt mask per position (~14% measured)
        if is64:
            ah = parts3[0][:, :, None, :]
            al = parts3[1][:, :, None, :]
            bh = rolled[0][:, None, :, :]
            bl = rolled[1][:, None, :, :]
            hi_eq = ah == bh
            gt = ((ah > bh) | (hi_eq & (al > bl))).sum(-1, dtype=jnp.int32)
            eq = (hi_eq & (al == bl)).sum(-1, dtype=jnp.int32)
        else:
            av = parts3[0][:, :, None, :]
            bv = rolled[0][:, None, :, :]
            gt = (av > bv).sum(-1, dtype=jnp.int32)
            eq = (av == bv).sum(-1, dtype=jnp.int32)
        return None, (gt, jnp.int32(m) - gt - eq)   # (nt, t, t) per band

    _, (gts, lts) = jax.lax.scan(body, None, jnp.arange(nd, dtype=jnp.int32))
    src = jnp.concatenate([gts.reshape(-1, t, t),
                           jnp.swapaxes(lts.reshape(-1, t, t), 1, 2)]
                          ).reshape(-1, t)
    return jnp.take(src, seg_idx, axis=0).reshape(npad, npad)


# ----------------------------------------------------------------------
# per-column dense rank reduction (order-preserving register compression)
# ----------------------------------------------------------------------
#
# The full-register estimators (cmp_core.cpp:458-494 full setsketch
# gt/lt; :495-517 OPH equality) consume ONLY per-pair eq/gt/lt counts.
# Replacing each column's values by their dense ranks (ties -> equal
# rank) preserves <, ==, > per column exactly, so every count — and
# therefore the estimator output — is bit-identical while the registers
# shrink from 64-bit limb pairs to single i32 words (< N <= 2^31), which
# the single-word engines compare at a fraction of the limb-pair
# cost. Cost: two lax.sort passes per column, O(N m log N) once per
# matrix vs O(N^2 m) pair work.

def _dense_ranks_cols(keys: Tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    """Dense per-column ranks for lexicographic (hi, lo, ...) u32 keys of
    shape (N, m); ties receive equal ranks. Returns (N, m) int32."""
    n = keys[0].shape[0]
    kt = tuple(k.T for k in keys)                      # (m, N): sort lanes
    iota = jax.lax.broadcasted_iota(jnp.int32, kt[0].shape, 1)
    out = jax.lax.sort(kt + (iota,), dimension=1, num_keys=len(kt),
                       is_stable=False)
    sk, si = out[:-1], out[-1]
    neq = sk[0][:, 1:] != sk[0][:, :-1]
    for s in sk[1:]:
        neq = neq | (s[:, 1:] != s[:, :-1])
    r = jnp.concatenate(
        [jnp.zeros((neq.shape[0], 1), jnp.int32),
         jnp.cumsum(neq.astype(jnp.int32), axis=1)], axis=1)
    # unpermute: sort by original index — a second sort instead of a
    # scatter. For n < 2^15 both
    # index and rank fit one packed i32 key (single-operand sort is
    # cheaper than key+payload).
    if n <= (1 << 15):
        packed = (si << 15) | r
        out = jax.lax.sort(packed, dimension=1, is_stable=False)
        return (out & jnp.int32(0x7FFF)).T
    _, ranks = jax.lax.sort((si, r), dimension=1, num_keys=1,
                            is_stable=False)
    return ranks.T


def dense_ranks(x: jnp.ndarray) -> jnp.ndarray:
    """(N, m) u64/u32/u16/u8 registers -> (N, m) i32 per-column dense
    ranks (order-isomorphic per column; traced, device-resident)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.uint64:
        hi, lo = _split_u64(x)
        return _dense_ranks_cols((hi, lo))
    return _dense_ranks_cols((x.astype(jnp.uint32),))


# ----------------------------------------------------------------------
# SWAR packed-word engines (popcount accumulation)
# ----------------------------------------------------------------------
#
# lax.population_count is one instruction per word, so registers bounded
# below 2^15 (dense ranks for N <= 32767; u8/u16 values directly where
# safe) pack two-per-u32-word (four for u8) and compare wordwise:
#
#   eq  (any 16-bit halves): x = a ^ b;
#       nonzero-half flags = (((x & 0x7FFF7FFF) + 0x7FFF7FFF) | x)
#                            & 0x80008000
#       (the add is confined to the low 15 bits per half, no carry
#       crosses halves; bit15 of x feeds in via the |)
#   gt  (halves < 2^15):  ~((b | 0x80008000) - a) & 0x80008000
#       (biased minuend keeps each half-difference positive — no
#       cross-half borrow; per-half bit15 clear iff a_h > b_h)
#
# The full-register job on this route: 15.9 ms against 132 ms for the
# u64-limb circulant at N=10240, m=1024 (H100 80GB HBM3, 700 W; PERF.md).

_H16 = 0x80008000
_L15 = 0x7FFF7FFF
_H8 = 0x80808080
_L7 = 0x7F7F7F7F
# 10-bit fields at bit offsets 0/10/20 (three per u32 word, bits 30-31
# spare): values bounded below 2^9 leave bit 9 of each field as a guard
# bit, so the same borrow/carry tricks apply at 1.5x the pack16 density.
# u8 registers qualify unconditionally (255 < 512) with NO rank pass;
# dense ranks qualify whenever n <= 512.
_H10 = 0x20080200      # bit 9 of each 10-bit field
_L9 = 0x1FF7FDFF       # low 9 value bits of each field


def pack16(x: jnp.ndarray) -> jnp.ndarray:
    """(N, m) integer registers with values < 2^16 -> (N, ceil(m/2)) u32
    packed halves (pads a zero half when m is odd — self-pair eq counts
    gain exactly +1 per pair, corrected by the callers)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    if x.shape[1] % 2:
        x = jnp.concatenate(
            [x, jnp.zeros((x.shape[0], 1), jnp.uint32)], axis=1)
    return (x[:, 0::2] << 16) | x[:, 1::2]


def _eq16_flags(x: jnp.ndarray) -> jnp.ndarray:
    """popcount of nonzero-half flags for x = a ^ b (u32 words)."""
    t7 = ((x & jnp.uint32(_L15)) + jnp.uint32(_L15)) | x
    return jax.lax.population_count(t7 & jnp.uint32(_H16))


def swar16_eq_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """eq counts (HALVES equal, i.e. registers equal) for packed u32
    word rows a (..., W) vs b (..., W); returns int32 (...,) counts of
    EQUAL halves = 2W - nonzero halves of xor."""
    nz = _eq16_flags(a ^ b)
    return jnp.int32(2 * a.shape[-1]) - nz.sum(-1, dtype=jnp.int32)


def swar15_eq_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """eq counts for packed halves BOUNDED below 2^15 (dense ranks; u8
    values): x = a ^ b stays < 2^15 per half, so x + 0x7FFF cannot
    carry across halves and its bit15 alone flags x != 0 — two fewer
    ops per word than the full-range swar16_eq_tile."""
    x = a ^ b
    nz = jax.lax.population_count((x + jnp.uint32(_L15))
                                  & jnp.uint32(_H16))
    return jnp.int32(2 * a.shape[-1]) - nz.sum(-1, dtype=jnp.int32)


def swar16_gt_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """gt counts (#halves with a_h > b_h) for packed halves < 2^15."""
    h = jnp.uint32(_H16)
    return jax.lax.population_count(~((b | h) - a) & h).sum(
        -1, dtype=jnp.int32)


def swar8_eq_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """eq counts for u8 registers packed four-per-word (full 8-bit
    range is safe for the zero-byte detect)."""
    x = a ^ b
    t7 = ((x & jnp.uint32(_L7)) + jnp.uint32(_L7)) | x
    nz = jax.lax.population_count(t7 & jnp.uint32(_H8))
    return jnp.int32(4 * a.shape[-1]) - nz.sum(-1, dtype=jnp.int32)


def pack10(x: jnp.ndarray) -> jnp.ndarray:
    """(N, m) integer registers with values < 2^9 -> (N, ceil(m/3)) u32
    words of three 10-bit fields (zero-padded; pad fields are equal and
    non-gt on both sides of every pair — eq callers correct by the pad
    amount, gt/lt callers need no correction)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    pad = (-x.shape[1]) % 3
    if pad:
        x = jnp.concatenate(
            [x, jnp.zeros((x.shape[0], pad), jnp.uint32)], axis=1)
    w = x.reshape(x.shape[0], -1, 3)
    return (w[..., 0] << 20) | (w[..., 1] << 10) | w[..., 2]


def swar10_eq_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """eq counts for 2^9-bounded fields packed three-per-word: x = a ^ b
    stays < 2^9 per field, so x + 0x1FF cannot carry across fields and
    its bit 9 alone flags x != 0 (the pack10 analogue of
    swar15_eq_tile)."""
    x = a ^ b
    nz = jax.lax.population_count((x + jnp.uint32(_L9))
                                  & jnp.uint32(_H10))
    return jnp.int32(3 * a.shape[-1]) - nz.sum(-1, dtype=jnp.int32)


def swar10_gt_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """gt counts (#fields with a_f > b_f) for 2^9-bounded fields packed
    three-per-word: the biased minuend (b | guard) - a keeps every
    field-difference positive (a_f < 2^9 <= b_f | 2^9), so no borrow
    crosses fields and per-field bit 9 is clear iff a_f > b_f."""
    h = jnp.uint32(_H10)
    return jax.lax.population_count(~((b | h) - a) & h).sum(
        -1, dtype=jnp.int32)


def pack30(x: jnp.ndarray) -> jnp.ndarray:
    """(N, m) integer registers with values < 2^30 (dense ranks for any
    practical N) -> (N, 2*ceil(m/2)) u32 words: the HIGH 15 bits of
    each value pack two-per-word in the first half of the word axis,
    the LOW 15 bits in the second half. The 30-bit tiles recombine the
    per-half flags (gt = gt_hi | (eq_hi & gt_lo)), extending the SWAR
    fast path beyond the 2^15 single-half rank bound at ~2x the
    per-register cost. One register per word overall (FIELDS_PER_WORD
    1): zero-padded tail fields are equal/non-gt on both sides."""
    x = jnp.asarray(x).astype(jnp.uint32)
    return jnp.concatenate([pack16(x >> jnp.uint32(15)),
                            pack16(x & jnp.uint32(0x7FFF))], axis=1)


def swar30_gt_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """gt counts for pack30 rows: per-half gt flags via the borrow
    trick, hi-half equality via the bounded nonzero detect, combined
    lexicographically before one popcount."""
    W = a.shape[-1] // 2
    ah, al = a[..., :W], a[..., W:]
    bh, bl = b[..., :W], b[..., W:]
    h = jnp.uint32(_H16)
    gthi = ~((bh | h) - ah) & h
    nzhi = ((ah ^ bh) + jnp.uint32(_L15)) & h    # halves < 2^15
    gtlo = ~((bl | h) - al) & h
    return jax.lax.population_count(gthi | (~nzhi & gtlo)).sum(
        -1, dtype=jnp.int32)


def swar30_eq_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """eq counts for pack30 rows: a register is equal iff BOTH 15-bit
    halves match — one bounded nonzero detect on the OR of the half
    xors (each < 2^15, so their OR is too)."""
    W = a.shape[-1] // 2
    x = (a[..., :W] ^ b[..., :W]) | (a[..., W:] ^ b[..., W:])
    nz = jax.lax.population_count((x + jnp.uint32(_L15))
                                  & jnp.uint32(_H16))
    return jnp.int32(2 * W) - nz.sum(-1, dtype=jnp.int32)


def swar8_gt_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """gt counts for FULL-RANGE u8 registers packed four-per-word with a
    DERIVED guard (no spare bit): per byte, split x = x7*128 + xl,
    y = y7*128 + yl (xl, yl < 128); then
        x > y  <=>  (x7 & ~y7) | (x7 == y7 & xl > yl)
    where xl > yl uses the biased borrow trick on the masked low 7 bits
    ((yl | 0x80) - xl stays in [1, 255] per byte, so no cross-byte
    borrow; bit7 clear iff xl > yl). Measured (r4_probes, N=10240,
    m=1024): gt8+neq8 52.2 ms vs the pack16 two-tile 60.9 ms — the 2x
    word density beats the longer per-word op chain."""
    t = ~(((b & jnp.uint32(_L7)) | jnp.uint32(_H8))
          - (a & jnp.uint32(_L7))) & jnp.uint32(_H8)
    flags = ((a & ~b) | (~(a ^ b) & t)) & jnp.uint32(_H8)
    return jax.lax.population_count(flags).sum(-1, dtype=jnp.int32)


def swar8_neq_tile(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """NONEQUAL-byte counts for pack8 rows (pad bytes are equal on both
    sides, so pads never contribute): the lt complement for the gtlt8
    engine (lt = neq - gt; eq = m - neq)."""
    x = a ^ b
    t7 = ((x & jnp.uint32(_L7)) + jnp.uint32(_L7)) | x
    return jax.lax.population_count(t7 & jnp.uint32(_H8)).sum(
        -1, dtype=jnp.int32)


def gtlt_pair_tiles(mode: str, a: jnp.ndarray, b: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(gt, lt) for one packed tile pair under any gt engine mode. The
    guard-bit modes run the gt tile in both directions; 'gtlt8' runs
    gt once plus the cheaper nonequal detect (lt = neq - gt)."""
    if mode == "gtlt8":
        gt = swar8_gt_tile(a, b)
        return gt, swar8_neq_tile(a, b) - gt
    f = _GT_TILES[mode]
    return f(a, b), f(b, a)


def pack8(x: jnp.ndarray) -> jnp.ndarray:
    """(N, m) u8 registers -> (N, ceil(m/4)) u32 words (zero-pad; +pad
    eq per self-pair corrected by callers)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    pad = (-x.shape[1]) % 4
    if pad:
        x = jnp.concatenate(
            [x, jnp.zeros((x.shape[0], pad), jnp.uint32)], axis=1)
    w = x.reshape(x.shape[0], -1, 4)
    return (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) \
        | w[..., 3]


_EQ_TILES = {"eq16": swar16_eq_tile, "eq15": swar15_eq_tile,
             "eq8": swar8_eq_tile, "eq10": swar10_eq_tile,
             "eq30": swar30_eq_tile}
_GT_TILES = {"gtlt16": swar16_gt_tile, "gtlt10": swar10_gt_tile,
             "gtlt30": swar30_gt_tile, "gtlt8": swar8_gt_tile}
FIELDS_PER_WORD = {"eq16": 2, "eq15": 2, "eq8": 4, "eq10": 3,
                   "gtlt16": 2, "gtlt10": 3, "eq30": 1, "gtlt30": 1,
                   "gtlt8": 4}


def circ_self_swar_tiles(packed: jnp.ndarray, *, t: int, mode: str):
    """Circulant band tile stacks over packed words: returns (xs, ys)
    each (nd, nt, t, t) int32 — band d, block-row bi holds the tile of
    rows [bi*t, ...) vs cols [((bi+d)%nt)*t, ...). xs/ys are (eq, eq)
    for the eq modes, (gt, lt) for 'gtlt16'. The fused measure path
    applies the estimator PER TILE on these (half the full-square
    elements) and assembles f32 directly — the raw count matrices are
    never materialized."""
    npad, w = packed.shape
    nt = npad // t
    nd = nt // 2 + 1
    p3 = packed.reshape(nt, t, w)
    p6 = jnp.concatenate([p3, p3])

    def body(_, d):
        zero = jnp.int32(0)
        rolled = jax.lax.dynamic_slice(p6, (d, zero, zero), (nt, t, w))
        a = p3[:, :, None, :]
        b = rolled[:, None, :, :]
        if mode in _EQ_TILES:
            eq = _EQ_TILES[mode](a, b)
            return None, (eq, eq)
        return None, gtlt_pair_tiles(mode, a, b)

    _, (xs, ys) = jax.lax.scan(body, None, jnp.arange(nd, dtype=jnp.int32))
    return xs, ys


def circ_assemble(low_tiles: jnp.ndarray, mirror_tiles: jnp.ndarray,
                  seg_idx: jnp.ndarray, npad: int, t: int) -> jnp.ndarray:
    """(nd, nt, t, t) band tiles -> full (npad, npad): the computed
    tiles land as-is, their mirrors as the transposed mirror stack
    (same row-segment gather as _circ_seg_index)."""
    src = jnp.concatenate(
        [low_tiles.reshape(-1, t, t),
         jnp.swapaxes(mirror_tiles.reshape(-1, t, t), 1, 2)]
    ).reshape(-1, t)
    return jnp.take(src, seg_idx, axis=0).reshape(npad, npad)


@functools.partial(jax.jit, static_argnames=("t", "mode"))
def _circ_self_swar(packed: jnp.ndarray, seg_idx: jnp.ndarray, *, t: int,
                    mode: str):
    """Circulant self-pairs over packed words. mode:
    'eq16'/'eq8' -> full (npad, npad) eq-count matrix (symmetric);
    'gtlt16' -> full gt matrix (lt == gt.T)."""
    xs, ys = circ_self_swar_tiles(packed, t=t, mode=mode)
    return circ_assemble(xs, ys, seg_idx, packed.shape[0], t)


def _swar_pad_rows(packed: jnp.ndarray, t: int) -> jnp.ndarray:
    n = packed.shape[0]
    pad = (-n) % t
    if pad:
        packed = jnp.concatenate(
            [packed, jnp.zeros((pad, packed.shape[1]), packed.dtype)])
    return packed


def count_eq_self_packed(packed: jnp.ndarray, m: int, *,
                         eight_bit: bool = False, t: int = 512,
                         bounded15: bool = False, mode: str = None
                         ) -> jnp.ndarray:
    """eq counts for all self-pairs over packed word registers; m = true
    register count (pad halves/bytes/fields are equal on both sides of
    every pair, so raw counts exceed eq by the pad amount — corrected
    here). mode selects the detect directly ('eq16'/'eq15'/'eq8'/'eq10');
    the legacy eight_bit/bounded15 flags map onto it. Traceable."""
    if mode is None:
        mode = "eq8" if eight_bit else ("eq15" if bounded15 else "eq16")
    n0 = packed.shape[0]
    t = max(8, min(t, 1 << max(n0 - 1, 1).bit_length()))
    a = _swar_pad_rows(packed, t)
    seg_idx = jnp.asarray(_circ_seg_index(a.shape[0], t))
    raw = _circ_self_swar(a, seg_idx, t=t, mode=mode)
    extra = FIELDS_PER_WORD[mode] * packed.shape[1] - m
    return raw[:n0, :n0] - jnp.int32(extra)


def count_gtlt_self_packed16(packed: jnp.ndarray, t: int = 512,
                             mode: str = "gtlt16"
                             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(gt, lt) counts for all self-pairs over guard-bounded packed
    fields — 'gtlt16' halves < 2^15, 'gtlt10' fields < 2^9 (pad fields
    equal -> contribute no gt/lt). lt == gt.T."""
    n0 = packed.shape[0]
    t = max(8, min(t, 1 << max(n0 - 1, 1).bit_length()))
    a = _swar_pad_rows(packed, t)
    seg_idx = jnp.asarray(_circ_seg_index(a.shape[0], t))
    gt = _circ_self_swar(a, seg_idx, t=t, mode=mode)
    gt = gt[:n0, :n0]
    return gt, gt.T


@functools.partial(jax.jit, static_argnames=("mode", "tm"))
def _pairwise_swar(a: jnp.ndarray, b: jnp.ndarray, *, mode: str, tm: int):
    """Rectangular packed-word counts (rows of a vs all rows of b),
    scanning row tiles of a. mode 'eq16'/'eq8' -> eq; 'gtlt16' ->
    (gt, lt)."""
    na = a.shape[0]
    a = _pad_rows(a, tm)
    nt = a.shape[0] // tm
    tiles = a.reshape(nt, tm, -1)

    def body(_, at):
        av = at[:, None, :]
        bv = b[None, :, :]
        if mode in _EQ_TILES:
            eq = _EQ_TILES[mode](av, bv)
            return None, (eq, eq)
        return None, gtlt_pair_tiles(mode, av, bv)

    _, (xs, ys) = jax.lax.scan(body, None, tiles)
    return (xs.reshape(nt * tm, -1)[:na], ys.reshape(nt * tm, -1)[:na])


def count_eq_packed(a_packed, b_packed, m: int, *, eight_bit: bool = False,
                    tm: int = 256, bounded15: bool = False,
                    mode: str = None) -> jnp.ndarray:
    """Rectangular eq counts over packed words (pad-corrected)."""
    if mode is None:
        mode = "eq8" if eight_bit else ("eq15" if bounded15 else "eq16")
    extra = FIELDS_PER_WORD[mode] * a_packed.shape[1] - m
    eq, _ = _pairwise_swar(a_packed, b_packed, mode=mode, tm=tm)
    return eq - jnp.int32(extra)


def count_gtlt_packed16(a_packed, b_packed, tm: int = 256,
                        mode: str = "gtlt16"
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rectangular (gt, lt) counts over guard-bounded packed fields."""
    gt, lt = _pairwise_swar(a_packed, b_packed, mode=mode, tm=tm)
    return gt, lt


def count_gtlt_self(a, t: int = 128) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(gt, lt) counts for all pairs of one register matrix, computing
    only ~half the full-square work via the circulant band decomposition.
    lt == gt.T exactly (self-pairs symmetry)."""
    a = jnp.asarray(a)
    n0 = a.shape[0]
    t = max(8, min(t, 1 << max(n0 - 1, 1).bit_length()))
    a = _pad_rows(a, t)
    npad = a.shape[0]
    seg_idx = jnp.asarray(_circ_seg_index(npad, t))
    gt = _circ_self_counts(a, seg_idx, t=t)
    gt = gt[:n0, :n0]
    return gt, gt.T


@functools.partial(jax.jit, static_argnames=("t",))
def _circ_self_eq(a: jnp.ndarray, seg_idx: jnp.ndarray, *, t: int):
    """Circulant-banded self-pairs eq matrix (eq is symmetric, so the
    mirror tiles are the bands' own transposes)."""
    npad, m = a.shape
    nt = npad // t
    nd = nt // 2 + 1
    is64 = a.dtype == jnp.uint64
    parts = _split_u64(a) if is64 else (a,)
    parts3 = tuple(p.reshape(nt, t, m) for p in parts)
    parts6 = tuple(jnp.concatenate([p, p]) for p in parts3)

    def body(_, d):
        zero = jnp.int32(0)
        rolled = tuple(jax.lax.dynamic_slice(p, (d, zero, zero),
                                             (nt, t, m)) for p in parts6)
        if is64:
            eq = ((parts3[0][:, :, None, :] == rolled[0][:, None, :, :])
                  & (parts3[1][:, :, None, :] == rolled[1][:, None, :, :])
                  ).sum(-1, dtype=jnp.int32)
        else:
            eq = (parts3[0][:, :, None, :] == rolled[0][:, None, :, :]
                  ).sum(-1, dtype=jnp.int32)
        return None, eq

    _, eqs = jax.lax.scan(body, None, jnp.arange(nd, dtype=jnp.int32))
    eqs = eqs.reshape(-1, t, t)
    src = jnp.concatenate([eqs, jnp.swapaxes(eqs, 1, 2)]).reshape(-1, t)
    return jnp.take(src, seg_idx, axis=0).reshape(npad, npad)


def count_eq_self(a, t: int = 128) -> jnp.ndarray:
    """eq counts for all pairs of one register matrix (circulant bands,
    ~half the full-square work)."""
    a = jnp.asarray(a)
    n0 = a.shape[0]
    t = max(8, min(t, 1 << max(n0 - 1, 1).bit_length()))
    a = _pad_rows(a, t)
    seg_idx = jnp.asarray(_circ_seg_index(a.shape[0], t))
    return _circ_self_eq(a, seg_idx, t=t)[:n0, :n0]


def count_eq(a, b, tm: int = 32, tn: int = 32) -> jnp.ndarray:
    """eq counts for all row pairs: out[i, j] = #{r : a[i,r] == b[j,r]}."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    return _pairwise_counts(a, b, want_gtlt=False, tm=tm, tn=tn)[0]


def count_gtlt(a, b, tm: int = 32, tn: int = 32
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(gt, lt) counts: gt[i,j] = #{r : a[i,r] > b[j,r]} (count_gtlt
    semantics from the reference's SIMD kernels; eq = m - gt - lt)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    _, gt, lt = _pairwise_counts(a, b, want_gtlt=True, tm=tm, tn=tn)
    return gt, lt


def count_eq_nibbles(a_packed, b_packed, tm: int = 32, tn: int = 32
                     ) -> jnp.ndarray:
    """eq counts over nibble-packed registers (two per byte;
    count_eq_nibbles semantics, cmp_core.cpp:381-385)."""
    a = jnp.asarray(a_packed, dtype=jnp.uint8)
    b = jnp.asarray(b_packed, dtype=jnp.uint8)
    lo_a = a & jnp.uint8(0xF)
    hi_a = a >> jnp.uint8(4)
    lo_b = b & jnp.uint8(0xF)
    hi_b = b >> jnp.uint8(4)
    ia = jnp.concatenate([lo_a, hi_a], axis=1)
    ib = jnp.concatenate([lo_b, hi_b], axis=1)
    return count_eq(ia, ib, tm, tn)


def count_gtlt_nibbles(a_packed, b_packed, tm: int = 32, tn: int = 32):
    a = jnp.asarray(a_packed, dtype=jnp.uint8)
    b = jnp.asarray(b_packed, dtype=jnp.uint8)
    lo_a = a & jnp.uint8(0xF)
    hi_a = a >> jnp.uint8(4)
    lo_b = b & jnp.uint8(0xF)
    hi_b = b >> jnp.uint8(4)
    ia = jnp.concatenate([lo_a, hi_a], axis=1)
    ib = jnp.concatenate([lo_b, hi_b], axis=1)
    return count_gtlt(ia, ib, tm, tn)
