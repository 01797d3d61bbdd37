"""Comparison engines for nibble registers (--fastcmp 0.5): exact int8
one-hot products on the GPU's tensor cores.

* ``nibble_dots`` -- plain XLA, any A x B job, every platform:
    eq[i,j] = onehot(A) . onehot(B)^T
    gt[i,j] = onehot(A) . cumlt(B)^T    (cumlt[j, r, v] = [B[j,r] < v])

* ``tri_counts_tiles`` -- eq AND gt for self-pairs, the lower-triangle
  block pairs of the (N, N) count matrices, one tile each: a Pallas
  kernel through Triton. ONE int8 product per pair tile yields both
  counts via the combined encoding ct = [b==v] - 128*[b<v], contracted
  in 64-register chunks so each partial = eq_chunk - 128*gt_chunk
  decodes exactly (eq_chunk <= 64 < 128) inside the K loop -- a fused
  epilogue a cuBLAS GEMM cannot host. Half the MACs of the full square
  and one product instead of two: 2.56 ms against 4.42 ms for the two
  full-square dots at N=10240, m=1024 on an H100 80GB HBM3 at 700 W
  (PERF.md). The eq-only job stays on ``nibble_dots``: there the plain
  GEMM beat both a triangular kernel and triangular XLA strips end to
  end on the same card.

The kernel compiles for the GPU only. Tests run it in the Pallas
interpreter by setting ``INTERPRET = True`` explicitly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_TRI_BM = 1024    # assembly tile; T = Npad / bm must be even
# kernel tiling: the fastest of 11 tilings swept on an H100 (PERF.md)
_TB = 128         # kernel output sub-tile (rows and columns)
_BK = 128         # contraction step of the kernel's K loop
_WARPS = 8
_STAGES = 4
_CHUNK = 1024     # 64 registers * 16 levels between decodes
INTERPRET = False


def enc_onehot(a: jnp.ndarray) -> jnp.ndarray:
    """(N, 16m) int8 one-hot of nibble registers, register-major K."""
    n, m = a.shape
    lv = jnp.arange(16, dtype=jnp.uint8)
    return (a[:, :, None] == lv).astype(jnp.int8).reshape(n, 16 * m)


def enc_combined(a: jnp.ndarray) -> jnp.ndarray:
    """(N, 16m) int8 combined encoding [b==v] - 128*[b<v]."""
    n, m = a.shape
    lv = jnp.arange(16, dtype=jnp.uint8)
    eq = (a[:, :, None] == lv).astype(jnp.int8)
    lt = (a[:, :, None] < lv).astype(jnp.int8)
    return (eq + lt * jnp.int8(-128)).reshape(n, 16 * m)


def _pair_block(u, v, T: int):
    """Grid cell (u < T/2, v <= T) -> lower-triangle block pair (bi, bj).
    Block rows u and T-1-u together hold T+1 pairs, so the static (T/2,
    T+1) grid covers every bi >= bj exactly once. Works on numpy and
    traced integers alike."""
    hi = (v > u) * 1
    return u + hi * (T - 1 - 2 * u), v - hi * (u + 1)


@functools.lru_cache(maxsize=16)
def tri_pair_blocks(T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ii, jj) block coordinates of output slot p = u * (T+1) + v."""
    p = np.arange((T // 2) * (T + 1))
    return _pair_block(p // (T + 1), p % (T + 1), T)


def _tri_kernel(a_ref, b_ref, out_ref, *, T: int, bm: int, tb: int,
                bk: int, chunk: int):
    p = pl.program_id(0)
    bi, bj = _pair_block(p // (T + 1), p % (T + 1), T)
    r0 = pl.multiple_of(bi * bm + pl.program_id(1) * tb, tb)
    c0 = pl.multiple_of(bj * bm + pl.program_id(2) * tb, tb)
    zero = jnp.zeros((tb, tb), jnp.int32)

    def step(kk, part):
        k0 = pl.multiple_of(kk * bk, bk)
        a = a_ref[pl.ds(r0, tb), pl.ds(k0, bk)]
        b = b_ref[pl.ds(c0, tb), pl.ds(k0, bk)]
        return part + jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)

    nk = a_ref.shape[1] // bk
    per = chunk // bk

    def chunk_step(c, acc):
        part = jax.lax.fori_loop(c * per, (c + 1) * per, step, zero)
        g = (jnp.int32(127) - part) >> 7
        # eq_c = part + 128 g; packed accumulator eq + (gt << 16)
        return acc + part + g * jnp.int32(128 + 65536)

    out_ref[...] = jax.lax.fori_loop(0, nk // per, chunk_step, zero)


@functools.partial(jax.jit, static_argnames=("T", "bm", "interpret"))
def _tri_call(oh, ct, *, T: int, bm: int, interpret: bool):
    """(P, bm, bm) i32 tiles eq + (gt << 16) over the lower block pairs
    of the (Npad, K) one-hot x (Npad, K) combined-encoding product."""
    K = oh.shape[1]
    tb = min(_TB, bm)
    bk = min(_BK, K)
    chunk = min(_CHUNK, K)
    P = (T // 2) * (T + 1)
    s = bm // tb
    kern = functools.partial(_tri_kernel, T=T, bm=bm, tb=tb, bk=bk,
                             chunk=chunk)
    return pl.pallas_call(
        kern,
        grid=(P, s, s),
        out_specs=pl.BlockSpec((None, tb, tb),
                               lambda p, i, j: (p, i, j)),
        out_shape=jax.ShapeDtypeStruct((P, bm, bm), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_WARPS,
                                                num_stages=_STAGES),
        interpret=interpret,
        name="tri_nibble_counts",
    )(oh, ct)


def _tri_shape(n: int, bm: int) -> Tuple[int, int]:
    T = -(-n // bm)
    T += T % 2
    return T, T * bm


def tri_counts_tiles(a_nib: jnp.ndarray, bm: int = 0):
    """Triangular self-pairs engine at tile level: returns (eq_t, gt_t,
    T, bm, npad) with eq_t/gt_t (P, bm, bm) i32 covering every
    lower-triangle block pair once (slot order of tri_pair_blocks). The
    fused production path applies the measure epilogue PER TILE and
    assembles the f32 matrix directly."""
    n, m = a_nib.shape
    bm = bm or _TRI_BM
    T, npad = _tri_shape(n, bm)
    if npad != n:
        a_nib = jnp.concatenate(
            [a_nib, jnp.zeros((npad - n, m), a_nib.dtype)])
    with jax.enable_x64(False):
        acc = _tri_call(enc_onehot(a_nib), enc_combined(a_nib), T=T,
                        bm=bm, interpret=INTERPRET)
    return acc & jnp.int32(0xFFFF), acc >> 16, T, bm, npad


def tri_assemble(low_tiles, upper_src_tiles, T: int, bm: int):
    """(P, bm, bm) tiles -> full (npad, npad) matrix; the upper triangle
    comes from upper_src_tiles transposed per tile."""
    ii, jj = tri_pair_blocks(T)
    slot = {(int(i), int(j)): p for p, (i, j) in enumerate(zip(ii, jj))}
    rows = []
    for bi in range(T):
        cols = []
        for bj in range(T):
            if bi >= bj:
                cols.append(low_tiles[slot[bi, bj]])
            else:
                cols.append(jnp.swapaxes(upper_src_tiles[slot[bj, bi]],
                                         0, 1))
        rows.append(jnp.concatenate(cols, axis=1))
    return jnp.concatenate(rows, axis=0)


def tri_self_counts_available(n: int, m: int) -> bool:
    """Shapes the triangular engine takes: enough rows to beat the full
    square's padding, whole 128-wide contraction steps, 64-register
    decode chunks, and gt < 2^15 in the packed accumulator."""
    return (n > _TRI_BM and m < (1 << 15)
            and (m % 64 == 0 or (m <= 64 and m % 8 == 0)))


def counts_nibble_tri_self(a_nib: jnp.ndarray, bm: int = 0):
    """(eq, gt, lt) for all pairs of one unpacked nibble matrix (N, m)
    via the triangular combined-encoding kernel."""
    n, m = a_nib.shape
    eq_t, gt_t, T, bm, _ = tri_counts_tiles(a_nib, bm)
    eq = tri_assemble(eq_t, eq_t, T, bm)[:n, :n]
    gt = tri_assemble(gt_t, jnp.int32(m) - eq_t - gt_t, T, bm)[:n, :n]
    return eq, gt, jnp.int32(m) - eq - gt


@functools.partial(jax.jit, static_argnames=("want_gtlt",))
def nibble_dots(a_nib: jnp.ndarray, b_nib: jnp.ndarray, want_gtlt: bool):
    """(eq, gt, lt) i32 counts for unpacked nibble registers (N, m) x
    (M, m), values in [0, 16), via full-square int8 one-hot dots
    (exact)."""
    m = a_nib.shape[1]
    a_oh = enc_onehot(a_nib)
    eq = jax.lax.dot_general(
        a_oh, enc_onehot(b_nib), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    if not want_gtlt:
        return eq, eq, eq
    lv = jnp.arange(16, dtype=jnp.uint8)
    b_lt = (b_nib[:, :, None] < lv).astype(jnp.int8).reshape(
        b_nib.shape[0], 16 * m)
    gt = jax.lax.dot_general(
        a_oh, b_lt, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    return eq, gt, m - eq - gt
