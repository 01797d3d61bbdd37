"""Weighted sketches: BagMinHash-equivalent (weighted Jaccard J_W) and
ProbMinHash-equivalent (probability Jaccard J_P).

Reference roles: sketch::BagMinHash2 / pmh3_t consumed via d2.h:247-248 and
finalized from exact counts (src/fastxsketch.cpp:429-459, src/counter.h:118-138).
The bonsai `sketch` submodule is absent from the reference checkout, so these
are re-derivations from the published algorithms in a vectorized shape:

* **Weighted minhash** uses Ioffe's Improved Consistent Weighted Sampling
  (ICWS, ICDM 2010): per (item d, register j), with RNG keyed by (hash_d, j),
      r, c ~ Gamma(2,1), beta ~ U(0,1)
      t = floor(ln(w_d)/r + beta)
      ln y = r * (t - beta);  ln a = ln c - ln y - r
  The register keeps the item minimizing a. P(two sets pick the same
  (d, t)) = J_W exactly (Ioffe 2010, Thm 1) — the same quantity Ertl's
  BagMinHash estimates.
* **ProbMinHash1** (Ertl, TKDE 2020): per (d, j) value Exp(1)/p_d with
  p_d = w_d / W; register keeps the min. P(same winner) = J_P.

Register *values* are an item-keyed uniform hash (f64 in (0,1)) rather than
the winning time, so sketch equality <=> same winning sample — exactly the
event whose probability is J_W/J_P — independent of the other set's
normalization. (Comparisons in dashing2's multiset/probset space are pure
register-equality counts, cmp_core.cpp:495-517.)

All (chunk x m) math is dense vector work. The production engine is ROW
BATCHED: every item's (hash, weight) stream is laid into
fixed-width rows (one item never shares a row), a single jitted kernel
reduces a whole (R, L) row batch to (R, m) partial registers in one
dispatch, and partial rows of the same item min-merge on the host —
one device call per ~R·L draws instead of one per item per 2048-chunk
(a 10k-item corpus would otherwise be 10k+ dispatches). Draw math runs
in f32: deterministic and identical across backends, register equality semantics unchanged (values are
item-sample-keyed hashes), estimator perturbation ~2^-24 per draw —
documented in README "deviations".
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import hashes as DH

_S1 = 0xA24BAED4963EE407
_S2 = 0x9FB21C651E98DF25
_S3 = 0xE7037ED1A0B428DB
_S4 = 0x8EBC6AF09C88C6E3
_S5 = 0x589965CC75374CC3
_SVAL = 0xC2B2AE3D27D4EB4F
_GOLD = 0x9E3779B97F4A7C15


def _icws_rt(kind: str, h, lnw_f, j, m: int):
    """Shared draw math on pre-broadcast operands: h u64 (...,) hash
    per (position, register) cell, lnw_f f64 log-weight broadcast to
    the same shape, j u64 register-index term. Returns (key f32,
    sval f32) with IDENTICAL elementwise expressions wherever it is
    instantiated — the winner-recompute graph must reproduce the scan
    graph's f32 values bit-for-bit."""
    def keyed(salt):
        return DH.wanghash(h ^ (j + jnp.uint64(salt)))

    def unit32(u64):
        return jnp.maximum(
            DH.u64_to_unit_float(u64).astype(jnp.float32),
            jnp.float32(1e-30))

    live = jnp.isfinite(lnw_f)
    lnw32 = jnp.where(live, lnw_f, 0.0).astype(jnp.float32)
    if kind == "icws":
        u1 = unit32(keyed(_S1))
        u2 = unit32(keyed(_S2))
        u3 = unit32(keyed(_S3))
        u4 = unit32(keyed(_S4))
        beta = DH.u64_to_unit_float(keyed(_S5)).astype(jnp.float32)
        r = -(jnp.log(u1) + jnp.log(u2))          # Gamma(2,1)
        lnc = jnp.log(-(jnp.log(u3) + jnp.log(u4)))
        t = jnp.floor(lnw32 / r + beta)
        lny = r * (t - beta)
        key = lnc - lny - r
        # sample value keyed by (item, t): equality <=> same sample
        tbits = t.astype(jnp.int32).astype(jnp.uint64)
        sval = DH.u64_to_unit_float(
            DH.wanghash(h ^ (tbits * jnp.uint64(_GOLD))
                        ^ jnp.uint64(_SVAL))).astype(jnp.float32)
    else:
        u = unit32(keyed(_S1))
        key = -jnp.log(u) * jnp.exp(-lnw32)
        sval = jnp.broadcast_to(
            DH.u64_to_unit_float(
                DH.wanghash(h ^ jnp.uint64(_SVAL))).astype(jnp.float32),
            key.shape)
    key = jnp.where(live, key, jnp.float32(jnp.inf))
    return key, sval


def _draws(kind: str, hashes: jnp.ndarray, lnw: jnp.ndarray, m: int):
    """(..., m) f32 (key, sample-value) draws for a block of hashes.
    kind 'icws': Ioffe consistent weighted sampling (key = ln a);
    kind 'pmh': ProbMinHash1 (key = Exp(1)/p_d). lnw = ln weight
    (ln p_d for pmh), -inf to mask."""
    j = jnp.arange(m, dtype=jnp.uint64) * jnp.uint64(_GOLD)
    h = hashes[..., None]
    lnw_f = jnp.broadcast_to(lnw[..., None], hashes.shape + (m,))
    return _icws_rt(kind, h, lnw_f, j, m)


@functools.partial(jax.jit, static_argnames=("kind", "m", "sub"))
def _rows_kernel(hashes, lnw, *, kind: str, m: int, sub: int = 32):
    """Row-batched weighted sketch: hashes/lnw (R, L) -> stacked
    (3, R, m) f32 (key, val, idpos) partial registers.

    The scan carries ONE packed u64 per register: (order-preserving
    f32 key bits << 32) | stream position — min over the chunk and the
    carry replaces the old argmin + two take_along_axis gathers per
    step (the winners are re-derived ONCE per flush from a single
    (R, m) gather of the winning hashes). Packing preserves the exact selection semantics:
    smallest key wins, ties to the SMALLEST stream position (the old
    strict-less carry + first-argmin). The winner's key is decoded
    from its own bits (no recompute); sval re-derives from the winning
    hash with the same elementwise expressions (bit-identical)."""
    R, L = hashes.shape
    nc = L // sub
    hs = jnp.moveaxis(hashes.reshape(R, nc, sub), 1, 0)
    ws = jnp.moveaxis(lnw.reshape(R, nc, sub), 1, 0)
    j = jnp.arange(m, dtype=jnp.uint64) * jnp.uint64(_GOLD)

    def body(pk, xs):
        h, w, off = xs
        lnw_f = jnp.broadcast_to(w[..., None], (R, sub, m))
        key, _ = _icws_rt(kind, h[..., None], lnw_f, j, m)
        kb = jax.lax.bitcast_convert_type(key, jnp.uint32)
        ordered = jnp.where(kb >> jnp.uint32(31) != 0, ~kb,
                            kb | jnp.uint32(0x80000000))
        pos = (off + jnp.arange(sub, dtype=jnp.uint32))[None, :, None]
        packed = ((ordered.astype(jnp.uint64) << jnp.uint64(32))
                  | pos.astype(jnp.uint64))
        return jnp.minimum(pk, packed.min(axis=1)), None

    init = jnp.full((R, m), jnp.uint64(0xFFFFFFFFFFFFFFFF), jnp.uint64)
    offs = jnp.arange(nc, dtype=jnp.uint32) * jnp.uint32(sub)
    pk, _ = jax.lax.scan(body, init, (hs, ws, offs))
    top = (pk >> jnp.uint64(32)).astype(jnp.uint32)
    kb = jnp.where(top >> jnp.uint32(31) != 0,
                   top & jnp.uint32(0x7FFFFFFF), ~top)
    key = jax.lax.bitcast_convert_type(kb, jnp.float32)
    pos = (pk & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32)
    h_win = jnp.take_along_axis(hashes, pos.astype(jnp.int64), axis=1)
    w_win = jnp.take_along_axis(lnw, pos.astype(jnp.int64), axis=1)
    _, val = _icws_rt(kind, h_win, w_win, j, m)
    # ONE stacked output: one device->host pull per flush instead of
    # three
    return jnp.stack([key, val, pos.astype(jnp.float32)])


_ROW_L = 2048


def _row_batch_R(m: int) -> int:
    """Rows per device call, bounding the (R, sub, m) f32 draw
    intermediates to ~128 MB. Bigger batches mean FEWER flushes: every
    flush costs a dispatch + a pulled (3, R, m) result."""
    return max(8, min(1024, (1 << 20) // max(m, 1)))


def _sketch_stream(kind: str, hashes: np.ndarray, lnw: np.ndarray, m: int,
                   with_ids: bool):
    """Single-item convenience: routes the item's stream through the
    row-batched kernel and min-merges its row partials."""
    sigs, ids = _sketch_many_streams(kind, [hashes], [lnw], m)
    if with_ids:
        return sigs[0], ids[0]
    return sigs[0]


def _sketch_many_streams(kind: str, streams: List[np.ndarray],
                         lnws: List[np.ndarray], m: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched engine: lay every item's (hash, lnw) stream into fixed
    (R, L) row batches (an item never shares a row; short tails pad
    with -inf weights), reduce each batch to (R, m) partials in ONE
    device call, and min-merge partial rows of the same item on the
    host. Returns (sigs f64 (n, m), winner ids i64 (n, m))."""
    n = len(streams)
    R = _row_batch_R(m)
    sigs_key = np.full((n, m), np.inf, dtype=np.float32)
    sigs_val = np.zeros((n, m), dtype=np.float32)
    sigs_id = np.zeros((n, m), dtype=np.int64)

    rows_h = np.zeros((R, _ROW_L), dtype=np.uint64)
    rows_w = np.full((R, _ROW_L), -np.inf, dtype=np.float64)
    rows_item = np.zeros(R, dtype=np.int64)
    rows_base = np.zeros(R, dtype=np.int64)
    fill = 0

    def flush():
        nonlocal fill
        if fill == 0:
            return
        kvs = np.asarray(_rows_kernel(jnp.asarray(rows_h),
                                      jnp.asarray(rows_w), kind=kind,
                                      m=m))
        key, val, sid = kvs[0], kvs[1], kvs[2]
        for r in range(fill):
            i = rows_item[r]
            better = key[r] < sigs_key[i]
            sigs_key[i] = np.where(better, key[r], sigs_key[i])
            sigs_val[i] = np.where(better, val[r], sigs_val[i])
            sigs_id[i] = np.where(
                better, sid[r].astype(np.int64) + rows_base[r], sigs_id[i])
        rows_w[:] = -np.inf
        fill = 0

    for i in range(n):
        h = streams[i]
        w = lnws[i]
        for s in range(0, max(len(h), 1), _ROW_L):
            hs = h[s:s + _ROW_L]
            rows_h[fill, :len(hs)] = hs
            rows_w[fill, :len(hs)] = w[s:s + len(hs)]
            rows_item[fill] = i
            rows_base[fill] = s
            fill += 1
            if fill == R:
                flush()
    flush()
    return sigs_val.astype(np.float64), sigs_id


def bagminhash(hashes: np.ndarray, weights: np.ndarray, m: int,
               with_ids: bool = False):
    """Weighted-set sketch registers (f64 in (0,1); equality across
    sketches estimates weighted Jaccard). with_ids additionally returns
    the winning item ordinal per register."""
    with np.errstate(divide="ignore"):
        lnw = np.where(weights > 0, np.log(weights.astype(np.float64)),
                       -np.inf)
    return _sketch_stream("icws", hashes.astype(np.uint64), lnw, m,
                          with_ids)


def probminhash(hashes: np.ndarray, weights: np.ndarray, m: int,
                with_ids: bool = False):
    """Discrete-probability-distribution sketch registers (ProbMinHash1)."""
    W = float(weights.sum())
    with np.errstate(divide="ignore"):
        lnp = np.where(weights > 0,
                       np.log(weights.astype(np.float64) / max(W, 1e-300)),
                       -np.inf)
    return _sketch_stream("pmh", hashes.astype(np.uint64), lnp, m,
                          with_ids)


def _lnw_many(kind: str, uniq: List[np.ndarray], counts: List[np.ndarray]):
    out = []
    with np.errstate(divide="ignore"):
        for c in counts:
            c = c.astype(np.float64)
            if kind == "pmh":
                c = c / max(float(c.sum()), 1e-300)
            out.append(np.where(c > 0, np.log(c), -np.inf))
    return out


def bagminhash_many(uniq: List[np.ndarray], counts: List[np.ndarray],
                    m: int) -> Tuple[np.ndarray, np.ndarray]:
    streams = [u.astype(np.uint64) for u in uniq]
    sigs, _ = _sketch_many_streams("icws", streams,
                                   _lnw_many("icws", uniq, counts), m)
    cards = np.array([c.sum() for c in counts], np.float64)
    return sigs, cards  # total weight cardinality (d2.h:250-255)


def probminhash_many(uniq: List[np.ndarray], counts: List[np.ndarray],
                     m: int) -> Tuple[np.ndarray, np.ndarray]:
    streams = [u.astype(np.uint64) for u in uniq]
    sigs, _ = _sketch_many_streams("pmh", streams,
                                   _lnw_many("pmh", uniq, counts), m)
    cards = np.array([c.sum() for c in counts], np.float64)
    return sigs, cards
