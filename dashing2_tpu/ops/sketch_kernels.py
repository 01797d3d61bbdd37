"""Sketch register-update kernels, redesigned for SPMD execution.

Reference semantics being reproduced:

* One-Permutation SetSketch (src/oph.h:95-281): per k-mer hash h,
  ``id = DHasher(h)``, bucket ``idx = id % m``, register = running min of
  ids in the bucket, count = multiplicity of the current min. Here this is
  a batched ``segment_min`` over (sequence, bucket) segments — one scatter
  pass for an entire batch of sequences, no serial loop.

* CSetSketch (src/setsketch.h:276-602): the reference streams items through
  a sequential early-exit loop (exponential spacings + lazy Fisher-Yates +
  max-tree). The device formulation exploits the distributional identity:
  randomly permuting the ascending exponential spacings of one item gives
  m i.i.d. Exp(1) values, so an item's register draws are i.i.d. Exp(1)
  with minimum x1 ~ Exp(m) at a uniform register. We therefore
    1) compute each item's x1 from its first RNG value (matching the
       reference's ev_1 = -log(u)/m exactly),
    2) keep only items with x1 <= T (everything else provably cannot beat
       any final register), and
    3) for the <= S survivors, place x1 at a uniform register and
       x1 + Exp(1) everywhere else (memorylessness), then min-reduce.
  The result is verified against the effective threshold and recomputed
  with a larger T on the (rare) failure, so the output distribution is
  exactly CSetSketch's while the work is O(n) filter + O(S·m) dense math.

* Exact counting (src/counter.h:79-117): device sort + run-length
  segmentation replaces the hash table; emits (unique hash, count) pairs
  in sorted-hash order, which is also the FULL_MMER_SET/COUNTDICT
  representation (sorted hash sets, src/fastxsketch.cpp:429-459).

* Bottom-k (src/fastxsketch.cpp:24-47): k smallest distinct hashes via
  sort of the deduplicated stream.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import hashing as H
from . import hashes as DH

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_GOLD = 0x9E3779B97F4A7C15  # 2^64 / golden ratio, register-stride salt


# ----------------------------------------------------------------------
# One-Permutation SetSketch
# ----------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("nseqs", "m", "seed"))
def oph_sketch_segments(hashed: jnp.ndarray, valid: jnp.ndarray,
                        seq_ids: jnp.ndarray, *, nseqs: int, m: int,
                        seed: int = H.OPH_DEFAULT_SEED
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched OPH over a flat stream of hashed k-mers.

    hashed: (n,) u64 maskfn'd k-mer hashes; valid: (n,) bool;
    seq_ids: (n,) int32 owning-sequence index in [0, nseqs).
    Returns (registers u64 (nseqs, m), counts u32 (nseqs, m)).
    Empty registers hold u64::max (oph.h:147 T(-1) init).
    """
    ids = DH.oph_hash(hashed, seed)
    idx = (ids % jnp.uint64(m)).astype(jnp.int32)
    seg = seq_ids.astype(jnp.int32) * m + idx
    seg = jnp.where(valid, seg, nseqs * m)
    # Sort-based segmented min: sort the stream by id then stably by
    # segment, so each segment's run starts at its minimum;
    # first-occurrence lookup is a searchsorted gather.
    S = nseqs * m
    # one two-key lexicographic sort; payloads ride the sort network
    seg_s, ids_s = jax.lax.sort((seg, ids), num_keys=2)
    n = seg_s.shape[0]
    want = jnp.arange(S, dtype=seg_s.dtype)
    pos = jnp.searchsorted(seg_s, want)
    posc = jnp.minimum(pos, n - 1)
    found = seg_s[posc] == want
    regs = jnp.where(found, ids_s[posc], jnp.uint64(U64MAX))
    # count of the current min = length of the first (seg, id) run in the
    # segment: next (seg, id) change index after pos, via suffix-min
    iota = jnp.arange(n, dtype=jnp.int32)
    change = jnp.concatenate([
        jnp.ones(1, bool),
        (seg_s[1:] != seg_s[:-1]) | (ids_s[1:] != ids_s[:-1])])
    nxt = jnp.where(change, iota, jnp.int32(n))
    # run_end_excl[i] = min change index > i (default n)
    suff = jax.lax.cummin(nxt[::-1])[::-1]
    run_end = jnp.concatenate([suff[1:], jnp.full(1, n, jnp.int32)])
    counts = jnp.where(found, (run_end[posc] - posc).astype(jnp.uint32),
                       jnp.uint32(0))
    return regs.reshape(nseqs, m), counts.reshape(nseqs, m)


@functools.partial(jax.jit, static_argnames=("m", "seed", "want_counts"))
def oph_sketch_rows_scatter(hashed: jnp.ndarray, valid: jnp.ndarray, *,
                            m: int, seed: int = H.OPH_DEFAULT_SEED,
                            want_counts: bool = True
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row-wise OPH via ONE flat segment_min scatter over (row, bucket)
    segments — bit-identical to oph_sketch_rows. Trades the dense
    engine's O(nk*m) vector work for O(nk) scattered updates; which
    wins on the GPU is not measured. Select with
    DASHING2_TPU_OPH_ENGINE=scatter."""
    ids = DH.oph_hash(hashed, seed)
    R, nk = ids.shape
    idx = (ids % jnp.uint64(m)).astype(jnp.int32)
    row = jax.lax.broadcasted_iota(jnp.int32, ids.shape, 0)
    seg = jnp.where(valid, row * m + idx, R * m)
    regs = jax.ops.segment_min(ids.reshape(-1), seg.reshape(-1),
                               num_segments=R * m + 1)[:R * m]
    regs = regs.reshape(R, m)
    if not want_counts:
        return regs, jnp.zeros((R, m), jnp.uint32)
    ismin = jnp.where(valid, (ids == jnp.take_along_axis(
        regs, idx, axis=1)).astype(jnp.uint32), jnp.uint32(0))
    counts = jax.ops.segment_sum(ismin.reshape(-1), seg.reshape(-1),
                                 num_segments=R * m + 1)[:R * m]
    return regs, counts.reshape(R, m).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("m", "seed", "want_counts"))
def oph_sketch_rows_sort(hashed: jnp.ndarray, valid: jnp.ndarray, *,
                         m: int, seed: int = H.OPH_DEFAULT_SEED,
                         want_counts: bool = True
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row-wise OPH via per-row rotation sort — bit-identical to
    oph_sketch_rows_dense, at O(nk log^2 nk) comparator work instead of
    the dense engine's O(nk*m) select/min inflation.

    The trick: for power-of-two m the bucket is the LOW lg(m) bits of
    the id (oph.h:166 idx = id % m), so all ids in a bucket share those
    bits and ``rotr(id, lg m)`` is (a) a bijection, (b) bucket-major —
    the bucket becomes the HIGH bits — and (c) order-preserving WITHIN
    each bucket. ONE payload-free u64 sort per row therefore groups
    buckets contiguously with each bucket's min id at the run head, and
    the id is recovered by rotl. Extraction to dense (R, m) is a second
    single-limb sort: bucket heads keyed by bucket index, everything
    else keyed m, plus one always-present sentinel per bucket
    (key=U64MAX) so every bucket owns >=1 entry — after that sort the
    first 2m columns contain all heads+sentinels and a small dense
    min-reduce (R, 2m, m) places them.

    Min-multiplicity counts ride as a second payload: the count of the
    current min is the length of the first equal-key run of its bucket
    (equal rotated keys == equal ids), computed from the sorted stream
    by a suffix-cummin over change positions.

    Non-power-of-two m (the rotation trick needs bucket == low bits)
    delegates to the dense engine. Caveat shared with the segments
    engine: a VALID id equal to u64::max is indistinguishable from the
    empty sentinel (probability 2^-64 per k-mer under the invertible
    id hash), in which case its multiplicity reports 0.
    """
    if m & (m - 1) or m == 1:
        return oph_sketch_rows_dense(hashed, valid, m=m, seed=seed,
                                     want_counts=want_counts)
    ids = DH.oph_hash(hashed, seed)
    R, nk = ids.shape
    lgm = m.bit_length() - 1
    shift = 64 - lgm
    key = (ids >> jnp.uint64(lgm)) | (ids << jnp.uint64(shift))
    key = jnp.where(valid, key, jnp.uint64(U64MAX))
    key_s = jax.lax.sort(key, dimension=1)
    bucket_s = (key_s >> jnp.uint64(shift)).astype(jnp.int32)
    headb = jnp.concatenate([jnp.ones((R, 1), bool),
                             bucket_s[:, 1:] != bucket_s[:, :-1]], axis=1)
    ck = jnp.where(headb, bucket_s, jnp.int32(m))
    # sentinels: one per bucket, value U64MAX / count 0, so empty
    # buckets keep their slot in the compacted front window
    ck_all = jnp.concatenate(
        [ck, jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), (R, m))], 1)
    key_all = jnp.concatenate(
        [key_s, jnp.full((R, m), U64MAX, jnp.uint64)], 1)
    if want_counts:
        iota = jnp.arange(nk, dtype=jnp.int32)
        headk = jnp.concatenate([jnp.ones((R, 1), bool),
                                 key_s[:, 1:] != key_s[:, :-1]], axis=1)
        nxt = jnp.where(headk, iota, jnp.int32(nk))
        suff = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]
        run_end = jnp.concatenate([suff[:, 1:],
                                   jnp.full((R, 1), nk, jnp.int32)], 1)
        cnt = (run_end - iota).astype(jnp.uint32)
        cnt_all = jnp.concatenate([cnt, jnp.zeros((R, m), jnp.uint32)], 1)
        ck2, key2, cnt2 = jax.lax.sort((ck_all, key_all, cnt_all),
                                       dimension=1, num_keys=1)
    else:
        ck2, key2 = jax.lax.sort((ck_all, key_all), dimension=1,
                                 num_keys=1)
    S = min(2 * m, nk + m)
    sck, skey = ck2[:, :S], key2[:, :S]
    on = sck[:, :, None] == jnp.arange(m, dtype=jnp.int32)[None, None, :]
    regs_rot = jnp.min(jnp.where(on, skey[:, :, None],
                                 jnp.uint64(U64MAX)), axis=1)
    regs = (regs_rot << jnp.uint64(lgm)) | (regs_rot >> jnp.uint64(shift))
    if not want_counts:
        return regs, jnp.zeros((R, m), jnp.uint32)
    scnt = cnt2[:, :S]
    ismin = on & (skey[:, :, None] == regs_rot[:, None, :])
    counts = jnp.sum(jnp.where(ismin, scnt[:, :, None], jnp.uint32(0)),
                     axis=1, dtype=jnp.uint32)
    counts = jnp.where(regs == U64MAX, jnp.uint32(0), counts)
    return regs, counts


def oph_rows_engine() -> str:
    """OPH engine request: 'auto' (default; sketch/core resolves it to
    the native host engine on a single-device accelerator backend, the
    rotation-'sort' device engine for device dispatch, or the CPU
    segment path), 'native', 'dense' (bucket-one-hot), 'dense2' (split
    hi/lo u32 passes), 'sort' (per-row rotation sort), or 'scatter'
    (segment_min). All bit-identical; they differ in where they run and
    what they cost to compile (GPU costs not measured)."""
    import os
    return os.environ.get("DASHING2_TPU_OPH_ENGINE", "auto")


@functools.partial(jax.jit, static_argnames=("m", "seed", "want_counts",
                                              "chunk"))
def oph_sketch_rows_dense2(hashed: jnp.ndarray, valid: jnp.ndarray, *,
                           m: int, seed: int = H.OPH_DEFAULT_SEED,
                           want_counts: bool = True, chunk: int = 4096
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split hi/lo u32 variant of the dense bucket-one-hot engine —
    bit-identical to oph_sketch_rows_dense, trading the u64-emulated
    min-select in the O(nk*m) inner loop for two u32 passes:

      pass A: per (row, bucket) min of the ids' HIGH u32 words;
      pass B: per (row, bucket) min of the LOW words restricted to
              k-mers whose high word equals pass A's winner.

    (min_hi, min_lo_among_hi_winners) == the u64 min exactly, and every
    inner op is a native-width u32 compare/select instead of the
    2-limb emulation. The ids are read twice (HBM traffic is trivial
    next to the O(nk*m) lane work)."""
    ids = DH.oph_hash(hashed, seed)
    idx = jnp.where(valid, (ids % jnp.uint64(m)).astype(jnp.int32),
                    jnp.int32(-1))
    R, nk = ids.shape
    U32MAX = jnp.uint32(0xFFFFFFFF)
    hi = (ids >> jnp.uint64(32)).astype(jnp.uint32)
    lo = ids.astype(jnp.uint32)
    pad = (-nk) % chunk
    if pad:
        hi = jnp.concatenate([hi, jnp.zeros((R, pad), hi.dtype)], 1)
        lo = jnp.concatenate([lo, jnp.zeros((R, pad), lo.dtype)], 1)
        idx = jnp.concatenate([idx, jnp.full((R, pad), -1, idx.dtype)], 1)
    nc = hi.shape[1] // chunk
    hi_t = jnp.moveaxis(hi.reshape(R, nc, chunk), 1, 0)
    lo_t = jnp.moveaxis(lo.reshape(R, nc, chunk), 1, 0)
    idx_t = jnp.moveaxis(idx.reshape(R, nc, chunk), 1, 0)
    cols = jnp.arange(m, dtype=jnp.int32)

    def body_hi(regs, xs):
        chi, cidx = xs
        on = cidx[:, :, None] == cols[None, None, :]
        cmin = jnp.min(jnp.where(on, chi[:, :, None], U32MAX), axis=1)
        return jnp.minimum(regs, cmin), None

    min_hi, _ = jax.lax.scan(body_hi, jnp.full((R, m), U32MAX, jnp.uint32),
                             (hi_t, idx_t))

    def body_lo(regs, xs):
        chi, clo, cidx = xs
        on = ((cidx[:, :, None] == cols[None, None, :])
              & (chi[:, :, None] == min_hi[:, None, :]))
        cmin = jnp.min(jnp.where(on, clo[:, :, None], U32MAX), axis=1)
        return jnp.minimum(regs, cmin), None

    min_lo, _ = jax.lax.scan(body_lo, jnp.full((R, m), U32MAX, jnp.uint32),
                             (hi_t, lo_t, idx_t))
    regs = ((min_hi.astype(jnp.uint64) << jnp.uint64(32))
            | min_lo.astype(jnp.uint64))
    # empty buckets: both passes return U32MAX halves == U64MAX sentinel
    if not want_counts:
        return regs, jnp.zeros((R, m), jnp.uint32)

    def cbody(counts, xs):
        chi, clo, cidx = xs
        ismin = ((cidx[:, :, None] == cols[None, None, :])
                 & (chi[:, :, None] == min_hi[:, None, :])
                 & (clo[:, :, None] == min_lo[:, None, :]))
        return counts + ismin.sum(1).astype(jnp.uint32), None

    counts, _ = jax.lax.scan(cbody, jnp.zeros((R, m), jnp.uint32),
                             (hi_t, lo_t, idx_t))
    return regs, counts


@functools.partial(jax.jit, static_argnames=("m", "seed", "want_counts",
                                              "chunk"))
def oph_sketch_rows_dense(hashed: jnp.ndarray, valid: jnp.ndarray, *,
                          m: int, seed: int = H.OPH_DEFAULT_SEED,
                          want_counts: bool = True, chunk: int = 4096
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row-wise OPH: each row of hashed (R, nk) is one item's k-mer
    stream chunk; returns per-row (R, m) registers (+ min-multiplicity
    counts). Dense bucket-one-hot min-reduce over nk — no sort, no
    scatter; nk is scanned in `chunk` slices to bound the fused
    (R, chunk, m) intermediate."""
    ids = DH.oph_hash(hashed, seed)
    # fold validity into the bucket index ONCE (O(nk)): invalid k-mers
    # get bucket -1, which matches no column — saves the per-(kmer,
    # bucket) valid AND in the O(nk*m) inner compare
    idx = jnp.where(valid, (ids % jnp.uint64(m)).astype(jnp.int32),
                    jnp.int32(-1))
    R, nk = ids.shape
    pad = (-nk) % chunk
    if pad:
        ids = jnp.concatenate([ids, jnp.zeros((R, pad), ids.dtype)], 1)
        idx = jnp.concatenate([idx, jnp.full((R, pad), -1,
                                             idx.dtype)], 1)
        valid = jnp.concatenate([valid, jnp.zeros((R, pad), bool)], 1)
    nc = ids.shape[1] // chunk
    ids_t = jnp.moveaxis(ids.reshape(R, nc, chunk), 1, 0)
    idx_t = jnp.moveaxis(idx.reshape(R, nc, chunk), 1, 0)
    val_t = jnp.moveaxis(valid.reshape(R, nc, chunk), 1, 0)
    cols = jnp.arange(m, dtype=jnp.int32)

    def body(regs, xs):
        cids, cidx, cval = xs
        on = cidx[:, :, None] == cols[None, None, :]
        cmin = jnp.min(jnp.where(on, cids[:, :, None],
                                 jnp.uint64(U64MAX)), axis=1)
        return jnp.minimum(regs, cmin), None

    init = jnp.full((R, m), U64MAX, jnp.uint64)
    regs, _ = jax.lax.scan(body, init, (ids_t, idx_t, val_t))
    if not want_counts:
        return regs, jnp.zeros((R, m), jnp.uint32)

    def cbody(counts, xs):
        cids, cidx, cval = xs
        del cval                     # folded into cidx == -1
        ismin = ((cidx[:, :, None] == cols[None, None, :])
                 & (cids[:, :, None] == regs[:, None, :]))
        return counts + ismin.sum(1).astype(jnp.uint32), None

    counts, _ = jax.lax.scan(cbody, jnp.zeros((R, m), jnp.uint32),
                             (ids_t, idx_t, val_t))
    return regs, counts


@functools.partial(jax.jit, static_argnames=("m", "seed", "want_counts",
                                              "chunk"))
def oph_sketch_rows_rot(hashed: jnp.ndarray, valid: jnp.ndarray, *,
                        m: int, seed: int = H.OPH_DEFAULT_SEED,
                        want_counts: bool = True, chunk: int = 4096
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rotation-dense OPH engine: the subtract-trick variant of the
    dense bucket-one-hot min (bit-identical registers; counts share the
    sort engine's 2^-64 U64MAX-id caveat).

    With power-of-two m the bucket is the LOW lg(m) bits of the id
    (oph.h:166), so ``rot = rotr(id, lg m)`` puts the bucket in the TOP
    bits and is order-preserving within each bucket. On the rotated
    HIGH u32 word, ``d = hi - (col << s)`` (s = 32 - lg m) is < 2^s iff
    the position belongs to bucket col — out-of-bucket positions land
    in [2^s, 2^32) for every col, including the wraparound side — so
    pass 1's per-(position, bucket) work is ONE u32 subtract + ONE u32
    min: no bucket-index compare, no select, no u64 emulation. The
    dense engine pays ~8 lane-ops per position-bucket, dense2 ~7,
    this 2 (+3 in the lo pass) — the sketch phase is vector-op-bound
    (ops/position-bucket x nk x m / lane rate), so the op count sets
    the wall time.

    Pass 2 recovers the LOW u32 among positions whose high word equals
    pass 1's winner (hi equality implies bucket membership since the
    bucket is hi's top bits). Invalid positions carry rot = U64MAX: for
    cols < m-1 they fail the d < 2^s test; for col m-1 they alias to
    the maximal in-bucket value, so an all-invalid bucket m-1 resolves
    to the U64MAX empty sentinel exactly like the dense engine."""
    if m & (m - 1) or m < 2:
        return oph_sketch_rows_dense(hashed, valid, m=m, seed=seed,
                                     want_counts=want_counts, chunk=chunk)
    ids = DH.oph_hash(hashed, seed)
    R, nk = ids.shape
    lgm = m.bit_length() - 1
    s = 32 - lgm
    rot = (ids >> jnp.uint64(lgm)) | (ids << jnp.uint64(64 - lgm))
    rot = jnp.where(valid, rot, jnp.uint64(U64MAX))
    hi = (rot >> jnp.uint64(32)).astype(jnp.uint32)
    lo = rot.astype(jnp.uint32)
    U32MAX = jnp.uint32(0xFFFFFFFF)
    pad = (-nk) % chunk
    if pad:
        ones = jnp.full((R, pad), U32MAX, jnp.uint32)
        hi = jnp.concatenate([hi, ones], 1)
        lo = jnp.concatenate([lo, ones], 1)
    nc = hi.shape[1] // chunk
    hi_t = jnp.moveaxis(hi.reshape(R, nc, chunk), 1, 0)
    lo_t = jnp.moveaxis(lo.reshape(R, nc, chunk), 1, 0)
    colbase = (jnp.arange(m, dtype=jnp.uint32) << jnp.uint32(s))

    def body_hi(dmin, chi):
        d = chi[:, :, None] - colbase[None, None, :]
        return jnp.minimum(dmin, d.min(axis=1)), None

    dmin, _ = jax.lax.scan(body_hi, jnp.full((R, m), U32MAX, jnp.uint32),
                           hi_t)
    # d >= 2^s: no position in this bucket (out-of-bucket values can
    # never win below 2^s). The U32MAX sentinel for empty cols can
    # spuriously match real bucket-(m-1) positions whose hi word is
    # all-ones in pass 2, so empty cols are forced back to the U64MAX
    # sentinel after pass 2 (`empty` below) rather than trusted there.
    empty = dmin >> jnp.uint32(s) != 0
    min_hi = jnp.where(empty, U32MAX, colbase[None, :] + dmin)

    # pass 2/3 run with 4 independent accumulator trees over the
    # position axis: a single min/sum accumulator is a serial
    # dependency chain. min/sum are associative, so the split is
    # bit-identical.
    acc = 4 if chunk % 4 == 0 else 1

    def body_lo(lmin, xs):
        chi, clo = xs
        shi = chi.reshape(R, acc, chunk // acc)
        slo = clo.reshape(R, acc, chunk // acc)
        on = shi[:, :, :, None] == min_hi[:, None, None, :]
        cmin = jnp.min(jnp.where(on, slo[:, :, :, None], U32MAX),
                       axis=2).min(axis=1)
        return jnp.minimum(lmin, cmin), None

    min_lo, _ = jax.lax.scan(body_lo, jnp.full((R, m), U32MAX, jnp.uint32),
                             (hi_t, lo_t))
    rr = (min_hi.astype(jnp.uint64) << jnp.uint64(32)) \
        | min_lo.astype(jnp.uint64)
    regs = (rr << jnp.uint64(lgm)) | (rr >> jnp.uint64(64 - lgm))
    regs = jnp.where(empty, jnp.uint64(U64MAX), regs)
    if not want_counts:
        return regs, jnp.zeros((R, m), jnp.uint32)

    def cbody(counts, xs):
        chi, clo = xs
        shi = chi.reshape(R, acc, chunk // acc)
        slo = clo.reshape(R, acc, chunk // acc)
        ismin = ((shi[:, :, :, None] == min_hi[:, None, None, :])
                 & (slo[:, :, :, None] == min_lo[:, None, None, :]))
        return counts + ismin.sum((1, 2)).astype(jnp.uint32), None

    counts, _ = jax.lax.scan(cbody, jnp.zeros((R, m), jnp.uint32),
                             (hi_t, lo_t))
    counts = jnp.where(regs == U64MAX, jnp.uint32(0), counts)
    return regs, counts


def oph_sketch_rows(hashed, valid, *, m: int,
                    seed: int = H.OPH_DEFAULT_SEED,
                    want_counts: bool = True, chunk: int = 4096):
    """Row-wise OPH dispatcher: dense bucket-one-hot engine by default,
    split-u32 dense engine with DASHING2_TPU_OPH_ENGINE=dense2,
    subtract-trick rotation-dense engine with =rot, rotation-sort
    engine with =sort, segment_min scatter engine with =scatter
    (bit-identical outputs)."""
    eng = oph_rows_engine()
    if eng == "rot":
        return oph_sketch_rows_rot(hashed, valid, m=m, seed=seed,
                                   want_counts=want_counts, chunk=chunk)
    if eng == "scatter":
        return oph_sketch_rows_scatter(hashed, valid, m=m, seed=seed,
                                       want_counts=want_counts)
    if eng == "sort":
        return oph_sketch_rows_sort(hashed, valid, m=m, seed=seed,
                                    want_counts=want_counts)
    if eng == "dense2":
        return oph_sketch_rows_dense2(hashed, valid, m=m, seed=seed,
                                      want_counts=want_counts, chunk=chunk)
    return oph_sketch_rows_dense(hashed, valid, m=m, seed=seed,
                                 want_counts=want_counts, chunk=chunk)


def oph_to_sigs(regs: np.ndarray) -> np.ndarray:
    """LazyOnePermSetSketch::data() (oph.h:248-263): log-transform raw u64
    registers to f64 signatures; empty (max) and zero registers -> 0.

    sig = (-1 / (m - n_empty)) * log(2^-64 * (max - x + 1)).
    Order-preserving in x, so gt/lt/eq on sigs == on raw registers.
    """
    regs = np.asarray(regs, dtype=np.uint64)
    m = regs.shape[-1]
    out = np.zeros(regs.shape, dtype=np.float64)
    empty = regs == U64MAX
    nempty = empty.sum(axis=-1, keepdims=True)
    mul = -1.0 / np.maximum(m - nempty, 1)
    zero = regs == 0
    live = ~(empty | zero)
    with np.errstate(over="ignore", invalid="ignore"):
        delta = (U64MAX - regs) + np.uint64(1)  # max - x + 1 (wraps iff x==0)
        vals = mul * np.log(delta.astype(np.float64) * 2.0 ** -64)
    out[live] = np.broadcast_to(vals, out.shape)[live]
    return out


def oph_cardinality(regs: np.ndarray) -> np.ndarray:
    """getcard() (oph.h:240-247): m^2 / sum(x * 2^-64)."""
    regs = np.asarray(regs, dtype=np.uint64)
    m = regs.shape[-1]
    s = (regs.astype(np.float64) * 2.0 ** -64).sum(axis=-1)
    with np.errstate(divide="ignore"):
        return np.where(s > 0, m * (m / s), np.inf)


def oph_densify(regs: np.ndarray, kmers: np.ndarray | None = None,
                empty_value=None) -> tuple[np.ndarray, int]:
    """Optimal densification by rotation with hashed re-draw
    (cmp_core.cpp:578-613). Operates on one sketch row in place-semantics
    (returns new array). `empty_value` defaults to 0 for float sigs (the
    reference densifies the already-log-transformed signatures with
    empty=0) and u64::max for raw registers.
    """
    regs = np.array(regs)
    m = len(regs)
    if empty_value is None:
        empty_value = np.uint64(U64MAX) if regs.dtype == np.uint64 else regs.dtype.type(0)
    isempty = regs == empty_value
    ne = int(isempty.sum())
    if ne == 0 or ne == m:
        return regs, (m if ne == m else 0)
    out = regs.copy()
    for i in np.nonzero(isempty)[0]:
        rng_i = np.uint64((int(i) + H.DENSIFY_OFFSET) & 0xFFFFFFFFFFFFFFFF)
        while True:
            rng_i, draw = H.wyhash64_step(rng_i)
            j = int(draw % np.uint64(m))
            if regs[j] != empty_value:
                break
        out[i] = regs[j]
        if kmers is not None:
            kmers[i] = kmers[j]
    return out, ne


@functools.lru_cache(maxsize=8)
def _densify_draw_table(m: int, depth: int) -> np.ndarray:
    """(depth, m) redraw targets j_t(i) of the per-slot wyhash chain
    (cmp_core.cpp:578-613). The chain seed depends only on the slot
    index, so the draw sequence is identical across sketches and can be
    tabulated once per register count."""
    with np.errstate(over="ignore"):
        seed = np.arange(m, dtype=np.uint64) + np.uint64(H.DENSIFY_OFFSET)
    rows = np.empty((depth, m), np.int64)
    for t in range(depth):
        seed, draw = H.wyhash64_step(seed)
        rows[t] = (draw % np.uint64(m)).astype(np.int64)
    return rows


def oph_densify_rows(sigs: np.ndarray, kmers: np.ndarray | None = None,
                     empty_value=None, block: int = 512) -> np.ndarray:
    """Vectorized optimal densification across ALL sketch rows, in place.

    Bit-exact with per-row ``oph_densify`` (same wyhash redraw chain per
    empty slot, first draw landing on a non-empty register wins): the
    per-slot draw chain is row-independent, so a (depth, m) target table
    is shared by every row and the first hit is a vectorized argmax over
    the chain axis. Rows are processed in blocks to bound the gathered
    candidate tensor; unresolved slots (all `depth` draws hit empty
    registers) re-run with a doubled chain. Returns per-row empty counts.
    """
    sigs = np.asarray(sigs)
    N, m = sigs.shape
    if empty_value is None:
        empty_value = (np.uint64(U64MAX) if sigs.dtype == np.uint64
                       else sigs.dtype.type(0))
    isempty = sigs == empty_value
    ne = isempty.sum(axis=1)
    todo = np.nonzero((ne > 0) & (ne < m))[0]
    for s in range(0, len(todo), block):
        rows = todo[s:s + block]
        sub = sigs[rows]                       # original values (sources)
        esub = isempty[rows]
        r_idx, i_idx = np.nonzero(esub)        # empty positions to fill
        depth = 32
        src = np.full(len(r_idx), -1, np.int64)
        unresolved = np.arange(len(r_idx))
        while len(unresolved):
            J = _densify_draw_table(m, depth)  # (depth, m)
            ju = J[:, i_idx[unresolved]]       # (depth, U)
            hit = sub[r_idx[unresolved][None, :], ju] != empty_value
            first = hit.argmax(axis=0)
            ok = hit.any(axis=0)
            src[unresolved[ok]] = ju[first[ok], np.nonzero(ok)[0]]
            unresolved = unresolved[~ok]
            depth *= 2
            if depth > 1 << 20:                # pragma: no cover
                raise RuntimeError("densify chain failed to terminate")
        sigs[rows[r_idx], i_idx] = sub[r_idx, src]
        if kmers is not None:
            # sources are never densified slots (the chain checks the
            # ORIGINAL registers), so in-place kmer assignment is safe
            kmers[rows[r_idx], i_idx] = kmers[rows[r_idx], src]
    return ne


# ----------------------------------------------------------------------
# CSetSketch
# ----------------------------------------------------------------------

def _css_x1(hashed: jnp.ndarray, m: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-item first order statistic and its RNG value.

    rv = CEHasher(h ^ CSS_XOR) (setsketch.h:375); x1 = -log(rv * 2^-64)/m
    (the reference's ev_1). rv == 0 -> x1 = +inf (item never updates).
    """
    rv = DH.css_item_hash(hashed)
    u = DH.u64_to_unit_float(rv)
    x1 = jnp.where(rv == 0, jnp.inf, -jnp.log(jnp.maximum(u, 1e-300)) / m)
    return x1, rv


@functools.partial(jax.jit, static_argnames=("m", "cap"))
def _css_pass(hashed: jnp.ndarray, valid: jnp.ndarray, *, m: int, cap: int,
              threshold: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One filtered CSetSketch pass. Returns (registers (m,) f64, tcut f64).

    Exact iff max(registers) <= tcut (checked by the host driver):
    every excluded item has all draws > its x1 > tcut.
    """
    n = hashed.shape[0]
    x1, rv = _css_x1(hashed, m)
    x1 = jnp.where(valid, x1, jnp.inf)
    k = min(cap, n)
    neg_x1, take_idx = jax.lax.top_k(-x1, k)  # k smallest x1
    sx1 = -neg_x1
    srv = rv[take_idx]
    keep = sx1 <= threshold
    # effective cutoff: smallest x1 NOT included (items beyond capacity or
    # threshold). If everything kept, cutoff is +inf.
    tcut = jnp.where(jnp.all(keep), jnp.inf, jnp.min(jnp.where(keep, jnp.inf, sx1)))
    # first register: uniform from a fresh wyhash of rv
    _, draw = DH.wyhash64_step(srv)
    idx0 = (draw % jnp.uint64(m)).astype(jnp.int32)
    # residual draws: e[d, j] = x1[d] + Exp(1) via counter RNG on (rv, j)
    j = jnp.arange(m, dtype=jnp.uint64) * jnp.uint64(_GOLD)
    def row(d_rv, d_x1, d_idx0, d_keep):
        u = DH.u64_to_unit_float(DH.wanghash(d_rv ^ j))
        e = d_x1 - jnp.log(jnp.maximum(u, 1e-300))
        e = e.at[d_idx0].set(d_x1)
        return jnp.where(d_keep, e, jnp.inf)
    rows = jax.vmap(row)(srv, sx1, idx0, keep)  # (k, m)
    win = jnp.argmin(rows, axis=0)
    regs = jnp.take_along_axis(rows, win[None, :], 0)[0]
    win_ids = take_idx[win]
    return regs, tcut, win_ids


def css_sketch(hashed: np.ndarray, valid: np.ndarray, m: int,
               cap: int | None = None, return_ids: bool = False):
    """CSetSketch registers for one item set (host driver, device math).

    Iterates the filtered pass with a doubling threshold until the result
    is provably exact (max register <= effective cutoff). With
    return_ids, also returns the winning item's index into `hashed` per
    register (the ids() tracking of CSetSketch, setsketch.h:316,400-403).
    """
    hashed = jnp.asarray(hashed.reshape(-1), dtype=jnp.uint64)
    valid = jnp.asarray(valid.reshape(-1), dtype=bool)
    n = max(int(valid.sum()), 1)
    if cap is None:
        cap = int(min(hashed.shape[0], max(4096, 6 * m)))
    t = (np.log(m) + 8.0) / n
    for _ in range(64):
        regs, tcut, win = _css_pass(hashed, valid, m=m, cap=cap,
                                    threshold=jnp.float64(t))
        regs = np.asarray(regs)
        tc = float(tcut)
        if regs.max() <= tc:
            if return_ids:
                return regs, np.asarray(win)
            return regs
        t *= 4.0
        cap = min(int(hashed.shape[0]), cap * 4)
    raise RuntimeError("css_sketch failed to converge")


def css_cardinality(regs: np.ndarray) -> np.ndarray:
    """CSetSketch::cardinality (setsketch.h:553-561): m / sum(regs)."""
    regs = np.asarray(regs, dtype=np.float64)
    m = regs.shape[-1]
    s = regs.sum(axis=-1)
    with np.errstate(divide="ignore"):
        return np.where(s > 0, m / s, np.inf)


# ----------------------------------------------------------------------
# Exact counting / sorted hash sets
# ----------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("max_unique",))
def sort_count_unique(hashed: jnp.ndarray, valid: jnp.ndarray,
                      max_unique: int
                      ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sorted distinct hashes + multiplicities via sort / run-length.

    Returns (unique u64 (max_unique,), counts u32 (max_unique,), n_unique).
    Padding slots hold u64::max / 0 counts. Replaces the reference's
    Counter hash map (counter.h:79-117) with sort+segment device work.
    """
    x = jnp.where(valid, hashed, U64MAX)
    xs = jnp.sort(x)
    nvalid = valid.sum()
    is_head = jnp.concatenate([jnp.array([True]), xs[1:] != xs[:-1]])
    pos_valid = jnp.arange(xs.shape[0]) < nvalid
    is_head = is_head & pos_valid
    gid = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    gid = jnp.where(pos_valid, gid, max_unique)
    counts = jax.ops.segment_sum(pos_valid.astype(jnp.uint32), gid,
                                 num_segments=max_unique + 1)[:max_unique]
    uniq = jax.ops.segment_min(xs, gid, num_segments=max_unique + 1)[:max_unique]
    return uniq, counts, is_head.sum()


@jax.jit
def _countsketch_device(hv: jnp.ndarray, cssize: jnp.ndarray):
    """CountSketch bucket accumulation on device, scatter-free:
    bucket[h % cssize] += (h & 1) ? +1 : -1 (counter.h semantics)
    computed as ONE sort with the sign riding as payload + a cumsum;
    run boundaries mark distinct buckets. Returns (sorted bucket ids
    i32, inclusive sign cumsum i32, run-end mask bool) — the host
    extracts per-bucket sums as diffs of the cumsum at run ends (O(K)
    numpy), avoiding both device scatters and a cssize-dense buffer."""
    idx = (hv % cssize.astype(jnp.uint64)).astype(jnp.int32)
    sign = jnp.where((hv & jnp.uint64(1)).astype(bool),
                     jnp.int32(1), jnp.int32(-1))
    si, ss = jax.lax.sort((idx, sign), dimension=0, num_keys=1,
                          is_stable=False)
    cs = jnp.cumsum(ss, dtype=jnp.int32)
    last = jnp.concatenate([si[1:] != si[:-1],
                            jnp.ones(1, dtype=bool)])
    return si, cs, last


def countsketch_counts(hv: np.ndarray, cssize: int):
    """(bucket ids u64, |sums| f64) of the CountSketch accumulation of
    hash stream hv — device sort+cumsum, host run extraction. Matches
    the dense np.add.at formulation exactly (integer arithmetic)."""
    if len(hv) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.float64)
    # bucket ids ride the sort as i32: callers gate on cssize < 2^31
    # (the CLI's --countsketch-size is far below that in practice)
    assert cssize < (1 << 31)
    si, cs, last = jax.device_get(
        _countsketch_device(jnp.asarray(hv), jnp.uint64(cssize)))
    ends = np.flatnonzero(last)
    sums = np.diff(np.concatenate([[0], cs[ends]]))
    nz = sums != 0
    return si[ends][nz].astype(np.uint64), np.abs(sums[nz]).astype(
        np.float64)


def bottomk(hashed: np.ndarray, valid: np.ndarray, k: int) -> np.ndarray:
    """k smallest distinct hashes, ascending (fastxsketch.cpp:24-47).
    Fewer than k distinct -> pad with u64::max."""
    x = np.asarray(hashed)[np.asarray(valid)]
    u = np.unique(x)
    out = np.full(k, U64MAX, dtype=np.uint64)
    out[:min(k, len(u))] = u[:k]
    return out
