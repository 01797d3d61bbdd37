"""OrderMinHash: LSH sketches for edit distance over sequences.

Reference role: sketch::omh::OMHasher<RegT> used when sspace ==
SPACE_EDIT_DISTANCE (d2.h:249, fastxsketchbyseq.cpp:301-322). Re-derived
from Marcais, DeBlasio, Pandey, Kingsford (2019), "Locality-sensitive
hashing for the edit distance": each of the m registers selects the l
(default 2) k-mer occurrences with the smallest register-keyed hashes of
(k-mer, occurrence-index), then hashes them *in sequence order* — the
order-sensitivity is what makes collisions track edit distance.

Device shape: occurrence ranks via lexsort ranks (vectorized), per
register-chunk (R, n) keyed hashes + top_k, signature fold on the l
winners gathered in position order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import hashes as DH
from ..ops import kmers as K

_G1 = 0x9E3779B97F4A7C15
_G2 = 0xC2B2AE3D27D4EB4F
_SALT = 0x165667B19E3779F9


def _occurrence_ranks(kmers: np.ndarray) -> np.ndarray:
    """occ[i] = number of earlier positions with the same k-mer value."""
    order = np.argsort(kmers, kind="stable")
    sk = kmers[order]
    heads = np.concatenate([[True], sk[1:] != sk[:-1]])
    group_start = np.maximum.accumulate(
        np.where(heads, np.arange(len(sk)), 0))
    ranks_sorted = np.arange(len(sk)) - group_start
    occ = np.empty(len(sk), dtype=np.int64)
    occ[order] = ranks_sorted
    return occ


_PCHUNK = 8192          # positions per scan step: (m, _PCHUNK) keys live
_INVALID_CODE = 0x5851F42D4C957F2D   # fold sentinel for unfilled slots


@functools.partial(jax.jit, static_argnames=("m", "ell", "pchunk"))
def _omh_registers(kmers: jnp.ndarray, occ: jnp.ndarray, valid: jnp.ndarray,
                   *, m: int, ell: int, pchunk: int = _PCHUNK
                   ) -> jnp.ndarray:
    """(n,) k-mers + occurrence ranks -> (m,) u64 signatures.

    Positions stream through a lax.scan carrying each register's running
    ell smallest (key, position) pairs, so peak memory is O(m * _PCHUNK)
    instead of the full (m, n) key matrix (a 5 Mbase genome at m=1024
    would otherwise materialize ~40 GB). Ties break toward the earliest
    position (top_k first-occurrence over chunk-ordered candidates),
    matching the unchunked selection. Registers whose winners include an
    UNFILLED slot (fewer than ell valid k-mers) fold a fixed sentinel —
    invalid-window codes never leak into signatures."""
    n = kmers.shape[0]
    r = jnp.arange(m, dtype=jnp.uint64)
    keyed = jnp.where(valid, kmers ^ (occ.astype(jnp.uint64)
                                      * jnp.uint64(_G1)), 0)
    maxv = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    nc = -(-n // pchunk)
    pad = nc * pchunk - n
    if pad:
        keyed = jnp.concatenate([keyed, jnp.zeros(pad, jnp.uint64)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    kt = keyed.reshape(nc, pchunk)
    vt = valid.reshape(nc, pchunk)
    offs = (jnp.arange(nc, dtype=jnp.int64) * pchunk)
    pos_base = jnp.arange(pchunk, dtype=jnp.int64)

    def body(carry, xs):
        bkeys, bpos = carry                       # (m, ell) each
        ck, cv, off = xs
        keys = DH.wanghash(ck[None, :] ^ (r[:, None] * jnp.uint64(_G2)
                                          + jnp.uint64(_SALT)))
        keys = jnp.where(cv[None, :], keys, maxv)
        kf = keys.astype(jnp.float64)  # monotone enough for selection ties
        _, cidx = jax.lax.top_k(-kf, ell)          # (m, ell) chunk-local
        ckeys = jnp.take_along_axis(keys, cidx, 1)
        cpos = off + pos_base[cidx]
        allk = jnp.concatenate([bkeys, ckeys], 1)  # earlier chunks first:
        allp = jnp.concatenate([bpos, cpos], 1)    # ties keep low position
        _, sel = jax.lax.top_k(-allk.astype(jnp.float64), ell)
        return (jnp.take_along_axis(allk, sel, 1),
                jnp.take_along_axis(allp, sel, 1)), None

    init = (jnp.full((m, ell), maxv, jnp.uint64),
            jnp.zeros((m, ell), jnp.int64))
    (bkeys, bpos), _ = jax.lax.scan(body, init, (kt, vt, offs))
    # winners in sequence order; unfilled slots (key == maxv, possible
    # only when the sequence has < ell valid k-mers) fold the sentinel
    order = jnp.argsort(bpos, axis=1)
    bpos = jnp.take_along_axis(bpos, order, 1)
    bkeys = jnp.take_along_axis(bkeys, order, 1)
    sel = jnp.where(bkeys == maxv, jnp.uint64(_INVALID_CODE),
                    jnp.take(kmers, jnp.minimum(bpos, n - 1)))
    sig = jnp.full((m,), _SALT, dtype=jnp.uint64)
    for e in range(ell):
        sig = DH.wanghash(sig ^ sel[:, e]
                          ^ (jnp.uint64(e + 1) * jnp.uint64(_G1)))
    return sig


@functools.partial(jax.jit, static_argnames=("m", "ell", "pchunk"))
def _omh_registers_batch(kmers: jnp.ndarray, occ: jnp.ndarray,
                         valid: jnp.ndarray, *, m: int, ell: int,
                         pchunk: int = _PCHUNK) -> jnp.ndarray:
    """(B, n) batched _omh_registers via vmap: ONE device dispatch per
    length bucket instead of one per sequence (a by-seq corpus of many
    short reads would pay one dispatch each)."""
    return jax.vmap(
        lambda km, oc, va: _omh_registers.__wrapped__(
            km, oc, va, m=m, ell=ell, pchunk=pchunk))(kmers, occ, valid)


def _pad_len(n: int) -> int:
    """Bucketed jit shapes: next power of two >= 256 (a handful of
    compiles across any corpus instead of one per distinct length)."""
    p = 256
    while p < n:
        p <<= 1
    return p


def omh_sketch(codes: np.ndarray, k: int, m: int, ell: int = 2
               ) -> np.ndarray:
    """OMH signature vector (m,) u64 for one sequence's codes (no
    canonicalization — edit distance is strand-specific)."""
    return omh_sketch_many([codes], k, m, ell=ell)[0]


def omh_sketch_many(codes_list, k: int, m: int, ell: int = 2
                    ) -> np.ndarray:
    """(len(codes_list), m) u64 signatures, batched by padded-length
    bucket: sequences sharing a power-of-two bucket stack into one
    vmapped device call (row count capped so per-call key intermediates
    stay ~O(256 MB))."""
    n = len(codes_list)
    out = np.zeros((n, m), dtype=np.uint64)
    buckets: dict = {}
    for i, codes in enumerate(codes_list):
        if len(codes) < k:
            continue     # all-zero signature row
        buckets.setdefault(_pad_len(len(codes) - k + 1), []).append(i)
    for npad, idxs in sorted(buckets.items()):
        pchunk = min(_PCHUNK, npad)
        # cap rows per call: the scan body materializes (B, m, pchunk)
        # u64 keys per step
        bcap = max(1, (1 << 25) // max(m * pchunk, 1))
        for s in range(0, len(idxs), bcap):
            grp = idxs[s:s + bcap]
            B = len(grp)
            # batch the ENCODE too: one dna_kmer_codes call per batch
            # (INVALID padding keeps pad positions invalid)
            codes_b = np.full((B, npad + k - 1), K.INVALID, np.uint8)
            for r, i in enumerate(grp):
                c = np.asarray(codes_list[i], np.uint8)
                codes_b[r, :len(c)] = c
            km_d, va_d = K.dna_kmer_codes(jnp.asarray(codes_b), k,
                                          False)
            km_b = np.asarray(km_d)
            va_b = np.asarray(va_d)
            occ_b = np.zeros((B, npad), np.int64)
            for r in range(B):
                occ_b[r] = _occurrence_ranks(
                    np.where(va_b[r], km_b[r], 0))
            sigs = _omh_registers_batch(
                jnp.asarray(km_b), jnp.asarray(occ_b),
                jnp.asarray(va_b), m=m, ell=ell, pchunk=pchunk)
            out[np.asarray(grp)] = np.asarray(sigs)
    return out
