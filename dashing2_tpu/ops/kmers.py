"""K-mer encoding: the device equivalent of bonsai's Encoder/RollingHasher.

Reference behavior (call sites: /root/reference/src/fastxsketch.cpp:383-424,
/root/reference/src/d2.h:94-99,257-271; the bonsai submodule itself is empty
in the reference checkout, so encodings are re-derived from the documented
semantics: 2-bit DNA with reverse-complement canonicalization, reduced
protein alphabets via base-b packing, window-w lexicographic minimizers,
spaced seeds, and a rolling hash for k beyond the exact-coding capacity).

Device design
-------------
* Host side packs ASCII to small integer codes (numpy LUT) and chunks
  sequences into fixed-shape (nchunks, chunk_len) blocks with a (k-1)-base
  halo so every k-mer of the original sequence appears in exactly one chunk.
  Static shapes keep everything jit-compatible.
* The device kernel materializes all k-mer codes of a chunk with k shifted
  adds over the code array — O(k) full-width vector ops, no sequential scan.
  Reverse-complement codes accumulate in the same loop; canonical k-mer is
  the elementwise min.
* Window minimizers (w > k) use a sliding-window min (log-step shift-min),
  then a "this position is some window's minimum" mask. Each selected
  position is emitted once (standard minimizer-set semantics).
* Invalid bases (N etc.) invalidate every k-mer window containing them via
  a prefix-sum trick.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..enums import Alphabet
from . import hashes as DH

INVALID = 0xFF  # host-side code for non-alphabet characters

# ----------------------------------------------------------------------
# Host: ASCII -> code LUTs
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def alphabet_lut(alphabet: Alphabet) -> np.ndarray:
    """256-entry uint8 LUT from ASCII byte to alphabet code (INVALID=255)."""
    lut = np.full(256, INVALID, dtype=np.uint8)
    if alphabet in (Alphabet.DNA, Alphabet.DNAC):
        for i, chars in enumerate("ACGT"):
            lut[ord(chars)] = i
            lut[ord(chars.lower())] = i
        return lut
    if alphabet == Alphabet.DNA2:
        # purine/pyrimidine 1-bit alphabet
        for c in "AGag":
            lut[ord(c)] = 0
        for c in "CTct":
            lut[ord(c)] = 1
        return lut
    aas = "ACDEFGHIKLMNPQRSTVWY"
    if alphabet in (Alphabet.PROTEIN20, Alphabet.PROTEIN):
        groups = list(aas)
    elif alphabet == Alphabet.PROTEIN_3BIT:
        # 8-letter reduced alphabet (3-bit); Murphy-style grouping
        groups = ["AGST", "C", "DENQ", "FWY", "H", "ILMV", "KR", "P"]
    elif alphabet == Alphabet.PROTEIN_14:
        groups = ["A", "C", "DN", "EQ", "FY", "G", "H", "ILMV", "K",
                  "P", "R", "ST", "W", "X"]
    elif alphabet == Alphabet.PROTEIN_6:
        # Murphy 6-letter reduced alphabet
        groups = ["AGPST", "C", "DENQ", "FWY", "HKR", "ILMV"]
    else:
        raise ValueError(f"unknown alphabet {alphabet}")
    for code, grp in enumerate(groups):
        for ch in grp:
            lut[ord(ch)] = code
            lut[ord(ch.lower())] = code
    return lut


def alphabet_size(alphabet: Alphabet) -> int:
    if alphabet in (Alphabet.DNA, Alphabet.DNAC):
        return 4
    if alphabet == Alphabet.DNA2:
        return 2
    return {Alphabet.PROTEIN: 20, Alphabet.PROTEIN20: 20,
            Alphabet.PROTEIN_3BIT: 8, Alphabet.PROTEIN_14: 14,
            Alphabet.PROTEIN_6: 6}[alphabet]


def encode_ascii(seq: bytes | np.ndarray, alphabet: Alphabet) -> np.ndarray:
    """Map an ASCII sequence to uint8 codes (INVALID for non-alphabet)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, np.uint8)
    return alphabet_lut(alphabet)[arr]


# ----------------------------------------------------------------------
# Host: chunking with halo
# ----------------------------------------------------------------------


def chunk_halos(k: int, w: int = 0) -> Tuple[int, int]:
    """(left, right) halo widths in bases for chunking.

    Halos are symmetric so that a chunk owning base positions
    [start, start + chunk_len) holds every base its owned k-mers touch:
    the k-mer starting at the last owned position needs k - 1 bases past
    the owned range (without the right halo, the k - 1 k-mer starts
    before each chunk boundary appeared in NO chunk's owned window —
    they were silently dropped for any sequence longer than chunk_len).
    With window minimizers (w > k) both halos grow to w - 1 so every
    owned k-mer position sees ALL windows that contain it (a window
    covering position p spans bases [p - (w-k), p + w - 1]), making the
    selection decision identical to the unchunked computation.
    """
    if w > k:
        return w - 1, w - 1
    return k - 1, k - 1


def chunk_codes(code_arrays: Sequence[np.ndarray], k: int,
                chunk_len: int = 1 << 16,
                w: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-sequence code arrays into fixed-shape chunks with halos.

    Each chunk owns base positions [start, start + chunk_len) of its
    sequence and carries (left, right) halo context (see chunk_halos) so
    that k-mer extraction and minimizer selection inside the owned region
    are exact. Out-of-sequence positions are padded with INVALID, which
    kills any k-mer spanning the junction. Emitted k-mers must be masked
    to the owned range (owned_kmer_range) to avoid boundary duplicates.

    Returns (chunks uint8 (n, left + chunk_len + right), nrows dummy).
    """
    h_l, h_r = chunk_halos(k, w)
    width = chunk_len + h_l + h_r
    rows: List[np.ndarray] = []
    for codes in code_arrays:
        L = len(codes)
        if L < k:
            continue
        start = 0
        while start < L - (k - 1):
            lo = start - h_l
            pad_left = max(0, -lo)
            lo = max(lo, 0)
            hi = min(start + chunk_len + h_r, L)
            row = np.full(width, INVALID, dtype=np.uint8)
            seg = codes[lo:hi]
            row[pad_left:pad_left + len(seg)] = seg
            rows.append(row)
            start += chunk_len
    if not rows:
        return (np.full((1, width), INVALID, dtype=np.uint8),
                np.zeros(1, dtype=np.int64))
    chunks = np.stack(rows)
    return chunks, np.full(len(rows), width, dtype=np.int64)


def owned_kmer_range(k: int, w: int, chunk_len: int) -> Tuple[int, int]:
    """Local k-mer index range [lo, hi) a chunk owns (mask everything
    else to avoid boundary duplicates)."""
    h_l, _ = chunk_halos(k, w)
    return h_l, h_l + chunk_len


# ----------------------------------------------------------------------
# Device: exact k-mer codes
# ----------------------------------------------------------------------


def dna_kmer_codes(codes: jnp.ndarray, k: int, canonicalize: bool = True
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All k-mer codes of chunk rows, 2-bit DNA packing.

    codes: uint8 (..., L). Returns (kmers uint64 (..., L-k+1),
    valid bool (..., L-k+1)). Positions whose window touches an INVALID
    base are masked out. Canonical k-mer = min(forward, reverse-complement),
    matching bns::Encoder::canonicalize semantics.

    The k accumulation steps are static-unrolled shifted adds: per step one
    shift + or on u64 lanes, fully parallel across positions.
    """
    L = codes.shape[-1]
    n = L - k + 1
    bad = (codes == INVALID)
    c64 = jnp.where(bad, 0, codes).astype(jnp.uint64)
    fwd = jnp.zeros(codes.shape[:-1] + (n,), dtype=jnp.uint64)
    rc = jnp.zeros_like(fwd)
    for j in range(k):
        cj = jax.lax.slice_in_dim(c64, j, j + n, axis=-1)
        fwd = (fwd << jnp.uint64(2)) | cj
        # complement base into ascending significance: position j of the
        # forward k-mer is position k-1-j of the reverse complement.
        rc = rc | ((jnp.uint64(3) - cj) << jnp.uint64(2 * j))
    # validity via windowed any-bad
    badw = _window_any(bad, k)
    if canonicalize:
        kmers = jnp.minimum(fwd, rc)
    else:
        kmers = fwd
    return kmers, ~badw


def base_b_kmer_codes(codes: jnp.ndarray, k: int, base: int
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Base-b packed k-mers for non-DNA alphabets (no canonicalization)."""
    L = codes.shape[-1]
    n = L - k + 1
    bad = (codes == INVALID)
    c64 = jnp.where(bad, 0, codes).astype(jnp.uint64)
    acc = jnp.zeros(codes.shape[:-1] + (n,), dtype=jnp.uint64)
    for j in range(k):
        cj = jax.lax.slice_in_dim(c64, j, j + n, axis=-1)
        acc = acc * jnp.uint64(base) + cj
    return acc, ~_window_any(bad, k)


def spaced_kmer_codes(codes: jnp.ndarray, offsets: Sequence[int], bits: int,
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Spaced-seed k-mers: keep bases at the given absolute offsets.

    offsets: increasing positions within the seed span (offsets[-1]+1 = span).
    bits: bits per base (2 for DNA). Every base in the span must be valid
    (matches the reference's spacing semantics where skipped positions still
    must exist).
    """
    span = offsets[-1] + 1
    L = codes.shape[-1]
    n = L - span + 1
    bad = (codes == INVALID)
    c64 = jnp.where(bad, 0, codes).astype(jnp.uint64)
    acc = jnp.zeros(codes.shape[:-1] + (n,), dtype=jnp.uint64)
    for off in offsets:
        cj = jax.lax.slice_in_dim(c64, off, off + n, axis=-1)
        acc = (acc << jnp.uint64(bits)) | cj
    return acc, ~_window_any(bad, span)


def _window_any(flags: jnp.ndarray, k: int) -> jnp.ndarray:
    """windowed OR over length-k windows along the last axis (out len L-k+1),
    via log-step shift-or."""
    n = flags.shape[-1] - k + 1
    x = flags
    width = 1
    while width < k:
        step = min(width, k - width)
        x = x | _shift_left(x, step)
        width += step
    return jax.lax.slice_in_dim(x, 0, n, axis=-1)


def _shift_left(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """x[..., i] -> x[..., i+s], padding the tail with the pad value
    (False for bool, +inf-like max for uint)."""
    pad = jnp.zeros(x.shape[:-1] + (s,), dtype=x.dtype)
    if x.dtype != jnp.bool_:
        pad = pad + jnp.array(np.iinfo(np.uint64).max if x.dtype == jnp.uint64 else 0, x.dtype)
    return jnp.concatenate([jax.lax.slice_in_dim(x, s, x.shape[-1], axis=-1), pad], axis=-1)


def dna_kmer_codes128(codes: jnp.ndarray, k: int, canonicalize: bool = True
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """128-bit exact DNA k-mer codes for k <= 62 (--long-kmers).

    Returns (hi u64, lo u64, valid) per position; canonical = 128-bit min
    of forward and reverse complement.
    """
    L = codes.shape[-1]
    n = L - k + 1
    bad = (codes == INVALID)
    c64 = jnp.where(bad, 0, codes).astype(jnp.uint64)
    z = jnp.zeros(codes.shape[:-1] + (n,), dtype=jnp.uint64)
    fhi, flo, rhi, rlo = z, z, z, z
    for j in range(k):
        cj = jax.lax.slice_in_dim(c64, j, j + n, axis=-1)
        fhi = (fhi << jnp.uint64(2)) | (flo >> jnp.uint64(62))
        flo = (flo << jnp.uint64(2)) | cj
        comp = jnp.uint64(3) - cj
        if 2 * j < 64:
            rlo = rlo | (comp << jnp.uint64(2 * j))
        else:
            rhi = rhi | (comp << jnp.uint64(2 * j - 64))
    valid = ~_window_any(bad, k)
    if canonicalize:
        rc_less = (rhi < fhi) | ((rhi == fhi) & (rlo < flo))
        hi = jnp.where(rc_less, rhi, fhi)
        lo = jnp.where(rc_less, rlo, flo)
    else:
        hi, lo = fhi, flo
    return hi, lo, valid


_ROLL_SALT = 0x1F3D5B79A2C4E608


@functools.lru_cache(maxsize=None)
def _rolling_table(alphabet: Alphabet) -> np.ndarray:
    """Per-symbol random u64 table for the cyclic-polynomial rolling hash
    (bns::RollingHasher equivalent for k beyond exact coding)."""
    from .. import hashing as H
    nsym = alphabet_size(alphabet)
    syms = np.arange(nsym, dtype=np.uint64)
    return H.wanghash(syms * np.uint64(0x9E3779B97F4A7C15)
                      ^ np.uint64(_ROLL_SALT))


def _rotl64(x: jnp.ndarray, s: int) -> jnp.ndarray:
    s %= 64
    if s == 0:
        return x
    return (x << jnp.uint64(s)) | (x >> jnp.uint64(64 - s))


def rolling_hash_codes(codes: jnp.ndarray, k: int, canonicalize: bool,
                       alphabet: Alphabet
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cyclic-polynomial rolling hash for unbounded k (ntHash-style):
    h_i = XOR_j rotl(T[c_{i+j}], (k-1-j) mod 64). Computed as k parallel
    rotate-xor passes (no sequential scan); reverse-complement canonical
    via the complement table with mirrored rotations."""
    table = jnp.asarray(_rolling_table(alphabet))
    L = codes.shape[-1]
    n = L - k + 1
    bad = (codes == INVALID)
    safe = jnp.where(bad, 0, codes).astype(jnp.int32)
    t = table[safe]
    fwd = jnp.zeros(codes.shape[:-1] + (n,), dtype=jnp.uint64)
    if canonicalize and alphabet in (Alphabet.DNA, Alphabet.DNAC):
        tc = table[jnp.where(bad, 0, 3 - safe)]
        rc = jnp.zeros_like(fwd)
        for j in range(k):
            tj = jax.lax.slice_in_dim(t, j, j + n, axis=-1)
            tcj = jax.lax.slice_in_dim(tc, j, j + n, axis=-1)
            fwd = fwd ^ _rotl64(tj, (k - 1 - j) % 64)
            rc = rc ^ _rotl64(tcj, j % 64)
        out = jnp.minimum(fwd, rc)
    else:
        for j in range(k):
            tj = jax.lax.slice_in_dim(t, j, j + n, axis=-1)
            fwd = fwd ^ _rotl64(tj, (k - 1 - j) % 64)
        out = fwd
    return out, ~_window_any(bad, k)


# ----------------------------------------------------------------------
# Device: window minimizers
# ----------------------------------------------------------------------


def window_min(values: jnp.ndarray, nwin: int) -> jnp.ndarray:
    """Sliding min over windows of `nwin` consecutive values (log-step)."""
    x = values
    width = 1
    while width < nwin:
        step = min(width, nwin - width)
        x = jnp.minimum(x, _shift_left(x, step))
        width += step
    n = values.shape[-1] - nwin + 1
    return jax.lax.slice_in_dim(x, 0, n, axis=-1)


def minimizer_mask(scores: jnp.ndarray, valid: jnp.ndarray, k: int, w: int
                   ) -> jnp.ndarray:
    """Mask of k-mer positions selected as the minimum of >= 1 window.

    scores: (..., n) per-kmer selection scores (lower wins; lexicographic
    minimizers use the k-mer code itself as score). Invalid positions get
    +inf scores. A window is live only if ALL its k-mers are valid — the
    standard streaming-minimizer reset at sequence edges and N-runs.
    (Enforcing liveness is also what makes chunked selection identical
    to the unchunked computation: windows reaching into a chunk's
    out-of-sequence padding are dead, exactly like the nonexistent
    windows past the ends of an unchunked array.) Ties broken toward
    the leftmost position (stable, standard choice).
    """
    nwin = w - k + 1
    if nwin <= 1:
        return valid
    maxv = jnp.array(np.iinfo(np.uint64).max, jnp.uint64)
    s = jnp.where(valid, scores, maxv)
    wmin = window_min(s, nwin)  # (..., n - nwin + 1)
    # window liveness: sliding AND of validity over nwin positions
    wlive = window_min(valid.astype(jnp.uint8), nwin) > 0
    # position i is selected iff s[i] equals the min of some LIVE window
    # that contains i and s[i] is the leftmost occurrence of that min in
    # the window. Leftmost-tie handling: compare against a "strictly
    # less to the left within nwin-1" sliding min of prior positions.
    n = s.shape[-1]
    # windows j = max(0, i-nwin+1) .. min(i, nw-1) contain position i
    # expand wmin back: position i selected if any LIVE j with
    # wmin[j]==s[i] (out-of-range / dead windows contribute nothing)
    hit = jnp.zeros_like(valid)
    for d in range(nwin):
        # window starting at i-d contains i (needs 0 <= i-d < nw)
        shifted = _shift_right(wmin, d, n)
        live = _shift_right(wlive, d, n)
        hit = hit | (live & (shifted == s))
    # leftmost tie-break: no equal value within the previous nwin-1 slots
    prev_eq = jnp.zeros_like(valid)
    for d in range(1, nwin):
        prev_eq = prev_eq | (_shift_right(s, d, n) == s)
    sel = hit & valid & ~prev_eq
    return sel


def _shift_right(x: jnp.ndarray, s: int, out_len: int) -> jnp.ndarray:
    """y[..., i] = x[..., i-s] (out of range -> max), truncated/padded to out_len."""
    maxv = jnp.array(np.iinfo(np.uint64).max, jnp.uint64).astype(x.dtype) \
        if x.dtype != jnp.bool_ else jnp.zeros((), jnp.bool_)
    pad = jnp.full(x.shape[:-1] + (s,), maxv, dtype=x.dtype)
    y = jnp.concatenate([pad, x], axis=-1)
    if y.shape[-1] < out_len:
        tailpad = jnp.full(x.shape[:-1] + (out_len - y.shape[-1],), maxv, dtype=x.dtype)
        y = jnp.concatenate([y, tailpad], axis=-1)
    return jax.lax.slice_in_dim(y, 0, out_len, axis=-1)


# ----------------------------------------------------------------------
# Full pipeline: chunk codes -> masked hashed k-mers
# ----------------------------------------------------------------------


def hashed_kmers(codes: jnp.ndarray, k: int, *, w: int = 0,
                 canonicalize: bool = True, alphabet: Alphabet = Alphabet.DNA,
                 xormask: int | None = None,
                 seed_is_zero: bool = False,
                 entropy_min: bool = False,
                 spacing_offsets: tuple[int, ...] | None = None,
                 rolling: bool = False,
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """codes (..., L) -> (hashed kmers u64, valid mask) per position.

    Applies exact k-mer coding for the alphabet (spaced-seed gather when
    spacing_offsets given; cyclic rolling hash when `rolling`, for k
    beyond the exact-coding capacity), optional window-w minimizer
    selection (lexicographic by k-mer code, or entropy-weighted hash when
    entropy_min), then the maskfn scrambler (fastxsketch.cpp:385-389:
    every emitted k-mer is passed through maskfn before
    filtering/sketching). With seed 0 the scrambler is disabled and raw
    k-mer codes flow through (options.h:502 soft-documented behavior).
    """
    from .. import hashing as H
    if rolling:
        kmers, valid = rolling_hash_codes(codes, k, canonicalize, alphabet)
    elif spacing_offsets:
        bits = 2 if alphabet in (Alphabet.DNA, Alphabet.DNAC) else \
            max(1, (alphabet_size(alphabet) - 1).bit_length())
        kmers, valid = spaced_kmer_codes(codes, list(spacing_offsets), bits)
    elif alphabet in (Alphabet.DNA, Alphabet.DNAC):
        kmers, valid = dna_kmer_codes(codes, k, canonicalize)
    elif alphabet == Alphabet.DNA2:
        kmers, valid = base_b_kmer_codes(codes, k, 2)
    else:
        kmers, valid = base_b_kmer_codes(codes, k, alphabet_size(alphabet))
    if w > k:
        scores = (_entropy_weighted_hash(kmers, codes, k)
                  if entropy_min else kmers)
        sel = minimizer_mask(scores, valid, k, w)
        valid = sel
    if xormask is None:
        xormask = H.XORMASK
    if seed_is_zero:
        hashed = kmers
    else:
        hashed = DH.maskfn(kmers, xormask)
    return hashed, valid


def _entropy_weighted_hash(kmers: jnp.ndarray, codes: jnp.ndarray, k: int
                           ) -> jnp.ndarray:
    """Entropy-scored minimizers (--entmin): weight the k-mer hash by the
    base-composition entropy so low-complexity k-mers lose windows
    (bonsai to_entmin64 semantics, re-derived). Score = hash scaled by
    (1 - H/2) is approximated here as hash >> (2 * (2 - H)) buckets; we use
    the simpler exact formulation score = hash / max(H, eps) computed in
    f64 then re-ordered as u64 by value."""
    # count base occurrences per window via 4 windowed sums
    L = codes.shape[-1]
    n = L - k + 1
    ent = jnp.zeros(codes.shape[:-1] + (n,), dtype=jnp.float64)
    for b in range(4):
        flags = (codes == b).astype(jnp.float64)
        csum = jnp.cumsum(flags, axis=-1)
        zero = jnp.zeros_like(jax.lax.slice_in_dim(csum, 0, 1, axis=-1))
        csum = jnp.concatenate([zero, csum], axis=-1)
        cnt = (jax.lax.slice_in_dim(csum, k, k + n, axis=-1)
               - jax.lax.slice_in_dim(csum, 0, n, axis=-1))
        p = cnt / k
        ent = ent - jnp.where(p > 0, p * jnp.log2(jnp.maximum(p, 1e-12)), 0.0)
    h = DH.wanghash(kmers).astype(jnp.float64)
    score = h / jnp.maximum(ent, 1e-3)
    # order-preserving conversion back to u64 for the shared min machinery
    return jnp.clip(score, 0, 1.8e19).astype(jnp.uint64)


def parse_spacing(spacing: str, k: int) -> list[int]:
    """Parse the --spacing argument (options.h:488-492): comma-separated
    gaps after each kept position, with <gap>x<count> run-length syntax.
    Returns absolute offsets of the k kept positions."""
    if not spacing:
        return list(range(k))
    gaps: list[int] = []
    for tok in spacing.split(","):
        if "x" in tok:
            g, c = tok.split("x")
            gaps.extend([int(g)] * int(c))
        else:
            gaps.append(int(tok))
    if len(gaps) != k - 1:
        raise ValueError(f"spacing needs k-1={k-1} entries, got {len(gaps)}")
    offsets = [0]
    for g in gaps:
        offsets.append(offsets[-1] + 1 + g)
    return offsets
