"""Sketch orchestration: files/sequences -> SketchingResult.

Device rework of fastx2sketch (/root/reference/src/fastxsketch.cpp:162-627)
and fastx2sketch_byseq (:102): instead of per-file OpenMP threads each
streaming k-mers through a private sketch, sequences are chunked into
fixed-shape code blocks (ops/kmers.chunk_codes) and whole *batches of
chunks from many items* flow through one jitted kernel:

    codes (B, L) --[k-mer + hash + minimizer select]--> (B, n) hashes
      --[OPH segment-min keyed by (item, bucket)]--> (nitems, m) registers

Partial registers from successive batches merge on the host by elementwise
min (the universal sketch merge operator, setsketch.h:432-448), with
min-count bookkeeping. The CSetSketch path uses the threshold-filtered
kernel per item (ops/sketch_kernels.css_sketch).

Deviations from the reference, by design:
* k-mer downsampling (--downsample) is a stateless per-k-mer hash test
  (keep iff WangHash(h ^ SALT) < frac * 2^64) rather than a shared-state
  RNG stream (d2.h:176-179) — order-independent, SPMD-safe, same expected
  fraction.
* --count-threshold runs an exact distinct-count pass (device sort) and
  sketches surviving k-mers once, which reproduces the CountFiltered*
  final state without per-update hash-map "potentials" (oph.h:188-205).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import hashing as H
from ..config import Dashing2Options
from ..enums import Alphabet, KmerSketchResultType, SketchSpace
from ..io import fastx
from ..ops import hashes as DH
from ..ops import kmers as K
from ..ops import sketch_kernels as SK
from ..result import SketchingResult

DOWNSAMPLE_SALT = 0x6F22B7A19E5F3D71
U64MAX = SK.U64MAX


# ----------------------------------------------------------------------
# batched hashed-kmer production
# ----------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "k", "w", "canon", "alphabet", "entmin", "xormask", "seed_is_zero",
    "downsample_threshold", "use_filterset", "chunk_len", "span",
    "spacing_offsets", "rolling", "use128"))
def _hash_chunk_batch(chunks: jnp.ndarray, filterset: jnp.ndarray, *,
                      k: int, w: int, canon: bool, alphabet: Alphabet,
                      entmin: bool, xormask: int, seed_is_zero: bool,
                      downsample_threshold: int, use_filterset: bool,
                      chunk_len: int, span: int = 0, spacing_offsets=None,
                      rolling: bool = False, use128: bool = False):
    if span <= 0:
        span = k
    if use128 and not rolling and not spacing_offsets:
        # --long-kmers: 128-bit exact codes; the scrambled low word feeds
        # the 64-bit sketch machinery (maskfn(u128) low-word truncation,
        # enums.h:144-148 + oph.h update(uint64_t))
        hi, lo, valid = K.dna_kmer_codes128(chunks, k, canon)
        from ..ops import hashes as _DH
        hashed = lo if seed_is_zero else _DH.maskfn(lo, xormask)
        if w > k:
            sel = K.minimizer_mask(
                (hi >> jnp.uint64(1)) ^ lo, valid, k, w)
            valid = sel
    else:
        hashed, valid = K.hashed_kmers(
            chunks, k, w=w, canonicalize=canon, alphabet=alphabet,
            xormask=xormask, seed_is_zero=seed_is_zero, entropy_min=entmin,
            spacing_offsets=spacing_offsets, rolling=rolling)
    # ownership mask: drop halo positions so chunk boundaries emit each
    # k-mer exactly once
    lo, hi = K.owned_kmer_range(span, w, chunk_len)
    pos = jnp.arange(hashed.shape[-1])
    valid = valid & (pos >= lo) & (pos < hi)
    if downsample_threshold < (1 << 64) - 1:
        keep = DH.wanghash(hashed ^ jnp.uint64(DOWNSAMPLE_SALT)) < \
            jnp.uint64(downsample_threshold)
        valid = valid & keep
    if use_filterset:
        # exclude k-mers present in the (sorted) filterset
        pos = jnp.searchsorted(filterset, hashed)
        pos = jnp.minimum(pos, filterset.shape[0] - 1)
        valid = valid & (filterset[pos] != hashed)
    return hashed, valid


@functools.partial(jax.jit, static_argnames=(
    "k", "w", "canon", "xormask", "xormask2_hi", "seed_is_zero",
    "downsample_threshold", "use_filterset", "chunk_len"))
def _hash_chunk_batch128(chunks: jnp.ndarray, filterset: jnp.ndarray, *,
                         k: int, w: int, canon: bool, xormask: int,
                         xormask2_hi: int, seed_is_zero: bool,
                         downsample_threshold: int, use_filterset: bool,
                         chunk_len: int):
    """Full-width 128-bit exact k-mer keys for EXACT-SET sketching
    (--set/--countdict with --long-kmers): (hi', lo', valid) per
    position, where (hi', lo') is the reference's u128 maskfn — XOR
    with the 128-bit seed mask, then per-word WangHash (enums.h:
    144-148) — applied to the canonical 128-bit code. Register
    sketches keep the documented low-word truncation
    (_hash_chunk_batch); exact sets compare full keys like the
    reference's __uint128_t sorted merges (wcompare.cpp:28-51,111).
    Minimizer selection, ownership, downsampling and the filterset
    probe are IDENTICAL to the 64-bit path (selection scores the
    canonical code's (hi >> 1) ^ lo; downsample/filterset key on the
    masked LOW word — the same key the register path uses, so the
    same k-mers survive; a filterset low-word collision excludes with
    2^-64 probability, documented in README deviations)."""
    hi, lo, valid = K.dna_kmer_codes128(chunks, k, canon)
    if seed_is_zero:
        mhi, mlo = hi, lo
    else:
        mlo = DH.maskfn(lo, xormask)
        mhi = DH.maskfn(hi, xormask2_hi)
    if w > k:
        sel = K.minimizer_mask((hi >> jnp.uint64(1)) ^ lo, valid, k, w)
        valid = sel
    lo_, hi_ = K.owned_kmer_range(k, w, chunk_len)
    pos = jnp.arange(mlo.shape[-1])
    valid = valid & (pos >= lo_) & (pos < hi_)
    if downsample_threshold < (1 << 64) - 1:
        keep = DH.wanghash(mlo ^ jnp.uint64(DOWNSAMPLE_SALT)) < \
            jnp.uint64(downsample_threshold)
        valid = valid & keep
    if use_filterset:
        fpos = jnp.searchsorted(filterset, mlo)
        fpos = jnp.minimum(fpos, filterset.shape[0] - 1)
        valid = valid & (filterset[fpos] != mlo)
    return mhi, mlo, valid


@functools.lru_cache(maxsize=32)
def _fused_oph_fn(hkw_items: tuple, m: int, seed: int, want_counts: bool,
                  use_fs: bool, oph_engine: str = "dense"):
    """ONE jitted function for the whole per-batch OPH sketch step:
    encode/hash/minimize -> ownership/downsample/filterset masks -> OPH
    dense-rows registers (+ counts) -> packed (R, m*2) u64 result. The
    unfused pipeline paid 3+ dispatches and HBM round-trips of the
    (R, nk) u64 hash intermediates per batch."""
    import jax

    hkw = dict(hkw_items)

    @jax.jit
    def f(chunks, filterset):
        hashed, valid = _hash_chunk_batch(chunks, filterset,
                                          use_filterset=use_fs, **hkw)
        if oph_engine == "rot":
            r, c = SK.oph_sketch_rows_rot(hashed, valid, m=m, seed=seed,
                                          want_counts=want_counts)
        elif oph_engine == "scatter":
            r, c = SK.oph_sketch_rows_scatter(hashed, valid, m=m,
                                              seed=seed,
                                              want_counts=want_counts)
        elif oph_engine == "sort":
            r, c = SK.oph_sketch_rows_sort(hashed, valid, m=m, seed=seed,
                                           want_counts=want_counts)
        elif oph_engine == "dense2":
            r, c = SK.oph_sketch_rows_dense2(hashed, valid, m=m, seed=seed,
                                             want_counts=want_counts)
        else:
            r, c = SK.oph_sketch_rows_dense(hashed, valid, m=m, seed=seed,
                                            want_counts=want_counts)
        if not want_counts:
            # don't ship the all-zero counts half over device->host
            return r
        return jnp.concatenate([r, c.astype(jnp.uint64)], axis=1)
    return f


def _hkw_key(hkw: dict) -> tuple:
    return tuple(sorted(hkw.items()))


def _native_oph_supported(hkw: dict, use_fs: bool) -> bool:
    """Config coverage of the native host OPH sketcher. Round 5: the
    FULL sketch-config surface — 2-bit DNA (incl. w>k minimizer
    windows), protein/DNA2 base-b alphabets, spaced seeds, rolling hash
    for k beyond exact coding, the 128-bit low-word path, and filterset
    probes — every config except --entmin (whose entropy scores go
    through log2/division, not bit-reproducible between XLA's libm and
    the host's; it stays on the device engines)."""
    del use_fs  # filtersets probe the scramble keys in the generic loop
    if hkw["entmin"]:
        return False
    if hkw["rolling"] or hkw["spacing_offsets"]:
        return True
    from ..enums import Alphabet
    if hkw["use128"]:
        return 1 <= hkw["k"] <= 63
    if hkw["alphabet"] in (Alphabet.DNA, Alphabet.DNAC):
        return 1 <= hkw["k"] <= 32
    # base-b exact coding: non-rolling implies k is within the
    # alphabet's 64-bit capacity (config.use_rolling_hash)
    return hkw["k"] >= 1


# native/oph_sketch.cpp enum Mode
_NAT_DNA, _NAT_BASEB, _NAT_SPACED, _NAT_ROLL, _NAT_DNA128 = range(5)


def _native_mode(hkw: dict):
    """(mode, base, bits, offsets, roll_table, canon_eff): the native
    engine's encoding selection, mirroring _hash_chunk_batch +
    ops/kmers.hashed_kmers routing exactly."""
    from ..enums import Alphabet
    alpha = hkw["alphabet"]
    is_dna = alpha in (Alphabet.DNA, Alphabet.DNAC)
    base = K.alphabet_size(alpha)
    canon = bool(hkw["canon"])
    if hkw["use128"] and not hkw["rolling"] and not hkw["spacing_offsets"]:
        return _NAT_DNA128, base, 2, None, None, canon
    if hkw["rolling"]:
        # canonical only for DNA (kmers.rolling_hash_codes)
        return (_NAT_ROLL, base, 2, None,
                K._rolling_table(alpha), canon and is_dna)
    if hkw["spacing_offsets"]:
        bits = 2 if is_dna else max(1, (base - 1).bit_length())
        return (_NAT_SPACED, base, bits,
                np.asarray(hkw["spacing_offsets"], np.int32), None, False)
    if is_dna:
        return _NAT_DNA, 4, 2, None, None, canon
    return _NAT_BASEB, base, 2, None, None, False


def _native_oph_rows(lib, chunks: np.ndarray, hkw: dict, m: int,
                     seed: int, want_counts: bool, nthreads: int = 0,
                     filterset: Optional[np.ndarray] = None):
    """Sketch one (R, L) chunk batch on host cores via the native
    engine; bit-identical to the device path for supported configs."""
    import ctypes

    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    R, L = chunks.shape
    regs = np.empty((R, m), np.uint64)
    counts = np.empty((R, m), np.uint32) if want_counts else None
    span = hkw.get("span") or hkw["k"]
    lo, hi = K.owned_kmer_range(span, hkw["w"], hkw["chunk_len"])
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    oph_xor = int(H.mt19937_64_first(seed)) ^ H.CEIXOR_OPH
    if nthreads <= 0:
        nthreads = int(os.environ.get("DASHING2_TPU_NATIVE_THREADS", 0))
    mode, base, bits, offsets, roll_table, canon = _native_mode(hkw)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    off_p, noff = i32p(), 0
    if offsets is not None:
        offsets = np.ascontiguousarray(offsets, np.int32)
        off_p, noff = offsets.ctypes.data_as(i32p), len(offsets)
    roll_p = u64p()
    if roll_table is not None:
        roll_table = np.ascontiguousarray(roll_table, np.uint64)
        roll_p = roll_table.ctypes.data_as(u64p)
    fs_p, fs_len = u64p(), 0
    if filterset is not None and len(filterset):
        filterset = np.ascontiguousarray(filterset, np.uint64)
        fs_p, fs_len = filterset.ctypes.data_as(u64p), len(filterset)
    lib.oph_rows_native(
        chunks.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        R, L, hkw["k"], hkw["w"], int(canon),
        int(hkw["seed_is_zero"]),
        hkw["xormask"], oph_xor & 0xFFFFFFFFFFFFFFFF,
        int(ds), hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
        DOWNSAMPLE_SALT, lo, hi, m, nthreads,
        mode, base, bits, off_p, noff, roll_p, fs_p, fs_len, span,
        regs.ctypes.data_as(u64p),
        counts.ctypes.data_as(u32p) if want_counts else u32p())
    if counts is None:
        counts = np.zeros((R, m), np.uint32)
    return regs, counts


def _hash_kwargs(opts: Dashing2Options, chunk_len: int) -> dict:
    spacing = (tuple(K.parse_spacing(opts.spacing, opts.k))
               if opts.spacing else None)
    limit = opts.nremper128 if opts.use128 else opts.nremper64
    rolling = opts.k > limit and not spacing
    return dict(
        k=opts.k, w=opts.w, canon=opts.canonicalize, alphabet=opts.alphabet,
        entmin=opts.entmin, xormask=opts.xormask,
        seed_is_zero=False,
        downsample_threshold=opts.downsample_threshold(),
        chunk_len=chunk_len,
        span=(spacing[-1] + 1) if spacing else opts.k,
        spacing_offsets=spacing,
        rolling=rolling,
        use128=opts.use128 and opts.alphabet in (Alphabet.DNA,
                                                 Alphabet.DNAC),
    )


@dataclasses.dataclass
class _Item:
    """One sketchable item: a file group or a single sequence."""
    name: str
    codes: List[np.ndarray]


def _load_items(opts: Dashing2Options, groups: Sequence[str]):
    """Returns (items, seqstore). seqstore holds the raw sequences for
    the edit-distance space — RAM below 2 Gbp, temp-file spill above
    (tmpseqs.h semantics; --seqs-in-ram pins RAM)."""
    from ..io.seqstore import SequenceStore
    items: List[_Item] = []
    keep_raw = opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE
    store = SequenceStore(in_ram=opts.seqs_in_ram) if keep_raw else None
    for group in groups:
        if opts.parse_by_seq:
            for path in group.split():
                if keep_raw:
                    for name, seq in fastx.read_fastx(path):
                        store.append(bytes(seq))
                        items.append(_Item(
                            name=name,
                            codes=[K.encode_ascii(seq, opts.alphabet)]))
                else:
                    for name, codes in fastx.read_encoded(path,
                                                          opts.alphabet):
                        items.append(_Item(name=name, codes=[codes]))
        else:
            codes = []
            raws = []
            for path in group.split():
                if keep_raw:
                    for _, seq in fastx.read_fastx(path):
                        codes.append(K.encode_ascii(seq, opts.alphabet))
                        raws.append(bytes(seq))
                else:
                    for _, c in fastx.read_encoded(path, opts.alphabet):
                        codes.append(c)
            if keep_raw:
                store.append(b"".join(raws))
            items.append(_Item(name=group, codes=codes))
    return items, store


def _should_stream(opts: Dashing2Options, groups: Sequence[str]) -> bool:
    """Streaming ingest policy: iterate items lazily (one group's codes
    in RAM at a time) instead of materializing the whole corpus. On by
    default above DASHING2_TPU_STREAM_BYTES (2 GiB) of input, forced
    with DASHING2_TPU_STREAM=1, off with =0. Mirrors the reference's
    per-file streaming with O(file) buffers (fastxsketch.cpp:302-424)."""
    mode = os.environ.get("DASHING2_TPU_STREAM", "")
    if mode == "1":
        return True
    if mode == "0":
        return False
    thresh = int(os.environ.get("DASHING2_TPU_STREAM_BYTES", 2 << 30))
    total = 0
    for g in groups:
        for path in g.split():
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        if total > thresh:
            return True
    return False


def _iter_items_lazy(opts: Dashing2Options, groups: Sequence[str]
                     ) -> Iterable[_Item]:
    """Yield one _Item per group, loading its encoded sequences on
    demand — host RSS stays O(largest group), not O(corpus)."""
    for group in groups:
        if opts.parse_by_seq:
            for path in group.split():
                for name, codes in fastx.read_encoded(path, opts.alphabet):
                    yield _Item(name=name, codes=[codes])
        else:
            codes = []
            for path in group.split():
                for _, c in fastx.read_encoded(path, opts.alphabet):
                    codes.append(c)
            yield _Item(name=group, codes=codes)


def _count_records(opts: Dashing2Options, groups: Sequence[str]
                   ) -> List[str]:
    """Counting pass for --parse-by-seq streaming (the reference's
    two-pass design, fastxsketchbyseq.cpp:146-171): record names only."""
    names: List[str] = []
    for group in groups:
        for path in group.split():
            for name, _ in fastx.read_fastx(path):
                names.append(name)
    return names


def _iter_chunk_batches(opts: Dashing2Options, items: Sequence[_Item],
                        chunk_len: int, rows_per_batch: int
                        ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """Yield (chunks (R, L) u8, item_ids (R,) i32) fixed-shape batches."""
    spacing = (K.parse_spacing(opts.spacing, opts.k)
               if opts.spacing else None)
    span = (spacing[-1] + 1) if spacing else opts.k
    halo_w = opts.w if opts.w > span else 0
    h_l, h_r = K.chunk_halos(span, halo_w)
    width = chunk_len + h_l + h_r
    buf: List[np.ndarray] = []
    ids: List[int] = []

    def flush():
        nonlocal buf, ids
        if not buf:
            return None
        rows = np.stack(buf)
        rid = np.asarray(ids, dtype=np.int32)
        # full batches share one jit shape; the tail batch pads only to
        # the next power of two (a second compiled shape) — padding all
        # the way to rows_per_batch makes tiny corpora execute mostly
        # padding rows
        target = (rows_per_batch if len(rid) == rows_per_batch
                  else min(rows_per_batch,
                           max(8, 1 << (len(rid) - 1).bit_length())))
        pad = target - rows.shape[0]
        if pad > 0:
            rows = np.concatenate(
                [rows, np.full((pad, width), K.INVALID, np.uint8)])
            rid = np.concatenate([rid, np.full(pad, -1, np.int32)])
        buf, ids = [], []
        return rows, rid

    for idx, item in enumerate(items):
        chunks, _ = K.chunk_codes(item.codes, span, chunk_len=chunk_len,
                                  w=halo_w)
        for row in chunks:
            buf.append(row)
            ids.append(idx)
            if len(buf) == rows_per_batch:
                yield flush()
    tail = flush()
    if tail is not None:
        yield tail


def _timed_iter(it, name: str):
    """Iterate while accumulating per-next() wall into the named span —
    the consumer-side stall behind the ingest/prefetch producer."""
    import time as _time

    from ..timing import add_span
    it = iter(it)
    while True:
        t0 = _time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            add_span(name, _time.perf_counter() - t0)
        yield item


def _merge_oph(regs_a, counts_a, regs_b, counts_b):
    """Merge two OPH partials: min registers; counts follow the winning
    side and add when both sides hold the same min (streaming semantics,
    oph.h:206-210)."""
    take_b = regs_b < regs_a
    tie = regs_b == regs_a
    regs = np.where(take_b, regs_b, regs_a)
    counts = np.where(tie, counts_a + counts_b,
                      np.where(take_b, counts_b, counts_a))
    return regs, counts


# ----------------------------------------------------------------------
# main entry
# ----------------------------------------------------------------------

def _auto_chunk_len(items: Sequence["_Item"]) -> int:
    """Smallest power-of-two chunk covering the longest sequence, in
    [4096, 32768]: corpora of many short sequences would otherwise pad
    every row to the 32k maximum (3x wasted device work at 10kb
    genomes). One size per run keeps a single jit shape."""
    longest = max((len(c) for it in items for c in it.codes), default=0)
    cl = 4096
    while cl < longest and cl < (1 << 15):
        cl <<= 1
    return cl


def sketch_fastx(opts: Dashing2Options, groups: Sequence[str],
                 chunk_len: int = 0, rows_per_batch: int = 0
                 ) -> SketchingResult:
    """Sketch FASTA/FASTQ inputs with cache probe/write (--cache:
    parameter-keyed per-input artifacts, fastxsketch.cpp:313-380,461-524).

    `groups`: one item per entry; an entry may contain several
    space-separated paths sketched jointly (d2.h:52-71)."""
    if opts.cache_sketches and not opts.parse_by_seq \
            and opts.sspace != SketchSpace.SPACE_EDIT_DISTANCE:
        # edit-distance space bypasses the cache: exact comparisons need
        # the sequences themselves, which no cache artifact stores
        return _sketch_fastx_cached(opts, groups, chunk_len, rows_per_batch)
    return _sketch_fastx_core(opts, groups, chunk_len, rows_per_batch)


def _sketch_fastx_cached(opts: Dashing2Options, groups: Sequence[str],
                         chunk_len: int = 0, rows_per_batch: int = 0
                         ) -> SketchingResult:
    from ..io import formats
    from ..io.cache import makedest
    from ..enums import KmerSketchResultType as KR
    m = opts.sketchsize
    kres = opts.kmer_result
    # register dtype of signature caches: f64 OPH/CSetSketch registers,
    # or the quantized width for compressed direct sketching (the cache
    # key carries a/b/fd so widths never cross files — io/cache.makedest)
    sig_dt = np.float64
    if opts.sketch_compressed_set:
        sig_dt = {0.5: np.uint8, 1.0: np.uint8, 2.0: np.uint16,
                  4.0: np.uint32, 8.0: np.uint64}[opts.fd_level]
    # --save-kmers/--save-kmercounts: per-item k-mer artifacts ride the
    # cache too (fastxsketch.cpp:461-524 writes .kmer/.kmercounts files);
    # a signature cache without its k-mer artifact is a MISS, or cached
    # items would carry all-zero k-mer rows into the eq-count engines
    want_kmers = (kres == KR.ONE_PERM
                  and (opts.save_kmers or opts.save_kmercounts))
    def _exact_stream_wanted(opts, *paths) -> bool:
        """>RAM exact corpora stay file-backed (DiskSortedSet) and
        compare via the chunked streaming merge — the reference's
        FILE-based exact path (cmp_core.cpp:518-572). Triggered by
        DASHING2_TPU_EXACT_STREAM=1 or cache files above
        --sig-ram-limit."""
        env = os.environ.get("DASHING2_TPU_EXACT_STREAM")
        if env == "0":
            return False
        if env == "1":
            return True
        try:
            return sum(os.path.getsize(p) for p in paths) \
                > opts.sig_ram_limit
        except OSError:
            return False

    dests = [makedest(opts, g) for g in groups]
    loaded: dict = {}
    for i, dest in enumerate(dests):
        if kres == KR.FULL_MMER_COUNTDICT:
            # countdict artifacts live at the iskmer keys path + its
            # .kmercounts.f64 sibling (reference naming,
            # fastxsketch.cpp:313-318); `dest` itself is never written
            kp = makedest(opts, groups[i], iskmer=True)
            if not (os.path.isfile(kp)
                    and os.path.isfile(_counts_dest(kp))):
                continue
        elif not os.path.isfile(dest):
            continue
        try:
            if kres in (KR.ONE_PERM, KR.FULL_SETSKETCH):
                card, regs = formats.read_sketch_cache(dest, dtype=sig_dt)
                if len(regs) != m:
                    continue  # corrupted/size-mismatched: resketch
                kk = cc = None
                if want_kmers:
                    if opts.save_kmers:
                        kk = np.fromfile(dest + ".kmers.u64",
                                         dtype=np.uint64)
                        if len(kk) != m:
                            continue
                    if opts.save_kmercounts:
                        cc = np.fromfile(dest + ".kmercounts.f32",
                                         dtype=np.float32)
                        if len(cc) != m:
                            continue
                loaded[i] = ("sig", card, (regs, kk, cc))
            elif kres == KR.FULL_MMER_SET:
                if _exact_stream_wanted(opts, dest) \
                        and not _exact128_keys(opts):
                    from ..io.diskset import DiskSortedSet
                    ds = DiskSortedSet(dest, offset=8)
                    loaded[i] = ("set", float(len(ds)), ds)
                else:
                    card, kmers = _read_kmer_set(opts, dest,
                                                 with_card=True)
                    loaded[i] = ("set", card, kmers)
            elif kres == KR.FULL_MMER_COUNTDICT:
                kpath = makedest(opts, groups[i], iskmer=True)
                cpath = _counts_dest(kpath)
                if _exact_stream_wanted(opts, cpath, kpath) \
                        and not _exact128_keys(opts):
                    from ..io.diskset import DiskSortedSet
                    ds = DiskSortedSet(kpath, offset=8,
                                       counts_path=cpath)
                    if os.path.getsize(cpath) != 8 * len(ds):
                        continue
                    loaded[i] = ("dict", ds.counts_sum(), (ds, None))
                else:
                    card, kmers = _read_kmer_set(opts, kpath,
                                                 with_card=True)
                    counts = np.fromfile(cpath, dtype=np.float64)
                    if len(kmers) != len(counts):
                        continue
                    loaded[i] = ("dict", card, (kmers, counts))
            elif kres == KR.FULL_MMER_SEQUENCE:
                seq = _read_kmer_set(opts, dest)
                loaded[i] = ("seq", float(len(seq)), seq)
        except (OSError, ValueError):
            continue
    pending = [g for i, g in enumerate(groups) if i not in loaded]
    sub = (_sketch_fastx_core(opts, pending, chunk_len, rows_per_batch)
           if pending else SketchingResult())
    # assemble in original order
    res = SketchingResult(names=list(groups))
    n = len(groups)
    res.cardinalities = np.zeros(n, np.float64)
    if kres in (KR.ONE_PERM, KR.FULL_SETSKETCH):
        res.signatures = np.zeros((n, m), sig_dt)
        if want_kmers and opts.save_kmers:
            res.kmers = np.zeros((n, m), np.uint64)
        if want_kmers and opts.save_kmercounts:
            res.kmercounts = np.zeros((n, m), np.float32)
    elif kres in (KR.FULL_MMER_SET, KR.FULL_MMER_COUNTDICT):
        res.kmer_sets = [None] * n
        if kres == KR.FULL_MMER_COUNTDICT:
            res.kmer_set_counts = [None] * n
    else:
        res.mmer_sequences = [None] * n
    si = 0
    for i in range(n):
        if i in loaded:
            kind, card, payload = loaded[i]
            res.cardinalities[i] = card
            res.destination_files.append(dests[i])
            if kind == "sig":
                regs, kk, cc = payload
                res.signatures[i] = regs
                if kk is not None:
                    res.kmers[i] = kk
                if cc is not None:
                    res.kmercounts[i] = cc
            elif kind == "set":
                res.kmer_sets[i] = payload
            elif kind == "dict":
                res.kmer_sets[i] = payload[0]
                res.kmer_set_counts[i] = payload[1]
            else:
                res.mmer_sequences[i] = payload
        else:
            res.cardinalities[i] = sub.cardinalities[si]
            if res.signatures is not None:
                res.signatures[i] = sub.signatures[si]
                if res.kmers is not None:
                    res.kmers[i] = sub.kmers[si]
                if res.kmercounts is not None:
                    res.kmercounts[i] = sub.kmercounts[si]
            elif res.kmer_sets is not None:
                res.kmer_sets[i] = sub.kmer_sets[si]
                if res.kmer_set_counts is not None:
                    res.kmer_set_counts[i] = sub.kmer_set_counts[si]
            else:
                res.mmer_sequences[i] = sub.mmer_sequences[si]
            # write the cache artifact (fastxsketch.cpp:461-524)
            dest = dests[i]
            try:
                if kres in (KR.ONE_PERM, KR.FULL_SETSKETCH):
                    formats.write_sketch_cache(dest, res.cardinalities[i],
                                               res.signatures[i])
                    if want_kmers and opts.save_kmers:
                        res.kmers[i].tofile(dest + ".kmers.u64")
                    if want_kmers and opts.save_kmercounts:
                        res.kmercounts[i].tofile(dest + ".kmercounts.f32")
                elif kres == KR.FULL_MMER_SET:
                    _write_kmer_set(res.kmer_sets[i], dest,
                                    card=res.cardinalities[i])
                elif kres == KR.FULL_MMER_COUNTDICT:
                    # reference layout (fastxsketch.cpp:313-318,467):
                    # card + keys at the iskmer destination, raw f64
                    # counts at <keys stem>.kmercounts.f64
                    kdest = makedest(opts, groups[i], iskmer=True)
                    _write_kmer_set(res.kmer_sets[i], kdest,
                                    card=res.cardinalities[i])
                    res.kmer_set_counts[i].astype(np.float64).tofile(
                        _counts_dest(kdest))
                else:
                    _write_kmer_set(res.mmer_sequences[i], dest)
                res.destination_files.append(dest)
            except OSError:
                pass
            si += 1
    return res


def _native_hash_codes_list(lib, codes_list, hkw: dict,
                            filterset: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """Compact valid scrambled k-mer hashes for a list of RECORD code
    arrays, computed on host by the native engine (hash_rows_native).
    Records are padded into bucketed power-of-two rows (one record per
    row — per-record semantics identical to the chunked device path).
    The device route pulls the full (R, npos) u64 hash matrix back per
    flush; this is host-only."""
    import ctypes
    span = hkw.get("span") or hkw["k"]
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    mode, base, bits, offsets, roll_table, canon = _native_mode(hkw)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    off_p, noff = i32p(), 0
    if offsets is not None:
        offsets = np.ascontiguousarray(offsets, np.int32)
        off_p, noff = offsets.ctypes.data_as(i32p), len(offsets)
    roll_p = u64p()
    if roll_table is not None:
        roll_table = np.ascontiguousarray(roll_table, np.uint64)
        roll_p = roll_table.ctypes.data_as(u64p)
    fs_p, fs_len = u64p(), 0
    if filterset is not None and len(filterset):
        filterset = np.ascontiguousarray(filterset, np.uint64)
        fs_p, fs_len = filterset.ctypes.data_as(u64p), len(filterset)
    buckets: dict = {}
    for c in codes_list:
        if len(c) < span:
            continue
        L = 256
        while L < len(c):
            L <<= 1
        buckets.setdefault(L, []).append(c)
    parts: List[np.ndarray] = []
    for L, recs in sorted(buckets.items()):
        rcap = max(1, (32 << 20) // L)
        for s in range(0, len(recs), rcap):
            grp = recs[s:s + rcap]
            rows = np.full((len(grp), L), K.INVALID, np.uint8)
            for r, c in enumerate(grp):
                rows[r, :len(c)] = c
            npos = L - span + 1
            out = np.empty(len(grp) * npos, np.uint64)
            cnt = lib.hash_rows_native(
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                len(grp), L, hkw["k"], hkw["w"], int(canon),
                int(hkw["seed_is_zero"]), hkw["xormask"], int(ds),
                hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
                DOWNSAMPLE_SALT, mode, base, bits, off_p, noff,
                roll_p, fs_p, fs_len, span,
                out.ctypes.data_as(u64p))
            parts.append(out[:cnt].copy())
    if not parts:
        return np.zeros(0, np.uint64)
    return np.concatenate(parts)


def _native_hash_codes_list128(lib, codes_list, hkw: dict,
                               xormask2_hi: int,
                               filterset: Optional[np.ndarray] = None
                               ) -> np.ndarray:
    """u128 variant of _native_hash_codes_list: compact FULL masked
    (hi', lo') keys for the exact-set counting stream (the u128 maskfn
    of enums.h:144-148; same minimizer/downsample/filterset gating as
    _hash_chunk_batch128, which probes the masked low word)."""
    import ctypes

    from .. import u128 as U
    k = hkw["k"]
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    u64p = ctypes.POINTER(ctypes.c_uint64)
    fs_p, fs_len = u64p(), 0
    if filterset is not None and len(filterset):
        filterset = np.ascontiguousarray(filterset, np.uint64)
        fs_p, fs_len = filterset.ctypes.data_as(u64p), len(filterset)
    buckets: dict = {}
    for c in codes_list:
        if len(c) < k:
            continue
        L = 256
        while L < len(c):
            L <<= 1
        buckets.setdefault(L, []).append(c)
    parts: List[np.ndarray] = []
    for L, recs in sorted(buckets.items()):
        rcap = max(1, (32 << 20) // L)
        for s in range(0, len(recs), rcap):
            grp = recs[s:s + rcap]
            rows = np.full((len(grp), L), K.INVALID, np.uint8)
            for r, c in enumerate(grp):
                rows[r, :len(c)] = c
            npos = L - k + 1
            out_hi = np.empty(len(grp) * npos, np.uint64)
            out_lo = np.empty(len(grp) * npos, np.uint64)
            cnt = lib.hash_rows_native128(
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                len(grp), L, k, hkw["w"], int(hkw["canon"]),
                int(hkw["seed_is_zero"]), hkw["xormask"],
                xormask2_hi & 0xFFFFFFFFFFFFFFFF, int(ds),
                hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
                DOWNSAMPLE_SALT, fs_p, fs_len,
                out_hi.ctypes.data_as(u64p),
                out_lo.ctypes.data_as(u64p))
            parts.append(U.from_words(out_hi[:cnt], out_lo[:cnt]))
    from .. import u128 as U2
    if not parts:
        return np.zeros(0, U2.U128)
    return np.concatenate(parts)


def _auto_device_engine() -> str:
    """Device OPH engine for 'auto' dispatch on an accelerator backend.

    'sort' for one-shot CLI processes (the cheapest to compile on the
    accelerator this was first tuned on); inside a RESIDENT worker
    (`serve`, DASHING2_TPU_RESIDENT — compiles amortize across jobs)
    the 'rot' engine, which ran faster per batch there. Neither choice
    is measured on the GPU yet."""
    if os.environ.get("DASHING2_TPU_RESIDENT") == "1":
        return "rot"
    return "sort"


def _exact128_keys(opts: Dashing2Options) -> bool:
    """True when exact-set keys are full 128-bit (--long-kmers with a
    DNA alphabet — the same gate as hkw['use128']); the .kmerset128
    cache/emit layout then holds little-endian u128 entries."""
    return bool(opts.use128 and opts.alphabet in (Alphabet.DNA,
                                                  Alphabet.DNAC))


def _counts_dest(keys_dest: str) -> str:
    """<keys path minus its suffix>.kmercounts.f64 — the reference's
    destkmercounts naming (fastxsketch.cpp:314-318)."""
    stem = keys_dest[:keys_dest.rfind(".")]
    return stem + ".kmercounts.f64"


def _write_kmer_set(arr: np.ndarray, path: str,
                    card: Optional[float] = None) -> None:
    """Exact-set cache write. Layout matches the reference cache
    artifact (fastxsketch.cpp:467-489 + cmp_main.cpp:107 'st_size - 8'):
    a leading f64 cardinality (when `card` is given — k-mer sets and
    countdict keys; minimizer-sequence caches are headerless like the
    reference's FULL_MMER_SEQUENCE write at :526-553), then u64 keys
    raw or u128 keys little-endian (lo, hi)."""
    from .. import u128 as U
    with open(path, "wb") as f:
        if card is not None:
            np.float64(card).tofile(f)
        if U.is_u128(arr):
            U.tofile_bytes(np.asarray(arr, U.U128)).tofile(f)
        else:
            np.ascontiguousarray(arr, np.uint64).tofile(f)


def _read_kmer_set(opts: Dashing2Options, path: str,
                   with_card: bool = False):
    """Inverse of _write_kmer_set. with_card=True skips and returns
    the leading f64 cardinality header."""
    from .. import u128 as U
    off = 8 if with_card else 0
    raw = np.fromfile(path, dtype=np.uint64, offset=off)
    card = (float(np.fromfile(path, np.float64, count=1)[0])
            if with_card else None)
    if _exact128_keys(opts):
        pairs = raw.reshape(-1, 2)
        keys = U.from_words(pairs[:, 1], pairs[:, 0])
    else:
        keys = raw
    return (card, keys) if with_card else keys


def _finalize_one_perm(opts: Dashing2Options, res: SketchingResult,
                       regs, counts, n: int, m: int) -> SketchingResult:
    """Shared ONE_PERM finalization: cardinalities, -log signatures (in
    row blocks into a RAM-or-memmap matrix so peak temp memory stays
    bounded for huge N, mm::vector semantics), id recovery, counts."""
    from ..io import mmvec
    res.cardinalities = SK.oph_cardinality(regs)
    sigs = mmvec.alloc((n, m), np.float64, opts.sig_ram_limit)
    for s in range(0, n, 4096):
        sigs[s:s + 4096] = SK.oph_to_sigs(regs[s:s + 4096])
    res.signatures = sigs
    if opts.save_kmers:
        ids64 = H.oph_hash_inverse(regs)
        ids64[regs == U64MAX] = 0
        res.kmers = ids64
    if opts.save_kmercounts:
        res.kmercounts = counts.astype(np.float32)
    return res


def _try_native_files(opts: Dashing2Options, groups: Sequence[str]
                      ) -> Optional[SketchingResult]:
    """The native FILE-DRIVER sketch path: read + encode + sketch whole
    path groups inside the C++ engine (oph_sketch_files), bypassing
    _load_items / chunk batching / per-record numpy copies entirely.

    The chunk-batched native route spends much of its sketch phase on
    Python-side ingest (per-record copies, batch stacking, ctypes
    plumbing); this driver removes all of it — the reference's P4
    native producer/consumer ingest (src/fqfeeder.cpp) fused with
    sketching. Results are bit-identical to the chunked
    engines: the OPH bucket-min is partition-order-free and chunked
    minimizer selection equals whole-record selection by construction
    (tests/test_native_oph.py asserts per config).

    DASHING2_TPU_NATIVE_FILES: '' auto (on whenever the native engine
    is selected), '0' off (chunk-batched native), '1'/'force' on even
    where the engine policy would pick a device route (tests drive the
    CPU-backend comparison this way). Returns None -> generic path."""
    env = os.environ.get("DASHING2_TPU_NATIVE_FILES", "")
    if env == "0":
        return None
    if opts.parse_by_seq or opts.by_chrom \
            or opts.sspace != SketchSpace.SPACE_SET \
            or opts.kmer_result != KmerSketchResultType.ONE_PERM \
            or opts.count_threshold > 1:
        return None
    paths: List[str] = []
    item_of: List[int] = []
    for i, g in enumerate(groups):
        for p in g.split():
            if p.endswith((".xz", ".bz2")):
                return None     # gz/plain only in the native reader
            paths.append(p)
            item_of.append(i)
    if not paths:
        return None
    hkw = _hash_kwargs(opts, 1 << 15)
    fs = _filterset_array(opts)
    use_fs = fs is not None
    if not _native_oph_supported(hkw, use_fs):
        return None
    if env not in ("1", "force"):
        engine = SK.oph_rows_engine()
        if engine != "native" and not (
                engine == "auto" and jax.default_backend() != "cpu"
                and jax.device_count() == 1):
            return None
    from .. import native as _nat
    try:
        lib = _nat.load_oph_lib()
    except Exception:
        lib = None
    if lib is None or not hasattr(lib, "oph_sketch_files"):
        return None
    import ctypes

    from ..io import mmvec
    from ..timing import span
    n, m = len(groups), opts.sketchsize
    want_counts = bool(opts.save_kmercounts)
    regs = mmvec.alloc((n, m), np.uint64, opts.sig_ram_limit,
                       fill=U64MAX)
    counts = mmvec.alloc((n, m), np.uint32, opts.sig_ram_limit, fill=0)
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    oph_xor = int(H.mt19937_64_first(H.OPH_DEFAULT_SEED)) ^ H.CEIXOR_OPH
    mode, base, bits, offsets, roll_table, canon = _native_mode(hkw)
    span_len = hkw.get("span") or hkw["k"]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    off_p, noff = i32p(), 0
    if offsets is not None:
        offsets = np.ascontiguousarray(offsets, np.int32)
        off_p, noff = offsets.ctypes.data_as(i32p), len(offsets)
    roll_p = u64p()
    if roll_table is not None:
        roll_table = np.ascontiguousarray(roll_table, np.uint64)
        roll_p = roll_table.ctypes.data_as(u64p)
    fs_p, fs_len = u64p(), 0
    if use_fs and len(fs):
        fs = np.ascontiguousarray(fs, np.uint64)
        fs_p, fs_len = fs.ctypes.data_as(u64p), len(fs)
    cpaths = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths])
    items32 = np.ascontiguousarray(item_of, np.int32)
    lut = K.alphabet_lut(opts.alphabet).tobytes()
    nthreads = int(os.environ.get("DASHING2_TPU_NATIVE_THREADS", 0)) \
        or (opts.nthreads if opts.nthreads > 0 else 0)
    with span("sketch/native-files"):
        rc = lib.oph_sketch_files(
            cpaths, items32.ctypes.data_as(i32p), len(paths), n, lut,
            hkw["k"], hkw["w"], int(canon), int(hkw["seed_is_zero"]),
            hkw["xormask"], oph_xor & 0xFFFFFFFFFFFFFFFF,
            int(ds), hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
            DOWNSAMPLE_SALT, m, nthreads,
            mode, base, bits, off_p, noff, roll_p, fs_p, fs_len,
            span_len,
            regs.ctypes.data_as(u64p),
            counts.ctypes.data_as(u32p) if want_counts else u32p())
    if rc < 0:
        raise OSError(f"failed to read {paths[-int(rc) - 1]}")
    res = SketchingResult(names=list(groups))
    return _finalize_one_perm(opts, res, regs, counts, n, m)


def _sketch_fastx_core(opts: Dashing2Options, groups: Sequence[str],
                       chunk_len: int = 0, rows_per_batch: int = 0
                       ) -> SketchingResult:
    res = _try_native_files(opts, groups)
    if res is not None:
        return res
    stream = (_should_stream(opts, groups)
              and opts.sspace != SketchSpace.SPACE_EDIT_DISTANCE)
    if stream:
        names = (_count_records(opts, groups) if opts.parse_by_seq
                 else list(groups))
        seqstore = None
        items = None

        def items_iter():
            return _iter_items_lazy(opts, groups)
        if chunk_len <= 0:
            # one fixed jit shape; the eager path sizes this from the
            # longest sequence, which streaming cannot know cheaply
            chunk_len = int(os.environ.get("DASHING2_TPU_CHUNK_LEN",
                                           1 << 15))
    else:
        items, seqstore = _load_items(opts, groups)
        names = [it.name for it in items]

        def items_iter():
            return items
        if chunk_len <= 0:
            chunk_len = _auto_chunk_len(items)
    if rows_per_batch <= 0:
        # size batches for ~8MB device pushes: the host->device hop has
        # a fixed per-call latency, so few big uploads beat many small
        # ones
        rows_per_batch = int(min(512, max(64, (8 << 20) // max(chunk_len,
                                                               1))))
    res = SketchingResult(names=list(names))
    n = len(names)
    m = opts.sketchsize
    kres = opts.kmer_result

    if opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE:
        # OrderMinHash signatures over raw sequences, batched by length
        # bucket (one vmapped dispatch per bucket — a by-seq corpus of
        # short reads previously paid one device call per sequence)
        from .omh import omh_sketch_many
        allcodes = [(np.concatenate(it.codes) if it.codes
                     else np.zeros(0, np.uint8)) for it in items]
        sigs = omh_sketch_many(allcodes, opts.k, m)
        res.signatures = sigs.view(np.float64)
        res.cardinalities = np.array(
            [sum(len(c) for c in it.codes) for it in items], np.float64)
        res.sequences = seqstore
        return res

    fs = _filterset_array(opts)
    use_fs = fs is not None
    fs_dev = jnp.asarray(fs if use_fs else np.zeros(1, np.uint64))
    hkw = _hash_kwargs(opts, chunk_len)

    needs_stream = (kres in (KmerSketchResultType.FULL_MMER_SET,
                             KmerSketchResultType.FULL_MMER_COUNTDICT,
                             KmerSketchResultType.FULL_MMER_SEQUENCE)
                    or kres == KmerSketchResultType.FULL_SETSKETCH
                    or opts.count_threshold > 1
                    or opts.sspace in (SketchSpace.SPACE_MULTISET,
                                       SketchSpace.SPACE_PSET))

    from ..io import mmvec
    from ..io.prefetch import prefetch
    if kres == KmerSketchResultType.ONE_PERM and not needs_stream:
        regs = mmvec.alloc((n, m), np.uint64, opts.sig_ram_limit,
                           fill=U64MAX)
        counts = mmvec.alloc((n, m), np.uint32, opts.sig_ram_limit, fill=0)
        want_counts = bool(opts.save_kmercounts)
        # engine policy: the OPH bucket-min is scatter-shaped, and on a
        # fresh process the device engines pay a one-time XLA compile,
        # while the native host engine sketches the same batch stream
        # bit-identically with ZERO compile and leaves the device free
        # for the comparison phase. 'auto' therefore resolves: native host
        # engine on a single-device accelerator backend when the config
        # is covered; rotation-'sort' for device dispatch (multi-chip
        # meshes shard batch rows); the work-efficient CPU segment path on the
        # CPU backend. Explicit DASHING2_TPU_OPH_ENGINE requests always
        # win (tests drive every engine this way).
        engine = SK.oph_rows_engine()
        native_lib = None
        if engine == "auto" and jax.default_backend() != "cpu" \
                and jax.device_count() == 1 \
                and _native_oph_supported(hkw, use_fs):
            engine = "native"
        if engine == "native" and _native_oph_supported(hkw, use_fs):
            from .. import native as _nat
            try:
                native_lib = _nat.load_oph_lib()
            except Exception:
                native_lib = None  # no toolchain: device dispatch below
        if engine == "auto" or (engine == "native" and native_lib is None):
            engine = (_auto_device_engine()
                      if jax.default_backend() != "cpu" else "")
        # an EXPLICIT engine request routes through the device-dispatch
        # path even on the CPU backend (tests drive the multichip
        # sharded dispatch this way; unset means backend default)
        dense_rows = (jax.default_backend() != "cpu"
                      or engine in ("dense", "dense2", "sort", "scatter"))
        if native_lib is not None:
            # heterogeneous placement: the scatter-shaped bucket-min
            # update runs on host cores (threads across batch rows)
            # while the device stays free for the comparison phase
            from ..timing import span
            for chunks, ids in _timed_iter(prefetch(_iter_chunk_batches(
                    opts, items_iter(), chunk_len, rows_per_batch)),
                    "sketch/ingest-stall"):
                with span("sketch/native-oph"):
                    r, c = _native_oph_rows(
                        native_lib, chunks, hkw, m,
                        H.OPH_DEFAULT_SEED, want_counts,
                        filterset=fs if use_fs else None)
                with span("sketch/merge"):
                    for row, item_id in enumerate(ids):
                        if item_id < 0:
                            continue
                        regs[item_id], counts[item_id] = _merge_oph(
                            regs[item_id], counts[item_id], r[row],
                            c[row])
        elif dense_rows:
            # dispatch every batch asynchronously, fetch results in
            # bounded groups: per-batch synchronous pulls pay the
            # device<->host round-trip latency per batch (dispatch itself
            # is fast and queues on device)
            fused = _fused_oph_fn(_hkw_key(hkw), m, H.OPH_DEFAULT_SEED,
                                  want_counts, use_fs,
                                  engine or "dense")
            # multichip: batch rows are independent, so they shard
            # across the mesh with zero collectives — device_put with a
            # row sharding and GSPMD partitions the whole fused step
            row_sh = None
            if (jax.device_count() > 1
                    and os.environ.get("DASHING2_TPU_MULTICHIP",
                                       "1") != "0"):
                from jax.sharding import NamedSharding, PartitionSpec
                from ..parallel.allpairs import make_mesh
                row_sh = NamedSharding(make_mesh(),
                                       PartitionSpec("rows", None))

            def put(x):
                if row_sh is not None and \
                        x.shape[0] % row_sh.mesh.devices.size == 0:
                    return jax.device_put(x, row_sh)
                return jnp.asarray(x)
            inflight: List[tuple] = []

            def drain():
                if not inflight:
                    return
                # one stacked device array -> ONE host transfer per
                # drain, grouped by batch shape (the tail batch pads to
                # a smaller power of two than the full batches, so a
                # window can hold two row counts)
                by_shape: dict = {}
                for p, bids in inflight:
                    by_shape.setdefault(p.shape, []).append((p, bids))
                zrow = np.zeros(m, np.uint32)
                for group in by_shape.values():
                    packed = np.asarray(jnp.stack([p for p, _ in group]))
                    for b, (_, bids) in enumerate(group):
                        r = packed[b, :, :m]
                        c = (packed[b, :, m:].astype(np.uint32)
                             if want_counts else None)
                        for row, item_id in enumerate(bids):
                            if item_id < 0:
                                continue
                            regs[item_id], counts[item_id] = _merge_oph(
                                regs[item_id], counts[item_id],
                                r[row], c[row] if c is not None else zrow)
                inflight.clear()

            # dispatch-ahead window: more overlap but each in-flight
            # batch pins its buffers — peak memory is O(window), not
            # O(corpus)
            window = int(os.environ.get("DASHING2_TPU_INFLIGHT", 64))
            # deep prefetch: the FIRST fused() call blocks in the XLA
            # compile and the default 2-deep queue stalls the ingest
            # thread behind it; 16
            # batches (~8 MB each) keep parse+encode+chunk running
            # through the compile so ingest is off the critical path
            pf_depth = int(os.environ.get("DASHING2_TPU_PREFETCH", 16))
            from ..timing import span
            for chunks, ids in _timed_iter(prefetch(_iter_chunk_batches(
                    opts, items_iter(), chunk_len, rows_per_batch),
                    depth=pf_depth), "sketch/ingest-stall"):
                with span("sketch/dispatch"):
                    inflight.append((fused(put(chunks), fs_dev), ids))
                if len(inflight) >= window:
                    with span("sketch/drain"):
                        drain()
            with span("sketch/drain"):
                drain()
        else:
            for chunks, ids in prefetch(_iter_chunk_batches(
                    opts, items_iter(), chunk_len, rows_per_batch)):
                hashed, valid = _hash_chunk_batch(
                    jnp.asarray(chunks), fs_dev, use_filterset=use_fs,
                    **hkw)
                nk = hashed.shape[1]
                flat_ids = jnp.repeat(jnp.asarray(np.maximum(ids, 0)), nk)
                flat_valid = valid.reshape(-1) & jnp.repeat(
                    jnp.asarray(ids >= 0), nk)
                r, c = SK.oph_sketch_segments(
                    hashed.reshape(-1), flat_valid, flat_ids,
                    nseqs=n, m=m, seed=H.OPH_DEFAULT_SEED)
                # write back IN PLACE: rebinding would silently replace
                # the sig_ram_limit memmap backing with in-RAM np.where
                # outputs after the first batch
                mr, mc = _merge_oph(regs, counts, np.asarray(r),
                                    np.asarray(c))
                regs[:] = mr
                counts[:] = mc
        return _finalize_one_perm(opts, res, regs, counts, n, m)

    # streaming paths. Batches arrive in item order, so an item is
    # complete the moment the stream advances past it: its raw hash
    # buffer is finalized (counted/compacted) and freed immediately.
    # Host RSS stays O(largest item + compact results), matching the
    # reference's per-file O(1)-buffer streaming (fastxsketch.cpp:302-424)
    # instead of holding every occurrence of every item to the end.
    if kres == KmerSketchResultType.FULL_MMER_SEQUENCE:
        # ordered minimizer streams: the representation itself is the
        # full stream (kept per item; homopolymer compression applied
        # at finalize). --long-kmers keeps FULL 128-bit tokens
        # (structured arrays, like the exact sets — the reference's
        # mmer_edit_distance_f<u128_t>, wcompare.cpp:85)
        from .. import u128 as U
        seq128 = (hkw["use128"] and not hkw["rolling"]
                  and not hkw["spacing_offsets"])
        acc: List[List[np.ndarray]] = [[] for _ in range(n)]
        for chunks, ids in prefetch(_iter_chunk_batches(
                opts, items_iter(), chunk_len, rows_per_batch)):
            if seq128:
                mhi, mlo, valid = _hash_chunk_batch128(
                    jnp.asarray(chunks), fs_dev,
                    k=hkw["k"], w=hkw["w"], canon=hkw["canon"],
                    xormask=hkw["xormask"],
                    xormask2_hi=opts.xormask2_hi,
                    seed_is_zero=hkw["seed_is_zero"],
                    downsample_threshold=hkw["downsample_threshold"],
                    use_filterset=use_fs, chunk_len=hkw["chunk_len"])
                mhi, mlo, valid = jax.device_get((mhi, mlo, valid))
                hashed = None
            else:
                hashed, valid = _hash_chunk_batch(
                    jnp.asarray(chunks), fs_dev, use_filterset=use_fs,
                    **hkw)
                hashed, valid = jax.device_get((hashed, valid))
            for row, item_id in enumerate(ids):
                if item_id < 0:
                    continue
                if seq128:
                    v = valid[row]
                    acc[item_id].append(
                        U.from_words(mhi[row][v], mlo[row][v]))
                else:
                    acc[item_id].append(hashed[row][valid[row]])
        seqs = []
        empty_dt = U.U128 if seq128 else np.uint64
        for parts in acc:
            hv = (np.concatenate(parts) if parts
                  else np.zeros(0, dtype=empty_dt))
            if opts.homopolymer_compress_minimizers and len(hv):
                keep = np.concatenate([[True], hv[1:] != hv[:-1]])
                hv = hv[keep]
            seqs.append(hv)
        res.mmer_sequences = seqs
        res.cardinalities = np.array([len(s) for s in seqs], dtype=np.float64)
        return res

    # distinct counting (exact sets / count dicts / count threshold / weighted)
    use_countsketch = (opts.cssize > 0
                       and opts.sspace in (SketchSpace.SPACE_MULTISET,
                                           SketchSpace.SPACE_PSET))
    # --long-kmers exact sets keep FULL 128-bit keys (structured
    # ('hi','lo') arrays, dashing2_tpu/u128.py) like the reference's
    # __uint128_t sorted sets (wcompare.cpp:28-51,111); register
    # sketches keep the documented low-word truncation
    exact128 = (hkw["use128"]
                and not hkw["rolling"] and not hkw["spacing_offsets"]
                and kres in (KmerSketchResultType.FULL_MMER_SET,
                             KmerSketchResultType.FULL_MMER_COUNTDICT))
    from .. import u128 as U

    def _count_one(hv):
        if use_countsketch:
            # CountSketch with fixed memory (enums.h:44-57, counter.h):
            # bucket[h % cssize] += (h & 1) ? 1 : -1; weights = |bucket|,
            # items = bucket indices (bedsketch.cpp:77-86 semantics).
            if U.is_u128(hv):
                # u128 keys: exact (hi*2^64+lo) % cssize buckets, sign
                # from the low bit (x & 1 on a u128 is lo & 1); bucket
                # indices keep the u128 representation so downstream
                # emit/compare see one key dtype per corpus
                buckets = np.zeros(opts.cssize, np.float64)
                idx = U.mod_u128(hv, opts.cssize).astype(np.int64)
                sign = np.where((hv["lo"] & np.uint64(1)).astype(bool),
                                1.0, -1.0)
                np.add.at(buckets, idx, sign)
                nz = np.nonzero(buckets)[0]
                u = U.from_words(np.zeros(len(nz), np.uint64),
                                 nz.astype(np.uint64))
                c = np.abs(buckets[nz])
            elif jax.default_backend() != "cpu" and len(hv) > 4096 \
                    and opts.cssize < (1 << 31):
                # device sort+cumsum engine (the host np.add.at is a
                # single-threaded O(stream) scatter)
                u, c = SK.countsketch_counts(hv, opts.cssize)
            else:
                buckets = np.zeros(opts.cssize, np.float64)
                idx = (hv % np.uint64(opts.cssize)).astype(np.int64)
                sign = np.where((hv & np.uint64(1)).astype(bool),
                                1.0, -1.0)
                np.add.at(buckets, idx, sign)
                nz = np.nonzero(buckets)[0]
                u = nz.astype(np.uint64)
                c = np.abs(buckets[nz])
        else:
            u, c = np.unique(hv, return_counts=True)
        if opts.count_threshold > 1:
            keep = c >= opts.count_threshold
            u, c = u[keep], c[keep]
        if not U.is_u128(u):
            u = u.astype(np.uint64)
        return u, c.astype(np.float64)

    # -p threads overlap per-item host counting with the device stream
    # (numpy releases the GIL in sort/unique; OMP analogue, SURVEY P1)
    pool = None
    if opts.nthreads > 1 and n > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=opts.nthreads)
    results: List = [None] * n
    pending: List[tuple] = []
    raws: List[np.ndarray] = []
    cur = -1

    def _finalize(i: int):
        hv = (np.concatenate(raws) if raws
              else np.zeros(0, U.U128 if exact128 else np.uint64))
        raws.clear()
        if pool is not None:
            pending.append((i, pool.submit(_count_one, hv)))
            # bound in-flight raw buffers
            while len(pending) > 2 * opts.nthreads:
                j, fut = pending.pop(0)
                results[j] = fut.result()
        else:
            results[i] = _count_one(hv)

    # native host hashing for the counting stream where supported: the
    # device path round-trips the FULL (R, npos) u64 hash matrix per
    # batch (~320 MB pulled for a 40 MB corpus). exact128 keeps
    # the device path (the native hasher emits the masked low word
    # only). DASHING2_TPU_NATIVE_HASH=0 pins the device route (tests).
    natlib = None
    if os.environ.get("DASHING2_TPU_NATIVE_HASH", "1") != "0" \
            and _native_oph_supported(hkw, use_fs):
        from .. import native as _nat
        try:
            natlib = _nat.load_oph_lib()
        except Exception:
            natlib = None
        if natlib is not None and not hasattr(
                natlib, "hash_rows_native128" if exact128
                else "hash_rows_native"):
            natlib = None
    if natlib is not None:
        for i, item in enumerate(items_iter()):
            if exact128:
                hv = _native_hash_codes_list128(
                    natlib, item.codes, hkw, opts.xormask2_hi,
                    filterset=fs if use_fs else None)
            else:
                hv = _native_hash_codes_list(
                    natlib, item.codes, hkw,
                    filterset=fs if use_fs else None)
            if pool is not None:
                pending.append((i, pool.submit(_count_one, hv)))
                while len(pending) > 2 * opts.nthreads:
                    j, fut = pending.pop(0)
                    results[j] = fut.result()
            else:
                results[i] = _count_one(hv)
        cur = -1   # nothing buffered; skip the device loop entirely
    else:
        cur = -2   # device loop runs below
    for chunks, ids in (() if cur == -1 else prefetch(
            _iter_chunk_batches(
                opts, items_iter(), chunk_len, rows_per_batch))):
        if exact128:
            mhi, mlo, valid = _hash_chunk_batch128(
                jnp.asarray(chunks), fs_dev,
                k=hkw["k"], w=hkw["w"], canon=hkw["canon"],
                xormask=hkw["xormask"], xormask2_hi=opts.xormask2_hi,
                seed_is_zero=hkw["seed_is_zero"],
                downsample_threshold=hkw["downsample_threshold"],
                use_filterset=use_fs, chunk_len=hkw["chunk_len"])
            mhi, mlo, valid = jax.device_get((mhi, mlo, valid))
            hashed = None
        else:
            hashed, valid = _hash_chunk_batch(
                jnp.asarray(chunks), fs_dev, use_filterset=use_fs,
                **hkw)
            hashed, valid = jax.device_get((hashed, valid))
        for row, item_id in enumerate(ids):
            if item_id < 0:
                continue
            if item_id != cur:
                if cur >= 0:
                    _finalize(cur)
                cur = item_id
            if exact128:
                v = valid[row]
                raws.append(U.from_words(mhi[row][v], mlo[row][v]))
            else:
                raws.append(hashed[row][valid[row]])
    if cur >= 0:
        _finalize(cur)
    for j, fut in pending:
        results[j] = fut.result()
    if pool is not None:
        pool.shutdown()
    empty = (np.zeros(0, U.U128 if exact128 else np.uint64),
             np.zeros(0, np.float64))
    uniq_list: List[np.ndarray] = [(r or empty)[0] for r in results]
    cnt_list: List[np.ndarray] = [(r or empty)[1] for r in results]

    if kres == KmerSketchResultType.FULL_MMER_SET:
        res.kmer_sets = uniq_list
        res.cardinalities = np.array([len(u) for u in uniq_list], np.float64)
        return res
    if kres == KmerSketchResultType.FULL_MMER_COUNTDICT:
        res.kmer_sets = uniq_list
        res.kmer_set_counts = cnt_list
        res.cardinalities = np.array([c.sum() for c in cnt_list], np.float64)
        return res

    if opts.sspace in (SketchSpace.SPACE_MULTISET, SketchSpace.SPACE_PSET):
        from .weighted import bagminhash_many, probminhash_many
        fn = bagminhash_many if opts.sspace == SketchSpace.SPACE_MULTISET \
            else probminhash_many
        sigs, cards = fn(uniq_list, cnt_list, m)
        res.signatures = sigs
        res.cardinalities = cards
        return res

    # FULL_SETSKETCH (or count-thresholded variants)
    sigs = mmvec.alloc((n, m), np.float64, opts.sig_ram_limit)
    cards = np.empty(n, dtype=np.float64)
    for i, u in enumerate(uniq_list):
        regs = SK.css_sketch(u, np.ones(len(u), bool), m) if len(u) else \
            np.full(m, np.inf)
        sigs[i] = np.where(np.isfinite(regs), regs, 0.0)
        cards[i] = SK.css_cardinality(regs) if len(u) else 0.0
    if opts.sketch_compressed_set:
        # --setsketch-ab / --fastcmp-{bytes,shorts,words,nibbles}: quantize
        # to the fixed (a, b) registers directly. Quantizing the exact
        # CSetSketch registers is identical to sketching into quantized
        # registers (CSetSketch::to_setsketch, setsketch.h:325-333).
        from ..cmp.core import _QLUT
        a_, b_ = opts.compressed_a, opts.compressed_b
        q = _QLUT[opts.fd_level]
        logbinv = 1.0 / np.log1p(b_ - 1.0)
        with np.errstate(divide="ignore"):
            kq = np.clip(np.floor(1.0 - np.log(np.maximum(sigs, 1e-300)
                                               / a_) * logbinv),
                         0, int(q) + 1)
        kq = np.where(sigs <= 0, 0, kq)
        dt = {0.5: np.uint8, 1.0: np.uint8, 2.0: np.uint16,
              4.0: np.uint32, 8.0: np.uint64}[opts.fd_level]
        res.signatures = kq.astype(dt)
        # harmonic-mean cardinality over quantized registers
        # (SetSketch::cardinality, setsketch.h:773-777)
        num = m * (1.0 - 1.0 / b_) * logbinv / a_
        res.cardinalities = num / np.power(b_, -kq).sum(axis=1)
        return res
    res.signatures = sigs
    res.cardinalities = cards
    return res


def _filterset_array(opts: Dashing2Options) -> Optional[np.ndarray]:
    """Build the sorted-hash exclusion set from --filterset
    (d2.cpp:45-98). The argument may carry a ':suffix': a suffix other
    than 'k'/'K' marks the file as a raw binary u64 k-mer-hash list
    (e.g. a --save-kmers artifact) loaded verbatim; otherwise it is a
    FASTA whose k-mers are hashed exactly like the data."""
    if not opts.filterset_path:
        return None
    arg = opts.filterset_path
    i = arg.rfind(":")
    if i != -1:
        path, suffix = arg[:i], arg[i + 1:]
        if suffix[:1].upper() != "K":
            from ..io.fastx import xopen
            with xopen(path) as f:
                raw = np.frombuffer(f.read(), dtype=np.uint64)
            return np.unique(raw)
        opts = dataclasses.replace(opts, filterset_path=path)
    sub = dataclasses.replace(opts, filterset_path="",
                              kmer_downsample_frac=1.0)
    hashes: List[np.ndarray] = []
    # chunk geometry must match _iter_chunk_batches: spaced seeds widen
    # the k-mer SPAN, and halos/ownership are span-based — using k here
    # would shift the column<->base alignment under --spacing
    fs_spacing = (K.parse_spacing(sub.spacing, sub.k)
                  if sub.spacing else None)
    fs_span = (fs_spacing[-1] + 1) if fs_spacing else sub.k
    for _, seq in fastx.read_fastx(opts.filterset_path):
        codes = K.encode_ascii(seq, opts.alphabet)
        chunks, _ = K.chunk_codes([codes], fs_span, chunk_len=1 << 15,
                                  w=sub.w if sub.w > fs_span else 0)
        h, v = _hash_chunk_batch(jnp.asarray(chunks),
                                 jnp.zeros(1, jnp.uint64),
                                 use_filterset=False,
                                 **_hash_kwargs(sub, 1 << 15))
        hashes.append(np.asarray(h)[np.asarray(v)])
    if not hashes:
        return None
    return np.unique(np.concatenate(hashes))
