"""Interval inputs: BED, BigWig, LeafCutter sketchers.

Reference: src/bedsketch.cpp (per-base items ``chrhash ^ position``,
weight 1 or 1/(stop-start) with --normalize-intervals), src/bwsketch.cpp
(per-base items weighted by coverage value), src/lfsketch.cpp (one sketch
per sample column; items are splice-site string hashes weighted by counts,
optionally normalized by denominators).

Device design: interval -> per-base item expansion is pure iota arithmetic
(SURVEY §2 bedsketch note) done in bounded slabs; sketching reuses the
same OPH/CSetSketch/weighted kernels as the FASTX path. The chromosome
string hash is FNV-1a finished with a Wang mix (the reference uses
XXH3_64bits / std::hash — only intra-run determinism matters, no on-disk
hash surface for these inputs).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .. import hashing as H
from ..config import Dashing2Options
from ..enums import KmerSketchResultType, SketchSpace
from ..io.fastx import xopen
from ..ops import sketch_kernels as SK
from ..result import SketchingResult

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def string_hash64(s: str) -> int:
    h = _FNV_OFFSET
    for b in s.encode():
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return int(H.wanghash(np.uint64(h)))


def _expand_interval_arrays(chrh: np.ndarray, starts: np.ndarray,
                            stops: np.ndarray, weights: np.ndarray,
                            slab: int = 1 << 22
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Array form of _expand_intervals: (chrhash u64, start i64,
    stop i64, weight f64) arrays -> slabs of (items u64, weights f64),
    item = chrhash ^ position per base."""
    lens = np.maximum(stops - starts, 0)
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    begins = ends - lens
    for lo in range(0, total, slab):
        hi = min(lo + slab, total)
        pos = np.arange(lo, hi, dtype=np.int64)
        iid = np.searchsorted(ends, pos, side="right")
        base = starts[iid] + (pos - begins[iid])
        items = chrh[iid] ^ base.astype(np.uint64)
        yield items, weights[iid]


def _expand_intervals(intervals: List[Tuple[int, int, int, float]],
                      slab: int = 1 << 22
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(chrhash, start, stop, weight) list -> slabs of
    (items u64, weights f64): item = chrhash ^ position per base."""
    if not intervals:
        return
    arr = np.array([(c, s, e, w) for (c, s, e, w) in intervals],
                   dtype=np.float64)
    chrh = np.array([c for (c, s, e, w) in intervals], dtype=np.uint64)
    yield from _expand_interval_arrays(
        chrh, arr[:, 1].astype(np.int64), arr[:, 2].astype(np.int64),
        arr[:, 3], slab)


def _aggregate_key(items: np.ndarray, ws: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort-aggregate (items, weights) -> (unique sorted items, sums)."""
    order = np.argsort(items, kind="stable")
    si, sw = items[order], np.asarray(ws, np.float64)[order]
    heads = np.concatenate([[True], si[1:] != si[:-1]])
    gid = np.cumsum(heads) - 1
    uniq = si[heads]
    wsum = np.zeros(len(uniq))
    np.add.at(wsum, gid, sw)
    return uniq, wsum


def _aggregate_stream(slabs: Iterator[Tuple[np.ndarray, np.ndarray]],
                      compact_at: int = 1 << 24
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-item weight sums over an (items, weights) slab stream
    (Counter semantics) at O(distinct items) memory: each slab is
    aggregated on arrival and the running parts compact whenever their
    total length exceeds `compact_at` — overlapping intervals no longer
    inflate peak memory by the coverage depth."""
    parts: List[Tuple[np.ndarray, np.ndarray]] = []
    held = 0
    for items, w in slabs:
        if not len(items):
            continue
        u, s = _aggregate_key(np.asarray(items, np.uint64), w)
        parts.append((u, s))
        held += len(u)
        if held > compact_at and len(parts) > 1:
            u, s = _aggregate_key(
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
            parts = [(u, s)]
            held = len(u)
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0)
    if len(parts) == 1:
        return parts[0]
    return _aggregate_key(np.concatenate([p[0] for p in parts]),
                          np.concatenate([p[1] for p in parts]))


def _sketch_item_stream(opts: Dashing2Options,
                        slabs: Iterator[Tuple[np.ndarray, np.ndarray]]
                        ) -> Tuple[np.ndarray, float]:
    """One (m,) signature row + cardinality from an (item, weight) stream."""
    m = opts.sketchsize
    ct = opts.count_threshold
    if opts.sspace == SketchSpace.SPACE_SET:
        if ct > 1:
            # per-item multiplicity threshold (FullSetSketch(ct, m),
            # bedsketch.cpp:11 / OPSetSketch::set_mincount,
            # bwsketch.cpp:81): an item needs >= ct base-updates before
            # it is admitted to the set — count OCCURRENCES, not weights
            uniq, cnt = _aggregate_stream(
                (items, np.ones(len(items))) for items, _w in slabs)
            uniq = uniq[cnt >= ct]
            slabs = iter([(uniq, np.ones(len(uniq)))])
        if opts.one_perm:
            # native streamed bucket-min when the toolchain is up
            # (bit-identical; the per-slab device segment engine
            # measured 97 s / 7 GB RSS at 7.6M intervals on the CPU
            # backend vs ~3 ns/item here), device segments otherwise
            from .. import hashing as H
            from ..native import load_oph_lib
            try:
                lib = load_oph_lib()
            except Exception:
                lib = None
            if lib is not None:
                import ctypes
                u64p = ctypes.POINTER(ctypes.c_uint64)
                oph_xor = (int(H.mt19937_64_first(H.OPH_DEFAULT_SEED))
                           ^ H.CEIXOR_OPH) & 0xFFFFFFFFFFFFFFFF
                regs1 = np.full(m, SK.U64MAX, np.uint64)
                for items, _w in slabs:
                    items = np.ascontiguousarray(items, np.uint64)
                    lib.oph_update_hashed(
                        items.ctypes.data_as(u64p), len(items),
                        oph_xor, m, regs1.ctypes.data_as(u64p),
                        ctypes.POINTER(ctypes.c_uint32)())
                regs = regs1[None, :]
            else:
                regs = np.full((1, m), SK.U64MAX, np.uint64)
                counts = np.zeros((1, m), np.uint32)
                from .core import _merge_oph
                for items, _w in slabs:
                    r, c = SK.oph_sketch_segments(
                        jnp.asarray(items), jnp.ones(len(items), bool),
                        jnp.zeros(len(items), jnp.int32), nseqs=1, m=m)
                    regs, counts = _merge_oph(regs, counts,
                                              np.asarray(r),
                                              np.asarray(c))
            card = float(SK.oph_cardinality(regs)[0])
            return SK.oph_to_sigs(regs)[0], card
        allitems = [i for i, _ in slabs]
        items = (np.concatenate(allitems) if allitems
                 else np.zeros(0, np.uint64))
        items = np.unique(items)
        regs = SK.css_sketch(items, np.ones(len(items), bool), m) \
            if len(items) else np.full(m, np.inf)
        card = float(SK.css_cardinality(regs)) if len(items) else 0.0
        return np.where(np.isfinite(regs), regs, 0.0), card
    # weighted spaces: aggregate exact counts first (Counter semantics)
    uniq, wsum = _aggregate_stream(slabs)
    if ct > 1:
        keep = wsum >= ct
        uniq, wsum = uniq[keep], wsum[keep]
    from .weighted import bagminhash, probminhash
    fn = bagminhash if opts.sspace == SketchSpace.SPACE_MULTISET \
        else probminhash
    sigs = fn(uniq, wsum, m)
    return sigs, float(wsum.sum())


def _parse_bed(path: str, opts: Dashing2Options
               ) -> List[Tuple[int, int, int, float]]:
    out = []
    with xopen(path) as f:
        for raw in f:
            line = raw.decode() if isinstance(raw, bytes) else raw
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError(f"Malformed BED line: {line!r}")
            chrom = parts[0]
            if opts.trim_chr and chrom.lower().startswith("chr"):
                chrom = chrom[3:]
            start, stop = int(parts[1]), int(parts[2])
            w = 1.0 / (stop - start) if (opts.bed_normalize
                                         and stop > start) else 1.0
            out.append((string_hash64(chrom), start, stop, w))
    return out


def sketch_bed(opts: Dashing2Options, groups: Sequence[str]
               ) -> SketchingResult:
    if opts.sspace > SketchSpace.SPACE_PSET:
        raise ValueError("Can't do edit distance for BED files")
    if opts.bed_normalize and opts.sspace == SketchSpace.SPACE_SET:
        raise ValueError("Can't normalize BED rows in set space; use "
                         "--multiset or --prob")
    res = SketchingResult(names=list(groups))
    m = opts.sketchsize
    n = len(groups)
    res.signatures = np.zeros((n, m), np.float64)
    res.cardinalities = np.zeros(n, np.float64)
    for i, group in enumerate(groups):
        intervals: List[Tuple[int, int, int, float]] = []
        for path in group.split():
            intervals.extend(_parse_bed(path, opts))
        sigs, card = _sketch_item_stream(opts, _expand_intervals(intervals))
        res.signatures[i] = sigs
        res.cardinalities[i] = card
    return res


def _bw_block_slabs(opts: Dashing2Options, readers,
                    chrom_ids=None) -> "Iterator[Tuple[np.ndarray, np.ndarray]]":
    """Stream (items, weights) slabs from BigWig readers, one data
    block at a time — memory stays O(block + slab), never
    O(intervals). chrom_ids: optional per-reader chrom-id filter sets
    (the by-chrom path). Zero-valued intervals only drop out of the
    WEIGHTED spaces; the reference's set-space path updates every base
    unconditionally (DO_FOR_UNWEIGHTED_SKETCH ignores the value,
    bwsketch.cpp:116-123)."""
    keep_zero = opts.sspace == SketchSpace.SPACE_SET
    for ri, r in enumerate(readers):
        want = None if chrom_ids is None else chrom_ids[ri]
        # per-chrom queries iterate R-tree leaves per id (libBigWig
        # overlap-query shape); whole-file iterates once in file order
        block_iter = (r.iter_blocks() if want is None else
                      (blk for cid in sorted(want)
                       for blk in r.iter_blocks(chrom_id=cid)))
        hash_cache: Dict[int, int] = {}
        for cid, starts, ends, vals in block_iter:
            chrom = r.chroms.get(cid)
            if chrom is None:
                continue
            ch = hash_cache.get(cid)
            if ch is None:
                cname = chrom[3:] if (opts.trim_chr
                                      and chrom.lower().startswith(
                                          "chr")) else chrom
                ch = int(string_hash64(cname))
                hash_cache[cid] = ch
            w = vals.astype(np.float64)
            if not keep_zero:
                nz = w != 0
                if not nz.all():
                    starts, ends, w = starts[nz], ends[nz], w[nz]
            if not len(starts):
                continue
            chrh = np.full(len(starts), ch, np.uint64)
            yield from _expand_interval_arrays(
                chrh, starts.astype(np.int64), ends.astype(np.int64), w)


def sketch_bigwig(opts: Dashing2Options, groups: Sequence[str]
                  ) -> SketchingResult:
    """BigWig coverage tracks: items chrhash^pos weighted by track value
    (bwsketch.cpp:112-119). With --by-chrom, one entry per chromosome is
    appended per file (sketch_core.cpp:65-94). Streaming + vectorized:
    blocks decode straight to numpy arrays and feed the sketcher one
    slab at a time — multi-GB tracks run under an O(block + slab)
    memory envelope."""
    from ..io.bigwig import BigWigReader
    names: List[str] = []
    rows: List[np.ndarray] = []
    cards: List[float] = []
    for group in groups:
        readers = [BigWigReader(p) for p in group.split()]
        try:
            if opts.by_chrom:
                # trimmed name -> (display name, per-reader chrom ids)
                per: Dict[str, Tuple[str, List[set]]] = {}
                for ri, r in enumerate(readers):
                    for cid, chrom in r.chroms.items():
                        cname = chrom[3:] if (
                            opts.trim_chr
                            and chrom.lower().startswith("chr")) \
                            else chrom
                        disp, sets = per.setdefault(
                            cname, (chrom, [set() for _ in readers]))
                        sets[ri].add(cid)
                for _key, (disp, sets) in sorted(per.items()):
                    sigs, card = _sketch_item_stream(
                        opts, _bw_block_slabs(opts, readers, sets))
                    names.append(f"{group}:{disp}")
                    rows.append(sigs)
                    cards.append(card)
            else:
                sigs, card = _sketch_item_stream(
                    opts, _bw_block_slabs(opts, readers))
                names.append(group)
                rows.append(sigs)
                cards.append(card)
        finally:
            for r in readers:
                r.close()
    res = SketchingResult(names=names)
    res.signatures = np.vstack(rows) if rows else np.zeros((0, opts.sketchsize))
    res.cardinalities = np.asarray(cards)
    return res


def sketch_leafcutter(opts: Dashing2Options, groups: Sequence[str]
                      ) -> SketchingResult:
    """LeafCutter perind counts: one sketch per sample column
    (lfsketch.cpp:41-125). Values "num/denom"; with
    --normalize-intervals the weight is num/denom, else num."""
    names: List[str] = []
    rows: List[np.ndarray] = []
    cards: List[float] = []
    m = opts.sketchsize
    for group in groups:
        for path in group.split():
            with xopen(path) as f:
                header = f.readline()
                if isinstance(header, bytes):
                    header = header.decode()
                sample_names = header.split()[1:] if header.split() else []
                nsamples = len(sample_names)
                per_sample: List[Dict[int, float]] = [dict() for _ in
                                                      range(nsamples)]
                for raw in f:
                    line = raw.decode() if isinstance(raw, bytes) else raw
                    parts = line.split()
                    if not parts:
                        continue
                    # splice site = everything before the THIRD colon
                    # (lfsketch.cpp:86-90): the 4th field is the
                    # per-run leafcutter cluster id, which must NOT
                    # participate or identical junctions from different
                    # runs hash apart
                    site = parts[0]
                    ncol = 0
                    for ci, chch in enumerate(site):
                        if chch == ":":
                            ncol += 1
                            if ncol == 3:
                                site = site[:ci]
                                break
                    if opts.trim_chr and site.lower().startswith("chr"):
                        site = site[3:]
                    sh = string_hash64(site)
                    for si, tok in enumerate(parts[1:nsamples + 1]):
                        if "/" in tok:
                            num_s, den_s = tok.split("/")
                            num = float(num_s)
                            den = float(den_s) if den_s else 1.0
                        else:
                            num, den = float(tok), 1.0
                        if num == 0:
                            continue
                        w = num / den if opts.bed_normalize else num
                        d = per_sample[si]
                        d[sh] = d.get(sh, 0.0) + w
            # file prefix for sample name disambiguation (lfsketch.cpp:25-33)
            pref = path
            for cut in ("_perind", ".count", "_"):
                pos = path.find(cut)
                if pos != -1:
                    pref = path[:pos]
                    break
            for si, sname in enumerate(sample_names):
                d = per_sample[si]
                items = np.fromiter(d.keys(), dtype=np.uint64, count=len(d))
                ws = np.fromiter(d.values(), dtype=np.float64, count=len(d))
                slabs = iter([(items, ws)]) if len(items) else iter([])
                sigs, card = _sketch_item_stream(opts, slabs)
                names.append(f"{sname}:{pref}")
                rows.append(sigs)
                cards.append(card)
    res = SketchingResult(names=names)
    res.signatures = np.vstack(rows) if rows else np.zeros((0, m))
    res.cardinalities = np.asarray(cards)
    return res
