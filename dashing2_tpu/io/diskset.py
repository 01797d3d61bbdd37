"""File-backed sorted k-mer sets for >RAM exact comparisons.

The reference streams exact set/count-dict comparisons from their cache
files when the corpus is not RAM-resident (cmp_core.cpp:518-572 opens
the per-item .kmerset64/.kmercountdict files; wcompare.cpp:145-187 is
the FILE* sorted-merge). This module is the analogue: a
DiskSortedSet reads bounded chunks with plain pread-style fromfile
calls — no mmap (so an RLIMIT-capped process stays capped) and no
whole-set materialization ever.

Sortedness contract: the framework's own cache writers emit sorted
unique hashes (ops/sketch_kernels.sort_count_unique), as does the
reference (fastxsketch.cpp:429-459). The chunked merge verifies
monotonicity as it streams and raises on violation rather than
returning wrong counts.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

DEFAULT_CHUNK = 1 << 20   # keys per read (8 MB of u64)


def stream_chunk_keys() -> int:
    v = os.environ.get("DASHING2_TPU_EXACT_CHUNK")
    return max(16, int(v)) if v else DEFAULT_CHUNK


class DiskSortedSet:
    """Sorted u64 key set (plus optional parallel f64 counts file)
    backed by files, exposing only bounded-chunk reads.

    len() and head slicing (``s[:k]``, used by the bottom-k LSH keys)
    work like an ndarray; anything needing the full array must go
    through the streaming comparators instead.
    """

    __slots__ = ("path", "offset", "n", "dtype", "counts_path",
                 "counts_offset", "counts_dtype")

    def __init__(self, path: str, offset: int = 0, n: Optional[int] = None,
                 dtype=np.uint64, counts_path: Optional[str] = None,
                 counts_offset: int = 0, counts_dtype=np.float64):
        self.path = path
        self.offset = int(offset)
        self.dtype = np.dtype(dtype)
        if n is None:
            n = (os.path.getsize(path) - self.offset) \
                // self.dtype.itemsize
        self.n = int(n)
        self.counts_path = counts_path
        self.counts_offset = int(counts_offset)
        self.counts_dtype = np.dtype(counts_dtype)

    def __len__(self) -> int:
        return self.n

    @property
    def weighted(self) -> bool:
        return self.counts_path is not None

    def read_keys(self, start: int, stop: int) -> np.ndarray:
        stop = min(stop, self.n)
        if stop <= start:
            return np.empty(0, self.dtype)
        with open(self.path, "rb") as f:
            f.seek(self.offset + start * self.dtype.itemsize)
            return np.fromfile(f, dtype=self.dtype, count=stop - start)

    def read_counts(self, start: int, stop: int) -> np.ndarray:
        stop = min(stop, self.n)
        if self.counts_path is None:
            return np.ones(max(stop - start, 0), np.float64)
        with open(self.counts_path, "rb") as f:
            f.seek(self.counts_offset + start * self.counts_dtype.itemsize)
            return np.fromfile(f, dtype=self.counts_dtype,
                               count=stop - start).astype(np.float64)

    def counts_sum(self, chunk: Optional[int] = None) -> float:
        """Streaming total multiplicity (the count-dict cardinality)."""
        if self.counts_path is None:
            return float(self.n)
        chunk = chunk or stream_chunk_keys()
        total = 0.0
        for s in range(0, self.n, chunk):
            total += float(self.read_counts(s, s + chunk).sum())
        return total

    def __getitem__(self, sl):
        """Head slices only (bottom-k LSH keys use ``s[:k]``)."""
        if isinstance(sl, slice) and (sl.start in (None, 0)) \
                and sl.step in (None, 1):
            stop = self.n if sl.stop is None else min(sl.stop, self.n)
            return self.read_keys(0, stop)
        raise TypeError("DiskSortedSet supports head slices only; use "
                        "the streaming comparators for full scans")


def as_stream(x):
    """Uniform chunk-read adapter over DiskSortedSet or in-RAM arrays."""
    if isinstance(x, DiskSortedSet):
        return x
    return _RamSet(np.asarray(x))


class _RamSet:
    __slots__ = ("keys", "counts")

    def __init__(self, keys: np.ndarray, counts: Optional[np.ndarray] = None):
        self.keys = keys
        self.counts = counts

    def __len__(self):
        return len(self.keys)

    @property
    def weighted(self):
        return self.counts is not None

    def read_keys(self, start, stop):
        return self.keys[start:stop]

    def read_counts(self, start, stop):
        if self.counts is None:
            return np.ones(max(min(stop, len(self.keys)) - start, 0),
                           np.float64)
        return np.asarray(self.counts[start:stop], np.float64)


def ram_set(keys, counts=None):
    return _RamSet(np.asarray(keys), counts)


def streaming_intersection(a, b, weighted: bool = False,
                           chunk: Optional[int] = None) -> float:
    """|A & B| (or sum of min counts over shared keys when weighted)
    for two sorted streams, touching at most 2 chunks of each at a time.
    This is the reference's FILE-based sorted merge
    (wcompare.cpp:145-187) in chunked vector form."""
    chunk = chunk or stream_chunk_keys()
    na, nb = len(a), len(b)
    if na == 0 or nb == 0:
        return 0.0
    isz = 0.0
    ai = bi = 0
    prev_a = prev_b = None
    while ai < na and bi < nb:
        ka = a.read_keys(ai, ai + chunk)
        kb = b.read_keys(bi, bi + chunk)
        if (len(ka) > 1 and (ka[1:] < ka[:-1]).any()) or \
                (prev_a is not None and len(ka) and ka[0] < prev_a):
            raise ValueError("exact-set stream is not sorted "
                             "(corrupt or non-canonical cache file)")
        if (len(kb) > 1 and (kb[1:] < kb[:-1]).any()) or \
                (prev_b is not None and len(kb) and kb[0] < prev_b):
            raise ValueError("exact-set stream is not sorted "
                             "(corrupt or non-canonical cache file)")
        hi = min(ka[-1], kb[-1])
        ca = int(np.searchsorted(ka, hi, side="right"))
        cb = int(np.searchsorted(kb, hi, side="right"))
        # cross-chunk monotonicity anchors: the last key BEFORE the next
        # chunk's start position
        if ca:
            prev_a = ka[ca - 1]
        if cb:
            prev_b = kb[cb - 1]
        aa, bb = ka[:ca], kb[:cb]
        if len(aa) and len(bb):
            idx = np.searchsorted(bb, aa)
            idxc = np.minimum(idx, len(bb) - 1)
            hit = bb[idxc] == aa
            if weighted:
                wa = a.read_counts(ai, ai + ca)
                wb = b.read_counts(bi, bi + cb)
                isz += float(np.minimum(wa[hit], wb[idxc[hit]]).sum())
            else:
                isz += float(hit.sum())
        # consume everything <= hi on both sides; the side whose chunk
        # ends at hi consumes it fully, so progress is guaranteed
        ai += ca
        bi += cb
    return isz
