"""Output-parsing facade mirroring the reference's reader utility
(/root/reference/python/parse.py) so downstream analysis scripts port by
swapping the import. Thin wrappers over dashing2_tpu.io.formats, with
result shapes/field names matching parse.py's.

    from dashing2_tpu import parse
    sigs = parse.parse_binary_signatures("sketches.bin")
    knn = parse.parse_knn("graph.csr")          # scipy CSR if available
    mat = parse.parse_binary_distmat("dists.bin")
"""

from __future__ import annotations

from collections import namedtuple
from typing import List

import numpy as np

from .enums import Alphabet
from .io import formats

ParsedSignatureMatrix = namedtuple(
    "ParsedSignatureMatrix", ["nseqs", "cardinalities", "signatures"])
ParsedKmerMatrix = namedtuple(
    "ParsedKmerMatrix", ["k", "w", "canon", "alphabet", "sketchsize",
                         "seed", "kmers"])


def parse_knn(path: str, idsize: int = 4, dstsize: int = 4):
    """KNN/threshold CSR graph (emitnn.cpp:5-47). Returns a scipy
    csr_matrix when scipy is importable, else (indptr, indices, data)."""
    indptr, indices, data = formats.read_knn_csr(path)
    try:
        import scipy.sparse as sp
        n = len(indptr) - 1
        return sp.csr_matrix((data, indices, indptr), shape=(n, n))
    except ImportError:
        return indptr, indices, data


def parse_binary_signatures(path: str) -> ParsedSignatureMatrix:
    """Stacked signature file (parse.py:61-74)."""
    cards, sigs = formats.read_stacked_signatures(path)
    return ParsedSignatureMatrix(len(cards), cards, sigs)


def parse_binary_sketch(path: str) -> dict:
    """Single --cache sketch file (parse.py:78-82)."""
    card, regs = formats.read_sketch_cache(path)
    return {"cardinality": card, "signatures": regs}


def convert_sketches_to_packed_sketch(paths, destination_path: str
                                      ) -> ParsedSignatureMatrix:
    """Stack per-input cache sketches into one signature file
    (parse.py:85-99)."""
    cards, rows = [], []
    for p in paths:
        card, regs = formats.read_sketch_cache(p)
        cards.append(card)
        rows.append(np.asarray(regs))
    cards = np.asarray(cards, dtype=np.float64)
    sigs = np.vstack(rows)
    formats.write_stacked_signatures(destination_path, cards, sigs,
                                     names=list(paths))
    return ParsedSignatureMatrix(len(cards), cards, sigs)


def parse_binary_kmers(path: str) -> ParsedKmerMatrix:
    """--save-kmers .kmer64 database (parse.py:102-115)."""
    db = formats.read_kmer_db(path)
    return ParsedKmerMatrix(db.k, db.w, db.canon, db.alphabet,
                            db.sketchsize, db.seed, db.kmers)


_ALPHA_BY_NAME = {
    "DNA": Alphabet.DNA, "BYTES": Alphabet.PROTEIN,
    "PROTEIN": Alphabet.PROTEIN20, "PROTEIN_3BIT": Alphabet.PROTEIN_3BIT,
    "PROTEIN_14": Alphabet.PROTEIN_14, "PROTEIN_6": Alphabet.PROTEIN_6,
    "DNA2": Alphabet.DNA2, "DNAC": Alphabet.DNAC,
}


def alphabetcvt(x):
    """Name <-> code conversion (parse.py:118-124)."""
    if isinstance(x, str):
        return _ALPHA_BY_NAME[x.upper()]
    return Alphabet(x)


def pairwise_equality_compare(input_matrix: np.ndarray,
                              nthreads: int = 1) -> np.ndarray:
    """Pairwise register-equality counts over a signature matrix
    (reference python/parse.py:128-157, which loops rows in numpy or
    calls sketch.pcmp). Returns the condensed nrec-choose-2 vector of
    per-pair equal-register counts, row-major upper triangle — the
    layout scipy.spatial.distance.squareform expands.

    Rows flow through the tiled device count_eq_self engine
    (ops/cmp_kernels) instead of a per-row python loop; `nthreads` is
    accepted for signature compatibility (device kernels ignore it)."""
    assert isinstance(input_matrix, np.ndarray), "expected a numpy array"
    assert input_matrix.ndim == 2, "expected a 2d array"
    nr, nc = input_matrix.shape
    dt = (np.uint8 if nc <= 0xFF else
          np.uint16 if nc <= 0xFFFF else np.uint32)
    if nr < 2:
        return np.zeros(0, dtype=dt)
    x = np.ascontiguousarray(input_matrix)
    if x.dtype.kind in "fi":
        # bit-pattern equality == value equality for the signatures this
        # framework emits (non-negative, NaN-free); signed ints view
        # losslessly to the same-width unsigned
        x = x.view(np.dtype(f"u{x.dtype.itemsize}"))
    if x.dtype.kind != "u":
        # exotic dtypes: the reference's plain numpy row loop
        counts = np.empty(nr * (nr - 1) // 2, np.int64)
        idx = 0
        for i in range(nr - 1):
            lc = nr - i - 1
            counts[idx:idx + lc] = (x[i] == x[i + 1:]).sum(axis=1)
            idx += lc
        return counts.astype(dt)
    from .ops.cmp_kernels import count_eq_self
    eq = np.asarray(count_eq_self(x))
    return eq[np.triu_indices(nr, 1)].astype(dt)


def parse_binary_clustering(path: str, d64: bool = False) -> List[np.ndarray]:
    """Greedy-dedup clustering CSR (parse.py:159-170)."""
    return formats.read_clustering(path)


def parse_binary_distmat(path: str) -> np.ndarray:
    """Flat f32 distance block: condensed upper triangle for symmetric
    all-pairs, row-major square otherwise (parse.py:173-177)."""
    return np.memmap(path, np.float32)


def parse_binary_rectmat(path: str, nref: int | None = None,
                         nquery: int | None = None) -> np.ndarray:
    """Panel (query x reference) matrix. The reference signature takes the
    two input path-list files and counts lines (parse.py:180-188); pass
    counts directly, or one of them to infer the other."""
    flat = np.memmap(path, np.float32)
    if nref is None and nquery is None:
        raise ValueError("pass nref and/or nquery")
    if nref is None:
        nref = flat.size // nquery
    if nquery is None:
        nquery = flat.size // nref
    return flat.reshape(nref, nquery)


def parse_binary_contain(path: str) -> dict:
    """contain coverage/depth matrices (parse.py:191-196)."""
    return formats.read_contain(path)


def parse_minimizer_sequence_set(path: str) -> dict:
    """--seq minimizer streams (parse.py:200-210)."""
    return formats.read_mmer_sequences(path)


def condensed_to_square(flat: np.ndarray, n: int, diag: float = 0.0
                        ) -> np.ndarray:
    """Expand a condensed upper-triangle distance block to a full
    symmetric (n, n) matrix (helper; not in the reference's parse.py)."""
    out = np.full((n, n), diag, dtype=flat.dtype)
    iu = np.triu_indices(n, 1)
    out[iu] = flat
    out[(iu[1], iu[0])] = flat
    return out
