"""contain subcommand: mash-screen-like coverage of a k-mer database.

Reference: src/contain_main.cpp:133-301. Loads a stacked .kmer64 database
(--save-kmers output), hashes each query file's k-mers through the same
maskfn pipeline, and reports per (query, reference): coverage fraction
(#distinct db k-mers of the reference matched / sketchsize) and mean depth
(total matched occurrences / #matched).

Device design: the db's k-mer -> reference mapping becomes a sorted flat
array + searchsorted lookups (gather), replacing the flat_hash_map
(contain_main.cpp:190-199); query hashing reuses the batched device
pipeline.
"""

from __future__ import annotations

import sys
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from .. import hashing as H
from ..config import Dashing2Options
from ..io import fastx, formats
from ..ops import kmers as K
from ..sketch.core import (_hash_chunk_batch, _hash_kwargs,
                           _native_hash_codes_list,
                           _native_oph_supported)


def contain_main(a) -> int:
    if not a.paths:
        print("contain requires a .kmer64 database and >= 1 query file",
              file=sys.stderr)
        return 1
    dbpath, queries = a.paths[0], list(a.paths[1:])
    if a.ffile:
        with open(a.ffile) as f:
            queries += [x.strip() for x in f if x.strip()]
    if not queries:
        print("contain requires >= 1 query file (positional or -F)",
              file=sys.stderr)
        return 1
    db = formats.read_kmer_db(dbpath)
    xormask, _ = H.seed_mask(db.seed) if db.seed else (H.XORMASK,
                                                       H.XORMASK2_HI)
    names: List[str] = [str(i) for i in range(db.kmers.shape[0])]
    try:
        names, _ = formats.read_names_file(dbpath + ".names.txt")
    except OSError:
        base = dbpath[:-len(".kmer64")] if dbpath.endswith(".kmer64") else dbpath
        try:
            names, _ = formats.read_names_file(base + ".names.txt")
        except OSError:
            pass
    nitems, sketchsize = db.kmers.shape
    flat = db.kmers.reshape(-1)
    owners = np.repeat(np.arange(nitems, dtype=np.int64), sketchsize)
    order = np.argsort(flat, kind="stable")
    sorted_kmers = flat[order]
    sorted_owners = owners[order]

    opts = Dashing2Options(k=db.k, w=db.w, alphabet=db.alphabet,
                           canonicalize=db.canon, seedseed=db.seed)
    opts.xormask = xormask
    hkw = _hash_kwargs(opts, 1 << 15)
    nq = len(queries)
    coverage = np.zeros((nq, nitems), np.float32)
    depth = np.zeros((nq, nitems), np.float32)

    # producer/consumer screening (round 5, the reference's threaded
    # FastxParser pipeline at contain_main.cpp:76-114): the NATIVE
    # reader encodes record batches in a prefetch thread while this
    # thread chunk-packs, hashes (device work on an accelerator
    # backend), and accumulates — bounded at ~32 MB of codes in flight
    # per side.
    from ..io.prefetch import prefetch

    def _code_batches():
        for qi, q in enumerate(queries):
            codes: List[np.ndarray] = []
            pending = 0
            for path in q.split():
                for _name, c in fastx.read_encoded(path, db.alphabet):
                    codes.append(c)
                    pending += len(c)
                    if pending >= (32 << 20):
                        yield qi, codes
                        codes, pending = [], 0
            yield qi, codes     # possibly empty: marks the query seen

    def _finalize(qi: int, hv_parts: List[np.ndarray]):
        if not hv_parts:
            return
        hv = np.concatenate(hv_parts)
        # distinct query k-mers + multiplicities that hit the db
        uniq, counts = np.unique(hv, return_counts=True)
        pos = np.searchsorted(sorted_kmers, uniq)
        pos = np.minimum(pos, len(sorted_kmers) - 1)
        hit = sorted_kmers[pos] == uniq
        uniq, counts, pos = uniq[hit], counts[hit], pos[hit]
        # expand each hit k-mer to all its owners (vectorized ragged
        # range expansion instead of a per-hit loop)
        hi = np.searchsorted(sorted_kmers, uniq, side="right")
        lens = hi - pos
        total = int(lens.sum())
        if total:
            starts = np.repeat(pos, lens)
            within = np.arange(total) - np.repeat(
                np.cumsum(lens) - lens, lens)
            owners_u = sorted_owners[starts + within]
            matches = np.bincount(owners_u, minlength=nitems)
            matchsums = np.bincount(
                owners_u, weights=np.repeat(counts, lens).astype(
                    np.float64), minlength=nitems)
        else:
            matches = np.zeros(nitems, np.int64)
            matchsums = np.zeros(nitems, np.float64)
        nz = matches > 0
        coverage[qi, nz] = matches[nz] / sketchsize
        depth[qi, nz] = matchsums[nz] / matches[nz]

    # host hashing via the native engine where supported: the device
    # route round-trips the FULL (R, npos) u64 hash matrix per flush;
    # the device path remains the fallback
    import os as _os
    natlib = None
    if _os.environ.get("DASHING2_TPU_CONTAIN_NATIVE", "1") != "0" \
            and _native_oph_supported(hkw, use_fs=False):
        from .. import native as _nat
        try:
            natlib = _nat.load_oph_lib()
        except Exception:
            natlib = None
        if natlib is not None and not hasattr(natlib,
                                              "hash_rows_native"):
            natlib = None

    cur = -1
    hv_parts: List[np.ndarray] = []
    for qi, codes in prefetch(_code_batches(), depth=2):
        if qi != cur:
            if cur >= 0:
                _finalize(cur, hv_parts)
            cur, hv_parts = qi, []
        if not codes:
            continue
        if natlib is not None:
            hv_parts.append(_native_hash_codes_list(natlib, codes, hkw))
            continue
        chunks, _ = K.chunk_codes(codes, db.k, chunk_len=1 << 15,
                                  w=db.w if db.w > db.k else 0)
        h, v = _hash_chunk_batch(jnp.asarray(chunks),
                                 jnp.zeros(1, jnp.uint64),
                                 use_filterset=False, **hkw)
        h, v = jax.device_get((h, v))
        hv_parts.append(h[v])
    if cur >= 0:
        _finalize(cur, hv_parts)
    # the reference's contain writes its matrix to -o (contain_main.cpp
    # "-o" handling); accept --cmpout as an alias
    outpath = a.cmpout or getattr(a, "outfile", None) or ""
    binary = a.binary_output
    if binary:
        if outpath and outpath not in ("-", "/dev/stdout"):
            formats.write_contain(outpath, coverage, depth)
        else:
            buf = sys.stdout.buffer
            buf.write(np.array([nitems, nq], np.uint64).tobytes())
            buf.write(coverage.astype(np.float32).tobytes())
            buf.write(depth.astype(np.float32).tobytes())
    else:
        f = (sys.stdout if not outpath or outpath in ("-", "/dev/stdout")
             else open(outpath, "w"))
        f.write("#Dashing2 contain - a list of coverage %s for the set of "
                "references, + mean coverage levels.\n"
                "#Each matrix entry consists of <coverage%:mean depth of "
                "coverage>\n##References:")
        for nm in names[:nitems]:
            f.write("\t" + nm)
        f.write("\n")
        for qi, q in enumerate(queries):
            f.write(q)
            for j in range(nitems):
                f.write("\t%0.6g%%:%g" % (100.0 * coverage[qi, j],
                                          depth[qi, j]))
            f.write("\n")
        if f is not sys.stdout:
            f.close()
    return 0
