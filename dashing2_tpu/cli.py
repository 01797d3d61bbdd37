"""dashing2-compatible command-line interface.

Subcommands and flag surface mirror the reference
(/root/reference/src/options.h:63-171 SHARED_OPTS, src/d2.cpp:115-151,
src/sketch_main.cpp, src/cmp_main.cpp). Flags keep their reference names so
existing invocations port directly.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np

from .config import Dashing2DistOptions
from .enums import (Alphabet, DataType, KmerSketchResultType, Measure,
                    OutputFormat, OutputKind, SketchSpace)
from .io import formats
from .result import SketchingResult


def _add_shared(p: argparse.ArgumentParser) -> None:
    p.add_argument("paths", nargs="*", help="input files")
    p.add_argument("-F", "--ffile", help="read input paths from file")
    p.add_argument("-Q", "--qfile", help="query paths (panel mode)")
    p.add_argument("-p", "--threads", type=int, default=0)
    p.add_argument("-S", "--sketchsize", type=int, default=1024)
    p.add_argument("-L", "--sketch-size-l2", type=int, dest="ssl2")
    p.add_argument("--cmpout", "--distout", "--cmp-outfile", dest="cmpout")
    p.add_argument("--outprefix", "--prefix", dest="outprefix", default="")
    p.add_argument("-K", "--topk", "--top-k", dest="topk", type=int)
    p.add_argument("-T", "--similarity-threshold", dest="simthresh",
                   type=float)
    p.add_argument("--greedy", type=str)
    p.add_argument("--fastcmp", "--regsize", "--regbytes", dest="fastcmp",
                   type=float)
    p.add_argument("--fastcmp-nibbles", action="store_true",
                   help="same as --fastcmp 0.5 (listed but disabled in "
                        "the reference's option table, options.h:126,214)")
    p.add_argument("--fastcmp-bytes", action="store_true")
    p.add_argument("--fastcmp-shorts", action="store_true")
    p.add_argument("--fastcmp-words", action="store_true")
    p.add_argument("--bbit-sigs", action="store_true")
    p.add_argument("-c", "--countsketch-size", "--countmin-size",
                   dest="cssize", type=int, default=0)
    p.add_argument("-k", "--kmer-length", dest="k", type=int, default=31)
    p.add_argument("-w", "--window-size", dest="w", type=int, default=-1)
    p.add_argument("-o", "--outfile")
    p.add_argument("-m", "--count-threshold", "--threshold",
                   dest="count_threshold", type=float, default=0)
    p.add_argument("--binary-output", "--emit-binary", "--binary",
                   dest="binary_output", action="store_true")
    p.add_argument("-P", "--prob", "--probs", "--pminhash", "--pmh",
                   "--probminhash", dest="prob", action="store_true")
    p.add_argument("-B", "--multiset", "--bagminhash", "--bmh",
                   dest="multiset", action="store_true")
    p.add_argument("--bed", action="store_true")
    p.add_argument("--bigwig", action="store_true")
    p.add_argument("--leafcutter", action="store_true")
    p.add_argument("-E", "--edit-distance", dest="edit_distance",
                   action="store_true")
    p.add_argument("--intersection", "--intersection-size", dest="isz",
                   action="store_true")
    p.add_argument("--union-size", dest="usz", action="store_true")
    p.add_argument("--mash-distance", "--distance", "--poisson-distance",
                   dest="mashdist", action="store_true")
    p.add_argument("--compute-edit-distance", dest="compute_edit",
                   action="store_true")
    p.add_argument("--symmetric-containment", dest="symcontain",
                   action="store_true")
    p.add_argument("--containment", action="store_true")
    p.add_argument("-H", "--set", dest="mmer_set", action="store_true")
    p.add_argument("-J", "--countdict", action="store_true")
    p.add_argument("-G", "--seq", dest="mmer_seq", action="store_true")
    p.add_argument("-2", "--128bit", "--long-kmers", dest="use128",
                   action="store_true")
    # registering "-2" flips argparse's negative-number heuristic so
    # EVERY "-<digit>" token parses as an option and flags reject
    # negative values ("-w -1", "--maxcand -1"). Reset the internal
    # marker: "-2" still resolves (exact option-string match precedes
    # the heuristic), while other negative numbers parse as values.
    p._has_negative_number_optionals[:] = []
    p.add_argument("--phylip", action="store_true")
    p.add_argument("--asymmetric-all-pairs", "--asymmetric", "--square",
                   dest="asym", action="store_true")
    p.add_argument("-s", "--save-kmers", dest="save_kmers",
                   action="store_true")
    p.add_argument("-N", "--save-kmercounts", dest="save_kmercounts",
                   action="store_true")
    p.add_argument("--hp-compress", dest="hpcompress", action="store_true")
    p.add_argument("--refine-exact", dest="refine_exact",
                   action="store_true")
    p.add_argument("-Z", "--oneperm-setsketch", "--oneperm", "--one-perm",
                   "--oph", "--doph", dest="oneperm", action="store_true")
    p.add_argument("--full", "--full-setsketch", dest="full",
                   action="store_true")
    p.add_argument("--normalize-intervals", dest="normalize_intervals",
                   action="store_true")
    p.add_argument("--protein", "--protein20", "--enable-protein",
                   dest="protein", action="store_true")
    p.add_argument("--protein6", action="store_true")
    p.add_argument("--protein8", action="store_true")
    p.add_argument("--protein14", action="store_true")
    p.add_argument("--downsample", type=float, default=1.0)
    p.add_argument("-W", "--cache", "--cache-sketches", dest="cache",
                   action="store_true")
    p.add_argument("-C", "--no-canon", dest="nocanon", action="store_true")
    p.add_argument("--exact-kmer-dist", dest="exact_kmer_dist",
                   action="store_true")
    p.add_argument("--spacing", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--filterset", default="")
    p.add_argument("--parse-by-seq", dest="parse_by_seq",
                   action="store_true")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=0)
    p.add_argument("--nlsh", "--nLSH", dest="nlsh", type=int, default=2)
    p.add_argument("--entmin", action="store_true")
    p.add_argument("--by-chrom", dest="by_chrom", action="store_true")
    p.add_argument("--sig-ram-limit", dest="sig_ram_limit", type=int)
    p.add_argument("--maxcand", type=int, default=-1)
    p.add_argument("--index-save", default="", metavar="PATH",
                   help="write the KNN/dedup LSH index after building "
                        "it; a .ssi suffix selects the reference's gz "
                        "layout (sketch::lsh::SetSketchIndex::write, "
                        "ssi.h:454-484), anything else the native "
                        "format")
    p.add_argument("--index-load", default="", metavar="PATH",
                   help="load a previously saved LSH index instead of "
                        "building one (.ssi = reference layout)")
    p.add_argument("--setsketch-ab", dest="setsketch_ab")
    p.add_argument("--pairlist")
    p.add_argument("--seqs-in-ram", dest="seqs_in_ram", action="store_true")
    p.add_argument("--f32-registers", dest="regt32", action="store_true",
                   help="compare full registers in f32 (the reference's "
                        "-DSKETCH_FLOAT_TYPE=float build, as a runtime "
                        "switch; ~1.4x faster full-register comparisons)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--warm-only", type=int, default=0, metavar="N",
                   help="compile the compare programs for an announced "
                        "item count N under these flags, then exit (no "
                        "inputs needed). Through a resident worker "
                        "(DASHING2_TPU_DAEMON / `serve --warm`) this "
                        "pre-pays the XLA compile wall so the real job "
                        "runs at the warm rate")


def _build_opts(a: argparse.Namespace, presketched: bool = False
                ) -> Dashing2DistOptions:
    sketchsize = ((1 << a.ssl2) if a.ssl2 is not None
                  else a.sketchsize)
    sspace = SketchSpace.SPACE_SET
    kres = KmerSketchResultType.ONE_PERM
    if a.multiset:
        sspace = SketchSpace.SPACE_MULTISET
        kres = KmerSketchResultType.FULL_SETSKETCH
    if a.prob:
        sspace = SketchSpace.SPACE_PSET
        kres = KmerSketchResultType.FULL_SETSKETCH
    if a.edit_distance:
        sspace = SketchSpace.SPACE_EDIT_DISTANCE
    if a.full:
        kres = KmerSketchResultType.FULL_SETSKETCH
        if not (a.multiset or a.prob):
            sspace = SketchSpace.SPACE_SET
    if a.oneperm:
        kres = KmerSketchResultType.ONE_PERM
    if a.mmer_set:
        kres = KmerSketchResultType.FULL_MMER_SET
    if a.countdict:
        kres = KmerSketchResultType.FULL_MMER_COUNTDICT
    if a.mmer_seq:
        kres = KmerSketchResultType.FULL_MMER_SEQUENCE

    dtype = DataType.FASTX
    if a.bed:
        dtype = DataType.BED
    elif a.bigwig:
        dtype = DataType.BIGWIG
    elif a.leafcutter:
        dtype = DataType.LEAFCUTTER

    alphabet = Alphabet.DNA
    if a.protein:
        alphabet = Alphabet.PROTEIN20
    elif a.protein6:
        alphabet = Alphabet.PROTEIN_6
    elif a.protein8:
        alphabet = Alphabet.PROTEIN_3BIT
    elif a.protein14:
        alphabet = Alphabet.PROTEIN_14

    measure = Measure.SIMILARITY
    if a.isz:
        measure = Measure.INTERSECTION
    if a.usz:
        measure = Measure.UNION_SIZE
    if a.mashdist:
        measure = Measure.POISSON_LLR
    if a.symcontain:
        measure = Measure.SYMMETRIC_CONTAINMENT
    if a.containment:
        measure = Measure.CONTAINMENT
    if a.compute_edit:
        measure = Measure.M_EDIT_DISTANCE

    kind = OutputKind.SYMMETRIC_ALL_PAIRS
    if a.phylip:
        kind = OutputKind.PHYLIP
    if a.asym:
        kind = OutputKind.ASYMMETRIC_ALL_PAIRS
    if a.qfile:
        kind = OutputKind.PANEL
    num_neighbors = -1
    min_sim = -1.0
    exhaustive_dedup = fasta_dedup = False
    if a.topk is not None:
        kind = OutputKind.KNN_GRAPH
        num_neighbors = a.topk
    if a.simthresh is not None:
        kind = OutputKind.NN_GRAPH_THRESHOLD
        min_sim = a.simthresh
    if a.greedy is not None:
        kind = OutputKind.DEDUP
        g = a.greedy
        gv = ""
        for ch in g:
            if ch.lower() == "e":
                exhaustive_dedup = True
            elif ch.lower() == "f":
                fasta_dedup = True
            else:
                gv += ch
        min_sim = float(gv)

    fd = a.fastcmp if a.fastcmp is not None else 8.0
    ca = cb = -1.0
    if a.fastcmp_nibbles:
        fd = 0.5
    if a.fastcmp_bytes:
        ca, cb, fd = 20.0, 1.2, 1.0
    if a.fastcmp_shorts:
        ca, cb, fd = 0.06, 1.0005, 2.0
    if a.fastcmp_words:
        ca, cb, fd = 19.77, 1.0000000109723500835, 4.0
    if a.setsketch_ab:
        pa, pb = a.setsketch_ab.split(",")
        ca, cb = float(pa), float(pb)

    opts = Dashing2DistOptions(
        k=a.k, w=a.w, alphabet=alphabet, sspace=sspace, dtype=dtype,
        use128=a.use128, spacing=a.spacing, canonicalize=not a.nocanon,
        kmer_result=kres, parse_by_seq=a.parse_by_seq,
        sketchsize=sketchsize, count_threshold=a.count_threshold,
        cssize=a.cssize, save_kmers=a.save_kmers,
        save_kmercounts=a.save_kmercounts,
        homopolymer_compress_minimizers=a.hpcompress,
        cache_sketches=a.cache, outprefix=a.outprefix,
        kmer_downsample_frac=a.downsample, seedseed=a.seed,
        fd_level=fd, truncation_method=1 if a.bbit_sigs else 0,
        nthreads=a.threads, compressed_a=ca, compressed_b=cb,
        entmin=a.entmin, filterset_path=a.filterset,
        verbosity=a.verbose, bed_normalize=a.normalize_intervals,
        by_chrom=a.by_chrom, fasta_dedup=fasta_dedup,
        exhaustive_dedup=exhaustive_dedup,
        output_kind=kind,
        output_format=(OutputFormat.MACHINE_READABLE if a.binary_output
                       else OutputFormat.HUMAN_READABLE),
        num_neighbors=num_neighbors, min_similarity=min_sim,
        measure=measure, outfile_path=a.cmpout or "",
        exact_kmer_dist=a.exact_kmer_dist, refine_exact=a.refine_exact,
        cmp_batch_size=a.batch_size, nLSH=a.nlsh, maxcand=a.maxcand,
        index_save=a.index_save, index_load=a.index_load,
        sig_ram_limit=(a.sig_ram_limit if a.sig_ram_limit is not None
                       else 20 << 30),
        regt32=a.regt32, seqs_in_ram=a.seqs_in_ram,
    )
    return opts


def _collect_inputs(a: argparse.Namespace) -> tuple[List[str], int]:
    groups: List[str] = list(a.paths)
    if getattr(a, "pairlist", None):
        # The reference collects the unique paths named in the pairlist and
        # proceeds with the normal comparison flow (options.h:428-449;
        # sparse pair-restricted output is a TODO there too).
        if groups:
            raise SystemExit("Provide either a pairlist or paths, not both")
        seen = {}
        with open(a.pairlist) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    raise SystemExit(
                        "pairlist lines need two space-separated paths")
                for p in parts[:2]:
                    seen.setdefault(p, None)
        groups.extend(seen.keys())
    if a.ffile:
        with open(a.ffile) as f:
            # .strip(), not rstrip("\n"): CRLF list files would leave a
            # trailing "\r" in every path
            groups.extend(line.strip() for line in f if line.strip())
    nq = 0
    if a.qfile:
        with open(a.qfile) as f:
            qgroups = [line.strip() for line in f if line.strip()]
        groups.extend(qgroups)
        nq = len(qgroups)
    return groups, nq


def _do_sketch(opts: Dashing2DistOptions, groups: List[str], nq: int
               ) -> SketchingResult:
    from .sketch.core import sketch_fastx
    if opts.dtype == DataType.FASTX:
        result = sketch_fastx(opts, groups)
    else:
        from .sketch import intervals
        if opts.dtype == DataType.BED:
            result = intervals.sketch_bed(opts, groups)
        elif opts.dtype == DataType.BIGWIG:
            result = intervals.sketch_bigwig(opts, groups)
        else:
            result = intervals.sketch_leafcutter(opts, groups)
    result.nq = nq
    return result


def _write_outputs(opts: Dashing2DistOptions, a, result: SketchingResult
                   ) -> None:
    if a.outfile:
        if opts.kmer_result == KmerSketchResultType.FULL_MMER_SEQUENCE:
            formats.write_mmer_sequences(
                a.outfile, result.mmer_sequences, opts.k, opts.w,
                opts.alphabet, opts.canonicalize)
            formats.write_names_file(a.outfile + ".names.txt", result.names,
                                     result.cardinalities)
        elif result.signatures is not None:
            formats.write_stacked_signatures(
                a.outfile, result.cardinalities, result.signatures,
                result.names)
            if result.kmers is not None:
                formats.write_kmer_db(a.outfile + ".kmer64", result.kmers,
                                      opts.k, opts.w, opts.alphabet,
                                      opts.canonicalize, opts.seedseed)
            if result.kmercounts is not None:
                result.kmercounts.astype(np.float64).tofile(
                    a.outfile + ".kmercounts.f64")


def _do_cmp(opts: Dashing2DistOptions, result: SketchingResult) -> None:
    from .cmp.core import pairwise_matrix
    from .io.emitters import emit_rectangular
    if opts.output_kind in (OutputKind.KNN_GRAPH,
                            OutputKind.NN_GRAPH_THRESHOLD,
                            OutputKind.DEDUP):
        from .cmp.graph import neighbor_graph_main
        neighbor_graph_main(opts, result)
        return
    # symmetric/PHYLIP emitters never read the lower triangle: pull only
    # the upper trapezoids over the (slow) device->host hop
    upper = (opts.output_kind in (OutputKind.SYMMETRIC_ALL_PAIRS,
                                  OutputKind.PHYLIP)
             and result.nqueries() == 0)
    emit_rectangular(opts, result,
                     pairwise_matrix(opts, result, upper_only=upper))


def _load_presketched(opts: Dashing2DistOptions,
                      groups: List[str], nq_files: int = 0
                      ) -> SketchingResult:
    """Load pre-computed sketches: stacked signature files or per-input
    sketch-cache files, with suffix sniffing that also fixes the sketch
    space/result type (cmp_main.cpp:24-198,305-352). `nq_files` trailing
    paths are query files (PANEL): nq becomes the number of ITEMS they
    contain (a stacked file holds many)."""
    result = SketchingResult()
    cards_all, sig_rows = [], []
    kmer_sets, kmer_counts = [], []
    mmer_seqs = []
    items_per_path = []
    for path in groups:
        if path.endswith((".opss", ".ss", ".bmh", ".pmh")):
            if path.endswith(".bmh"):
                opts.sspace = SketchSpace.SPACE_MULTISET
            elif path.endswith(".pmh"):
                opts.sspace = SketchSpace.SPACE_PSET
            opts.kmer_result = (KmerSketchResultType.ONE_PERM
                                if path.endswith(".opss")
                                else KmerSketchResultType.FULL_SETSKETCH)
            card, regs = formats.read_sketch_cache(path)
            result.names.append(path)
            cards_all.append(np.array([card]))
            sig_rows.append(regs[None, :])
            items_per_path.append(1)
        elif path.endswith((".kmerset64", ".kmerset128")):
            # cache artifact: leading f64 cardinality then the sorted
            # keys (fastxsketch.cpp:467-489; load_results subtracts
            # the 8-byte header, cmp_main.cpp:107)
            opts.kmer_result = KmerSketchResultType.FULL_MMER_SET
            import os as _os
            stream = path.endswith(".kmerset64") and (
                _os.environ.get("DASHING2_TPU_EXACT_STREAM") == "1"
                or _os.path.getsize(path) > opts.sig_ram_limit)
            if stream:
                # >RAM exact corpus: file-backed sorted set, compared by
                # the chunked streaming merge (cmp_core.cpp:518-572)
                from .io.diskset import DiskSortedSet
                ds = DiskSortedSet(path, offset=8)
                result.names.append(path)
                kmer_sets.append(ds)
                cards_all.append(np.array([float(len(ds))]))
                items_per_path.append(1)
                continue
            card = float(np.fromfile(path, np.float64, count=1)[0])
            raw = np.fromfile(path, dtype=np.uint64, offset=8)
            if path.endswith(".kmerset128"):
                # u128 entries (little-endian lo, hi): FULL 128-bit
                # keys, compared by 2-limb lexicographic order exactly
                # like the reference's __uint128_t sorted merges
                # (wcompare.cpp:28-51,111; round-5 closes the former
                # low-word truncation deviation)
                from . import u128 as _U
                pairs = raw.reshape(-1, 2)
                kmers = _U.from_words(pairs[:, 1], pairs[:, 0])
                opts.use128 = True
            else:
                kmers = raw
            result.names.append(path)
            kmer_sets.append(np.sort(kmers))
            cards_all.append(np.array([card if card > 0
                                       else float(len(kmers))]))
            items_per_path.append(1)
        elif path.endswith((".mmerseq64", ".mmerseq128")):
            # per-item cache artifact: the raw ordered token stream; a
            # sibling <stem>kmercounts.f64 upgrades the load to a
            # COUNTDICT over the same keys (cmp_main.cpp:335-351).
            # .mmerseq128 tokens are little-endian u128 (full keys,
            # like the exact sets)
            import os as _os
            if path.endswith(".mmerseq128"):
                from . import u128 as _U
                tokens = _U.read_file(path)
                opts.use128 = True
            else:
                tokens = np.fromfile(path, dtype=np.uint64)
            countg = path[:path.rfind(".")] + "kmercounts.f64"
            if _os.path.isfile(countg):
                counts = np.fromfile(countg, dtype=np.float64)
                if len(counts) == len(tokens):
                    # dict keys must be unique+sorted for the posting
                    # joins; positional streams may repeat a token
                    u, inv = np.unique(tokens, return_inverse=True)
                    csum = np.zeros(len(u), np.float64)
                    np.add.at(csum, inv, counts)
                    opts.kmer_result = \
                        KmerSketchResultType.FULL_MMER_COUNTDICT
                    result.names.append(path)
                    kmer_sets.append(u)
                    kmer_counts.append(csum)
                    cards_all.append(np.array([float(csum.sum())]))
                    items_per_path.append(1)
                    continue
            opts.kmer_result = KmerSketchResultType.FULL_MMER_SEQUENCE
            result.names.append(path)
            mmer_seqs.append(tokens)
            cards_all.append(np.array([float(len(tokens))]))
            items_per_path.append(1)
        else:
            cards, sigs = formats.read_stacked_signatures(path)
            try:
                names, _ = formats.read_names_file(path + ".names.txt")
            except OSError:
                names = [f"{path}:{i}" for i in range(len(cards))]
            result.names.extend(names)
            cards_all.append(cards)
            sig_rows.append(sigs)
            items_per_path.append(len(cards))
    result.cardinalities = np.concatenate(cards_all)
    if sig_rows:
        result.signatures = np.vstack(sig_rows)
        if result.signatures.shape[1] != opts.sketchsize:
            opts.sketchsize = result.signatures.shape[1]
    if kmer_sets:
        result.kmer_sets = kmer_sets
        if kmer_counts and len(kmer_counts) == len(kmer_sets):
            result.kmer_set_counts = kmer_counts
        opts.exact_kmer_dist = True
    if mmer_seqs:
        result.mmer_sequences = mmer_seqs
        # the config coupling (__post_init__: kres >= FULL_MMER_SET =>
        # exact span distances) ran before the suffix sniff flipped
        # kmer_result — re-apply it so presketched streams compare
        # exactly like the fresh-sketch path
        opts.exact_kmer_dist = True
    if nq_files:
        result.nq = int(sum(items_per_path[-nq_files:]))
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: dispatch + clean error reporting (the reference's
    THROW_EXCEPTION prints the message and aborts, enums.h:59-63).
    Set DASHING2_TPU_DEBUG=1 or pass -v for full tracebacks."""
    import os
    if os.environ.get("DASHING2_TPU_DAEMON"):
        from .serve import maybe_dispatch_to_daemon
        rc = maybe_dispatch_to_daemon(
            list(sys.argv[1:] if argv is None else argv))
        if rc is not None:
            return rc
    try:
        return _main(argv)
    except (OSError, ValueError) as e:
        if os.environ.get("DASHING2_TPU_DEBUG") or "-v" in (argv or sys.argv):
            raise
        print(f"dashing2-tpu: error: {e}", file=sys.stderr)
        return 1


def _main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    top = argparse.ArgumentParser(prog="dashing2-tpu")
    sub = top.add_subparsers(dest="command", required=True)
    ps = sub.add_parser("sketch", help="sketch inputs (and optionally compare)")
    _add_shared(ps)
    pc = sub.add_parser("cmp", aliases=["dist"], help="compare inputs")
    _add_shared(pc)
    pc.add_argument("--presketched", action="store_true")
    pw = sub.add_parser("wsketch", help="sketch pre-aggregated weighted sets")
    pw.add_argument("wargs", nargs="*")
    pw.add_argument("-S", "--sketchsize", type=int, default=1024)
    pw.add_argument("-o", "--outfile", default="")
    pw.add_argument("-P", "--prob", action="store_true",
                    help="ProbMinHash (the default; kept for "
                         "compatibility with earlier versions)")
    pw.add_argument("-B", "--bagminhash", action="store_true",
                    help="BagMinHash instead of the default ProbMinHash "
                         "(reference -B)")
    pw.add_argument("-q", "--set", dest="setsketch", action="store_true",
                    help="set semantics: FullSetSketch over the ids, "
                         "weights ignored (reference -q)")
    pw.add_argument("--u32", action="store_true",
                    help="ids are 32-bit (reference -u)")
    pw.add_argument("--f32", action="store_true",
                    help="weights are 32-bit floats (reference -f)")
    pw.add_argument("--indptr32", action="store_true",
                    help="indptr is u32 (the reference's -P)")
    pcon = sub.add_parser("contain", help="screen queries against a k-mer db")
    _add_shared(pcon)
    ppm = sub.add_parser("printmin", help="print minimizer sequences")
    ppm.add_argument("minfile")
    psv = sub.add_parser(
        "serve", help="resident worker: keeps compiled XLA executables "
                      "alive across CLI jobs (see dashing2_tpu/serve.py)")
    psv.add_argument("--socket", required=True,
                     help="unix socket path to listen on")
    psv.add_argument("--max-requests", type=int, default=0,
                     help="exit after N jobs (0 = run until shutdown)")
    psv.add_argument("--warm", action="append", default=[], metavar="ARGV",
                     help="CLI invocation (quoted, shell-split) run once "
                          "at startup before accepting jobs, e.g. "
                          "--warm 'cmp --warm-only 10240' — precompiles "
                          "the expected program set so the first client "
                          "job runs at the warm rate; repeatable")
    psv.add_argument("-v", "--verbose", action="count", default=0)
    a = top.parse_args(argv)

    if a.command == "serve":
        from .serve import serve_main
        return serve_main(a.socket, a.max_requests, bool(a.verbose),
                          warm=a.warm)

    if a.command == "wsketch":
        from .sketch.wsketch import wsketch_main
        return wsketch_main(a)
    if a.command == "contain":
        from .cmp.contain import contain_main
        return contain_main(a)
    if a.command == "printmin":
        from .io.printmin import printmin_main
        return printmin_main(a.minfile)

    groups, nq = _collect_inputs(a)
    presketched = getattr(a, "presketched", False)
    opts = _build_opts(a, presketched)
    if opts.verbosity >= 1:
        # version banner + reconstructed command line (d2.cpp:134-136)
        from . import __version__
        print(f"#dashing2-tpu v{__version__}; invocation: dashing2-tpu "
              + " ".join(argv), file=sys.stderr)
    if a.command in ("cmp", "dist") and not opts.outfile_path:
        opts.outfile_path = "/dev/stdout"
    if getattr(a, "warm_only", 0):
        from .cmp.core import warm_pairwise_cache
        from .timing import phase as _ph
        with _ph("warm-only", opts.verbosity):
            ok = warm_pairwise_cache(opts, a.warm_only, nq)
        if opts.verbosity >= 1:
            print(f"#dashing2-tpu warm-only n={a.warm_only}: "
                  f"{'warmed' if ok else 'no fast-path program'}",
                  file=sys.stderr)
        return 0

    from .timing import phase
    import contextlib
    import os as _os
    profdir = _os.environ.get("DASHING2_TPU_PROFILE")
    prof = contextlib.nullcontext()
    if profdir:
        import jax
        prof = jax.profiler.trace(profdir)  # device trace for xprof
    with prof:
        return _run(a, top, opts, groups, nq, presketched, phase)


def _warm_compare_async(opts, n: int, nq: int):
    """Fire-and-forget compare-program compile overlapped with the
    sketch phase (cmp.core.warm_pairwise_cache). Only worth the dummy
    work where compiles are expensive (a real accelerator backend);
    DASHING2_TPU_WARM=1 forces it on CPU for tests, =0 disables."""
    import os as _os
    import threading
    mode = _os.environ.get("DASHING2_TPU_WARM", "")
    if mode == "0" or (mode != "1" and _backend_is_cpu()):
        return None
    if opts.output_kind not in (OutputKind.SYMMETRIC_ALL_PAIRS,
                                OutputKind.PHYLIP,
                                OutputKind.ASYMMETRIC_ALL_PAIRS,
                                OutputKind.PANEL):
        return None

    def work():
        try:
            from .cmp.core import warm_pairwise_cache
            warm_pairwise_cache(opts, n, nq)
        except Exception:
            pass  # warm-up is best-effort; production compiles lazily

    t = threading.Thread(target=work, daemon=True, name="d2-warm-cmp")
    t.start()
    return t


def _backend_is_cpu() -> bool:
    try:
        import jax
        return jax.default_backend() == "cpu"
    except Exception:
        return True


def _run(a, top, opts, groups, nq, presketched, phase) -> int:
    if presketched:
        with phase("load-presketched", opts.verbosity):
            result = _load_presketched(opts, groups, nq_files=nq)
    else:
        if not groups:
            top.error("no input files")
        # groups already includes query files; item count == len(groups)
        # only for whole-file FASTX items (by-seq / by-chrom counts are
        # unknown before parsing, so those jobs compile lazily)
        if (a.command in ("cmp", "dist") or opts.outfile_path) \
                and opts.dtype == DataType.FASTX \
                and not opts.parse_by_seq:
            _warm_compare_async(opts, len(groups), nq)
        with phase("sketch", opts.verbosity):
            result = _do_sketch(opts, groups, nq)
        with phase("write-sketches", opts.verbosity):
            _write_outputs(opts, a, result)

    if a.command in ("cmp", "dist") or opts.outfile_path:
        with phase("compare+emit", opts.verbosity):
            _do_cmp(opts, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
