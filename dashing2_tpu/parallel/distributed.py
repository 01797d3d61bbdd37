"""Multi-host distributed sketch + compare driver.

The reference is single-node shared-memory only — it has NO distributed
backend (SURVEY §2.4: no MPI/NCCL/Gloo anywhere in the tree), so this is
a new first-class component:

* one jax.distributed process per host, a 1-D global mesh over all devices;
* inputs are sharded across hosts by size-descending round-robin (the
  LPT schedule the reference uses across OpenMP threads,
  src/sketch_core.cpp:175-184, lifted to hosts);
* each host sketches its shard locally (any sketch kind), then the
  register matrix is all-gathered — sketch rows are tiny (m × 8 bytes per
  item), so the gather rides ICI/DCN cheaply;
* the N×N comparison runs as device-owned row blocks against the
  replicated register matrix (jax shard_map over the global mesh — XLA
  inserts the collectives), each host emitting its own row range;
* outputs are written per-host as FULL row-major f32 blocks
  (<out>.rows.<host>): concatenating them yields the complete row-major
  N x N (or N x nq) matrix. Note this is NOT the single-node `-o`
  binary artifact for symmetric jobs — that one stores the condensed
  upper triangle (io/formats.py) — it is the distributed layout, each
  pair appearing in both its rows.

Single-process use (tests, one machine) works unchanged: the mesh is
whatever `jax.devices()` offers, and `init_distributed` is a no-op
without coordinator settings.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize jax.distributed when multi-process coordinates are
    given (explicitly or via JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
    / JAX_PROCESS_ID). Returns (process_index, process_count)."""
    import jax
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address:
        num_processes = num_processes or int(
            os.environ.get("JAX_NUM_PROCESSES", "1"))
        process_id = process_id if process_id is not None else int(
            os.environ.get("JAX_PROCESS_ID", "0"))
        if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
            # multi-process CPU backend needs gloo collectives, and the
            # platform must be pinned before the first backend creation
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_index(), jax.process_count()


def shard_paths(paths: Sequence[str], process_index: int,
                process_count: int) -> Tuple[List[str], List[int]]:
    """LPT shard: order inputs by descending file size and deal them
    round-robin so hosts receive balanced byte totals (the reference's
    size-descending dynamic schedule, sketch_core.cpp:175-184, made
    deterministic for SPMD). Returns (my_paths, my_global_indices)."""

    def size_of(group: str) -> int:
        tot = 0
        for p in group.split():
            # fail LOUDLY: silently treating an unreadable input as size
            # 0 would let hosts with inconsistent filesystem views (NFS
            # lag, permissions) compute DIFFERENT shard assignments —
            # two hosts sketch the same row, another row stays all-zero
            tot += os.path.getsize(p)
        return tot

    order = sorted(range(len(paths)), key=lambda i: (-size_of(paths[i]), i))
    mine = [g for pos, g in enumerate(order)
            if pos % process_count == process_index]
    mine.sort()
    return [paths[i] for i in mine], mine


def allgather_sketches(local_sigs: np.ndarray, local_cards: np.ndarray,
                       local_indices: Sequence[int], n_total: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble the full (N, m) signature matrix from per-host shards.

    Multi-process: every host contributes its rows via
    jax.experimental.multihost_utils (process_allgather rides the
    ICI/DCN collectives). Single process: pure reindexing."""
    import jax

    m = local_sigs.shape[1]
    full_sigs = np.zeros((n_total, m), dtype=local_sigs.dtype)
    full_cards = np.zeros(n_total, dtype=np.float64)
    if jax.process_count() == 1:
        full_sigs[list(local_indices)] = local_sigs
        full_cards[list(local_indices)] = local_cards
        return full_sigs, full_cards
    from jax.experimental import multihost_utils
    # fixed-size per-host payload: (rows, cards, indices, count), padded
    max_rows = -(-n_total // jax.process_count()) + 1
    pad = max_rows - local_sigs.shape[0]
    sig_pad = np.concatenate(
        [local_sigs, np.zeros((pad, m), local_sigs.dtype)])
    card_pad = np.concatenate([local_cards, np.zeros(pad)])
    idx_pad = np.concatenate(
        [np.asarray(local_indices, np.int64), np.full(pad, -1, np.int64)])
    g_sigs = multihost_utils.process_allgather(sig_pad)
    g_cards = multihost_utils.process_allgather(card_pad)
    g_idx = multihost_utils.process_allgather(idx_pad)
    for h in range(jax.process_count()):
        live = g_idx[h] >= 0
        full_sigs[g_idx[h][live]] = np.asarray(g_sigs[h])[live]
        full_cards[g_idx[h][live]] = np.asarray(g_cards[h])[live]
    return full_sigs, full_cards


def my_row_range(n: int, process_index: int, process_count: int
                 ) -> Tuple[int, int]:
    """Contiguous row block owned by this host (row-major outputs
    concatenate across hosts)."""
    per = -(-n // process_count)
    lo = min(process_index * per, n)
    return lo, min(lo + per, n)


def gather_candidate_shards(ia: np.ndarray, ib: np.ndarray,
                            counts: np.ndarray) -> List[tuple]:
    """All-gather this host's candidate shard. Multi-process: padded
    fixed-width payload over process_allgather; single process: the
    local shard alone."""
    import jax
    if jax.process_count() == 1:
        return [(ia, ib, counts)]
    from jax.experimental import multihost_utils
    n = np.array([len(ia)], np.int64)
    nmax = int(np.asarray(multihost_utils.process_allgather(n)).max())
    pad = nmax - len(ia)

    def _p(x):
        return np.concatenate([x.astype(np.int64),
                               np.full(pad, -1, np.int64)])
    g = multihost_utils.process_allgather(
        np.stack([_p(ia), _p(ib), _p(counts)]))
    out = []
    for h in range(jax.process_count()):
        row = np.asarray(g[h])
        live = row[0] >= 0
        out.append((row[0][live], row[1][live], row[2][live]))
    return out


def distributed_neighbor_lists(opts, result, creps,
                               process_index: Optional[int] = None,
                               process_count: Optional[int] = None):
    """Multi-host KNN/threshold graph: the LSH index is built
    replicated (key hashing is one vectorized pass), candidate
    generation is partitioned by subtable COLUMN across hosts (the
    sort-joins are the expensive part), shards merge into the exact
    global candidate set (lsh.merge_candidate_shards), and every host
    refines + selects identically — all hosts produce the same output,
    equal to a single-host run with per-item bucket saturation disabled
    (column shards cannot see global per-item counts, so the merged set
    is the UNSATURATED candidate set; it differs from a saturated
    single-host run only when the sat cap binds, i.e. heavily clustered
    corpora, where it strictly adds candidates).

    process_index/count override jax.process_* for simulated-host
    tests."""
    import jax

    from ..cmp.graph import INFLATE_FACTOR, _index_source, _refine_lists
    from ..cmp.lsh import merge_candidate_shards
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    n = result.n
    ntoquery = (min(n - 1, int(opts.num_neighbors * INFLATE_FACTOR))
                if opts.num_neighbors > 0
                else (opts.maxcand if opts.maxcand > 0 else n - 1))
    idx = _index_source(opts, result, creps)
    if process_index is None:
        shards = gather_candidate_shards(*idx.candidate_pairs(
            max_per_item=ntoquery, column_shard=(pi, pc)))
    else:
        # simulated hosts: run every shard in this process
        shards = [idx.candidate_pairs(max_per_item=ntoquery,
                                      column_shard=(h, pc))
                  for h in range(pc)]
    ia, ib, _ = merge_candidate_shards(shards, n, ntoquery)
    return _refine_lists(opts, result, creps, ia, ib)


def distributed_dedup(opts, result, creps,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None):
    """Multi-host greedy dedup: the LSH self-join that feeds candidate
    generation — the expensive phase at scale — is partitioned by
    subtable COLUMN across hosts, shards merge into the exact global
    unsaturated candidate set (as in distributed_neighbor_lists), and
    every host then replays the same deterministic greedy walk over the
    merged set, so all hosts emit identical clusters. Like the KNN
    path, the merged candidates equal a single-host run with per-item
    bucket saturation disabled; outputs differ from a plain single-host
    run only when that cap binds.

    process_index/count override jax.process_* for simulated-host
    tests (every shard then runs in this process)."""
    import jax

    from ..cmp.graph import _index_source, dedup_core
    from ..cmp.lsh import default_candidates, merge_candidate_shards
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    n = result.n
    maxc = max(default_candidates(n, opts.maxcand) * 4, 64)
    idx = _index_source(opts, result, creps)
    if process_index is None:
        shards = gather_candidate_shards(*idx.candidate_pairs(
            max_per_item=maxc, column_shard=(pi, pc)))
    else:
        shards = [idx.candidate_pairs(max_per_item=maxc,
                                      column_shard=(h, pc))
                  for h in range(pc)]
    cand = merge_candidate_shards(shards, n, maxc)
    return dedup_core(opts, result, creps, cand_pairs=cand)


def distributed_sketch_cmp(opts, groups: Sequence[str],
                           outfile: Optional[str] = None) -> np.ndarray:
    """Full multi-host pipeline: shard inputs -> sketch locally ->
    all-gather sketches -> compute this host's row block of the measure
    matrix -> (optionally) write it as `<outfile>.rows.<lo>-<hi>`.

    Returns this host's (rows, N) f32 block. Concatenating the per-host
    files in row order yields the complete ROW-MAJOR matrix (see the
    module docstring: not the condensed single-node symmetric
    artifact)."""
    import jax

    from ..result import SketchingResult
    from ..sketch.core import sketch_fastx

    pi, pc = jax.process_index(), jax.process_count()
    my_groups, my_idx = shard_paths(groups, pi, pc)
    local = sketch_fastx(opts, my_groups)
    if local.signatures is None:
        raise ValueError("distributed path needs register sketches "
                         "(ONE_PERM / FULL_SETSKETCH)")
    n = len(groups)
    sigs, cards = allgather_sketches(local.signatures, local.cardinalities,
                                     my_idx, n)
    full = SketchingResult(names=list(groups))
    full.signatures = sigs
    full.cardinalities = cards
    lo, hi = my_row_range(n, pi, pc)
    # compute only this host's rows via the FUSED device engine (one
    # jitted counts+epilogue call), falling back to the blocked general
    # path for representations without a counts engine
    from ..cmp.core import (_block_matrix_fn, _measure_block, _prep,
                            _representation, _unpack_nibbles)
    from ..enums import KmerSketchResultType, Measure, SketchSpace
    creps, full = _prep(opts, full)
    rows = np.arange(lo, hi)
    cols = np.arange(n)
    counts_path = (opts.kmer_result < KmerSketchResultType.FULL_MMER_SET
                   and not (opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE
                            and (opts.exact_kmer_dist
                                 or opts.measure == Measure.M_EDIT_DISTANCE))
                   and full.signatures is not None)
    if not len(rows):
        block = np.zeros((0, n), np.float32)
    elif counts_path:
        kind, data = _representation(opts, full, creps)
        if kind.startswith("nibble"):
            data = _unpack_nibbles(np.asarray(data))
        data = np.ascontiguousarray(data)
        from ..cmp.core import (_block_matrix_swar_fn, _gb_args,
                                _kernel_mode, _swar_route)
        bf = max(creps.b, 1.0 + 1e-9)
        gbt, gbinv = _gb_args(bf, opts.sketchsize)
        lhc = np.asarray(cards[lo:hi], np.float64)
        rhc = np.asarray(cards, np.float64)
        if _swar_route(n, _kernel_mode()):
            # packed engine (shared _swar_pack policy): values/ranks
            # packed over ALL rows once, owned rows compare against the
            # packed matrix (2-6x the u64 limb rate, counts
            # bit-identical)
            fn = _block_matrix_swar_fn(kind, opts.sketchsize,
                                       opts.measure, opts.k,
                                       opts.fd_level, lo, hi)
            block = np.asarray(fn(data, lhc, rhc, np.float64(bf),
                                  gbt, gbinv))
        else:
            if data.dtype != np.uint64:
                data = data.astype(np.uint64)
            fn = _block_matrix_fn(kind, opts.sketchsize, opts.measure,
                                  opts.k, opts.fd_level)
            block = np.asarray(fn(data[lo:hi], data, lhc, rhc,
                                  np.float64(bf), gbt, gbinv))
    else:
        block = _measure_block(opts, full, creps, rows, cols)
    if outfile:
        block.astype(np.float32).tofile(f"{outfile}.rows.{lo}-{hi}")
    return block
