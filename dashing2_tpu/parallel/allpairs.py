"""Device-resident all-pairs similarity pipelines, single- and multi-chip.

Single chip: the full gtlt-count + SetSketch-estimator pipeline as one
jittable function (registers as uint64 bit patterns — see
ops/cmp_kernels docstring for why this is exact).

Multi-chip (the reference has NO distributed backend — SURVEY §2.4 row
"Distributed": this is a new component): a 1-D mesh where

* sketch construction is data-parallel over sequence chunks; partial
  registers merge across devices with a min-collective (sketch merge is
  elementwise min, setsketch.h:432-448), and
* the N x N comparison matrix is computed as device-owned row blocks
  against the all-gathered register matrix (sketches are tiny: m * 8 bytes
  per genome, so the all-gather rides ICI cheaply and each chip does
  N/D x N of the N^2 work with zero further communication).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import hashing as H
from ..ops import hashes as DH


def _split(x):
    x = x.astype(jnp.uint64)
    return (x >> jnp.uint64(32)).astype(jnp.uint32), x.astype(jnp.uint32)


def _gtlt_block(a: jnp.ndarray, b: jnp.ndarray, tm: int = 16
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(gt, lt) int32 counts for register rows a (Na, m) vs b (Nb, m),
    scanning row tiles of a to bound the broadcast intermediate.

    u64 inputs compare exactly via (hi, lo) u32 limb pairs; float inputs
    compare directly (used by the multichip dryrun, whose signatures
    stay floats)."""
    na = a.shape[0]
    if jnp.issubdtype(a.dtype, jnp.floating):
        parts_a, parts_b = (a,), (b,)
    else:
        ah, al = _split(a)
        bh, bl = _split(b)
        parts_a, parts_b = (ah, al), (bh, bl)
    pad = (-na) % tm
    if pad:
        parts_a = tuple(
            jnp.concatenate([p, jnp.zeros((pad, p.shape[1]), p.dtype)])
            for p in parts_a)
    nt = parts_a[0].shape[0] // tm
    tiles = tuple(p.reshape(nt, tm, -1) for p in parts_a)

    def body(_, tile):
        # lt derives from trichotomy (lt = m - gt - eq; eq mask is
        # cheaper than the lt mask)
        if len(tile) == 1:
            # float branch: trichotomy holds only for totally ordered
            # values — a NaN register would count as lt (fails >, ==,
            # <), so compare lt directly instead
            (tv,), (bv,) = tile, parts_b
            gt = (tv[:, None, :] > bv[None, :, :]).sum(-1, dtype=jnp.int32)
            lt = (tv[:, None, :] < bv[None, :, :]).sum(-1, dtype=jnp.int32)
            return None, (gt, lt)
        else:
            (th, tl), (bh, bl) = tile, parts_b
            hi_eq = th[:, None, :] == bh[None, :, :]
            gt = ((th[:, None, :] > bh[None, :, :]) |
                  (hi_eq & (tl[:, None, :] > bl[None, :, :]))
                  ).sum(-1, dtype=jnp.int32)
            eq = (hi_eq & (tl[:, None, :] == bl[None, :, :])
                  ).sum(-1, dtype=jnp.int32)
        return None, (gt, jnp.int32(parts_b[0].shape[-1]) - gt - eq)

    _, (gts, lts) = jax.lax.scan(body, None, tiles)
    gt = gts.reshape(nt * tm, -1)[:na]
    lt = lts.reshape(nt * tm, -1)[:na]
    return gt, lt


def _similarity_epilogue(gt, lt, m: int, lh, rh):
    """Full-register SetSketch similarity (cmp_core.cpp:458-480) in f32."""
    invm = 1.0 / m
    alpha = gt.astype(jnp.float32) * invm
    beta = lt.astype(jnp.float32) * invm
    eq = 1.0 - alpha - beta
    return jnp.maximum(eq, 0.0)


@functools.partial(jax.jit, static_argnames=("m",))
def device_similarity(sigs_u64: jnp.ndarray, cards: jnp.ndarray, *, m: int
                      ) -> jnp.ndarray:
    """Single-chip all-pairs similarity matrix (f32, N x N) via the
    circulant self-pairs kernel (half-square work; lt == gt.T)."""
    from ..ops import cmp_kernels as CK
    n0 = sigs_u64.shape[0]
    t = max(8, min(128, 1 << max(n0 - 1, 1).bit_length()))
    a = CK._pad_rows(sigs_u64, t)
    seg_idx = jnp.asarray(CK._circ_seg_index(a.shape[0], t))
    gt = CK._circ_self_counts(a, seg_idx, t=t)[:n0, :n0]
    return _similarity_epilogue(gt, gt.T, m, cards[:, None], cards[None, :])


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("rows",))


def sharded_similarity(mesh: Mesh, sigs_u64: jnp.ndarray,
                       cards: jnp.ndarray) -> jnp.ndarray:
    """Row-sharded all-pairs: each device owns N/D rows, compares against
    the replicated full register matrix. Output sharded by rows."""
    m = sigs_u64.shape[1]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("rows", None), P(None, None), P("rows"), P(None)),
        out_specs=P("rows", None))
    def step(a_blk, b_all, lh_blk, rh_all):
        gt, lt = _gtlt_block(a_blk, b_all)
        return _similarity_epilogue(gt, lt, m, lh_blk[:, None],
                                    rh_all[None, :])

    return jax.jit(step)(sigs_u64, sigs_u64, cards, cards)


def pack_words_np(x: np.ndarray, mode: str) -> np.ndarray:
    """Host-side (numpy) analogue of cmp_kernels pack16/pack10/pack8/
    pack30: (n, m) bounded integer registers -> u32 SWAR words for the
    given engine mode (zero-padded tail fields). The *30 modes emit
    (n, 2*ceil(m/2)): hi-15-bit halves two-per-word first, then the
    lo-15-bit halves."""
    from ..ops import cmp_kernels as CK
    x = np.ascontiguousarray(x).astype(np.uint32)
    if mode in ("eq30", "gtlt30"):
        return np.concatenate(
            [pack_words_np(x >> np.uint32(15), "eq16"),
             pack_words_np(x & np.uint32(0x7FFF), "eq16")], axis=1)
    per = CK.FIELDS_PER_WORD[mode]
    pad = (-x.shape[1]) % per
    if pad:
        x = np.concatenate(
            [x, np.zeros((x.shape[0], pad), np.uint32)], axis=1)
    w = x.reshape(x.shape[0], -1, per)
    width = 32 // per if per != 3 else 10
    out = np.zeros(w.shape[:2], np.uint32)
    for i in range(per):
        out |= w[..., i] << np.uint32(width * (per - 1 - i))
    return out


def sharded_selfpairs(mesh: Mesh, regs: jnp.ndarray, t: int = 128,
                      packed16: bool = False,
                      eq_only: bool = False,
                      mode: str = None) -> jnp.ndarray:
    """Multi-chip symmetric all-pairs gt matrix via the circulant band
    decomposition: band d compares every block-row against block-rows
    rolled by d, and bands shard evenly across devices — each chip does
    1/D of the N(N-1)/2 unique-pair work with no duplication, then the
    band tiles all-gather (tiny vs the compare work) and every chip
    assembles the full matrix with one row-granular take.

    regs: (n, m) u64 registers (mode 'u64'), or (n, W) u32 SWAR-packed
    words (pack_words_np / cmp_kernels pack16/pack10/pack8) for any
    packed engine mode — which compare at 2-6x the u64 limb rate and
    shrink the replicated operand bytes each chip holds. The legacy
    packed16/eq_only flags map onto mode 'gtlt16'/'eq15'.

    Gt modes return the (n, n) int32 gt matrix; lt == gt.T. Eq modes
    compute ONE eq pass per band instead of the two gt/lt passes (~40%
    less compare work) and return the EQ matrix — valid for every
    estimator that consumes gt/lt only through the sum
    gt + lt = m - eq (all kinds except 'ab' with fd < 8; the raw count
    is in FIELDS incl. the packing pad, callers correct by
    per*W - m)."""
    from ..ops import cmp_kernels as CK

    if mode is None:
        mode = ("u64" if not packed16
                else ("eq15" if eq_only else "gtlt16"))
    packed = mode != "u64"
    n0 = regs.shape[0]
    D = mesh.devices.size
    t = max(8, min(t, 1 << max(n0 - 1, 1).bit_length()))
    a = np.asarray(regs, dtype=np.uint32 if packed else np.uint64)
    pad = (-a.shape[0]) % t
    if pad:
        a = np.concatenate([a, np.zeros((pad, a.shape[1]), a.dtype)])
    npad, m = a.shape
    nt = npad // t
    nd = nt // 2 + 1
    ndpad = -(-nd // D) * D
    bands = np.concatenate([np.arange(nd, dtype=np.int32),
                            np.zeros(ndpad - nd, np.int32)])  # dup band 0
    seg_idx = jnp.asarray(CK._circ_seg_index(npad, t))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, None), P("rows")),
        out_specs=(P("rows"), P("rows")))
    def band_shard(av, my_bands):
        if packed:
            a3 = av.reshape(nt, t, m)
            a6 = jnp.concatenate([a3, a3])

            def body(_, d):
                zero = jnp.int32(0)
                bb = jax.lax.dynamic_slice(a6, (d, zero, zero), (nt, t, m))
                aa = a3[:, :, None, :]
                b4 = bb[:, None, :, :]
                if mode in CK._EQ_TILES:
                    eq = CK._EQ_TILES[mode](aa, b4)
                    return None, (eq, eq)
                return None, CK.gtlt_pair_tiles(mode, aa, b4)

            _, (gts, lts) = jax.lax.scan(body, None, my_bands)
            return gts, lts
        ah, al = _split(av)
        a3h = ah.reshape(nt, t, m)
        a3l = al.reshape(nt, t, m)
        a6h = jnp.concatenate([a3h, a3h])
        a6l = jnp.concatenate([a3l, a3l])

        def body(_, d):
            zero = jnp.int32(0)
            bh = jax.lax.dynamic_slice(a6h, (d, zero, zero), (nt, t, m))
            bl = jax.lax.dynamic_slice(a6l, (d, zero, zero), (nt, t, m))
            hi_eq = a3h[:, :, None, :] == bh[:, None, :, :]
            gt = ((a3h[:, :, None, :] > bh[:, None, :, :]) |
                  (hi_eq & (a3l[:, :, None, :] > bl[:, None, :, :]))
                  ).sum(-1, dtype=jnp.int32)
            eq = (hi_eq & (a3l[:, :, None, :] == bl[:, None, :, :])
                  ).sum(-1, dtype=jnp.int32)
            return None, (gt, jnp.int32(m) - gt - eq)

        _, (gts, lts) = jax.lax.scan(body, None, my_bands)
        return gts, lts

    gts, lts = jax.jit(band_shard)(jnp.asarray(a), jnp.asarray(bands))
    # band tiles -> full matrix (duplicated padding bands are sliced off)
    gts = gts[:nd].reshape(-1, t, t)
    lts = lts[:nd].reshape(-1, t, t)

    @jax.jit
    def assemble(gts, lts, idx):
        src = jnp.concatenate([gts, jnp.swapaxes(lts, 1, 2)]).reshape(-1, t)
        return jnp.take(src, idx, axis=0).reshape(npad, npad)

    return assemble(gts, lts, seg_idx)[:n0, :n0]


def sharded_pipeline_step(mesh: Mesh, hashed: jnp.ndarray,
                          valid: jnp.ndarray, seq_ids: jnp.ndarray,
                          *, nseqs: int, m: int) -> jnp.ndarray:
    """Full sharded step: data-parallel OPH sketching over the k-mer
    stream (min-collective register merge over ICI) followed by
    row-sharded all-pairs comparison. This is the multi-chip "training
    step" analogue driven by __graft_entry__.dryrun_multichip.

    hashed/valid/seq_ids: flat k-mer stream, sharded along its length.
    Returns the (nseqs, nseqs) similarity matrix (row-sharded).
    """
    oph_seed = H.mt19937_64_first(H.OPH_DEFAULT_SEED)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("rows"), P("rows"), P("rows")),
        out_specs=P(None, None), check_vma=False)
    def sketch_shard(h, v, sid):
        ids = DH.wanghash(h ^ jnp.uint64(oph_seed ^ H.CEIXOR_OPH))
        idx = (ids % jnp.uint64(m)).astype(jnp.int32)
        seg = jnp.where(v, sid * m + idx, nseqs * m)
        regs = jax.ops.segment_min(ids, seg, num_segments=nseqs * m + 1)
        regs = regs[:nseqs * m].reshape(nseqs, m)
        # min-merge partial registers across devices: all-gather then
        # reduce locally (the gathered tensor is tiny: D x nseqs x m u64).
        gathered = jax.lax.all_gather(regs, axis_name="rows")
        return jnp.min(gathered, axis=0)

    regs = jax.jit(sketch_shard)(hashed, valid, seq_ids)

    # log-transform registers to signatures on device (oph_to_sigs math)
    maxv = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    empty = regs == maxv
    nempty = empty.sum(axis=1, keepdims=True)
    mul = -1.0 / jnp.maximum(m - nempty, 1).astype(jnp.float64)
    delta = (maxv - regs) + jnp.uint64(1)
    sigs = jnp.where(
        empty | (regs == 0), 0.0,
        mul * jnp.log(delta.astype(jnp.float64) * (2.0 ** -64)))
    cards = (m * m) / jnp.maximum(
        (regs.astype(jnp.float64) * 2.0 ** -64).sum(axis=1), 1e-300)
    # signatures stay f64 and compare directly
    return sharded_similarity(mesh, sigs, cards.astype(jnp.float32))
