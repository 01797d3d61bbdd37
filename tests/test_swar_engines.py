"""SWAR packed-engine exactness: kernels vs naive counts bit-for-bit,
and the _self_matrix_fn SWAR route vs the XLA route to f32-ulp
tolerance (counts identical; the f32 epilogues are separate XLA graphs
whose FMA contraction may differ in the last ulp).

The SWAR engines (ops/cmp_kernels pack16/pack8 + popcount tiles) are
the round-3 default-path acceleration; DASHING2_TPU_KERNEL=swar forces
the route on CPU so these tests exercise the exact production code."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import dashing2_tpu  # noqa: F401
from dashing2_tpu.cmp import core as C
from dashing2_tpu.enums import Measure
from dashing2_tpu.ops import cmp_kernels as CK


@pytest.mark.parametrize("m", [64, 63, 17])
def test_swar_kernels_exact(m):
    rng = np.random.default_rng(5)
    n = 150
    vals = rng.integers(0, 300, size=(n, m)).astype(np.uint64) \
        * np.uint64(0x9E3779B97F4A7C15)
    r = np.asarray(jax.jit(CK.dense_ranks)(jnp.asarray(vals)))
    assert r.max() < n
    pk = CK.pack16(jnp.asarray(r))
    ref_eq = (vals[:, None, :] == vals[None, :, :]).sum(-1)
    ref_gt = (vals[:, None, :] > vals[None, :, :]).sum(-1)
    eq = np.asarray(CK.count_eq_self_packed(pk, m, eight_bit=False, t=32))
    assert (eq == ref_eq).all()
    # bounded-halves (< 2^15) fast detect: identical counts on ranks
    eq15 = np.asarray(CK.count_eq_self_packed(pk, m, eight_bit=False,
                                              t=32, bounded15=True))
    assert (eq15 == ref_eq).all()
    gt, lt = CK.count_gtlt_self_packed16(pk, t=32)
    assert (np.asarray(gt) == ref_gt).all()
    assert (np.asarray(lt) == ref_gt.T).all()
    # rectangular
    eqr = np.asarray(CK.count_eq_packed(pk[:40], pk[40:], m,
                                        eight_bit=False))
    assert (eqr == ref_eq[:40, 40:]).all()
    gtr, ltr = CK.count_gtlt_packed16(pk[:40], pk[40:])
    assert (np.asarray(gtr) == ref_gt[:40, 40:]).all()
    ref_lt = (vals[:40][:, None, :] < vals[40:][None, :, :]).sum(-1)
    assert (np.asarray(ltr) == ref_lt).all()


def test_swar_8bit_and_16bit_fullrange_eq():
    rng = np.random.default_rng(6)
    n, m = 100, 96
    v8 = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    eq8 = np.asarray(CK.count_eq_self_packed(
        CK.pack8(jnp.asarray(v8)), m, eight_bit=True, t=32))
    assert (eq8 == (v8[:, None, :] == v8[None, :, :]).sum(-1)).all()
    v16 = rng.integers(0, 65536, size=(n, m)).astype(np.uint16)
    eq16 = np.asarray(CK.count_eq_self_packed(
        CK.pack16(jnp.asarray(v16)), m, eight_bit=False, t=32))
    assert (eq16 == (v16[:, None, :] == v16[None, :, :]).sum(-1)).all()


@pytest.mark.parametrize("m", [64, 63, 17])
def test_swar_pack10_kernels_exact(m):
    """Three-per-word 10-bit guard fields: u8 values direct (no rank
    pass) for gt/lt; ranks < 512 for the bounded eq10 detect."""
    rng = np.random.default_rng(11)
    n = 150
    v8 = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    v8[rng.random((n, m)) < 0.3] = v8[0, 0]  # ties
    pk = CK.pack10(jnp.asarray(v8))
    ref_eq = (v8[:, None, :] == v8[None, :, :]).sum(-1)
    ref_gt = (v8[:, None, :] > v8[None, :, :]).sum(-1)
    gt, lt = CK.count_gtlt_self_packed16(pk, t=32, mode="gtlt10")
    assert (np.asarray(gt) == ref_gt).all()
    assert (np.asarray(lt) == ref_gt.T).all()
    eq = np.asarray(CK.count_eq_self_packed(pk, m, t=32, mode="eq10"))
    assert (eq == ref_eq).all()
    # rectangular
    gtr, ltr = CK.count_gtlt_packed16(pk[:40], pk[40:], mode="gtlt10")
    assert (np.asarray(gtr) == ref_gt[:40, 40:]).all()
    ref_lt = (v8[:40][:, None, :] < v8[40:][None, :, :]).sum(-1)
    assert (np.asarray(ltr) == ref_lt).all()
    eqr = np.asarray(CK.count_eq_packed(pk[:40], pk[40:], m, mode="eq10"))
    assert (eqr == ref_eq[:40, 40:]).all()
    # ranks of wider values < n <= 512 qualify for the same fields
    vals = rng.integers(0, 1 << 62, size=(n, m)).astype(np.uint64)
    vals[rng.random((n, m)) < 0.2] = vals[0, 0]
    r = np.asarray(jax.jit(CK.dense_ranks)(jnp.asarray(vals)))
    pkr = CK.pack10(jnp.asarray(r))
    g2, l2 = CK.count_gtlt_self_packed16(pkr, t=32, mode="gtlt10")
    assert (np.asarray(g2)
            == (vals[:, None, :] > vals[None, :, :]).sum(-1)).all()


@pytest.mark.parametrize("m", [64, 63, 17])
def test_swar_gtlt8_kernels_exact(m):
    """Byte-packed derived-guard gt engine (gtlt8, the production
    ab-u8 route since round 4): exact over the FULL u8 range — the
    engine splits each byte on bit 7, so values straddling 128 are the
    adversarial cases — for self tiles, rectangular tiles, and the
    pair-list body."""
    rng = np.random.default_rng(13)
    n = 150
    v8 = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    v8[rng.random((n, m)) < 0.25] = v8[0, 0]            # ties
    v8[rng.random((n, m)) < 0.15] = 127                 # bit-7 boundary
    v8[rng.random((n, m)) < 0.15] = 128
    pk = CK.pack8(jnp.asarray(v8))
    ref_gt = (v8[:, None, :] > v8[None, :, :]).sum(-1)
    ref_lt = (v8[:, None, :] < v8[None, :, :]).sum(-1)
    gt, lt = CK.count_gtlt_self_packed16(pk, t=32, mode="gtlt8")
    assert (np.asarray(gt) == ref_gt).all()
    assert (np.asarray(lt) == ref_lt).all()
    gtr, ltr = CK.count_gtlt_packed16(pk[:40], pk[40:], mode="gtlt8")
    assert (np.asarray(gtr) == ref_gt[:40, 40:]).all()
    assert (np.asarray(ltr) == ref_lt[:40, 40:]).all()
    # pair-list body (eq from trichotomy must include only true regs)
    from dashing2_tpu.cmp.core import _pair_counts_swar_fn
    ia = rng.integers(0, n, size=256).astype(np.int32)
    ib = rng.integers(0, n, size=256).astype(np.int32)
    eqp, gtp, ltp = _pair_counts_swar_fn("gtlt8", m, 64)(
        pk, jnp.asarray(ia), jnp.asarray(ib))
    assert (np.asarray(gtp) == ref_gt[ia, ib]).all()
    assert (np.asarray(ltp) == ref_lt[ia, ib]).all()
    ref_eq = (v8[ia] == v8[ib]).sum(-1)
    assert (np.asarray(eqp) == ref_eq).all()


@pytest.mark.parametrize("m", [64, 63, 17])
def test_swar_pack30_kernels_exact(m):
    """Two-level 15-bit halves for values < 2^30 (dense ranks past the
    2^15 single-half bound): gt combines per-half flags
    lexicographically, eq detects on the OR of the half xors. Values
    drawn across the full 30-bit range stand in for large-N ranks."""
    rng = np.random.default_rng(17)
    n = 150
    v = rng.integers(0, 1 << 30, size=(n, m)).astype(np.uint32)
    v[rng.random((n, m)) < 0.3] = v[0, 0]          # ties
    v[:, 0] = (1 << 30) - 1                        # max-value edge
    v[0, 1] = 0
    pk = CK.pack30(jnp.asarray(v))
    assert pk.shape[1] == 2 * ((m + 1) // 2)
    ref_eq = (v[:, None, :] == v[None, :, :]).sum(-1)
    ref_gt = (v[:, None, :] > v[None, :, :]).sum(-1)
    gt, lt = CK.count_gtlt_self_packed16(pk, t=32, mode="gtlt30")
    assert (np.asarray(gt) == ref_gt).all()
    assert (np.asarray(lt) == ref_gt.T).all()
    eq = np.asarray(CK.count_eq_self_packed(pk, m, t=32, mode="eq30"))
    assert (eq == ref_eq).all()
    # rectangular (the panel/row-block engines)
    gtr, ltr = CK.count_gtlt_packed16(pk[:40], pk[40:], mode="gtlt30")
    assert (np.asarray(gtr) == ref_gt[:40, 40:]).all()
    ref_lt = (v[:40][:, None, :] < v[40:][None, :, :]).sum(-1)
    assert (np.asarray(ltr) == ref_lt).all()
    eqr = np.asarray(CK.count_eq_packed(pk[:40], pk[40:], m,
                                        mode="eq30"))
    assert (eqr == ref_eq[:40, 40:]).all()
    # host packer agrees with the device packer
    from dashing2_tpu.parallel.allpairs import pack_words_np
    assert np.array_equal(pack_words_np(v, "gtlt30"), np.asarray(pk))


@pytest.mark.parametrize("kind_opts,exact", [
    (dict(kmer_result=1), True),                                # full gt/lt
    (dict(kmer_result=1, fd_level=1.0, truncation_method=1), True),  # bbit
    (dict(kmer_result=1, fd_level=1.0), False),                 # ab u8 gtlt
])
def test_device_block_counts_match_host(kind_opts, exact, monkeypatch):
    """The generic row-block path (N > SELF_MAX) with the fused device
    SWAR block engine forced must match the host block path. Counts are
    bit-identical by construction; the f32 epilogue now runs INSIDE the
    device program, so for the a/b-quantized kinds — whose g_b complement
    recurrence chains contractible steps and transcendental calls — the
    XLA and numpy graphs may differ by ~10 ulps (README deviations; the
    same envelope as the swar/xla routing fuzz below). full/bbit
    epilogues are contraction-immune and stay byte-identical."""
    from dashing2_tpu.config import Dashing2DistOptions
    from dashing2_tpu.result import SketchingResult
    n, m = 150, 96

    def mk():
        rng = np.random.default_rng(29)
        res = SketchingResult(names=[f"s{i}" for i in range(n)])
        res.signatures = np.abs(rng.normal(size=(n, m))) + 1e-9
        res.cardinalities = rng.uniform(1e3, 1e5, size=n)
        return res

    res1 = mk()
    res2 = mk()
    opts = Dashing2DistOptions(sketchsize=m, **kind_opts)
    monkeypatch.setenv("DASHING2_TPU_SELF_MAX", "0")   # force block path
    monkeypatch.delenv("DASHING2_TPU_PAIR_DEVICE", raising=False)
    host = dict(C.pairwise_matrix(opts, res1))
    monkeypatch.setenv("DASHING2_TPU_PAIR_DEVICE", "force")
    dev = dict(C.pairwise_matrix(opts, res2))
    assert host.keys() == dev.keys()
    for k in host:
        if exact:
            assert np.array_equal(host[k], dev[k]), k
        else:
            _close(host[k], dev[k], tol=2e-6)


def _close(a, b, tol=3e-7):
    """COUNTS are bit-exact between routes (kernel tests assert that);
    the f32 measure epilogues run as different XLA graphs, whose FMA
    contraction may differ by the last ulp — compare to 2 ulps. The
    wide-ab complement g_b recurrence chains 11 contractible steps, so
    its routes may drift ~10 ulps (pass tol=2e-6 there)."""
    finite = np.isfinite(a) & np.isfinite(b)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[finite], b[finite], rtol=tol, atol=tol)


def _route_pair(kind, data, cards, m, msr, fd, b=1.2):
    """Run _self_matrix_fn under the swar and xla routes."""
    gbt, gbinv = C._gb_args(max(b, 1.0 + 1e-9), m)
    outs = {}
    for mode in ("swar", "xla"):
        fn = C._self_matrix_fn_m(kind, m, msr, 31, fd, mode)
        outs[mode] = np.asarray(fn(data, cards, np.float64(b), gbt, gbinv))
    return outs["swar"], outs["xla"]


@pytest.mark.parametrize("msr", [Measure.SIMILARITY, Measure.CONTAINMENT,
                                 Measure.INTERSECTION, Measure.POISSON_LLR])
@pytest.mark.parametrize("m", [128, 96])
def test_full_kind_swar_route_bitexact(msr, m):
    """Default full-register gt/lt estimator: SWAR route (gtlt packed
    rank halves) vs the XLA circulant route — identical counts, f32-ulp
    equal measures."""
    rng = np.random.default_rng(7)
    n = 96
    sigs = rng.uniform(0.1, 4.0, size=(n, m))
    sigs[rng.random((n, m)) < 0.2] = sigs[0, 0]  # force ties
    data = sigs.view(np.uint64) if sigs.flags.c_contiguous \
        else np.ascontiguousarray(sigs).view(np.uint64)
    cards = rng.uniform(1e4, 1e6, size=n)
    a, b = _route_pair("full", data, cards, m, msr, 8.0)
    _close(a, b)


@pytest.mark.parametrize("kind,dtype,fd", [
    ("eqfull", np.uint64, 8.0),
    ("bbit", np.uint8, 1.0),
    ("bbit", np.uint16, 2.0),
    ("bbit", np.uint32, 4.0),
    ("bbit", np.uint64, 8.0),
    ("ab", np.uint8, 1.0),
    ("ab", np.uint16, 2.0),
    ("ab", np.uint32, 4.0),
])
def test_compressed_kinds_swar_route_bitexact(kind, dtype, fd):
    rng = np.random.default_rng(8)
    n, m = 100, 128
    hi = min(int(np.iinfo(dtype).max) + 1, 1 << 62)
    data = rng.integers(0, hi, size=(n, m)).astype(dtype)
    data[rng.random((n, m)) < 0.3] = data[0, 0]
    cards = rng.uniform(1e4, 1e6, size=n)
    a, b = _route_pair(kind, data, cards, m, Measure.SIMILARITY, fd)
    _close(a, b)


def test_ab_u64_nonpow2_m_swar_route_bitexact():
    """fd=8 'ab' with non-pow2 m (odd packing tail) through the gtlt
    halves path."""
    rng = np.random.default_rng(9)
    n, m = 80, 96
    data = rng.integers(0, 1 << 62, size=(n, m)).astype(np.uint64)
    cards = rng.uniform(1e4, 1e6, size=n)
    a, b = _route_pair("ab", data, cards, m, Measure.SIMILARITY, 8.0)
    _close(a, b)


@pytest.mark.parametrize("kind,dtype,fd", [
    ("full", np.uint64, 8.0),    # ranks > 512: eq15 halves
    ("ab", np.uint16, 2.0),      # ranks > 512: gtlt16 halves
])
def test_large_n_swar_route_pack16(kind, dtype, fd):
    """n > 512 exceeds the 10-bit field bound — the halves engines must
    still route and agree with XLA (covers the pack16 branches the
    small-n tests no longer reach)."""
    rng = np.random.default_rng(15)
    n, m = 560, 32
    hi = min(int(np.iinfo(dtype).max) + 1, 1 << 62)
    data = rng.integers(0, hi, size=(n, m)).astype(dtype)
    data[rng.random((n, m)) < 0.2] = data[0, 0]
    cards = rng.uniform(1e4, 1e6, size=n)
    a, b = _route_pair(kind, data, cards, m, Measure.SIMILARITY, fd)
    _close(a, b, tol=2e-6 if kind == "ab" and fd < 8 else 3e-7)


@pytest.mark.parametrize("kind,dtype,fd", [
    ("ab", np.uint8, 1.0),       # gtlt tiles, asymmetric mirror
    ("bbit", np.uint8, 1.0),     # eq8 tiles
    ("full", np.uint64, 8.0),    # eq-on-ranks tiles
])
def test_containment_mirror_tiles(kind, dtype, fd):
    """CONTAINMENT is row-normalized (asymmetric): the per-tile fused
    path computes upper-triangle mirrors with swapped cards/counts —
    must match the XLA full-matrix route."""
    rng = np.random.default_rng(14)
    n, m = 90, 128
    hi = min(int(np.iinfo(dtype).max) + 1, 1 << 62)
    data = rng.integers(0, hi, size=(n, m)).astype(dtype)
    data[rng.random((n, m)) < 0.4] = data[0, 0]
    cards = rng.uniform(1e4, 1e6, size=n)
    a, b = _route_pair(kind, data, cards, m, Measure.CONTAINMENT, fd)
    _close(a, b, tol=2e-6 if kind == "ab" and fd < 8 else 3e-7)


def test_swar_pack_mode_policy():
    """Tile-engine pack policy: the 16-bit halves (not the 3-per-word
    pack10 engines) for mid-size ranks, the byte-packed derived-guard
    gt8+neq8 for u8 a/b. Guard the routing so a refactor doesn't
    silently change the engines."""
    rng = np.random.default_rng(21)
    m = 64

    def pick(kind, data, fd):
        import jax as _j
        with _j.ensure_compile_time_eval():
            return C._swar_pack(kind, jnp.asarray(data), m, fd)[1]

    u8 = rng.integers(0, 256, size=(300, m)).astype(np.uint8)
    u64 = rng.integers(0, 1 << 62, size=(300, m)).astype(np.uint64)
    assert pick("ab", u8, 1.0) == "gtlt8"       # r4: byte derived-guard
    assert pick("bbit", u8, 1.0) == "eq8"
    assert pick("full", u64, 8.0) == "eq15"     # 256 < n: not eq10
    assert pick("full", u64[:200], 8.0) == "eq8"
    big = rng.integers(0, 1 << 62, size=(40000, 4)).astype(np.uint64)
    assert pick("full", big, 8.0) == "eq30"
    assert pick("ab", big.astype(np.uint16), 2.0) == "gtlt30"
