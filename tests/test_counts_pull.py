"""The u16 counts-pull route (cmp/core._counts_pull_on): for eq-count
representations and transcendental-free measures, only the u16 eq
counts cross device->host and the numpy epilogue reconstructs the f32
measure matrix BYTE-IDENTICALLY to the fused f32 route (which is the
goldens' contract). DASHING2_TPU_PULL_COUNTS=force engages it on the
CPU test backend; =0 pins the f32 route as the reference."""

import numpy as np
import pytest

from dashing2_tpu.cmp import core as C
from dashing2_tpu.cmp.core import pairwise_matrix
from dashing2_tpu.config import Dashing2DistOptions
from dashing2_tpu.enums import Measure
from dashing2_tpu.result import SketchingResult

# SIMILARITY only: the card-dependent measures divide by per-pair
# runtime values and a device f32 divide need not be IEEE-identical —
# they keep the f32 route
MEASURES = [Measure.SIMILARITY]


def _result(n, m, seed=0):
    rng = np.random.default_rng(seed)
    res = SketchingResult(names=[f"g{i}" for i in range(n)])
    res.signatures = rng.random((n, m)) + 0.5
    res.cardinalities = rng.random(n) * 1e5 + 10.0
    return res


def _collect(opts, res, upper_only=False):
    if hasattr(res, "_pair_dev_cache"):
        del res._pair_dev_cache
    out = {}
    for start, blk in pairwise_matrix(opts, res, upper_only=upper_only):
        out[start] = np.asarray(blk).copy()
    return out


def _byte_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        assert np.array_equal(a[k], b[k], equal_nan=True), \
            (k, np.nanmax(np.abs(a[k].astype(np.float64)
                                 - b[k].astype(np.float64))))


@pytest.fixture(autouse=True)
def _route_env(monkeypatch):
    # single-logical-device routing (the mesh keeps the f32 route) and
    # the SWAR engines (the production GPU route) on the CPU backend
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    monkeypatch.setenv("DASHING2_TPU_KERNEL", "swar")


@pytest.mark.parametrize("msr", MEASURES)
def test_self_route_byte_identical(monkeypatch, msr):
    opts = Dashing2DistOptions(k=31, sketchsize=64, measure=msr)
    res = _result(300, 64, seed=int(msr))
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "0")
    ref = _collect(opts, res)
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "force")
    got = _collect(opts, res)
    _byte_equal(got, ref)


def test_self_route_upper_only(monkeypatch):
    opts = Dashing2DistOptions(k=31, sketchsize=64)
    res = _result(300, 64, seed=5)
    monkeypatch.setenv("DASHING2_TPU_UPPER", "force")
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "0")
    ref = _collect(opts, res, upper_only=True)
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "force")
    got = _collect(opts, res, upper_only=True)
    _byte_equal(got, ref)


@pytest.mark.parametrize("n,m", [(300, 64), (301, 64), (257, 2048)])
def test_self_route_packed_pull(monkeypatch, n, m):
    """The packed-trapezoid pull (2 counts per 3 bytes, one pull —
    _pack_tri_counts_fn) is byte-identical to the unpacked block route
    and the f32 route, including odd condensed totals (n=301 forces the
    pad element) and wider count bits (m=2048 -> 12 bits, the 2*bits=24
    ceiling)."""
    opts = Dashing2DistOptions(k=31, sketchsize=m)
    res = _result(n, m, seed=n + m)
    monkeypatch.setenv("DASHING2_TPU_UPPER", "force")
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "0")
    ref = _collect(opts, res, upper_only=True)
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "force")
    monkeypatch.setenv("DASHING2_TPU_PACK_PULL", "0")
    unpacked = _collect(opts, res, upper_only=True)
    monkeypatch.setenv("DASHING2_TPU_PACK_PULL", "1")
    packed = _collect(opts, res, upper_only=True)
    _byte_equal(unpacked, ref)
    _byte_equal(packed, ref)


def test_pack_unpack_roundtrip_exact():
    """Device pack / host unpack round-trips every count value 0..m."""
    import jax.numpy as jnp
    m = 1024
    bits = int(m).bit_length()
    n = 64
    rng = np.random.default_rng(0)
    cmat = rng.integers(0, m + 1, size=(n, n)).astype(np.uint16)
    cmat.ravel()[:m + 1] = np.arange(m + 1)    # cover the full range
    block = 24                                 # multiple partial blocks
    buf = np.asarray(C._pack_tri_counts_fn(n, block, bits)(
        jnp.asarray(cmat)))
    sizes = [(s, min(block, n - s), n - s) for s in range(0, n, block)]
    total = sum(b * w for _, b, w in sizes)
    vals = C._unpack_tri_counts(buf, bits, total)
    off = 0
    for s, b, w in sizes:
        got = vals[off:off + b * w].reshape(b, w)
        off += b * w
        assert np.array_equal(got, cmat[s:s + b, s:])


@pytest.mark.parametrize("upper", [False, True])
def test_block_route_byte_identical(monkeypatch, upper):
    opts = Dashing2DistOptions(k=31, sketchsize=64)
    res = _result(300, 64, seed=9)
    monkeypatch.setenv("DASHING2_TPU_SELF_MAX", "0")
    monkeypatch.setenv("DASHING2_TPU_PAIR_DEVICE", "force")
    if upper:
        monkeypatch.setenv("DASHING2_TPU_UPPER", "force")
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "0")
    ref = _collect(opts, res, upper_only=upper)
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "force")
    got = _collect(opts, res, upper_only=upper)
    _byte_equal(got, ref)


def test_panel_route_byte_identical(monkeypatch):
    opts = Dashing2DistOptions(k=31, sketchsize=64)
    res = _result(300, 64, seed=13)
    res.nq = 40   # last 40 rows are queries -> (260, 40) panel
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "0")
    ref = _collect(opts, res)
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "force")
    got = _collect(opts, res)
    _byte_equal(got, ref)


def test_non_sim_and_ab_stay_on_f32_route(monkeypatch):
    # force-enable so the kind/measure/m exclusion guards are what the
    # assertions exercise (without it the CPU backend returns False for
    # EVERY combo and the guards could be deleted unnoticed)
    monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", "force")
    # positive control: the eligible combo takes the route under force
    assert C._counts_pull_on("full", Measure.SIMILARITY, 64)
    assert C._counts_pull_on("eqfull", Measure.SIMILARITY, 64)
    # card-dependent measures (a device divide need not be
    # IEEE-identical) and the gt/lt-consuming ab kinds
    # never take the route
    for msr in (Measure.POISSON_LLR, Measure.CONTAINMENT,
                Measure.INTERSECTION, Measure.SYMMETRIC_CONTAINMENT,
                Measure.UNION_SIZE):
        assert not C._counts_pull_on("full", msr, 64)
    assert not C._counts_pull_on("ab", Measure.SIMILARITY, 64)
    assert not C._counts_pull_on("nibble-ab", Measure.SIMILARITY, 64)
    assert not C._counts_pull_on("full", Measure.SIMILARITY, 1 << 16)


def test_sim_table_matches_epilogue():
    # the (m+1)-entry device sim table IS the fused epilogue evaluated
    # on every possible count (here the device is XLA:CPU)
    import numpy as np
    from dashing2_tpu.cmp import estimators as E
    m = 64
    t_eqfull = C._sim_table("eqfull", m, 31, 8.0)
    ref = E.equality_measures32(np.arange(m + 1, dtype=np.int32), m,
                                np.ones(1), np.ones(1),
                                Measure.SIMILARITY, 31, xp=np)
    assert np.array_equal(t_eqfull, np.asarray(ref, np.float32).ravel())


def test_cli_fastcmp_routes_byte_identical(monkeypatch, tmp_path):
    """CLI-level: bbit u8 (--fastcmp 1) and nibble-bbit (--fastcmp 0.5
    --bbit-sigs) condensed binary outputs are byte-identical with the
    counts-pull route forced vs disabled."""
    import sys
    sys.path.insert(0, str(tmp_path))  # noqa: F401 (fixture imports)
    from make_fixtures import make

    from dashing2_tpu.cli import main as climain
    fas = make(str(tmp_path), n_genomes=8, length=12000, seed=21)
    for extra in (["--fastcmp", "1"],
                  ["--fastcmp", "0.5", "--bbit-sigs"]):
        outs = {}
        for mode in ("0", "force"):
            monkeypatch.setenv("DASHING2_TPU_PULL_COUNTS", mode)
            out = str(tmp_path / f"o_{'-'.join(extra)}_{mode}.bin")
            rc = climain(["sketch", "-k", "31", "-S", "64",
                          "--binary-output", "--cmpout", out]
                         + extra + fas)
            assert rc == 0
            outs[mode] = open(out, "rb").read()
        assert outs["0"] == outs["force"], extra


def test_native_helpers_match_numpy():
    """reg2sig_nibble / unpack_counts24 native helpers are bit-identical
    to the numpy forms they replace."""
    from dashing2_tpu import hashing as H
    from dashing2_tpu.cmp.core import _native_helper
    nat = _native_helper()
    if nat is None:
        pytest.skip("native toolchain unavailable")
    import ctypes
    rng = np.random.default_rng(3)
    # reg2sig + nibble pack
    regs = rng.integers(0, 1 << 63, size=4096, dtype=np.uint64)
    sig64 = H.reg2sig(regs)
    want = ((sig64[0::2] & np.uint64(0xF))
            | ((sig64[1::2] & np.uint64(0xF)) << np.uint64(4))
            ).astype(np.uint8)
    got = np.empty(2048, np.uint8)
    nat.reg2sig_nibble(
        regs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), 4096,
        H.REG2SIG_XOR, got.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert np.array_equal(got, want)
    # 24-bit pair unpack
    bits = 11
    t2 = 5000
    vals = rng.integers(0, 1 << bits, size=2 * t2, dtype=np.uint32)
    x = vals[0::2] | (vals[1::2] << np.uint32(bits))
    buf = np.concatenate([(x & 0xFF), ((x >> 8) & 0xFF),
                          ((x >> 16) & 0xFF)]).astype(np.uint8)
    out = np.empty(2 * t2, np.uint16)
    nat.unpack_counts24(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t2, bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    assert np.array_equal(out, vals.astype(np.uint16))
