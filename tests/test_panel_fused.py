"""Fused panel (Q x F) engine vs the generic blocked path, bit-exact.

_panel_matrix_fn routes nq > 0 jobs through the rectangular
SWAR/one-hot count engines with a shared rank space; DASHING2_TPU_KERNEL=
swar forces that route on CPU so both paths run here."""

import os

import numpy as np
import pytest

import dashing2_tpu  # noqa: F401
from dashing2_tpu.cmp.core import pairwise_matrix
from dashing2_tpu.config import Dashing2DistOptions
from dashing2_tpu.enums import Measure
from dashing2_tpu.result import SketchingResult


def _mkres(rng, n, m, nq):
    sigs = np.abs(rng.normal(size=(n, m))) + 1e-9
    res = SketchingResult(names=[f"s{i}" for i in range(n)])
    res.signatures = sigs
    res.cardinalities = rng.uniform(1e3, 1e5, size=n)
    res.nq = nq
    return res


def _run(opts, res, mode):
    os.environ["DASHING2_TPU_KERNEL"] = mode
    try:
        return dict(pairwise_matrix(opts, res))
    finally:
        del os.environ["DASHING2_TPU_KERNEL"]


@pytest.mark.parametrize("msr", [Measure.SIMILARITY, Measure.CONTAINMENT])
@pytest.mark.parametrize("m", [128, 96])
def test_panel_fused_matches_generic_full_kind(msr, m):
    rng = np.random.default_rng(11)
    n, nq = 120, 40
    res1 = _mkres(rng, n, m, nq)
    res2 = SketchingResult(names=list(res1.names))
    res2.signatures = res1.signatures.copy()
    res2.cardinalities = res1.cardinalities.copy()
    res2.nq = nq
    opts = Dashing2DistOptions(sketchsize=m, kmer_result=1, measure=msr)
    fused = _run(opts, res1, "swar")
    generic = _run(opts, res2, "xla")
    assert fused.keys() == generic.keys()
    for k in fused:
        np.testing.assert_allclose(fused[k], generic[k],
                                   rtol=3e-7, atol=3e-7)
    # panel blocks must cover exactly the reference rows
    assert sum(b.shape[0] for b in fused.values()) == n - nq
    assert all(b.shape[1] == nq for b in fused.values())


@pytest.mark.parametrize("kind_opts", [
    dict(kmer_result=1),                                   # full gt/lt
    dict(kmer_result=1, fd_level=1.0, truncation_method=1),  # bbit u8
    dict(kmer_result=1, fd_level=0.5, truncation_method=1),  # nibble-bbit
    dict(kmer_result=1, fd_level=0.5),                       # nibble-ab
])
def test_panel_sharded_matches_single_device(kind_opts):
    """The mesh-sharded panel engine (refs rows sharded, queries
    replicated) must match the single-device fused engine on the same
    SWAR route."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    rng = np.random.default_rng(13)
    n, m, nq = 140, 96, 44
    res1 = _mkres(rng, n, m, nq)
    res2 = SketchingResult(names=list(res1.names))
    res2.signatures = res1.signatures.copy()
    res2.cardinalities = res1.cardinalities.copy()
    res2.nq = nq
    opts = Dashing2DistOptions(sketchsize=m, **kind_opts)
    multi = _run(opts, res1, "swar")
    os.environ["DASHING2_TPU_MULTICHIP"] = "0"
    try:
        single = _run(opts, res2, "swar")
    finally:
        del os.environ["DASHING2_TPU_MULTICHIP"]
    assert multi.keys() == single.keys()
    for k in multi:
        np.testing.assert_allclose(multi[k], single[k],
                                   rtol=2e-7, atol=2e-7)


def test_panel_fused_matches_generic_bbit_u16():
    rng = np.random.default_rng(12)
    n, m, nq = 100, 64, 30
    res1 = _mkres(rng, n, m, nq)
    res2 = SketchingResult(names=list(res1.names))
    res2.signatures = res1.signatures.copy()
    res2.cardinalities = res1.cardinalities.copy()
    res2.nq = nq
    opts = Dashing2DistOptions(sketchsize=m, kmer_result=1,
                               fd_level=2.0, truncation_method=1)
    fused = _run(opts, res1, "swar")
    generic = _run(opts, res2, "xla")
    for k in fused:
        np.testing.assert_allclose(fused[k], generic[k],
                                   rtol=3e-7, atol=3e-7)
