"""The per-tile fused epilogue (tri engine) must produce the same f32
matrix as the full-square engine for every measure, incl. the
asymmetric CONTAINMENT."""

import numpy as np
import pytest

import dashing2_tpu.ops.pallas_cmp as PC
from dashing2_tpu.cmp import core as C
from dashing2_tpu.enums import Measure


@pytest.mark.parametrize("kind", ["nibble-ab", "nibble-bbit"])
@pytest.mark.parametrize("msr", [Measure.SIMILARITY, Measure.CONTAINMENT,
                                 Measure.INTERSECTION,
                                 Measure.POISSON_LLR])
def test_tile_fused_matches_full(monkeypatch, kind, msr):
    rng = np.random.default_rng(int(msr) * 7 + (kind == "nibble-ab"))
    n, m = 300, 64  # unpacked register count = 2 * packed columns
    packed = rng.integers(0, 256, size=(n, m // 2), dtype=np.uint16
                          ).astype(np.uint8)
    cards = rng.uniform(1e3, 1e5, size=n)
    b = np.float64(1.01)
    gbt, gbinv = C._gb_args(float(b), m)

    import jax.numpy as jnp

    # full-square reference (the plain XLA route)
    fn_full = C._self_matrix_fn_m(kind, m, msr, 21, 0.5, "xla")
    ref = np.asarray(fn_full(jnp.asarray(packed), jnp.asarray(cards), b,
                             jnp.asarray(gbt), gbinv))

    # the tile-fused route (kernel in the Pallas interpreter, small
    # blocks so the interpreter stays fast)
    monkeypatch.setattr(PC, "INTERPRET", True)
    monkeypatch.setattr(PC, "_TRI_BM", 128)
    C._self_matrix_fn.cache_clear()
    fn_tile = C._self_matrix_fn_m(kind, m, msr, 21, 0.5, "tri")
    got = np.asarray(fn_tile(jnp.asarray(packed), jnp.asarray(cards), b,
                             jnp.asarray(gbt), gbinv))
    C._self_matrix_fn.cache_clear()
    assert got.shape == ref.shape
    assert np.array_equal(got, ref), np.abs(got - ref).max()
