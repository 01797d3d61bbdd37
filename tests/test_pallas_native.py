import gzip

import numpy as np
import pytest

import dashing2_tpu.ops.pallas_cmp as PC
from dashing2_tpu.ops.pallas_cmp import nibble_dots


@pytest.fixture
def interpret(monkeypatch):
    """The triangular kernel compiles for the GPU only: run it in the
    Pallas interpreter."""
    monkeypatch.setattr(PC, "INTERPRET", True)


def naive(a, b):
    eq = np.array([[(x == y).sum() for y in b] for x in a])
    gt = np.array([[(x > y).sum() for y in b] for x in a])
    lt = np.array([[(x < y).sum() for y in b] for x in a])
    return eq, gt, lt


def test_counts_nibble_mxu():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 16, size=(11, 64)).astype(np.uint8)
    b = rng.integers(0, 16, size=(7, 64)).astype(np.uint8)
    eq_n, gt_n, lt_n = naive(a, b)
    eq, gt, lt = nibble_dots(a, b, True)
    assert np.array_equal(np.asarray(eq), eq_n)
    assert np.array_equal(np.asarray(gt), gt_n)
    assert np.array_equal(np.asarray(lt), lt_n)


def test_native_reader_matches_python(tmp_path):
    from dashing2_tpu.enums import Alphabet
    from dashing2_tpu.io.fastx import read_encoded, read_fastx
    from dashing2_tpu.native import load_fastx_lib
    from dashing2_tpu.ops.kmers import alphabet_lut
    fa = tmp_path / "x.fa"
    fa.write_text(">s1 desc\nACGTNNacgt\nGGGG\n>s2\nTTTT\n\n>s3\nA\n")
    fq = tmp_path / "y.fq.gz"
    with gzip.open(fq, "wt") as f:
        f.write("@r1\nACGTA\n+\nIIIII\n@r2 z\nGGCCN\n+r2 z\n!!!!!\n")
    if load_fastx_lib() is None:
        pytest.skip("no native toolchain")
    for p in (str(fa), str(fq)):
        native = [(n, c.tolist()) for n, c in read_encoded(p, Alphabet.DNA)]
        py = [(n, alphabet_lut(Alphabet.DNA)[
            np.frombuffer(s, np.uint8)].tolist())
            for n, s in read_fastx(p)]
        assert native == py, p


def test_native_reader_malformed(tmp_path):
    from dashing2_tpu.enums import Alphabet
    from dashing2_tpu.io.fastx import read_encoded
    from dashing2_tpu.native import load_fastx_lib
    if load_fastx_lib() is None:
        pytest.skip("no native toolchain")
    bad = tmp_path / "bad.fa"
    bad.write_text("this is not fasta\n")
    with pytest.raises(ValueError):
        list(read_encoded(str(bad), Alphabet.DNA))


def test_tri_comb_counts_match_reference(interpret):
    """Triangular combined-encoding kernel (Pallas interpreter) must
    produce exact eq/gt/lt incl. padding rows sliced off and the
    eq_chunk==64 decode boundary (identical rows)."""
    import jax.numpy as jnp
    from dashing2_tpu.ops.pallas_cmp import counts_nibble_tri_self
    rng = np.random.default_rng(11)
    for n, m in ((300, 128), (512, 64)):
        a = rng.integers(0, 16, size=(n, m)).astype(np.uint8)
        a[7] = a[3]         # identical pair
        a[20] = 0           # constant rows
        a[21] = 15
        eq, gt, lt = counts_nibble_tri_self(jnp.asarray(a), bm=128)
        eq_ref = (a[:, None, :] == a[None, :, :]).sum(2)
        gt_ref = (a[:, None, :] > a[None, :, :]).sum(2)
        assert np.array_equal(np.asarray(eq), eq_ref), (n, m)
        assert np.array_equal(np.asarray(gt), gt_ref), (n, m)
        assert np.array_equal(np.asarray(lt), m - eq_ref - gt_ref), (n, m)


def test_tri_eq_counts_match_reference():
    """The eq-only self-pairs job (--bbit-sigs) runs the plain XLA
    full-square product, which beat a triangular kernel on the card."""
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    a = rng.integers(0, 16, size=(300, 128)).astype(np.uint8)
    a[5] = a[2]
    eq = np.asarray(nibble_dots(jnp.asarray(a), jnp.asarray(a), False)[0])
    ref = (a[:, None, :] == a[None, :, :]).sum(2)
    assert np.array_equal(eq, ref)


@pytest.mark.gpu
def test_tri_kernel_compiled_matches_interpreter(gpu, monkeypatch):
    """The Triton-compiled kernel agrees with the Pallas interpreter."""
    import jax.numpy as jnp
    rng = np.random.default_rng(13)
    a = jnp.asarray(rng.integers(0, 16, size=(2100, 128)).astype(np.uint8))
    got = [np.asarray(x) for x in PC.counts_nibble_tri_self(a)]
    monkeypatch.setattr(PC, "INTERPRET", True)
    PC._tri_call.clear_cache()
    ref = [np.asarray(x) for x in PC.counts_nibble_tri_self(a)]
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


@pytest.mark.parametrize("T", [2, 4, 6, 10, 16])
def test_tri_pair_blocks_cover_lower_triangle_once(T):
    ii, jj = PC.tri_pair_blocks(T)
    pairs = list(zip(ii.tolist(), jj.tolist()))
    assert len(pairs) == T * (T + 1) // 2 == len(set(pairs))
    assert set(pairs) == {(i, j) for i in range(T) for j in range(i + 1)}


@pytest.mark.parametrize("n,m", [(129, 64), (200, 128), (256, 8)])
def test_tri_decode_boundary_and_padding(interpret, n, m):
    """Identical rows put eq_chunk at its 64-register bound in every
    decode chunk; constant 0/15 rows put gt at 0 and at its bound; n is
    not a multiple of the block, so padding rows are sliced off."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n + m)
    a = rng.integers(0, 16, size=(n, m)).astype(np.uint8)
    a[1::2] = a[0]
    a[2] = 0
    a[4] = 15
    eq, gt, lt = PC.counts_nibble_tri_self(jnp.asarray(a), bm=64)
    eq_ref = (a[:, None, :] == a[None, :, :]).sum(2)
    gt_ref = (a[:, None, :] > a[None, :, :]).sum(2)
    assert np.asarray(eq).shape == (n, n)
    assert np.array_equal(np.asarray(eq), eq_ref)
    assert np.array_equal(np.asarray(gt), gt_ref)
    assert np.array_equal(np.asarray(lt), m - eq_ref - gt_ref)


@pytest.mark.parametrize("n,m,ok", [(1024, 1024, False), (1025, 1024, True),
                                    (4096, 96, False), (4096, 48, True),
                                    (4096, 36, False), (4096, 1 << 15, False)])
def test_tri_self_counts_available_shapes(n, m, ok):
    assert PC.tri_self_counts_available(n, m) is ok
