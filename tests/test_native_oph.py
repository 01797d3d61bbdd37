"""Native host OPH sketcher: bit-exactness vs the device path.

The native engine (native/oph_sketch.cpp) reimplements the default DNA
chain — 2-bit encode + RC canonicalization, maskfn scrambler, ownership
window, downsampling, OPH id hash + bucket min/multiplicity — as a
serial per-row loop threaded across batch rows. Every supported config
must match ops/kmers.hashed_kmers -> oph_sketch_rows bit-for-bit.
"""

import os

import numpy as np
import pytest

import dashing2_tpu  # noqa: F401  (x64 mode)
import jax.numpy as jnp

from dashing2_tpu import hashing as H
from dashing2_tpu import native as NAT
from dashing2_tpu.enums import Alphabet
from dashing2_tpu.ops import sketch_kernels as SK
from dashing2_tpu.sketch.core import (_hash_chunk_batch, _native_oph_rows,
                                      _native_oph_supported)
from make_fixtures import make


def _hkw(k=31, w=None, canon=True, chunk_len=512, xormask=H.XORMASK,
         seed_is_zero=False, ds=(1 << 64) - 1, alphabet=Alphabet.DNA,
         spacing_offsets=None, rolling=False, use128=False):
    span = spacing_offsets[-1] + 1 if spacing_offsets else k
    return dict(k=k, w=w or k, canon=canon, alphabet=alphabet,
                entmin=False, xormask=xormask, seed_is_zero=seed_is_zero,
                downsample_threshold=ds, chunk_len=chunk_len, span=span,
                spacing_offsets=spacing_offsets, rolling=rolling,
                use128=use128)


def _codes(rng, R, L, invalid_frac=0.02):
    c = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    bad = rng.random((R, L)) < invalid_frac
    c[bad] = 0xFF
    return c


lib = NAT.load_oph_lib()
pytestmark = pytest.mark.skipif(lib is None,
                                reason="native toolchain unavailable")


@pytest.mark.parametrize("k,canon,seed_is_zero,ds_frac", [
    (31, True, False, None),
    (32, True, False, None),     # full-width mask edge
    (21, False, False, None),
    (4, True, True, None),       # raw codes, tiny k
    (31, True, False, 0.5),      # downsampling active
])
def test_native_matches_device(k, canon, seed_is_zero, ds_frac):
    rng = np.random.default_rng(hash((k, canon, seed_is_zero)) % 2**32)
    R, L, m = 5, 700, 128
    ds = (1 << 64) - 1 if ds_frac is None else int(ds_frac * 2**64)
    hkw = _hkw(k=k, canon=canon, chunk_len=L - 80,
               seed_is_zero=seed_is_zero, ds=ds)
    assert _native_oph_supported(hkw, use_fs=False)
    chunks = _codes(rng, R, L)
    for want_counts in (True, False):
        hashed, valid = _hash_chunk_batch(
            jnp.asarray(chunks), jnp.zeros(1, jnp.uint64),
            use_filterset=False, **hkw)
        r_dev, c_dev = SK.oph_sketch_rows_dense(
            hashed, valid, m=m, seed=H.OPH_DEFAULT_SEED,
            want_counts=want_counts)
        r_nat, c_nat = _native_oph_rows(lib, chunks, hkw, m,
                                        H.OPH_DEFAULT_SEED, want_counts)
        assert np.array_equal(np.asarray(r_dev), r_nat)
        assert np.array_equal(np.asarray(c_dev), c_nat)


@pytest.mark.parametrize("k,w,invalid_frac,ds_frac", [
    (21, 31, 0.02, None),    # typical minimizer config
    (31, 50, 0.0, None),     # clean row, wide window
    (32, 40, 0.05, None),    # k=32 edge (all-T code == invalid sentinel)
    (4, 12, 0.10, None),     # tiny k, heavy invalids, dense ties
    (21, 31, 0.02, 0.5),     # minimizers + downsampling
])
def test_native_minimizers_match_device(k, w, invalid_frac, ds_frac):
    """w > k window-minimizer selection (lexicographic, leftmost tie
    break, kmers.py:360-394 incl. the out-of-range maxv padding edges)
    must be bit-identical between the native engine and the device
    path."""
    rng = np.random.default_rng(hash((k, w, invalid_frac)) % 2**32)
    R, L, m = 5, 700, 128
    ds = (1 << 64) - 1 if ds_frac is None else int(ds_frac * 2**64)
    hkw = _hkw(k=k, w=w, chunk_len=L - 100, ds=ds)
    assert _native_oph_supported(hkw, use_fs=False)
    chunks = _codes(rng, R, L, invalid_frac=invalid_frac)
    if k == 4:
        # low-entropy periodic rows force dense score ties so the
        # leftmost tie break is exercised (invalids re-sprinkled)
        motif = rng.integers(0, 4, size=(R, 5)).astype(np.uint8)
        chunks = np.tile(motif, (1, L // 5 + 1))[:, :L]
        chunks[rng.random((R, L)) < invalid_frac] = 0xFF
    for want_counts in (True, False):
        hashed, valid = _hash_chunk_batch(
            jnp.asarray(chunks), jnp.zeros(1, jnp.uint64),
            use_filterset=False, **hkw)
        r_dev, c_dev = SK.oph_sketch_rows_dense(
            hashed, valid, m=m, seed=H.OPH_DEFAULT_SEED,
            want_counts=want_counts)
        r_nat, c_nat = _native_oph_rows(lib, chunks, hkw, m,
                                        H.OPH_DEFAULT_SEED, want_counts)
        assert np.array_equal(np.asarray(r_dev), r_nat), (k, w)
        assert np.array_equal(np.asarray(c_dev), c_nat), (k, w)


def _assert_native_matches(hkw, chunks, m=128, fs=None, seeds=(True, False)):
    use_fs = fs is not None
    fs_dev = jnp.asarray(fs if use_fs else np.zeros(1, np.uint64))
    for want_counts in seeds:
        hashed, valid = _hash_chunk_batch(
            jnp.asarray(chunks), fs_dev, use_filterset=use_fs, **hkw)
        r_dev, c_dev = SK.oph_sketch_rows_dense(
            hashed, valid, m=m, seed=H.OPH_DEFAULT_SEED,
            want_counts=want_counts)
        r_nat, c_nat = _native_oph_rows(lib, chunks, hkw, m,
                                        H.OPH_DEFAULT_SEED, want_counts,
                                        filterset=fs)
        assert np.array_equal(np.asarray(r_dev), r_nat)
        assert np.array_equal(np.asarray(c_dev), c_nat)


def _alpha_codes(rng, R, L, alphabet, invalid_frac=0.02):
    from dashing2_tpu.ops.kmers import alphabet_size
    c = rng.integers(0, alphabet_size(alphabet),
                     size=(R, L)).astype(np.uint8)
    c[rng.random((R, L)) < invalid_frac] = 0xFF
    return c


@pytest.mark.parametrize("alphabet,k,w", [
    (Alphabet.PROTEIN20, 10, None),     # base-20 packing
    (Alphabet.PROTEIN_6, 20, None),     # Murphy-6, high k
    (Alphabet.PROTEIN_3BIT, 12, 20),    # 8-letter + minimizer windows
    (Alphabet.DNA2, 40, None),          # 1-bit alphabet past k=32
])
def test_native_baseb_matches_device(alphabet, k, w):
    """Protein / DNA2 base-b exact coding (kmers.base_b_kmer_codes; no
    canonicalization, matching the device)."""
    rng = np.random.default_rng(hash((alphabet, k)) % 2**32)
    R, L = 5, 700
    hkw = _hkw(k=k, w=w, chunk_len=L - 80, alphabet=alphabet)
    assert _native_oph_supported(hkw, use_fs=False)
    _assert_native_matches(hkw, _alpha_codes(rng, R, L, alphabet))


@pytest.mark.parametrize("k,canon,w,alphabet", [
    (40, True, None, Alphabet.DNA),     # rolling + RC canonical
    (80, True, None, Alphabet.DNA),     # k > 64 rotation wrap
    (40, False, None, Alphabet.DNA),
    (40, True, 60, Alphabet.DNA),       # rolling + minimizer windows
    (30, True, None, Alphabet.PROTEIN20),  # protein rolling: no canon
])
def test_native_rolling_matches_device(k, canon, w, alphabet):
    """Cyclic-polynomial rolling hash for k beyond exact coding
    (kmers.rolling_hash_codes), incl. the canonical DNA recurrence."""
    rng = np.random.default_rng(hash((k, canon, alphabet)) % 2**32)
    R, L = 5, 700
    hkw = _hkw(k=k, w=w, canon=canon, chunk_len=L - 150,
               alphabet=alphabet, rolling=True)
    assert _native_oph_supported(hkw, use_fs=False)
    _assert_native_matches(hkw, _alpha_codes(rng, R, L, alphabet))


@pytest.mark.parametrize("spacing,k,w", [
    ("1x10", 11, None),        # uniform gaps
    ("0,2,0,1,0x5,3", 11, None),
    ("1x10", 11, 30),          # spaced + minimizer windows
])
def test_native_spaced_matches_device(spacing, k, w):
    from dashing2_tpu.ops.kmers import parse_spacing
    rng = np.random.default_rng(hash((spacing, k)) % 2**32)
    R, L = 5, 700
    offs = tuple(parse_spacing(spacing, k))
    hkw = _hkw(k=k, w=w, chunk_len=L - 120, spacing_offsets=offs)
    assert _native_oph_supported(hkw, use_fs=False)
    _assert_native_matches(hkw, _codes(rng, R, L))


@pytest.mark.parametrize("k,canon,seed_is_zero,w", [
    (40, True, False, None),    # 128-bit canonical
    (33, True, False, None),    # hi-word 2-bit edge
    (63, True, False, None),    # capacity edge
    (40, False, True, None),    # raw low words
    (40, True, False, 55),      # 128-bit minimizers ((hi>>1)^lo scores)
    (21, True, False, None),    # use128 with k < 32 (hi == 0)
])
def test_native_128bit_matches_device(k, canon, seed_is_zero, w):
    """--long-kmers 128-bit exact codes: canonical 128-bit min, low-word
    scramble truncation (enums.h:144-148 semantics), (hi>>1)^lo
    minimizer scores."""
    rng = np.random.default_rng(hash((k, canon, w)) % 2**32)
    R, L = 5, 700
    hkw = _hkw(k=k, w=w, canon=canon, seed_is_zero=seed_is_zero,
               chunk_len=L - 150, use128=True)
    assert _native_oph_supported(hkw, use_fs=False)
    _assert_native_matches(hkw, _codes(rng, R, L))


def test_native_filterset_matches_device():
    """Sorted-hash exclusion probe on the scramble keys (the generic
    loop handles DNA + filterset; device parity incl. hits)."""
    rng = np.random.default_rng(99)
    R, L, m = 5, 700, 128
    hkw = _hkw(k=21, chunk_len=L - 80)
    chunks = _codes(rng, R, L)
    # build the exclusion set from hashes that actually occur
    hashed, valid = _hash_chunk_batch(
        jnp.asarray(chunks), jnp.zeros(1, jnp.uint64),
        use_filterset=False, **hkw)
    hv = np.asarray(hashed)[np.asarray(valid)]
    fs = np.sort(np.unique(rng.choice(hv, size=min(200, len(hv)),
                                      replace=False)))
    assert _native_oph_supported(hkw, use_fs=True)
    _assert_native_matches(hkw, chunks, m=m, fs=fs)
    # filterset + minimizers + downsampling stack
    hkw2 = _hkw(k=21, w=31, chunk_len=L - 80, ds=int(0.6 * 2**64))
    _assert_native_matches(hkw2, chunks, m=m, fs=fs)


def test_native_threads_layout_independent():
    """Row partitioning across thread counts must not change results."""
    rng = np.random.default_rng(7)
    R, L, m = 9, 900, 64
    hkw = _hkw(chunk_len=L - 80)
    chunks = _codes(rng, R, L)
    outs = [_native_oph_rows(lib, chunks, hkw, m, H.OPH_DEFAULT_SEED,
                             True, nthreads=nt) for nt in (1, 3, 8)]
    for r, c in outs[1:]:
        assert np.array_equal(outs[0][0], r)
        assert np.array_equal(outs[0][1], c)


def test_native_supported_surface():
    """Round 5: every config is native-covered except --entmin (libm
    log2 scores are not bit-reproducible vs XLA) and non-routed k."""
    assert _native_oph_supported(_hkw(w=50), False)   # minimizers
    assert _native_oph_supported(_hkw(), True)        # filterset
    h = _hkw(k=40); h["rolling"] = True               # rolling k > 32
    assert _native_oph_supported(h, False)
    h = _hkw(k=10); h["alphabet"] = Alphabet.PROTEIN20
    assert _native_oph_supported(h, False)            # protein base-b
    assert _native_oph_supported(_hkw(k=40, use128=True), False)
    h = _hkw(w=50)
    h["entmin"] = True                                # entropy scoring
    assert not _native_oph_supported(h, False)
    # 2-bit exact k past capacity only arrives as rolling/use128; the
    # raw combination is rejected
    assert not _native_oph_supported(_hkw(k=40), False)


@pytest.mark.parametrize("engine", ["dense", "dense2", "sort", "scatter", "rot"])
def test_device_engines_e2e_match_default(engine, tmp_path, monkeypatch):
    """Explicit device OPH engines through the CLI (which on the test
    mesh also exercises the multichip row-sharded dispatch — batch rows
    shard over the 8 virtual devices) produce byte-identical output to
    the default CPU segments path."""
    from dashing2_tpu.cli import main
    paths = make(str(tmp_path / "fa"), n_genomes=4, length=6000)
    out_d, out_e = str(tmp_path / "d.bin"), str(tmp_path / "e.bin")
    args = ["sketch", "-S", "128", "-k", "31", "--binary-output",
            "--cmpout"]
    monkeypatch.delenv("DASHING2_TPU_OPH_ENGINE", raising=False)
    assert main(args + [out_d] + paths) == 0
    monkeypatch.setenv("DASHING2_TPU_OPH_ENGINE", engine)
    assert main(args + [out_e] + paths) == 0
    with open(out_d, "rb") as f1, open(out_e, "rb") as f2:
        assert f1.read() == f2.read()


def test_dense_path_mixed_shape_drain(tmp_path, monkeypatch):
    """A tail batch (padded to a smaller power of two) sharing a drain
    window with full batches must not break the async dispatch loop
    (regression: jnp.stack over mixed shapes raised on any corpus whose
    chunk count was not a multiple of rows_per_batch)."""
    from dashing2_tpu.config import Dashing2Options
    from dashing2_tpu.sketch.core import sketch_fastx
    monkeypatch.setenv("DASHING2_TPU_OPH_ENGINE", "dense")
    paths = make(str(tmp_path / "fa"), n_genomes=21, length=3000)
    opts = Dashing2Options(k=21, sketchsize=64)
    res = sketch_fastx(opts, paths, rows_per_batch=16)  # 1 full + tail
    monkeypatch.delenv("DASHING2_TPU_OPH_ENGINE")
    ref = sketch_fastx(Dashing2Options(k=21, sketchsize=64), paths,
                       rows_per_batch=16)
    assert np.array_equal(np.asarray(res.signatures),
                          np.asarray(ref.signatures))


@pytest.mark.parametrize("extra", [
    ["-k", "31"],                              # default DNA AVX path
    ["-k", "40"],                              # rolling hash
    ["-k", "40", "--128bit"],                  # 128-bit exact low-word
    ["-k", "11", "--spacing", "1x10"],         # spaced seed
    ["-k", "21", "-w", "31"],                  # minimizer windows
])
def test_native_engine_e2e_matches_default(tmp_path, monkeypatch, extra):
    """DASHING2_TPU_OPH_ENGINE=native through the CLI produces
    byte-identical output to the default engine across the full
    supported config surface — via BOTH native routes: the file-driver
    engine (reads + sketches path groups wholly in C++) and the
    chunk-batched row engine (DASHING2_TPU_NATIVE_FILES=0)."""
    from dashing2_tpu.cli import main
    paths = make(str(tmp_path / "fa"), n_genomes=4, length=6000)
    out_d = str(tmp_path / "d.bin")
    args = ["sketch", "-S", "128", "--binary-output"] + extra \
        + ["--cmpout"]
    monkeypatch.delenv("DASHING2_TPU_OPH_ENGINE", raising=False)
    monkeypatch.delenv("DASHING2_TPU_NATIVE_FILES", raising=False)
    assert main(args + [out_d] + paths) == 0
    monkeypatch.setenv("DASHING2_TPU_OPH_ENGINE", "native")
    for files_mode in ("force", "0"):
        out_n = str(tmp_path / f"n{files_mode}.bin")
        monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", files_mode)
        assert main(args + [out_n] + paths) == 0
        with open(out_d, "rb") as f1, open(out_n, "rb") as f2:
            assert f1.read() == f2.read()


def test_native_files_driver_input_shapes(tmp_path, monkeypatch):
    """The file-driver engine handles gzip inputs, FASTQ, multi-path
    groups, records shorter than k, and N runs — bit-identically to
    the chunk-batched engines."""
    import gzip
    import random

    from dashing2_tpu.config import Dashing2Options
    from dashing2_tpu.sketch.core import sketch_fastx
    random.seed(5)

    def seq(n, abc="ACGT"):
        return "".join(random.choice(abc) for _ in range(n))

    fa = str(tmp_path / "a.fa")
    with open(fa, "w") as f:
        f.write(f">r0 descr\n{seq(800)}\n>short\nACG\n"
                f">ns\n{seq(300, 'ACGTN')}\n>multi\n"
                + "\n".join(seq(60) for _ in range(10)) + "\n")
    fz = str(tmp_path / "b.fa.gz")
    with gzip.open(fz, "wt") as f:
        f.write(f">z0\n{seq(700)}\n>z1\n{seq(50)}\n")
    fq = str(tmp_path / "c.fq")
    with open(fq, "w") as f:
        for i in range(4):
            s = seq(250)
            f.write(f"@q{i}\n{s}\n+\n{'I' * len(s)}\n")
    groups = [fa, f"{fz} {fq}"]    # multi-path group merges sketches

    def run(files_mode):
        monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", files_mode)
        if files_mode == "0":
            monkeypatch.setenv("DASHING2_TPU_OPH_ENGINE", "native")
        else:
            monkeypatch.delenv("DASHING2_TPU_OPH_ENGINE", raising=False)
        return sketch_fastx(Dashing2Options(
            k=21, w=31, sketchsize=128, save_kmercounts=True,
            cache_sketches=False), groups)

    a, b = run("force"), run("0")
    assert np.array_equal(np.asarray(a.signatures),
                          np.asarray(b.signatures))
    assert np.array_equal(a.cardinalities, b.cardinalities)
    assert np.array_equal(a.kmercounts, b.kmercounts)


def test_native_files_driver_missing_path(tmp_path, monkeypatch):
    """A missing input file raises OSError naming the path (the same
    failure class as the Python reader path)."""
    from dashing2_tpu.config import Dashing2Options
    from dashing2_tpu.sketch.core import sketch_fastx
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    missing = str(tmp_path / "nope.fa")
    with pytest.raises(OSError, match="nope.fa"):
        sketch_fastx(Dashing2Options(k=21, sketchsize=64,
                                     cache_sketches=False), [missing])


def test_auto_device_engine_resident_routing(monkeypatch):
    """'auto' device dispatch resolves to the rot engine inside a
    resident worker (compiles amortize) and to cheap-compile sort in
    one-shot processes."""
    from dashing2_tpu.sketch.core import _auto_device_engine
    monkeypatch.delenv("DASHING2_TPU_RESIDENT", raising=False)
    assert _auto_device_engine() == "sort"
    monkeypatch.setenv("DASHING2_TPU_RESIDENT", "1")
    assert _auto_device_engine() == "rot"


def test_native_hash_counting_path_matches_device(tmp_path, monkeypatch):
    """The counting stream (exact sets / countdicts / weighted spaces)
    hashed by the native host engine is byte-identical to the device
    hash path (DASHING2_TPU_NATIVE_HASH=0)."""
    from dashing2_tpu.cli import main
    paths = make(str(tmp_path / "fa"), n_genomes=4, length=6000)
    for args in (["--set", "-k", "21"],
                 ["--countdict", "-k", "21"],
                 ["--multiset", "-k", "21", "-S", "64"],
                 ["--set", "-k", "21", "-w", "31"]):
        outs = []
        for knob in ("1", "0"):
            monkeypatch.setenv("DASHING2_TPU_NATIVE_HASH", knob)
            out = str(tmp_path / f"o{knob}.bin")
            assert main(["cmp", "--binary-output", "--cmpout", out]
                        + args + paths) == 0
            outs.append(open(out, "rb").read())
        assert outs[0] == outs[1], args
