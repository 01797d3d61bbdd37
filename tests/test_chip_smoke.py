"""chip_smoke.py's helpers and phases at a tiny size on the CPU (the
script itself refuses to run without a GPU)."""

import importlib.util
import os
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod    # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


TINY = dict(ancestors=3, members=4, length=4000, sketchsize=128,
            sample_rows=6, device_sketch=5, topk=3)


def test_corpus_families_and_divergence(cs, tmp_path):
    size = cs.Size(**TINY)
    paths = cs.make_corpus(str(tmp_path), 7, size)
    assert len(paths) == 12
    seqs = []
    for p in paths:
        with open(p, "rb") as f:
            head, *lines = f.read().split(b"\n")
        assert head.startswith(b">fam")
        seqs.append(np.frombuffer(b"".join(lines), np.uint8))
    assert all(len(s) == 4000 for s in seqs)
    # same family: two members differ at <= 2 x 2 % of positions;
    # different families are unrelated random sequences (~75 %)
    within = np.mean(seqs[0] != seqs[1])
    across = np.mean(seqs[0] != seqs[4])
    assert 0 < within <= 0.04 < 0.6 < across
    # same seed, same corpus
    again = cs.make_corpus(str(tmp_path / "b"), 7, size)
    with open(paths[5], "rb") as f1, open(again[5], "rb") as f2:
        assert f1.read() == f2.read()


def test_condensed_rows_match_square(cs):
    from dashing2_tpu.parse import condensed_to_square
    rng = np.random.default_rng(3)
    n = 9
    flat = rng.random(n * (n - 1) // 2).astype(np.float32)
    sq = condensed_to_square(flat, n)
    rows = [0, 4, 8]
    got = cs.condensed_rows(flat, n, rows)
    for t, i in enumerate(rows):
        assert np.isnan(got[t, i])
        mask = np.arange(n) != i
        assert np.array_equal(got[t, mask], sq[i, mask])


def test_max_ulps(cs):
    a = np.array([1.0, 0.5, np.nan, 0.0], np.float32)
    b = a.copy()
    assert cs.max_ulps(a, b) == 0
    b[1] = np.nextafter(np.float32(0.5), np.float32(1), dtype=np.float32)
    b[3] = -0.0
    assert cs.max_ulps(a, b) == 1
    b[2] = 1.0
    assert cs.max_ulps(a, b) == 1 << 40


def test_np_counts(cs):
    rng = np.random.default_rng(4)
    regs = rng.integers(0, 5, size=(13, 40)).astype(np.uint8)
    rows = [1, 7, 12]
    eq, gt = cs.np_counts(regs, rows, True, step=2)
    for t, i in enumerate(rows):
        assert np.array_equal(eq[t], (regs[i] == regs).sum(1))
        assert np.array_equal(gt[t], (regs[i] > regs).sum(1))
    eq2, none = cs.np_counts(regs, rows, False)
    assert none is None and np.array_equal(eq2, eq)


def test_recall_at_k(cs):
    ip = np.array([0, 2, 4], np.uint64)
    exact = (ip, np.array([1, 2, 0, 2], np.uint32), None)
    approx = (ip, np.array([2, 1, 0, 1], np.uint32), None)
    assert cs.recall_at_k(approx, exact) == pytest.approx(0.75)


def test_main_refuses_without_gpu(cs, capsys):
    assert cs.main([]) == 2
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    assert '"ok"' not in out


def test_single_card_phases_tiny(cs, tmp_path, capsys):
    """Every phase and comparison of the one-card run, on the CPU at a
    tiny size: all checks within their tolerances."""
    run = cs.Runner()
    cs.run_single(run, str(tmp_path), 5, cs.Size(**TINY))
    out = capsys.readouterr().out
    assert run.failed == [], out
    for ph in ("a-sketch", "b-nibble-bbit", "c-full", "d-nibble-ab",
               "e-knn", "f-device-sketch"):
        assert f"phase {ph}:" in out
    assert out.count(" ok\n") == 8
