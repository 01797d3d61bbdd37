"""File-backed exact-set streaming (>RAM corpora).

The reference compares exact k-mer sets / count-dicts streamed from
their cache files when not RAM-resident (cmp_core.cpp:518-572,
wcompare.cpp:145-187 FILE variant). These tests pin this framework's
analogue: DiskSortedSet chunked merges are exact vs a numpy oracle,
byte-identical to the RAM route end-to-end, and bounded-memory.
"""

import os
import tracemalloc

import numpy as np
import pytest

from dashing2_tpu.io.diskset import (DiskSortedSet, ram_set,
                                     streaming_intersection)


def _sorted_unique(rng, n, hi=1 << 40):
    return np.unique(rng.integers(0, hi, size=n, dtype=np.uint64))


@pytest.mark.parametrize("na,nb,chunk", [
    (0, 100, 16), (100, 0, 16), (1, 1, 16),
    (1000, 1000, 16), (1000, 1000, 37), (1000, 1000, 1 << 20),
    (5000, 300, 64), (300, 5000, 64),
])
def test_streaming_intersection_matches_oracle(tmp_path, na, nb, chunk):
    rng = np.random.default_rng(na * 7919 + nb + chunk)
    a = _sorted_unique(rng, na, hi=4 * max(na + nb, 1))  # force overlaps
    b = _sorted_unique(rng, nb, hi=4 * max(na + nb, 1))
    want = float(len(np.intersect1d(a, b)))
    # RAM <-> RAM, disk <-> RAM, disk <-> disk all agree
    pa, pb = str(tmp_path / "a.kmerset64"), str(tmp_path / "b.kmerset64")
    a.tofile(pa)
    b.tofile(pb)
    da, db = DiskSortedSet(pa), DiskSortedSet(pb)
    assert len(da) == len(a) and len(db) == len(b)
    for x, y in [(ram_set(a), ram_set(b)), (da, ram_set(b)), (da, db)]:
        assert streaming_intersection(x, y, chunk=chunk) == want


def test_streaming_weighted_min_counts(tmp_path):
    rng = np.random.default_rng(5)
    a = _sorted_unique(rng, 800, hi=1600)
    b = _sorted_unique(rng, 700, hi=1600)
    ca = rng.integers(1, 50, size=len(a)).astype(np.float64)
    cb = rng.integers(1, 50, size=len(b)).astype(np.float64)
    common, ia, ib = np.intersect1d(a, b, return_indices=True)
    want = float(np.minimum(ca[ia], cb[ib]).sum())
    pa, pb = str(tmp_path / "a.u64"), str(tmp_path / "b.u64")
    qa, qb = str(tmp_path / "a.f64"), str(tmp_path / "b.f64")
    a.tofile(pa)
    b.tofile(pb)
    ca.tofile(qa)
    cb.tofile(qb)
    da = DiskSortedSet(pa, counts_path=qa)
    db = DiskSortedSet(pb, counts_path=qb)
    assert da.weighted and db.weighted
    got = streaming_intersection(da, db, weighted=True, chunk=61)
    assert got == want
    assert da.counts_sum(chunk=17) == float(ca.sum())
    # mixed disk/RAM weighted
    got2 = streaming_intersection(da, ram_set(b, cb), weighted=True,
                                  chunk=61)
    assert got2 == want


def test_streaming_rejects_unsorted(tmp_path):
    bad = np.array([5, 3, 9], np.uint64)
    p = str(tmp_path / "bad.u64")
    bad.tofile(p)
    with pytest.raises(ValueError, match="not sorted"):
        streaming_intersection(DiskSortedSet(p),
                               ram_set(np.arange(10, dtype=np.uint64)),
                               chunk=2)


def test_disk_set_head_slice_and_full_scan_guard(tmp_path):
    a = np.arange(100, dtype=np.uint64) * 3
    p = str(tmp_path / "a.u64")
    a.tofile(p)
    d = DiskSortedSet(p)
    assert np.array_equal(d[:10], a[:10])
    assert np.array_equal(d[:1000], a)
    with pytest.raises(TypeError):
        d[5:10]


def test_streaming_bounded_memory(tmp_path):
    """Peak allocation during the merge stays O(chunk), not O(set)."""
    n = 1 << 19  # 4 MB of keys per side
    a = (np.arange(n, dtype=np.uint64) * 3)
    b = (np.arange(n, dtype=np.uint64) * 5)
    pa, pb = str(tmp_path / "a.u64"), str(tmp_path / "b.u64")
    a.tofile(pa)
    b.tofile(pb)
    want = float(len(np.intersect1d(a, b)))
    chunk = 1 << 12  # 32 KB reads
    da, db = DiskSortedSet(pa), DiskSortedSet(pb)
    tracemalloc.start()
    tracemalloc.reset_peak()
    got = streaming_intersection(da, db, chunk=chunk)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert got == want
    # generous constant: a few live chunks + searchsorted temporaries,
    # but far below the 8 MB full materialization
    assert peak < 40 * chunk * 8, peak


def _run_cli(args, env=None):
    old = {}
    for k, v in (env or {}).items():
        old[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        from dashing2_tpu.cli import main
        return main(args)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("mode_flag", ["--set", "--countdict"])
def test_exact_stream_e2e_matches_ram(tmp_path, mode_flag, monkeypatch):
    """CLI exact job re-run over its cache files with streaming forced
    (tiny chunks) is byte-identical to the RAM route — and the
    streaming merge really ran."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from make_fixtures import make
    paths = make(str(tmp_path / "fa"), n_genomes=4, length=6000)
    calls = [0]
    import dashing2_tpu.io.diskset as dk
    real = dk.streaming_intersection

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(dk, "streaming_intersection", counting)
    outs = []
    # first run sketches + writes the cache artifacts; the next two
    # load them (RAM route vs DiskSortedSet streaming route)
    for tag, env in [("warm", {"DASHING2_TPU_EXACT_STREAM": "0"}),
                     ("ram", {"DASHING2_TPU_EXACT_STREAM": "0"}),
                     ("disk", {"DASHING2_TPU_EXACT_STREAM": "1",
                               "DASHING2_TPU_EXACT_CHUNK": "64"})]:
        out = str(tmp_path / f"{tag}.bin")
        rc = _run_cli(["sketch", mode_flag, "-k", "16", "--cache",
                       "--binary-output", "--cmpout", out] + paths,
                      env=env)
        assert rc == 0
        if tag == "ram":
            assert calls[0] == 0
        outs.append(np.fromfile(out, np.float32))
    assert calls[0] >= 6, "streaming comparator never engaged"
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[1], outs[2]), (outs[1], outs[2])
    assert np.isfinite(outs[0]).all() and len(outs[0]) == 6
