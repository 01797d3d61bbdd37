"""Statistical accuracy of the weighted sketch estimators (the asserted
version of the reference's eyeball harness test/oph.cpp, extended to the
weighted spaces)."""

import numpy as np

from dashing2_tpu.sketch.weighted import bagminhash_many, probminhash_many


def _weighted_sets(rng, n_items=600, overlap=0.6):
    ids = rng.choice(1 << 62, size=n_items, replace=False).astype(np.uint64)
    wa = rng.gamma(2.0, 2.0, size=n_items)
    wb = wa.copy()
    flip = rng.random(n_items) > overlap
    wb[flip] = rng.gamma(2.0, 2.0, size=int(flip.sum()))
    keep_a = rng.random(n_items) < 0.9
    keep_b = rng.random(n_items) < 0.9
    a, ca = ids[keep_a], wa[keep_a]
    b, cb = ids[keep_b], wb[keep_b]
    # ground truths over the union
    awm = {int(i): w for i, w in zip(a, ca)}
    bwm = {int(i): w for i, w in zip(b, cb)}
    keys = set(awm) | set(bwm)
    mins = sum(min(awm.get(k, 0.0), bwm.get(k, 0.0)) for k in keys)
    maxs = sum(max(awm.get(k, 0.0), bwm.get(k, 0.0)) for k in keys)
    jw = mins / maxs
    return (a, ca, b, cb, jw)


def test_weighted_jaccard_accuracy():
    rng = np.random.default_rng(3)
    m = 2048
    a, ca, b, cb, jw = _weighted_sets(rng)
    sigs, cards = bagminhash_many([a, b], [ca, cb], m)
    est = (sigs[0] == sigs[1]).mean()
    tol = 4 * np.sqrt(jw * (1 - jw) / m) + 1e-3
    assert abs(est - jw) < tol, (est, jw, tol)
    # total weights come back as cardinalities
    np.testing.assert_allclose(cards, [ca.sum(), cb.sum()], rtol=1e-6)


def test_probminhash_probability_jaccard_accuracy():
    rng = np.random.default_rng(4)
    m = 2048
    a, ca, b, cb, _ = _weighted_sets(rng)
    awm = {int(i): w for i, w in zip(a, ca)}
    bwm = {int(i): w for i, w in zip(b, cb)}
    keys = set(awm) & set(bwm)
    jp = 0.0
    for d in keys:
        denom = sum(max(awm.get(q, 0.0) / awm[d], bwm.get(q, 0.0) / bwm[d])
                    for q in set(awm) | set(bwm))
        jp += 1.0 / denom
    sigs, _ = probminhash_many([a, b], [ca, cb], m)
    est = (sigs[0] == sigs[1]).mean()
    tol = 4 * np.sqrt(jp * (1 - jp) / m) + 1e-3
    assert abs(est - jp) < tol, (est, jp, tol)


def _estimator_reps(fn, rng, weights_a, weights_b, m, reps):
    """Estimator samples over `reps` independent sketch repetitions.
    The engines are deterministic keyed by item hash, so fresh random
    item ids per repetition = a fresh RNG stream (same ground truth:
    the Jaccard values depend only on the weights)."""
    n_items = len(weights_a)
    streams, lnws = [], []
    for _ in range(reps):
        ids = rng.choice(1 << 62, size=n_items,
                         replace=False).astype(np.uint64)
        ka, kb = weights_a > 0, weights_b > 0
        streams += [ids[ka], ids[kb]]
        lnws += [weights_a[ka], weights_b[kb]]
    sigs, _ = fn(streams, lnws, m)
    return np.array([(sigs[2 * r] == sigs[2 * r + 1]).mean()
                     for r in range(reps)])


def test_estimator_variance_matches_ertl_bound():
    """Measured justification: the per-register
    collision probability of the ICWS/PMH1 engines is exactly J_W/J_P
    with i.i.d. registers, so the m-register equality-fraction
    estimator must have variance J(1-J)/m — the same bound Ertl proves
    for BagMinHash (Alg. family, IEEE TKDE 2020, Sec. 3) and
    ProbMinHash (Thm 2). Measured over 48 independent repetitions; the
    chi-square 99.9% envelope for the sample variance at df=47 is
    [0.45, 1.9]x."""
    rng = np.random.default_rng(12)
    n_items, m, reps = 200, 256, 48
    wa = rng.gamma(2.0, 2.0, size=n_items)
    wb = wa.copy()
    flip = rng.random(n_items) > 0.5
    wb[flip] = rng.gamma(2.0, 2.0, size=int(flip.sum()))
    jw = np.minimum(wa, wb).sum() / np.maximum(wa, wb).sum()
    est = _estimator_reps(bagminhash_many, rng, wa, wb, m, reps)
    mean, var = est.mean(), est.var(ddof=1)
    bound = jw * (1 - jw) / m
    assert abs(mean - jw) < 4 * np.sqrt(bound / reps) + 1e-3, (mean, jw)
    assert 0.45 * bound < var < 1.9 * bound, (var, bound)
    # ProbMinHash: J_P ground truth for full-support weight vectors
    denom_terms = np.maximum(wa[None, :] / wa[:, None],
                             wb[None, :] / wb[:, None]).sum(axis=1)
    jp = float((1.0 / denom_terms).sum())
    est_p = _estimator_reps(probminhash_many, rng, wa, wb, m, reps)
    mean_p, var_p = est_p.mean(), est_p.var(ddof=1)
    bound_p = jp * (1 - jp) / m
    assert abs(mean_p - jp) < 4 * np.sqrt(bound_p / reps) + 1e-3, \
        (mean_p, jp)
    assert 0.45 * bound_p < var_p < 1.9 * bound_p, (var_p, bound_p)


def test_disjoint_and_identical_sets():
    rng = np.random.default_rng(5)
    m = 512
    ids1 = rng.choice(1 << 62, size=100, replace=False).astype(np.uint64)
    ids2 = (ids1 + np.uint64(1 << 62)).astype(np.uint64)
    w = rng.gamma(2.0, 1.0, size=100)
    sigs, _ = bagminhash_many([ids1, ids1, ids2], [w, w, w], m)
    assert (sigs[0] == sigs[1]).all()          # identical weighted sets
    assert (sigs[0] == sigs[2]).mean() < 0.05  # disjoint
    psigs, _ = probminhash_many([ids1, ids1, ids2], [w, w, w], m)
    assert (psigs[0] == psigs[1]).all()
    assert (psigs[0] == psigs[2]).mean() < 0.05


def test_batched_rows_equal_per_item_calls():
    """The row-batched engine must give layout-independent registers:
    sketching items together in one _sketch_many_streams pass equals
    sketching each alone (consistency requirement of ICWS/PMH — the
    winner per (item, register) is a pure function of the stream)."""
    from dashing2_tpu.sketch import weighted as W

    rng = np.random.default_rng(21)
    m = 64
    uniq, counts = [], []
    for i in range(9):
        k = int(rng.integers(1, 5000))
        uniq.append(rng.integers(1, 1 << 62, size=k).astype(np.uint64))
        counts.append(rng.integers(1, 50, size=k).astype(np.float64))
    for many in (W.bagminhash_many, W.probminhash_many):
        sigs, cards = many(uniq, counts, m)
        for i in range(9):
            solo, _ = many([uniq[i]], [counts[i]], m)
            np.testing.assert_array_equal(sigs[i], solo[0])
        np.testing.assert_allclose(
            cards, [c.sum() for c in counts])


def test_batched_1024_items_fast():
    """A 1024-item weighted corpus must sketch
    in bounded time through the batched engine (was a per-item dispatch
    loop)."""
    import time

    from dashing2_tpu.sketch import weighted as W

    rng = np.random.default_rng(22)
    m = 64
    uniq = [rng.integers(1, 1 << 62, size=200).astype(np.uint64)
            for _ in range(1024)]
    counts = [rng.integers(1, 9, size=200).astype(np.float64)
              for _ in range(1024)]
    t0 = time.perf_counter()
    sigs, cards = W.probminhash_many(uniq, counts, m)
    dt = time.perf_counter() - t0
    assert sigs.shape == (1024, m)
    assert (sigs > 0).all() and (sigs < 1).all()
    assert dt < 60, f"batched weighted sketch too slow: {dt:.1f}s"


def test_countsketch_device_engine_matches_dense():
    """Device sort+cumsum CountSketch == the dense np.add.at
    formulation (counter.h bucket semantics), incl. sign cancellation."""
    from dashing2_tpu.ops import sketch_kernels as SK

    rng = np.random.default_rng(33)
    for K, cs in [(10000, 997), (5000, 1 << 16), (1, 13), (0, 13)]:
        hv = rng.integers(0, 1 << 62, size=K).astype(np.uint64)
        u, c = SK.countsketch_counts(hv, cs)
        b = np.zeros(cs, np.float64)
        np.add.at(b, (hv % np.uint64(cs)).astype(np.int64),
                  np.where((hv & np.uint64(1)).astype(bool), 1.0, -1.0))
        nz = np.nonzero(b)[0]
        assert np.array_equal(u, nz.astype(np.uint64))
        assert np.array_equal(c, np.abs(b[nz]))
