"""Similarity/distance estimators applied to pairwise count matrices.

Vectorized re-derivation of the per-pair logic in compare()
(/root/reference/src/cmp_core.cpp:349-517). Every function takes count
matrices (int32, shape (N, M)) plus cardinality vectors and returns the
final measure matrix in float64 (callers emit float32).

Cardinality conventions: lhcard/rhcard must be pre-broadcast to the count
matrices' shape (callers pass lh[:, None], rh[None, :] for matrices, or
flat per-pair vectors). lhcard is the row/left item, rhcard the
column/right item. Note the reference's asymmetric quirks are kept:
the full-register SET path divides CONTAINMENT by the *column* cardinality
(cmp_core.cpp:484) while the compressed/equality paths divide by the *row*
cardinality (cmp_core.cpp:419,443,511).
"""

from __future__ import annotations

import numpy as np

from ..enums import Measure

FINF = np.float64(np.finfo(np.float32).max)


def sim2dist(x: np.ndarray, k: int, xp=np) -> np.ndarray:
    """Mash/Poisson distance transform (cmp_core.cpp:361):
    -log(2x / (1+x)) / k, +inf at x == 0."""
    pm = -1.0 / max(1, k)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = xp.where(x > 0, xp.log(2.0 * x / (1.0 + x)) * pm, xp.inf)
    return out


def g_b(b: float, arg: np.ndarray, xp=np) -> np.ndarray:
    """SetSketch truncation correction (cmp_core.cpp:323-325):
    (1 - b^-arg) / (1 - 1/b)."""
    return (1.0 - xp.power(b, -arg)) / (1.0 - 1.0 / b)


def _finalize(ret: np.ndarray, xp=np) -> np.ndarray:
    """NaN/inf -> max float (cmp_core.cpp:573)."""
    if xp is not np:
        out = xp.asarray(ret, dtype=xp.float64)
        return xp.where(xp.isfinite(out), out, FINF)
    out = np.asarray(ret, dtype=np.float64)
    bad = ~np.isfinite(out)
    if bad.any():
        out = np.where(bad, FINF, out)
    return out


def full_setsketch_measures(gt: np.ndarray, lt: np.ndarray, m: int,
                            lhcard: np.ndarray, rhcard: np.ndarray,
                            measure: Measure, k: int, xp=np) -> np.ndarray:
    """Full-register SET-space estimator (cmp_core.cpp:458-494).

    alpha = gt/m, beta = lt/m, eq = 1-alpha-beta,
    ucard = max((lh+rh)/(2-alpha-beta), 0).
    """
    invm = 1.0 / m
    alpha = gt * invm
    beta = lt * invm
    eq = 1.0 - alpha - beta
    lh = xp.asarray(lhcard)
    rh = xp.asarray(rhcard)
    with np.errstate(divide="ignore", invalid="ignore"):
        ucard = xp.maximum((lh + rh) / (2.0 - alpha - beta), 0.0)
        eq = xp.where(eq <= 1e-15, 0.0, eq)
        isz = ucard * eq
        if measure == Measure.SIMILARITY:
            ret = eq
        elif measure == Measure.INTERSECTION:
            ret = isz
        elif measure == Measure.CONTAINMENT:
            ret = isz / rh
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = isz / xp.minimum(lh, rh)
        elif measure == Measure.POISSON_LLR:
            ret = sim2dist(eq, k, xp)
        elif measure == Measure.UNION_SIZE:
            ret = lh + rh - isz
        else:
            raise ValueError(f"measure {measure} invalid here")
        # eq <= 0 -> 0 similarity (or max distance) (cmp_core.cpp:473-475)
        zero_mask = (1.0 - alpha - beta) <= 0
        if measure == Measure.POISSON_LLR:
            ret = xp.where(zero_mask, xp.inf, ret)
        else:
            ret = xp.where(zero_mask, 0.0, ret)
    return _finalize(ret, xp)


def equality_measures(eqc: np.ndarray, m: int, lhcard: np.ndarray,
                      rhcard: np.ndarray, measure: Measure, k: int, xp=np
                      ) -> np.ndarray:
    """Equality-fraction estimator for MULTISET/PSET/full-register-kmer
    paths (cmp_core.cpp:495-517): sim = eq/m, union = (lh+rh)/(1+sim)."""
    sim = eqc / m
    lh = xp.asarray(lhcard)
    rh = xp.asarray(rhcard)
    with np.errstate(divide="ignore", invalid="ignore"):
        ucard = xp.maximum((lh + rh) / (1.0 + sim), 0.0)
        if measure == Measure.SIMILARITY:
            ret = sim
        elif measure == Measure.INTERSECTION:
            ret = sim * ucard
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = sim * ucard / xp.minimum(lh, rh)
        elif measure == Measure.CONTAINMENT:
            ret = sim * ucard / lh
        elif measure == Measure.POISSON_LLR:
            ret = sim2dist(sim, k, xp)
        elif measure == Measure.UNION_SIZE:
            ret = lh + rh - sim * ucard
        else:
            raise ValueError(f"measure {measure} invalid here")
    return _finalize(ret, xp)


def bbit_measures(eqc: np.ndarray, m: int, fd_level: float,
                  lhcard: np.ndarray, rhcard: np.ndarray,
                  measure: Measure, k: int, xp=np) -> np.ndarray:
    """b-bit compressed estimator (cmp_core.cpp:406-423): collision-corrected
    similarity ret = max(0, (eq/m + b2pow) / (1 + b2pow)),
    b2pow = -2^-(8*fd)."""
    b2pow = -np.ldexp(1.0, -int(fd_level * 8))
    sim = xp.maximum(0.0, (eqc / m + b2pow) / (1.0 + b2pow))
    lh = xp.asarray(lhcard)
    rh = xp.asarray(rhcard)
    with np.errstate(divide="ignore", invalid="ignore"):
        if measure in (Measure.INTERSECTION, Measure.UNION_SIZE):
            isz = xp.maximum((lh + rh) / (1.0 + sim), 0.0)
            ret = isz if measure == Measure.INTERSECTION else lh + rh - isz
        elif measure == Measure.CONTAINMENT:
            ret = xp.maximum((lh + rh) / (1.0 + sim), 0.0) * sim / lh
        elif measure == Measure.POISSON_LLR:
            ret = sim2dist(sim, k, xp)
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = xp.maximum((lh + rh) / (1.0 + sim), 0.0) * sim / xp.minimum(lh, rh)
        else:  # SIMILARITY
            ret = sim
    return _finalize(ret, xp)


def compressed_ab_measures(gt: np.ndarray, lt: np.ndarray, m: int,
                           b: float, fd_level: float,
                           lhcard: np.ndarray, rhcard: np.ndarray,
                           measure: Measure, k: int,
                           reg_bytes: float = 8.0, xp=np) -> np.ndarray:
    """Setsketch-compressed (a,b-quantized) estimator
    (cmp_core.cpp:424-449): g_b-corrected alpha/beta, union from
    cardinalities, similarity = max(1 - alpha - beta, 0)."""
    invm = 1.0 / m
    alpha = gt * invm
    beta = lt * invm
    if fd_level < reg_bytes:
        alpha = g_b(b, alpha, xp)
        beta = g_b(b, beta, xp)
    lh = xp.asarray(lhcard)
    rh = xp.asarray(rhcard)
    with np.errstate(divide="ignore", invalid="ignore"):
        disjoint = (alpha + beta) >= 1.0
        mu = xp.where(disjoint, lh + rh,
                      xp.maximum((lh + rh) / (2.0 - alpha - beta), 0.0))
        ret = xp.maximum(1.0 - alpha - beta, 0.0)
        if measure == Measure.INTERSECTION:
            ret = ret * mu
        elif measure == Measure.UNION_SIZE:
            ret = lh + rh - ret * mu
        elif measure == Measure.CONTAINMENT:
            ret = ret * mu / lh
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = ret * mu / xp.minimum(lh, rh)
        elif measure == Measure.POISSON_LLR:
            ret = sim2dist(ret, k, xp)
    return _finalize(ret, xp)


def gb_bit_table(b: float, m: int) -> np.ndarray:
    """(2, nbits) f32 constants for the bit-selected g_b power: row 0
    holds c_k = b^(-2^k / m) (the bit-PRODUCT form: for an integer
    count c, b^(-c/m) = prod_k c_k^{bit_k(c)}), row 1 holds the
    COMPLEMENTS u_k = 1 - c_k. The constants are computed once in f64
    on the host; both evaluation forms below are pure f32 IEEE
    arithmetic, so every backend produces identical bits (unlike
    pow/exp, whose implementations differ between numpy and XLA).

    The complement row exists because quantized SetSketch b values
    approach 1 as the register widens (fd=4 -> b - 1 ~ 2.7e-10,
    cmp_core.cpp:248 q-table): c_k then rounds to 1.0f and the product
    form collapses, while u_k ~ 2^k ln(b)/m stays fully accurate."""
    nbits = max(1, int(m).bit_length())
    pows = np.array([np.power(np.float64(b), -(float(1 << k) / m))
                     for k in range(nbits)], dtype=np.float64)
    return np.stack([pows.astype(np.float32),
                     (1.0 - pows).astype(np.float32)])


def _pow_b_neg32(counts, table: np.ndarray, xp=np):
    """b^(-c/m) for integer count arrays via the bit-product table
    (row 0 of gb_bit_table)."""
    c = counts.astype(np.int32) if xp is np else counts.astype("int32")
    r = xp.full(c.shape, np.float32(1.0), dtype=np.float32)
    one = np.float32(1.0)
    row = table[0]
    for k in range(table.shape[-1]):
        bit = ((c >> k) & 1).astype(bool)
        r = r * xp.where(bit, row[k], one)
    return r


def _one_minus_pow_b32(counts, table: np.ndarray, xp=np):
    """q = 1 - b^(-c/m) via the complement recurrence q' = q + u_k(1-q)
    over the set bits of c (row 1 of gb_bit_table) — accurate for b
    arbitrarily close to 1, still pure f32 IEEE arithmetic."""
    c = counts.astype(np.int32) if xp is np else counts.astype("int32")
    q = xp.zeros(c.shape, dtype=np.float32)
    zero = np.float32(0.0)
    one = np.float32(1.0)
    row = table[1]
    for k in range(table.shape[-1]):
        bit = ((c >> k) & 1).astype(bool)
        u = xp.where(bit, row[k], zero)
        q = q + u * (one - q)
    return q


def compressed_ab_measures32(gtc, ltc, m: int, b: float, fd_level: float,
                             lhcard, rhcard, measure: Measure, k: int,
                             reg_bytes: float = 8.0, xp=np,
                             table=None, gbinv=None,
                             gb_form: str = "product"):
    """f32 variant of compressed_ab_measures operating on integer gt/lt
    COUNT matrices, used for every a/b-quantized fastcmp path (README
    deviation: f32 estimator epilogues).
    g_b evaluates one of two bit-selected forms:

    * gb_form='product' (the nibble path): bit-PRODUCT of c_k — pure
      f32 multiplies with NO contractible add-of-product, so XLA's
      excess-precision FMA fusion cannot perturb it and every graph
      shape produces identical bits (the per-tile fused route and the
      full-square route must agree exactly). Valid while c_k stays
      representable (b - 1 >~ 1e-3; nibble's q=15.4 gives b ~ 1.07).
    * gb_form='complement' (u8/u16/u32 'ab' kinds): the recurrence
      q' = q + u_k(1-q) over set bits — accurate for b arbitrarily
      close to 1 (fd=4's b - 1 ~ 2.7e-10 underflows the product form)
      but FMA-contractible, so different graph shapes may differ in
      the last ulp.

    Relative deviation from the f64 form is <= ~1e-6 — far below the
    m=1024 sketch estimator noise.

    Pass (table, gbinv) explicitly inside jits where b is traced
    (gb_bit_table needs a concrete b)."""
    f32 = np.float32
    if fd_level < reg_bytes:
        if table is None:
            table = gb_bit_table(b, m)
            gbinv = f32(1.0 / (1.0 - 1.0 / np.float64(b)))
        if gb_form == "product":
            alpha = (f32(1.0) - _pow_b_neg32(gtc, table, xp)) * gbinv
            beta = (f32(1.0) - _pow_b_neg32(ltc, table, xp)) * gbinv
        else:
            alpha = _one_minus_pow_b32(gtc, table, xp) * gbinv
            beta = _one_minus_pow_b32(ltc, table, xp) * gbinv
        ab = alpha + beta
        # (alpha + beta) first: f32 addition is commutative, so the
        # expression is invariant under the (alpha, lh) <-> (beta, rh)
        # swap — required for upper-triangle tiles to be EXACTLY the
        # transposed lower tiles in the per-tile fused path
    else:
        # fd >= 8: no g_b — sum the INTEGER counts before the one f32
        # scale, so any (gt', lt') with gt' + lt' = gt + lt (e.g. the
        # eq-only engines' (m - eq, 0)) yields identical bits
        invm = f32(1.0 / m)
        ab = (gtc + ltc).astype(np.float32) * invm
    lh = xp.asarray(lhcard).astype(np.float32)
    rh = xp.asarray(rhcard).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        disjoint = ab >= f32(1.0)
        mu = xp.where(disjoint, lh + rh,
                      xp.maximum((lh + rh) / (f32(2.0) - ab), f32(0.0)))
        ret = xp.maximum(f32(1.0) - ab, f32(0.0))
        if measure == Measure.INTERSECTION:
            ret = ret * mu
        elif measure == Measure.UNION_SIZE:
            ret = lh + rh - ret * mu
        elif measure == Measure.CONTAINMENT:
            ret = ret * mu / lh
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = ret * mu / xp.minimum(lh, rh)
        elif measure == Measure.POISSON_LLR:
            pm = f32(-1.0 / max(1, k))
            # log1p form: 2r/(1+r) = 1 - ab/(2-ab) for r = 1-ab
            ret = xp.where(ret > 0,
                           xp.log1p(-ab / (f32(2.0) - ab)) * pm,
                           f32(np.inf))
    ret = ret.astype(np.float32)
    return xp.where(xp.isfinite(ret), ret, f32(FINF))


def bbit_measures32(eqc, m: int, fd_level: float, lhcard, rhcard,
                    measure: Measure, k: int, xp=np):
    """f32 variant of bbit_measures on integer eq COUNT matrices (same
    rationale as compressed_ab_measures32).

    sim is evaluated in the cleared-denominator integer form
    (eqc*2^b - m) / (m*(2^b - 1)) rather than the reference's
    (eqc/m - 2^-b)/(1 - 2^-b): the latter in f32 cancels
    catastrophically when eqc/m ~ 2^-b (the random-collision floor,
    i.e. exactly the small-sim regime POISSON_LLR amplifies — measured
    30 ulp vs the long-double oracle, tests/test_ld_oracle.py). In the
    integer form eqc*2^b is EXACT (power-of-two scale), the subtraction
    of exacts is correctly rounded, and exact products keep FMA
    contraction bit-identical to the unfused graph — ulp-level vs the
    oracle at every fd, same bits on every backend/engine."""
    f32 = np.float32
    scale = f32(np.ldexp(1.0, int(fd_level * 8)))
    den = f32(np.float64(m) * (np.ldexp(1.0, int(fd_level * 8)) - 1.0))
    sim = xp.maximum(f32(0.0),
                     (eqc.astype(np.float32) * scale - f32(m)) / den)
    # sim - 1 from exact integers ((eqc - m)*2^b is exact): feeds the
    # log1p POISSON_LLR form, which does not amplify rounding near
    # sim -> 1 the way log(2s/(1+s)) does (measured 24 -> <=2 ulp vs
    # the long-double oracle)
    simm1 = xp.minimum(
        f32(0.0), (eqc.astype(np.float32) - f32(m)) * scale / den)
    lh = xp.asarray(lhcard).astype(np.float32)
    rh = xp.asarray(rhcard).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if measure in (Measure.INTERSECTION, Measure.UNION_SIZE):
            isz = xp.maximum((lh + rh) / (f32(1.0) + sim), f32(0.0))
            ret = isz if measure == Measure.INTERSECTION else lh + rh - isz
        elif measure == Measure.CONTAINMENT:
            ret = xp.maximum((lh + rh) / (f32(1.0) + sim), f32(0.0)) \
                * sim / lh
        elif measure == Measure.POISSON_LLR:
            pm = f32(-1.0 / max(1, k))
            # log1p form: 2s/(1+s) = 1 + (s-1)/(1+s); log() of an
            # argument near 1 amplifies its rounding ~1/|log| -fold
            ret = xp.where(sim > 0,
                           xp.log1p(simm1 / (f32(1.0) + sim)) * pm,
                           f32(np.inf))
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = xp.maximum((lh + rh) / (f32(1.0) + sim), f32(0.0)) \
                * sim / xp.minimum(lh, rh)
        else:
            ret = sim
    ret = ret.astype(np.float32)
    return xp.where(xp.isfinite(ret), ret, f32(FINF))


def full_setsketch_measures32(gt, lt, m: int, lhcard, rhcard,
                              measure: Measure, k: int, xp=np):
    """f32 variant of full_setsketch_measures on integer gt/lt COUNT
    matrices — the DEFAULT mode's production epilogue (the emitted
    matrix is f32 anyway). (gt + lt) sums first so
    tiles and their transposes commute exactly in the per-tile fused
    path."""
    f32 = np.float32
    s = (gt + lt).astype(np.float32) * f32(1.0 / m)   # alpha + beta
    eq = f32(1.0) - s
    lh = xp.asarray(lhcard).astype(np.float32)
    rh = xp.asarray(rhcard).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ucard = xp.maximum((lh + rh) / (f32(2.0) - s), f32(0.0))
        eqv = xp.where(eq <= f32(1e-15), f32(0.0), eq)
        isz = ucard * eqv
        if measure == Measure.SIMILARITY:
            ret = eqv
        elif measure == Measure.INTERSECTION:
            ret = isz
        elif measure == Measure.CONTAINMENT:
            ret = isz / rh
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = isz / xp.minimum(lh, rh)
        elif measure == Measure.POISSON_LLR:
            pm = f32(-1.0 / max(1, k))
            # log1p form: 2e/(1+e) = 1 - s/(2-s) for e = 1-s (see
            # bbit_measures32)
            ret = xp.where(eqv > 0,
                           xp.log1p(-s / (f32(2.0) - s)) * pm,
                           f32(np.inf))
        elif measure == Measure.UNION_SIZE:
            ret = lh + rh - isz
        else:
            raise ValueError(f"measure {measure} invalid here")
        zero_mask = eq <= f32(0.0)
        if measure == Measure.POISSON_LLR:
            ret = xp.where(zero_mask, f32(np.inf), ret)
        else:
            ret = xp.where(zero_mask, f32(0.0), ret)
    ret = ret.astype(np.float32)
    return xp.where(xp.isfinite(ret), ret, f32(FINF))


def equality_measures32(eqc, m: int, lhcard, rhcard, measure: Measure,
                        k: int, xp=np):
    """f32 variant of equality_measures on integer eq COUNT matrices
    (same rationale as full_setsketch_measures32)."""
    f32 = np.float32
    sim = eqc.astype(np.float32) * f32(1.0 / m)
    lh = xp.asarray(lhcard).astype(np.float32)
    rh = xp.asarray(rhcard).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ucard = xp.maximum((lh + rh) / (f32(1.0) + sim), f32(0.0))
        if measure == Measure.SIMILARITY:
            ret = sim
        elif measure == Measure.INTERSECTION:
            ret = sim * ucard
        elif measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = sim * ucard / xp.minimum(lh, rh)
        elif measure == Measure.CONTAINMENT:
            ret = sim * ucard / lh
        elif measure == Measure.POISSON_LLR:
            pm = f32(-1.0 / max(1, k))
            # log1p form with sim-1 from the exact integer (eqc - m)
            simm1 = (eqc.astype(np.float32) - f32(m)) * f32(1.0 / m)
            ret = xp.where(sim > 0,
                           xp.log1p(simm1 / (f32(1.0) + sim)) * pm,
                           f32(np.inf))
        elif measure == Measure.UNION_SIZE:
            ret = lh + rh - sim * ucard
        else:
            raise ValueError(f"measure {measure} invalid here")
    ret = ret.astype(np.float32)
    return xp.where(xp.isfinite(ret), ret, f32(FINF))


def exact_measures(isz: np.ndarray, lhcard: np.ndarray, rhcard: np.ndarray,
                   measure: Measure, k: int) -> np.ndarray:
    """Exact-mode correction (cmp_core.cpp:519-526 CORRECT_RES): from true
    intersection sizes and cardinalities."""
    lh = np.asarray(lhcard)
    rh = np.asarray(rhcard)
    with np.errstate(divide="ignore", invalid="ignore"):
        if measure == Measure.SYMMETRIC_CONTAINMENT:
            ret = isz / np.minimum(lh, rh)
        elif measure in (Measure.POISSON_LLR, Measure.SIMILARITY):
            ret = isz / (lh + rh - isz)
            if measure == Measure.POISSON_LLR:
                ret = sim2dist(ret, k)
        elif measure == Measure.CONTAINMENT:
            ret = isz / lh
        elif measure == Measure.INTERSECTION:
            ret = isz
        elif measure == Measure.UNION_SIZE:
            ret = lh + rh - isz
        else:
            ret = isz
    return _finalize(ret)


def brent_find_minima(func, a: float, b: float, bits: int = 24,
                      maxiter: int = 200) -> tuple[float, float]:
    """Brent's method minimizer on [a, b] (setsketch.h:34-86 /
    boost::math::tools::brent_find_minima equivalent)."""
    golden = 0.3819660112501051
    tol = 2.0 ** (1 - bits)
    x = w = v = a + golden * (b - a)
    fx = fw = fv = func(x)
    dd = e = 0.0
    for _ in range(maxiter):
        mid = 0.5 * (a + b)
        # boost's absolute floor is tolerance/4, NOT a denormal guard:
        # with a tiny floor the test below can never fire for minima
        # near x == 0 and every call burns all maxiter evaluations
        tol1 = tol * abs(x) + tol * 0.25
        tol2 = 2.0 * tol1
        if abs(x - mid) <= tol2 - 0.5 * (b - a):
            break
        use_golden = True
        if abs(e) > tol1:
            r = (x - w) * (fx - fv)
            q_ = (x - v) * (fx - fw)
            p = (x - v) * q_ - (x - w) * r
            q_ = 2.0 * (q_ - r)
            if q_ > 0:
                p = -p
            q_ = abs(q_)
            etemp = e
            e = dd
            if (abs(p) < abs(0.5 * q_ * etemp) and p > q_ * (a - x)
                    and p < q_ * (b - x)):
                dd = p / q_
                u = x + dd
                if (u - a) < tol2 or (b - u) < tol2:
                    dd = tol1 if x < mid else -tol1
                use_golden = False
        if use_golden:
            e = (b if x < mid else a) - x
            dd = golden * e
        u = x + (dd if abs(dd) >= tol1 else (tol1 if dd > 0 else -tol1))
        fu = func(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def jmle_simple(lhgt: int, rhgt: int, m: int, lhest: float, rhest: float,
                base: float) -> float:
    """Joint maximum-likelihood Jaccard from a SetSketch register pair's
    (gt, lt) counts and cardinality estimates (setsketch.h:93-112,
    used by SetSketch::jaccard_by_mle :810). Brent-minimizes the negative
    log-likelihood over J in [0, min/max]."""
    if not lhest and not rhest:
        return 0.0
    neq = m - (lhgt + rhgt)
    sumest = lhest + rhest
    bi = 1.0 / base
    lbi = 1.0 / np.log(base)
    z = (1.0 - bi) / sumest

    def func(jaccard):
        with np.errstate(divide="ignore", invalid="ignore"):
            lhs = (lbi * np.log1p((rhest * jaccard - lhest) * z)
                   if (neq or lhgt) else 0.0)
            rhs = (lbi * np.log1p((lhest * jaccard - rhest) * z)
                   if (neq or rhgt) else 0.0)
            ret = 0.0
            if neq:
                ret += neq * np.log1p(lhs + rhs)
            if lhgt:
                ret += lhgt * np.log(-lhs)
            if rhgt:
                ret += rhgt * np.log(-rhs)
        if np.isnan(ret):
            return np.finfo(np.float64).max
        return -ret

    hi = min(lhest, rhest) / max(lhest, rhest)
    return brent_find_minima(func, 0.0, hi, 24)[0]


def optimal_parameters(minreg: float, maxreg: float, q: float
                       ) -> tuple[float, float]:
    """SetSketch (b, a) for a register value range (setsketch.cpp:7-10):
    b = exp(log(max/min)/q), a = max/b."""
    if maxreg < minreg:
        minreg, maxreg = maxreg, minreg
    b = float(np.exp(np.log(maxreg / minreg) / q))
    a = maxreg / b
    return b, a
