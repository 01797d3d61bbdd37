"""64-bit unsigned integer arithmetic as u32 limb pairs for device kernels.

XLA emulates u64 on 32-bit vector units; kernels that want explicit
control use 32-bit limb arithmetic. A u64 array is represented as a pair
``(hi, lo)`` of ``uint32`` arrays of equal shape. All shift amounts and
multiplier constants are Python ints (static), which lets each helper emit
the minimal op sequence.

These mirror the host-side numpy semantics in dashing2_tpu.hashing and are
validated against it bit-for-bit in tests/test_u64_ops.py.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

U32Pair = Tuple[jnp.ndarray, jnp.ndarray]

_MASK16 = 0xFFFF


def _u32(c: int) -> jnp.ndarray:
    return jnp.uint32(c & 0xFFFFFFFF)


def from_u64(x) -> U32Pair:
    """Split a (numpy/jnp) uint64 array into (hi, lo) uint32 limbs."""
    x = jnp.asarray(x, dtype=jnp.uint64)
    return (x >> jnp.uint64(32)).astype(jnp.uint32), x.astype(jnp.uint32)


def to_u64(pair: U32Pair) -> jnp.ndarray:
    hi, lo = pair
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)


def const(c: int, shape=()) -> U32Pair:
    hi = jnp.full(shape, (c >> 32) & 0xFFFFFFFF, dtype=jnp.uint32)
    lo = jnp.full(shape, c & 0xFFFFFFFF, dtype=jnp.uint32)
    return hi, lo


def xor(a: U32Pair, b: U32Pair) -> U32Pair:
    return a[0] ^ b[0], a[1] ^ b[1]


def xor_const(a: U32Pair, c: int) -> U32Pair:
    return a[0] ^ _u32(c >> 32), a[1] ^ _u32(c)


def bnot(a: U32Pair) -> U32Pair:
    return ~a[0], ~a[1]


def band(a: U32Pair, b: U32Pair) -> U32Pair:
    return a[0] & b[0], a[1] & b[1]


def shl(a: U32Pair, s: int) -> U32Pair:
    hi, lo = a
    if s == 0:
        return a
    if s >= 64:
        z = jnp.zeros_like(lo)
        return z, z
    if s == 32:
        return lo, jnp.zeros_like(lo)
    if s > 32:
        return lo << _u32(s - 32), jnp.zeros_like(lo)
    return (hi << _u32(s)) | (lo >> _u32(32 - s)), lo << _u32(s)


def shr(a: U32Pair, s: int) -> U32Pair:
    hi, lo = a
    if s == 0:
        return a
    if s >= 64:
        z = jnp.zeros_like(hi)
        return z, z
    if s == 32:
        return jnp.zeros_like(hi), hi
    if s > 32:
        return jnp.zeros_like(hi), hi >> _u32(s - 32)
    return hi >> _u32(s), (lo >> _u32(s)) | (hi << _u32(32 - s))


def add(a: U32Pair, b: U32Pair) -> U32Pair:
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(jnp.uint32)
    return a[0] + b[0] + carry, lo


def add_const(a: U32Pair, c: int) -> U32Pair:
    return add(a, (jnp.uint32((c >> 32) & 0xFFFFFFFF),
                   jnp.uint32(c & 0xFFFFFFFF)))


def sub(a: U32Pair, b: U32Pair) -> U32Pair:
    lo = a[1] - b[1]
    borrow = (a[1] < b[1]).astype(jnp.uint32)
    return a[0] - b[0] - borrow, lo


def _mul32_full(a: jnp.ndarray, b: jnp.ndarray) -> U32Pair:
    """32x32 -> 64 multiply via 16-bit halves (returns hi, lo u32)."""
    a0 = a & _u32(_MASK16)
    a1 = a >> _u32(16)
    b0 = b & _u32(_MASK16)
    b1 = b >> _u32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> _u32(16)) + (p10 & _u32(_MASK16)) + (p01 & _u32(_MASK16))
    lo = (p00 & _u32(_MASK16)) | (mid << _u32(16))
    hi = p11 + (p10 >> _u32(16)) + (p01 >> _u32(16)) + (mid >> _u32(16))
    return hi, lo


def mul(a: U32Pair, b: U32Pair) -> U32Pair:
    """Low 64 bits of a 64x64 multiply."""
    ahi, alo = a
    bhi, blo = b
    hi, lo = _mul32_full(alo, blo)
    hi = hi + alo * bhi + ahi * blo
    return hi, lo


def mul_const(a: U32Pair, c: int) -> U32Pair:
    if c == 0:
        z = jnp.zeros_like(a[0])
        return z, z
    if c & (c - 1) == 0:  # power of two
        return shl(a, c.bit_length() - 1)
    return mul(a, (jnp.uint32((c >> 32) & 0xFFFFFFFF),
                   jnp.uint32(c & 0xFFFFFFFF)))


def mul_wide(a: U32Pair, b: U32Pair) -> Tuple[U32Pair, U32Pair]:
    """Full 64x64 -> 128 multiply; returns (hi64 pair, lo64 pair).

    Accumulates the four 32x32 partial products limb by limb:
      limb0 = l00
      limb1 = h00 + l01 + l10            (carries into limb2)
      limb2 = h01 + h10 + l11 + carry1   (carries into limb3)
      limb3 = h11 + carry2
    """
    ahi, alo = a
    bhi, blo = b
    h00, l00 = _mul32_full(alo, blo)
    h01, l01 = _mul32_full(alo, bhi)
    h10, l10 = _mul32_full(ahi, blo)
    h11, l11 = _mul32_full(ahi, bhi)
    s1a = h00 + l01
    c1 = (s1a < h00).astype(jnp.uint32)
    limb1 = s1a + l10
    c1 = c1 + (limb1 < s1a).astype(jnp.uint32)
    s2a = h01 + h10
    c2 = (s2a < h01).astype(jnp.uint32)
    s2b = s2a + l11
    c2 = c2 + (s2b < s2a).astype(jnp.uint32)
    limb2 = s2b + c1
    c2 = c2 + (limb2 < s2b).astype(jnp.uint32)
    limb3 = h11 + c2
    return (limb3, limb2), (limb1, l00)


def eq(a: U32Pair, b: U32Pair) -> jnp.ndarray:
    return (a[0] == b[0]) & (a[1] == b[1])


def gt(a: U32Pair, b: U32Pair) -> jnp.ndarray:
    return (a[0] > b[0]) | ((a[0] == b[0]) & (a[1] > b[1]))


def lt(a: U32Pair, b: U32Pair) -> jnp.ndarray:
    return gt(b, a)


def mod_small(a: U32Pair, m: int) -> jnp.ndarray:
    """a mod m for small m (< 2^20), exact, returned as uint32.

    Uses (hi*2^32 + lo) mod m = ((hi mod m)*(2^32 mod m) + lo mod m) mod m
    with the middle product carried out in f64 (exact: < 2^40 + 2^32 <
    2^53). This replaces the reference's Schismatic fast-mod
    (src/oph.h:114,184) with an identical result.
    """
    hi, lo = a
    two32_mod = (1 << 32) % m
    t = (hi % _u32(m)).astype(jnp.float64) * float(two32_mod) + \
        (lo % _u32(m)).astype(jnp.float64)
    return jnp.mod(t, float(m)).astype(jnp.uint32)


def to_unit_float(a: U32Pair) -> jnp.ndarray:
    """Map u64 -> (0, 1] double: (x + 1) * 2^-64-ish.

    Matches the reference's ``rv * INVMUL64`` (x * 2^-64,
    setsketch.h:114-119,387) which yields 0 for x == 0; callers that feed
    this into log() must handle x == 0. We compute x * 2^-64 exactly in f64
    rounding (hi*2^-32 + lo*2^-64).
    """
    hi, lo = a
    return hi.astype(jnp.float64) * (2.0 ** -32) + \
        lo.astype(jnp.float64) * (2.0 ** -64)
