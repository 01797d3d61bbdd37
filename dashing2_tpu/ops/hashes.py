"""Device (jnp) implementations of the 64-bit hash chain.

Primary forms take/return ``jnp.uint64`` arrays (XLA lowers u64 element ops
to 32-bit limb sequences).
Limb forms (suffix ``_limbs``) operate on (hi, lo) uint32 pairs for use
inside Pallas kernels, where 64-bit integers are unavailable.

Validated bit-for-bit against dashing2_tpu.hashing (numpy ground truth) in
tests/test_u64_ops.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import hashing as H
from . import u64 as limbs


def _c(x: int) -> jnp.ndarray:
    return jnp.uint64(x)


# ----------------------------------------------------------------------
# native-u64 forms
# ----------------------------------------------------------------------

def wanghash(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.uint64)
    x = (~x) + (x << _c(21))
    x = x ^ (x >> _c(24))
    x = x * _c(265)
    x = x ^ (x >> _c(14))
    x = x * _c(21)
    x = x ^ (x >> _c(28))
    x = x + (x << _c(31))
    return x


def maskfn(x: jnp.ndarray, xormask: int = H.XORMASK) -> jnp.ndarray:
    """WangHash(x ^ XORMASK) — the global k-mer scrambler (enums.h:136)."""
    return wanghash(x.astype(jnp.uint64) ^ _c(xormask))


def cehasher(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.uint64)
    return ((x ^ _c(H.CEH_A)) * _c(H.CEH_B)) ^ _c(H.CEH_C)


def oph_hash(x: jnp.ndarray, seed: int = H.OPH_DEFAULT_SEED) -> jnp.ndarray:
    """OPH bucket hash (oph.h:55-89): WangHash(x ^ mt_seed ^ CEIXOR)."""
    s = H.mt19937_64_first(seed)
    return wanghash(x.astype(jnp.uint64) ^ _c(s) ^ _c(H.CEIXOR_OPH))


def mulhi_u64(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High 64 bits of a full 64x64 product (via u32 limbs)."""
    hi, _ = limbs.mul_wide(limbs.from_u64(a), limbs.from_u64(b))
    return limbs.to_u64(hi)


def wyhash64_step(seed: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One wyhash64_stateless step; returns (new_seed, output)."""
    seed = seed.astype(jnp.uint64) + _c(H.WY_INC)
    t = seed * _c(H.WY_M1)
    m1 = mulhi_u64(seed, _c(H.WY_M1) * jnp.ones_like(seed)) ^ t
    t2 = m1 * _c(H.WY_M2)
    m2 = mulhi_u64(m1, _c(H.WY_M2) * jnp.ones_like(m1)) ^ t2
    return seed, m2


def reg2sig(bits: jnp.ndarray) -> jnp.ndarray:
    """Register-bit-pattern -> signature hash (cmp_core.cpp:19-37)."""
    return wanghash(bits.astype(jnp.uint64) ^ _c(H.REG2SIG_XOR))


def css_item_hash(ids: jnp.ndarray) -> jnp.ndarray:
    """CSetSketch per-item RNG seed (setsketch.h:375)."""
    return cehasher(ids.astype(jnp.uint64) ^ _c(H.CSS_XOR))


def u64_to_unit_float(x: jnp.ndarray) -> jnp.ndarray:
    """x * 2^-64 in f64 (INVMUL64 semantics, setsketch.h:114).

    Matches C++ ``double(x) * 0x1p-64`` exactly: a single u64->f64
    conversion (correctly rounded) then a power-of-two scale (exact).
    """
    return x.astype(jnp.float64) * (2.0 ** -64)


# ----------------------------------------------------------------------
# limb forms (Pallas-safe)
# ----------------------------------------------------------------------

def wanghash_limbs(x: limbs.U32Pair) -> limbs.U32Pair:
    x = limbs.add(limbs.bnot(x), limbs.shl(x, 21))
    x = limbs.xor(x, limbs.shr(x, 24))
    x = limbs.mul_const(x, 265)
    x = limbs.xor(x, limbs.shr(x, 14))
    x = limbs.mul_const(x, 21)
    x = limbs.xor(x, limbs.shr(x, 28))
    x = limbs.add(x, limbs.shl(x, 31))
    return x


def maskfn_limbs(x: limbs.U32Pair, xormask: int = H.XORMASK) -> limbs.U32Pair:
    return wanghash_limbs(limbs.xor_const(x, xormask))


def cehasher_limbs(x: limbs.U32Pair) -> limbs.U32Pair:
    return limbs.xor_const(
        limbs.mul_const(limbs.xor_const(x, H.CEH_A), H.CEH_B), H.CEH_C)


def oph_hash_limbs(x: limbs.U32Pair,
                   seed: int = H.OPH_DEFAULT_SEED) -> limbs.U32Pair:
    s = H.mt19937_64_first(seed)
    return wanghash_limbs(limbs.xor_const(x, s ^ H.CEIXOR_OPH))


def wyhash64_step_limbs(seed: limbs.U32Pair
                        ) -> tuple[limbs.U32Pair, limbs.U32Pair]:
    seed = limbs.add_const(seed, H.WY_INC)
    m1c = limbs.const(H.WY_M1, seed[0].shape)
    hi, lo = limbs.mul_wide(seed, m1c)
    m1 = limbs.xor(hi, lo)
    m2c = limbs.const(H.WY_M2, seed[0].shape)
    hi, lo = limbs.mul_wide(m1, m2c)
    return seed, limbs.xor(hi, lo)
