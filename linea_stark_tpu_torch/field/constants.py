"""BLS12-377 scalar-field (Fr) constants: a jax-free copy of
``linea_stark_tpu/field/constants.py``, held to it by
``tests/test_torch_host_copies.py``.

The reference stores Montgomery integers as 16 limbs of 16 bits; the port
stores the same integers as 8 words of 32 bits (``field/fr.py``).  R = 2**256 in both, and r = 1 mod 2**47.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Prime modulus (253 bits, two-adicity 47).
# ---------------------------------------------------------------------------
R_MOD = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
MODULUS_BITS = 253
TWO_ADICITY = 47

# Montgomery parameters (R = 2**256).
LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
MONT_R = (1 << 256) % R_MOD
MONT_R2 = (MONT_R * MONT_R) % R_MOD
# -r^{-1} mod 2**16 == 0xFFFF (r ≡ 1 mod 2**16)
MONT_N0 = pow(-R_MOD, -1, 1 << LIMB_BITS)
assert MONT_N0 == LIMB_MASK

# ---------------------------------------------------------------------------
# Two-adic root of unity: the smallest c >= 2 such that c**((r-1)/2**47) has
# exact order 2**47 is c = 11; the resulting root generates every power-of-two
# subgroup up to 2**47 (plenty for traces up to 2**22 rows at blowup 8, the
# sizes profiled in the reference bench.log:20).
# ---------------------------------------------------------------------------
TWO_ADIC_GENERATOR = pow(11, (R_MOD - 1) >> TWO_ADICITY, R_MOD)

# Coset shift for low-degree extensions.  ark-bls12-377 documents 22 as the
# multiplicative-group generator of Fr; for LDE correctness all we require is
# that the shift is outside every 2**k subgroup (so the coset g·H is disjoint
# from H), which holds iff shift**(2**47) != 1 — asserted below.
COSET_SHIFT = 22
assert pow(COSET_SHIFT, 1 << TWO_ADICITY, R_MOD) != 1

# S-box exponent for Poseidon2: the smallest alpha with gcd(alpha, r-1) = 1.
# 3, 5, 7 and 13 all divide r-1, so x^alpha is a permutation first at 11.
POSEIDON2_ALPHA = 11

