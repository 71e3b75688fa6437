"""CRC encode/check over GF(2), vectorized as constant bit-matrix ops.

Three reference styles (SURVEY §2.2):
  - multiplicative CRC-6:  w(D) = m(D) g(D), g = 1 + D^5 + D^6
    (encode CASCL_128.c:205-220, check by long division CASCL_128.c:517-536)
  - multiplicative CRC-24: same with the 13-tap g listed below
    (CASCL_1024_L8.c:245-270 / 569-600)
  - systematic CRC-24: codeword [parity(K x r) || message], parity rows Gc
    (CASCL_1024_sys.c:49-561 data table, 776-789 encode, 1093-1122 check)

Polynomials are stored as exponent tuples; the check is a GF(2) matvec
syndrome = C . R mod 2 with R[i] = D^i mod g(D) precomputed on host, so a batch
of L paths x B frames checks in one int matmul + parity reduce.
The systematic parity matrix Gc is derived (Gc[i][j] = coeff_j of D^{r+i} mod g)
rather than hard-coded; tests confirm [Gc.v || v] always passes the divisor
check, matching the reference's table by construction.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# g(D) = D^6 + D^5 + 1 (ref: CASCL_128.c:205-220)
CRC6_EXPONENTS = (0, 5, 6)
# g(D) = D^24 + D^23 + D^21 + D^20 + D^17 + D^15 + D^13 + D^12 + D^8 + D^4
#        + D^2 + D + 1 (ref: CASCL_1024_L8.c:245-270)
CRC24_EXPONENTS = (0, 1, 2, 4, 8, 12, 13, 15, 17, 20, 21, 23, 24)


def crc_degree(exponents) -> int:
    return max(exponents)


def _poly_mod_table(exponents, length: int) -> np.ndarray:
    """R[i] = coefficients of D^i mod g(D), shape [length, r]."""
    r = crc_degree(exponents)
    low = [e for e in exponents if e < r]
    table = np.zeros((length, r), dtype=np.uint8)
    cur = np.zeros(r, dtype=np.uint8)
    cur[0] = 1  # D^0
    for i in range(length):
        table[i] = cur
        # multiply by D: shift up; if D^r appears, substitute D^r = sum(low)
        carry = cur[r - 1]
        cur = np.roll(cur, 1)
        cur[0] = 0
        if carry:
            for e in low:
                cur[e] ^= 1
    return table


def multiplicative_encode_matrix(exponents, k: int) -> np.ndarray:
    """[k, k+r] GF(2) matrix E with w = m . E: message bit i contributes at
    offsets i + e for each exponent e (the reference's tap accumulation)."""
    r = crc_degree(exponents)
    E = np.zeros((k, k + r), dtype=np.uint8)
    for i in range(k):
        for e in exponents:
            E[i, i + e] = 1
    return E


def systematic_parity_matrix(exponents, k: int) -> np.ndarray:
    """Gc: [k, r] with parity p = v . Gc so that [p || v] is divisible by g.

    p(D) must equal sum_i v_i D^{r+i} mod g(D), i.e. Gc[i] = D^{r+i} mod g —
    the derivation behind the reference's 512 x 24 hard-coded table."""
    r = crc_degree(exponents)
    return _poly_mod_table(exponents, r + k)[r:]


def check_matrix(exponents, length: int) -> np.ndarray:
    """[length, r] matrix R with syndrome = C . R mod 2; C passes iff syndrome
    is all-zero (equivalent to the reference's in-place long division)."""
    return _poly_mod_table(exponents, length)


def crc_syndrome(codeword_bits, R):
    """Batched GF(2) syndrome: codeword_bits [..., length] x R [length, r].

    Uses an integer matmul + bit-parity (int32 operands and accumulation:
    exact, no precision setting involved)."""
    acc = jnp.matmul(
        codeword_bits.astype(jnp.int32),
        jnp.asarray(R, dtype=jnp.int32),
        preferred_element_type=jnp.int32,
    )
    return acc & 1


def crc_passes(codeword_bits, R):
    """True where the codeword is divisible by g."""
    return jnp.all(crc_syndrome(codeword_bits, R) == 0, axis=-1)


def crc_encode_multiplicative(message_bits, exponents):
    """w = m(D) g(D) as a batched GF(2) matvec; returns [..., k + r]."""
    k = message_bits.shape[-1]
    E = multiplicative_encode_matrix(exponents, k)
    acc = jnp.matmul(
        message_bits.astype(jnp.int32),
        jnp.asarray(E, dtype=jnp.int32),
        preferred_element_type=jnp.int32,
    )
    return (acc & 1).astype(message_bits.dtype)


def crc_encode_systematic(message_bits, exponents):
    """[parity || message], parity = v . Gc (ref: CASCL_1024_sys.c:776-789)."""
    k = message_bits.shape[-1]
    Gc = systematic_parity_matrix(exponents, k)
    acc = jnp.matmul(
        message_bits.astype(jnp.int32),
        jnp.asarray(Gc, dtype=jnp.int32),
        preferred_element_type=jnp.int32,
    )
    parity = (acc & 1).astype(message_bits.dtype)
    return jnp.concatenate([parity, message_bits], axis=-1)
