"""Polar transform: O(N log N) butterfly encoder, batched over frames.

The reference encodes by accumulating rows of a dense N x N matrix read from
stdin (x = u . Fn, ref: SC_128.c:148-158, 182-191) — O(K N) per frame.  Here the
transform is log2(N) stages of reshape + XOR over the whole batch (the Lee-graph
butterflies applied left to right), so a [B, N] batch encodes in n fused
elementwise passes.  `utils.gf2.dense_generator` provides F^{tensor n} for
bit-exact cross-checks.

Graph conventions: the Lee graph (separation 2^i at stage i) and the Kao/"_fag"
graph (separation 2^(n-1-i), bit-reversal at the decoder) are related by
relabeling every stage's position p as bRev(p): under that relabeling the Kao
channel-LLR assignment, frozen mask, decode order, and output extraction all
become the natural order of the Lee graph, so one engine serves both (verified
in tests against a direct dense-graph simulator of each wiring).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax


def polar_encode(u):
    """x = u . F^{tensor n} over GF(2), Lee convention (stage-i pairs at
    distance 2^i; upper-right = upper xor lower, lower-right = lower).

    u: int array [..., N] with values in {0, 1}.  Returns same shape/dtype.
    """
    N = u.shape[-1]
    n = N.bit_length() - 1
    x = u
    lead = u.shape[:-1]
    for i in range(n):
        d = 1 << i
        v = x.reshape(lead + (N // (2 * d), 2, d))
        up = v[..., 0, :] ^ v[..., 1, :]
        lo = v[..., 1, :]
        x = jnp.stack((up, lo), axis=-2).reshape(lead + (N,))
    return x


def scatter_info(payload, info_positions, N: int):
    """Place payload bits [..., K'] into a length-N u-vector at the static
    info positions (frozen positions stay 0).  Ref: SC_128.c:179-181."""
    lead = payload.shape[:-1]
    u = jnp.zeros(lead + (N,), dtype=payload.dtype)
    return u.at[..., info_positions].set(payload)


def info_sub_generator(info_positions, N: int) -> np.ndarray:
    """G_I: the info-position rows of F^{tensor n} as numpy uint8 [K', N],
    so  polar_encode(scatter_info(w, I, N)) == (w . G_I) mod 2.

    Host-side constant for `encode_info_mxu` (becomes a jit literal)."""
    from polardecoding_tpu.utils.gf2 import dense_generator

    return dense_generator(N)[np.asarray(info_positions)]


def encode_info_mxu(w, g_rows) -> jnp.ndarray:
    """Codeword x = (w . G_I) mod 2 as ONE matmul — bit-exact vs the
    butterfly path, on the matrix units the min/sign/LUT decode arithmetic
    cannot use (the tensor cores on the GPU).

    The whole encode is [B, K']x[K', N] in bf16 with float32 accumulation
    (`preferred_element_type`; default precision, which for bf16 operands is
    the native bf16 product): 0/1 values are exact in bf16, products are
    exact, and the f32 accumulation of at most K' <= 2^24 ones is exact, so
    x = acc - 2*floor(acc/2)  reproduces GF(2) exactly (tested bit-equal in
    tests/test_core_ops.py and on the card in chip_smoke.py).

    w: [..., K'] 0/1 bits; g_rows: uint8 [K', N] from `info_sub_generator`.
    Returns f32 0.0/1.0 [..., N].
    """
    acc = lax.dot_general(
        w.astype(jnp.bfloat16),
        jnp.asarray(g_rows, jnp.bfloat16),
        (((w.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return acc - 2.0 * jnp.floor(acc * 0.5)
