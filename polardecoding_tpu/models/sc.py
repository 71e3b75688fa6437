"""Successive-cancellation decoder: iterative compact schedule, batched over frames.

Reference semantics (SC_128.c:394-460): serial loop over bits j = 0..N-1; the
LLR of bit j comes from the recursive memoized `getLLR` (f-node = CHK of the
two children, g-node = lower child +/- upper child by the decided partner bit,
SC_128.c:344-365); decided bits back-propagate rightward (`updateBit`,
SC_128.c:367-392); frozen bits are forced to 0 (SC_128.c:404-410) — in the
serial order, deciding each frozen bit as 0 at its turn is equivalent.

Array design (SURVEY §7.3): see models/_compact.py — O(N) compact state, static
full-slot slices, `lax.fori_loop` over bits with `lax.switch` over ntz(j).
Throughput comes from the frame batch axis; the N-step serial chain is the
intrinsic SC dependency (SURVEY §3.2).

The Kao ("_fag") wiring (SC_128_fag.c:333-358, decode order bRev,
SC_128_fag.c:436-448) is this same engine under bit-reversal relabeling —
verified in tests against direct simulators of both wirings.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from polardecoding_tpu.models._compact import bit_phase, llr_phase, ntz_traced


@jax.jit
def sc_decode(ch_llr, frozen):
    """Decode a batch of frames with plain SC.

    ch_llr: [B, N] channel LLRs; frozen: [N] bool.
    Returns u_hat [B, N] int8 (frozen positions 0).
    """
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    dt = ch_llr.dtype

    llr_c = jnp.zeros((B, N - 1), dt)
    bits_c = jnp.zeros((B, N - 1), jnp.int8)
    u_out = jnp.zeros((B, N), jnp.int8)
    frozen_i = jnp.asarray(frozen)

    llr_branches = [
        (lambda lc, bc, ch, tt=tt: llr_phase(lc, bc, ch, tt, n)) for tt in range(n + 1)
    ]
    bit_branches = [
        (lambda bc, u, tt=tt: bit_phase(bc, u, tt, n)) for tt in range(n + 1)
    ]

    def body(j, carry):
        llr_c, bits_c, u_out = carry
        j = jnp.int32(j)
        t = ntz_traced(j | N)  # ntz(j) clamped to n; j = 0 -> n
        llr_c = lax.switch(t, llr_branches, llr_c, bits_c, ch_llr)
        l0 = llr_c[..., 0]
        u = jnp.where(frozen_i[j], jnp.int8(0), (l0 < 0).astype(jnp.int8))
        u_out = u_out.at[:, :].set(
            lax.dynamic_update_slice_in_dim(u_out, u[:, None], j, axis=-1)
        )
        t1 = jnp.minimum(ntz_traced(j + 1), n)
        bits_c = lax.switch(t1, bit_branches, bits_c, u)
        return llr_c, bits_c, u_out

    _, _, u_out = lax.fori_loop(0, N, body, (llr_c, bits_c, u_out))
    return u_out
