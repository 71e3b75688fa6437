"""SC list decoding (SCL) and CRC-aided SCL, batched over frames with the list
as a tensor axis.

Reference semantics (SCL_1024.c:546-680, CASCL_128.c:538-699):
  - L parallel graph copies; LLR-based path metric with the table-approximated
    PHI update (SCL_1024.c:481-502, derived in updatePM.pdf);
  - phase A doubles active paths until L (SCL_1024.c:581-605); phase B builds
    2L PM candidates per info bit, quicksorts a copy, takes med = PMcand[L] as
    the survival threshold, and repacks survivors into dead slots
    (SCL_1024.c:606-661);
  - the final answer is the min-PM path (SCL_1024.c:667-674); CA-SCL evaluates
    the CRC on every path and picks the min-PM passer, falling back to the
    global min-PM (CASCL_128.c:663-698).

Array design (SURVEY §2.5 "List-parallelism"):
  - per-path state is the compact O(N) layout of models/_compact.py with
    leading shape [B, L]; path copying is a gather along the L axis of just
    2(N-1) lanes per path (not the reference's O(n N) copyPath);
  - both growth phases collapse into one rule by giving inactive paths PM =
    BIG: selection always keeps the L smallest of the 2L candidates
    (`lax.top_k` of the negated PMs).  While active paths < L the finite
    candidates all survive — exactly the reference's doubling phase — and
    afterwards the kept set equals the reference's strict-less-than-median
    survivors whenever the median is unique.  (On exact PM ties at the median
    the reference keeps fewer than L paths and prints "Oops!"
    (SCL_1024.c:621-622); we keep exactly L, breaking ties by candidate index
    — a measure-zero divergence.)
  - candidate ordering matches the reference: cand[k] = PM[k] + PHI(l_k, 0),
    cand[k+L] = PM[k] + PHI(l_k, 1) (SCL_1024.c:611-617), so index tie-breaks
    favor the u=0 branch of the lower-numbered path, like the C scan order.

The Kao ("_fag") graph and the systematic-CRC variant ride the same engine
under bit-reversal relabeling (see models/sc.py docstring).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from polardecoding_tpu.models._compact import bit_phase, llr_phase, ntz_traced
from polardecoding_tpu.ops.chk import phi_penalties_both

BIG = 1e30  # PM of inactive list slots


@functools.partial(
    jax.jit,
    static_argnames=("list_size", "return_all", "return_ties",
                     "strict_median"),
)
def scl_decode(ch_llr, frozen, list_size: int = 8, return_all: bool = False,
               return_ties: bool = False, strict_median: bool = False):
    """Decode a batch of frames with SCL.

    ch_llr: [B, N]; frozen: [N] bool; list_size: L.
    Returns u_hat [B, N] int8 (min-PM path), or with return_all=True the tuple
    (u_all [B, L, N], PM [B, L]) for CA-SCL selection / tests.

    return_ties=True appends a PM-tie counter [B] int32: the number of info
    bits at which the L-th and (L+1)-th smallest of the 2L PM candidates were
    exactly equal — the condition under which the reference's strict-less-
    than-median repack keeps FEWER than L paths and prints "Oops!"
    (SCL_1024.c:620-633).  We keep exactly L with index tie-breaks; a nonzero
    counter marks the (measure-zero) frames where the two policies could
    diverge, making that documented divergence observable rather than assumed.

    strict_median=True is the debug-only REFERENCE policy: keep only
    candidates STRICTLY below the median PMcand[L] (SCL_1024.c:618-633), so
    an exact tie at the median kills the tied candidates and the list runs
    with fewer than L live paths until the next doubling refills it (the
    reference's post-"Oops!" behavior: dead slots stay PM=inf and phase A's
    active<L doubling re-engages because BIG candidates never enter the
    survivor set while finite ones exist).  The surviving path SET and all
    finite PMs match the reference; only the slot numbering differs (the
    reference repacks survivors into dead slots, we leave them in rank
    order — selection and the final min-PM readout are order-free).  On
    tie-free frames (every observed MC frame) this is bit-identical to the
    default keep-exactly-L policy — proven in test_scl_strict_median.
    """
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    L = list_size
    dt = ch_llr.dtype

    llr_c = jnp.zeros((B, L, N - 1), dt)
    bits_c = jnp.zeros((B, L, N - 1), jnp.int8)
    u_all = jnp.zeros((B, L, N), jnp.int8)
    PM = jnp.full((B, L), BIG, dt).at[:, 0].set(0.0)
    frozen_i = jnp.asarray(frozen)
    ch = ch_llr[:, None, :]  # broadcast over the list axis

    llr_branches = [
        (lambda lc, bc, c, tt=tt: llr_phase(lc, bc, c, tt, n)) for tt in range(n + 1)
    ]
    bit_branches = [
        (lambda bc, u, tt=tt: bit_phase(bc, u, tt, n)) for tt in range(n + 1)
    ]

    ties = jnp.zeros((B,), jnp.int32)

    def frozen_step(j, l0, pen0, pen1, state):
        llr_c, bits_c, u_all, PM, ties = state
        # frozen bit: every path takes u = 0 and pays PHI(l, 0)
        # (ref: SCL_1024.c:663-666 frozen branch)
        return (llr_c, bits_c, u_all, PM + pen0, ties,
                jnp.zeros((B, L), jnp.int8))

    def info_step(j, l0, pen0, pen1, state):
        llr_c, bits_c, u_all, PM, ties = state
        cand = jnp.concatenate([PM + pen0, PM + pen1], axis=-1)  # [B, 2L]
        # L+1 smallest: [..., :L] survive; [..., L] is the reference's median
        # PMcand[L] (only used for tie observability)
        neg_top, idx = lax.top_k(-cand, L + 1)  # ties by index
        parent = idx[..., :L] % L  # originating path slot
        ub = (idx[..., :L] >= L).astype(jnp.int8)  # chosen bit
        # reference keeps PM < median strictly; equality of the L-th and
        # (L+1)-th candidates is the "Oops!" condition.  Guard against the
        # BIG sentinels of the doubling phase (both would absorb to BIG).
        tie = jnp.logical_and(
            neg_top[..., L - 1] == neg_top[..., L],
            -neg_top[..., L] < BIG / 2,
        )
        take = lambda a: jnp.take_along_axis(
            a, parent.reshape(parent.shape + (1,) * (a.ndim - 2)), axis=1
        )
        new_PM = -neg_top[..., :L]
        if strict_median:
            # reference policy: survivors are STRICTLY below the median
            # PMcand[L]; tied-at-median candidates die (slot PM = BIG), the
            # "Oops!" case (SCL_1024.c:618-633)
            med = -neg_top[..., L:]
            new_PM = jnp.where(new_PM < med, new_PM, BIG)
        return (take(llr_c), take(bits_c), take(u_all), new_PM,
                ties + tie.astype(jnp.int32), ub)

    def body(j, carry):
        llr_c, bits_c, u_all, PM, ties = carry
        j = jnp.int32(j)
        t = ntz_traced(j | N)
        llr_c = lax.switch(t, llr_branches, llr_c, bits_c, ch)
        l0 = llr_c[..., 0]  # [B, L]
        pen0, pen1 = phi_penalties_both(l0)
        llr_c, bits_c, u_all, PM, ties, u = lax.cond(
            frozen_i[j], frozen_step, info_step,
            j, l0, pen0, pen1, (llr_c, bits_c, u_all, PM, ties),
        )
        u_all = lax.dynamic_update_slice_in_dim(u_all, u[:, :, None], j, axis=-1)
        t1 = jnp.minimum(ntz_traced(j + 1), n)
        bits_c = lax.switch(t1, bit_branches, bits_c, u)
        return llr_c, bits_c, u_all, PM, ties

    _, _, u_all, PM, ties = lax.fori_loop(
        0, N, body, (llr_c, bits_c, u_all, PM, ties)
    )
    if return_all:
        return (u_all, PM, ties) if return_ties else (u_all, PM)
    best = jnp.argmin(PM, axis=-1)
    u_hat = jnp.take_along_axis(u_all, best[:, None, None], axis=1)[:, 0]
    return (u_hat, ties) if return_ties else u_hat


def cascl_select(u_all, PM, info_positions, crc_R):
    """CA-SCL final selection (ref: CASCL_128.c:663-698): among CRC-passing
    paths pick min PM; if none pass, global min PM.

    u_all: [B, L, N]; info_positions: [K + r] static array of the bit channels
    carrying [message || CRC] in encode order; crc_R: [K + r, r] check matrix
    (see ops/crc.py).  Returns (u_hat [B, N], passed [B] bool).
    """
    cw = u_all[..., jnp.asarray(info_positions)]  # [B, L, K+r]
    syn = jnp.matmul(
        cw.astype(jnp.int32),
        jnp.asarray(crc_R, jnp.int32),
        preferred_element_type=jnp.int32,
    ) & 1
    ok = jnp.all(syn == 0, axis=-1)  # [B, L]
    PMm = jnp.where(ok, PM, jnp.inf)
    any_ok = jnp.any(ok, axis=-1)
    best = jnp.where(any_ok, jnp.argmin(PMm, axis=-1), jnp.argmin(PM, axis=-1))
    u_hat = jnp.take_along_axis(u_all, best[:, None, None], axis=1)[:, 0]
    return u_hat, any_ok


def cascl_decode(ch_llr, frozen, info_positions, crc_R, list_size: int = 8,
                 return_ties: bool = False):
    """CRC-aided SCL: SCL pass + CRC-filtered min-PM selection."""
    u_all, PM, ties = scl_decode(
        ch_llr, frozen, list_size=list_size, return_all=True,
        return_ties=True,
    )
    u_hat, _ = cascl_select(u_all, PM, info_positions, crc_R)
    return (u_hat, ties) if return_ties else u_hat
