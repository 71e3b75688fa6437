"""Compact O(N)-state successive-cancellation substrate shared by SC and SCL.

The reference keeps full (n+1) x N per-node state and walks it with recursive
memoized functions (`getLLR` SC_128.c:344-365, `updateBit` SC_128.c:367-392).
The array engine instead exploits the classic observation that at any point of
the serial bit loop only ONE group per stage is live: while decoding bit j,
stage i's live LLR group is the contiguous block [(j >> i) << i, +2^i) and the
live partial-sum group is its upper half awaiting a partner.  So all per-path
state packs into two length-(N-1) arrays whose stage-i slot (size 2^i, offset
2^i - 1) always holds the *current* group:

  - llr slot i: stage-i LLRs of the current group (written by f/g updates);
  - bit slot i: the saved upper-half stage-i decided node values.

Every access is a full-slot static slice — no dynamic indexing anywhere, which
is exactly what XLA wants.  The stage-n LLRs are the (path-independent)
channel LLRs and are passed separately.  The per-bit schedule is:

  t  = ntz(j)   (n for j = 0): one g-update at stage t, then f-updates (CHK)
                at stages t-1 .. 0  — `llr_phase`;
  t1 = ntz(j+1): after deciding bit j, combine partial sums upward through t1
                stages — `bit_phase` (the reference's updateBit chain).

Both phases are selected with `lax.switch` over the n+1 possible t values, so
the compiled loop body has O(n) small branches regardless of N.  All functions
are shape-polymorphic in the leading axes: [B] for SC, [B, L] for SCL.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from polardecoding_tpu.ops.chk import chk


def slot(i: int):
    """Static slice bounds of the stage-i slot in a compact array."""
    return (1 << i) - 1, (2 << i) - 1


def _read(arr, i: int):
    lo, hi = slot(i)
    return arr[..., lo:hi]


def _write(arr, i: int, val):
    lo, hi = slot(i)
    return arr.at[..., lo:hi].set(val)


def _stage_src(llr_c, ch, i: int, n: int):
    """Stage-(i+1) LLR source for an update at stage i: slot i+1, or the
    channel when i+1 == n.  `ch` must already be broadcast to the leading
    shape of llr_c."""
    if i + 1 == n:
        return ch
    return _read(llr_c, i + 1)


def llr_phase(llr_c, bits_c, ch, t: int, n: int):
    """All LLR recomputation for one bit given t = ntz(j) (t = n for j = 0).

    g-node at stage t (lower half: partner bits saved in bit slot t), then
    f-nodes (CHK) at stages t-1 .. 0 (ref: SC_128.c:344-365).
    """
    if t < n:
        src = _stage_src(llr_c, ch, t, n)
        w = 1 << t
        up, lo = src[..., :w], src[..., w:]
        sgn = (1 - 2 * _read(bits_c, t)).astype(src.dtype)
        llr_c = _write(llr_c, t, lo + sgn * up)
    for i in range(t - 1, -1, -1):
        src = _stage_src(llr_c, ch, i, n)
        w = 1 << i
        llr_c = _write(llr_c, i, chk(src[..., :w], src[..., w:]))
    return llr_c


def bit_phase(bits_c, u, t1: int, n: int):
    """Partial-sum propagation after deciding bit j, t1 = ntz(j+1): combine
    [saved_upper ^ v, v] upward through t1 stages, then save the result as the
    next pending upper half (ref: SC_128.c:367-392).  `u` has the leading
    shape of bits_c (int8)."""
    v = u[..., None]
    for i in range(t1):
        v = jnp.concatenate([_read(bits_c, i) ^ v, v], axis=-1)
    if t1 < n:
        bits_c = _write(bits_c, t1, v)
    return bits_c


def ntz_traced(x):
    """Number of trailing zeros of a traced positive int32, via popcount."""
    x = x.astype(jnp.int32)
    v = ((x & -x) - 1).astype(jnp.uint32)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24).astype(jnp.int32)
