"""Belief-propagation decoder: vectorized flooding sweeps over the butterfly graph.

Reference semantics (BP_128.c:334-389, BP_1024.c, BP_128_fag.c:349-403):
  - messages: left-going L[i, p] and right-going R[i, p] on an (n+1) x N lattice;
    L[n] = channel LLR (fixed), R[0] = 999 on frozen / 0 on info (fixed);
  - one iteration = R-sweep over stages 0..n-1 (Gauss-Seidel: stage i+1 reads the
    stage-i R just written) then L-sweep over stages n-1..0;
  - per-butterfly updates with the table-corrected min-sum CHK:
        R'[i+1, u] = CHK(R[i, u], L[i+1, d] + R[i, d])
        R'[i+1, d] = R[i, d] + CHK(R[i, u], L[i+1, u])
        L'[i, u]   = CHK(L[i+1, u], L[i+1, d] + R[i, d])
        L'[i, d]   = L[i+1, d] + CHK(R[i, u], L[i+1, u])
  - decision after iterMax iterations: u_hat = sign(L[0] + R[0]) on info bits.

Array design: no pointer graph — stage i's butterflies are a reshape of the N
axis into [N/2d, 2, d] (d = 2^i) and a batched elementwise CHK over the halves;
the whole iteration runs under `lax.fori_loop` (or `lax.while_loop` with the
early-stop extension).  Batched over frames on the leading axis.  These plain
engines are the reference; on the GPU the `*_auto` / `bp_wave_fused` entry
points run the shared-memory CUDA kernel of ops/bp_kernel.py instead.

Graph conventions: the Kao ("_fag") wiring is the Lee wiring under per-stage
bit-reversal relabeling, with channel/frozen/output maps that also become the
identity — so this single engine implements both (equivalence is verified in
tests against a direct simulator of each wiring).

Extension beyond the reference: optional early stopping.  The reference always
runs iterMax=100 fixed sweeps; with `early_stop_every > 0` we periodically
re-encode the current hard decision and compare against the POSTERIOR hard
decision at the channel stage, sign(L[n] + R[n]) (a G-matrix stopping rule) —
sanctioned by BASELINE.json ("BP ... with R/L message arrays and
early-stopping").  Each frame's decision is LATCHED at its own first check
boundary where its rule holds, so the output is a pure function of
(channel LLRs, early_stop_every) — independent of batch size, sharding, and
of when the surrounding while_loop exits.  The loop itself exits once every
frame in the batch has latched (or at iterMax); that timing affects only
throughput, never decisions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from polardecoding_tpu.ops.chk import chk, chk_exact, chk_fast
from polardecoding_tpu.ops.encode import polar_encode

FROZEN_R = 999.0  # the reference's frozen-bit "infinity" (BP_128.c:351)


def _halves(x, i):
    """Split the last axis (length N) into stage-i butterfly halves.

    Returns (upper, lower) of shape [..., N/2]; `_merge` is the inverse.
    """
    N = x.shape[-1]
    d = 1 << i
    v = x.reshape(x.shape[:-1] + (N // (2 * d), 2, d))
    return v[..., 0, :], v[..., 1, :]


def _merge(up, lo, i, N):
    out = jnp.stack((up, lo), axis=-2)
    return out.reshape(out.shape[:-3] + (N,))


def bp_iteration(Ls, Rs, chk_fn):
    """One flooding iteration over per-stage message lists.

    Ls, Rs: lists of n+1 arrays [..., N].  Ls[n] and Rs[0] are fixed by the
    caller.  Returns updated lists (Gauss-Seidel across stages, parallel within
    a stage, exactly like the reference's sweep order).
    """
    n = len(Ls) - 1
    N = Ls[0].shape[-1]
    Rs = list(Rs)
    Ls = list(Ls)
    for i in range(n):
        ru, rd = _halves(Rs[i], i)
        lu, ld = _halves(Ls[i + 1], i)
        new_u = chk_fn(ru, ld + rd)
        new_d = rd + chk_fn(ru, lu)
        Rs[i + 1] = _merge(new_u, new_d, i, N)
    for i in range(n - 1, -1, -1):
        ru, rd = _halves(Rs[i], i)
        lu, ld = _halves(Ls[i + 1], i)
        new_u = chk_fn(lu, ld + rd)
        new_d = ld + chk_fn(ru, lu)
        Ls[i] = _merge(new_u, new_d, i, N)
    return Ls, Rs


def _stack(stages):
    return jnp.stack(stages, axis=-2)  # [..., n+1, N]


def _unstack(arr):
    return [arr[..., i, :] for i in range(arr.shape[-2])]


@functools.partial(
    jax.jit, static_argnames=("iters", "flavor", "early_stop_every")
)
def bp_decode(
    ch_llr,
    frozen,
    iters: int = 100,
    flavor: str = "minsum_lut",
    early_stop_every: int = 0,
):
    """Decode a batch of frames.

    ch_llr: [B, N] channel LLRs (2y/sigma^2); frozen: [N] bool.
    Returns u_hat [B, N] int8 (frozen positions forced 0).
    """
    chk_fn = {"minsum_lut": chk, "minsum_lut_fast": chk_fast,
              "spa": chk_exact}[flavor]
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    dt = ch_llr.dtype

    r0 = jnp.where(frozen, jnp.asarray(FROZEN_R, dt), jnp.asarray(0, dt))
    r0 = jnp.broadcast_to(r0, (B, N))
    Ls0 = _stack([jnp.zeros((B, N), dt)] * n + [ch_llr])
    Rs0 = _stack([r0] + [jnp.zeros((B, N), dt)] * n)

    def decision(Larr, Rarr):
        soft = Larr[..., 0, :] + Rarr[..., 0, :]
        return jnp.where(frozen, 0, (soft < 0)).astype(jnp.int8)

    if early_stop_every:
        # Per-frame latch: a frame's decision freezes at its own first check
        # boundary where the G-matrix rule holds; the loop keeps running for
        # the laggards and exits once every frame has latched.  `done` and
        # `u_lat` make decisions batch-independent (advisor round-1 medium).
        def body(carry):
            it, Larr, Rarr, done, u_lat = carry
            Ls, Rs = _unstack(Larr), _unstack(Rarr)
            Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
            Larr, Rarr = _stack(Ls), _stack(Rs)
            check_now = (it + 1) % early_stop_every == 0
            u_hat = decision(Larr, Rarr)
            x_hat = polar_encode(u_hat)
            # posterior channel-stage hard decision sign(L[n] + R[n]) — NOT
            # the raw channel sign, which carries the channel's own bit errors
            ch_hard = (Larr[..., n, :] + Rarr[..., n, :] < 0).astype(jnp.int8)
            ok = jnp.all(x_hat == ch_hard, axis=-1)
            newly = check_now & ok & ~done
            u_lat = jnp.where(newly[:, None], u_hat, u_lat)
            done = done | newly
            return it + 1, Larr, Rarr, done, u_lat

        def cond(carry):
            it, _, _, done, _ = carry
            return (it < iters) & ~jnp.all(done)

        init = (jnp.asarray(0), Ls0, Rs0, jnp.zeros((B,), bool),
                jnp.zeros((B, N), jnp.int8))
        _, Larr, Rarr, done, u_lat = lax.while_loop(cond, body, init)
        return jnp.where(done[:, None], u_lat, decision(Larr, Rarr))

    def body(carry):
        Larr, Rarr = carry
        Ls, Rs = _unstack(Larr), _unstack(Rarr)
        Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        return _stack(Ls), _stack(Rs)

    Larr, Rarr = lax.fori_loop(0, iters, lambda _, c: body(c), (Ls0, Rs0))
    return decision(Larr, Rarr)


def use_kernel(engine: str) -> bool:
    """Engine choice shared by the BP entry points: "auto" takes the CUDA
    kernel (ops/bp_kernel.py) on the GPU and the plain engine elsewhere;
    "jnp" always takes the plain engine; "kernel" always takes the kernel
    (on the CPU that is its serial host build, which exists for tests)."""
    if engine not in ("auto", "jnp", "kernel"):
        raise ValueError(f"unknown BP engine {engine!r}")
    if engine == "auto":
        return jax.default_backend() == "gpu"
    return engine == "kernel"


def bp_decode_auto(ch_llr, frozen, iters=100, flavor="minsum_lut",
                   early_stop_every=0, engine="auto"):
    """bp_decode on the engine `engine` selects (see use_kernel).  The
    kernel runs float32 messages only: on the GPU any other dtype raises
    KernelUnsupported, and engine="jnp" is the way to run it."""
    if use_kernel(engine):
        from polardecoding_tpu.ops.bp_kernel import bp_decode_kernel

        return bp_decode_kernel(ch_llr, frozen, iters=iters, flavor=flavor,
                                early_stop_every=early_stop_every)
    return bp_decode(ch_llr, frozen, iters=iters, flavor=flavor,
                     early_stop_every=early_stop_every)


# ---------------------------------------------------------------------------
# Wave decoding: persistent message state advanced K iterations at a time.
#
# The continuous-batching BP engine (parallel/harness.run_point_waves) keeps a
# full batch of in-flight frames, advances ALL of them by a wave of K
# iterations, retires the frames whose G-matrix check passes (or that hit
# iterMax), and refills the freed slots with fresh frames in place.  Unlike
# the whole-decode early stop (jnp.all over the batch), a frame's decision is
# taken at ITS OWN first wave boundary where the per-frame check passes —
# a pure function of (channel LLRs, K), independent of batch size, sharding,
# and what other frames share the batch.  K is part of the decode semantics
# and is recorded in the preset (decoder.wave_iters).


def wave_init_state(ch_llr, frozen):
    """Pack fresh BP message state [2(n+1), B, N] (stage-major: each stage
    is a contiguous [B, N] plane): planes 0..n = L (L[n] = the channel
    LLRs), planes n+1..2n+1 = R (R[0] = frozen 999/0)."""
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    dt = ch_llr.dtype
    r0 = jnp.where(frozen, jnp.asarray(FROZEN_R, dt), jnp.asarray(0, dt))
    Ls = [jnp.zeros((B, N), dt)] * n + [ch_llr]
    Rs = [jnp.broadcast_to(r0, (B, N))] + [jnp.zeros((B, N), dt)] * n
    return jnp.stack(Ls + Rs, axis=0)


@functools.partial(jax.jit, static_argnames=("iters", "flavor"))
def bp_wave(state, iters: int = 8, flavor: str = "minsum_lut"):
    """Advance packed state by `iters` BP iterations."""
    chk_fn = {"minsum_lut": chk, "minsum_lut_fast": chk_fast,
              "spa": chk_exact}[flavor]
    S2 = state.shape[0]
    n = S2 // 2 - 1

    def body(_, st):
        Ls = [st[i] for i in range(n + 1)]
        Rs = [st[n + 1 + i] for i in range(n + 1)]
        Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        return jnp.stack(Ls + Rs, axis=0)

    return lax.fori_loop(0, iters, body, state)


def wave_decide(state, frozen):
    """(u_hat [B, N] int8, done [B] bool) from packed state: decision
    sign(L0 + R0) on info bits; done = G-matrix check, x(u_hat) equal to the
    posterior channel-stage hard decision sign(L[n] + R[n])."""
    S2 = state.shape[0]
    n = S2 // 2 - 1
    soft = state[0] + state[n + 1]
    u_hat = jnp.where(frozen, 0, (soft < 0)).astype(jnp.int8)
    x_hat = polar_encode(u_hat)
    post = (state[n] + state[2 * n + 1] < 0).astype(jnp.int8)
    return u_hat, jnp.all(x_hat == post, axis=-1)


def wave_merge(state, ch_llr, retire):
    """Re-initialize retired slots' planes from fresh channel LLRs in place:
    L[n] <- llr, every other L/R plane <- 0 for slots where retire is True.
    R[0] (the frozen 999/0 row) is identical for every frame and untouched.
    Same merge the fused wave kernel performs at its head."""
    S2, B, N = state.shape
    n = S2 // 2 - 1
    r0 = state[n + 1]
    keep = ~retire[None, :, None]
    state = jnp.where(keep, state, 0)
    state = state.at[n].set(jnp.where(retire[:, None], ch_llr, state[n]))
    return state.at[n + 1].set(r0)


@functools.partial(jax.jit, static_argnames=("iters", "flavor",
                                              "check_every"))
def bp_wave_fused_jnp(state, ch_llr, retire, iters: int = 8,
                      flavor: str = "minsum_lut", check_every: int = 0):
    """jnp reference for the fused wave step: merge -> advance -> decide.
    Bit-identical to the fused wave kernel (ops/bp_kernel.py::
    bp_wave_fused_kernel), including the check_every > 0 in-wave per-frame
    latch (a frame's (u, done) freeze at its own first passing check)."""
    chk_fn = {"minsum_lut": chk, "minsum_lut_fast": chk_fast,
              "spa": chk_exact}[flavor]
    n = state.shape[0] // 2 - 1
    state = wave_merge(state, ch_llr, retire)
    frozen = state[n + 1] > 0.0
    if check_every:
        B, N = state.shape[1:]

        def wbody(it, c):
            st, done, u_lat = c
            Ls = [st[i] for i in range(n + 1)]
            Rs = [st[n + 1 + i] for i in range(n + 1)]
            Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
            st = jnp.stack(Ls + Rs, axis=0)
            u, ok = wave_decide(st, frozen)
            do = jnp.logical_or((it + 1) % check_every == 0, it + 1 == iters)
            newly = do & ok & ~done
            u_lat = jnp.where(newly[:, None], u, u_lat)
            return st, done | newly, u_lat

        done0 = jnp.zeros((B,), bool)
        state, done, u_lat = lax.fori_loop(
            0, iters, wbody, (state, done0, jnp.zeros((B, N), jnp.int8)))
        u_fin, _ = wave_decide(state, frozen)
        return state, jnp.where(done[:, None], u_lat, u_fin), done
    state = bp_wave(state, iters=iters, flavor=flavor)
    u_hat, done = wave_decide(state, frozen)
    return state, u_hat, done


def bp_wave_fused(state, ch_llr, retire, iters: int = 8,
                  flavor: str = "minsum_lut", check_every: int = 0,
                  engine: str = "auto"):
    """The fused wave step (refill-merge + K iterations + G-matrix decide)
    on the engine `engine` selects (see use_kernel)."""
    if use_kernel(engine):
        from polardecoding_tpu.ops.bp_kernel import bp_wave_fused_kernel

        return bp_wave_fused_kernel(state, ch_llr, retire, iters=iters,
                                    flavor=flavor, check_every=check_every)
    return bp_wave_fused_jnp(state, ch_llr, retire, iters=iters,
                             flavor=flavor, check_every=check_every)


@functools.partial(jax.jit, static_argnames=("iters", "flavor", "checkpoints"))
def bpr_decode(
    ch_llr,
    frozen,
    true_u,
    info_positions,
    iters: int = 90,
    flavor: str = "minsum_lut",
    checkpoints: tuple = (3, 6, 10, 20, 40, 80),
):
    """BPr instrumentation (ref: BPr_128.c:373-580): run BP, and at each
    checkpoint iteration snapshot per-stage hard decisions, propagate them
    leftward through the GF(2) butterfly inverse, and count info-bit errors.

    Returns (u_hat [B, N], stage_errors [num_checkpoints, n+1] summed over the
    batch — the reference's E table before division by run count).
    """
    chk_fn = {"minsum_lut": chk, "minsum_lut_fast": chk_fast,
              "spa": chk_exact}[flavor]
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    dt = ch_llr.dtype

    r0 = jnp.where(frozen, jnp.asarray(FROZEN_R, dt), jnp.asarray(0, dt))
    r0 = jnp.broadcast_to(r0, (B, N))
    Ls = [jnp.zeros((B, N), dt) for _ in range(n)] + [ch_llr]
    Rs = [r0] + [jnp.zeros((B, N), dt) for _ in range(n)]

    true_info = true_u[..., info_positions]
    errs = []
    # checkpoints are static and few: unroll segments between them.
    it = 0
    cps = sorted(checkpoints)
    segs = []
    prev = 0
    for c in cps:
        segs.append(c - prev)
        prev = c

    def run_iters(Ls, Rs, count):
        Larr, Rarr = _stack(Ls), _stack(Rs)

        def body(_, c):
            La, Ra = c
            ls, rs = bp_iteration(_unstack(La), _unstack(Ra), chk_fn)
            return _stack(ls), _stack(rs)

        Larr, Rarr = lax.fori_loop(0, count, body, (Larr, Rarr))
        return _unstack(Larr), _unstack(Rarr)

    for seg in segs:
        Ls, Rs = run_iters(Ls, Rs, seg)
        it += seg
        # snapshot: for each stage i, hard-decide b = sign(l + r) at stage i,
        # propagate left via (upper <- upper xor lower, lower <- lower), then
        # count errors over info bits (ref: BPr_128.c:418-441).
        stage_err = []
        for i in range(n + 1):
            b = (Ls[i] + Rs[i] < 0).astype(jnp.int8)
            for k in range(i - 1, -1, -1):
                up, lo = _halves(b, k)
                b = _merge(up ^ lo, lo, k, N)
            bad = b[..., info_positions] != true_info
            stage_err.append(jnp.sum(bad, dtype=jnp.int32))
        errs.append(jnp.stack(stage_err))

    # finish any remaining iterations up to iterMax
    if it < iters:
        Ls, Rs = run_iters(Ls, Rs, iters - it)
    soft = Ls[0] + Rs[0]
    u_hat = jnp.where(frozen, 0, (soft < 0)).astype(jnp.int8)
    return u_hat, jnp.stack(errs)
