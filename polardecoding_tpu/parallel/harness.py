"""Monte-Carlo simulation harness: batched frame pipeline + adaptive-stop sweep.

Array-program re-design of every reference program's main() (SURVEY §2.1 harness
row, §3.1-3.3 call stacks):

  reference (per frame, serial)            here (per super-batch, jit + sharded)
  ---------------------------------        -------------------------------------
  payload from PN window                   PN gather, frame-index arithmetic
  encode x = u . Fn  (O(N^2) stdin matrix) O(N log N) butterfly encode
  normal() noise loop                      counter-based per-frame keys
  decode                                   batched decoder (bp/sc/scl/cascl)
  count info-bit errors                    vectorized compare + scalar reduce
  stop when errBlock >= target             host-side stop on psum'd counters

Payloads and noise are pure functions of (seed, frame index), so results are
independent of batch size, device count, and sharding — the reference's
implicit resumability (SURVEY §5 checkpoint note) made explicit: any
(seed, frame-range) segment can be recomputed bit-identically.

Error-count conventions follow the reference exactly: block error = any
mismatch over the info set I (all K + r positions for CA-SCL,
CASCL_128.c:245-252; K positions otherwise, BP_128.c:203-210); BLER =
errBlock / run.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from polardecoding_tpu.configs import Preset
from polardecoding_tpu.models.bp import bp_decode_auto
from polardecoding_tpu.models.sc import sc_decode
from polardecoding_tpu.models.scl import cascl_decode, scl_decode
from polardecoding_tpu.ops.channel import awgn_llr
from polardecoding_tpu.ops.crc import check_matrix, crc_encode_multiplicative, crc_encode_systematic
from polardecoding_tpu.ops.encode import (
    encode_info_mxu,
    info_sub_generator,
    polar_encode,
    scatter_info,
)
from polardecoding_tpu.parallel.mesh import DATA_AXIS, batch_sharding, data_mesh, round_up_batch
from polardecoding_tpu.utils.pn import PN_PERIOD, pn_sequence
from polardecoding_tpu.analysis.construction import code_frozen_mask, code_info_set


@dataclasses.dataclass
class PointResult:
    """One SNR point — the structured replacement for the reference's four
    incompatible printf scales (SURVEY §5 metrics note)."""

    preset: str
    snr_db: float
    errbit: int
    errblock: int
    frames: int
    seed: int
    elapsed_s: float = 0.0
    # frames where an SCL selection hit an exact PM tie at the median — the
    # reference's "Oops!" condition (SCL_1024.c:620-633).  Zero everywhere
    # observed; nonzero would flag frames where our keep-exactly-L policy
    # could diverge from the reference's strict-below-median repack.
    pm_ties: int = 0

    @property
    def bler(self) -> float:
        return self.errblock / max(self.frames, 1)

    @property
    def errbits_per_frame(self) -> float:
        # raw bit errors per frame (can exceed 1); the reference's BER scale
        # (errbit / (frames * num_info)) needs num_info — see to_json
        return self.errbit / max(self.frames, 1)

    def to_json(self, num_info: int) -> dict:
        return {
            "preset": self.preset,
            "snr_db": self.snr_db,
            "errbit": self.errbit,
            "errblock": self.errblock,
            "frames": self.frames,
            "bler": self.bler,
            "ber": self.errbit / max(self.frames * num_info, 1),
            "seed": self.seed,
            "elapsed_s": self.elapsed_s,
            "pm_ties": self.pm_ties,
        }


def payload_from_index(frame_index, pn, K: int):
    """PN-window payload per frame (ref: SC_128.c:179-181, 214-215):
    payload[b, i] = PN[(m_b + i) % 63], m_b = (frame_index * (K % 63)) % 63."""
    step = K % PN_PERIOD
    m = (frame_index * step) % PN_PERIOD
    idx = (m[:, None] + jnp.arange(K)[None, :]) % PN_PERIOD
    return pn[idx]


def _make_encoder(encoder: str, info_positions, N: int) -> Callable:
    """Codeword map w [B, K'] -> x [B, N] in {0, 1}.  "mxu" computes the
    GF(2) product  x = (w . G_I) mod 2  as one bf16 matmul (bit-exact vs the
    butterfly — ops/encode.encode_info_mxu); "butterfly" is the scatter +
    O(N log N) xor-stage path.  Which is faster on the GPU is not
    measured."""
    if encoder == "mxu":
        g_rows = info_sub_generator(np.asarray(info_positions), N)
        return lambda w: encode_info_mxu(w, g_rows)
    assert encoder == "butterfly", encoder
    I = jnp.asarray(info_positions)
    return lambda w: polar_encode(scatter_info(w, I, N))


def per_shard(fn, mesh, in_specs, out_specs):
    """Run `fn` on each device's shard of the batch under a multi-device
    mesh.  The BP kernel is a foreign call with no sharding rule, so without
    this XLA would gather the whole batch onto every device; frames are
    independent, so the per-shard result is the same."""
    if mesh is None or mesh.devices.size == 1:
        return fn
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _make_decoder(dec, frozen, I, crc_R, bp_engine, mesh) -> Callable:
    """llr [B, N] -> (u_hat [B, N] int8, tie frame counter [B] int32 or
    None) for the preset's decoder.  BP runs per shard under a mesh
    (`per_shard`), since its GPU engine is a foreign kernel call."""
    if dec.kind == "bp":
        bp = per_shard(
            lambda llr: bp_decode_auto(
                llr, frozen, iters=dec.bp_iters, flavor=dec.bp_flavor,
                early_stop_every=(4 if dec.bp_early_stop else 0),
                engine=bp_engine),
            mesh, P(DATA_AXIS), P(DATA_AXIS))
        return lambda llr: (bp(llr), None)
    if dec.kind == "sc":
        return lambda llr: (sc_decode(llr, frozen), None)
    if dec.kind == "scl":
        return lambda llr: scl_decode(llr, frozen, list_size=dec.list_size,
                                      return_ties=True)
    if dec.kind == "cascl":
        return lambda llr: cascl_decode(llr, frozen, tuple(np.asarray(I)),
                                        crc_R, list_size=dec.list_size,
                                        return_ties=True)
    raise ValueError(f"unknown decoder kind {dec.kind!r}")


def make_frame_step(preset: Preset, batch: int, mesh=None,
                    llr_dtype=None, bp_engine="auto",
                    encoder="mxu") -> Callable:
    """Build the jitted super-batch step: (key, frame_start, sigma) ->
    (errbit, errblock, pm_ties) int32 scalars summed over the batch
    (pm_ties = frames with an SCL median PM tie; 0 for non-list decoders).

    llr_dtype: optional message-state dtype for the decoder (e.g.
    jnp.bfloat16); channel LLRs are cast once before decode.  Default None
    keeps the f32 production path (results/REPRODUCTION.md precision study).
    bp_engine: "auto" (the CUDA kernel on the GPU, the plain engine
    elsewhere), "jnp" or "kernel" — models/bp.use_kernel.
    encoder: "mxu" (default) or "butterfly" — bit-identical codewords
    (tests/test_harness.py), so every counter is encoder-independent."""
    code, dec = preset.code, preset.decoder
    N, K = code.N, code.K
    num_info = code.num_info
    I = jnp.asarray(code_info_set(code))
    frozen = jnp.asarray(code_frozen_mask(code))
    pn = jnp.asarray(pn_sequence())
    crc_R = check_matrix(code.crc, num_info) if code.crc else None
    encode = _make_encoder(encoder, code_info_set(code), N)
    shard = batch_sharding(mesh) if mesh is not None and mesh.devices.size > 1 else None
    decode = _make_decoder(dec, frozen, I, crc_R, bp_engine, mesh)

    @jax.jit
    def step(key, frame_start, sigma):
        fidx = frame_start + jnp.arange(batch, dtype=jnp.int32)
        if shard is not None:
            fidx = lax.with_sharding_constraint(fidx, shard)
        payload = payload_from_index(fidx, pn, K)
        if code.crc is None:
            w = payload
        elif code.crc_style == "systematic":
            w = crc_encode_systematic(payload, code.crc)
        else:
            w = crc_encode_multiplicative(payload, code.crc)
        x = encode(w)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        llr = awgn_llr(x, keys, sigma)
        if llr_dtype is not None:
            llr = llr.astype(llr_dtype)
        u_hat, ties = decode(llr)
        bad = u_hat[:, I] != w
        errbit = jnp.sum(bad, dtype=jnp.int32)
        errblock = jnp.sum(jnp.any(bad, axis=-1), dtype=jnp.int32)
        pm_ties = (jnp.int32(0) if ties is None
                   else jnp.sum((ties > 0).astype(jnp.int32)))
        return errbit, errblock, pm_ties

    return step


def make_multisnr_step(preset: Preset, batch: int, num_snr: int, mesh=None,
                       llr_dtype=None, bp_engine="auto", encoder="mxu"):
    """Fold the SNR sweep into the batch (SURVEY §2.5 "SNR-sweep
    parallelism"): frame i runs at sigma[i % num_snr]; counters come back
    per SNR point.  One compiled step serves the whole sweep — useful for
    deep sweeps with a fixed frame budget, where per-point adaptive stopping
    would leave the chip underutilized on the easy points.

    Same knobs as make_frame_step (llr_dtype for e.g. bfloat16 message
    state, which needs bp_engine="jnp" on the GPU: the BP kernel is
    float32-only), and
    the same pm_ties observability: returns (errbit, errblock, frames,
    pm_ties), each [num_snr] int32."""
    code, dec = preset.code, preset.decoder
    N, K = code.N, code.K
    num_info = code.num_info
    I = jnp.asarray(code_info_set(code))
    frozen = jnp.asarray(code_frozen_mask(code))
    pn = jnp.asarray(pn_sequence())
    crc_R = check_matrix(code.crc, num_info) if code.crc else None
    encode = _make_encoder(encoder, code_info_set(code), N)
    shard = batch_sharding(mesh) if mesh is not None and mesh.devices.size > 1 else None
    decode = _make_decoder(dec, frozen, I, crc_R, bp_engine, mesh)

    @jax.jit
    def step(key, frame_start, sigmas):
        fidx = frame_start + jnp.arange(batch, dtype=jnp.int32)
        if shard is not None:
            fidx = lax.with_sharding_constraint(fidx, shard)
        snr_idx = fidx % num_snr
        payload = payload_from_index(fidx, pn, K)
        if code.crc is None:
            w = payload
        elif code.crc_style == "systematic":
            w = crc_encode_systematic(payload, code.crc)
        else:
            w = crc_encode_multiplicative(payload, code.crc)
        x = encode(w)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        llr = awgn_llr(x, keys, sigmas[snr_idx])
        if llr_dtype is not None:
            llr = llr.astype(llr_dtype)
        u_hat, ties = decode(llr)
        bad = u_hat[:, I] != w
        errbit = jax.ops.segment_sum(
            jnp.sum(bad, axis=-1, dtype=jnp.int32), snr_idx, num_snr
        )
        errblock = jax.ops.segment_sum(
            jnp.any(bad, axis=-1).astype(jnp.int32), snr_idx, num_snr
        )
        frames = jax.ops.segment_sum(
            jnp.ones_like(snr_idx), snr_idx, num_snr
        )
        tie_frames = (jnp.zeros(num_snr, jnp.int32) if ties is None
                      else jax.ops.segment_sum(
                          (ties > 0).astype(jnp.int32), snr_idx, num_snr))
        return errbit, errblock, frames, tie_frames

    return step


def run_fused_sweep(
    preset: Preset,
    snr_points,
    total_frames: int,
    batch: int = 4096,
    mesh=None,
    seed: Optional[int] = None,
    llr_dtype=None,
    bp_engine: str = "auto",
    encoder: str = "mxu",
) -> list[PointResult]:
    """Fixed-budget sweep with all SNR points fused into every batch.

    llr_dtype / bp_engine / encoder pass through to make_multisnr_step, so
    e.g. the precision study's bf16 + jnp-engine fallback combination
    (results/REPRODUCTION.md precision part 2) is reachable from this entry
    point too: run_fused_sweep(..., llr_dtype=jnp.bfloat16, bp_engine="jnp").
    """
    seed = preset.sweep.seed if seed is None else seed
    snrs = list(snr_points)
    sigmas = jnp.asarray([10.0 ** (-s / 20.0) for s in snrs], jnp.float32)
    step = make_multisnr_step(preset, batch, len(snrs), mesh,
                              llr_dtype=llr_dtype, bp_engine=bp_engine,
                              encoder=encoder)
    key = jax.random.PRNGKey(seed)
    eb = np.zeros(len(snrs), np.int64)
    ebl = np.zeros(len(snrs), np.int64)
    fr = np.zeros(len(snrs), np.int64)
    ties = np.zeros(len(snrs), np.int64)
    t0 = time.perf_counter()
    done = 0
    while done < total_frames:
        a, b, c, d = step(key, jnp.int32(done), sigmas)
        eb += np.asarray(a)
        ebl += np.asarray(b)
        fr += np.asarray(c)
        ties += np.asarray(d)
        done += batch
    dt = time.perf_counter() - t0
    return [
        PointResult(preset.name, snrs[i], int(eb[i]), int(ebl[i]), int(fr[i]),
                    seed, dt * fr[i] / max(done, 1), pm_ties=int(ties[i]))
        for i in range(len(snrs))
    ]


def make_wave_step(preset: Preset, batch: int, wave_iters: int = 8,
                   mesh=None, fused: bool = True,
                   encoder: str = "mxu",
                   check_every: int = 0,
                   bp_engine: str = "auto") -> tuple[Callable, Callable]:
    """Continuous-batching BP stepper (the production early-stop engine).

    Returns (init, step):
      init(key, frame_start, sigma) -> carry
      step(key, sigma, carry) -> (carry', (errbit, errblock, frames) int32)

    carry = (state [2(n+1), B, N], fidx [B] i32, iters_done [B] i32,
             next_fidx i32).  Each step advances EVERY in-flight frame by
    `wave_iters` BP iterations, retires frames whose per-frame G-matrix check passes or
    that reached iterMax, counts their info-bit errors, and refills the freed
    slots with fresh frames IN PLACE (no compaction: slots are independent).

    A frame's decision here is taken at its own first wave boundary where
    its check passes — a pure function of (seed, frame index, wave_iters),
    independent of batch size and sharding.  Throughput at operating SNRs
    approaches iterMax / E[convergence iters] times the fixed-iteration
    engine because no slot ever idles waiting for a slow frame.

    fused=True runs refill-merge + wave + decide as one step per wave
    (models/bp.bp_wave_fused: on the GPU one shared-memory kernel launch,
    chosen by `bp_engine` as in models/bp.use_kernel), eliminating the
    decide and where-merge full-state passes; the refill of a step's retirees then happens at the
    HEAD of the next step's kernel (the merge commutes with the retire
    bookkeeping), so the carry additionally holds the pending retire mask.

    check_every > 0 (fused only) additionally runs the G-matrix check every
    `check_every` iterations inside the wave step with a per-frame latch:
    a frame whose rule passes mid-wave retires at this wave's boundary with
    its first-passing decision, instead of paying further waves until a
    boundary check happens to align.  Decisions
    stay pure in (seed, frame index, wave_iters, check_every).
    Frame issue order, per-frame decisions, and every step's counter outputs
    are bit-identical to fused=False (tested in test_harness); total issued
    frames differ only at drain time (the unfused path refills once more
    before draining, the fused path leaves that refill unissued) — both
    drains census every issued frame exactly once, so both are unbiased.
    """
    from polardecoding_tpu.models.bp import (
        bp_wave,
        bp_wave_fused,
        wave_decide,
        wave_init_state,
    )

    code, dec = preset.code, preset.decoder
    assert dec.kind == "bp", "wave stepping is a BP engine"
    N, K = code.N, code.K
    iter_max = dec.bp_iters
    I = jnp.asarray(code_info_set(code))
    frozen = jnp.asarray(code_frozen_mask(code))
    pn = jnp.asarray(pn_sequence())
    encode = _make_encoder(encoder, code_info_set(code), N)
    shard = batch_sharding(mesh) if mesh is not None and mesh.devices.size > 1 else None

    def fresh_llr(key, fidx, sigma):
        payload = payload_from_index(fidx, pn, K)
        x = encode(payload)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        return awgn_llr(x, keys, sigma), payload

    assert not (check_every and not fused), \
        "check_every needs the fused wave step"
    st_spec = P(None, DATA_AXIS, None)  # state is stage-major [2(n+1), B, N]
    wave_fused = per_shard(
        lambda state, llr, retire: bp_wave_fused(
            state, llr, retire, iters=wave_iters, flavor=dec.bp_flavor,
            check_every=check_every, engine=bp_engine),
        mesh, (st_spec, P(DATA_AXIS), P(DATA_AXIS)),
        (st_spec, P(DATA_AXIS), P(DATA_AXIS)))

    if fused:
        @jax.jit
        def init_fused(key, frame_start, sigma):
            # no frames issued yet: every slot is marked retired, so the
            # FIRST step's kernel merge performs the initial fill (fidx
            # assignment there gives frame_start + arange, matching the
            # unfused init exactly)
            llr0 = jnp.zeros((batch, N), jnp.float32)
            if shard is not None:
                llr0 = lax.with_sharding_constraint(llr0, shard)
            state = wave_init_state(llr0, frozen)
            return (state, jnp.zeros(batch, jnp.int32),
                    jnp.zeros(batch, jnp.int32), jnp.int32(frame_start),
                    jnp.ones(batch, bool))

        @functools.partial(jax.jit, donate_argnums=(2,))
        def step_fused(key, sigma, carry):
            state, fidx, iters_done, next_fidx, retire = carry
            # refill bookkeeping for last wave's retirees (their state is
            # re-initialized inside the kernel below)
            rank = jnp.cumsum(retire.astype(jnp.int32)) - 1
            fidx = jnp.where(retire, next_fidx + rank, fidx)
            next_fidx = next_fidx + jnp.sum(retire, dtype=jnp.int32)
            iters_done = jnp.where(retire, 0, iters_done)
            llr, _ = fresh_llr(key, fidx, sigma)
            state, u_hat, done = wave_fused(state, llr, retire)
            iters_done = iters_done + wave_iters
            retire_new = done | (iters_done >= iter_max)
            payload = payload_from_index(fidx, pn, K)
            bad = (u_hat[:, I] != payload) & retire_new[:, None]
            errbit = jnp.sum(bad, dtype=jnp.int32)
            errblock = jnp.sum(jnp.any(bad, axis=-1), dtype=jnp.int32)
            frames = jnp.sum(retire_new, dtype=jnp.int32)
            return (state, fidx, iters_done, next_fidx, retire_new), (
                errbit, errblock, frames)

        @functools.partial(jax.jit, donate_argnums=(1,))
        def drain_fused(sigma, carry):
            state, fidx, iters_done, next_fidx, retire = carry
            # pending retirees were already counted by the last step: mark
            # dead instead of refilling (slots die, fidx = -1)
            fidx = jnp.where(retire, -1, fidx)
            no_retire = jnp.zeros(batch, bool)
            state, u_hat, done = wave_fused(
                state, jnp.zeros((batch, N), state.dtype), no_retire)
            iters_done = iters_done + wave_iters
            alive = fidx >= 0
            retire_new = (done | (iters_done >= iter_max)) & alive
            payload = payload_from_index(jnp.maximum(fidx, 0), pn, K)
            bad = (u_hat[:, I] != payload) & retire_new[:, None]
            errbit = jnp.sum(bad, dtype=jnp.int32)
            errblock = jnp.sum(jnp.any(bad, axis=-1), dtype=jnp.int32)
            frames = jnp.sum(retire_new, dtype=jnp.int32)
            fidx = jnp.where(retire_new, -1, fidx)
            remaining = jnp.sum((fidx >= 0).astype(jnp.int32))
            return (state, fidx, iters_done, next_fidx, no_retire), (
                errbit, errblock, frames, remaining)

        return init_fused, step_fused, drain_fused

    @jax.jit
    def init(key, frame_start, sigma):
        fidx = frame_start + jnp.arange(batch, dtype=jnp.int32)
        if shard is not None:
            fidx = lax.with_sharding_constraint(fidx, shard)
        llr, _ = fresh_llr(key, fidx, sigma)
        state = wave_init_state(llr, frozen)
        return (state, fidx, jnp.zeros(batch, jnp.int32),
                frame_start + jnp.int32(batch))

    # The carry is donated: the old state buffer is dead the moment the wave
    # kernel writes the new one, and donation lets XLA update it in place
    # (~90 KB/frame of HBM churn otherwise).  CPU ignores donation (tests
    # unaffected); callers must not reuse a carry after stepping it.
    @functools.partial(jax.jit, donate_argnums=(2,))
    def step(key, sigma, carry):
        state, fidx, iters_done, next_fidx = carry
        state = bp_wave(state, iters=wave_iters, flavor=dec.bp_flavor)
        iters_done = iters_done + wave_iters
        u_hat, done = wave_decide(state, frozen)
        retire = done | (iters_done >= iter_max)
        # count info-bit errors of retired frames against their payloads
        payload = payload_from_index(fidx, pn, K)
        bad = (u_hat[:, I] != payload) & retire[:, None]
        errbit = jnp.sum(bad, dtype=jnp.int32)
        errblock = jnp.sum(jnp.any(bad, axis=-1), dtype=jnp.int32)
        frames = jnp.sum(retire, dtype=jnp.int32)
        # refill retired slots in place with the next frame indices
        rank = jnp.cumsum(retire.astype(jnp.int32)) - 1
        fidx = jnp.where(retire, next_fidx + rank, fidx)
        next_fidx = next_fidx + frames
        llr, _ = fresh_llr(key, fidx, sigma)
        fresh = wave_init_state(llr, frozen)
        state = jnp.where(retire[None, :, None], fresh, state)
        iters_done = jnp.where(retire, 0, iters_done)
        return (state, fidx, iters_done, next_fidx), (errbit, errblock, frames)

    @functools.partial(jax.jit, donate_argnums=(1,))
    def drain_step(sigma, carry):
        """Like step but retires WITHOUT refilling (slots die, fidx = -1).

        Required for unbiased adaptive stopping: frames still in flight when
        the error target fires are disproportionately the slow-converging
        (= likely erroneous) ones; stopping without draining censors them
        and biases BLER low.  Draining counts every issued frame exactly
        once."""
        state, fidx, iters_done, next_fidx = carry
        state = bp_wave(state, iters=wave_iters, flavor=dec.bp_flavor)
        iters_done = iters_done + wave_iters
        u_hat, done = wave_decide(state, frozen)
        alive = fidx >= 0
        retire = (done | (iters_done >= iter_max)) & alive
        payload = payload_from_index(jnp.maximum(fidx, 0), pn, K)
        bad = (u_hat[:, I] != payload) & retire[:, None]
        errbit = jnp.sum(bad, dtype=jnp.int32)
        errblock = jnp.sum(jnp.any(bad, axis=-1), dtype=jnp.int32)
        frames = jnp.sum(retire, dtype=jnp.int32)
        fidx = jnp.where(retire, -1, fidx)
        remaining = jnp.sum((fidx >= 0).astype(jnp.int32))
        return (state, fidx, iters_done, next_fidx), (
            errbit, errblock, frames, remaining)

    return init, step, drain_step


def run_point_waves(
    preset: Preset,
    snr_db: float,
    batch: Optional[int] = None,
    wave_iters: int = 8,
    mesh=None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    seed: Optional[int] = None,
    start_state: Optional[PointResult] = None,
    log: Optional[Callable[[str], None]] = None,
    fused: bool = True,
    check_every: int = 0,
) -> PointResult:
    """Adaptive MC at one SNR point on the continuous-batching BP engine
    (make_wave_step)."""
    sweep = preset.sweep
    seed = sweep.seed if seed is None else seed
    target = sweep.error_blocks if error_blocks is None else error_blocks
    cap = sweep.max_frames if max_frames is None else max_frames
    if mesh is None:
        mesh = data_mesh()
    if batch is None:
        batch = round_up_batch(sweep.batch_per_device * mesh.devices.size, mesh)
    init, step, drain_step = make_wave_step(preset, batch, wave_iters, mesh,
                                            fused=fused,
                                            check_every=check_every)
    sigma = float(10.0 ** (-snr_db / 20.0))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), int(round(snr_db * 100)))
    res = start_state or PointResult(preset.name, snr_db, 0, 0, 0, seed)
    carry = init(key, jnp.int32(res.frames), sigma)
    t0 = time.perf_counter()
    # `sync_every` steps run as one dispatch via lax.scan (counters summed
    # on device, one scalar triple read per chunk), so the host syncs once
    # per chunk.  The value 8 is a plain chunking default: its effect on
    # the GPU is not measured.  Decisions are unchanged — the scan body IS
    # step(), in the same order.
    sync_every = 8

    @functools.partial(jax.jit, donate_argnums=(2,))
    def chunk(key, sigma, carry):
        def body(c, _):
            c2, out = step(key, sigma, c)
            return c2, out

        carry, (eb, ebl, fr) = lax.scan(body, carry, None,
                                        length=sync_every)
        return carry, (jnp.sum(eb), jnp.sum(ebl), jnp.sum(fr))

    # One-chunk lookahead: sync chunk i's counters while chunk i+1 runs
    # (the stop check then lags one chunk — overshoot frames are counted,
    # MC stays unbiased, exactly as the old 8-step enqueue overshot).
    pending = None
    while res.errblock < target and res.frames < cap:
        carry, out = chunk(key, sigma, carry)
        if pending is not None:
            res.errbit += int(pending[0])
            res.errblock += int(pending[1])
            res.frames += int(pending[2])
        pending = out
        if log:
            # counted frames lag one chunk behind dispatch (the lookahead)
            log(
                f"{preset.name} @ {snr_db:.2f} dB (waves): "
                f"counted={res.frames} errblock={res.errblock} "
                f"bler={res.bler:.3e}"
            )
    if pending is not None:
        res.errbit += int(pending[0])
        res.errblock += int(pending[1])
        res.frames += int(pending[2])
    # drain in-flight frames so slow (error-prone) frames are not censored
    remaining = batch
    while remaining > 0:
        carry, (eb, ebl, fr, rem) = drain_step(sigma, carry)
        res.errbit += int(eb)
        res.errblock += int(ebl)
        res.frames += int(fr)
        remaining = int(rem)
    res.elapsed_s += time.perf_counter() - t0
    return res


def make_bpr_step(preset: Preset, batch: int, mesh=None) -> Callable:
    """BPr instrumentation step (ref: BPr_128.c): like make_frame_step but also
    accumulates the per-checkpoint per-stage info-bit error table E
    (shape [num_checkpoints, n+1], summed over frames; the reference reports
    E / run, BPr_128.c:229-255)."""
    from polardecoding_tpu.models.bp import bpr_decode

    code, dec = preset.code, preset.decoder
    N, K = code.N, code.K
    I = jnp.asarray(code_info_set(code))
    frozen = jnp.asarray(code_frozen_mask(code))
    pn = jnp.asarray(pn_sequence())
    shard = batch_sharding(mesh) if mesh is not None and mesh.devices.size > 1 else None

    @jax.jit
    def step(key, frame_start, sigma):
        fidx = frame_start + jnp.arange(batch, dtype=jnp.int32)
        if shard is not None:
            fidx = lax.with_sharding_constraint(fidx, shard)
        payload = payload_from_index(fidx, pn, K)
        u = scatter_info(payload, I, N)
        x = polar_encode(u)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        llr = awgn_llr(x, keys, sigma)
        u_hat, stage_errs = bpr_decode(
            llr, frozen, u, I, iters=dec.bp_iters, flavor=dec.bp_flavor,
            checkpoints=dec.bpr_checkpoints,
        )
        bad = u_hat[:, I] != payload
        errbit = jnp.sum(bad, dtype=jnp.int32)
        errblock = jnp.sum(jnp.any(bad, axis=-1), dtype=jnp.int32)
        return errbit, errblock, stage_errs

    return step


def run_bpr_point(
    preset: Preset,
    snr_db: float,
    batch: int = 256,
    mesh=None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    seed: Optional[int] = None,
):
    """Run BPr at one SNR point.  Returns (PointResult, E [checkpoints, n+1])
    with E summed over frames (divide by frames for the reference's table)."""
    sweep = preset.sweep
    seed = sweep.seed if seed is None else seed
    target = sweep.error_blocks if error_blocks is None else error_blocks
    cap = sweep.max_frames if max_frames is None else max_frames
    step_fn = make_bpr_step(preset, batch, mesh)
    sigma = float(10.0 ** (-snr_db / 20.0))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), int(round(snr_db * 100)))
    res = PointResult(preset.name, snr_db, 0, 0, 0, seed)
    E = None
    t0 = time.perf_counter()
    while res.errblock < target and res.frames < cap:
        eb, ebl, se = step_fn(key, jnp.int32(res.frames), sigma)
        res.errbit += int(eb)
        res.errblock += int(ebl)
        res.frames += batch
        E = np.asarray(se, dtype=np.int64) if E is None else E + np.asarray(se)
    res.elapsed_s = time.perf_counter() - t0
    return res, E


def run_point(
    preset: Preset,
    snr_db: float,
    batch: Optional[int] = None,
    mesh=None,
    step_fn: Optional[Callable] = None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    seed: Optional[int] = None,
    start_state: Optional[PointResult] = None,
    log: Optional[Callable[[str], None]] = None,
    sync_every: Optional[int] = None,
) -> PointResult:
    """Adaptive-length MC for one SNR point: run super-batches until the
    error-block target (ref stop rule, e.g. BP_128.c:168).

    sync_every overrides the steps-per-dispatch chunking (default: 8 on an
    accelerator, 1 on CPU).

    BP early-stop presets (decoder.bp_early_stop) are served by the
    continuous-batching wave engine (run_point_waves): each frame retires at
    its own convergence wave.  The per-check early stop (bp_decode
    early_stop_every, reachable via an explicit step_fn) latches each
    frame's decision at its own first passing check, so BOTH paths are pure
    in (seed, frame index); they differ only in check granularity (wave
    boundary vs every early_stop_every iterations) and throughput."""
    if (step_fn is None and preset.decoder.kind == "bp"
            and preset.decoder.bp_early_stop):
        return run_point_waves(
            preset, snr_db, batch=batch, mesh=mesh,
            error_blocks=error_blocks, max_frames=max_frames, seed=seed,
            start_state=start_state, log=log,
        )
    sweep = preset.sweep
    seed = sweep.seed if seed is None else seed
    target = sweep.error_blocks if error_blocks is None else error_blocks
    cap = sweep.max_frames if max_frames is None else max_frames
    if mesh is None:
        mesh = data_mesh()
    if batch is None:
        batch = round_up_batch(sweep.batch_per_device * mesh.devices.size, mesh)
    if step_fn is None:
        step_fn = make_frame_step(preset, batch, mesh)

    sigma = float(10.0 ** (-snr_db / 20.0))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), int(round(snr_db * 100)))
    res = start_state or PointResult(preset.name, snr_db, 0, 0, 0, seed)
    t0 = time.perf_counter()
    # On an accelerator, run `sync_every` steps per dispatch via lax.scan
    # (distinct frame_start per inner step — frames stay pure in frame
    # index) and sync one chunk behind (overshoot frames are counted; MC
    # unbiased).  8 is a plain chunking default; its effect on the GPU is
    # not measured.  CPU keeps the one-step path: tests' tiny adaptive
    # points would pay 8x overshoot for nothing.
    if sync_every is None:
        sync_every = 1 if jax.default_backend() == "cpu" else 8

    if sync_every == 1:
        while res.errblock < target and res.frames < cap:
            eb, ebl, ties = step_fn(key, jnp.int32(res.frames), sigma)
            res.errbit += int(eb)
            res.errblock += int(ebl)
            res.pm_ties += int(ties)
            res.frames += batch
            if log:
                log(
                    f"{preset.name} @ {snr_db:.2f} dB: frames={res.frames} "
                    f"errblock={res.errblock} bler={res.bler:.3e}"
                )
        res.elapsed_s += time.perf_counter() - t0
        return res

    # the chunk is cached ON the step_fn so a run_sweep's points (which
    # share one step_fn precisely to compile once) also share one traced
    # scan program instead of re-tracing the 8-step wrapper per SNR point
    chunk = getattr(step_fn, "_pd_chunk", None)
    if chunk is None or getattr(step_fn, "_pd_chunk_cfg", None) != (
            batch, sync_every):

        @jax.jit
        def chunk(key, frame_start, sigma):
            def body(c, i):
                eb, ebl, ties = step_fn(key, frame_start + i * batch, sigma)
                return c, (eb, ebl, ties)

            _, (eb, ebl, ties) = lax.scan(
                body, jnp.int32(0), jnp.arange(sync_every, dtype=jnp.int32))
            return jnp.sum(eb), jnp.sum(ebl), jnp.sum(ties)

        try:
            step_fn._pd_chunk = chunk
            step_fn._pd_chunk_cfg = (batch, sync_every)
        except AttributeError:
            # non-assignable callables retrace the 8-step scan wrapper per
            # point, a recompile at every SNR point — make it loud
            import logging

            logging.getLogger(__name__).warning(
                "run_point: step_fn %r does not accept attributes; the "
                "%d-step scan wrapper will RETRACE (and recompile) at "
                "every SNR point — wrap the callable in a function or "
                "functools.partial to enable caching", step_fn, sync_every)

    def take(out):
        res.errbit += int(out[0])
        res.errblock += int(out[1])
        res.pm_ties += int(out[2])
        res.frames += batch * sync_every

    issued = res.frames  # frames dispatched (res.frames lags one chunk)
    pending = None
    while res.errblock < target and res.frames < cap:
        out = chunk(key, jnp.int32(issued), sigma)
        issued += batch * sync_every
        if pending is not None:
            take(pending)
        pending = out
        if log:
            # counters lag one chunk behind dispatch (the lookahead): log
            # both so progress is not under-reported (advisor r4)
            log(
                f"{preset.name} @ {snr_db:.2f} dB: issued={issued} "
                f"counted={res.frames} errblock={res.errblock} "
                f"bler={res.bler:.3e}"
            )
    if pending is not None:
        take(pending)
    res.elapsed_s += time.perf_counter() - t0
    return res


def run_multiseed(
    preset: Preset,
    seeds,
    snr_points=None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    batch: Optional[int] = None,
    mesh=None,
    log: Optional[Callable[[str], None]] = None,
):
    """The reference's multi-seed replication methodology as a feature
    (SURVEY §2.5/§4.6: independent seeds per configuration, averaged by the
    plot scripts).  Returns (per_seed: {seed: [PointResult]}, averaged:
    [dict]) where each averaged record pools error counts over seeds —
    equivalent to plot_SCL.py's row averaging but weighted by frames."""
    per_seed = {}
    for seed in seeds:
        per_seed[seed] = run_sweep(
            preset, batch=batch, mesh=mesh, snr_points=snr_points,
            error_blocks=error_blocks, max_frames=max_frames, seed=seed,
            log=log,
        )
    averaged = []
    points = [r.snr_db for r in per_seed[seeds[0]]]
    for i, snr in enumerate(points):
        frames = sum(per_seed[s][i].frames for s in seeds)
        errblock = sum(per_seed[s][i].errblock for s in seeds)
        errbit = sum(per_seed[s][i].errbit for s in seeds)
        averaged.append(
            {
                "preset": preset.name,
                "snr_db": snr,
                "seeds": list(seeds),
                "frames": frames,
                "errblock": errblock,
                "bler": errblock / max(frames, 1),
                "ber": errbit / max(frames * preset.code.num_info, 1),
            }
        )
    return per_seed, averaged


def run_sweep(
    preset: Preset,
    batch: Optional[int] = None,
    mesh=None,
    snr_points=None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    seed: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    log: Optional[Callable[[str], None]] = None,
) -> list[PointResult]:
    """Full SNR sweep with optional JSON checkpointing (rerunnable shards:
    SURVEY §5 failure-detection note — counters checkpointed per point)."""
    if mesh is None:
        mesh = data_mesh()
    if batch is None:
        batch = round_up_batch(preset.sweep.batch_per_device * mesh.devices.size, mesh)
    # ES presets go through run_point's wave-engine dispatch (per-frame
    # retirement); a shared batch-global step here would override it
    wave_es = preset.decoder.kind == "bp" and preset.decoder.bp_early_stop
    step_fn = None if wave_es else make_frame_step(preset, batch, mesh)
    points = preset.sweep.snr_points() if snr_points is None else list(snr_points)

    done: dict[float, PointResult] = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            for rec in json.load(f):
                done[rec["snr_db"]] = PointResult(
                    rec["preset"], rec["snr_db"], rec["errbit"], rec["errblock"],
                    rec["frames"], rec["seed"], rec.get("elapsed_s", 0.0),
                    pm_ties=rec.get("pm_ties", 0),
                )

    results = []
    for snr in points:
        res = run_point(
            preset, snr, batch=batch, mesh=mesh, step_fn=step_fn,
            error_blocks=error_blocks, max_frames=max_frames, seed=seed,
            start_state=done.get(snr), log=log,
        )
        results.append(res)
        if checkpoint_path:
            with open(checkpoint_path, "w") as f:
                json.dump(
                    [r.to_json(preset.code.num_info) for r in results], f, indent=1
                )
        if log:
            log(
                f"DONE {preset.name} @ {snr:.2f} dB: BLER={res.bler:.4e} "
                f"({res.errblock}/{res.frames})"
            )
    return results
