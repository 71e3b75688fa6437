"""Chip check: drive the Monte-Carlo pipeline once on one NVIDIA GPU.

    python chip_smoke.py          # one card: the phases below, in order
    python chip_smoke.py --four   # four cards: the data-parallel mesh only

Phases (one card):
  1. card     the card's name and power limit (nvidia-smi, a child process)
  2. compile  each main-path step at full width, with memory_analysis():
              BP_1024 frame step B=8192, BP_1024_FASTCHK fused wave step
              B=16384 K=8, SCL_1024_L8 and CASCL_1024_L8 frame steps B=16384
  3. kernel   the CUDA BP kernel against the plain engines on the same
              channel LLRs at 2.0 dB (N=1024, B=8192 and B=16384), a
              256-frame slice against the CPU backend, and the two GF(2)
              encoders against each other
  4. timing   each kernel entry end to end against engine="jnp", in turns
              jnp, kernel, kernel, jnp
  5. run      `cli run` BP_1024 @ 2.0 dB and SCL_1024_L8 @ 1.5 dB to their
              error-block targets, BLER checked against BASELINE.md
The last line of standard output is one JSON object naming the device; it
is printed only when every phase passed.  Without a GPU the script exits
non-zero before printing anything of the kind.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

SNR_DB = 2.0
BP_BATCH = 8192
WAVE_BATCH = 16384
WAVE_K = 8
SCL_BATCH = 16384
# (preset, snr_db, expected BLER, absolute tolerance): BASELINE.md values,
# the tolerances of scripts/verify_drive.py
BLER_CHECKS = [("BP_1024", 2.0, 0.02948, 0.008),
               ("SCL_1024_L8", 1.5, 0.04721, 0.012)]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """Fail the phase (and the run's exit code) unless `ok`."""
    if not ok:
        raise RuntimeError(msg)


def sigma_of(snr_db: float) -> float:
    return float(10.0 ** (-snr_db / 20.0))


def channel_llr(preset_name: str, batch: int, seed: int = 7,
                snr_db: float = SNR_DB):
    """Channel LLRs [batch, N] of frames 0..batch-1 through the harness's
    own payload, encoder and AWGN channel."""
    import jax
    import jax.numpy as jnp

    from polardecoding_tpu.analysis.construction import code_info_set
    from polardecoding_tpu.configs import preset
    from polardecoding_tpu.ops.channel import awgn_llr
    from polardecoding_tpu.ops.encode import polar_encode, scatter_info
    from polardecoding_tpu.parallel.harness import payload_from_index
    from polardecoding_tpu.utils.pn import pn_sequence

    code = preset(preset_name).code
    I = jnp.asarray(code_info_set(code))
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def make():
        fidx = jnp.arange(batch, dtype=jnp.int32)
        w = payload_from_index(fidx, jnp.asarray(pn_sequence()), code.K)
        x = polar_encode(scatter_info(w, I, code.N))
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        return awgn_llr(x, keys, sigma_of(snr_db))

    return make()


# --------------------------------------------------------------------------
# phase 2: compile at full width


def phase_compile() -> None:
    import jax
    import jax.numpy as jnp

    from polardecoding_tpu.configs import preset
    from polardecoding_tpu.parallel.harness import make_frame_step, make_wave_step

    key = jax.random.PRNGKey(1)
    sigma = jnp.float32(sigma_of(SNR_DB))
    for name, batch in (("BP_1024", BP_BATCH), ("SCL_1024_L8", SCL_BATCH),
                        ("CASCL_1024_L8", SCL_BATCH)):
        t0 = time.perf_counter()
        step = make_frame_step(preset(name), batch)
        compiled = step.lower(key, jnp.int32(0), sigma).compile()
        log(f"[compile] {name} frame step B={batch}: "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{compiled.memory_analysis()}")
    t0 = time.perf_counter()
    init, step, _ = make_wave_step(preset("BP_1024_FASTCHK"), WAVE_BATCH,
                                   WAVE_K)
    carry = jax.eval_shape(init, key, jnp.int32(0), sigma)
    compiled = step.lower(key, sigma, carry).compile()
    log(f"[compile] BP_1024_FASTCHK fused wave step B={WAVE_BATCH} "
        f"K={WAVE_K}: {time.perf_counter() - t0:.1f} s; "
        f"{compiled.memory_analysis()}")


# --------------------------------------------------------------------------
# phase 3: kernel against the plain engines


def bler_bound(errors_a: int, errors_b: int, frames: int) -> bool:
    """Two BLERs over the same `frames` agree within a 3-sigma binomial
    bound (of the pooled estimate; one error of slack for p ~ 0)."""
    p = (errors_a + errors_b) / (2 * frames)
    sd = math.sqrt(max(p * (1 - p), 1e-12) * 2 / frames)
    return abs(errors_a - errors_b) / frames <= 3 * sd + 1.0 / frames


def compare_decisions(tag, u_ker, u_ref, conv, payload_bad_ker,
                      payload_bad_ref) -> None:
    """Bits equal on every frame both engines converged on; BLERs within
    the 3-sigma bound over all frames."""
    diff = np.any(u_ker != u_ref, axis=-1)
    on_conv = int(np.sum(diff & conv))
    ea, eb = int(payload_bad_ker.sum()), int(payload_bad_ref.sum())
    frames = len(diff)
    log(f"[kernel] {tag}: frames={frames} converged={int(conv.sum())} "
        f"differing={int(diff.sum())} (on converged: {on_conv}) "
        f"block errors kernel={ea} reference={eb}")
    check(on_conv == 0, f"{tag}: decisions differ on converged frames")
    check(bler_bound(ea, eb, frames), f"{tag}: BLERs disagree")


def assert_close(tag, a, b, rtol=1e-5) -> None:
    """float32 messages equal within rtol (atol: rtol of the largest
    magnitude, for messages near zero)."""
    a, b = np.asarray(a), np.asarray(b)
    atol = rtol * float(np.max(np.abs(b)))
    err = np.abs(a - b) - rtol * np.abs(b)
    log(f"[kernel] {tag}: max |diff| {float(np.max(np.abs(a - b))):.3g}, "
        f"exactly equal {np.array_equal(a, b)}")
    check(np.all(err <= atol), f"{tag}: messages differ beyond rtol {rtol}")


def phase_kernel() -> None:
    import jax
    import jax.numpy as jnp

    from polardecoding_tpu.analysis.construction import (
        code_frozen_mask, code_info_set)
    from polardecoding_tpu.configs import preset
    from polardecoding_tpu.models.bp import (
        bp_decode, bp_wave_fused_jnp, wave_init_state)
    from polardecoding_tpu.ops.bp_kernel import (
        bp_decode_kernel, bp_wave_fused_kernel)
    from polardecoding_tpu.ops.encode import (
        encode_info_mxu, info_sub_generator, polar_encode, scatter_info)
    from polardecoding_tpu.parallel.harness import payload_from_index
    from polardecoding_tpu.utils.pn import pn_sequence

    code = preset("BP_1024").code
    I = np.asarray(code_info_set(code))
    frozen = jnp.asarray(code_frozen_mask(code))
    pay = np.asarray(payload_from_index(
        jnp.arange(WAVE_BATCH, dtype=jnp.int32), jnp.asarray(pn_sequence()),
        code.K))

    def block_errors(u, rows):
        return np.any(np.asarray(u)[:, I] != pay[rows], axis=-1)

    # --- decode entry, BP_1024 (minsum_lut), B=8192, 100 iterations
    llr = channel_llr("BP_1024", BP_BATCH)
    t0 = time.perf_counter()
    u_k = np.asarray(bp_decode_kernel(llr, frozen, iters=100))
    log(f"[kernel] pd_bp_decode build + compile + first call "
        f"{time.perf_counter() - t0:.1f} s")
    u_r = np.asarray(bp_decode(llr, frozen, iters=100))
    # per-frame convergence after 100 iterations: the G-matrix check of the
    # wave entry run from a fresh state for the same 100 iterations
    st0 = wave_init_state(jnp.zeros_like(llr), frozen)
    every = jnp.ones((BP_BATCH,), bool)
    _, u_wk, d_k = bp_wave_fused_kernel(st0, llr, every, iters=100)
    _, u_wr, d_r = bp_wave_fused_jnp(st0, llr, every, iters=100)
    conv = np.asarray(d_k) & np.asarray(d_r)
    rows = np.arange(BP_BATCH)
    compare_decisions("bp_decode B=8192 iters=100", u_k, u_r, conv,
                      block_errors(u_k, rows), block_errors(u_r, rows))
    compare_decisions("wave entry B=8192 iters=100 (decode semantics)",
                      np.asarray(u_wk), u_r, conv,
                      block_errors(u_wk, rows), block_errors(u_r, rows))
    # early-stop latch
    u_ke = np.asarray(bp_decode_kernel(llr, frozen, iters=100,
                                       early_stop_every=4))
    u_re = np.asarray(bp_decode(llr, frozen, iters=100, early_stop_every=4))
    compare_decisions("bp_decode early_stop_every=4", u_ke, u_re, conv,
                      block_errors(u_ke, rows), block_errors(u_re, rows))

    # --- messages after 1 and 5 iterations (five 1-iteration waves)
    sk = sr = st0
    for it in range(1, 6):
        ret = every if it == 1 else jnp.zeros((BP_BATCH,), bool)
        sk, _, _ = bp_wave_fused_kernel(sk, llr, ret, iters=1)
        sr, _, _ = bp_wave_fused_jnp(sr, llr, ret, iters=1)
        if it in (1, 5):
            assert_close(f"messages after {it} iteration(s)", sk, sr)

    # --- 256-frame slice against the CPU backend
    cpu = jax.devices("cpu")[0]
    u_cpu = np.asarray(bp_decode(jax.device_put(llr[:256], cpu),
                                 jax.device_put(frozen, cpu), iters=100))
    compare_decisions("256 frames, kernel vs CPU backend", u_k[:256], u_cpu,
                      conv[:256], block_errors(u_k[:256], rows[:256]),
                      block_errors(u_cpu, rows[:256]))

    # --- fused wave entry, BP_1024_FASTCHK, B=16384, K=8, mixed retire mask
    llr16 = channel_llr("BP_1024_FASTCHK", WAVE_BATCH)
    llr16b = channel_llr("BP_1024_FASTCHK", WAVE_BATCH, seed=8)
    st = wave_init_state(llr16, frozen)
    st = bp_wave_fused_jnp(st, llr16, jnp.zeros((WAVE_BATCH,), bool),
                           iters=WAVE_K, flavor="minsum_lut_fast")[0]
    retire = jnp.asarray(np.arange(WAVE_BATCH) % 3 == 0)
    for ce in (0, 2):
        sk, uk, dk = bp_wave_fused_kernel(st, llr16b, retire, iters=WAVE_K,
                                          flavor="minsum_lut_fast",
                                          check_every=ce)
        sr, ur, dr = bp_wave_fused_jnp(st, llr16b, retire, iters=WAVE_K,
                                       flavor="minsum_lut_fast",
                                       check_every=ce)
        assert_close(f"wave B={WAVE_BATCH} K={WAVE_K} check_every={ce} state",
                     sk, sr)
        both = np.asarray(dk) & np.asarray(dr)
        du = np.any(np.asarray(uk) != np.asarray(ur), axis=-1)
        log(f"[kernel] wave check_every={ce}: done kernel={int(np.sum(dk))} "
            f"reference={int(np.sum(dr))}; decisions differ on "
            f"{int(np.sum(du & both))} frames done in both")
        check(not np.any(du & both),
              f"wave check_every={ce}: decisions differ on frames done in both")
        check(bler_bound(int(np.sum(dk)), int(np.sum(dr)), WAVE_BATCH),
              f"wave check_every={ce}: done counts disagree")

    # --- GF(2) encoders: the bf16 matmul (ops/encode.encode_info_mxu: bf16
    # operands, float32 accumulation, default precision) and the butterfly
    w = jnp.asarray(pay[:BP_BATCH])
    x_mm = np.asarray(encode_info_mxu(w, info_sub_generator(I, code.N)))
    x_bf = np.asarray(polar_encode(scatter_info(w, jnp.asarray(I), code.N)))
    log(f"[kernel] encoders: matmul vs butterfly bit-equal "
        f"{np.array_equal(x_mm.astype(np.int8), x_bf)}")
    check(np.array_equal(x_mm.astype(np.int8), x_bf),
          "matmul and butterfly encoders differ")


# --------------------------------------------------------------------------
# phase 4: timing, kernel against engine="jnp"


def phase_timing(card: str) -> dict:
    from bench import frame_step_timer, wave_step_timer

    results = {}
    for tag, make in (
            (f"BP_1024 frame step B={BP_BATCH} iters=100",
             lambda e: frame_step_timer("BP_1024", BP_BATCH, SNR_DB, 4,
                                        bp_engine=e)[0]),
            (f"BP_1024_FASTCHK fused wave B={WAVE_BATCH} K={WAVE_K}",
             lambda e: wave_step_timer("BP_1024_FASTCHK", WAVE_BATCH, SNR_DB,
                                       32, bp_engine=e)[0])):
        runs = {e: make(e) for e in ("jnp", "kernel")}
        got = {"jnp": [], "kernel": []}
        for e in ("jnp", "kernel", "kernel", "jnp"):
            got[e].append(runs[e]())
        results[tag] = got
        log(f"[timing] {tag} on {card}: frames/s jnp {got['jnp']} "
            f"kernel {got['kernel']}; kernel/jnp "
            f"{np.mean(got['kernel']) / np.mean(got['jnp']):.2f}x")
    return results


# --------------------------------------------------------------------------
# phase 5: the main path through the CLI


def phase_run(out_dir: str) -> None:
    from polardecoding_tpu.cli import main as cli_main

    for name, snr, want, tol in BLER_CHECKS:
        out = os.path.join(out_dir, f"smoke_{name}.json")
        t0 = time.perf_counter()
        cli_main(["run", "--preset", name, "--snr", str(snr), "--out", out])
        with open(out) as f:
            rec = json.load(f)[0]
        ok = abs(rec["bler"] - want) < tol
        log(f"[run] {name} @ {snr} dB: BLER {rec['bler']:.5f} "
            f"({rec['errblock']}/{rec['frames']}) want {want} +- {tol} "
            f"in {time.perf_counter() - t0:.1f} s: {'OK' if ok else 'FAIL'}")
        check(ok, f"{name}: BLER outside the reference window")


# --------------------------------------------------------------------------
# --four: the data-parallel mesh on four cards


def phase_four(card: str) -> None:
    import jax
    import jax.numpy as jnp

    from polardecoding_tpu.cli import main as cli_main
    from polardecoding_tpu.configs import preset
    from polardecoding_tpu.parallel.harness import make_frame_step, make_wave_step
    from polardecoding_tpu.parallel.mesh import data_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, JAX found {len(devs)}")
    one, four = data_mesh(devs[:1]), data_mesh(devs)
    key = jax.random.PRNGKey(5)
    sigma = jnp.float32(sigma_of(SNR_DB))
    for name, per_card in (("BP_1024", BP_BATCH), ("CASCL_1024_L8", 4096)):
        batch = 4 * per_card
        counters = []
        for mesh in (one, four):
            step = make_frame_step(preset(name), batch, mesh)
            counters.append([int(v) for v in step(key, jnp.int32(0), sigma)])
        log(f"[four] {name} frame step B={batch}: counters (errbit, "
            f"errblock, pm_ties) 1 card {counters[0]} 4 cards {counters[1]}")
        check(counters[0] == counters[1], f"{name}: 1-card and 4-card counters differ")
    waves = []
    for mesh in (one, four):
        init, step, drain = make_wave_step(preset("BP_1024_FASTCHK"),
                                           WAVE_BATCH, WAVE_K, mesh)
        carry = init(key, jnp.int32(0), sigma)
        tot = np.zeros(3, np.int64)
        for _ in range(6):
            carry, out = step(key, sigma, carry)
            tot += np.asarray([int(v) for v in out])
        waves.append(tot.tolist())
    log(f"[four] BP_1024_FASTCHK fused wave B={WAVE_BATCH} K={WAVE_K}, 6 "
        f"steps: counters (errbit, errblock, frames) 1 card {waves[0]} "
        f"4 cards {waves[1]}")
    check(waves[0] == waves[1], "fused wave: 1-card and 4-card counters differ")
    log(f"[four] cli scale on {card}:")
    cli_main(["scale", "--preset", "BP_1024", "--batch-per-device",
              str(BP_BATCH)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    from polardecoding_tpu import runtime

    devs = runtime.require_gpu()
    runtime.enable_compile_cache()
    card = runtime.card()
    log(f"[card] {card}")
    import jax

    log(f"[card] jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        phase_compile()
        phase_kernel()
        phase_timing(card)
        with tempfile.TemporaryDirectory() as out_dir:
            phase_run(out_dir)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
