"""Throughput of the full Monte-Carlo pipeline on the GPU, one record per leg.

    python bench.py [--legs bp_fixed bp_wave scl] [--snr 2.0] [--steps 8]

Each leg is a full pipeline step (payload, encode, channel, decode, count)
at N=1024 and prints one JSON line:

  bp_fixed  BP_1024 frame step, 100 iterations, B=8192     decoded frames/s
  bp_wave   BP_1024_FASTCHK fused wave step, K=8, B=16384  retired frames/s
  scl       SCL_1024_L8 frame step, B=16384               decoded frames/s

Every record names the device it ran on (platform, device kind, device
count, the card's name and power limit) and XLA_FLAGS.  Time is taken on
the host clock around steps that end in block_until_ready, after a warm-up
that compiles; compilation is reported separately.  Without a GPU the
script exits non-zero: it never times the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp

from polardecoding_tpu import runtime
from polardecoding_tpu.configs import preset
from polardecoding_tpu.parallel.harness import make_frame_step, make_wave_step

LEGS = {
    "bp_fixed": ("BP_1024", 8192),
    "bp_wave": ("BP_1024_FASTCHK", 16384),
    "scl": ("SCL_1024_L8", 16384),
}
WAVE_K = 8


def frame_step_timer(preset_name, batch, snr_db=2.0, steps=8,
                     bp_engine="auto"):
    """(run, compile seconds) for make_frame_step: the step is compiled
    here; each run() times `steps` further batches and returns decoded
    frames/s."""
    p = preset(preset_name)
    step = make_frame_step(p, batch=batch, bp_engine=bp_engine)
    key = jax.random.PRNGKey(p.sweep.seed)
    sigma = jnp.float32(10.0 ** (-snr_db / 20.0))
    t0 = time.perf_counter()
    jax.block_until_ready(step(key, jnp.int32(0), sigma))
    compile_s = time.perf_counter() - t0
    issued = [1]

    def run():
        t0 = time.perf_counter()
        outs = [step(key, jnp.int32((issued[0] + i) * batch), sigma)
                for i in range(steps)]
        jax.block_until_ready(outs)
        issued[0] += steps
        return steps * batch / (time.perf_counter() - t0)

    return run, compile_s


def wave_step_timer(preset_name, batch, snr_db=2.0, steps=8, warmup=4,
                    bp_engine="auto"):
    """(run, compile seconds) for the fused wave step, warmed up by
    `warmup` waves into its steady retirement mix; each run() times `steps`
    further waves and returns retired frames/s."""
    p = preset(preset_name)
    init, step, _ = make_wave_step(p, batch, WAVE_K, bp_engine=bp_engine)
    key = jax.random.PRNGKey(p.sweep.seed)
    sigma = jnp.float32(10.0 ** (-snr_db / 20.0))
    t0 = time.perf_counter()
    box = {"carry": init(key, jnp.int32(0), sigma)}
    for _ in range(warmup):
        box["carry"], out = step(key, sigma, box["carry"])
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    def run():
        t0 = time.perf_counter()
        frames = []
        for _ in range(steps):
            box["carry"], out = step(key, sigma, box["carry"])
            frames.append(out[2])
        jax.block_until_ready(frames)
        dt = time.perf_counter() - t0
        return sum(int(f) for f in frames) / dt

    return run, compile_s


def bench_step(preset_name, batch, snr_db=2.0, steps=8):
    """(frames/s, compile seconds) of make_frame_step for one preset."""
    run, compile_s = frame_step_timer(preset_name, batch, snr_db, steps)
    return run(), compile_s


def main(argv=None):
    ap = argparse.ArgumentParser(description="pipeline throughput per leg")
    ap.add_argument("--legs", nargs="+", choices=sorted(LEGS),
                    default=list(LEGS))
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    runtime.require_gpu()
    runtime.enable_compile_cache()
    device = runtime.device_record()
    for leg in args.legs:
        name, batch = LEGS[leg]
        if leg == "bp_wave":
            run, compile_s = wave_step_timer(name, batch, args.snr,
                                             args.steps)
            unit = "retired frames/s"
        else:
            run, compile_s = frame_step_timer(name, batch, args.snr,
                                              args.steps)
            unit = "decoded frames/s"
        fps = run()
        print(json.dumps({
            "leg": leg, "preset": name, "batch": batch, "snr_db": args.snr,
            "value": fps, "unit": unit, "compile_s": compile_s,
            "device": device}), flush=True)


if __name__ == "__main__":
    main()
