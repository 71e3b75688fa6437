"""End-to-end verification drive on the GPU: decode through the public
harness at several SNR points and assert BLER within confidence intervals of
the reference tables (BASELINE.md).  Used by .claude/skills/verify.

Run:  PYTHONPATH=/root/repo:$PYTHONPATH python scripts/verify_drive.py [--fast]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from polardecoding_tpu.configs import preset
from polardecoding_tpu.parallel.harness import run_point

FAST = "--fast" in sys.argv

# (preset, snr_db, frames, expected BLER, absolute tolerance ~3-4 sigma)
CHECKS = [
    ("BP_128", 2.0, 32768, 0.1127, 0.012),
    ("SC_128", 3.0, 32768, 0.02098, 0.006),
    ("SCL_128_L8", 2.0, 16384, 0.0552, 0.010),
    ("CASCL_128_L8", 2.0, 16384, 0.03773, 0.008),
]
if not FAST:
    CHECKS += [
        ("SC_1024", 2.0, 32768, 0.09009, 0.010),
        ("BP_1024", 2.0, 16384, 0.02948, 0.008),
        ("SCL_1024_L8", 1.5, 8192, 0.04721, 0.012),
        ("CASCL_1024_L8", 1.5, 8192, 0.07130, 0.015),
    ]


def main():
    print("devices:", jax.devices())
    failures = []
    for name, snr, frames, want, tol in CHECKS:
        p = preset(name)
        batch = min(4096, frames)
        t0 = time.time()
        res = run_point(p, snr, batch=batch, error_blocks=10**9,
                        max_frames=frames)
        dt = time.time() - t0
        ok = abs(res.bler - want) < tol
        print(
            f"{name:16s} @{snr:.1f}dB: bler={res.bler:.5f} want~{want:.5f} "
            f"(+-{tol}) frames={res.frames} [{res.frames/dt:.0f} fps] "
            f"{'OK' if ok else 'FAIL'}"
        )
        if not ok:
            failures.append(name)

    # invariants: all-frozen decodes to zeros; zero-LLR ties decode to 0
    from polardecoding_tpu.models.bp import bp_decode
    from polardecoding_tpu.models.sc import sc_decode

    fr = jnp.ones(32, bool)
    noisy = jnp.asarray(
        np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    )
    assert (np.asarray(bp_decode(noisy, fr, iters=5)) == 0).all()
    assert (np.asarray(sc_decode(jnp.zeros((2, 32), jnp.float32),
                                 jnp.zeros(32, bool))) == 0).all()
    print("probes ok")
    if failures:
        print("VERIFY FAIL:", failures)
        sys.exit(1)
    print("VERIFY PASS")


if __name__ == "__main__":
    from polardecoding_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    main()
