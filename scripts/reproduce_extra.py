"""Remaining archive configurations: systematic CRC-24 (Kao graph), the
CA-SCL L=32 runs, and the `_fag` CA-SCL archive.

Usage: python scripts/reproduce_extra.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from polardecoding_tpu.configs import preset
from polardecoding_tpu.parallel.harness import run_sweep

RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results")

# (preset, snrs, blocks, cap, reference note)
RUNS = [
    ("CASCL_128_L32", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 2_000_000,
     "CASCL_128_L32.txt seed 2525: 0.147/0.0662/0.0185/4.03e-3/9.83e-4/1.89e-4"),
    ("CASCL_128_fag_L8", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 2_000_000,
     "CAL8_0.dat seed 1319: 0.243/0.1221/0.0394/0.0102/2.17e-3/3.79e-4"),
    ("CASCL_1024_sys_L8", [1.0, 1.5, 2.0, 2.5], 150, 4_000_000,
     "CASCL_1024_sys.c sweeps 2.5 only; mult-CRC CASCL_L8.dat @2.5 = 9.65e-5"),
    ("CASCL_1024_L32", [1.0, 1.5, 2.0, 2.2], 100, 2_000_000,
     "CASCL_L32.dat seed 1825: 0.2435/0.0270/7.07e-4/1.11e-4"),
]


def main():
    os.makedirs(RESULTS, exist_ok=True)
    for name, snrs, blocks, cap, note in RUNS:
        p = preset(name)
        t0 = time.time()
        res = run_sweep(
            p, batch=4096, snr_points=snrs, error_blocks=blocks,
            max_frames=cap,
            checkpoint_path=os.path.join(RESULTS, f"{name}.json"),
            log=lambda m: print(m, flush=True),
        )
        print(f"== {name} [{note}]", flush=True)
        for r in res:
            print(f"   {r.snr_db:.1f} dB: {r.bler:.4e} ({r.errblock}/{r.frames})",
                  flush=True)
        print(f"   done in {time.time()-t0:.0f}s", flush=True)


if __name__ == "__main__":
    from polardecoding_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    main()
