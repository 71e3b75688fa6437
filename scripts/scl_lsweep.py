"""Reproduce the reference's SCL list-size study (plot_SCL.py / SCL_1024.py):
BLER for L in {2,4,8,16,32} at both N, vs the reference's seed-averaged
tables, including the L-monotonicity A/B check (SURVEY §4.5).

Usage: python scripts/scl_lsweep.py [--N 128|1024|all]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from polardecoding_tpu.configs import preset
from polardecoding_tpu.parallel.harness import run_sweep
from polardecoding_tpu.plotting import REFERENCE_SCL_BY_L

RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results")
ARG_N = "all"
for i, a in enumerate(sys.argv):
    if a == "--N" and i + 1 < len(sys.argv):
        ARG_N = sys.argv[i + 1]

PLANS = {
    128: dict(snrs=[1.0, 1.5, 2.0, 2.5, 3.0, 3.5], blocks=200, cap=1_500_000),
    1024: dict(snrs=[1.0, 1.5, 2.0, 2.5, 3.0], blocks=50, cap=1_000_000),
}


def main():
    os.makedirs(RESULTS, exist_ok=True)
    table = {}
    for ncode, plan in PLANS.items():
        if ARG_N not in ("all", str(ncode)):
            continue
        for L in (2, 4, 8, 16, 32):
            name = f"SCL_{ncode}_L{L}"
            p = preset(name)
            res = run_sweep(
                p, batch=4096, snr_points=plan["snrs"],
                error_blocks=plan["blocks"], max_frames=plan["cap"],
                checkpoint_path=os.path.join(RESULTS, f"{name}_lsweep.json"),
                log=lambda m: print(m, flush=True),
            )
            table[(ncode, L)] = [r.bler for r in res]
            print(f"== {name}: {[f'{r.bler:.3e}' for r in res]}", flush=True)

    lines = ["# SCL list-size study vs reference (plot_SCL.py / SCL_1024.py)", ""]
    for ncode in (128, 1024):
        if not any(k[0] == ncode for k in table):
            continue
        ref = REFERENCE_SCL_BY_L[ncode]
        snrs = PLANS[ncode]["snrs"]
        lines += [f"## N = {ncode}", "",
                  "| L | " + " | ".join(f"{s} dB" for s in snrs) + " |",
                  "|---|" + "---|" * len(snrs)]
        for L in (2, 4, 8, 16, 32):
            ours = table.get((ncode, L))
            if not ours:
                continue
            cells = []
            for i, s in enumerate(snrs):
                cell = f"{ours[i]:.3e}"
                if s in ref["snr"]:
                    cell += f" (ref {ref[L][ref['snr'].index(s)]:.3g})"
                cells.append(cell)
            lines.append(f"| {L} | " + " | ".join(cells) + " |")
        lines.append("")
        # monotonicity A/B: larger L should not be (much) worse at low SNR
        l2 = table.get((ncode, 2))
        l32 = table.get((ncode, 32))
        if l2 and l32:
            ok = l32[0] <= l2[0]
            lines.append(
                f"L-monotonicity at {snrs[0]} dB: L32 {l32[0]:.3e} "
                f"{'<=' if ok else '>'} L2 {l2[0]:.3e} "
                f"({'OK' if ok else 'VIOLATION'})")
            lines.append("")
    with open(os.path.join(RESULTS, "SCL_LSWEEP.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote results/SCL_LSWEEP.md", flush=True)


if __name__ == "__main__":
    from polardecoding_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    main()
