"""Reproduce the reference's published BLER curves end to end on the GPU.

Runs adaptive Monte-Carlo sweeps for every family at the reference's SNR
grids, writes results/<preset>.json, results/curves_{128,1024}.png and
results/REPRODUCTION.md (side-by-side table vs the reference archives).

Usage: python scripts/reproduce_curves.py [--quick]
  --quick lowers the error-block target to 50 (CI ~14%) for a fast pass.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from polardecoding_tpu.configs import preset
from polardecoding_tpu.parallel.harness import run_sweep
from polardecoding_tpu.plotting import REFERENCE_BLER, plot_results

QUICK = "--quick" in sys.argv
RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results")

# (preset, snr grid, error-block target, max frames per point)
RUNS = [
    ("SC_128", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 100, 2_000_000),
    ("BP_128", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 200, 2_000_000),
    ("BP_128_SPA", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 200, 2_000_000),
    ("SCL_128_L8", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 2_000_000),
    ("CASCL_128_L8", [1.0, 1.5, 2.0, 2.5, 3.0], 200, 2_000_000),
    ("SC_1024", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 100, 8_000_000),
    ("BP_1024", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 8_000_000),
    ("SCL_1024_L8", [1.0, 1.5, 2.0, 2.5, 3.0], 50, 2_000_000),
    ("CASCL_1024_L8", [1.0, 1.5, 2.0, 2.5], 200, 4_000_000),
]


def main():
    os.makedirs(RESULTS, exist_ok=True)
    target_scale = 0.25 if QUICK else 1.0
    all_recs = []
    for name, snrs, blocks, cap in RUNS:
        p = preset(name)
        t0 = time.time()
        res = run_sweep(
            p, batch=4096, snr_points=snrs,
            error_blocks=max(25, int(blocks * target_scale)), max_frames=cap,
            checkpoint_path=os.path.join(RESULTS, f"{name}.json"),
            log=lambda m: print(m, flush=True),
        )
        print(f"== {name} done in {time.time()-t0:.0f}s", flush=True)
        all_recs.extend(r.to_json(p.code.num_info) for r in res)

    # plots per N
    for ncode in (128, 1024):
        recs = [r for r in all_recs
                if str(ncode) in r["preset"].replace("L8", "").replace("L32", "")]
        if recs:
            plot_results(
                recs, os.path.join(RESULTS, f"curves_{ncode}.png"),
                title=f"N={ncode} BLER vs reference archives",
            )

    # side-by-side markdown
    lines = [
        "# BLER reproduction vs reference archives",
        "",
        "Our adaptive-MC results against the reference's",
        "published tables (BASELINE.md, transcribed from its result archives).",
        "Counter-based RNG (not the reference's Ranq1 stream), so agreement is",
        "statistical: the binomial CI is ~2/sqrt(errblocks) relative.",
        "",
        "| preset | Eb/N0 (dB) | this work | reference | ratio | errblocks |",
        "|---|---|---|---|---|---|",
    ]
    for r in all_recs:
        ref = REFERENCE_BLER.get(r["preset"])
        want = ""
        ratio = ""
        if ref and r["snr_db"] in ref["snr"]:
            w = ref["bler"][ref["snr"].index(r["snr_db"])]
            want = f"{w:.4g}"
            ratio = f"{r['bler'] / w:.2f}" if w else ""
        lines.append(
            f"| {r['preset']} | {r['snr_db']:.1f} | {r['bler']:.4g} | {want} "
            f"| {ratio} | {r['errblock']} |"
        )
    with open(os.path.join(RESULTS, "REPRODUCTION.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote results/REPRODUCTION.md", flush=True)


if __name__ == "__main__":
    from polardecoding_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    main()
