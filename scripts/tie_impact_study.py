"""Quantify the keep-exactly-L vs strict-below-median policy divergence.

The PM-tie counter ("Oops!" condition, SCL_1024.c:620-633) is NOT
measure-zero at L=32 — ~1% of production MC frames hit at least one exact
median tie (results/REPRODUCTION_EXTRA.md, "PM ties at L=32").  This
study decodes the SAME tie frames under BOTH policies with the jnp engine
(models/scl.scl_decode strict_median flag) and compares block outcomes —
converting the documented divergence from "observable" to "quantified".

CPU-friendly config: CASCL_128_L32 (the reference's own L=32 small-code
runs).  Usage: python scripts/tie_impact_study.py [--frames 8192] [--snr 2.0]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from polardecoding_tpu.analysis.construction import (  # noqa: E402
    code_frozen_mask,
    code_info_set,
)
from polardecoding_tpu.configs import preset  # noqa: E402
from polardecoding_tpu.models.scl import cascl_select, scl_decode  # noqa: E402
from polardecoding_tpu.ops.channel import awgn_llr  # noqa: E402
from polardecoding_tpu.ops.crc import check_matrix, crc_encode_multiplicative  # noqa: E402
from polardecoding_tpu.ops.encode import polar_encode, scatter_info  # noqa: E402
from polardecoding_tpu.parallel.harness import payload_from_index  # noqa: E402
from polardecoding_tpu.utils.pn import pn_sequence  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8192)
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--batch", type=int, default=512)
    args = ap.parse_args()

    p = preset("CASCL_128_L32")
    code = p.code
    L = p.decoder.list_size
    frozen = jnp.asarray(code_frozen_mask(code))
    I = np.asarray(code_info_set(code))
    R = check_matrix(code.crc, code.num_info)
    pn = jnp.asarray(pn_sequence())
    key = jax.random.PRNGKey(p.sweep.seed)
    sigma = jnp.float32(10.0 ** (-args.snr / 20.0))

    @jax.jit
    def gen(fidx):
        payload = payload_from_index(fidx, pn, code.K)
        w = crc_encode_multiplicative(payload, code.crc)
        u = scatter_info(w, jnp.asarray(I), code.N)
        x = polar_encode(u)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        return awgn_llr(x, keys, sigma), w

    @functools.partial(jax.jit, static_argnames=("strict",))
    def decode(llr, strict):
        u_all, PM, ties = scl_decode(llr, frozen, list_size=L,
                                     return_all=True, return_ties=True,
                                     strict_median=strict)
        u_hat, _ = cascl_select(u_all, PM, tuple(I), R)
        return u_hat, ties

    tie_frames = blk_default = blk_strict = differs = 0
    tie_err_default = tie_err_strict = 0
    done = 0
    while done < args.frames:
        fidx = done + jnp.arange(args.batch, dtype=jnp.int32)
        llr, w = gen(fidx)
        ud, ties = decode(llr, False)
        us, ties2 = decode(llr, True)
        assert bool(jnp.all(ties == ties2))
        bad_d = np.asarray(jnp.any(ud[:, I] != w, axis=-1))
        bad_s = np.asarray(jnp.any(us[:, I] != w, axis=-1))
        t = np.asarray(ties) > 0
        tie_frames += int(t.sum())
        blk_default += int(bad_d.sum())
        blk_strict += int(bad_s.sum())
        differs += int((bad_d != bad_s).sum())
        tie_err_default += int(bad_d[t].sum())
        tie_err_strict += int(bad_s[t].sum())
        done += args.batch
        bits_differ = int((np.asarray(ud) != np.asarray(us)).any(axis=-1).sum())
        print(json.dumps({"frames": done, "tie_frames": tie_frames,
                          "blk_default": blk_default,
                          "blk_strict": blk_strict,
                          "outcome_differs": differs,
                          "decoded_bits_differ": bits_differ}), flush=True)

    print(json.dumps({
        "preset": p.name, "snr_db": args.snr, "frames": done,
        "tie_frames": tie_frames, "tie_rate": round(tie_frames / done, 5),
        "blk_default": blk_default, "blk_strict": blk_strict,
        "block_outcome_differs": differs,
        "tie_frame_errors_default": tie_err_default,
        "tie_frame_errors_strict": tie_err_strict,
    }), flush=True)


if __name__ == "__main__":
    from polardecoding_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    main()
