"""Config dataclasses + named presets mirroring every reference program.

The reference's "config system" is compile-time #defines (SURVEY §5): N, K, n,
L, r, iterMax, BLE, SNR sweep bounds hard-coded per program.  Each reference
program becomes a named preset here with the same knobs and values, so e.g.
`preset("BP_128")` reproduces BP_128.c's configuration exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from polardecoding_tpu.ops.crc import CRC6_EXPONENTS, CRC24_EXPONENTS


@dataclasses.dataclass(frozen=True)
class CodeConfig:
    """The polar code itself."""

    N: int
    K: int  # payload bits (excluding CRC)
    graph: str = "lee"  # "lee" (G = F^{tensor n}) or "kao" (bit-reversed, "_fag")
    crc: Optional[Tuple[int, ...]] = None  # CRC generator exponents, or None
    crc_style: str = "multiplicative"  # or "systematic"
    # frozen-set construction: the reference's 5G table, GA-SC density
    # evolution, or BP DE-GA ranking (BASELINE.json "RGA/DEGA construction")
    construction: str = "5g"  # "5g" | "ga_sc" | "bp_dega"
    design_snr_db: float = 2.0

    @property
    def n(self) -> int:
        return self.N.bit_length() - 1

    @property
    def r(self) -> int:
        return max(self.crc) if self.crc else 0

    @property
    def num_info(self) -> int:
        """Bit channels carrying payload + CRC (K + r most reliable)."""
        return self.K + self.r

    def __post_init__(self):
        if 1 << self.n != self.N:
            raise ValueError(f"N={self.N} must be a power of two")
        if self.graph not in ("lee", "kao"):
            raise ValueError(f"unknown graph convention {self.graph!r}")
        if self.crc_style not in ("multiplicative", "systematic"):
            raise ValueError(f"unknown crc_style {self.crc_style!r}")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Which decoder and its knobs."""

    kind: str  # "bp" | "sc" | "scl" | "cascl" | "bpr"
    list_size: int = 1  # L for scl/cascl
    bp_iters: int = 100  # iterMax for bp/bpr
    bp_flavor: str = "minsum_lut"  # or "spa" (exact box-plus A/B variant)
    bp_early_stop: bool = False  # extension; reference runs fixed iterations
    bpr_checkpoints: Tuple[int, ...] = (3, 6, 10, 20, 40, 80)  # BPr_128.c:18-23


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Monte-Carlo sweep: SNR grid + adaptive stop (SURVEY §2.1 harness row)."""

    snr_start_db: float
    snr_stop_db: float
    snr_step_db: float = 0.5
    error_blocks: int = 100  # stop a point once this many block errors seen
    seed: int = 1024
    batch_per_device: int = 1024
    max_frames: int = 1 << 34  # hard cap so a too-good point terminates

    def snr_points(self):
        out = []
        s = self.snr_start_db
        # inclusive upper bound with float-safe stepping, like the C for-loops
        while s <= self.snr_stop_db + 1e-9:
            out.append(round(s, 6))
            s += self.snr_step_db
        return out


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    code: CodeConfig
    decoder: DecoderConfig
    sweep: SweepConfig
    source: str  # the reference program this mirrors


def _p(name, code, decoder, sweep, source):
    return Preset(name=name, code=code, decoder=decoder, sweep=sweep, source=source)


PRESETS = {
    p.name: p
    for p in [
        # --- SC family ---------------------------------------------------
        _p(
            "SC_128",
            CodeConfig(128, 64),
            DecoderConfig("sc"),
            SweepConfig(1.0, 4.0, error_blocks=100, seed=1024),
            "SC_128.c",
        ),
        _p(
            "SC_1024",
            CodeConfig(1024, 512),
            DecoderConfig("sc"),
            SweepConfig(1.0, 3.5, error_blocks=50, seed=1024),
            "SC_1024.c",
        ),
        _p(
            "SC_128_fag",
            CodeConfig(128, 64, graph="kao"),
            DecoderConfig("sc"),
            SweepConfig(1.0, 4.0, error_blocks=500, seed=1024),
            "SC_128_fag.c",
        ),
        # --- BP family ---------------------------------------------------
        _p(
            "BP_128",
            CodeConfig(128, 64),
            DecoderConfig("bp", bp_iters=100),
            SweepConfig(1.0, 4.0, error_blocks=200, seed=1024),
            "BP_128.c (time-based seed in ref)",
        ),
        _p(
            "BP_128_SPA",
            CodeConfig(128, 64),
            DecoderConfig("bp", bp_iters=100, bp_flavor="spa"),
            SweepConfig(1.0, 4.0, error_blocks=200, seed=1024),
            "BP128out_SPA.txt variant",
        ),
        _p(
            "BP_1024",
            CodeConfig(1024, 512),
            DecoderConfig("bp", bp_iters=100),
            SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
            "BP_1024.c",
        ),
        _p(
            "BP_128_fag",
            CodeConfig(128, 64, graph="kao"),
            DecoderConfig("bp", bp_iters=100),
            SweepConfig(1.0, 4.0, error_blocks=200, seed=1024),
            "BP_128_fag.c",
        ),
        _p(
            "BP_1024_ES",
            CodeConfig(1024, 512),
            DecoderConfig("bp", bp_iters=100, bp_early_stop=True),
            SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
            "BP_1024.c + G-matrix early stopping (extension; 2-3x at high SNR)",
        ),
        _p(
            "BP_1024_GA",
            CodeConfig(1024, 512, construction="ga_sc", design_snr_db=2.0),
            DecoderConfig("bp", bp_iters=100, bp_early_stop=True),
            SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
            "BASELINE.json 'BP_1024 with RGA/DEGA construction and early stopping'",
        ),
        # Throughput flavors: identical configs with the algebraic chk
        # rewrite (ops/chk.chk_fast, ulp-level non-identical to the
        # reference; ~12% fewer operations per check node).  BLER
        # statistically clean at 1000 error blocks at 4.0 dB for both N
        # (ratio fast/default 0.998 @N=128, 0.991 @N=1024, both << the
        # 3-sigma window) and at 2.0 dB.  The exact-LUT presets above remain
        # the golden-parity configurations.
        _p(
            "BP_128_FASTCHK",
            CodeConfig(128, 64),
            DecoderConfig("bp", bp_iters=100, bp_flavor="minsum_lut_fast"),
            SweepConfig(1.0, 4.0, error_blocks=200, seed=1024),
            "BP_128.c + chk_fast (throughput flavor, BLER-validated)",
        ),
        _p(
            "BP_1024_FASTCHK",
            CodeConfig(1024, 512),
            DecoderConfig("bp", bp_iters=100, bp_flavor="minsum_lut_fast"),
            SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
            "BP_1024.c + chk_fast (throughput flavor, BLER-validated)",
        ),
        _p(
            "BPr_128",
            CodeConfig(128, 64),
            DecoderConfig("bpr", bp_iters=90),
            SweepConfig(1.0, 4.0, error_blocks=200, seed=1024),
            "BPr_128.c",
        ),
        # --- SCL family --------------------------------------------------
        # the reference sweeps L in {2, 4, 8, 16, 32} for both N
        # (plot_SCL.py:9-27, SCL_1024.py:8-36); L=8 is the program default
        *[
            _p(
                f"SCL_128_L{l}",
                CodeConfig(128, 64),
                DecoderConfig("scl", list_size=l),
                SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
                "SCL_128.c (L sweep in plot_SCL.py)",
            )
            for l in (2, 4, 16, 32)
        ],
        _p(
            "SCL_128_L8",
            CodeConfig(128, 64),
            DecoderConfig("scl", list_size=8),
            SweepConfig(1.0, 2.5, error_blocks=50, seed=1024),
            "SCL_128.c",
        ),
        *[
            _p(
                f"SCL_1024_L{l}",
                CodeConfig(1024, 512),
                DecoderConfig("scl", list_size=l),
                SweepConfig(1.0, 3.0, error_blocks=50, seed=1024),
                "SCL_1024.c (L sweep in SCL_1024.py)",
            )
            for l in (2, 4, 16, 32)
        ],
        _p(
            "SCL_1024_L8",
            CodeConfig(1024, 512),
            DecoderConfig("scl", list_size=8),
            SweepConfig(1.0, 3.0, error_blocks=50, seed=1024),
            "SCL_1024.c",
        ),
        _p(
            "SCL_128_fag_L8",
            CodeConfig(128, 64, graph="kao"),
            DecoderConfig("scl", list_size=8),
            SweepConfig(1.0, 3.0, error_blocks=200, seed=1024),
            "SCL_128_fag.c",
        ),
        # --- CA-SCL family -----------------------------------------------
        _p(
            "CASCL_128_L8",
            CodeConfig(128, 64, crc=CRC6_EXPONENTS),
            DecoderConfig("cascl", list_size=8),
            SweepConfig(1.0, 3.0, error_blocks=200, seed=1024),
            "CASCL_128.c",
        ),
        _p(
            "CASCL_128_L32",
            CodeConfig(128, 64, crc=CRC6_EXPONENTS),
            DecoderConfig("cascl", list_size=32),
            SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
            "CASCL_128.c (L=32 runs)",
        ),
        _p(
            "CASCL_1024_L8",
            CodeConfig(1024, 512, crc=CRC24_EXPONENTS),
            DecoderConfig("cascl", list_size=8),
            SweepConfig(1.0, 2.5, error_blocks=200, seed=1024),
            "CASCL_1024_L8.c",
        ),
        _p(
            "CASCL_1024_L32",
            CodeConfig(1024, 512, crc=CRC24_EXPONENTS),
            DecoderConfig("cascl", list_size=32),
            SweepConfig(1.0, 2.2, error_blocks=200, seed=1024),
            "CASCL_1024_L8.c (L=32 runs)",
        ),
        _p(
            "CASCL_1024_sys_L8",
            CodeConfig(
                1024,
                512,
                graph="kao",
                crc=CRC24_EXPONENTS,
                crc_style="systematic",
            ),
            DecoderConfig("cascl", list_size=8),
            SweepConfig(2.5, 2.5, error_blocks=200, seed=1024),
            "CASCL_1024_sys.c",
        ),
        _p(
            "CASCL_128_fag_L8",
            CodeConfig(128, 64, graph="kao", crc=CRC6_EXPONENTS),
            DecoderConfig("cascl", list_size=8),
            SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
            "result_128_fag.zip CA-SCL runs",
        ),
        _p(
            "CASCL_128_fag_L32",
            CodeConfig(128, 64, graph="kao", crc=CRC6_EXPONENTS),
            DecoderConfig("cascl", list_size=32),
            SweepConfig(1.0, 3.5, error_blocks=200, seed=1024),
            "result_128_fag.zip:CAL32_0.dat (seed 1749)",
        ),
    ]
}


def preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}") from None
