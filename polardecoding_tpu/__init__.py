"""polardecoding_tpu — polar-code Monte-Carlo decoding framework in JAX.

A ground-up JAX/XLA re-design (with one CUDA kernel for BP on NVIDIA GPUs,
native/bp_kernel.cu) of the capabilities of the C reference
CHEBSB/PolarDecoding (see SURVEY.md): batched polar encode, BPSK/AWGN channel,
BP / SC / SCL / CA-SCL decoders, BPr instrumentation, DE-GA analysis, and a
sharded adaptive Monte-Carlo sweep harness.
"""
from polardecoding_tpu.configs import PRESETS, CodeConfig, DecoderConfig, Preset, SweepConfig, preset

__all__ = [
    "PRESETS",
    "preset",
    "Preset",
    "CodeConfig",
    "DecoderConfig",
    "SweepConfig",
]

__version__ = "0.1.0"
