"""Process set-up shared by the entry points (cli, bench.py, chip_smoke.py,
scripts/): the persistent compile cache, and what every measurement records
about the device it ran on."""
from __future__ import annotations

import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when that is set, else at the fixed directory .jax_cache of this
    checkout.  Returns the directory."""
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_ROOT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them, one line
    per card.  Runs nvidia-smi as a child process (it does not touch JAX);
    raises RuntimeError when there is no NVIDIA card to ask."""
    try:
        out = subprocess.run(CARD_QUERY, check=True, capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from None
    return out.stdout.strip()


def require_gpu():
    """The JAX devices, or SystemExit when JAX found no GPU: measurements
    and the chip check never fall back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {devs[0].platform} devices only")
    return devs


def device_record() -> dict:
    """What every measurement names: platform, device kind and count as JAX
    reports them, the card's name and power limit, and XLA_FLAGS."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}
