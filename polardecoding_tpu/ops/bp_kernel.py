"""The whole-decode BP kernel (native/bp_kernel.cu) as JAX operations.

The kernel keeps a frame's whole message state in a thread block's shared
memory across every iteration (see the source's header).  It is CUDA,
compiled for Hopper (`sm_90a`) with `nvcc` from the committed source into
native/build/ at first use and called through the XLA foreign function
interface.  The same source compiled by the host C++ compiler with
`-DPD_HOST` runs the identical block bodies serially on the CPU; that build
exists so the kernel can be tested without a card, and the production
dispatch (models/bp.py) never routes the CPU to it.

Entries, each bit-compatible with its plain-JAX reference in models/bp.py:

  bp_decode_kernel(ch_llr, frozen, iters, flavor, early_stop_every)
      == bp_decode(...)
  bp_wave_fused_kernel(state, ch_llr, retire, iters, flavor, check_every)
      == bp_wave_fused_jnp(...)

Both take float32 messages only; anything the kernel cannot run raises
KernelUnsupported instead of falling back.
"""
from __future__ import annotations

import ctypes
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from polardecoding_tpu.native import build_shared

FLAVORS = {"minsum_lut": 0, "minsum_lut_fast": 1, "spa": 2}
SMEM_LIMIT = 227 * 1024  # shared memory one Hopper block may use


class KernelUnsupported(ValueError):
    """The request is outside what the kernel implements."""


def frames_per_block(N: int) -> int:
    """Frames one block decodes together: one frame from N = 512 up, more
    below so that a block still runs >= 256 threads (N/2 butterflies each)."""
    return max(1, 512 // N)


def smem_bytes(N: int, frames: int) -> int:
    """Dynamic shared memory of one block (mirrors smem_bytes in the
    source): the message lattice, the check scratch and the flags."""
    n = N.bit_length() - 1
    return frames * (2 * (n + 1) * N * 4 + N) + (3 * frames + 1) * 4 + 16


def check_supported(dtype, N: int, flavor: str) -> int:
    """Validate a request; returns the block's frame count."""
    if jnp.dtype(dtype) != jnp.float32:
        raise KernelUnsupported(
            f"the BP kernel takes float32 messages, not {jnp.dtype(dtype)}; "
            "pass engine='jnp' for other message dtypes")
    if N < 2 or N & (N - 1):
        raise KernelUnsupported(f"N={N} is not a power of two >= 2")
    if flavor not in FLAVORS:
        raise KernelUnsupported(f"unknown BP flavor {flavor!r}")
    F = frames_per_block(N)
    if smem_bytes(N, F) > SMEM_LIMIT:
        raise KernelUnsupported(
            f"N={N} needs {smem_bytes(N, F)} B of shared memory per frame, "
            f"more than a block's {SMEM_LIMIT} B")
    return F


def _pad_to(x, multiple: int, axis: int):
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return jnp.pad(x, widths)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def _build(platform: str) -> str:
    inc = jax.ffi.include_dir()
    if platform == "cuda":
        return build_shared(
            "bp_kernel.cu", "libpd_bp_cuda.so",
            lambda src, out: [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", inc, "-o", out, src])
    return build_shared(
        "bp_kernel.cu", "libpd_bp_host.so",
        lambda src, out: [
            "c++", "-x", "c++", "-DPD_HOST", "-std=c++17", "-O2", "-shared",
            "-fPIC", "-I", inc, "-o", out, src])


@functools.cache
def _register(platform: str) -> None:
    """Build the library for `platform` ("cuda" or "cpu") and register its
    two FFI targets; once per process."""
    lib = ctypes.CDLL(_build(platform))
    for name, sym in (("pd_bp_decode", lib.PdBpDecode),
                      ("pd_bp_wave", lib.PdBpWave)):
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(sym),
            platform="CUDA" if platform == "cuda" else "cpu")


def _platform() -> str:
    return "cuda" if jax.default_backend() == "gpu" else "cpu"


@functools.partial(jax.jit,
                   static_argnames=("iters", "flavor", "early_stop_every"))
def bp_decode_kernel(ch_llr, frozen, iters: int = 100,
                     flavor: str = "minsum_lut", early_stop_every: int = 0):
    """Kernel twin of models/bp.bp_decode: [B, N] f32 LLRs, [N] bool frozen
    -> u_hat [B, N] int8.  The batch is padded to a multiple of the block's
    frame count and the padding is cut off again."""
    B, N = ch_llr.shape
    F = check_supported(ch_llr.dtype, N, flavor)
    _register(_platform())
    x = _pad_to(ch_llr, F, 0)
    call = jax.ffi.ffi_call(
        "pd_bp_decode", jax.ShapeDtypeStruct(x.shape, jnp.int8))
    u = call(x, jnp.asarray(frozen).astype(jnp.int8),
             iters=np.int32(iters), flavor=np.int32(FLAVORS[flavor]),
             early_stop_every=np.int32(early_stop_every),
             frames_per_block=np.int32(F))
    return u[:B]


@functools.partial(jax.jit, static_argnames=("iters", "flavor",
                                              "check_every"))
def bp_wave_fused_kernel(state, ch_llr, retire, iters: int = 8,
                         flavor: str = "minsum_lut", check_every: int = 0):
    """Kernel twin of models/bp.bp_wave_fused_jnp: merge -> `iters`
    iterations -> decide on the stage-major state [2(n+1), B, N].
    Returns (state', u_hat [B, N] int8, done [B] bool).  The state buffer is
    updated in place when the caller donates it."""
    S2, B, N = state.shape
    F = check_supported(state.dtype, N, flavor)
    if ch_llr.dtype != state.dtype:
        raise KernelUnsupported("channel LLRs must match the state dtype")
    _register(_platform())
    st = _pad_to(state, F, 1)
    x = _pad_to(ch_llr, F, 0)
    r = _pad_to(retire.astype(jnp.int8), F, 0)
    Bp = st.shape[1]
    call = jax.ffi.ffi_call(
        "pd_bp_wave",
        (jax.ShapeDtypeStruct(st.shape, jnp.float32),
         jax.ShapeDtypeStruct((Bp, N), jnp.int8),
         jax.ShapeDtypeStruct((Bp,), jnp.int8)),
        input_output_aliases={0: 0})
    st, u, done = call(st, x, r, iters=np.int32(iters),
                       flavor=np.int32(FLAVORS[flavor]),
                       check_every=np.int32(check_every),
                       frames_per_block=np.int32(F))
    return st[:, :B], u[:B], done[:B] != 0
