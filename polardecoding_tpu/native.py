"""ctypes loader for the native exact-parity engine (native/golden_ref.c).

Builds lib on demand with the system C compiler (cc -O2 -shared -fPIC) into
native/build/, then binds:

  golden_noise(seed, nframes, N, sigma)    -> [nframes, N] float64
  golden_mc(N, K, info_set, seed, snr_db, nframes, decoder, iters)
      -> (errbit, errblock, u_hat [nframes, K] int8)

`decoder`: "bp" or "sc".  Used by golden-parity tests (thousands of frames
against the C-reference stream) and as the measured single-core CPU baseline
for bench comparisons.  Raises NativeUnavailable if no compiler is present.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD = os.path.join(_HERE, "native", "build")
_LIB = os.path.join(_BUILD, "libgolden_ref.so")


class NativeUnavailable(RuntimeError):
    pass


def build_shared(src: str, lib: str, argv) -> str:
    """Compile native/<src> into native/build/<lib> unless the library is
    newer than its source; returns the library path.  `argv(src_path,
    out_path)` gives the compiler command.  The output is written to a
    temporary name and renamed, so concurrent builders never load a
    half-written library.  Raises NativeUnavailable when the command fails."""
    src_path = os.path.join(_HERE, "native", src)
    out = os.path.join(_BUILD, lib)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src_path):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(argv(src_path, tmp), check=True, capture_output=True,
                       text=True)
    except FileNotFoundError as e:
        raise NativeUnavailable(f"compiler not found: {e}") from None
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(
            f"building {src} failed:\n{e.stdout}\n{e.stderr}") from None
    os.replace(tmp, out)
    return out


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    err = None
    for cc in ("cc", "gcc", "clang"):
        try:
            build_shared("golden_ref.c", "libgolden_ref.so",
                         lambda src, out: [cc, "-O2", "-shared", "-fPIC",
                                           "-o", out, src, "-lm"])
            break
        except NativeUnavailable as e:
            err = e
    else:
        raise NativeUnavailable(f"no working C compiler: {err}")
    lib = ctypes.CDLL(_LIB)
    lib.pd_golden_noise.argtypes = [
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.pd_golden_mc.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint64, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
    ]
    lib.pd_golden_mc_list.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_uint64, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
    ]
    _lib = lib
    return lib


def golden_noise(seed: int, nframes: int, N: int, sigma: float) -> np.ndarray:
    lib = _load()
    out = np.empty((nframes, N), dtype=np.float64)
    lib.pd_golden_noise(
        seed, nframes, N, sigma,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def golden_mc_list(
    N: int,
    K: int,
    info_set: np.ndarray,
    seed: int,
    snr_db: float,
    nframes: int,
    list_size: int = 8,
    crc_exponents=None,
    return_bits: bool = True,
):
    """Native SCL / CA-SCL Monte-Carlo at matched seeds.  info_set carries the
    K + r info channels for CA-SCL (pass crc_exponents) or K for plain SCL.
    Returns (errbit, errblock, bits [nframes, len(info_set)] or None)."""
    lib = _load()
    info = np.ascontiguousarray(info_set, dtype=np.int32)
    KI = info.shape[0]
    if crc_exponents:
        exps = np.ascontiguousarray(crc_exponents, dtype=np.int32)
        exps_p = exps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n_crc = len(crc_exponents)
        assert KI == K + max(crc_exponents)
    else:
        exps_p, n_crc = None, 0
        assert KI == K
    eb = ctypes.c_int64()
    ebl = ctypes.c_int64()
    bits = np.empty((nframes, KI), dtype=np.int8) if return_bits else None
    lib.pd_golden_mc_list(
        N, K, KI, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        exps_p, n_crc, seed, snr_db, nframes, list_size,
        ctypes.byref(eb), ctypes.byref(ebl),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        if bits is not None else None,
    )
    return eb.value, ebl.value, bits


def golden_mc(
    N: int,
    K: int,
    info_set: np.ndarray,
    seed: int,
    snr_db: float,
    nframes: int,
    decoder: str = "sc",
    iters: int = 100,
    return_bits: bool = True,
):
    lib = _load()
    info = np.ascontiguousarray(info_set, dtype=np.int32)
    assert info.shape == (K,)
    eb = ctypes.c_int64()
    ebl = ctypes.c_int64()
    bits = np.empty((nframes, K), dtype=np.int8) if return_bits else None
    lib.pd_golden_mc(
        N, K, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        seed, snr_db, nframes, {"bp": 0, "sc": 1}[decoder], iters,
        ctypes.byref(eb), ctypes.byref(ebl),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        if bits is not None else None,
    )
    return eb.value, ebl.value, bits
