"""The BP kernel (native/bp_kernel.cu, ops/bp_kernel.py) on the CPU.

The kernel's source also builds for the host (-DPD_HOST): the same block
bodies run serially, behind the same FFI entry points, so its arithmetic and
control flow are checked here bit for bit against the plain engines of
models/bp.py and the graph-faithful numpy oracle.  The wrapper around the
call (padding, block choice, refusals, shapes, engine choice, sharding) is
plain Python and JAX and is tested directly.  The comparison on the card
itself is marked `gpu` and is phase 3 of chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polardecoding_tpu.configs import preset
from polardecoding_tpu.models.bp import (
    bp_decode,
    bp_decode_auto,
    bp_wave_fused_jnp,
    use_kernel,
    wave_init_state,
)
from polardecoding_tpu.ops import chk as chk_ops
from polardecoding_tpu.ops.bp_kernel import (
    FLAVORS,
    KernelUnsupported,
    bp_decode_kernel,
    bp_wave_fused_kernel,
    check_supported,
    frames_per_block,
    smem_bytes,
)
from polardecoding_tpu.parallel.harness import make_frame_step, make_wave_step
from polardecoding_tpu.parallel.mesh import data_mesh
from polardecoding_tpu.utils.sequences import frozen_mask

import reference_impl as ref


def _llr(B, N, seed, scale=1.5, mean=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray((rng.normal(size=(B, N)) * scale + mean)
                       .astype(np.float32))


def _wave_inputs(N, B, seed):
    fr = jnp.asarray(frozen_mask(N, N // 2))
    rng = np.random.default_rng(seed)
    state = wave_init_state(_llr(B, N, seed), fr)
    state = bp_wave_fused_jnp(state, _llr(B, N, seed), jnp.zeros(B, bool),
                              iters=3)[0]
    fresh = _llr(B, N, seed + 1)
    retire = jnp.asarray(rng.integers(0, 2, size=B).astype(bool))
    return state, fresh, retire


# --- the kernel's arithmetic against the plain engines ---------------------


@pytest.mark.parametrize("early_stop_every", [0, 4])
@pytest.mark.parametrize("flavor", ["minsum_lut", "minsum_lut_fast"])
@pytest.mark.parametrize("N", [32, 64, 128, 256])
def test_decode_kernel_matches_bp_decode(N, flavor, early_stop_every):
    """Decisions bit-equal to bp_decode, fixed iterations and the per-frame
    early-stop latch; B = 20 is not a multiple of the block's frame count
    at N <= 64, so the padding path is exercised too."""
    fr = jnp.asarray(frozen_mask(N, N // 2))
    llr = _llr(20, N, N)
    a = np.asarray(bp_decode(llr, fr, iters=24, flavor=flavor,
                             early_stop_every=early_stop_every))
    b = np.asarray(bp_decode_kernel(llr, fr, iters=24, flavor=flavor,
                                    early_stop_every=early_stop_every))
    assert a.shape == b.shape == (20, N)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("convention", ["lee", "kao"])
@pytest.mark.parametrize("N,K", [(8, 4), (16, 12), (32, 16)])
def test_decode_kernel_matches_numpy_oracle(N, K, convention):
    """Kernel decisions equal the float64 graph-faithful oracle of either
    wiring (the Kao graph is the Lee graph under per-stage bit-reversal
    relabeling, so one engine serves both) on the frames of
    test_bp.test_bp_matches_oracle."""
    frozen = frozen_mask(N, K)
    g = ref.Graph(N, convention)
    rng = np.random.default_rng(N + (convention == "kao"))
    llrs = rng.normal(size=(6, N)) * 3.0
    got = np.asarray(bp_decode_kernel(jnp.asarray(llrs, jnp.float32),
                                      jnp.asarray(frozen), iters=10))
    for b in range(6):
        want = ref.bp_decode(g, llrs[b], frozen, iters=10)
        assert (got[b] == want).all(), f"frame {b}"


@pytest.mark.parametrize("check_every", [0, 1, 2, 6])
@pytest.mark.parametrize("N", [32, 128])
def test_wave_kernel_matches_jnp(N, check_every):
    """Fused wave step (merge + 6 iterations + decide, in-wave latch):
    state, decisions and done flags bit-equal to bp_wave_fused_jnp."""
    state, fresh, retire = _wave_inputs(N, 24, N + check_every)
    a = bp_wave_fused_jnp(state, fresh, retire, iters=6,
                          check_every=check_every)
    b = bp_wave_fused_kernel(state, fresh, retire, iters=6,
                             check_every=check_every)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("flavor", ["minsum_lut_fast", "spa"])
def test_wave_kernel_flavors(flavor):
    """The other two flavours through the wave entry: the fast flavour is
    bit-equal; spa's exp/log1p come from two different math libraries, so
    its messages agree to float32 rounding."""
    state, fresh, retire = _wave_inputs(64, 16, 5)
    a = bp_wave_fused_jnp(state, fresh, retire, iters=3, flavor=flavor)
    b = bp_wave_fused_kernel(state, fresh, retire, iters=3, flavor=flavor)
    if flavor == "spa":
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                                   rtol=1e-5, atol=1e-4)
    else:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_wave_kernel_is_decode_kernel_from_fresh_state():
    """Merging every slot then running K iterations is bp_decode with K
    iterations: the two entries agree on decisions."""
    N, B = 64, 16
    fr = jnp.asarray(frozen_mask(N, 32))
    llr = _llr(B, N, 9)
    st = wave_init_state(jnp.zeros_like(llr), fr)
    _, u_w, _ = bp_wave_fused_kernel(st, llr, jnp.ones(B, bool), iters=12)
    u_d = bp_decode_kernel(llr, fr, iters=12)
    np.testing.assert_array_equal(np.asarray(u_w), np.asarray(u_d))


def test_decode_kernel_early_stop_batch_invariance():
    """A frame's early-stop decision is a function of its own LLRs: alone
    or inside a batch (another block, or another slot of one block)."""
    N = 64
    fr = jnp.asarray(frozen_mask(N, 32))
    llr = _llr(24, N, 4)
    full = np.asarray(bp_decode_kernel(llr, fr, iters=40,
                                       early_stop_every=4))
    for b in (0, 7, 23):
        alone = np.asarray(bp_decode_kernel(llr[b:b + 1], fr, iters=40,
                                            early_stop_every=4))
        np.testing.assert_array_equal(alone[0], full[b])


def test_wave_kernel_check_every_retires_superset():
    """Checks inside the wave can only retire more frames than the single
    boundary check, never fewer."""
    state, fresh, retire = _wave_inputs(32, 32, 17)
    _, _, d0 = bp_wave_fused_kernel(state, fresh, retire, iters=6)
    _, _, d1 = bp_wave_fused_kernel(state, fresh, retire, iters=6,
                                    check_every=1)
    assert np.all(np.asarray(d0) <= np.asarray(d1))


# --- the wrapper ------------------------------------------------------------


@pytest.mark.parametrize("N,F", [(16, 32), (32, 16), (128, 4), (256, 2),
                                 (1024, 1), (2048, 1)])
def test_frames_per_block(N, F):
    assert frames_per_block(N) == F


def test_smem_budget():
    """N=1024 holds 2 (n+1) N f32 messages per frame (90,112 B) and fits
    two blocks in a Hopper SM; N=2048 still fits one; N=4096 does not."""
    assert smem_bytes(1024, 1) == 90112 + 1024 + 16 + 16
    assert 2 * smem_bytes(1024, 1) <= 227 * 1024
    assert check_supported(jnp.float32, 2048, "minsum_lut") == 1
    with pytest.raises(KernelUnsupported, match="shared memory"):
        check_supported(jnp.float32, 4096, "minsum_lut")


@pytest.mark.parametrize("dtype,N,flavor,match", [
    (jnp.bfloat16, 64, "minsum_lut", "float32"),
    (jnp.float16, 64, "spa", "float32"),
    (jnp.float32, 48, "minsum_lut", "power of two"),
    (jnp.float32, 64, "minsum", "flavor"),
])
def test_kernel_refuses(dtype, N, flavor, match):
    with pytest.raises(KernelUnsupported, match=match):
        bp_decode_kernel(jnp.zeros((4, N), dtype), jnp.zeros(N, bool),
                         iters=2, flavor=flavor)


def test_flavor_table_matches_plain_engine():
    """Every flavour the plain engine accepts has a kernel code, in the
    order the CUDA source switches on."""
    assert FLAVORS == {"minsum_lut": 0, "minsum_lut_fast": 1, "spa": 2}
    for name, fn in (("minsum_lut", chk_ops.chk),
                     ("minsum_lut_fast", chk_ops.chk_fast),
                     ("spa", chk_ops.chk_exact)):
        assert name in FLAVORS and callable(fn)


@pytest.mark.parametrize("B,N", [(20, 32), (8, 1024)])
def test_output_shapes(B, N):
    """Shapes and dtypes from jax.eval_shape: nothing runs, no padding
    leaks out."""
    fr = jax.ShapeDtypeStruct((N,), jnp.bool_)
    llr = jax.ShapeDtypeStruct((B, N), jnp.float32)
    u = jax.eval_shape(lambda x, f: bp_decode_kernel(x, f, iters=3), llr, fr)
    assert (u.shape, u.dtype) == ((B, N), jnp.int8)
    n = N.bit_length() - 1
    st = jax.ShapeDtypeStruct((2 * (n + 1), B, N), jnp.float32)
    ret = jax.ShapeDtypeStruct((B,), jnp.bool_)
    s2, u2, d2 = jax.eval_shape(
        lambda s, x, r: bp_wave_fused_kernel(s, x, r, iters=2), st, llr, ret)
    assert (s2.shape, s2.dtype) == (st.shape, jnp.float32)
    assert (u2.shape, u2.dtype) == ((B, N), jnp.int8)
    assert (d2.shape, d2.dtype) == ((B,), jnp.bool_)


@pytest.mark.parametrize("engine,want", [("auto", False), ("jnp", False),
                                         ("kernel", True), ("pallas", None)])
def test_engine_choice_on_cpu(engine, want):
    """"auto" takes the kernel only on the GPU, so the CPU gets the plain
    engine; an unknown engine is an error, never a silent fallback."""
    if want is None:
        with pytest.raises(ValueError):
            use_kernel(engine)
    else:
        assert use_kernel(engine) is want


def test_auto_dispatch_on_cpu_is_plain_engine():
    N = 32
    fr = jnp.asarray(frozen_mask(N, 16))
    llr = _llr(8, N, 2)
    np.testing.assert_array_equal(
        np.asarray(bp_decode_auto(llr, fr, iters=7)),
        np.asarray(bp_decode(llr, fr, iters=7)))
    # bf16 messages are the plain engine's business: accepted off the GPU
    bp_decode_auto(llr.astype(jnp.bfloat16), fr, iters=2, engine="jnp")


# --- the kernel inside the harness -------------------------------------------


@pytest.mark.parametrize("mesh_devices", [1, 8])
def test_frame_step_kernel_equals_jnp(mesh_devices):
    """The BP_128 frame step counts the same errors with either engine,
    unsharded and per shard on the 8-device mesh."""
    p = preset("BP_128")
    mesh = data_mesh(jax.devices()[:mesh_devices])
    key = jax.random.PRNGKey(3)
    sigma = jnp.float32(10.0 ** (-1.5 / 20.0))
    outs = [make_frame_step(p, 64, mesh, bp_engine=e)(key, jnp.int32(0),
                                                      sigma)
            for e in ("jnp", "kernel")]
    assert [int(v) for v in outs[0]] == [int(v) for v in outs[1]]
    assert int(outs[0][1]) > 0  # the point has errors to count


@pytest.mark.parametrize("mesh_devices", [1, 8])
def test_wave_step_kernel_equals_jnp(mesh_devices):
    """The fused wave engine (BP_128_FASTCHK, K=4): every step's counters
    and the drain agree between engines, unsharded and on the mesh."""
    p = preset("BP_128_FASTCHK")
    mesh = data_mesh(jax.devices()[:mesh_devices])
    key = jax.random.PRNGKey(5)
    sigma = jnp.float32(10.0 ** (-2.0 / 20.0))
    runs = []
    for engine in ("jnp", "kernel"):
        init, step, drain = make_wave_step(p, 64, 4, mesh, bp_engine=engine)
        carry = init(key, jnp.int32(0), sigma)
        outs = []
        for _ in range(5):
            carry, out = step(key, sigma, carry)
            outs.append(tuple(int(v) for v in out))
        carry, out = drain(sigma, carry)
        outs.append(tuple(int(v) for v in out))
        runs.append(outs)
    assert runs[0] == runs[1]
    assert sum(o[2] for o in runs[0]) > 0


# --- on the card ---------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_against_plain_engines_on_card(gpu):
    """Phase 3 of chip_smoke.py: the CUDA build against the plain engines at
    N=1024 (B=8192 decode, B=16384 wave), a slice against the CPU backend,
    and the GF(2) encoders."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.phase_kernel()
