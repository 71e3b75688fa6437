"""BP decoder: vectorized engine vs the direct graph-faithful oracle."""
import numpy as np
import jax.numpy as jnp
import pytest

from polardecoding_tpu.models.bp import bp_decode, bpr_decode
from polardecoding_tpu.utils.sequences import frozen_mask, info_set
from polardecoding_tpu.ops.encode import polar_encode, scatter_info

import reference_impl as ref


def _random_llrs(N, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, N)) * 3.0


@pytest.mark.parametrize("convention", ["lee", "kao"])
@pytest.mark.parametrize("N,K", [(8, 4), (16, 12), (32, 16)])
def test_bp_matches_oracle(N, K, convention):
    frozen = frozen_mask(N, K)
    g = ref.Graph(N, convention)
    llrs = _random_llrs(N, 6, seed=N + (convention == "kao"))
    got = np.asarray(bp_decode(jnp.asarray(llrs), jnp.asarray(frozen), iters=10))
    for b in range(llrs.shape[0]):
        want = ref.bp_decode(g, llrs[b], frozen, iters=10)
        assert (got[b] == want).all(), f"frame {b} ({convention})"


def test_bp_kao_equals_lee_exactly():
    """The Kao wiring is the Lee wiring under per-stage bit reversal; both
    oracles must produce identical u_hat for identical inputs."""
    N, K = 32, 16
    frozen = frozen_mask(N, K)
    glee = ref.Graph(N, "lee")
    gkao = ref.Graph(N, "kao")
    llrs = _random_llrs(N, 4, seed=11)
    for b in range(4):
        a = ref.bp_decode(glee, llrs[b], frozen, iters=8)
        c = ref.bp_decode(gkao, llrs[b], frozen, iters=8)
        assert (a == c).all()


def test_bp_decodes_clean_frames():
    """Noise-free LLRs must decode to the transmitted payload."""
    N, K = 128, 64
    I = info_set(N, K)
    frozen = frozen_mask(N, K)
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 2, size=(8, K)).astype(np.int8)
    u = scatter_info(jnp.asarray(payload), jnp.asarray(I), N)
    x = polar_encode(u)
    llr = 10.0 * (1.0 - 2.0 * np.asarray(x, dtype=np.float64))
    u_hat = np.asarray(bp_decode(jnp.asarray(llr, dtype=jnp.float32), jnp.asarray(frozen), iters=40))
    assert (u_hat[:, I] == payload).all()


def test_bp_early_stop_matches_fixed_on_clean_frames():
    N, K = 128, 64
    I = info_set(N, K)
    frozen = frozen_mask(N, K)
    rng = np.random.default_rng(2)
    payload = rng.integers(0, 2, size=(4, K)).astype(np.int8)
    u = scatter_info(jnp.asarray(payload), jnp.asarray(I), N)
    x = polar_encode(u)
    llr = jnp.asarray(8.0 * (1.0 - 2.0 * np.asarray(x, np.float64)), jnp.float32)
    fixed = np.asarray(bp_decode(llr, jnp.asarray(frozen), iters=100))
    early = np.asarray(
        bp_decode(llr, jnp.asarray(frozen), iters=100, early_stop_every=1)
    )
    assert (fixed == early).all()


def test_bp_early_stop_batch_invariance():
    """A frame's early-stop decision is latched at its own first passing
    check, so it must not depend on which other frames share the batch
    (advisor round-1 medium finding)."""
    N = 64
    frozen = frozen_mask(N, 32)
    # noisy frames: convergence iteration varies per frame
    llrs = jnp.asarray(_random_llrs(N, 8, seed=7), jnp.float32)
    full = np.asarray(bp_decode(llrs, jnp.asarray(frozen), iters=40,
                                early_stop_every=4))
    for b in range(8):
        solo = np.asarray(bp_decode(llrs[b:b + 1], jnp.asarray(frozen),
                                    iters=40, early_stop_every=4))
        assert (solo[0] == full[b]).all(), f"frame {b} decision batch-dependent"


def test_bp_spa_flavor_differs_and_decodes():
    N, K = 64, 32
    I = info_set(N, K)
    frozen = frozen_mask(N, K)
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 2, size=(4, K)).astype(np.int8)
    u = scatter_info(jnp.asarray(payload), jnp.asarray(I), N)
    x = polar_encode(u)
    llr = jnp.asarray(
        6.0 * (1.0 - 2.0 * np.asarray(x, np.float64)) , jnp.float32
    )
    u_spa = np.asarray(bp_decode(llr, jnp.asarray(frozen), iters=30, flavor="spa"))
    assert (u_spa[:, I] == payload).all()


def test_bp_fast_flavor_decodes():
    """The opt-in minsum_lut_fast flavor (ulp-level rounding differences
    only) must decode clean frames and agree with the default flavor on
    moderately noisy ones in the overwhelming majority of frames."""
    N, K = 128, 64
    I = info_set(N, K)
    frozen = frozen_mask(N, K)
    rng = np.random.default_rng(13)
    payload = rng.integers(0, 2, size=(8, K)).astype(np.int8)
    u = scatter_info(jnp.asarray(payload), jnp.asarray(I), N)
    x = polar_encode(u)
    llr = jnp.asarray(8.0 * (1.0 - 2.0 * np.asarray(x, np.float64)), jnp.float32)
    u_fast = np.asarray(bp_decode(llr, jnp.asarray(frozen), iters=40,
                                  flavor="minsum_lut_fast"))
    assert (u_fast[:, I] == payload).all()


def test_bpr_stage_errors():
    """BPr: on clean frames the per-stage error counts at late checkpoints are 0;
    shape/semantics match BPr_128.c's E table."""
    N, K = 32, 16
    I = info_set(N, K)
    frozen = frozen_mask(N, K)
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 2, size=(4, K)).astype(np.int8)
    u = scatter_info(jnp.asarray(payload), jnp.asarray(I), N)
    x = polar_encode(u)
    llr = jnp.asarray(8.0 * (1.0 - 2.0 * np.asarray(x, np.float64)), jnp.float32)
    u_hat, errs = bpr_decode(
        llr, jnp.asarray(frozen), u, jnp.asarray(I), iters=20, checkpoints=(2, 5, 10)
    )
    assert errs.shape == (3, N.bit_length())
    assert int(errs[-1].sum()) == 0
    assert (np.asarray(u_hat)[:, I] == payload).all()


@pytest.mark.parametrize("flavor", ["minsum_lut", "spa"])
@pytest.mark.parametrize("N,K", [(8, 4), (16, 12), (32, 16)])
def test_wave_fused_matches_oracle(N, K, flavor):
    """The fused wave step from a fresh state (every slot merged) for 10
    iterations is BP with 10 iterations: its decisions equal the float64
    oracle's, for the exact-LUT and the sum-product flavours."""
    from polardecoding_tpu.models.bp import bp_wave_fused_jnp, wave_init_state

    frozen = frozen_mask(N, K)
    g = ref.Graph(N, "lee")
    llrs = _random_llrs(N, 6, seed=N)
    llr = jnp.asarray(llrs, jnp.float32)
    st = wave_init_state(jnp.zeros_like(llr), jnp.asarray(frozen))
    _, got, _ = bp_wave_fused_jnp(st, llr, jnp.ones(6, bool), iters=10,
                                  flavor=flavor)
    chk_fn = {"minsum_lut": ref.chk, "spa": ref.chk_spa}[flavor]
    for b in range(6):
        want = ref.bp_decode(g, llrs[b], frozen, iters=10, chk_fn=chk_fn)
        assert (np.asarray(got)[b] == want).all(), f"frame {b}"
