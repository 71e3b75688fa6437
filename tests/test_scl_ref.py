"""models/scl.scl_decode against the two SCL oracles, across the frozen-node
taxonomy a whole-decode SCL kernel would specialise on.

tests/scl_fast_ref.py is a float32 numpy twin that follows a fast-SSC-list
schedule node by node (R0, REP, mixed and all-info loop nodes).  In exact
mode (r1min=0) it is the reference SCL semantics (SCL_1024.c:546-680), so
every decoded path, path metric and tie counter must equal the jnp engine
bit for bit.  Its r1 mode (the bounded-fork rate-1 rule, r1min > 0) is the
written spec of the fast flavour and is exercised here on its own.
tests/reference_impl.py is the float64 graph-faithful oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from polardecoding_tpu.models.scl import scl_decode
from polardecoding_tpu.utils.sequences import frozen_mask

import reference_impl as ref
from scl_fast_ref import decode_batch

# an aligned all-frozen quad (R0), REP blocks, SPC and mixed patterns and an
# info tail: every node kind of the twin's schedule at wloop=4
MIXED32 = np.array(
    [1, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 1, 0, 0,
     1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0], bool)


def _llr(B, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N)) * 3).astype(np.float32)


def _parity(fr, L, B=16, wloop=2, llr=None, seed=7):
    """scl_decode == the exact-mode twin: paths, PMs and tie counters."""
    fr = np.asarray(fr, bool)
    if llr is None:
        llr = _llr(B, len(fr), seed)
    ua, pma, ta = scl_decode(jnp.asarray(llr), jnp.asarray(fr), list_size=L,
                             return_all=True, return_ties=True)
    ub, pmb, tb = decode_batch(llr, fr, L, wloop=wloop, r1min=0)
    np.testing.assert_array_equal(np.asarray(ua), ub)
    np.testing.assert_array_equal(np.asarray(pma), pmb)
    np.testing.assert_array_equal(np.asarray(ta), tb)


@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_mixed_mask_all_list_sizes(L):
    _parity(MIXED32, L)


@pytest.mark.parametrize("wloop", [2, 4, 8])
def test_mixed_mask_loop_widths(wloop):
    """The twin's loop-node width changes only its schedule, never the
    result."""
    _parity(MIXED32, 4, wloop=wloop)


@pytest.mark.parametrize("K", [8, 20, 28])
def test_5g_masks(K):
    """Low rate (large R0/REP regions), rate 5/8, and high rate (all-info
    loop nodes) from the 5G reliability sequence at N=32."""
    _parity(frozen_mask(32, K), 4)


def test_all_info():
    """Rate 1: no frozen structure, a pure fork schedule."""
    _parity(np.zeros(32, bool), 4)


def test_forced_ties():
    """Symmetric +-1 LLRs force exact PM ties at the median (the reference's
    "Oops!" condition, SCL_1024.c:620-633): the tie counters must match
    event for event."""
    fr = frozen_mask(32, 20)
    llr = np.tile(np.array([1.0, -1.0] * 16, np.float32), (16, 1))
    _, _, ta = scl_decode(jnp.asarray(llr), jnp.asarray(fr), list_size=4,
                          return_all=True, return_ties=True)
    assert int(np.asarray(ta).sum()) > 0  # the scenario really ties
    _parity(fr, 4, llr=llr)


def test_n128_l8():
    """The reference's small code, N=128 K=64, at the program default L=8."""
    _parity(frozen_mask(128, 64), 8, B=8)


def test_l32():
    """L=32 at N=32: more list slots than half the leaves."""
    _parity(frozen_mask(32, 20), 32, B=8)


@pytest.mark.parametrize("L", [2, 4])
def test_engine_matches_graph_oracle_on_mixed_mask(L):
    """The surviving (PM, path) multiset equals the float64 graph oracle's
    on the mixed mask (slot order differs: the oracle repacks)."""
    llrs = _llr(4, 32, 11).astype(np.float64)
    u_all, PM = scl_decode(jnp.asarray(llrs, jnp.float32),
                           jnp.asarray(MIXED32), list_size=L,
                           return_all=True)
    u_all, PM = np.asarray(u_all), np.asarray(PM)
    g = ref.Graph(32, "lee")
    for b in range(4):
        outs, pm_ref = ref.scl_decode(g, llrs[b], MIXED32, L,
                                      return_state=True)
        ours = sorted(range(L), key=lambda k: PM[b, k])
        refs = sorted(range(L), key=lambda k: pm_ref[k])
        np.testing.assert_allclose(PM[b, ours], pm_ref[refs], rtol=1e-4,
                                   atol=1e-4)
        for a, c in zip(ours, refs):
            assert (u_all[b, a] == outs[c]).all(), f"frame {b}"


def test_r1_rule_diverges_from_exact():
    """The bounded-fork rate-1 rule is not survivor-set preserving under
    the reference PHI (its hard PM drops the path-dependent lut(|l|)
    terms), so it is a flavour that needs a BLER qualification, never a
    bit-parity replacement.  Seed 1024 at N=32 K=20 L=4 (mean 2.0, sigma
    2.5): frame 3 decodes differently."""
    fr = frozen_mask(32, 20)
    rng = np.random.default_rng(1024)
    llr = (rng.normal(size=(64, 32)) * 2.5 + 2.0).astype(np.float32)
    ua, pma = scl_decode(jnp.asarray(llr), jnp.asarray(fr), list_size=4,
                         return_all=True)
    ub, pmb, _ = decode_batch(llr, fr, 4, wloop=2, r1min=2)
    ba = np.take_along_axis(np.asarray(ua),
                            np.asarray(pma).argmin(-1)[:, None, None],
                            axis=1)[:, 0]
    bb = np.take_along_axis(ub, pmb.argmin(-1)[:, None, None], axis=1)[:, 0]
    d = (ba != bb).any(axis=1)
    assert d[3], "the documented counterexample frame must diverge"


@pytest.mark.parametrize("r1min", [2, 4])
def test_r1_rule_decodes_clean_frames(r1min):
    """Noise-free LLRs of the all-zero codeword decode to all zeros under
    the rate-1 rule too (its path metric is hard, but a clean frame never
    forks against its own sign)."""
    fr = frozen_mask(64, 40)
    llr = np.full((2, 64), 4.0, np.float32)
    u, pm, _ = decode_batch(llr, fr, 4, wloop=2, r1min=r1min)
    best = np.take_along_axis(u, pm.argmin(-1)[:, None, None], axis=1)[:, 0]
    assert (best == 0).all()
