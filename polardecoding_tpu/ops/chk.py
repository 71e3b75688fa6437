"""Box-plus (check-node) and path-metric LUT ops — branchless, batched.

The reference's CHK is min-sum with an 8-bin additive correction
delta(|a+b|) - delta(|a-b|), a table approximation of the exact
ln cosh((a+b)/2) - ln cosh((a-b)/2) terms (ref: SC_128.c:283-315, identical in
every Monte-Carlo program).  The same 8-bin table approximates ln(1 + e^-x) in
the SCL path-metric update PHI (ref: SCL_1024.c:481-502, derived in
updatePM.pdf).  The thresholds {0.196, 0.433, 0.71, 1.05, 1.508, 2.252, 4.5}
and values {0.65, 0.55, 0.45, 0.35, 0.25, 0.15, 0.05, 0} are normative
(SURVEY §7 "hard parts"): off-by-a-bin changes the published curves.

Array mapping: the piecewise lookup is evaluated as a sum of step functions
(7 compares + adds per lookup), which is branchless, fuses into surrounding
elementwise work, and vectorizes over any batch shape.  An exact SPA flavor
(2 atanh(tanh tanh)) is provided for the BP128out_SPA.txt A/B variant.
"""
from __future__ import annotations

import jax.numpy as jnp

# Normative correction table: value delta(x) for |x| in successive bins.
LUT_THRESHOLDS = (0.196, 0.433, 0.71, 1.05, 1.508, 2.252, 4.5)
LUT_VALUES = (0.65, 0.55, 0.45, 0.35, 0.25, 0.15, 0.05, 0.0)


def _lut_tree(x, lo, hi, dt):
    """Balanced select tree over bins [lo, hi): bin k iff
    T[k-1] <= x < T[k] (T[-1] = -inf, T[len] = +inf)."""
    if hi - lo == 1:
        return jnp.asarray(LUT_VALUES[lo], dt)
    mid = (lo + hi) // 2
    return jnp.where(x >= LUT_THRESHOLDS[mid - 1],
                     _lut_tree(x, mid, hi, dt), _lut_tree(x, lo, mid, dt))


def lut_correction(x):
    """delta(x) for x >= 0: piecewise-constant ln(1+e^-x) approximation.

    Branchless BALANCED select tree (depth 3 over the 8 bins) carrying the
    table's LITERAL values (not cumulative differences), so the result is
    bit-identical to the reference's if/else ladder in any precision,
    including the strict `<` bin edges (a value exactly at a threshold
    falls in the upper bin) and NaN (all compares false -> bin 0, as in
    the linear chain).  The tree cuts the lookup's dependent-select depth
    from 7 to 3 at identical op count; native/bp_kernel.cu uses the same
    tree."""
    dt = x.dtype
    return jnp.broadcast_to(_lut_tree(x, 0, len(LUT_VALUES), dt), x.shape)


def chk(a, b):
    """Table-corrected min-sum box-plus (ref CHK, SC_128.c:283-315):

        sign(a) sign(b) min(|a|, |b|) + (delta(|a+b|) - delta(|a-b|))

    with sign(0) treated as +1, matching the reference's `(L >= 0) ? 1 : -1`,
    and the delta difference formed first (the reference's association) so a
    float64 run is bit-identical to the C."""
    s = jnp.where((a >= 0) == (b >= 0), 1.0, -1.0).astype(a.dtype)
    m = jnp.minimum(jnp.abs(a), jnp.abs(b))
    delta = lut_correction(jnp.abs(a + b)) - lut_correction(jnp.abs(a - b))
    return s * m + delta


def chk_fast(a, b):
    """Algebraic rewrite of `chk` with ~12% fewer elementwise ops:

        sign(a) sign(b) min(|a|, |b|) == (|a+b| - |a-b|) / 2   (exact in R)

    so  chk(a, b) == 0.5 (|a+b| - |a-b|) + delta(|a+b|) - delta(|a-b|),
    reusing the |a+b| / |a-b| terms the LUT already needs and dropping the
    sign/min/abs(a)/abs(b) chain entirely.  NOT bit-identical to the reference: the halved
    difference rounds differently than the exact sign·min (ulp-level), so
    this is an opt-in flavor ("minsum_lut_fast") gated on the statistical
    BLER study, never the golden-parity default."""
    ap = jnp.abs(a + b)
    aq = jnp.abs(a - b)
    return 0.5 * (ap - aq) + (lut_correction(ap) - lut_correction(aq))


def chk_exact(a, b):
    """Exact sum-product box-plus 2 atanh(tanh(a/2) tanh(b/2)) — the "SPA"
    variant archived in myResult_128.zip:BP128out_SPA.txt.  Computed in the
    numerically stable min-sum + log1p form."""
    s = jnp.where((a >= 0) == (b >= 0), 1.0, -1.0).astype(a.dtype)
    m = jnp.minimum(jnp.abs(a), jnp.abs(b))
    return (
        s * m
        + jnp.log1p(jnp.exp(-jnp.abs(a + b)))
        - jnp.log1p(jnp.exp(-jnp.abs(a - b)))
    )


def phi_penalty(llr, u):
    """LLR-based path-metric increment PHI (ref: SCL_1024.c:481-502;
    Balatsoukas-Stimming et al., derivation in updatePM.pdf):

        PHI = delta(|l|) + |l| * [chosen bit disagrees with sign(l)]

    where disagreement means (u == 0 and l < 0) or (u == 1 and l > 0).
    `u` may be a traced 0/1 array broadcastable against `llr`.
    """
    absl = jnp.abs(llr)
    disagree = jnp.where(u == 0, llr < 0, llr > 0)
    return lut_correction(absl) + jnp.where(disagree, absl, jnp.zeros_like(absl))


def phi_penalties_both(llr):
    """(PHI(l, u=0), PHI(l, u=1)) in one pass — the SCL hot path computes both
    branches for every path (ref: SCL_1024.c:611-617)."""
    absl = jnp.abs(llr)
    base = lut_correction(absl)
    pen0 = base + jnp.where(llr < 0, absl, jnp.zeros_like(absl))
    pen1 = base + jnp.where(llr > 0, absl, jnp.zeros_like(absl))
    return pen0, pen1
