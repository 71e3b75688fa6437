"""Direct (slow, float64, per-frame) simulator of the reference semantics.

This is the test oracle: a pointer-free but otherwise faithful re-expression of
the reference C programs' graph algorithms, used to validate the vectorized
JAX engines on small N and random LLR inputs.  It implements BOTH factor-graph
wirings explicitly (Lee: separation 2^i, ref SC_128.c:317-342; Kao: separation
2^(n-1-i) with bit-reversal IO, ref SC_128_fag.c:333-358) so the production
code's "Kao == relabeled Lee" reduction is itself under test.

Only tests import this module.
"""
from __future__ import annotations

import numpy as np

from polardecoding_tpu.utils.sequences import bit_reversal

LUT_T = (0.196, 0.433, 0.71, 1.05, 1.508, 2.252, 4.5)
LUT_V = (0.65, 0.55, 0.45, 0.35, 0.25, 0.15, 0.05, 0.0)


def lutc(x: float) -> float:
    for t, v in zip(LUT_T, LUT_V[:-1]):
        if x < t:
            return v
    return 0.0


def chk(a: float, b: float) -> float:
    # association matches the C exactly: delta computed first, then added
    # (BP_128.c:273-305: delta = lut(sAbs); delta -= lut(dAbs); s*m + delta)
    s = (1 if a >= 0 else -1) * (1 if b >= 0 else -1)
    delta = lutc(abs(a + b)) - lutc(abs(a - b))
    return s * min(abs(a), abs(b)) + delta


def chk_spa(a: float, b: float) -> float:
    s = (1 if a >= 0 else -1) * (1 if b >= 0 else -1)
    return (
        s * min(abs(a), abs(b))
        + np.log1p(np.exp(-abs(a + b)))
        - np.log1p(np.exp(-abs(a - b)))
    )


def phi_penalty(l: float, u: int) -> float:
    res = lutc(abs(l))
    if (u == 0 and l < 0) or (u == 1 and l > 0):
        res += abs(l)
    return res


class Graph:
    """Butterfly lattice connectivity for one wiring convention.

    For each stage i in [0, n) we store the (upper, lower) left-position pairs;
    both left nodes of a pair share children (cU at the upper position, cL at
    the lower position, one stage to the right).
    """

    def __init__(self, N: int, convention: str):
        self.N = N
        self.n = N.bit_length() - 1
        self.convention = convention
        self.brev = bit_reversal(N)
        self.pairs = []  # pairs[i] = list of (upper_pos, lower_pos)
        for i in range(self.n):
            d = (1 << i) if convention == "lee" else (1 << (self.n - 1 - i))
            ps = []
            done = np.zeros(N, dtype=bool)
            for j in range(N):
                if not done[j]:
                    done[j] = True
                    done[j + d] = True
                    ps.append((j, j + d))
            self.pairs.append(ps)
        # partner/upper lookup per stage
        self.partner = np.zeros((self.n, N), dtype=np.int64)
        self.is_upper = np.zeros((self.n, N), dtype=bool)
        for i, ps in enumerate(self.pairs):
            for u, d in ps:
                self.partner[i, u] = d
                self.partner[i, d] = u
                self.is_upper[i, u] = True

    # IO mappings: logical bit index j <-> graph position at stage 0 / stage n.
    def u_graph_pos(self, j: int) -> int:
        return j if self.convention == "lee" else int(self.brev[j])

    def ch_graph_pos(self, j: int) -> int:
        # channel y[logical] feeds graph stage-n position p with logical = perm(p)
        return j if self.convention == "lee" else int(self.brev[j])


def bp_decode(g: Graph, ch_llr, frozen_logical, iters: int, chk_fn=chk):
    """Flooding BP with Gauss-Seidel stage sweeps (ref: BP_128.c:334-389;
    Kao variant BP_128_fag.c:349-403).  Returns u_hat (logical order)."""
    N, n = g.N, g.n
    L = np.zeros((n + 1, N))
    R = np.zeros((n + 1, N))
    for p in range(N):
        L[n, p] = ch_llr[g.ch_graph_pos(p)] if g.convention == "kao" else ch_llr[p]
    for p in range(N):
        logical = g.brev[p] if g.convention == "kao" else p
        R[0, p] = 999.0 if frozen_logical[logical] else 0.0
    for _ in range(iters):
        for i in range(n):
            newR = R[i + 1].copy()
            for u, d in g.pairs[i]:
                newR[u] = chk_fn(R[i, u], L[i + 1, d] + R[i, d])
                newR[d] = R[i, d] + chk_fn(R[i, u], L[i + 1, u])
            R[i + 1] = newR
        for i in range(n - 1, -1, -1):
            newL = L[i].copy()
            for u, d in g.pairs[i]:
                newL[u] = chk_fn(L[i + 1, u], L[i + 1, d] + R[i, d])
                newL[d] = L[i + 1, d] + chk_fn(R[i, u], L[i + 1, u])
            L[i] = newL
    u_hat = np.zeros(N, dtype=np.int8)
    for j in range(N):
        if frozen_logical[j]:
            u_hat[j] = 0
        else:
            p = g.u_graph_pos(j)
            u_hat[j] = 0 if (L[0, p] + R[0, p]) >= 0 else 1
    return u_hat


class _SCState:
    def __init__(self, g: Graph, num_paths: int):
        N, n = g.N, g.n
        self.llr = np.zeros((num_paths, n + 1, N))
        self.ldone = np.zeros((num_paths, n + 1, N), dtype=bool)
        self.bits = np.zeros((num_paths, n + 1, N), dtype=np.int8)
        self.bdone = np.zeros((num_paths, n + 1, N), dtype=bool)


def _get_llr(g: Graph, st: _SCState, k: int, i: int, p: int):
    """Recursive memoized LLR (ref: SC_128.c:344-365)."""
    if st.ldone[k, i, p]:
        return
    up = g.is_upper[i, p]
    cu = p if up else g.partner[i, p]
    cl = g.partner[i, p] if up else p
    _get_llr(g, st, k, i + 1, cu)
    _get_llr(g, st, k, i + 1, cl)
    if up:
        st.llr[k, i, p] = chk(st.llr[k, i + 1, cu], st.llr[k, i + 1, cl])
    else:
        partner = g.partner[i, p]
        assert st.bdone[k, i, partner], "wrong propagation order"
        sgn = 1.0 if st.bits[k, i, partner] == 0 else -1.0
        st.llr[k, i, p] = st.llr[k, i + 1, cl] + sgn * st.llr[k, i + 1, cu]
    st.ldone[k, i, p] = True


def _update_bit(g: Graph, st: _SCState, k: int, i: int, p: int):
    """Right-propagate decided bits (ref: SC_128.c:367-392)."""
    if st.bdone[k, i, p]:
        return
    st.bdone[k, i, p] = True
    if i == g.n:
        return
    partner = g.partner[i, p]
    if g.is_upper[i, p]:
        if st.bdone[k, i, partner]:
            cu = p
            st.bits[k, i + 1, cu] = st.bits[k, i, p] ^ st.bits[k, i, partner]
            _update_bit(g, st, k, i + 1, cu)
    else:
        if st.bdone[k, i, partner]:
            cu = partner
            st.bits[k, i + 1, cu] = st.bits[k, i, p] ^ st.bits[k, i, partner]
            _update_bit(g, st, k, i + 1, cu)
        cl = p
        st.bits[k, i + 1, cl] = st.bits[k, i, p]
        _update_bit(g, st, k, i + 1, cl)


def sc_decode(g: Graph, ch_llr, frozen_logical):
    """SC decoder (ref: SC_128.c:394-460; fag decode order SC_128_fag.c:436-448)."""
    N, n = g.N, g.n
    st = _SCState(g, 1)
    # frozen bits forced 0 up front
    for j in range(N):
        if frozen_logical[j]:
            p = g.u_graph_pos(j)
            st.bits[0, 0, p] = 0
            _update_bit(g, st, 0, 0, p)
    for p in range(N):
        src = g.ch_graph_pos(p) if g.convention == "kao" else p
        st.llr[0, n, p] = ch_llr[src]
        st.ldone[0, n, p] = True
    u_hat = np.zeros(N, dtype=np.int8)
    for j in range(N):
        p = g.u_graph_pos(j)
        _get_llr(g, st, 0, 0, p)
        if not frozen_logical[j]:
            st.bits[0, 0, p] = 0 if st.llr[0, 0, p] >= 0 else 1
            _update_bit(g, st, 0, 0, p)
        u_hat[j] = st.bits[0, 0, p]
    return u_hat


def scl_decode(g: Graph, ch_llr, frozen_logical, L: int, return_state=False):
    """SC list decoder with the reference's exact survivor-selection and slot
    repacking semantics (ref: SCL_1024.c:546-680)."""
    N, n = g.N, g.n
    st = _SCState(g, L)
    PM = np.zeros(L)
    for j in range(N):
        if frozen_logical[j]:
            p = g.u_graph_pos(j)
            st.bits[0, 0, p] = 0
            _update_bit(g, st, 0, 0, p)
    for p in range(N):
        src = g.ch_graph_pos(p) if g.convention == "kao" else p
        st.llr[:, n, p] = ch_llr[src]
        st.ldone[:, n, p] = True

    def copy_path(c, k, simple):
        # stages 0..n-1 only (rightmost shared; ref SCL_1024.c:450-478)
        st.llr[k, :n] = st.llr[c, :n]
        st.bits[k, :n] = st.bits[c, :n]
        if not simple:
            st.ldone[k, :n] = st.ldone[c, :n]
            st.bdone[k, :n] = st.bdone[c, :n]

    act = 1
    j = 0
    while j < N and act < L:
        p = g.u_graph_pos(j)
        for k in range(act):
            _get_llr(g, st, k, 0, p)
        if not frozen_logical[j]:
            for k in range(act):
                copy_path(k, k + act, simple=False)
            for k in range(act):
                st.bits[k, 0, p] = 0
                st.bits[k + act, 0, p] = 1
                PM[k + act] = PM[k] + phi_penalty(st.llr[k, 0, p], 1)
                PM[k] = PM[k] + phi_penalty(st.llr[k, 0, p], 0)
                _update_bit(g, st, k, 0, p)
                _update_bit(g, st, k + act, 0, p)
            act *= 2
        else:
            for k in range(act):
                PM[k] += phi_penalty(st.llr[k, 0, p], 0)
        j += 1
    for j in range(j, N):
        p = g.u_graph_pos(j)
        for k in range(L):
            _get_llr(g, st, k, 0, p)
        if not frozen_logical[j]:
            cand = np.zeros(2 * L)
            for k in range(L):
                cand[k] = PM[k] + phi_penalty(st.llr[k, 0, p], 0)
                cand[k + L] = PM[k] + phi_penalty(st.llr[k, 0, p], 1)
            PM0 = cand[:L].copy()
            PM1 = cand[L:].copy()
            med = np.sort(cand)[L]
            surviv = np.zeros(L, dtype=np.int64)
            for k in range(L):
                s0, s1 = PM0[k] < med, PM1[k] < med
                surviv[k] = 2 if (s0 and s1) else (1 if s1 else (0 if s0 else -1))
            PM[:] = PM0
            free = 0
            for k in range(L):
                if surviv[k] == 0:
                    st.bits[k, 0, p] = 0
                    _update_bit(g, st, k, 0, p)
                elif surviv[k] == 1:
                    st.bits[k, 0, p] = 1
                    _update_bit(g, st, k, 0, p)
                    PM[k] = PM1[k]
                elif surviv[k] == 2:
                    while surviv[free] != -1:
                        free += 1
                    copy_path(k, free, simple=True)
                    st.bits[k, 0, p] = 0
                    _update_bit(g, st, k, 0, p)
                    st.bits[free, 0, p] = 1
                    _update_bit(g, st, free, 0, p)
                    surviv[free] = -2
                    PM[free] = PM1[k]
        else:
            for k in range(L):
                PM[k] += phi_penalty(st.llr[k, 0, p], 0)

    # per-path logical outputs
    outs = np.zeros((L, N), dtype=np.int8)
    for j in range(N):
        outs[:, j] = st.bits[:, 0, g.u_graph_pos(j)]
    if return_state:
        return outs, PM
    best = int(np.argmin(PM))
    return outs[best]
