"""Numpy float32 spec of a frozen-specialized (fast-SSC-list) SCL decoder.

A straight-line implementation of the static node taxonomy a whole-decode
SCL kernel specialises on (R0, REP, mixed/SPC and all-info loop nodes, and
the bounded-fork rate-1 node), with explicit per-path arrays and full path
copies:

  * exact mode (r1min=0) mirrors the reference SCL semantics node-for-node
    and is validated against models/scl.scl_decode (tests/test_scl_ref.py);
  * r1 mode (r1min>0) is the bounded-fork rate-1 rule (hard PM,
    magnitude-ordered forks, fixed tie-breaks): the spec of the approximate
    fast flavour, which is not survivor-set preserving and so needs a BLER
    qualification.

All arithmetic is IEEE float32 with the association of models/scl.py, so
agreement with the engine is BIT equality, not closeness.  Selection order: the
2L candidates are ordered [PHI(u=0) of paths 0..L-1, PHI(u=1) of paths
0..L-1] and kept by stable sort on PM — exactly the kernel's rank
tie-breaks (cand0 beats cand1 on ties; lower path index beats higher).
"""
from __future__ import annotations

import numpy as np

BIG = np.float32(1e30)
LUT_T = (0.196, 0.433, 0.71, 1.05, 1.508, 2.252, 4.5)
LUT_V = (0.65, 0.55, 0.45, 0.35, 0.25, 0.15, 0.05, 0.0)


def lut(x):
    x = np.asarray(x, np.float32)
    out = np.full(x.shape, LUT_V[-1], np.float32)
    for t, v in zip(reversed(LUT_T), reversed(LUT_V[:-1])):
        out = np.where(x >= np.float32(t), out,
                       np.float32(v)).astype(np.float32)
    return out


def chk(a, b):
    s = np.where((a >= 0) == (b >= 0), np.float32(1), np.float32(-1))
    m = np.minimum(np.abs(a), np.abs(b))
    delta = (lut(np.abs(a + b)) - lut(np.abs(a - b))).astype(np.float32)
    return (s * m + delta).astype(np.float32)


def pen_pair(l0):
    a = np.abs(l0).astype(np.float32)
    base = lut(a)
    p0 = (base + np.where(l0 < 0, a, np.float32(0))).astype(np.float32)
    p1 = (base + np.where(l0 > 0, a, np.float32(0))).astype(np.float32)
    return p0, p1


def _ntz(x):
    return (x & -x).bit_length() - 1


def decode_frame(llr_row, frozen, L, wloop=2, r1min=0):
    """One-frame SCL decode following the fast kernel's schedule.
    Returns (u_all [L, N] int8, PM [L] f32, ties int)."""
    fr = np.asarray(frozen, bool)
    N = len(fr)
    n = N.bit_length() - 1
    ch = np.broadcast_to(np.asarray(llr_row, np.float32), (L, N)).copy()

    S = {
        "llr": [np.zeros((L, 1 << s), np.float32) for s in range(n)],
        "bits": [np.zeros((L, 1 << s), np.float32) for s in range(n)],
        "PM": np.full(L, BIG, np.float32),
        "ties": 0,
    }
    S["PM"][0] = np.float32(0)

    def get_llr(s):
        return ch if s == n else S["llr"][s]

    def fork_sel(pen0, pen1, frozen_bit=False, extras=()):
        """2L -> L selection with the kernel's candidate order + tie-breaks.
        Returns (ub [L] f32, gathered extras)."""
        if frozen_bit:
            S["PM"] = (S["PM"] + pen0).astype(np.float32)
            return np.zeros(L, np.float32), tuple(extras)
        cand = np.concatenate([S["PM"] + pen0,
                               S["PM"] + pen1]).astype(np.float32)
        order = np.argsort(cand, kind="stable")
        if L > 1 and cand[order[L - 1]] == cand[order[L]] \
                and cand[order[L]] < BIG / 2:
            S["ties"] += 1
        keep = order[:L]
        parent = keep % L
        ub = (keep >= L).astype(np.float32)
        S["PM"] = cand[keep].astype(np.float32)
        S["llr"] = [a[parent] for a in S["llr"]]
        S["bits"] = [a[parent] for a in S["bits"]]
        return ub, tuple(e[parent] for e in extras)

    def descend(x, s):
        w = 1 << s
        for k in range(s):
            c = 1 << k
            h = w >> (k + 1)
            v = x.reshape(L, c, 2, h)
            up, dn = v[:, :, 0], v[:, :, 1]
            x = np.stack([chk(up, dn), (dn + up).astype(np.float32)],
                         axis=2).reshape(L, w)
        return x

    def loop_node(stage, off):
        w = 1 << stage
        ub = np.zeros(L, np.float32)
        for jj in range(w):
            tz = _ntz(jj | w)
            for i in range(stage - 1, -1, -1):
                wi = 1 << i
                src = get_llr(i + 1)
                up, dn = src[:, :wi], src[:, wi:]
                pb = S["bits"][i]
                if tz == i:
                    S["llr"][i] = (
                        dn + (np.float32(1) - np.float32(2) * pb) * up
                    ).astype(np.float32)
                elif tz > i:
                    S["llr"][i] = chk(up, dn)
            l0 = S["llr"][0][:, 0]
            p0, p1 = pen_pair(l0)
            ub, _ = fork_sel(p0, p1, frozen_bit=bool(fr[off + jj]))
            t1 = _ntz(jj + 1)
            vs = ub[:, None].astype(np.float32)
            for i in range(stage):
                old = S["bits"][i]
                if t1 == i:
                    S["bits"][i] = vs.copy()
                vs = np.concatenate([np.abs(old - vs), vs],
                                    axis=1).astype(np.float32)
        vs = ub[:, None].astype(np.float32)
        for i in range(stage):
            old = S["bits"][i]
            vs = np.concatenate([np.abs(old - vs), vs],
                                axis=1).astype(np.float32)
        return vs, True

    def r1_node(stage):
        w = 1 << stage
        t = min(L - 1, w)
        alpha = get_llr(stage).copy()
        beta = (alpha < 0).astype(np.float32)
        if t == 0:
            return beta, False
        xm = np.abs(alpha).astype(np.float32)
        mins = np.zeros((L, t), np.float32)
        pos = np.zeros((L, t), np.int64)
        rows = np.arange(L)
        for k in range(t):
            m = xm.min(axis=1)
            j = np.argmax(xm == m[:, None], axis=1)  # first occurrence
            mins[:, k] = m
            pos[:, k] = j
            xm[rows, j] = (xm[rows, j] + BIG).astype(np.float32)
        flips = np.zeros((L, t), np.float32)
        for k in range(t):
            ub, (beta, mins, pos, flips) = fork_sel(
                np.zeros(L, np.float32), mins[:, k].copy(),
                extras=(beta, mins, pos, flips))
            flips = flips.copy()
            flips[:, k] = ub
        x = beta.copy()
        for k in range(t):
            x[rows, pos[:, k]] = np.abs(x[rows, pos[:, k]] - flips[:, k])
        return x.astype(np.float32), True

    def process(stage, off):
        w = 1 << stage
        blk = fr[off : off + w]
        if blk.all():  # R0
            leaves = descend(get_llr(stage).copy(), stage)
            for j in range(w):
                p0, _ = pen_pair(leaves[:, j])
                S["PM"] = (S["PM"] + p0).astype(np.float32)
            return None, False
        if w >= 2 and blk[:-1].all() and not blk[-1]:  # REP
            leaves = descend(get_llr(stage).copy(), stage)
            for j in range(w - 1):
                p0, _ = pen_pair(leaves[:, j])
                S["PM"] = (S["PM"] + p0).astype(np.float32)
            p0, p1 = pen_pair(leaves[:, w - 1])
            ub, _ = fork_sel(p0, p1)
            return np.broadcast_to(ub[:, None],
                                   (L, w)).astype(np.float32).copy(), True
        if r1min and w >= max(r1min, 2) and not blk.any():
            return r1_node(stage)
        if w <= wloop:
            return loop_node(stage, off)
        # branch
        h = w // 2
        src = get_llr(stage)
        S["llr"][stage - 1] = chk(src[:, :h], src[:, h:])
        v_l, fk_l = process(stage - 1, off)
        if v_l is not None:
            S["bits"][stage - 1] = v_l.copy()
        src = get_llr(stage)
        if v_l is None:
            S["llr"][stage - 1] = (src[:, h:] + src[:, :h]).astype(np.float32)
        else:
            S["llr"][stage - 1] = (
                src[:, h:]
                + (np.float32(1) - np.float32(2) * v_l) * src[:, :h]
            ).astype(np.float32)
        v_r, fk_r = process(stage - 1, off + h)
        if v_l is None and v_r is None:
            return None, False
        left_x = (np.zeros((L, h), np.float32) if v_l is None
                  else S["bits"][stage - 1])
        if v_r is None:
            v_r = np.zeros((L, h), np.float32)
        return np.concatenate([np.abs(left_x - v_r), v_r],
                              axis=1).astype(np.float32), fk_l or fk_r

    vs, _ = process(n, 0)
    if vs is None:
        u_all = np.zeros((L, N), np.int8)
    else:
        x = vs
        for i in range(n):
            d = 1 << i
            v = x.reshape(L, N // (2 * d), 2, d)
            up = np.abs(v[:, :, 0] - v[:, :, 1]).astype(np.float32)
            x = np.stack([up, v[:, :, 1]], axis=2).reshape(L, N)
        u_all = (x > 0.5).astype(np.int8)
    return u_all, S["PM"], S["ties"]


def decode_batch(llr, frozen, L, wloop=2, r1min=0):
    """[B, N] -> (u_all [B, L, N] i8, PM [B, L] f32, ties [B] i32)."""
    outs = [decode_frame(row, frozen, L, wloop=wloop, r1min=r1min)
            for row in np.asarray(llr)]
    return (np.stack([o[0] for o in outs]),
            np.stack([o[1] for o in outs]),
            np.asarray([o[2] for o in outs], np.int32))
