"""Scalar/NumPy reference implementation of the banded dual-affine-gap DP
("extd2" semantics, after src/kswlib/ksw2_extd2_sse.c).

This is the behavioral oracle for the device DP in extd2_jax.py:
readable, bit-compatible with the reference SSE kernel (fuzz-verified
against a .so compiled from the reference source in
tests/golden/test_ksw2_golden.py), and deliberately structured like the
anti-diagonal wavefront the device DP uses.

Mechanics mirrored exactly (they are observable in scores/CIGARs):
  - anti-diagonal iteration r = i+j with moving band
    st0 = max(0, r-qlen+1, ceil((r-w)/2)), en0 = min(tlen-1, r, floor((r+w)/2));
  - 16-aligned padded column ranges whose out-of-band cells keep evolving
    and can feed band-edge boundary reads (ksw2_extd2_sse.c:141-151);
  - dual gap channels with leading-gap cost min(q+e*k, q2+e2*k) encoded via
    the long_thres/long_diff boundary schedule (:95-98, :150-156);
  - per-cell clamp z = min(z, match_score) (:209);
  - tie-break order diag > E > F > E2 > F2 with strict-greater replacement
    (gap left-alignment, flag KSW_EZ_RIGHT absent, :228-243);
  - direction/continuation bits and ksw_backtrack_D state machine
    (ksw2.h:119-154), zdrop via ksw_apply_zdrop (ksw2.h:245-262).

Scoring convention: mat[0] = match score (>0), mat[1] = mismatch score
(<0); gap costs q,e,q2,e2 positive; a k-long gap costs
min(q + k*e, q2 + k*e2).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NEG_INF = -0x40000000

CIGAR_OPS = "MIDN"


@dataclass
class Ez:
    """Result record mirroring ksw_extz_t (ksw2.h:70-80)."""
    score: int = NEG_INF     # H[qlen-1, tlen-1] if reached
    mqe: int = NEG_INF       # max end-of-query score
    mqe_t: int = -1
    mte: int = NEG_INF       # max end-of-target score
    mte_q: int = -1
    max: int = 0             # global max
    max_q: int = -1
    max_t: int = -1
    zdropped: bool = False
    cigar: list = field(default_factory=list)  # [(op_char, length)]

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for op, n in self.cigar)


def extd2(
    query: np.ndarray,
    target: np.ndarray,
    match: int = 2,
    mismatch: int = -12,
    q: int = 16,
    e: int = 1,
    q2: int = 32,
    e2: int = 0,
    w: int = 200,
    zdrop: int = 400,
    with_cigar: bool = True,
) -> Ez:
    qlen, tlen = len(query), len(target)
    ez = Ez()
    if qlen <= 0 or tlen <= 0:
        return ez
    if q2 + e2 < q + e:
        q, q2 = q2, q
        e, e2 = e2, e
    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_pad = ((tlen + 15) // 16) * 16
    n_col = min(qlen, tlen)
    n_col = ((min(n_col, w + 1) + 15) // 16 + 1) * 16  # bytes per p row

    if -mismatch > 2 * (q + e):
        return ez  # reference refuses this configuration (:93)

    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    # persistent difference-state rows (full padded width, like the C arrays)
    u = np.full(tlen_pad, -q - e, dtype=np.int32)
    v = np.full(tlen_pad, -q - e, dtype=np.int32)
    x = np.full(tlen_pad, -q - e, dtype=np.int32)
    y = np.full(tlen_pad, -q - e, dtype=np.int32)
    x2 = np.full(tlen_pad, -q2 - e2, dtype=np.int32)
    y2 = np.full(tlen_pad, -q2 - e2, dtype=np.int32)
    s = np.zeros(tlen_pad, dtype=np.int32)
    H = np.full(tlen_pad, NEG_INF, dtype=np.int64)

    qr = query[::-1]
    p_rows = {} if with_cigar else None
    off = np.zeros(qlen + tlen - 1, dtype=np.int64)
    off_end = np.zeros(qlen + tlen - 1, dtype=np.int64)

    last_st = last_en = -1
    for r in range(qlen + tlen - 1):
        st0 = max(0, r - qlen + 1, (r - wr + 1) >> 1)
        en0 = min(tlen - 1, r, (r + wl) >> 1)
        if st0 > en0:
            ez.zdropped = True
            break
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        en = min(en, tlen_pad - 1)
        off[r] = st
        off_end[r] = en

        # boundary conditions (ksw2_extd2_sse.c:142-157)
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21, v1 = -q - e, -q2 - e2, -q - e
        else:
            x1, x21 = -q - e, -q2 - e2
            v1 = (
                -q - e if r == 0
                else (-e if r < long_thres else (long_diff if r == long_thres else -e2))
            )
        if en >= r:
            y[r] = -q - e
            y2[r] = -q2 - e2
            u[r] = (
                -q - e if r == 0
                else (-e if r < long_thres else (long_diff if r == long_thres else -e2))
            )

        # scores for the real cells of this diagonal
        t_real = np.arange(st0, en0 + 1)
        qi = qr[(qlen - 1 - r) + t_real]  # query[r - t]
        ti = target[t_real]
        s[t_real] = np.where(qi == ti, match, mismatch)

        # core recurrence over padded [st, en] (vectorized with shifts)
        tt = np.arange(st, en + 1)
        x_prev = np.empty(len(tt), dtype=np.int32)
        x_prev[0] = x1
        x_prev[1:] = x[st : en]
        v_prev = np.empty(len(tt), dtype=np.int32)
        v_prev[0] = v1
        v_prev[1:] = v[st : en]
        x2_prev = np.empty(len(tt), dtype=np.int32)
        x2_prev[0] = x21
        x2_prev[1:] = x2[st : en]

        a = x_prev + v_prev
        b = y[st : en + 1] + u[st : en + 1]
        a2 = x2_prev + v_prev
        b2 = y2[st : en + 1] + u[st : en + 1]
        z = s[st : en + 1].copy()

        d = np.zeros(len(tt), dtype=np.uint8)
        m1 = a > z
        d[m1] = 1
        z = np.maximum(z, a)
        m2 = b > z
        d[m2] = 2
        z = np.maximum(z, b)
        m3 = a2 > z
        d[m3] = 3
        z = np.maximum(z, a2)
        m4 = b2 > z
        d[m4] = 4
        z = np.maximum(z, b2)
        z = np.minimum(z, match)

        u_new = z - v_prev
        v_new = z - u[st : en + 1]
        a = a - (z - q)
        b = b - (z - q)
        a2 = a2 - (z - q2)
        b2 = b2 - (z - q2)

        x_new = np.maximum(a, 0) - q - e
        d |= np.uint8(0x08) * (a > 0)
        y_new = np.maximum(b, 0) - q - e
        d |= np.uint8(0x10) * (b > 0)
        x2_new = np.maximum(a2, 0) - q2 - e2
        d |= np.uint8(0x20) * (a2 > 0)
        y2_new = np.maximum(b2, 0) - q2 - e2
        d |= np.uint8(0x40) * (b2 > 0)

        u[st : en + 1] = u_new
        v[st : en + 1] = v_new
        x[st : en + 1] = x_new
        y[st : en + 1] = y_new
        x2[st : en + 1] = x2_new
        y2[st : en + 1] = y2_new
        if with_cigar:
            p_rows[r] = d  # covers padded [st, en]

        # H update + max (ksw2_extd2_sse.c:320-351)
        if r > 0:
            H_en0 = H[en0 - 1] + u_new[en0 - st] if en0 > 0 else H[en0] + v_new[en0 - st]
            if en0 > st0:
                H[st0:en0] += v_new[st0 - st : en0 - st]
            H[en0] = H_en0
            seg = H[st0 : en0 + 1]
            max_t = st0 + int(np.argmax(seg))
            max_H = int(H[max_t])
            # C scans give the LAST argmax among equal values for the tail
            # loop but blends SSE lanes first; emulate exact C tie behavior:
            max_t, max_H = _c_max(H, st0, en0)
        else:
            H[0] = v_new[0] - (q + e)
            max_H, max_t = int(H[0]), 0

        if en0 == tlen - 1 and H[en0] > ez.mte:
            ez.mte, ez.mte_q = int(H[en0]), r - en
        if r - st0 == qlen - 1 and H[st0] > ez.mqe:
            ez.mqe, ez.mqe_t = int(H[st0]), st0
        if _apply_zdrop(ez, max_H, r, max_t, zdrop, e2):
            break
        if r == qlen + tlen - 2 and en0 == tlen - 1:
            ez.score = int(H[tlen - 1])
        last_st, last_en = st, en

    if with_cigar:
        if not ez.zdropped:
            _backtrack(ez, p_rows, off, off_end, tlen - 1, qlen - 1)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            _backtrack(ez, p_rows, off, off_end, ez.max_t, ez.max_q)
    return ez


def _c_max(H, st0, en0):
    """Replicate the C max scan: H[en0] is taken as the initial candidate,
    then t in [st0, en0) replace on strictly greater (SSE blocks of 4 then
    scalar tail — order only matters for ties on max_t; the SSE pass
    compares blockwise but resolves in index order, so first-strictly-
    greatest wins with en0 seeded)."""
    max_t = en0
    max_H = int(H[en0])
    for t in range(st0, en0):
        if int(H[t]) > max_H:
            max_H = int(H[t])
            max_t = t
    return max_t, max_H


def _apply_zdrop(ez: Ez, H: int, r: int, t: int, zdrop: int, e: int) -> bool:
    """ksw_apply_zdrop (ksw2.h:245-262), is_rot=1."""
    if H > ez.max:
        ez.max, ez.max_t, ez.max_q = H, t, r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl = t - ez.max_t
        ql = (r - t) - ez.max_q
        l = abs(tl - ql)
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = True
            return True
    return False


def _backtrack(ez: Ez, p_rows, off, off_end, i0: int, j0: int):
    """ksw_backtrack_D (ksw2.h:119-154) with is_rot=1: i = target index,
    j = query index; op 'D' consumes target, 'I' consumes query."""
    ops: list[tuple[str, int]] = []

    def push(op: str, n: int):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + n)
        else:
            ops.append((op, n))

    i, j = i0, j0
    state = 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < off[r]:
            force_state = 2
        if i > off_end[r]:
            force_state = 1
        tmp = int(p_rows[r][i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            push("M", 1)
            i -= 1
            j -= 1
        elif state in (1, 3):
            push("D", 1)
            i -= 1
        else:
            push("I", 1)
            j -= 1
    if i >= 0:
        push("D", i + 1)
    if j >= 0:
        push("I", j + 1)
    ez.cigar = ops[::-1]
