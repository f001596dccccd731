"""Batched banded dual-affine-gap DP (extd2 semantics) in JAX.

Device wavefront implementation of the kernel specified by
ops/ksw2_ref.py (itself fuzz-verified bit-exact against the reference
SSE kernel). One `lax.scan` step = one anti-diagonal; problems are
vmapped across the batch, so each scan step is an elementwise pass over a
(B, T_max) tile. Direction bits are emitted per diagonal; the traceback
(traceback_batch) is a second scan, one step per CIGAR op, over all
problems at once.

Semantics notes (kept identical to the oracle / reference):
  - per-problem moving band with the reference's 16-aligned padded update
    ranges, so stale out-of-band state leaks identically at band edges;
  - dual gap channels with long_thres/long_diff leading-gap schedule;
  - z-drop freezes a problem's state mid-sweep (no early exit on device:
    lanes are masked instead);
  - direction bits and tie-break order exactly as gap-left-aligned extd2.

All scoring parameters are static (compiled in); qlen/tlen are dynamic
per problem up to the padded (Q_max, T_max) of the compiled size class.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -0x40000000

# lax.scan unroll factors of the forward sweep and of the traceback walk
FWD_UNROLL = 1
TB_UNROLL = 1


class Extd2Params(NamedTuple):
    match: int = 2
    mismatch: int = -12
    q: int = 16
    e: int = 1
    q2: int = 32
    e2: int = 0
    w: int = 200
    zdrop: int = 400

    def normalized(self) -> "Extd2Params":
        if self.q2 + self.e2 < self.q + self.e:
            return self._replace(q=self.q2, e=self.e2, q2=self.q, e2=self.e)
        return self

    @property
    def long_thres(self) -> int:
        p = self.normalized()
        lt = (p.q2 - p.q) // (p.e - p.e2) - 1 if p.e != p.e2 else 0
        if p.q2 + p.e2 + lt * p.e2 > p.q + p.e + lt * p.e:
            lt += 1
        return lt

    @property
    def long_diff(self) -> int:
        p = self.normalized()
        return self.long_thres * (p.e - p.e2) - (p.q2 - p.q) - p.e2


class Extd2Result(NamedTuple):
    score: jnp.ndarray     # (B,) int32, NEG_INF when ends not reached
    mqe: jnp.ndarray       # (B,)
    mqe_t: jnp.ndarray     # (B,)
    mte: jnp.ndarray       # (B,)
    mte_q: jnp.ndarray     # (B,)
    max: jnp.ndarray       # (B,)
    max_q: jnp.ndarray     # (B,)
    max_t: jnp.ndarray     # (B,)
    zdropped: jnp.ndarray  # (B,) bool
    dmat: jnp.ndarray      # (B, n_diag, T_max) uint8 direction bits
    st_arr: jnp.ndarray    # (B, n_diag) int32 padded band start per diagonal
    en_arr: jnp.ndarray    # (B, n_diag) int32 padded band end per diagonal


def _leading_gap_delta(r, p: Extd2Params):
    """u/v boundary schedule encoding H(0-row) leading-gap costs."""
    pn = p.normalized()
    return jnp.where(
        r == 0, -pn.q - pn.e,
        jnp.where(
            r < p.long_thres, -pn.e,
            jnp.where(r == p.long_thres, p.long_diff, -pn.e2),
        ),
    ).astype(jnp.int32)


def _extd2_single(q_codes, qlen, t_codes, tlen, p: Extd2Params, n_diag: int,
                  with_dmat: bool):
    pn = p.normalized()
    q_, e_, q2_, e2_ = pn.q, pn.e, pn.q2, pn.e2
    T = t_codes.shape[0]
    idx = jnp.arange(T, dtype=jnp.int32)
    tlen_pad = ((tlen + 15) // 16) * 16

    init = dict(
        u=jnp.full((T,), -q_ - e_, jnp.int32),
        v=jnp.full((T,), -q_ - e_, jnp.int32),
        x=jnp.full((T,), -q_ - e_, jnp.int32),
        y=jnp.full((T,), -q_ - e_, jnp.int32),
        x2=jnp.full((T,), -q2_ - e2_, jnp.int32),
        y2=jnp.full((T,), -q2_ - e2_, jnp.int32),
        s=jnp.zeros((T,), jnp.int32),
        H=jnp.full((T,), NEG_INF, jnp.int32),
        last_st=jnp.int32(-1),
        last_en=jnp.int32(-1),
        ez_max=jnp.int32(0),
        ez_max_q=jnp.int32(-1),
        ez_max_t=jnp.int32(-1),
        mqe=jnp.int32(NEG_INF),
        mqe_t=jnp.int32(-1),
        mte=jnp.int32(NEG_INF),
        mte_q=jnp.int32(-1),
        score=jnp.int32(NEG_INF),
        zdropped=jnp.bool_(False),
    )

    def step(c, r):
        r = r.astype(jnp.int32)
        st0 = jnp.maximum(jnp.maximum(0, r - qlen + 1),
                          jax.lax.shift_right_arithmetic(r - p.w + 1, 1))
        en0 = jnp.minimum(jnp.minimum(tlen - 1, r),
                          jax.lax.shift_right_arithmetic(r + p.w, 1))
        in_range = r < qlen + tlen - 1
        band_dead = st0 > en0
        active = in_range & ~c["zdropped"] & ~band_dead
        new_zdrop_from_band = in_range & ~c["zdropped"] & band_dead

        st = st0 // 16 * 16
        en = jnp.minimum((en0 + 16) // 16 * 16 - 1, tlen_pad - 1)

        real = (idx >= st0) & (idx <= en0)
        band = (idx >= st) & (idx <= en)

        # scores for real cells (persist elsewhere)
        qgather = q_codes[jnp.clip(r - idx, 0, q_codes.shape[0] - 1)]
        s_new = jnp.where(real & active,
                          jnp.where(qgather == t_codes, p.match, p.mismatch),
                          c["s"])

        # boundary writes at t == r (i == 0 row) before use
        top = (en >= r) & active
        u_bound = _leading_gap_delta(r, p)
        u_arr = jnp.where(top & (idx == r), u_bound, c["u"])
        y_arr = jnp.where(top & (idx == r), -q_ - e_, c["y"])
        y2_arr = jnp.where(top & (idx == r), -q2_ - e2_, c["y2"])

        # band-left boundary scalars
        stale_ok = (st - 1 >= c["last_st"]) & (st - 1 <= c["last_en"])
        stm1 = jnp.clip(st - 1, 0, T - 1)
        x1 = jnp.where(st > 0,
                       jnp.where(stale_ok, c["x"][stm1], -q_ - e_),
                       -q_ - e_)
        x21 = jnp.where(st > 0,
                        jnp.where(stale_ok, c["x2"][stm1], -q2_ - e2_),
                        -q2_ - e2_)
        v1 = jnp.where(st > 0,
                       jnp.where(stale_ok, c["v"][stm1], -q_ - e_),
                       _leading_gap_delta(r, p))

        # shifted previous-diagonal values (t-1), boundary injected at t==st
        def shift1(arr, bval):
            rolled = jnp.roll(arr, 1)
            return jnp.where(idx == st, bval, rolled)

        x_sh = shift1(c["x"], x1)
        v_sh = shift1(c["v"], v1)
        x2_sh = shift1(c["x2"], x21)

        a = x_sh + v_sh
        b = y_arr + u_arr
        a2 = x2_sh + v_sh
        b2 = y2_arr + u_arr
        z = s_new

        d = jnp.zeros((T,), jnp.int32)
        m = a > z
        d = jnp.where(m, 1, d)
        z = jnp.maximum(z, a)
        m = b > z
        d = jnp.where(m, 2, d)
        z = jnp.maximum(z, b)
        m = a2 > z
        d = jnp.where(m, 3, d)
        z = jnp.maximum(z, a2)
        m = b2 > z
        d = jnp.where(m, 4, d)
        z = jnp.maximum(z, b2)
        z = jnp.minimum(z, p.match)

        u_new = z - v_sh
        v_new = z - u_arr
        a = a - (z - q_)
        b = b - (z - q_)
        a2 = a2 - (z - q2_)
        b2 = b2 - (z - q2_)

        x_new = jnp.maximum(a, 0) - q_ - e_
        d = d | jnp.where(a > 0, 0x08, 0)
        y_new = jnp.maximum(b, 0) - q_ - e_
        d = d | jnp.where(b > 0, 0x10, 0)
        x2_new = jnp.maximum(a2, 0) - q2_ - e2_
        d = d | jnp.where(a2 > 0, 0x20, 0)
        y2_new = jnp.maximum(b2, 0) - q2_ - e2_
        d = d | jnp.where(b2 > 0, 0x40, 0)

        wmask = band & active
        u_out = jnp.where(wmask, u_new, u_arr)
        v_out = jnp.where(wmask, v_new, c["v"])
        x_out = jnp.where(wmask, x_new, c["x"])
        y_out = jnp.where(wmask, y_new, y_arr)
        x2_out = jnp.where(wmask, x2_new, c["x2"])
        y2_out = jnp.where(wmask, y2_new, y2_arr)

        # H update (order matters: H[en0] uses old H[en0-1])
        en0c = jnp.clip(en0, 0, T - 1)
        H_en0 = jnp.where(
            en0 > 0,
            c["H"][jnp.clip(en0 - 1, 0, T - 1)] + u_new[en0c],
            c["H"][en0c] + v_new[en0c],
        )
        H_mid = jnp.where(real & (idx < en0) & active, c["H"] + v_new, c["H"])
        H_r0 = v_new[0] - (q_ + e_)
        H_new = jnp.where(
            active & (idx == en0),
            jnp.where(r == 0, H_r0, H_en0),
            jnp.where(r == 0, c["H"], H_mid),
        )
        # (for r==0 only cell 0 == en0 is set)

        # diagonal max with C scan tie semantics: seed H[en0], then first
        # strictly-greater in [st0, en0)
        Hmask = jnp.where(real, H_new, NEG_INF)
        seg_max = jnp.max(Hmask)
        first_t = jnp.argmax(Hmask == seg_max).astype(jnp.int32)
        max_t = jnp.where(H_new[en0c] == seg_max, en0, first_t)
        max_H = seg_max

        # ez updates
        mte_hit = active & (en0 == tlen - 1) & (H_new[en0c] > c["mte"])
        mte = jnp.where(mte_hit, H_new[en0c], c["mte"])
        mte_q = jnp.where(mte_hit, r - en, c["mte_q"])
        st0c = jnp.clip(st0, 0, T - 1)
        mqe_hit = active & (r - st0 == qlen - 1) & (H_new[st0c] > c["mqe"])
        mqe = jnp.where(mqe_hit, H_new[st0c], c["mqe"])
        mqe_t = jnp.where(mqe_hit, st0, c["mqe_t"])

        # zdrop (ksw_apply_zdrop)
        better = max_H > c["ez_max"]
        ez_max = jnp.where(active & better, max_H, c["ez_max"])
        ez_max_t = jnp.where(active & better, max_t, c["ez_max_t"])
        ez_max_q = jnp.where(active & better, r - max_t, c["ez_max_q"])
        tl = max_t - c["ez_max_t"]
        ql = (r - max_t) - c["ez_max_q"]
        l = jnp.abs(tl - ql)
        drop_check = active & ~better & (max_t >= c["ez_max_t"]) & (r - max_t >= c["ez_max_q"])
        dropped_now = drop_check & (p.zdrop >= 0) & (c["ez_max"] - max_H > p.zdrop + l * e2_)
        zdropped = c["zdropped"] | dropped_now | new_zdrop_from_band

        score_hit = active & ~dropped_now & (r == qlen + tlen - 2) & (en0 == tlen - 1)
        score = jnp.where(score_hit, H_new[tlen - 1], c["score"])

        nc = dict(
            u=u_out, v=v_out, x=x_out, y=y_out, x2=x2_out, y2=y2_out,
            s=s_new, H=H_new,
            last_st=jnp.where(active, st, c["last_st"]),
            last_en=jnp.where(active, en, c["last_en"]),
            ez_max=ez_max, ez_max_q=ez_max_q, ez_max_t=ez_max_t,
            mqe=mqe, mqe_t=mqe_t, mte=mte, mte_q=mte_q,
            score=score, zdropped=zdropped,
        )
        if with_dmat:
            d_out = jnp.where(wmask, d, 0).astype(jnp.uint8)
            ys = (d_out, jnp.where(active, st, -1), jnp.where(active, en, -1))
        else:
            ys = (jnp.where(active, st, -1), jnp.where(active, en, -1))
        return nc, ys

    carry, ys = jax.lax.scan(step, init, jnp.arange(n_diag, dtype=jnp.int32),
                             unroll=FWD_UNROLL)
    if with_dmat:
        dmat, st_arr, en_arr = ys
    else:
        st_arr, en_arr = ys
        dmat = jnp.zeros((n_diag, 0), jnp.uint8)
    return carry, dmat, st_arr, en_arr


@functools.partial(
    jax.jit, static_argnames=("params", "n_diag", "with_dmat")
)
def extd2_batch(q_codes, qlens, t_codes, tlens,
                params: Extd2Params = Extd2Params(),
                n_diag: int | None = None,
                with_dmat: bool = True) -> Extd2Result:
    """Batched extd2. q_codes (B, Qmax) int32 0..3, t_codes (B, Tmax).

    Lengths beyond qlens/tlens are ignored. n_diag defaults to
    Qmax + Tmax - 1 (full sweep for the size class).
    """
    if n_diag is None:
        n_diag = q_codes.shape[1] + t_codes.shape[1] - 1
    single = functools.partial(
        _extd2_single, p=params, n_diag=n_diag, with_dmat=with_dmat
    )
    carry, dmat, st_arr, en_arr = jax.vmap(single)(
        q_codes, qlens, t_codes, tlens
    )
    return Extd2Result(
        score=carry["score"], mqe=carry["mqe"], mqe_t=carry["mqe_t"],
        mte=carry["mte"], mte_q=carry["mte_q"],
        max=carry["ez_max"], max_q=carry["ez_max_q"], max_t=carry["ez_max_t"],
        zdropped=carry["zdropped"],
        dmat=dmat, st_arr=st_arr, en_arr=en_arr,
    )


@functools.partial(jax.jit, static_argnames=("K",))
def traceback_batch(dmat, st_arr, en_arr, i0, j0, K: int):
    """Device traceback: batched ksw_backtrack_D over full-width direction
    matrices. dmat (B, n_diag, T) uint8; st/en (B, n_diag); i0/j0 (B,)
    start cell (target, query). Returns ops (B, K) int8 in backward order
    (0=M, 1=I, 2=D, 3=none) plus the final (i, j) per problem for the
    caller's leading-gap tail. i0 < 0 marks an empty problem."""
    B, n_diag, T = dmat.shape
    dflat = dmat.reshape(B, n_diag * T)
    bidx = jnp.arange(B)

    def step(carry, _):
        i, j, state, alive = carry
        r = i + j
        rc = jnp.clip(r, 0, n_diag - 1)
        ic = jnp.clip(i, 0, T - 1)
        st_r = st_arr[bidx, rc]
        en_r = en_arr[bidx, rc]
        force = jnp.where(i < st_r, 2, jnp.where(i > en_r, 1, -1))
        tmp = jnp.where(
            force < 0, dflat[bidx, rc * T + ic].astype(jnp.int32), 0
        )
        st1 = jnp.where(state == 0, tmp & 7, state)
        cont = (tmp >> (st1 + 2)) & 1
        st2 = jnp.where((state != 0) & (cont == 0), 0, st1)
        st3 = jnp.where(st2 == 0, tmp & 7, st2)
        st4 = jnp.where(force >= 0, force, st3)
        op = jnp.where(st4 == 0, 0, jnp.where((st4 == 1) | (st4 == 3), 2, 1))
        i_n = jnp.where(op != 1, i - 1, i)
        j_n = jnp.where(op != 2, j - 1, j)
        emitted = jnp.where(alive, op, 3).astype(jnp.int8)
        alive_n = alive & (i_n >= 0) & (j_n >= 0)
        return (jnp.where(alive, i_n, i), jnp.where(alive, j_n, j),
                jnp.where(alive, st4, state), alive_n), emitted

    alive0 = (i0 >= 0) & (j0 >= 0)
    (i_f, j_f, _, _), ops = jax.lax.scan(
        step, (i0, j0, jnp.zeros_like(i0), alive0), None, length=K,
        unroll=TB_UNROLL,
    )
    return jnp.transpose(ops), i_f, j_f


def ops_to_cigar(ops_row: np.ndarray, i_fin: int, j_fin: int) -> list:
    """Backward op codes -> forward run-length CIGAR, appending the
    leading deletion/insertion exactly like ksw_backtrack_D's tail."""
    out: list[tuple[str, int]] = []
    names = "MID"
    for code in ops_row:
        if code == 3:
            break
        op = names[code]
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + 1)
        else:
            out.append((op, 1))
    if i_fin >= 0:
        if out and out[-1][0] == "D":
            out[-1] = ("D", out[-1][1] + i_fin + 1)
        else:
            out.append(("D", int(i_fin) + 1))
    if j_fin >= 0:
        if out and out[-1][0] == "I":
            out[-1] = ("I", out[-1][1] + j_fin + 1)
        else:
            out.append(("I", int(j_fin) + 1))
    return out[::-1]


def traceback(dmat, st_arr, en_arr, i0: int, j0: int) -> list:
    """Host traceback over one problem's direction matrix (full-width
    columns; st/en arrays give the valid band). Mirrors ksw_backtrack_D."""
    dmat = np.asarray(dmat)
    st_arr = np.asarray(st_arr)
    en_arr = np.asarray(en_arr)
    ops: list[tuple[str, int]] = []

    def push(op, n):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + n)
        else:
            ops.append((op, n))

    i, j = i0, j0
    state = 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < st_arr[r]:
            force_state = 2
        if i > en_arr[r]:
            force_state = 1
        tmp = int(dmat[r][i]) if force_state < 0 else 0
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
    return ops[::-1]
