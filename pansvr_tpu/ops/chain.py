"""Batched seed chaining (sparse dynamic programming) on device.

Re-implementation of the reference's Graph_handler::process +
dynamic_programming_path (src/cpp_lib/graph.cpp:53-150) as JAX ops:
seeds sorted by (ref_end, ref_begin); edges computed as a dense
(seed, forward-offset) tensor with the reference's exact rules, then a
scan relaxes nodes in sorted order.

Edge rules (graph.cpp:89-118), from predecessor i to successor j = i+o:
  - no edge if seed_id equal or ref_end equal (continue; such j do NOT
    trigger the break below);
  - the j-scan from i BREAKS at the first non-skipped j with
    dis_ref = ref_begin[j] - ref_end[i] > max_ref_dis (50 / 400 STR) —
    reproduced with a cumulative-or along the offset axis;
  - dis_read > max_read_dis (50/400) or |gap| > max_gap (50/20 STR): skip;
  - penalty = 0 if gap == 0 else (|gap| >> 3) + 3;
  - weight = cov[j] - max(1-dis_read, 0)      if dis_read == dis_ref
           = cov[j]                            if both distances > 0
           = cov[j] + min(dis_read, dis_ref)   if -5 <= dis_read <= 0
                                                  and dis_ref >= -5
           = (no edge) otherwise;
  - look-ahead window o in [1, 40) normal, [1, 80) STR (MAX_SEARCH_STEP).

DP (graph.cpp:125-150): nodes without incoming edges keep dist = cov;
nodes with edges get dist = max(0, max_i(dist[i] + w - p)), pre = the
LATEST i attaining the max when >= 0, else -1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

WINDOW = 80  # static look-ahead; offsets >= 40 masked for non-STR reads
NEG = jnp.int32(-0x40000000)

MAX_REF_DIS, MAX_REF_DIS_STR = 50, 400
MAX_READ_DIS, MAX_READ_DIS_STR = 50, 400
MAX_SEARCH_STEP, MAX_SEARCH_STEP_STR = 40, 80
MAX_ABS_GAP, MAX_ABS_GAP_STR = 50, 20


class ChainResult(NamedTuple):
    order: jnp.ndarray      # (B, S) sorted position -> original seed row
    dist: jnp.ndarray       # (B, S) chain score per sorted position
    pre: jnp.ndarray        # (B, S) predecessor sorted position or -1
    n_valid: jnp.ndarray    # (B,)
    read_begin: jnp.ndarray  # attributes in sorted order:
    read_end: jnp.ndarray
    ref_begin: jnp.ndarray
    ref_end: jnp.ndarray
    cov: jnp.ndarray
    valid: jnp.ndarray


def _sort_seeds(read_begin, read_end, ref_begin, ref_end, cov, seed_id, valid):
    """Stable sort by (ref_end, ref_begin); invalid rows to the back.
    Two-pass stable argsort (lexsort) keeps everything int32 (no x64)."""
    ord1 = jnp.argsort(ref_begin, axis=-1, stable=True).astype(jnp.int32)
    fe1 = jnp.take_along_axis(ref_end, ord1, axis=-1)
    val1 = jnp.take_along_axis(valid, ord1, axis=-1)
    key = jnp.where(val1, fe1, jnp.int32(0x7FFFFFFF))
    ord2 = jnp.argsort(key, axis=-1, stable=True).astype(jnp.int32)
    order = jnp.take_along_axis(ord1, ord2, axis=-1)
    g = lambda a: jnp.take_along_axis(a, order, axis=-1)
    return order, g(read_begin), g(read_end), g(ref_begin), g(ref_end), \
        g(cov), g(seed_id), g(valid)


@jax.jit
def chain_batch(read_begin, read_end, ref_begin, ref_end, cov, seed_id,
                valid, is_str) -> ChainResult:
    """All inputs (B, S) int32 except valid (B, S) bool, is_str (B,) bool."""
    B, S = read_begin.shape
    order, rb, re_, fb, fe, cv, sid, val = _sort_seeds(
        read_begin, read_end, ref_begin, ref_end, cov, seed_id, valid
    )
    n_valid = jnp.sum(val, axis=-1).astype(jnp.int32)

    max_ref = jnp.where(is_str, MAX_REF_DIS_STR, MAX_REF_DIS)[:, None, None]
    max_read = jnp.where(is_str, MAX_READ_DIS_STR, MAX_READ_DIS)[:, None, None]
    max_step = jnp.where(is_str, MAX_SEARCH_STEP_STR, MAX_SEARCH_STEP)[:, None, None]
    max_gap = jnp.where(is_str, MAX_ABS_GAP_STR, MAX_ABS_GAP)[:, None, None]

    # look-ahead axis trimmed to the padded seed count: offsets beyond S
    # can never connect anything
    Weff = min(WINDOW, S)
    offs = jnp.arange(1, Weff + 1, dtype=jnp.int32)[None, None, :]  # (1,1,W)

    # gather successor attributes: succ[b, i, o] = attr[b, i+o]
    cols = jnp.arange(S, dtype=jnp.int32)[:, None] + offs[0]          # (S, W)
    in_range = (cols < S)[None]
    colsc = jnp.clip(cols, 0, S - 1)

    def succ(a):
        return a[:, colsc]  # (B, S, W)

    fb_j = succ(fb)
    rb_j = succ(rb)
    fe_j = succ(fe)
    cv_j = succ(cv)
    sid_j = succ(sid)
    val_j = succ(val.astype(jnp.int32)) > 0

    dis_ref = fb_j - fe[:, :, None]
    dis_read = rb_j - re_[:, :, None]
    skip = (sid_j == sid[:, :, None]) | (fe_j == fe[:, :, None])
    # break: first non-skipped offset with dis_ref > max kills itself and
    # all later offsets from this i
    brk_flag = (~skip) & (dis_ref > max_ref) & in_range & val_j
    broke = jax.lax.associative_scan(jnp.logical_or, brk_flag, axis=2)

    gap = jnp.abs(dis_read - dis_ref)
    has_w = (
        (dis_read == dis_ref)
        | ((dis_read > 0) & (dis_ref > 0))
        | ((dis_read >= -5) & (dis_read <= 0) & (dis_ref >= -5))
    )
    cond = (
        val[:, :, None] & val_j & in_range & ~skip & ~broke
        & (offs <= max_step - 1)
        & (dis_read <= max_read)
        & (gap <= max_gap)
        & has_w
    )
    penalty = jnp.where(gap == 0, 0, (gap >> 3) + 3)
    weight = jnp.where(
        dis_read == dis_ref, cv_j - jnp.maximum(1 - dis_read, 0),
        jnp.where((dis_read > 0) & (dis_ref > 0), cv_j,
                  cv_j + jnp.minimum(dis_read, dis_ref)),
    )
    delta = jnp.where(cond, weight - penalty, NEG)  # (B, S=i, W=o)

    # rearrange to incoming-edge view: inc[b, j, o] = delta[b, j-o, o]
    rows = jnp.arange(S, dtype=jnp.int32)[None, :, None] - offs  # (1,S,W)
    rows_ok = rows >= 0
    rowsc = jnp.clip(rows, 0, S - 1)
    inc = jnp.take_along_axis(delta, rowsc, axis=1)
    inc = jnp.where(rows_ok, inc, NEG)
    inc_cond = jnp.take_along_axis(cond, rowsc, axis=1) & rows_ok

    # sequential relaxation in sorted order, statically unrolled with a
    # rolling (B, Weff) window of recent dist columns: win[:, o-1] holds
    # dist[j-o] (S is bucketed small by callers)
    tie = (WINDOW - offs[0])                                  # (Weff,)
    win = jnp.zeros((B, Weff), jnp.int32)
    dist_cols: list = []
    pre_cols: list = []
    for j in range(S):
        inc_j = inc[:, j, :]
        cond_j = inc_cond[:, j, :]
        value = win + inc_j
        # later predecessor (smaller o) wins ties; int32 lex key
        # (|dist| bounded by total coverage << 2^22, so *256 is safe)
        vclamp = jnp.clip(value, -(1 << 21), 1 << 21)
        lex = jnp.where(cond_j, vclamp * (1 << 8) + tie,
                        jnp.int32(-0x7F000000))
        bo = jnp.argmax(lex, axis=-1)
        best_value = jnp.take_along_axis(value, bo[:, None], axis=-1)[:, 0]
        any_edge = jnp.any(cond_j, axis=-1)
        dist_j = jnp.where(any_edge, jnp.maximum(best_value, 0),
                           cv[:, j] * val[:, j])
        pre_j = jnp.where(any_edge & (best_value >= 0),
                          j - (bo.astype(jnp.int32) + 1), -1)
        dist_cols.append(dist_j)
        pre_cols.append(pre_j)
        win = jnp.concatenate([dist_j[:, None], win[:, : Weff - 1]], axis=1)

    dist = jnp.stack(dist_cols, axis=1)
    pre = jnp.stack(pre_cols, axis=1)
    return ChainResult(
        order=order, dist=dist, pre=pre, n_valid=n_valid,
        read_begin=rb, read_end=re_, ref_begin=fb, ref_end=fe, cov=cv,
        valid=val,
    )


# -------------------------------------------------------------------------
# host (NumPy) variant: for small bucketed S the batched relaxation is
# faster on host than the device round trip; semantics identical to
# chain_batch (validated against ops/chain_ref.py through the same tests)
# -------------------------------------------------------------------------

def chain_batch_np(read_begin, read_end, ref_begin, ref_end, cov, seed_id,
                   valid, is_str):
    import numpy as np

    B, S = read_begin.shape
    rb0, re0, fb0, fe0 = read_begin, read_end, ref_begin, ref_end
    # stable lexsort by (ref_end, ref_begin), invalid last
    key_fe = np.where(valid, ref_end, np.int64(1) << 40).astype(np.int64)
    order = np.lexsort(
        (np.broadcast_to(np.arange(S), (B, S)),
         np.where(valid, ref_begin, 0).astype(np.int64), key_fe)
    ).astype(np.int32)
    g = lambda a: np.take_along_axis(a, order, axis=1)
    rb, re_, fb, fe = g(rb0), g(re0), g(fb0), g(fe0)
    cv, sid, val = g(cov), g(seed_id), g(valid)
    n_valid = val.sum(axis=1).astype(np.int32)

    Weff = min(WINDOW, S)
    offs = np.arange(1, Weff + 1, dtype=np.int32)[None, None, :]
    is_str = np.asarray(is_str)
    max_ref = np.where(is_str, MAX_REF_DIS_STR, MAX_REF_DIS)[:, None, None]
    max_read = np.where(is_str, MAX_READ_DIS_STR, MAX_READ_DIS)[:, None, None]
    max_step = np.where(is_str, MAX_SEARCH_STEP_STR, MAX_SEARCH_STEP)[:, None, None]
    max_gap = np.where(is_str, MAX_ABS_GAP_STR, MAX_ABS_GAP)[:, None, None]

    cols = np.arange(S, dtype=np.int32)[:, None] + offs[0]
    in_range = (cols < S)[None]
    colsc = np.clip(cols, 0, S - 1)
    succ = lambda a: a[:, colsc]

    fb_j, rb_j, fe_j = succ(fb), succ(rb), succ(fe)
    cv_j, sid_j = succ(cv), succ(sid)
    val_j = succ(val)

    dis_ref = fb_j - fe[:, :, None]
    dis_read = rb_j - re_[:, :, None]
    skip = (sid_j == sid[:, :, None]) | (fe_j == fe[:, :, None])
    brk_flag = (~skip) & (dis_ref > max_ref) & in_range & val_j
    broke = np.cumsum(brk_flag, axis=2) > 0

    gap = np.abs(dis_read - dis_ref)
    has_w = (
        (dis_read == dis_ref)
        | ((dis_read > 0) & (dis_ref > 0))
        | ((dis_read >= -5) & (dis_read <= 0) & (dis_ref >= -5))
    )
    cond = (
        val[:, :, None] & val_j & in_range & ~skip & ~broke
        & (offs <= max_step - 1)
        & (dis_read <= max_read)
        & (gap <= max_gap)
        & has_w
    )
    penalty = np.where(gap == 0, 0, (gap >> 3) + 3)
    weight = np.where(
        dis_read == dis_ref, cv_j - np.maximum(1 - dis_read, 0),
        np.where((dis_read > 0) & (dis_ref > 0), cv_j,
                 cv_j + np.minimum(dis_read, dis_ref)),
    )
    NEGI = np.int32(-0x40000000)
    delta = np.where(cond, weight - penalty, NEGI)

    rows = np.arange(S, dtype=np.int32)[:, None] - offs[0]
    rows_ok = rows >= 0
    rowsc = np.clip(rows, 0, S - 1)
    rowsc_b = np.broadcast_to(rowsc[None], (B, S, Weff))
    inc = np.take_along_axis(delta, rowsc_b, axis=1)
    inc = np.where(rows_ok[None], inc, NEGI)
    inc_cond = np.take_along_axis(cond, rowsc_b, axis=1) & rows_ok[None]

    dist = np.zeros((B, S), np.int32)
    pre = np.full((B, S), -1, np.int32)
    tie = (WINDOW - offs.ravel()).astype(np.int64)
    rowsel = np.arange(B)
    for j in range(S):
        n_win = min(j, Weff)
        if n_win == 0:
            dist[:, 0] = cv[:, 0] * val[:, 0]
            continue
        win = dist[:, j - n_win : j][:, ::-1]        # index o-1 -> dist[j-o]
        inc_j = inc[:, j, :n_win]
        cond_j = inc_cond[:, j, :n_win]
        value = win + inc_j
        lex = np.where(cond_j,
                       value.astype(np.int64) * 256 + tie[None, :n_win],
                       np.int64(-1) << 60)
        bo = np.argmax(lex, axis=1)
        best_value = value[rowsel, bo]
        any_edge = cond_j.any(axis=1)
        dist[:, j] = np.where(any_edge, np.maximum(best_value, 0),
                              cv[:, j] * val[:, j])
        pre[:, j] = np.where(any_edge & (best_value >= 0), j - (bo + 1), -1)

    return ChainResult(
        order=order, dist=dist, pre=pre, n_valid=n_valid,
        read_begin=rb, read_end=re_, ref_begin=fb, ref_end=fe, cov=cv,
        valid=val,
    )


# -------------------------------------------------------------------------
# device chain extraction (sort_output, read_realignment.cpp:213-293)
# -------------------------------------------------------------------------
#
# Scalar spec: ops/chain_ref.extract_chain. Up to MAX_OUTPUT=6 chains per
# row: repeatedly take the unused node with max dist (ties -> largest
# sorted index, the C scan order with rand() removed), walk its pre[]
# path marking nodes used, apply the STR region suppression, and retry
# (without emitting) when >= half the path was already used.
#
# Vectorized trick: with K <= 32 the ancestor set of every node fits an
# int32 bitmask, computed once by pointer doubling; each extraction
# attempt is then O(1) vector work (popcounts over path & used masks)
# instead of a sequential walk — the whole extraction is ~K small steps.

MAX_OUTPUT = 6


@jax.jit
def chain_extract_batch(dist, pre, valid):
    """dist/pre (B, K) int32 (pre -1 = chain head), valid (B, K) bool.
    Returns (hit_idx, hit_score, hit_final): (B, 6) int32, idx -1 = none.
    K must be <= 32 (callers bucket K; larger falls back to host)."""
    B, K = dist.shape
    assert K <= 32
    lanes = jnp.arange(K, dtype=jnp.int32)[None, :]

    # ancestor bitmasks by pointer doubling
    pre_c = jnp.where(pre >= 0, pre, lanes)           # self-loop at heads
    bit = (jnp.uint32(1) << lanes.astype(jnp.uint32)) + jnp.zeros(
        (B, 1), jnp.uint32)
    anc = bit
    jump = pre_c
    for _ in range(6):                                # 2^6 >= 32
        anc = anc | jnp.take_along_axis(anc, jump, axis=1)
        jump = jnp.take_along_axis(jump, jump, axis=1)
    root = jump[:, :]                                 # fixpoint = head node

    used = jnp.zeros((B,), jnp.uint32)
    stop = jnp.zeros((B,), bool)
    n_out = jnp.zeros((B,), jnp.int32)
    hit_idx = jnp.full((B, MAX_OUTPUT), -1, jnp.int32)
    hit_score = jnp.zeros((B, MAX_OUTPUT), jnp.int32)
    hit_final = jnp.zeros((B, MAX_OUTPUT), jnp.int32)

    rows = jnp.arange(B, dtype=jnp.int32)

    def attempt(carry, _):
        used, stop, n_out, hit_idx, hit_score, hit_final = carry
        used_b = (used[:, None] >> lanes.astype(jnp.uint32)) & 1
        eligible = valid & (dist > 0) & (used_b == 0)
        key = jnp.where(eligible, dist * 64 + lanes, -1)
        best = jnp.argmax(key, axis=1).astype(jnp.int32)
        best_key = jnp.take_along_axis(key, best[:, None], axis=1)[:, 0]
        any_left = best_key >= 0
        act = any_left & ~stop

        path = jnp.take_along_axis(anc, best[:, None], axis=1)[:, 0]
        fin = jnp.take_along_axis(root, best[:, None], axis=1)[:, 0]
        sc = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
        u_cnt = _popcount32(path & used)
        total = _popcount32(path)
        nu_cnt = total - u_cnt
        used_n = jnp.where(act, used | path, used)

        # STR suppression: already_used[final:best] = True
        suppress = act & (best - fin > ((total + 5) << 1))
        range_mask = ((jnp.uint32(1) << best.astype(jnp.uint32))
                      - jnp.uint32(1)) & ~(
            (jnp.uint32(1) << fin.astype(jnp.uint32)) - jnp.uint32(1))
        used_n = jnp.where(suppress, used_n | range_mask, used_n)

        retry = u_cnt >= nu_cnt
        emit = act & ~retry
        slot = jnp.where(emit, n_out, MAX_OUTPUT)
        onehot = slot[:, None] == jnp.arange(MAX_OUTPUT)[None, :]
        hit_idx = jnp.where(onehot, best[:, None], hit_idx)
        hit_score = jnp.where(onehot, sc[:, None], hit_score)
        hit_final = jnp.where(onehot, fin[:, None], hit_final)
        n_out_n = n_out + emit.astype(jnp.int32)
        stop_n = stop | ~any_left | (n_out_n >= MAX_OUTPUT)
        return (used_n, stop_n, n_out_n, hit_idx, hit_score, hit_final), None

    carry = (used, stop, n_out, hit_idx, hit_score, hit_final)
    carry, _ = jax.lax.scan(attempt, carry, None, length=K)
    _, _, _, hit_idx, hit_score, hit_final = carry
    return hit_idx, hit_score, hit_final


def _popcount32(x):
    return jax.lax.population_count(
        jax.lax.bitcast_convert_type(x, jnp.int32)
    ).astype(jnp.int32)
