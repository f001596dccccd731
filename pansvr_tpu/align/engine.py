"""Batched device realignment engine.

Orchestrates the device pipeline per batch of reads:

  1. host:   2-bit encode fwd+rev, STR detection, packing;
  2. device: seeding (ops.seeding.seed_reads_flat) over fwd+rev rows;
  3. host:   colinear merge + reference expansion (vectorized NumPy);
  4. device: SDP chaining (ops.chain.chain_batch);
  5. host:   chain extraction (top-6 per direction, cutoff rules);
  6. host:   chain walk -> segment plan; simple-compare segments resolved
             inline, full-DP segments COLLECTED;
  7. device: one extd2_batch call over all collected DP segments;
  8. host:   replay the walks with the batched DP results -> scores,
             CIGARs, mapq, results identical to align.host_align.

The collect/replay trick is sound because segment boundaries and the
simple/DP decision depend only on chain geometry and direct sequence
compares — never on a DP outcome — so both passes request the same
segments in the same order.

Equality with HostAligner is the correctness contract (tested); speed
comes from steps 2, 4, 7 running as single batched device programs.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np

import functools

import jax
import jax.numpy as jnp

from ..index.builder import RdBGIndex
from ..index.device import to_device
from ..ops import chain_ref
from ..ops.chain import chain_batch, chain_extract_batch
from ..ops.extd2_jax import (
    Extd2Params,
    extd2_batch,
    ops_to_cigar,
    traceback_batch,
)
from ..ops.ksw2_ref import NEG_INF, Ez
from ..ops.seeding import (
    BUDGET_OVERFLOW,
    FLAT_OVERFLOW,
    merge_expand_device3,
    pack_reads,
    seed_reads_flat,
)
from ..utils import dna
from . import native_glue
from .host_align import (
    FORWARD,
    LEN_KMER,
    MIN_STR_DETECT_LEN,
    MAX_CHAIN_SCORE_DIFF,
    MAX_OUTPUT_NUMBER,
    MIN_ALN_SCORE,
    MIN_CHAIN_SCORE,
    MIN_CHAIN_SCORE_LOOP,
    REVERSE,
    SEED_STEP,
    AlignParams,
    AlnResult,
    HostAligner,
    KswHandler,
    OriResult,
    SingleEndState,
    reverse_merge_cigar,
)


# consecutive batches whose active rows fit half the next compaction
# budget before the engine grows the divisor (each grow recompiles)
_COMPACT_STABLE = 3

# flat-front probe flavor per front name
_FRONT_PROBE = {"v6": "sortjoin"}

# front="auto": sort-merge-join probe (v6) while the entry table is
# sort-sized — the per-batch join sort is O(n_kmer + B*S0), against the
# bisect's chain of dependent gathers; bigger indexes fall back to the
# bisect front (v5)
SORTJOIN_MAX_KMER = 1 << 22

# ---- fused device programs (one dispatch each, so a batch pays a few
# launches and host round trips instead of one per op) --------------------

def _pack_mask_host(m: np.ndarray) -> np.ndarray:
    """(rows, S0) bool -> (rows, ceil(S0/32)) int32 bitmask (little bit
    order): the seed whitelist goes to the device as ~S0/8 bytes per row
    instead of S0 bool bytes (~460 kB/batch saved at B=8192, S0=29)."""
    rows, S0 = m.shape
    W = (S0 + 31) // 32
    b = np.packbits(m, axis=1, bitorder="little")
    out = np.zeros((rows, W * 4), np.uint8)
    out[:, : b.shape[1]] = b
    return out.view(np.int32)


def _unpack_mask(mask_words: jnp.ndarray, S0: int) -> jnp.ndarray:
    """Device-side inverse of _pack_mask_host -> (rows, S0) bool."""
    cols = np.arange(S0, dtype=np.int32)
    w = mask_words[:, cols >> 5]
    sh = jnp.asarray((cols & 31).astype(np.int32))[None, :]
    return ((w >> sh) & 1) != 0


def _front_body(didx, words, lens, mask, S0, S, M, front, n_ext,
                nf_mult=10, compact=0):
    if mask.dtype != jnp.bool_:
        mask = _unpack_mask(mask, S0)
    if compact:
        # active-row compaction: rows with NO k-mer hit are common on
        # anchor-realignment workloads, so every post-probe stage
        # (extension, merge, chain) runs at `compact` rows instead of
        # B. stats3 is scattered back to full row space on device;
        # the per-seed chain outputs stay compact (rid rides in the
        # fused buffer, the host scatters). Over-budget active rows
        # get BUDGET_OVERFLOW (host fallback + engine widens).
        sb, rid, over_budget = seed_reads_flat(
            didx, words, lens, mask, S0=S0, M=M, n_ext_steps=n_ext,
            nf_mult=nf_mult, probe=_FRONT_PROBE.get(front, "bisect"),
            compact_rows=compact)
        es = merge_expand_device3(sb, didx, S=S)
        B_full = words.shape[0]
        ov_full = jnp.where(over_budget, jnp.int32(BUDGET_OVERFLOW), 0)
        ov_full = ov_full.at[rid].add(sb.n_overflow, mode="drop")
        dr_full = (jnp.zeros((B_full,), jnp.int32)
                   .at[rid].add(es.n_dropped.astype(jnp.int32),
                                mode="drop"))
        cnt_full = (jnp.zeros((B_full,), jnp.int32)
                    .at[rid].add(es.valid.sum(axis=1).astype(jnp.int32),
                                 mode="drop"))
        stats3 = jnp.stack([ov_full, dr_full, cnt_full])
        return es, stats3, rid
    # flat front: hits of the whole batch compacted onto one global
    # lane axis (~4x fewer extension lanes than (B, M) padding);
    # bit-identical SeedBatch, NF-cap rows flagged for host fallback.
    # v6 joins the query keys against the entry table in one sort; v5
    # keeps the bisect probe for indexes past SORTJOIN_MAX_KMER. (The
    # retired v1-v4/v5h fronts and merge v1/v2 A/B epitaphs live in
    # PERF.md.)
    sb = seed_reads_flat(didx, words, lens, mask, S0=S0, M=M,
                         n_ext_steps=n_ext, nf_mult=nf_mult,
                         probe=_FRONT_PROBE.get(front, "bisect"))
    es = merge_expand_device3(sb, didx, S=S)
    stats3 = jnp.stack([
        sb.n_overflow,
        es.n_dropped.astype(jnp.int32),
        es.valid.sum(axis=1).astype(jnp.int32),
    ])
    return es, stats3


@functools.partial(
    jax.jit,
    static_argnames=("S0", "S", "M", "front", "n_ext", "nf_mult",
                     "compact"))
def _device_front(didx, words, lens, mask, S0, S, M=64, front="v6",
                  n_ext=10, nf_mult=10, compact=0):
    return _front_body(didx, words, lens, mask, S0, S, M, front, n_ext,
                       nf_mult, compact)


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@functools.lru_cache(maxsize=64)
def _sharded_front(mesh, S0, S, M, front, n_ext, nf_mult=10):
    """Data-parallel front over a device mesh: read rows sharded on the
    'data' axis, the RdBG index replicated per device. Per-row outputs come
    back sharded; the engine's host glue is shard-agnostic."""
    from jax.sharding import PartitionSpec as P

    def body(didx, words, lens, mask):
        return _front_body(didx, words, lens, mask, S0, S, M, front, n_ext,
                           nf_mult)

    return jax.jit(_shard_map(
        body, mesh,
        in_specs=(P(), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P(None, "data")),
    ))


def _chain_body(rb, re_, fb, fe, cov, sid, valid, is_str):
    cr = chain_batch(rb, re_, fb, fe, cov, sid, valid, is_str)
    hit_idx, hit_score, hit_final = chain_extract_batch(
        cr.dist, cr.pre, cr.valid
    )
    # minimal-dtype transfer: the host walk (_score_chain) reads only
    # rb/re/fb/fe/pre, and the break rules read the extracted hits — so
    # dist/cov/sid never leave the device. fe rides as a delta off fb
    # (merged MEM span <= read length), halving the dominant (B, K)
    # payload vs a uniform int32 stack.
    p32 = cr.ref_begin                                   # (B, K) int32
    p16 = jnp.stack([
        cr.read_begin.astype(jnp.int16),
        cr.read_end.astype(jnp.int16),
        (cr.ref_end - cr.ref_begin).astype(jnp.int16),
    ])                                                   # (3, B, K)
    p8 = cr.pre.astype(jnp.int8)                         # (B, K)
    hits8 = jnp.stack([hit_idx.astype(jnp.int8),
                       hit_final.astype(jnp.int8)])      # (2, B, 6)
    hscore = hit_score.astype(jnp.int16)                 # (B, 6)
    return p32, p16, p8, hits8, hscore


_device_chain_pack = jax.jit(_chain_body)


def _b8(a):
    """Flatten any int array to little-endian bytes (int8 1-D)."""
    if a.dtype == jnp.int8:
        return a.reshape(-1)
    return jax.lax.bitcast_convert_type(a, jnp.int8).reshape(-1)


def _chain_fuse(stats3, es, is_str, K, rid=None):
    """Chain outputs (plus the front's stats) as ONE flat int8 buffer:
    one device-to-host copy instead of six. The [:, :K] seed slicing
    happens INSIDE the jit (eager slices would each dispatch a program of
    their own). Layout (B rows, K seeds):
    [stats3 (3,B) i32][rid (R) i32 if compacted][p32 (R,K) i32]
    [p16 (3,R,K) i16][p8 (R,K) i8][hits8 (2,R,6) i8][hscore (R,6) i16]
    where R = compacted row count (= B uncompacted); stats3 is always
    full row space. `is_str` is always full (B,); with rid it is
    gathered to the compact rows inside."""
    if rid is not None:
        B_full = is_str.shape[0]
        is_str = is_str[jnp.clip(rid, 0, B_full - 1)] & (rid < B_full)
    p32, p16, p8, hits8, hscore = _chain_body(
        es.read_begin[:, :K], es.read_end[:, :K], es.ref_begin[:, :K],
        es.ref_end[:, :K], es.cov[:, :K], es.seed_id[:, :K],
        es.valid[:, :K], is_str)
    parts = [_b8(stats3)]
    if rid is not None:
        parts.append(_b8(rid))
    parts += [_b8(p32), _b8(p16), _b8(p8), _b8(hits8), _b8(hscore)]
    return jnp.concatenate(parts)


_chain_body_fused = jax.jit(_chain_fuse, static_argnames=("K",))


def _collect_fuse(stats3, es, is_str, K, rid, active_words, n_pad, NC, NP):
    """Fused chain + DEVICE COLLECT buffer: the chain program runs at
    width K, then ops/collect.select_and_paths performs the per-read
    chain selection and pre-pointer path gather on device — only the
    compacted chain/path lanes reach the host (vs the (rows, K) chain
    tensors of _chain_fuse). Layout:
    [stats3 (3,B2) i32][rid (R) i32 if compacted][over (n_pad) i32]
    [scal (4,) i32 = n_chains,total_chains,n_nodes,total_nodes][chain_meta (NC,3) i32]
    [path_a (NP) i32][path_b (NP) i32][path_dfe (NP) i16]"""
    from ..ops.collect import select_and_paths

    if rid is not None:
        B_full = is_str.shape[0]
        is_str = is_str[jnp.clip(rid, 0, B_full - 1)] & (rid < B_full)
    cr = chain_batch(
        es.read_begin[:, :K], es.read_end[:, :K], es.ref_begin[:, :K],
        es.ref_end[:, :K], es.cov[:, :K], es.seed_id[:, :K],
        es.valid[:, :K], is_str)
    hit_idx, hit_score, hit_final = chain_extract_batch(
        cr.dist, cr.pre, cr.valid)
    co = select_and_paths(
        cr.read_begin, cr.read_end, cr.ref_begin, cr.ref_end, cr.pre,
        hit_idx, hit_score, hit_final, active_words, rid,
        n_pad=n_pad, NC=NC, NP=NP)
    parts = [_b8(stats3)]
    if rid is not None:
        parts.append(_b8(rid))
    parts += [
        _b8(co.over),
        _b8(jnp.concatenate([co.n_chains, co.n_nodes])),
        _b8(co.chain_meta),
        _b8(co.path_a), _b8(co.path_b),
        _b8(co.path_dfe.astype(jnp.int16)),
    ]
    return jnp.concatenate(parts)


_collect_fused = jax.jit(
    _collect_fuse, static_argnames=("K", "n_pad", "NC", "NP"))


def _collect_unpack(buf: np.ndarray, B: int, K: int, n_pad: int,
                    NC: int, NP: int, R: int = 0):
    """Host views into the fused collect buffer (layout: _collect_fuse)."""
    o = 0

    def take(n, dt, shape):
        nonlocal o
        v = buf[o : o + n].view(dt).reshape(shape)
        o += n
        return v

    stats3 = take(12 * B, np.int32, (3, B))
    if R:
        take(4 * R, np.int32, (R,))  # rid (host already knows it)
    over = take(4 * n_pad, np.int32, (n_pad,))
    scal = take(16, np.int32, (4,))
    chain_meta = take(12 * NC, np.int32, (NC, 3))
    path_a = take(4 * NP, np.int32, (NP,))
    path_b = take(4 * NP, np.int32, (NP,))
    path_dfe = take(2 * NP, np.int16, (NP,))
    return stats3, over, scal, chain_meta, path_a, path_b, path_dfe


@functools.partial(
    jax.jit,
    static_argnames=("S0", "S", "M", "front", "n_ext", "nf_mult",
                     "K", "compact", "n_pad", "NC", "NP"))
def _device_front_chain_collect(didx, words, lens, mask, is_str2,
                                active_words, S0, S, M, front, n_ext,
                                nf_mult, K, compact, n_pad, NC, NP):
    """Front + chain + device collect in ONE submit-time program."""
    if compact:
        es, stats3, rid = _front_body(didx, words, lens, mask, S0, S, M,
                                      front, n_ext, nf_mult, compact)
    else:
        es, stats3 = _front_body(didx, words, lens, mask, S0, S, M, front,
                                 n_ext, nf_mult)
        rid = None
    buf = _collect_fuse(stats3, es, is_str2, K, rid, active_words,
                        n_pad, NC, NP)
    return es, stats3, rid, buf


@functools.partial(
    jax.jit,
    static_argnames=("S0", "S", "M", "front", "n_ext", "nf_mult",
                     "K", "compact"))
def _device_front_chain(didx, words, lens, mask, is_str2, S0, S, M, front,
                        n_ext, nf_mult, K, compact=0):
    """Front + speculative-K chain in ONE program: dispatched at submit
    time with host-only args, so no chain dispatch has to wait for the
    front's outputs. Returns
    the fused chain buffer plus the device-resident es/stats3/rid for
    the rare K-miss re-chain (by then materialized, so the re-dispatch
    doesn't stall either)."""
    if compact:
        es, stats3, rid = _front_body(didx, words, lens, mask, S0, S, M,
                                      front, n_ext, nf_mult, compact)
    else:
        es, stats3 = _front_body(didx, words, lens, mask, S0, S, M, front,
                                 n_ext, nf_mult)
        rid = None
    buf = _chain_fuse(stats3, es, is_str2, K, rid)
    return es, stats3, rid, buf


def _chain_unpack(buf: np.ndarray, B: int, K: int, R: int = 0):
    """Host-side views into the fused chain buffer. R > 0: the per-seed
    sections are compacted to R rows with a rid row map right after
    stats3 — scatter them back to full (B, ...) arrays here (a few
    thousand rows, so sub-ms)."""
    o = 0

    def take(n, dt, shape):
        nonlocal o
        v = buf[o : o + n].view(dt).reshape(shape)
        o += n
        return v

    stats3 = take(12 * B, np.int32, (3, B))
    if not R:
        p32 = take(4 * B * K, np.int32, (B, K))
        p16 = take(6 * B * K, np.int16, (3, B, K))
        p8 = take(B * K, np.int8, (B, K))
        hits8 = take(2 * B * 6, np.int8, (2, B, 6))
        hscore = take(2 * B * 6, np.int16, (B, 6))
        return stats3, p32, p16, p8, hits8, hscore
    rid = take(4 * R, np.int32, (R,))
    p32c = take(4 * R * K, np.int32, (R, K))
    p16c = take(6 * R * K, np.int16, (3, R, K))
    p8c = take(R * K, np.int8, (R, K))
    hits8c = take(2 * R * 6, np.int8, (2, R, 6))
    hscorec = take(2 * R * 6, np.int16, (R, 6))
    ok = rid < B
    r = rid[ok]
    p32 = np.zeros((B, K), np.int32)
    p32[r] = p32c[ok]
    p16 = np.zeros((3, B, K), np.int16)
    p16[:, r] = p16c[:, ok]
    p8 = np.full((B, K), -1, np.int8)
    p8[r] = p8c[ok]
    hits8 = np.full((2, B, 6), -1, np.int8)  # hit_idx -1 = no hits
    hits8[1] = 0
    hits8[0, r] = hits8c[0, ok]
    hits8[1, r] = hits8c[1, ok]
    hscore = np.zeros((B, 6), np.int16)
    hscore[r] = hscorec[ok]
    return stats3, p32, p16, p8, hits8, hscore


@functools.lru_cache(maxsize=16)
def _sharded_chain(mesh):
    from jax.sharding import PartitionSpec as P

    return jax.jit(_shard_map(
        _chain_body, mesh,
        in_specs=tuple([P("data")] * 8),
        out_specs=(P("data"), P(None, "data"), P("data"),
                   P(None, "data"), P("data")),
    ))


def _dp_pack(ops, packed):
    """Fuse a DP chunk's (ops, packed) into one int8 buffer: one
    device-to-host copy instead of two. Backward op codes are 2 bits
    (0=M 1=I 2=D 3=terminal), so four ride per byte — the ops rows are
    the bulk of the transfer."""
    B = ops.shape[0]
    o = ops.reshape(B, -1).astype(jnp.uint8)
    L = o.shape[1]
    if L % 4:
        o = jnp.concatenate(
            [o, jnp.full((B, 4 - L % 4), 3, jnp.uint8)], axis=1)
    o4 = o.reshape(B, -1, 4)
    pk = (o4[:, :, 0] | (o4[:, :, 1] << 2) | (o4[:, :, 2] << 4)
          | (o4[:, :, 3] << 6))
    return jnp.concatenate([
        _b8(packed.astype(jnp.int32)),
        jax.lax.bitcast_convert_type(pk.reshape(-1), jnp.int8),
    ])


def _dp_unpack(buf: np.ndarray, B: int):
    packed = buf[: 32 * B].view(np.int32).reshape(8, B)
    pk = buf[32 * B :].view(np.uint8).reshape(B, -1)
    ops = np.empty((B, pk.shape[1] * 4), np.int8)
    ops[:, 0::4] = pk & 3
    ops[:, 1::4] = (pk >> 2) & 3
    ops[:, 2::4] = (pk >> 4) & 3
    ops[:, 3::4] = (pk >> 6) & 3
    return ops, packed


@functools.partial(jax.jit, static_argnames=("L",))
def _unpack_codes(words, L):
    """(B2, Wr) packed read words -> flat (B2*L,) uint8 codes on device
    (row-major, fwd rows then rev rows — the glue's codes layout). Stays
    on device; feeds the meta-driven DP fill."""
    u = jax.lax.bitcast_convert_type(words, jnp.uint32)
    j = np.arange(L, dtype=np.int32)
    w = u[:, j >> 4]                                     # static col gather
    sh = jnp.asarray(((15 - (j & 15)) * 2).astype(np.uint32))
    return ((w >> sh[None, :]) & 3).astype(jnp.uint8).reshape(-1)


def _dp_fill_meta(codes_flat, ref_words, qbase, qa, refst, tlen, rev,
                  tru_len, cq, ct):
    """Build one DP chunk's code matrices ON DEVICE from the resident
    flat read codes + packed reference, from per-request metadata
    (glue_fill_dp semantics: reversed rows for TYPE_LEFT, reference
    clamped at [0, true_len) with 0 beyond). Replaces the per-chunk
    int32 qc/tc host->device transfer (~2 MB per chunk)."""
    rw = jax.lax.bitcast_convert_type(ref_words, jnp.uint32)
    j_q = jnp.arange(cq, dtype=jnp.int32)[None, :]
    qidx = qbase[:, None] + jnp.where(rev[:, None] != 0,
                                      qa[:, None] - 1 - j_q, j_q)
    qok = j_q < qa[:, None]
    n_codes = codes_flat.shape[0]
    qc = jnp.where(
        qok, codes_flat[jnp.clip(qidx, 0, n_codes - 1)], 0
    ).astype(jnp.int32)
    j_t = jnp.arange(ct, dtype=jnp.int32)[None, :]
    tpos = refst[:, None] + jnp.where(rev[:, None] != 0,
                                      tlen[:, None] - 1 - j_t, j_t)
    tok = (j_t < tlen[:, None]) & (tpos < tru_len[0])
    w = rw[jnp.clip(tpos >> 4, 0, rw.shape[0] - 1)]
    base = (w >> (((15 - (tpos & 15)) * 2).astype(jnp.uint32))) & 3
    tc = jnp.where(tok, base.astype(jnp.int32), 0)
    return qc, qa, tc, tlen


@functools.partial(jax.jit, static_argnames=("params", "cq", "ct"))
def _device_dp_meta(codes_flat, ref_words, qbase, qa, refst, tlen, rev,
                    tru_len, params, cq, ct):
    qc, ql, tc, tl = _dp_fill_meta(
        codes_flat, ref_words, qbase, qa, refst, tlen, rev, tru_len, cq, ct)
    return _dp_pack(*_dp_scan_body(qc, ql, tc, tl, params, cq + ct))


def _dp_scan_body(qc, ql, tc, tl, params, K):
    res = extd2_batch(qc, ql, tc, tl, params=params)
    i0 = jnp.where(~res.zdropped, tl - 1,
                   jnp.where(res.max_t >= 0, res.max_t, -1)).astype(jnp.int32)
    j0 = jnp.where(~res.zdropped, ql - 1,
                   jnp.where(res.max_q >= 0, res.max_q, -1)).astype(jnp.int32)
    ops, i_f, j_f = traceback_batch(res.dmat, res.st_arr, res.en_arr,
                                    i0, j0, K=K)
    packed = jnp.stack([
        res.score, res.mqe, res.max, res.max_q, res.max_t,
        res.zdropped.astype(jnp.int32), i_f, j_f,
    ])
    return ops, packed


@functools.partial(jax.jit, static_argnames=("params", "K"))
def _device_dp(qc, ql, tc, tl, params, K):
    return _dp_pack(*_dp_scan_body(qc, ql, tc, tl, params, K))


@functools.lru_cache(maxsize=32)
def _sharded_dp(mesh, params, K: int):
    """Data-parallel DP over the mesh: each device sweeps its slice of
    the segment chunk with the same compiled program."""
    from jax.sharding import PartitionSpec as P

    def body(qc, ql, tc, tl):
        return _dp_scan_body(qc, ql, tc, tl, params, K)

    return jax.jit(_shard_map(
        body, mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P(None, "data")),
    ))


class _CollectDP(KswHandler):
    """KswHandler whose DP calls are collected (pass 1) then replayed
    (pass 2) from a batch-computed result list."""

    def __init__(self, idx, p):
        super().__init__(idx, p)
        self.mode = "collect"
        self.requests: list[tuple[np.ndarray, np.ndarray]] = []
        self.responses: list[Ez] = []
        self._cursor = 0

    def start_replay(self, responses):
        self.mode = "replay"
        self.responses = responses
        self._cursor = 0

    def _run_dp(self, qseq, tseq):
        if self.mode == "collect":
            self.requests.append((qseq, tseq))
            return Ez(score=0, mqe=0, cigar=[("M", min(len(qseq), len(tseq)))])
        ez = self.responses[self._cursor]
        self._cursor += 1
        return ez


@dataclass
class EngineConfig:
    # compiled read-length classes: each batch runs in the smallest class
    # that fits its longest read; longer reads fall back to the host
    # aligner. The top class matches the reference's cap (1600,
    # read_realignment.hpp:322); classes only compile when a batch
    # actually needs them.
    read_classes: tuple = (160, 256, 512, 1024, 1600)
    max_seeds: int = 32          # S: expanded seeds per read/direction
    chain_bucket: int = 32       # K: fixed chain width (over-K reads -> host)
    mem_slots: int = 32          # M: compacted MEM lanes (overflow -> host)
    dp_q: int = 176              # DP size class for the 160 read class
    dp_t: int = 256
    front: str = "auto"          # seeding front: "auto" = "v6" (flat
                                 # lanes + sort-merge-join probe) when
                                 # the entry table is sort-sized, else
                                 # "v5" (flat + bisect probe). Valid:
                                 # {"auto", "v5", "v6"} — the retired
                                 # v1-v4/v5h fronts are deleted (PERF.md
                                 # epitaphs); unknown values raise
    native_glue: bool = True     # use native/engine_glue.cpp for the
                                 # collect/replay walks when built
    nf_mult: int = 10            # flat-front global lane budget (avg
                                 # MEM lanes per row; rows over the pool
                                 # take the host path)
    retier_threshold: float = 0.25  # fallback rate that triggers doubling
                                 # the M/S/K caps (repeat-rich workloads)
    retier_max: int = 128        # cap for the widened shapes
    dp_chunk: int = 2048         # lanes per DP dispatch for the small
                                 # class (the big class uses 1/4 of it)
    fuse_chain: bool = True      # single-device path: run front + the
                                 # speculative-K chain as ONE device
                                 # program dispatched at submit time
                                 # (host-only args), so no chain
                                 # dispatch waits on the front's result
    compact_div: int = 4         # active-row compaction switch (>1 =
                                 # enabled): post-probe front stages +
                                 # chain (and the fused result buffer)
                                 # run at a peak-active-rows*1.4 budget
                                 # instead of 2*n_pad, tracked with
                                 # hysteresis. Over-budget rows fall
                                 # back to host and the cap drops.
                                 # Only the fused single-device path
                                 # compacts.
    stream_depth: int = 3        # in-flight batches in align_stream:
                                 # 3 = three device fronts in flight and
                                 # the DP phase deferred, so each chain
                                 # buffer's d2h copy hides behind TWO
                                 # newer fronts; 1 = single-batch
                                 # pipeline
    chain_copy: str = "dispatch" # when the fused chain buffer's d2h
                                 # copy is issued: "dispatch" = right
                                 # at front dispatch (queues behind the
                                 # program; with stream_depth=3 the
                                 # ~1-2 MB copy hides behind the two
                                 # newer fronts); "finish" = in
                                 # _finish_front
    collect: str = "auto"        # where the chain selection + walk-path
                                 # gather run: "device" (ops/collect in
                                 # the fused front program; only the
                                 # compacted chain/path lanes reach the
                                 # host — ~0.6 MB/batch less d2h) or
                                 # "host" (round-4 path: ship (rows, K)
                                 # chain tensors, C++ chases pre
                                 # pointers). "auto" = device on the
                                 # fused single-device path when the
                                 # native glue is built.
    collect_mult: int = 1        # device-collect lane budgets:
                                 # NC = mult*n_pad chains,
                                 # NP = 2*mult*n_pad path nodes; reads
                                 # over budget take the host path and
                                 # the engine doubles the mult (one
                                 # recompile per step, <= 8)
    pipe_order: str = "late"     # align_stream next-front dispatch point:
                                 # "late" = after this batch's DP,
                                 # "early" = right after its chain program
                                 # (result copies queue behind dispatched
                                 # programs, so an early front can delay
                                 # the chain fetch)

    @property
    def max_read_len(self) -> int:
        return max(self.read_classes)

    def read_class(self, max_len: int) -> int | None:
        for c in sorted(self.read_classes):
            if max_len <= c:
                return c
        return None

    def dp_class(self, read_class: int) -> tuple[int, int]:
        """(dp_q, dp_t) for a read class; bigger classes scale with L
        (same +80 target slack the 160 class uses)."""
        if read_class <= 160:
            return self.dp_q, self.dp_t
        q = read_class + 16
        return q, q + 80


class AlignEngine:
    """Batched aligner; produces SingleEndState lists compatible with
    align.host_align.PEScorer."""

    def __init__(self, idx: RdBGIndex, params: AlignParams | None = None,
                 config: EngineConfig | None = None,
                 ori_chrom_names: list[str] | None = None,
                 mesh=None):
        from ..utils.jaxcache import enable_cache

        enable_cache()
        self.idx = idx
        self.p = params or AlignParams()
        self.cfg = config or EngineConfig()
        if self.cfg.front == "auto":
            self.cfg.front = "v6" if idx.n_kmers <= SORTJOIN_MAX_KMER \
                else "v5"
        elif self.cfg.front not in ("v5", "v6"):
            raise ValueError(
                f"unknown EngineConfig.front {self.cfg.front!r} "
                "(valid: 'auto', 'v5', 'v6')")
        # jax.sharding.Mesh with a 'data' axis: the front/chain/DP device
        # programs run shard_mapped (reads data-parallel, index replicated
        # per device); None = single-device jit
        self.mesh = mesh
        self.didx = to_device(idx)
        self.host = HostAligner(idx, self.p, ori_chrom_names=ori_chrom_names)
        self.sv_info = self.host.sv_info
        self.dp_params = Extd2Params(
            match=self.p.match, mismatch=-self.p.mismatch,
            q=self.p.gap_open, e=self.p.gap_ex,
            q2=self.p.gap_open2, e2=self.p.gap_ex2,
            w=self.p.band, zdrop=self.p.zdrop,
        )
        self._scalar_dp = KswHandler(idx, self.p)._run_dp
        # native host glue (collect/replay walks in C++); None falls back
        # to the pure-Python loops below
        self._glue_lib = native_glue.get_lib() if self.cfg.native_glue \
            else None
        # speculative chain width: previous batch's max seed count,
        # rounded to the bucket (re-chained at full width on a miss);
        # starts at the smallest bucket — the common steady state — so
        # the warmup batch compiles the shape the stream will reuse
        self._k_spec = 8
        self._k_shrink_run = 0
        # active-row compaction: starts UNCOMPACTED; once the recent
        # window is full, the budget is recent-peak-active-rows + 40%
        # headroom (512-quantized, hysteresis before each recompile),
        # engaged only when it saves >= 12.5% of the rows. Budget
        # overflow drops the cap and clears the window.
        # cfg.compact_div <= 1 disables.
        self._act_window = deque(maxlen=8)
        self._comp_cap = 0       # applied budget (0 = uncompacted)
        self._comp_want = 0      # candidate awaiting stability
        self._comp_want_run = 0
        self._packed_ref = np.ascontiguousarray(self.host.ksw.packed_ref)
        # true (unpadded) reference length for the device DP fill's
        # beyond-end zero clamp; dynamic arg so quantized-shape worlds
        # share compiled programs
        self._tru_ref_len = np.array([len(self._packed_ref)], np.int32)
        self._chr_starts64 = np.ascontiguousarray(
            self.idx.chr_starts, np.int64)
        self._sv_st_pos = np.array(
            [info.st_pos for info in self.sv_info], np.int32)
        # wall-clock per engine phase, accumulated across batches; device
        # waits show up in the sync_* rows (dispatches are async)
        self.prof: dict[str, float] = defaultdict(float)
        self._fallback_warned = False
        self._tier_window: list[tuple[int, int]] = []  # (n_fallback, n)
        self._emit_ctx = None      # set_native_emit
        self._emit_pe = None       # PEScorer for fallback pairs

    # ------------------------------------------------------------------
    def load_tuning(self, path: str) -> bool:
        """Apply a previous run's converged lane budgets/shapes so the
        first batch compiles the RIGHT programs immediately — the
        adaptive widening otherwise walks several shape generations,
        each a compile."""
        import json

        try:
            with open(path) as fh:
                t = json.load(fh)
        except (OSError, ValueError):
            return False
        cfg = self.cfg
        for k in ("nf_mult", "mem_slots", "max_seeds", "chain_bucket",
                  "collect_mult"):
            if k in t:
                setattr(cfg, k, int(t[k]))
        if "k_spec" in t:
            self._k_spec = min(int(t["k_spec"]), cfg.max_seeds, 32)
        return True

    def save_tuning(self, path: str) -> None:
        import json

        cfg = self.cfg
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({
                "nf_mult": cfg.nf_mult, "mem_slots": cfg.mem_slots,
                "max_seeds": cfg.max_seeds,
                "chain_bucket": cfg.chain_bucket,
                "collect_mult": getattr(cfg, "collect_mult", 1),
                "k_spec": self._k_spec,
            }, fh)
        os.replace(tmp, path)

    # ------------------------------------------------------------------
    def set_native_emit(self, emit_ctx) -> None:
        """Route batches with aux=(names, quals, comments) through the
        C++ PE-pair + BAM-encode pass (glue_pe_emit): align_stream then
        yields encoded record blobs instead of state lists. Requires the
        native glue library."""
        if self._glue_lib is None:
            raise RuntimeError("native emit requires libpansvr_glue "
                               "(tools/build_native.sh)")
        from .host_align import PEScorer

        self._emit_ctx = emit_ctx
        self._emit_pe = PEScorer(self.host, emit_ctx.max_isize,
                                 emit_ctx.min_isize,
                                 emit_ctx.normal_read_len)

    # ------------------------------------------------------------------
    def align_batch(self, seqs: list[str], oris: list[OriResult]) -> list[SingleEndState]:
        return self._finish_batch(self._submit_batch(seqs, oris))

    def _maybe_retier(self):
        """Workload-adaptive shapes: repeat-rich reads overflow the
        static per-read caps (M MEM lanes / S expanded seeds / K chain
        width) and drop to the exact-but-slow host path. When the recent
        fallback rate crosses the threshold, double the caps (one
        recompile per tier, bounded by retier_max) — the reference's
        dynamic arrays have no such caps, so widening preserves its
        semantics while keeping the device path hot."""
        cfg = self.cfg
        if cfg.mem_slots >= cfg.retier_max:
            return
        win = self._tier_window[-4:]
        nf = sum(f for f, _ in win)
        n = sum(x for _, x in win)
        if n >= 2048 and nf > cfg.retier_threshold * n:
            old = (cfg.mem_slots, cfg.max_seeds, cfg.chain_bucket,
                   cfg.nf_mult)
            cfg.mem_slots = min(cfg.mem_slots * 2, cfg.retier_max)
            cfg.max_seeds = min(cfg.max_seeds * 2, cfg.retier_max)
            cfg.chain_bucket = min(cfg.chain_bucket * 2, cfg.retier_max)
            cfg.nf_mult = min(cfg.nf_mult * 2, cfg.retier_max)
            self._k_spec = min(self._k_spec, cfg.max_seeds)
            self._tier_window.clear()
            import sys as _sys

            print(
                f"[pansvr engine] fallback rate {nf}/{n} over the last "
                f"batches: widening device shapes (M,S,K,nf) {old} -> "
                f"({cfg.mem_slots}, {cfg.max_seeds}, {cfg.chain_bucket}, "
                f"{cfg.nf_mult}) (one-time recompile)", file=_sys.stderr,
            )

    def align_stream(self, batches):
        """Software-pipelined batches (cfg.stream_depth == 2, default):
        TWO device fronts stay in flight and each batch's DP phase
        (result fetch + replay + emit) is deferred one iteration, so

          - the chain-buffer fetch of batch N overlaps batch N+1's
            front execution (d2h copies run concurrently with compute),
            and
          - by the time batch N's DP results are fetched, its DP
            programs executed long ago and the async copies issued at
            dispatch have already landed (~0 wait).

        Steady-state wall per batch approaches pure device execution
        (front+chain+DP); host prep of the next batch runs in a worker
        thread (the kt_pipeline input-stage analog). stream_depth == 1
        falls back to the single-batch pipeline. `batches`
        yields (seqs, oris); yields state lists / emit blobs in order."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        it = iter(batches)
        depth = getattr(self.cfg, "stream_depth", 2)

        if depth <= 1:
            yield from self._align_stream_d1(it)
            return

        def pull():
            try:
                return next(it)
            except StopIteration:
                return None

        b = pull()
        if b is None:
            return
        # ONE prep worker, TWO prep futures in flight: prep is ~68 ms
        # and the main loop stalls on prep_fut.result without a queue;
        # a second WORKER was measured counterproductive (GIL contention
        # slowed the main thread's replay phase by more than it saved)
        with ThreadPoolExecutor(max_workers=1) as pool:
            q_front: deque = deque()   # front dispatched, chain pending
            q_dp: deque = deque()      # DP dispatched, results pending
            q_prep: deque = deque()    # prep futures in flight
            q_front.append(self._submit_batch(*b))
            for _ in range(depth - 1):
                b = pull()
                if b is None:
                    break
                # further fronts in flight before any result is waited on
                q_front.append(self._submit_batch(*b))
            if b is not None:
                while len(q_prep) < 2:
                    b = pull()
                    if b is None:
                        break
                    q_prep.append(pool.submit(self._prep_batch, *b))
            while q_front or q_dp:
                if q_front:
                    pend = q_front.popleft()
                    # fetch chain + collect + dispatch DP (the fetch
                    # overlaps the next front's execution on device)
                    self._finish_front(pend)
                    q_dp.append(pend)
                    if q_prep:
                        t = time.perf_counter()
                        q_front.append(
                            self._dispatch_front(q_prep.popleft().result()))
                        self.prof["host_submit"] += time.perf_counter() - t
                        b = pull()
                        if b is not None:
                            q_prep.append(
                                pool.submit(self._prep_batch, *b))
                # defer the DP phase one iteration while fronts remain:
                # its result copies land while the newer front executes
                if q_dp and (not q_front or len(q_dp) > 1):
                    yield self._finish_dp(q_dp.popleft())

    def _align_stream_d1(self, it):
        """Round-2 single-batch pipeline (stream_depth=1): kept for A/B
        and for workloads where two in-flight batches exceed HBM."""
        from concurrent.futures import ThreadPoolExecutor

        try:
            pend = self._submit_batch(*next(it))
        except StopIteration:
            return
        nxt_holder = {}
        with ThreadPoolExecutor(max_workers=1) as pool:
            prep_fut = None
            while True:
                try:
                    nxt = next(it)
                except StopIteration:
                    yield self._finish_batch(pend)
                    return
                # host prep of the NEXT batch runs in a worker thread
                # while this batch's finish waits on device transfers
                prep_fut = pool.submit(self._prep_batch, *nxt)

                def dispatch_next(fut=prep_fut):
                    t = time.perf_counter()
                    nxt_holder["p"] = self._dispatch_front(fut.result())
                    self.prof["host_submit"] += time.perf_counter() - t

                yield self._finish_batch(pend, on_dp_dispatched=dispatch_next)
                pend = nxt_holder.get("p") or \
                    self._dispatch_front(prep_fut.result())
                nxt_holder.clear()

    def _submit_batch(self, seqs: list[str], oris: list[OriResult],
                      aux=None):
        t = time.perf_counter()
        out = self._dispatch_front(self._prep_batch(seqs, oris, aux))
        self.prof["host_submit"] += time.perf_counter() - t
        return out

    def _prep_batch(self, seqs: list[str], oris: list[OriResult],
                    aux=None):
        """Host-only batch preparation (encode, STR screen, packing).
        Thread-safe: touches no engine/device state besides read-only
        tables, so align_stream runs it one batch ahead in a worker
        thread while the main thread waits on device transfers."""
        cfg = self.cfg
        n = len(seqs)
        # pad the batch row count to a power-of-two bucket so the jitted
        # device stages compile once per bucket, not once per call
        n_pad = max(64, 1 << (max(n, 1) - 1).bit_length())
        fit_lens = [len(s) for s in seqs if len(s) <= cfg.max_read_len]
        L = cfg.read_class(max(fit_lens)) if fit_lens \
            else min(cfg.read_classes)
        states: list[SingleEndState] = []

        codes_f = np.zeros((n_pad, L), np.uint8)
        codes_r = np.zeros((n_pad, L), np.uint8)
        lens = np.zeros(n_pad, np.int32)
        S0 = (L - LEN_KMER) // SEED_STEP + 1
        seed_mask_f = np.ones((n_pad, S0), bool)
        seed_mask_r = np.ones((n_pad, S0), bool)
        is_str = np.zeros(n_pad, bool)

        # ---- batch-vectorized read encoding --------------------------
        # One frombuffer + LUT over the joined batch replaces 8k per-read
        # encode/fill_n/revcomp calls (was ~0.25 s/batch of host_submit).
        # fill_n hashes the LOCAL read position, which is exactly the
        # column index of the padded matrix, so the vectorized fill is
        # bit-identical to the per-read path.
        all_lens = np.fromiter((len(s) for s in seqs), np.int32, count=n)
        fit = all_lens <= L
        col = np.arange(L)
        if n:
            joined = "".join(s for s, f in zip(seqs, fit) if f).encode()
            flat = dna.encode(joined)
            in_row = col[None, :] < all_lens[fit, None]
            cf_rows = np.zeros((int(fit.sum()), L), np.uint8)
            cf_rows[in_row] = flat          # row-major fill order
            # fill N's with the position hash (dna.fill_n semantics)
            n_mask = (cf_rows >= 4) & in_row
            if n_mask.any():
                h = ((col.astype(np.uint64)
                      * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(61))
                cf_rows = np.where(
                    n_mask, (h & np.uint64(3)).astype(np.uint8)[None, :],
                    cf_rows)
            # per-row reversal of the first rl entries, then complement
            rev_idx = np.clip(all_lens[fit, None] - 1 - col[None, :], 0,
                              L - 1)
            cr_rows = np.where(
                in_row,
                np.take_along_axis(cf_rows, rev_idx, axis=1) ^ 3, 0
            ).astype(np.uint8)
            fit_idx = np.nonzero(fit)[0]
            # rows of refused (full-score) reads keep garbage codes here;
            # they never enter `active` and lens stays 0, which masks
            # every seed, matching the zero rows of the per-read path
            codes_f[fit_idx] = cf_rows
            codes_r[fit_idx] = cr_rows
        fit_row = np.zeros(n, np.int32)
        fit_row[fit] = np.arange(int(fit.sum()))

        # oris may arrive as the native comment parser's (n, 8) int32
        # matrix (native_glue.parse_comments) instead of OriResult
        # objects: the unmapped/refusal rules vectorize, and OriResult
        # objects are materialized only where a host path needs them
        ori_mat = oris if isinstance(oris, np.ndarray) else None
        if ori_mat is not None:
            unm_arr = (ori_mat[:, 6] == 1) | (ori_mat[:, 0] > 24)
            ori_score_arr = ori_mat[:, 3]

        # ---- vectorized refusal / activity masks ---------------------
        # (the per-read Python loop here cost ~100 ms/batch — with the
        # round-4 transfer fixes, host prep IS the pipeline wall)
        if ori_mat is not None:
            unm_all = unm_arr.astype(bool)
            score_all = ori_score_arr.astype(np.int64)
            ori_objs = [None] * n
        else:
            unm_all = np.fromiter(
                (o.unmapped or o.chr_id > 24 for o in oris), bool, count=n)
            score_all = np.fromiter(
                (o.align_score for o in oris), np.int64, count=n)
            ori_objs = oris
        refuse = (~unm_all) & (
            score_all == all_lens.astype(np.int64) * self.p.match)
        act_mask = fit & ~refuse
        lens[:n][act_mask] = all_lens[act_mask]
        active = np.nonzero(act_mask)[0].tolist()
        # out-of-class reads: exact host path, deferred to _finish_batch
        # (prep may run in a worker thread; HostAligner is not
        # thread-safe)
        oversize = np.nonzero(~fit)[0].tolist()
        maybe_str = np.nonzero(
            act_mask & (all_lens - LEN_KMER + 1 > 0))[0].tolist()
        unm_l = unm_all.tolist()
        fit_l = fit.tolist()
        row_l = fit_row.tolist()
        len_l = all_lens.tolist()
        ap = states.append
        for i in range(n):
            if fit_l[i]:
                r = row_l[i]
                rl = len_l[i]
                cf = cf_rows[r, :rl]
                cr = cr_rows[r, :rl]
            else:
                cf = dna.fill_n(dna.encode(seqs[i]), seed=0)
                cr = (cf[::-1] ^ 3).astype(np.uint8)
            ap(SingleEndState(
                results=[], ori=ori_objs[i], ori_unmapped=unm_l[i],
                read_codes_fwd=cf, read_codes_rev=cr,
            ))

        # STR detection: cheap pre-screen (duplicate-20-mer count) narrows
        # the reads that need the full per-read seed-list construction.
        # The native glue computes the counts in one C++ pass; the NumPy
        # per-length-group row sort is the fallback.
        if maybe_str:
            candidates: set[int] = set()
            dup_all = None
            if self._glue_lib is not None:
                dup_all = native_glue.str_dup_counts(
                    self._glue_lib, codes_f, lens, LEN_KMER)
            if dup_all is not None:
                for i in maybe_str:
                    n_kmer = int(lens[i]) - LEN_KMER + 1
                    if n_kmer <= MIN_STR_DETECT_LEN \
                            or dup_all[i] > MIN_STR_DETECT_LEN - 1:
                        candidates.add(i)
            else:
                by_len: dict[int, list] = {}
                for i in maybe_str:
                    by_len.setdefault(int(lens[i]), []).append(i)
                for rl, rows_l in by_len.items():
                    n_kmer = rl - LEN_KMER + 1
                    if n_kmer <= MIN_STR_DETECT_LEN or len(rows_l) < 8:
                        candidates.update(rows_l)
                        continue
                    sub = codes_f[np.array(rows_l)][:, :rl].astype(np.uint64)
                    vals = np.zeros((len(rows_l), n_kmer), dtype=np.uint64)
                    for k in range(LEN_KMER):
                        vals |= sub[:, k : k + n_kmer] << np.uint64(2 * (LEN_KMER - 1 - k))
                    sv = np.sort(vals, axis=1)
                    n_dup = (sv[:, 1:] == sv[:, :-1]).sum(axis=1)
                    # reference rule: distinct < n_kmer - 15 <=> dup > 15;
                    # the exact distinct count is n_kmer - adjacent-dups
                    for k, i in enumerate(rows_l):
                        if n_dup[k] > MIN_STR_DETECT_LEN - 1:
                            candidates.add(int(i))
            for i in candidates:
                rl = int(lens[i])
                n_kmer = rl - LEN_KMER + 1
                istr, sl = self.host._detect_str(codes_f[i, :rl])
                is_str[i] = istr
                if sl is not None:
                    pos = np.arange(0, n_kmer, SEED_STEP)
                    seed_mask_f[i, : len(pos)] = (sl > 0)[pos]
                    seed_mask_r[i, : len(pos)] = (sl[::-1] > 0)[pos]

        if not active:
            return dict(states=states, active=active, n=n, n_pad=n_pad,
                        seqs=seqs, oris=oris, front=None,
                        oversize=oversize, aux=aux)

        # ---- pack rows for the device front: fwd rows then rev rows ---
        codes2 = np.concatenate([codes_f, codes_r], axis=0)
        words = pack_reads(codes2)
        lens2 = np.concatenate([lens, lens])
        mask2 = _pack_mask_host(
            np.concatenate([seed_mask_f, seed_mask_r], axis=0))
        act_pad = np.zeros(n_pad, bool)
        act_pad[:n] = act_mask
        active_words = _pack_mask_host(act_pad[None, :]).ravel()
        return dict(states=states, active=active, n=n, n_pad=n_pad,
                    seqs=seqs, oris=oris, oversize=oversize, aux=aux,
                    words=words, lens2=lens2, mask2=mask2,
                    active_words=active_words, S0=S0, L=L,
                    is_str=is_str, codes_f=codes_f, codes_r=codes_r,
                    lens=lens)

    def _dispatch_front(self, prep):
        """Async device-front dispatch for a prepared batch (main thread
        only — dispatches device programs)."""
        cfg = self.cfg
        if "front" in prep:
            return prep  # no active reads (prep already finalized)
        words = prep["words"]
        lens2 = prep["lens2"]
        mask2 = prep["mask2"]
        S0 = prep["S0"]
        L = prep["L"]
        is_str = prep["is_str"]
        # device front (seed+merge+stats) in one dispatch, then device
        # chaining bucketed to the real max seed count
        n_ext = max(9, -(-(L - LEN_KMER) // 16))
        # MEM lanes scale with the seed-position count of the class (the
        # overflow counter tallies hits BEFORE the coverage skip, so M
        # must at least cover one hit per seed position)
        M = max(cfg.mem_slots, (S0 + 1 + 15) // 16 * 16)
        codes_flat = None
        if self.mesh is not None:
            fr = _sharded_front(self.mesh, S0, cfg.max_seeds, M,
                                cfg.front, n_ext, cfg.nf_mult)
            es, stats3_dev = fr(self.didx, words, lens2, mask2)
            chain_spec = None
            is_str2 = None
        else:
            # one explicit transfer of the packed reads, shared by the
            # front and the code-unpack programs
            words_dev = jax.device_put(words)
            is_str2 = np.concatenate([is_str, is_str])
            if cfg.fuse_chain:
                K = self._k_spec
                comp = 0
                if cfg.compact_div > 1 and cfg.front in ("v5", "v6"):
                    # peak-based compaction budget: recent peak active
                    # rows + 40% headroom, 512-quantized (the round-3
                    # power-of-two divisor could not engage at all on
                    # ~45%-active worlds — its grow rule demanded 2x
                    # headroom at the next halving). Hysteresis: a new
                    # cap must repeat _COMPACT_STABLE times before it
                    # applies — each change recompiles the fused front.
                    # Budget overflow clears the window (8 batches of
                    # natural cooldown before re-engaging).
                    aw = self._act_window
                    if len(aw) >= 4:
                        tight = -(-(max(aw) * 7 // 5 + 64) // 512) * 512
                        if tight == self._comp_want:
                            self._comp_want_run += 1
                        else:
                            self._comp_want = tight
                            self._comp_want_run = 1
                        if (self._comp_want_run >= _COMPACT_STABLE
                                and self._comp_cap != tight):
                            self._comp_cap = tight
                    rows = words.shape[0]
                    if self._comp_cap and self._comp_cap <= rows * 7 // 8:
                        # engage only when it saves at least 12.5% of
                        # the rows (each distinct comp is a compile)
                        comp = max(256, min(self._comp_cap, rows))
                if self._use_device_collect():
                    n_pad = prep["n_pad"]
                    NC, NP = self._collect_budgets(n_pad)
                    aw_dev = jax.device_put(prep["active_words"])
                    es, stats3_dev, rid_dev, buf_dev = \
                        _device_front_chain_collect(
                            self.didx, words_dev, lens2, mask2, is_str2,
                            aw_dev, S0=S0, S=cfg.max_seeds, M=M,
                            front=cfg.front, n_ext=n_ext,
                            nf_mult=cfg.nf_mult, K=K, compact=comp,
                            n_pad=n_pad, NC=NC, NP=NP,
                        )
                    chain_spec = ("collect", buf_dev, K, comp, rid_dev,
                                  aw_dev, NC, NP)
                else:
                    es, stats3_dev, rid_dev, buf_dev = _device_front_chain(
                        self.didx, words_dev, lens2, mask2, is_str2, S0=S0,
                        S=cfg.max_seeds, M=M, front=cfg.front, n_ext=n_ext,
                        nf_mult=cfg.nf_mult, K=K,
                        compact=comp,
                    )
                    chain_spec = ("fused", buf_dev, K, comp, rid_dev)
                if getattr(cfg, "chain_copy", "finish") == "dispatch":
                    try:
                        buf_dev.copy_to_host_async()
                    except (AttributeError, TypeError):
                        pass
            else:
                es, stats3_dev = _device_front(
                    self.didx, words_dev, lens2, mask2, S0=S0,
                    S=cfg.max_seeds, M=M, front=cfg.front, n_ext=n_ext,
                    nf_mult=cfg.nf_mult,
                )
                # the chain is dispatched speculatively in _finish_batch
                # (dispatching here would wait on the front's outputs)
                chain_spec = "pending"
            if self._glue_lib is not None:
                # device-resident flat read codes for the meta-driven DP
                # fill (stays on device; consumed by the DP programs)
                codes_flat = _unpack_codes(words_dev, L)
        prep = dict(prep)
        prep.update(front=(es, stats3_dev), chain_spec=chain_spec,
                    is_str2=is_str2, read_class=L, codes_flat=codes_flat)
        for k in ("words", "lens2", "mask2"):
            prep.pop(k, None)
        return prep

    def _use_device_collect(self) -> bool:
        c = getattr(self.cfg, "collect", "auto")
        if c == "host":
            return False
        has = self._glue_lib is not None
        if c == "device":
            if not has:
                raise RuntimeError(
                    "collect='device' needs libpansvr_glue "
                    "(tools/build_native.sh)")
            return True
        return has

    def _collect_budgets(self, n_pad: int) -> tuple[int, int]:
        m = getattr(self.cfg, "collect_mult", 1)
        return m * n_pad, 2 * m * n_pad

    def _finish_batch(self, pend, on_dp_dispatched=None):
        """One-shot finish: front phase (chain fetch, collect, DP
        dispatch) + DP phase (DP fetch, replay, emit). align_stream
        with stream_depth >= 2 calls the two phases a batch apart so
        the DP wait of batch N hides behind batch N+1's device front."""
        self._finish_front(pend, on_dp_dispatched)
        return self._finish_dp(pend)

    def _finish_front(self, pend, on_dp_dispatched=None) -> None:
        cfg = self.cfg
        states = pend["states"]
        active = pend["active"]
        n = pend["n"]
        n_pad = pend["n_pad"]
        seqs = pend["seqs"]
        # out-of-class reads deferred by _prep_batch (exact host path)
        t = time.perf_counter()
        for i in pend.get("oversize", ()):
            states[i] = self.host.align_read(seqs[i], self._ori_obj(pend, i))
        if pend.get("oversize"):
            self.prof["host_fallback"] += time.perf_counter() - t
        if pend["front"] is None:
            if on_dp_dispatched is not None:
                on_dp_dispatched()
            pend["dp"] = ("none",)
            return
        es, stats3_dev = pend["front"]
        is_str = pend["is_str"]
        cs = pend.get("chain_spec")
        comp = 0
        rid_dev = None
        collect_data = None
        kind = "pending"
        if cs is not None:
            # single-device path: chain speculated at the previous
            # batch's K; its results (+ the front stats) arrive in ONE
            # fused buffer — one device-to-host copy per batch. With
            # fuse_chain the buffer comes from the submit-time program;
            # otherwise dispatch the chain now
            t = time.perf_counter()
            kind = cs[0] if isinstance(cs, tuple) else "pending"
            aw_dev = NC = NP = None
            if isinstance(cs, tuple):
                if kind == "collect":
                    _, buf_dev, K, comp, rid_dev, aw_dev, NC, NP = cs
                else:
                    _, buf_dev, K, comp, rid_dev = cs
                try:
                    # start the host copy before blocking (issued here,
                    # AFTER the previous batch's DP results were fetched,
                    # so it cannot delay them in the copy queue)
                    buf_dev.copy_to_host_async()
                except (AttributeError, TypeError):
                    pass
            else:
                K = self._k_spec
                buf_dev = _chain_body_fused(stats3_dev, es,
                                            pend["is_str2"], K=K)
            buf = np.asarray(buf_dev)
            self.prof["sync_chain"] += time.perf_counter() - t
            B2 = 2 * n_pad
            if kind == "collect":
                stats3, c_over, c_scal, chain_meta, path_a, path_b, \
                    path_dfe = _collect_unpack(buf, B2, K, n_pad, NC, NP,
                                               comp)
                collect_data = True
                s_fb = p16 = pre = hits8 = hit_score = None
            else:
                stats3, s_fb, p16, pre, hits8, hit_score = _chain_unpack(
                    buf, B2, K, comp)
            overflow, dropped, seed_count = stats3
            kmax = int(seed_count.max()) if len(seed_count) else 0
            # adapt the speculative width with hysteresis: grow at once
            # (a miss costs a full-width re-chain), but shrink only one
            # bucket after 8 consecutive narrower batches — with
            # fuse_chain, K is a static arg of the whole front program,
            # so an oscillating width would churn expensive retraces
            # 32 = device chain hard cap (uint32 ancestor bitmasks in
            # chain_extract_batch); rows with more seeds take the host
            # path below
            bucket = min(
                cfg.max_seeds, 32,
                max(8, 1 << max(kmax - 1, 0).bit_length()))
            if bucket > self._k_spec:
                self._k_spec = bucket
                self._k_shrink_run = 0
            elif bucket < self._k_spec:
                self._k_shrink_run += 1
                if self._k_shrink_run >= 8:
                    self._k_spec = max(bucket, self._k_spec // 2)
                    self._k_shrink_run = 0
            else:
                self._k_shrink_run = 0
            if kmax > K and K < 32:
                # speculation missed (a row has more seeds than the
                # chained width): re-chain at full width. Clamp to the
                # es the FRONT actually produced — a retier may have
                # widened cfg.max_seeds after this batch was dispatched
                # (jnp slicing would silently clamp and the buffer
                # would unpack at the wrong K) — and to the 32-node
                # device chain cap
                K = min(cfg.max_seeds, int(es.read_begin.shape[1]), 32)
                t = time.perf_counter()
                if kind == "collect":
                    buf_dev = _collect_fused(
                        stats3_dev, es, pend["is_str2"], K=K, rid=rid_dev,
                        active_words=aw_dev, n_pad=n_pad, NC=NC, NP=NP)
                    buf = np.asarray(buf_dev)
                    self.prof["sync_chain"] += time.perf_counter() - t
                    _, c_over, c_scal, chain_meta, path_a, path_b, \
                        path_dfe = _collect_unpack(buf, B2, K, n_pad, NC,
                                                   NP, comp)
                else:
                    buf_dev = _chain_body_fused(
                        stats3_dev, es, pend["is_str2"], K=K, rid=rid_dev)
                    buf = np.asarray(buf_dev)
                    self.prof["sync_chain"] += time.perf_counter() - t
                    _, s_fb, p16, pre, hits8, hit_score = _chain_unpack(
                        buf, B2, K, comp)
        else:
            t = time.perf_counter()
            stats3 = np.asarray(stats3_dev)
            self.prof["sync_front"] += time.perf_counter() - t
            overflow, dropped, seed_count = stats3
            kmax = int(seed_count.max()) if len(seed_count) else 0
            K = min(cfg.max_seeds, 32,
                    max(8, 1 << max(kmax - 1, 0).bit_length()))
            is_str2 = np.concatenate([is_str, is_str])
            # seeds are compacted to the front of the S axis, so [:, :K]
            # keeps every valid seed
            t = time.perf_counter()
            chain_fn = _sharded_chain(self.mesh)
            p32_dev, p16_dev, p8_dev, hits8_dev, hscore_dev = chain_fn(
                es.read_begin[:, :K], es.read_end[:, :K],
                es.ref_begin[:, :K], es.ref_end[:, :K], es.cov[:, :K],
                es.seed_id[:, :K], es.valid[:, :K], is_str2,
            )
            s_fb = np.asarray(p32_dev)
            p16 = np.asarray(p16_dev)
            pre = np.asarray(p8_dev)
            hits8 = np.asarray(hits8_dev)
            hit_score = np.asarray(hscore_dev)
            self.prof["sync_chain"] += time.perf_counter() - t

        fallback = set(int(r) % n_pad for r in np.nonzero(overflow > 0)[0])
        fallback |= set(int(r) % n_pad for r in np.nonzero(dropped > 0)[0])
        # rows past the 32-node device chain cap (uint32 ancestor masks):
        # exact host path, permanently — no widening can fix them
        seed32 = set(int(r) % n_pad for r in np.nonzero(seed_count > 32)[0])
        n_seed32 = len(seed32 - fallback)
        fallback |= seed32
        # ---- batch retry on mass overflow ------------------------------
        # A workload shift (e.g. chromosome-scale signal where ~every
        # read is on-target with ~S0 hit lanes) can overflow the lane
        # budgets for MOST of a batch at once. Host-aligning thousands
        # of reads in Python is the round-4 death spiral (839 s and a
        # 0-byte BAM at chrom scale); instead, widen the SPECIFIC budget
        # that overflowed and re-dispatch this same batch on device —
        # one recompile per growth step, a handful per workload.
        if (len(fallback) - n_seed32 > max(64, len(active) // 8)
                and pend.get("retry", 0) < 4 and cs is not None):
            widened = False
            flat_n = int(((overflow & FLAT_OVERFLOW) != 0).sum())
            m_over = int(((overflow & (FLAT_OVERFLOW - 1)) > 0).sum())
            drop_n = int((dropped > 0).sum())
            if flat_n and cfg.nf_mult < 64:
                cfg.nf_mult = min(64, cfg.nf_mult * 2)
                widened = True
            if (m_over or drop_n) and cfg.mem_slots < cfg.retier_max:
                cfg.mem_slots = min(cfg.mem_slots * 2, cfg.retier_max)
                cfg.max_seeds = min(cfg.max_seeds * 2, cfg.retier_max)
                cfg.chain_bucket = min(cfg.chain_bucket * 2,
                                       cfg.retier_max)
                widened = True
            budget_n = int(((overflow & BUDGET_OVERFLOW) != 0).sum())
            if not widened and budget_n and self._comp_cap:
                # mass compaction-budget overflow: disable compaction
                # and retry uncompacted
                self._act_window.clear()
                self._comp_cap = 0
                self._comp_want = 0
                self._comp_want_run = 0
                widened = True
            if widened:
                import sys as _sys

                print(
                    f"[pansvr engine] {len(fallback)} reads over lane "
                    f"budgets (flat={flat_n} M/S={m_over}/{drop_n}): "
                    f"widening to (M,S,K,nf)=({cfg.mem_slots}, "
                    f"{cfg.max_seeds}, {cfg.chain_bucket}, {cfg.nf_mult})"
                    " and re-dispatching the batch", file=_sys.stderr)
                self._k_spec = min(self._k_spec, cfg.max_seeds)
                pend2 = self._dispatch_front(self._prep_batch(
                    pend["seqs"], pend["oris"], pend.get("aux")))
                pend2["retry"] = pend.get("retry", 0) + 1
                pend.clear()
                pend.update(pend2)
                self._finish_front(pend, on_dp_dispatched)
                return
        n_collect_over = 0
        if collect_data is not None:
            # reads whose chains/paths missed the device-collect lane
            # budgets: exact host path now, wider budgets next compile
            co_reads = set(int(r) for r in np.nonzero(c_over)[0])
            n_collect_over = len(co_reads - fallback)
            if (n_collect_over > max(64, len(active) // 8)
                    and pend.get("retry", 0) < 4
                    and getattr(cfg, "collect_mult", 1) < 16):
                # mass collect overflow: grow the budgets from the TRUE
                # demand and re-dispatch the batch (host-aligning
                # thousands of reads would stall the stream)
                need = max(
                    -(-int(c_scal[1]) // n_pad),
                    -(-int(c_scal[3]) // (2 * n_pad)),
                    cfg.collect_mult + 1,
                )
                cfg.collect_mult = min(
                    16, max(1 << (need - 1).bit_length(),
                            cfg.collect_mult * 2))
                import sys as _sys

                print(
                    f"[pansvr engine] {n_collect_over} reads over the "
                    f"collect budgets: collect_mult -> "
                    f"{cfg.collect_mult}, re-dispatching the batch",
                    file=_sys.stderr)
                pend2 = self._dispatch_front(self._prep_batch(
                    pend["seqs"], pend["oris"], pend.get("aux")))
                pend2["retry"] = pend.get("retry", 0) + 1
                pend.clear()
                pend.update(pend2)
                self._finish_front(pend, on_dp_dispatched)
                return
            fallback |= co_reads
            if n_collect_over and getattr(cfg, "collect_mult", 1) < 16:
                # size the next compile's budgets from the TRUE demand
                # the device reported (c_scal carries unclipped totals)
                need = max(
                    -(-int(c_scal[1]) // n_pad),
                    -(-int(c_scal[3]) // (2 * n_pad)),
                    cfg.collect_mult + 1,
                )
                new_mult = 1 << (need - 1).bit_length()
                new_mult = min(16, max(new_mult, cfg.collect_mult * 2))
                cfg.collect_mult = new_mult
                import sys as _sys

                print(
                    f"[pansvr engine] device-collect budgets overflowed "
                    f"for {n_collect_over} reads: collect_mult -> "
                    f"{cfg.collect_mult} (one-time recompile)",
                    file=_sys.stderr)
        pend["fallback"] = fallback
        t = time.perf_counter()
        for i in list(fallback):
            if i < n and i in active:
                states[i] = self.host.align_read(seqs[i], self._ori_obj(pend, i))
                active.remove(i)
        self.prof["host_fallback"] += time.perf_counter() - t
        self.prof["n_fallback"] += len(fallback)
        self.prof["n_reads"] += n
        # ---- adapt the active-row compaction divisor -------------------
        # (budget-overflow fallbacks are correct-but-slow and say nothing
        # about the M/S/K shape caps, so they stay out of the retier
        # window and the degradation warning)
        nb = int(((stats3[0] & BUDGET_OVERFLOW) != 0).sum()) if comp else 0
        nb_reads = len({int(r) % n_pad for r in
                        np.nonzero(stats3[0] & BUDGET_OVERFLOW)[0]}) \
            if nb else 0
        self.prof["n_budget_fallback"] += nb_reads
        if getattr(cfg, "compact_div", 4) > 1 and cs is not None \
                and cfg.fuse_chain:
            act = int(((stats3[2] > 0) | (stats3[0] > 0)).sum())
            if nb > 0:
                # budget overflow: drop the cap and clear the window —
                # re-engaging needs 8 fresh batches (natural cooldown
                # against compile thrash)
                self._act_window.clear()
                self._comp_cap = 0
                self._comp_want = 0
                self._comp_want_run = 0
            else:
                self._act_window.append(act)
        # collect-budget overflows are lane-pool sizing, not M/S/K shape
        # pressure — keep them out of the retier signal like the
        # compaction-budget ones
        self._tier_window.append(
            (max(len(fallback) - nb_reads - n_collect_over - n_seed32, 0),
             n))
        self._maybe_retier()
        # telemetry threshold: a high fallback rate means the static
        # shape caps (M/S/K) are undersized for this workload — the
        # device path silently degrades to host speed, so say so once
        nr = self.prof["n_reads"]
        n_hard_fb = self.prof["n_fallback"] - self.prof["n_budget_fallback"]
        if (not self._fallback_warned and nr >= 4096
                and n_hard_fb > 0.05 * nr):
            self._fallback_warned = True
            import sys as _sys

            print(
                f"[pansvr engine] WARNING: {int(self.prof['n_fallback'])}"
                f"/{int(nr)} reads ({100 * self.prof['n_fallback'] / nr:.1f}%)"
                " took the host fallback path (seed-slot overflow/drops)."
                " Throughput will degrade; consider raising"
                " EngineConfig.mem_slots / max_seeds for this workload.",
                file=_sys.stderr,
            )

        if on_dp_dispatched is not None and cfg.pipe_order == "early":
            # "early" pipelining: queue the NEXT batch's device front
            # right behind this batch's (small) chain program, so the
            # device chews through it while this batch's
            # host_collect/replay run. This batch's DP lands behind the
            # next front in the FIFO — per-batch sync_dp grows, but the
            # device never idles. "late" (default) queues it after this
            # batch's DP instead.
            on_dp_dispatched()
            on_dp_dispatched = None
        if collect_data is not None:
            # device-collect path: selection + path gather already ran on
            # device; mark host-fallback reads' chains with the skip bit
            # so C++ doesn't also produce results for them, then walk the
            # compacted lanes
            t = time.perf_counter()
            n_chains = int(c_scal[0])
            n_nodes = int(c_scal[2])
            chain_meta = chain_meta[:n_chains]
            if fallback and n_chains:
                chain_meta = chain_meta.copy()  # fetched buffer is RO
                m0 = chain_meta[:, 0]
                fb_arr = np.fromiter(fallback, np.int32, len(fallback))
                bad = (m0 >= 0) & np.isin(m0 & 0x7FFF, fb_arr)
                chain_meta[:, 0] = np.where(bad, m0 | (1 << 24), m0)
            gb = native_glue.GlueBatch.from_paths(
                self._glue_lib, n_pad=n_pad, L=pend["codes_f"].shape[1],
                chain_meta=chain_meta,
                path_a=path_a[:n_nodes], path_b=path_b[:n_nodes],
                path_dfe=path_dfe[:n_nodes],
                codes_f=pend["codes_f"], codes_r=pend["codes_r"],
                lens=pend["lens"], packed_ref=self._packed_ref,
                chr_starts=self._chr_starts64, sv_st_pos=self._sv_st_pos,
                params=self.p,
            )
            self.prof["host_collect"] += time.perf_counter() - t
            self.prof["n_dp_req"] += gb.n_req
            self._dispatch_dp_from_gb(pend, gb, on_dp_dispatched)
            return
        if self._glue_lib is not None:
            self._dispatch_native_dp(
                pend, states, active, n_pad, s_fb, p16, pre, hits8,
                hit_score, on_dp_dispatched)
            return
        s_rb, s_re, s_dfe = p16
        s_fe = s_fb + s_dfe
        hit_idx, hit_final = hits8
        nv = seed_count

        # ---- per-read chain extraction + walk (collect pass) ----------
        handlers: dict[int, _CollectDP] = {}
        pending: list[tuple[int, AlnResult, chain_ref.ChainGraph, int, int]] = []

        t = time.perf_counter()
        for i in active:
            results: list[AlnResult] = []
            meta = []
            max_chain_score = 0
            for d, row in ((FORWARD, i), (REVERSE, i + n_pad)):
                if hit_idx[row, 0] < 0:
                    continue
                k = int(nv[row])
                # dist/cov are not read by the scoring walk (only the
                # hit list and pre-pointers are) — zero placeholders
                g = chain_ref.ChainGraph(
                    read_begin=s_rb[row][:k], read_end=s_re[row][:k],
                    ref_begin=s_fb[row][:k], ref_end=s_fe[row][:k],
                    cov=np.zeros(k, np.int64), seed_id=np.zeros(k, np.int64),
                    dist=np.zeros(k, np.float64),
                    pre=pre[row][:k].astype(np.int64),
                )
                # hits come pre-extracted from the device (sort_output
                # semantics in ops/chain.chain_extract_batch); the break
                # rules replay the sequential loop exactly
                for s in range(hit_idx.shape[1]):
                    hi = int(hit_idx[row, s])
                    if hi < 0:
                        break
                    cs = int(hit_score[row, s])
                    max_chain_score = max(max_chain_score, cs)
                    if cs + MAX_CHAIN_SCORE_DIFF < max_chain_score or cs < MIN_CHAIN_SCORE_LOOP:
                        break
                    fin = int(hit_final[row, s])
                    ref_begin0 = int(s_fb[row][fin])
                    r = AlnResult(chain_score=cs, direction=d,
                                  read_bg=int(s_rb[row][fin]))
                    cid = self.idx.chr_of_pos(ref_begin0)
                    r.chr_id = cid
                    r.ref_bg = ref_begin0 - int(self.idx.chr_starts[cid])
                    results.append(r)
                    meta.append((g, hi))
            if not results or max_chain_score < MIN_CHAIN_SCORE:
                continue
            idxs = sorted(range(len(results)),
                          key=lambda j: (-results[j].chain_score, meta[j][1]))
            results = [results[j] for j in idxs]
            meta = [meta[j] for j in idxs]
            h = _CollectDP(self.idx, self.p)
            handlers[i] = h
            for r, (g, mi) in zip(results, meta):
                if r.chain_score + MAX_CHAIN_SCORE_DIFF < max_chain_score:
                    break
                pending.append((i, r, g, mi, max_chain_score))
                codes = states[i].read_codes_rev if r.direction == REVERSE \
                    else states[i].read_codes_fwd
                self._walk(h, g, mi, codes)  # collect DP requests

        self.prof["host_collect"] += time.perf_counter() - t

        # ---- batched DP ------------------------------------------------
        t = time.perf_counter()
        dp_handles = self._dispatch_dp_batch(handlers,
                                             pend.get("read_class", 160))
        self.prof["dp_dispatch"] += time.perf_counter() - t
        if on_dp_dispatched is not None:
            # pipelining hook: the next batch's device front is queued HERE,
            # after this batch's DP — so the device FIFO never stalls this
            # batch's programs behind the next batch's
            on_dp_dispatched()
        pend["dp"] = ("python", handlers, pending, dp_handles)

    def _finish_dp(self, pend):
        """DP phase: fetch this batch's DP results, replay, emit."""
        kind = pend.pop("dp")
        states = pend["states"]
        if kind[0] == "none":
            if self._emit_ctx is not None and pend.get("aux") is not None:
                return self._emit_tail(pend, states, None)
            return states
        if kind[0] == "native":
            return self._finish_native_dp(pend, *kind[1:])
        _, handlers, pending, dp_handles = kind
        t = time.perf_counter()
        responses_per_read = self._sync_dp_batch(dp_handles)
        self.prof["sync_dp"] += time.perf_counter() - t

        # ---- replay pass: final scores + cigars ------------------------
        t = time.perf_counter()
        per_read_pending: dict[int, list] = {}
        for item in pending:
            per_read_pending.setdefault(item[0], []).append(item)
        for i, items in per_read_pending.items():
            st = states[i]
            h = handlers[i]
            h.start_replay(responses_per_read.get(i, []))
            kept = []
            for (_, r, g, mi, mcs) in items:
                codes = st.read_codes_rev if r.direction == REVERSE else st.read_codes_fwd
                rba, score, cigar_tmp = self._walk(h, g, mi, codes)
                r.ref_bg -= rba
                r.align_score = max(score, 0)
                cig = reverse_merge_cigar(cigar_tmp, len(codes))
                r.cigar = cig or []
                kept.append(r)
            kept.sort(key=lambda r: -r.align_score)
            if not kept or kept[0].align_score < MIN_ALN_SCORE:
                continue
            for j, r in enumerate(kept):
                r.sv_id = r.chr_id
                info = self.sv_info[r.sv_id]
                r.chr_id = -1
                r.ref_bg += info.st_pos - 1
                r.is_ori = False
                r.rst_idx = j
                r.mapq = 0
            kept[0].mapq = min(
                40, kept[0].align_score - (kept[1].align_score if len(kept) > 1 else 0)
            )
            st.results = kept
        self.prof["host_replay"] += time.perf_counter() - t
        return states

    # ------------------------------------------------------------------
    def _dispatch_native_dp(self, pend, states, active, n_pad, s_fb, p16,
                            pre, hits8, hit_score, on_dp_dispatched):
        """Native-glue front phase: the C++ module runs the collect
        walk, we dispatch its DP requests through the device size
        classes (async copies issued); _finish_native_dp then syncs,
        replays and ranks. Bit-identical to the Python path (tested)."""
        cfg = self.cfg
        seqs = pend["seqs"]
        read_class = pend.get("read_class", 160)
        L = pend["codes_f"].shape[1]
        K = s_fb.shape[1]
        active_mask = np.zeros(n_pad, np.uint8)
        if active:
            active_mask[np.array(sorted(active), np.int64)] = 1

        t = time.perf_counter()
        gb = native_glue.GlueBatch(
            self._glue_lib, n_pad=n_pad, L=L, K=K,
            s_rb=p16[0], s_re=p16[1], s_fb=np.ascontiguousarray(s_fb),
            s_dfe=p16[2], pre=np.ascontiguousarray(pre),
            hit_idx=hits8[0], hit_score=np.ascontiguousarray(hit_score),
            hit_final=hits8[1],
            codes_f=pend["codes_f"], codes_r=pend["codes_r"],
            lens=pend["lens"], active_mask=active_mask,
            packed_ref=self._packed_ref, chr_starts=self._chr_starts64,
            sv_st_pos=self._sv_st_pos, params=self.p,
        )
        self.prof["host_collect"] += time.perf_counter() - t
        self.prof["n_dp_req"] += gb.n_req
        self._dispatch_dp_from_gb(pend, gb, on_dp_dispatched)

    def _dispatch_dp_from_gb(self, pend, gb, on_dp_dispatched):
        """DP dispatch over size classes from a built GlueBatch (shared
        by the host-collect and device-collect paths)."""
        cfg = self.cfg
        read_class = pend.get("read_class", 160)

        # ---- DP dispatch over size classes -----------------------------
        t = time.perf_counter()
        dp_q, dp_t = cfg.dp_class(read_class)
        # (48, 64) first: the realigner's DP segments are chain-gap
        # repairs, mostly tiny (84.5% of the bench world's fit 48x64,
        # median 14x29), and the scan's work per problem is
        # (cq + ct - 1) diagonals x ct lanes — ~4x less for (48, 64) than
        # for (96, 128). Each class runs full-quantum chunks, then its
        # residue at a quarter of the quantum: two compiled shapes per
        # class bound the compile count.
        classes = [(48, 64, cfg.dp_chunk),
                   (96, 128, max(cfg.dp_chunk // 4, 128)),
                   (dp_q, dp_t, max(cfg.dp_chunk // 16, 128))]
        classes = [c for c in classes[:-1]
                   if c[0] < dp_q and c[1] < dp_t] + [classes[-1]]
        ql_all, tl_all = gb.req_sizes()
        assigned = np.full(gb.n_req, -1, np.int32)
        for ci, (cq, ct, _) in enumerate(classes):
            m = (assigned < 0) & (ql_all <= cq) & (tl_all <= ct)
            assigned[m] = ci
        # meta-driven device fill: ship 5 int32 per request and build the
        # code matrices on device from the resident reads + reference
        # (the qc/tc transfer otherwise costs ~2 MB per chunk).
        # Unavailable on the mesh path.
        codes_flat = pend.get("codes_flat")
        meta5 = gb.req_meta() \
            if codes_flat is not None and self.mesh is None else None
        chunks = []
        for ci, (cq, ct, CHUNK) in enumerate(classes):
            members = np.nonzero(assigned == ci)[0].astype(np.int32)
            small = max(CHUNK // 4, 128)
            bounds = []
            c0 = 0
            while len(members) - c0 >= CHUNK:
                bounds.append((c0, CHUNK))
                c0 += CHUNK
            while c0 < len(members):
                bounds.append((c0, small))
                c0 += small
            for c0, CHUNK in bounds:
                mem = members[c0 : c0 + CHUNK]
                if meta5 is not None:
                    pad = CHUNK - len(mem)

                    def pm(row, fill=0):
                        return np.concatenate(
                            [row[mem], np.full(pad, fill, np.int32)])

                    qb, qa = pm(meta5[0]), pm(meta5[1], 1)
                    rs, tl_m = pm(meta5[2]), pm(meta5[3], 1)
                    rv = pm(meta5[4])
                    buf_dev = _device_dp_meta(
                        codes_flat, self.didx.ref_words, qb, qa, rs,
                        tl_m, rv, self._tru_ref_len,
                        params=self.dp_params, cq=cq, ct=ct)
                    chunks.append((mem, ("fused", buf_dev, CHUNK)))
                    continue
                qc, ql, tc, tl = gb.fill_dp(mem, cq, ct, CHUNK)
                chunks.append((mem, self._dispatch_dp_codes(qc, ql, tc, tl)))
        big = np.nonzero(assigned < 0)[0]
        # start all chunk copies before anything else is enqueued (each
        # np.asarray would otherwise wait for its own copy in turn, and
        # copies issued after the next batch's front dispatch would queue
        # behind its compute)
        for _, payload in chunks:
            for arr in payload[1:]:
                if hasattr(arr, "copy_to_host_async"):
                    arr.copy_to_host_async()
        self.prof["n_dp_chunks"] += len(chunks)
        self.prof["dp_dispatch"] += time.perf_counter() - t
        if on_dp_dispatched is not None:
            on_dp_dispatched()
        pend["dp"] = ("native", gb, chunks, big, ql_all, tl_all)

    def _finish_native_dp(self, pend, gb, chunks, big, ql_all, tl_all):
        states = pend["states"]
        t = time.perf_counter()
        for k in big:
            qc, ql, tc, tl = gb.fill_dp(
                np.array([k], np.int32), int(ql_all[k]), int(tl_all[k]), 1)
            ez = self._scalar_dp(qc[0, : ql[0]], tc[0, : tl[0]])
            gb.set_dp_scalar(int(k), ez)
        t2 = time.perf_counter()
        self.prof["dp_big"] += t2 - t
        self.prof["n_dp_big"] += len(big)
        t_dec = 0.0
        for mem, payload in chunks:
            if payload[0] == "fused":
                raw = np.asarray(payload[1])
                td = time.perf_counter()
                ops, packed = _dp_unpack(raw, payload[2])
            else:
                ops = np.asarray(payload[1])
                packed = np.asarray(payload[2])
                td = time.perf_counter()
            gb.set_dp_chunk(mem, ops[: len(mem)], packed[:, : len(mem)])
            t_dec += time.perf_counter() - td
        self.prof["dp_decode"] += t_dec
        self.prof["sync_dp"] += time.perf_counter() - t

        # ---- replay + result objects -----------------------------------
        t = time.perf_counter()
        if self._emit_ctx is not None and pend.get("aux") is not None:
            # native tail: PE-pair + BAM-encode inside the glue, straight
            # from the ctx result vectors (no Python result objects);
            # the copied arrays only materialize results for reads that
            # share a pair with a host-path read
            res = gb.replay()
            blob = self._emit_tail(pend, states, gb, res)
            gb.free()
            self.prof["host_replay"] += time.perf_counter() - t
            return blob
        res_read, rf, cig_op, cig_len, cig_off, cig_n = gb.replay()
        gb.free()
        OPS = "MID"
        for x in range(len(res_read)):
            i = int(res_read[x])
            o = int(cig_off[x])
            c = int(cig_n[x])
            r = AlnResult(
                align_score=int(rf[x, 2]), chain_score=int(rf[x, 1]),
                read_bg=int(rf[x, 3]), mapq=int(rf[x, 6]), chr_id=-1,
                ref_bg=int(rf[x, 4]), direction=int(rf[x, 0]),
                is_ori=False, sv_id=int(rf[x, 5]), rst_idx=int(rf[x, 7]),
                cigar=[(OPS[cig_op[o + j]], int(cig_len[o + j]))
                       for j in range(c)],
            )
            states[i].results.append(r)
        self.prof["host_replay"] += time.perf_counter() - t
        return states

    # ------------------------------------------------------------------
    @staticmethod
    def _ori_obj(pend, i) -> OriResult:
        """OriResult for read i, materialized from the packed ori matrix
        when the batch came through the native comment parser."""
        oris = pend["oris"]
        if isinstance(oris, np.ndarray):
            r = oris[i]
            return OriResult(
                chr_id=int(r[0]), ref_bg=int(r[1]), read_bg=int(r[2]),
                align_score=int(r[3]), mapq=int(r[4]),
                direction=int(r[5]), unmapped=bool(r[6]))
        return oris[i]

    # ------------------------------------------------------------------
    def _emit_tail(self, pend, states, gb, res=None) -> bytes:
        """Batch -> encoded BAM record blob. Pairs whose reads took the
        host path (oversize/fallback: their results live in Python
        states, not the glue ctx) are PE-paired and encoded here and
        spliced in pair order by glue_pe_emit; everything else is paired
        and encoded in C++."""
        from ..io.bam import _encode_record
        from .bam_out import emit_pair

        ec = self._emit_ctx
        names, quals, comments = pend["aux"]
        seqs = pend["seqs"]
        oris = pend["oris"]
        n = pend["n"] // 2 * 2
        n_pairs = n // 2
        ori8 = np.zeros((max(n, 1), 8), np.int32)
        if isinstance(oris, np.ndarray):
            ori8[:n] = oris[:n]
            # col 6 carries st.ori_unmapped (raw flag OR chr_id > 24)
            ori8[:n, 6] = ((oris[:n, 6] == 1)
                           | (oris[:n, 0] > 24)).astype(np.int32)
            ori8[:n, 7] = 0
        else:
            for i in range(n):
                o = oris[i]
                row = ori8[i]
                row[0] = o.chr_id
                row[1] = o.ref_bg
                row[2] = o.read_bg
                row[3] = o.align_score
                row[4] = o.mapq
                row[5] = o.direction
                row[6] = 1 if states[i].ori_unmapped else 0
        def fill_from_ctx(i):
            """Materialize read i's device results from the replay copy
            (a host-path mate needs them for the Python pairing)."""
            if res is None:
                return
            res_read, rf, cig_op, cig_len, cig_off, cig_n = res
            lo = int(np.searchsorted(res_read, i))
            hi = int(np.searchsorted(res_read, i + 1))
            OPS = "MID"
            for x in range(lo, hi):
                o = int(cig_off[x])
                states[i].results.append(AlnResult(
                    align_score=int(rf[x, 2]), chain_score=int(rf[x, 1]),
                    read_bg=int(rf[x, 3]), mapq=int(rf[x, 6]), chr_id=-1,
                    ref_bg=int(rf[x, 4]), direction=int(rf[x, 0]),
                    is_ori=False, sv_id=int(rf[x, 5]),
                    rst_idx=int(rf[x, 7]),
                    cigar=[(OPS[cig_op[o + j]], int(cig_len[o + j]))
                           for j in range(int(cig_n[x]))]))

        host_reads = set(pend.get("oversize", ()))
        host_reads.update(pend.get("fallback", ()))
        skip_parts: dict[int, bytes] = {}
        for p in range(n_pairs):
            k = 2 * p
            if k in host_reads or k + 1 in host_reads:
                ori8[k, 7] = ori8[k + 1, 7] = 1
                for i in (k, k + 1):
                    if i not in host_reads and not states[i].results:
                        fill_from_ctx(i)
                    if states[i].ori is None:   # packed-ori batch
                        states[i].ori = self._ori_obj(pend, i)
                pr = self._emit_pe.pair(states[k], states[k + 1])
                if not pr.gain_better:
                    continue
                recs = emit_pair(
                    self.host, pr, states[k], states[k + 1], names[k],
                    seqs[k], quals[k], seqs[k + 1], quals[k + 1],
                    comments[k], comments[k + 1], ec.header)
                part = b"".join(_encode_record(r) for r in recs)
                if part:
                    skip_parts[p] = part
        if gb is None:
            # no native ctx this batch (no device-active reads): pairs
            # without host results have ori-only candidates and emit
            # nothing, exactly like the C++ pass would
            return b"".join(skip_parts.get(p, b"") for p in range(n_pairs))
        skip_off = np.zeros(n_pairs + 1, np.int64)
        if skip_parts:
            parts = [skip_parts.get(p, b"") for p in range(n_pairs)]
            np.cumsum([len(b) for b in parts], out=skip_off[1:])
            skip_blob = np.frombuffer(b"".join(parts), np.uint8).copy()
        else:
            skip_blob = np.zeros(1, np.uint8)

        def blob(strs):
            off = np.zeros(len(strs) + 1, np.int64)
            if strs:
                np.cumsum([len(s) for s in strs], out=off[1:])
            data = np.frombuffer(
                "".join(strs).encode() or b"\0", np.uint8)
            return data, off

        name_blob, name_off = blob(names[:n])
        seq_blob, seq_off = blob(seqs[:n])
        qual_blob, qual_off = blob(quals[:n])
        comment_blob, comment_off = blob(comments[:n])
        return gb.pe_emit(n, ori8, name_blob, name_off, seq_blob, seq_off,
                          qual_blob, qual_off, comment_blob, comment_off,
                          ec, skip_blob, skip_off)

    # ------------------------------------------------------------------
    def _walk(self, ksw: _CollectDP, g: chain_ref.ChainGraph, max_index: int,
              read_codes: np.ndarray):
        """The get_ksw_score walk, shared with HostAligner._score_chain
        (duplicated here to keep walk state per handler mode)."""
        al = self.host
        # reuse HostAligner logic but with the collecting handler
        saved = al.ksw
        al.ksw = ksw
        try:
            return al._score_chain(g, max_index, read_codes)
        finally:
            al.ksw = saved

    def _dispatch_dp_batch(self, handlers: dict[int, "_CollectDP"],
                           read_class: int = 160):
        """Dispatch all collected DP requests (fixed-size chunks) without
        synchronizing; returns handles for _sync_dp_batch. Oversize
        segments fall back to the scalar reference kernel at sync time.

        Requests are bucketed into DP size classes: most inter-MEM gaps
        are small (measured mean (55, 85) on the bench world), so the
        (48, 64) and (96, 128) classes take nearly all of them and the
        full (dp_q, dp_t) class stays as the overflow tier. Every class
        reproduces the scalar kernel bit-for-bit."""
        cfg = self.cfg
        dp_q, dp_t = cfg.dp_class(read_class)
        reqs = []
        owners = []
        for i, h in handlers.items():
            for j, (q, t) in enumerate(h.requests):
                reqs.append((q, t))
                owners.append((i, j))
        responses: dict[int, list] = {
            i: [None] * len(h.requests) for i, h in handlers.items()
        }
        handles = dict(responses=responses, reqs=reqs, owners=owners,
                       chunks=[], big=[])
        if not reqs:
            return handles
        classes = [(48, 64, cfg.dp_chunk),
                   (96, 128, cfg.dp_chunk),
                   (dp_q, dp_t, max(cfg.dp_chunk // 4, 128))]
        classes = [c for c in classes[:-1]
                   if c[0] < dp_q and c[1] < dp_t] + [classes[-1]]
        by_class: list[list[int]] = [[] for _ in classes]
        big = []
        for k, (q, t) in enumerate(reqs):
            for ci, (cq, ct, _) in enumerate(classes):
                if len(q) <= cq and len(t) <= ct:
                    by_class[ci].append(k)
                    break
            else:
                big.append(k)
        handles["big"] = big

        # fixed-size DP chunks: ONE compiled shape per class for the
        # DP+traceback programs regardless of how many segments a batch
        # produced
        for (cq, ct, CHUNK), members in zip(classes, by_class):
            for c0 in range(0, len(members), CHUNK):
                chunk = members[c0 : c0 + CHUNK]
                B = CHUNK
                qc = np.zeros((B, cq), np.int32)
                tc = np.zeros((B, ct), np.int32)
                ql = np.ones(B, np.int32)
                tl = np.ones(B, np.int32)
                for bi, k in enumerate(chunk):
                    q, t = reqs[k]
                    qc[bi, : len(q)] = q
                    tc[bi, : len(t)] = t
                    ql[bi] = len(q)
                    tl[bi] = len(t)
                handles["chunks"].append(
                    (chunk, self._dispatch_dp_codes(qc, ql, tc, tl)))
        return handles

    def _dispatch_dp_codes(self, qc, ql, tc, tl):
        """One DP chunk from host code matrices: sharded over the mesh
        when there is one, else the fused single-device program. Returns
        a ("pair", ops, packed) or ("fused", buf, rows) chunk payload."""
        K = qc.shape[1] + tc.shape[1]
        if self.mesh is not None:
            ops_dev, packed_dev = _sharded_dp(self.mesh, self.dp_params,
                                              K)(qc, ql, tc, tl)
            return ("pair", ops_dev, packed_dev)
        return ("fused", _device_dp(qc, ql, tc, tl, params=self.dp_params,
                                    K=K), qc.shape[0])

    def _sync_dp_batch(self, handles):
        """Pull the dispatched DP results and build Ez responses."""
        responses = handles["responses"]
        reqs = handles["reqs"]
        owners = handles["owners"]
        # start all chunk copies before blocking on the first, so the
        # copies overlap instead of each waiting its turn
        for _, payload in handles["chunks"]:
            for arr in payload[1:]:
                try:
                    arr.copy_to_host_async()
                except (AttributeError, TypeError):
                    break
        for chunk, payload in handles["chunks"]:
            if payload[0] == "fused":
                ops, packed = _dp_unpack(np.asarray(payload[1]), payload[2])
            else:
                ops = np.asarray(payload[1])
                packed = np.asarray(payload[2])
            score, mqe, mx, mxq, mxt, zdr, i_f, j_f = packed
            for bi, k in enumerate(chunk):
                cig = ops_to_cigar(ops[bi], int(i_f[bi]), int(j_f[bi]))
                ez = Ez(
                    score=int(score[bi]), mqe=int(mqe[bi]),
                    max=int(mx[bi]), max_q=int(mxq[bi]), max_t=int(mxt[bi]),
                    zdropped=bool(zdr[bi]), cigar=cig,
                )
                i, j = owners[k]
                responses[i][j] = ez
        for k in handles["big"]:
            q, t = reqs[k]
            i, j = owners[k]
            responses[i][j] = self._scalar_dp(q, t)
        return responses
