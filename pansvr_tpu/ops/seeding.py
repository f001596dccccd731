"""Batched device seeding: k-mer lookup + unitig MEM extension.

Device re-implementation of the reference's per-read seeding loop
(chainning_one_read, read_realignment.cpp:615-644 + deBGA_index.cpp
search_kmer/UNITIG_MEM_search): every SEED_STEP=5 bases, look up the
20-mer in the two-level hash, skip seeds with more than UNI_POS_N_MAX=32
table entries, and extend each entry to a maximal exact match within its
unitig.

Layout: reads are packed 16 bases per int32 word (MSB-first). MEM
extension compares 16 bases per step via XOR + leading/trailing
zero-pair counts — the TPU analog of the reference's 64-bit bit-parallel
compare (deBGA_index.cpp:116-128). All shapes static: B reads x S0 seed
positions x H=32 hit slots.

The sequential MEM-coverage skip (read_realignment.cpp:617,634-643:
a seed is skipped when the previous used seed's rightmost MEM reach
covers it) is applied as a cheap post-scan over the S0 axis: each seed's
extension depends only on itself, so extensions are computed for all
seeds and the skip just masks outputs — identical results, wasted
compute bounded by the skip rate.

Merging (merge_seed_in_unipath) and reference expansion (expand_seed)
are vectorized host-side in merge_expand_batch below (runs of
adjacent-linked MEMs after a (uid, read_pos) sort).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.device import DeviceIndex

SEED_STEP = 5
UNI_POS_N_MAX = 32
H_SLOTS = 32
POS_N_MAX = 500
POS_N_MAX_LEVEL2 = 8000
RANDOM_NUM = 500
WAITING_LEN = 3


class SeedBatch(NamedTuple):
    """Compacted MEM output, (B, M) int32 unless noted. Valid MEMs are
    packed to the front of the M axis in (seed-position, hit) order; rows
    with more than M valid MEMs report the excess in n_overflow (callers
    fall back to the host path for those reads to preserve exactness)."""
    uid: jnp.ndarray
    read_pos: jnp.ndarray
    uni_pos_off: jnp.ndarray
    length: jnp.ndarray
    pos_n: jnp.ndarray
    valid: jnp.ndarray       # (B, M) bool
    n_overflow: jnp.ndarray  # (B,) int32


def pack_reads(codes: np.ndarray) -> np.ndarray:
    """(B, L) uint8 codes -> (B, ceil(L/16)) int32 packed words."""
    B, L = codes.shape
    Wr = (L + 15) // 16
    padded = np.zeros((B, Wr * 16), dtype=np.uint32)
    padded[:, :L] = codes & 3
    mat = padded.reshape(B, Wr, 16)
    shifts = np.uint32(2) * (np.uint32(15) - np.arange(16, dtype=np.uint32))
    return (mat << shifts).sum(axis=2, dtype=np.uint32).view(np.int32)


def _window32(words_u32, p):
    """32-bit window of bases [p, p+16) from packed words (1-D array).
    words_u32: (W,) uint32; p: any int32 shape; returns uint32."""
    w = p >> 4
    sh = (p & 15).astype(jnp.uint32) * 2
    n = words_u32.shape[0]
    hi = words_u32[jnp.clip(w, 0, n - 1)]
    lo = words_u32[jnp.clip(w + 1, 0, n - 1)]
    # sh==0 must not shift by 32 (undefined); mask it
    lo_part = jnp.where(sh == 0, jnp.uint32(0), lo >> (jnp.uint32(32) - sh))
    return (hi << sh) | lo_part


def _window32_rows(words_u32, p):
    """Row-wise variant: words_u32 (B, W), p (B, ...) positions."""
    w = p >> 4
    sh = (p & 15).astype(jnp.uint32) * 2
    n = words_u32.shape[1]
    wc = jnp.clip(w, 0, n - 1)
    wc1 = jnp.clip(w + 1, 0, n - 1)
    hi = jnp.take_along_axis(words_u32, wc.reshape(p.shape[0], -1), axis=1).reshape(p.shape)
    lo = jnp.take_along_axis(words_u32, wc1.reshape(p.shape[0], -1), axis=1).reshape(p.shape)
    lo_part = jnp.where(sh == 0, jnp.uint32(0), lo >> (jnp.uint32(32) - sh))
    return (hi << sh) | lo_part


def _clz32(x):
    return jax.lax.clz(x.astype(jnp.int32)).astype(jnp.int32)


def _ctz32(x):
    xi = x.astype(jnp.uint32)
    blsi = xi & (jnp.uint32(0) - xi)          # lowest set bit
    return jax.lax.population_count((blsi - jnp.uint32(1)).astype(jnp.int32)).astype(jnp.int32)


def _read_win_table(rw_u, S0, sk, NE, Wr):
    """(B, S0, 2*NE) read-side extension windows: column word indices and
    shifts are STATIC per (seed column, step) — pure slicing, no dynamic
    gathers. Layout: [:, :, 0:NE] = left windows for steps 1..NE (16
    bases ending before the k-mer), [:, :, NE:2*NE] = right windows for
    steps 0..NE-1."""
    offs_np = np.arange(S0, dtype=np.int32) * SEED_STEP
    w0 = offs_np // 16
    shs = np.asarray((offs_np % 16) * 2, np.int32)
    pr = offs_np + sk
    wr0 = np.asarray(pr // 16, np.int32)
    shr = np.asarray((pr % 16) * 2, np.int32)

    def rwin_table(widx, shv):
        hi = rw_u[:, np.clip(widx, 0, Wr - 1)]
        lo = rw_u[:, np.clip(widx + 1, 0, Wr - 1)]
        shv_j = jnp.asarray(shv.astype(np.uint32))[None, :]
        lo_part = jnp.where(shv_j == 0, jnp.uint32(0),
                            lo >> (jnp.uint32(32) - shv_j))
        return (hi << shv_j) | lo_part

    rl_cols = [rwin_table(np.asarray(w0) - b_, shs) for b_ in range(1, NE + 1)]
    rr_cols = [rwin_table(wr0 + b_, shr) for b_ in range(NE)]
    return jnp.stack(rl_cols + rr_cols, axis=2)       # (B, S0, 2*NE)


def _read_win_lanes(rw_u, hit_seed, S0, sk, NE, Wr):
    """(B, M, 2*NE): the static window table mapped to hit lanes with one
    in-row take."""
    rtab = _read_win_table(rw_u, S0, sk, NE, Wr)
    return jnp.take_along_axis(
        rtab, hit_seed[:, :, None] + jnp.zeros((1, 1, 2 * NE), jnp.int32),
        axis=1,
    )                                                 # (B, M, 2*NE)


def _ext_steps(didx, rw_u, off, hit_seed, max_left, max_right,
               sk, NE, S0, Wr):
    """Stepped MEM extension with rolled unitig-word gathers (the v1
    extension; measured faster on TPU than the slab fetch): consecutive
    steps share a packed word, so each step past the first needs ONE new
    global gather instead of two."""
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)
    uni_u = bc(didx.uni_words)
    rlanes = _read_win_lanes(rw_u, hit_seed, S0, sk, NE, Wr)

    nW = uni_u.shape[0]
    uw = lambda j: uni_u[jnp.clip(j, 0, nW - 1)]
    woff = off >> 4

    sh_l = (off & 15).astype(jnp.uint32) * 2
    lo_w = uw(woff)
    left_m = jnp.zeros_like(off)
    still = jnp.ones_like(off, dtype=bool)
    for step in range(NE):
        wr = rlanes[:, :, step]
        hi_w = uw(woff - (step + 1))
        wu = (hi_w << sh_l) | jnp.where(
            sh_l == 0, jnp.uint32(0), lo_w >> (jnp.uint32(32) - sh_l))
        x = wr ^ wu
        m = jnp.where(x == 0, 16, _ctz32(x) >> 1)
        take = jnp.where(still, jnp.minimum(m, max_left - left_m), 0)
        left_m = left_m + jnp.maximum(take, 0)
        still = still & (m >= 16) & (left_m < max_left)
        lo_w = hi_w
    left_m = jnp.minimum(left_m, max_left)

    p0 = off + sk
    sh_r = (p0 & 15).astype(jnp.uint32) * 2
    w0r = p0 >> 4
    hi_w = uw(w0r)
    right_m = jnp.zeros_like(off)
    still = jnp.ones_like(off, dtype=bool)
    for step in range(NE):
        wr = rlanes[:, :, NE + step]
        lo_w = uw(w0r + step + 1)
        wu = (hi_w << sh_r) | jnp.where(
            sh_r == 0, jnp.uint32(0), lo_w >> (jnp.uint32(32) - sh_r))
        x = wr ^ wu
        m = jnp.where(x == 0, 16, _clz32(x) >> 1)
        take = jnp.where(still, jnp.minimum(m, max_right - right_m), 0)
        right_m = right_m + jnp.maximum(take, 0)
        still = still & (m >= 16) & (right_m < max_right)
        hi_w = lo_w
    right_m = jnp.minimum(right_m, max_right)
    return left_m, right_m


def _coverage_skip(found, per_seed_max_right, offs, sk, S0, B):
    """Sequential coverage skip (read_realignment.cpp:617) — unrolled
    static loop (a 29-step lax.scan with a (B,)-sized body schedules as
    29 tiny sequential kernels on TPU)."""
    msr = jnp.zeros((B,), jnp.int32)
    used_cols = []
    for s in range(S0):
        o_s = offs[s]
        used = (o_s + sk - 1 > msr) & found[:, s]
        max_right_i = jnp.maximum(per_seed_max_right[:, s] + 1, 1)
        msr = jnp.where(used, o_s + sk + max_right_i - 1, msr)
        used_cols.append(used)
    return jnp.stack(used_cols, axis=1)            # (B, S0)


def _ext_slab(didx, rw_u, off, o, o2, hit_seed, max_left, max_right,
              sk, NE, S0, Wr):
    """MEM extension over ONE contiguous unitig-word slab per lane plus
    static read-window tables (the v2 front's extension, reusable with
    the v1 bisect seeding). Bit-identical results to the stepped
    extension in seed_reads."""
    from ..index.device import PAD_WORDS

    B, M = off.shape
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)
    SLAB = 2 * NE + 3
    woff = off >> 4
    slab_start = (woff - NE + PAD_WORDS).reshape(-1)
    uni_pad_u = bc(didx.uni_words_pad)
    slab = jax.vmap(
        lambda s_: jax.lax.dynamic_slice(uni_pad_u, (s_,), (SLAB,))
    )(slab_start).reshape(B, M, SLAB)
    sh_l = (off & 15).astype(jnp.uint32) * 2
    p_r = off + sk
    sh_r = (p_r & 15).astype(jnp.uint32) * 2
    delta_r = (p_r >> 4) - woff                      # 1 or 2

    def uwin_left(b_):
        hi = slab[:, :, NE - b_]
        lo = slab[:, :, NE - b_ + 1]
        lo_part = jnp.where(sh_l == 0, jnp.uint32(0),
                            lo >> (jnp.uint32(32) - sh_l))
        return (hi << sh_l) | lo_part

    def uwin_right(b_):
        hi = jnp.where(delta_r == 1, slab[:, :, NE + 1 + b_],
                       slab[:, :, NE + 2 + b_])
        lo = jnp.where(delta_r == 1, slab[:, :, NE + 2 + b_],
                       slab[:, :, NE + 3 + b_] if NE + 3 + b_ < SLAB
                       else slab[:, :, SLAB - 1])
        lo_part = jnp.where(sh_r == 0, jnp.uint32(0),
                            lo >> (jnp.uint32(32) - sh_r))
        return (hi << sh_r) | lo_part

    rlanes = _read_win_lanes(rw_u, hit_seed, S0, sk, NE, Wr)

    left_m = jnp.zeros_like(off)
    still = jnp.ones_like(off, dtype=bool)
    for step in range(NE):
        wr = rlanes[:, :, step]
        wu = uwin_left(step + 1)
        x = wr ^ wu
        mm = jnp.where(x == 0, 16, _ctz32(x) >> 1)
        take = jnp.where(still, jnp.minimum(mm, max_left - left_m), 0)
        left_m = left_m + jnp.maximum(take, 0)
        still = still & (mm >= 16) & (left_m < max_left)
    left_m = jnp.minimum(left_m, max_left)

    right_m = jnp.zeros_like(off)
    still = jnp.ones_like(off, dtype=bool)
    for step in range(NE):
        wr = rlanes[:, :, NE + step]
        wu = uwin_right(step)
        x = wr ^ wu
        mm = jnp.where(x == 0, 16, _clz32(x) >> 1)
        take = jnp.where(still, jnp.minimum(mm, max_right - right_m), 0)
        right_m = right_m + jnp.maximum(take, 0)
        still = still & (mm >= 16) & (right_m < max_right)
    right_m = jnp.minimum(right_m, max_right)
    return left_m, right_m


@functools.partial(
    jax.jit, static_argnames=("S0", "n_ext_steps", "M", "ext_mode"))
def seed_reads(
    didx: DeviceIndex,
    read_words: jnp.ndarray,   # (B, Wr) int32 packed
    read_lens: jnp.ndarray,    # (B,) int32
    seed_mask: jnp.ndarray,    # (B, S0) bool: STR whitelist (True = usable)
    S0: int,
    n_ext_steps: int = 10,
    M: int = 128,
    ext_mode: str = "steps",
) -> SeedBatch:
    B = read_words.shape[0]
    fl = didx.first_level_bases
    sk = didx.search_k
    resid_bases = sk - fl
    entry_shift = jnp.uint32(2 * (didx.k - sk))

    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)
    rw_u = bc(read_words)
    uni_u = bc(didx.uni_words)
    hash_g = didx.hash_g
    kmer_g_u = bc(didx.kmer_g)

    offs = jnp.arange(S0, dtype=jnp.int32) * SEED_STEP      # (S0,)
    o = jnp.broadcast_to(offs[None, :], (B, S0))            # (B, S0)
    n_kmer = read_lens[:, None] - sk + 1
    seed_ok = (o < n_kmer) & seed_mask

    # --- k-mer split keys -------------------------------------------------
    win_a = _window32_rows(rw_u, o)                         # bases [o, o+16)
    win_b = _window32_rows(rw_u, o + fl)                    # bases [o+fl, ..)
    bucket = (win_a >> jnp.uint32(32 - 2 * fl)).astype(jnp.int32)
    residue = (win_b >> jnp.uint32(32 - 2 * resid_bases)).astype(jnp.int32)

    lo0 = hash_g[jnp.clip(bucket, 0, hash_g.shape[0] - 2)]
    hi0 = hash_g[jnp.clip(bucket + 1, 0, hash_g.shape[0] - 1)]

    # --- branchless lower/upper bound on (kmer_g >> shift) == residue -----
    def bisect(pred):
        lo = lo0
        hi = hi0
        # iteration count covers the largest first-level bucket (static,
        # recorded at index build)
        for _ in range(didx.max_bucket_bits):
            mid = (lo + hi) >> 1
            key = (kmer_g_u[jnp.clip(mid, 0, max(didx.n_kmer - 1, 0))]
                   >> entry_shift).astype(jnp.int32)
            go_right = pred(key)
            active = lo < hi
            lo = jnp.where(active & go_right, mid + 1, lo)
            hi = jnp.where(active & ~go_right, mid, hi)
        return lo

    left = bisect(lambda key: key < residue)
    right = bisect(lambda key: key <= residue)
    count = right - left
    found = seed_ok & (count > 0) & (count <= UNI_POS_N_MAX)

    # --- compact hits BEFORE extension ------------------------------------
    # most seeds have 1-2 table entries; doing the gather-heavy extension
    # on (B, S0, H) wastes ~10-30x lanes. Valid hits per seed are the
    # FIRST count[s] slots, so per-read packing is pure offset arithmetic
    # (a prefix sum + searchsorted — no (B, S0*H) argsort).
    eff = jnp.where(found, count, 0)                         # (B, S0)
    cum = jnp.cumsum(eff, axis=1)                            # inclusive
    start = cum - eff                                        # per-seed offset
    n_hits = cum[:, -1]
    overflow0 = jnp.maximum(n_hits - M, 0).astype(jnp.int32)

    m_slot = jnp.arange(M, dtype=jnp.int32)[None, :]         # (1, M)
    # seed owning output slot m: first s with cum[s] > m
    hit_seed = jax.vmap(
        lambda c, s: jnp.searchsorted(c, s, side="right")
    )(cum, m_slot + jnp.zeros((B, 1), jnp.int32)).astype(jnp.int32)
    hit_seed = jnp.clip(hit_seed, 0, S0 - 1)
    hit_h = m_slot - jnp.take_along_axis(start, hit_seed, axis=1)
    hit_ok = m_slot < jnp.minimum(n_hits, M)[:, None]

    gb = lambda a: jnp.take_along_axis(a, hit_seed, axis=1)  # (B,S0)->(B,M)
    entry = gb(left) + hit_h
    o2 = gb(o)                                               # seed offsets
    entry_c = jnp.clip(entry, 0, max(didx.n_kmer - 1, 0))
    off = jnp.where(hit_ok, didx.off_g[entry_c], 0)          # (B, M)
    uid = jnp.searchsorted(didx.uni_seqf, off, side="right").astype(jnp.int32) - 1
    uid = jnp.clip(uid, 0, max(didx.n_uni - 1, 0))
    pos_n = didx.uni_posp[uid + 1] - didx.uni_posp[uid]
    off_l = off - didx.uni_seqf[uid]
    off_r = didx.uni_seqf[uid + 1] - (off + sk)

    o3 = o2
    max_left = jnp.minimum(off_l, o3)
    max_right = jnp.minimum(off_r, read_lens[:, None] - o3 - sk)

    if ext_mode == "slab":
        # unitig side: ONE contiguous (SLAB,)-word dynamic slice per lane
        # (a gather row fetch instead of 2 scattered word gathers per
        # step); read side: static per (seed column, step) window tables
        # mapped to lanes with an in-row gather. Same results as "steps".
        left_m, right_m = _ext_slab(
            didx, rw_u, off, o, o2, hit_seed, max_left, max_right,
            sk, n_ext_steps, S0, read_words.shape[1])
    else:
        left_m, right_m = _ext_steps(
            didx, rw_u, off, hit_seed, max_left, max_right,
            sk, n_ext_steps, S0, read_words.shape[1])

    read_pos = o3 - left_m
    uni_pos_off = off_l - left_m
    length = sk + left_m + right_m

    # --- sequential coverage skip over seed positions ---------------------
    # msr carries the rightmost covered read position; a seed is used iff
    # o + sk - 1 > msr (read_realignment.cpp:617)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    per_seed_max_right = (
        jnp.full((B, S0), -1, jnp.int32)
        .at[rows + jnp.zeros_like(hit_seed), hit_seed]
        .max(jnp.where(hit_ok, right_m, -1))
    )
    seed_used = _coverage_skip(found, per_seed_max_right, offs, sk, S0, B)

    valid = hit_ok & jnp.take_along_axis(seed_used, hit_seed, axis=1)
    return SeedBatch(
        uid=jnp.where(valid, uid, 0),
        read_pos=jnp.where(valid, read_pos, 0),
        uni_pos_off=jnp.where(valid, uni_pos_off, 0),
        length=jnp.where(valid, length, 0),
        pos_n=jnp.where(valid, pos_n, 0),
        valid=valid,
        n_overflow=overflow0,
    )


# -------------------------------------------------------------------------
# v5 "flat" front: globally-compacted hit lanes
# -------------------------------------------------------------------------
#
# seed_reads pads every row to M MEM lanes, but real hit counts are
# bimodal (wrong-direction rows find ~0 seeds, matching rows ~S0): the
# batch-mean is ~7 hits/row vs M=32 lanes, so ~4.4x of the gather-bound
# extension work is spent on padding. This front compacts all hits of
# the batch into ONE flat lane axis sized NF = nf_mult * B, runs the
# per-hit attribute lookups and MEM extension there, and scatters the
# results back into the (B, M) SeedBatch layout. Results are
# bit-identical to seed_reads for every row it doesn't flag in
# n_overflow (flagged rows take the exact host path, same as v1's M
# overflow rule).

FLAT_OVERFLOW = 1 << 20    # n_overflow marker for rows cut by the NF cap
BUDGET_OVERFLOW = 1 << 21  # marker for active rows beyond compact_rows


@functools.partial(
    jax.jit, static_argnames=("S0", "n_ext_steps", "M", "nf_mult", "probe",
                              "lane_map", "read_win", "ent", "ext", "wb",
                              "stop_after", "compact_rows"))
def seed_reads_flat(
    didx: DeviceIndex,
    read_words: jnp.ndarray,   # (B, Wr) int32 packed
    read_lens: jnp.ndarray,    # (B,) int32
    seed_mask: jnp.ndarray,    # (B, S0) bool
    S0: int,
    n_ext_steps: int = 10,
    M: int = 32,
    nf_mult: int = 10,
    probe: str = "bisect",
    lane_map: str = "scan",
    read_win: str = "auto",
    ent: str = "pack",         # entry attrs: "pack" = ONE (NF, 4) row
                               # gather from didx.ent_pack; "split" = 5
                               # separate table gathers
    ext: str = "rows",         # unitig windows: "rows" = 2+ aligned
                               # 32-word row gathers + in-register barrel
                               # rotate; "steps" = ~2*NE word gathers
    wb: str = "gather",        # (B, M) writeback: "gather" = 6 full-size
                               # lane gathers; "slice" = one (M, 6)
                               # contiguous slice per row (the stack
                               # can break XLA's fusion of the
                               # where-masks into the gathers)
    stop_after: str = "",      # profiling: "probe" / "lanes" returns the
                               # partial result early (tools/profile_front2)
    compact_rows: int = 0,     # R > 0: after the probe, compact the rows
                               # with any k-mer hit onto R slots and run
                               # every later stage (lane layout, MEM
                               # extension, attributes, writeback — and
                               # the caller's merge/chain) at R rows
                               # instead of B. On anchor-realignment
                               # workloads most signal reads hit NO
                               # anchor k-mer (measured ~90% empty rows
                               # on the bench world), so the padded-row
                               # work is nearly all waste. Active rows
                               # beyond R are flagged BUDGET_OVERFLOW
                               # (host fallback; the engine halves its
                               # compact divisor when that fires).
                               # Returns (SeedBatch[R rows], rid[R],
                               # over_budget[B]) instead of a SeedBatch.
) -> SeedBatch:
    B, Wr = read_words.shape
    NF = nf_mult * B
    NE = n_ext_steps
    fl = didx.first_level_bases
    sk = didx.search_k
    resid_bases = sk - fl
    entry_shift = jnp.uint32(2 * (didx.k - sk))

    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)
    rw_u = bc(read_words)
    hash_g = didx.hash_g
    kmer_g_u = bc(didx.kmer_g)

    offs = jnp.arange(S0, dtype=jnp.int32) * SEED_STEP
    o = jnp.broadcast_to(offs[None, :], (B, S0))
    n_kmer = read_lens[:, None] - sk + 1
    seed_ok = (o < n_kmer) & seed_mask

    # --- k-mer probe (identical results to seed_reads; the probe windows
    # are at STATIC positions per seed column, so they're built by column
    # slicing instead of the (B, S0) dynamic gathers _window32_rows does)
    def _static_windows(pos_np):
        w = pos_np // 16
        sh = ((pos_np % 16) * 2).astype(np.int32)
        hi = rw_u[:, np.clip(w, 0, Wr - 1)]
        lo = rw_u[:, np.clip(w + 1, 0, Wr - 1)]
        shj = jnp.asarray(sh.astype(np.uint32))[None, :]
        lo_part = jnp.where(shj == 0, jnp.uint32(0),
                            lo >> (jnp.uint32(32) - shj))
        return (hi << shj) | lo_part

    offs_np = np.arange(S0, dtype=np.int32) * SEED_STEP
    win_a = _static_windows(offs_np)
    win_b = _static_windows(offs_np + fl)

    if probe == "sortjoin":
        # sort-merge join of the batch's query keys against the WHOLE
        # entry table: one 3-key lax.sort + cummax scans + one unsort
        # replaces the per-lane dependent-gather bisect, which needs
        # mbb+2 dependent gather steps. Identical (found, count, left) to the
        # bisect path. Viable when n_kmer is sort-sized (the engine
        # gates on SORTJOIN_MAX_KMER); the index side contributes its
        # (bucket, residue) keys via didx.ent_bucket/ent_res.
        N = didx.n_kmer
        Q = B * S0
        NQ = N + Q
        i32max = jnp.int32(0x7FFFFFFF)
        qb = (win_a >> jnp.uint32(32 - 2 * fl)).astype(jnp.int32)
        qr = (win_b >> jnp.uint32(32 - 2 * resid_bases)).astype(jnp.int32)
        # dead lanes key (i32max, -1): sorts after every real key but
        # BEFORE the (i32max, i32max) index pad entries, so the sentinel
        # run is query-headed -> no match
        sok = seed_ok.reshape(-1)
        k1 = jnp.concatenate([didx.ent_bucket,
                              jnp.where(sok, qb.reshape(-1), i32max)])
        k2 = jnp.concatenate([didx.ent_res,
                              jnp.where(sok, qr.reshape(-1), -1)])
        src = jnp.arange(NQ, dtype=jnp.int32)
        # src as third key: stable tie order puts index entries (src<N)
        # before the queries of the same key
        k1s, k2s, srcs = jax.lax.sort((k1, k2, src), num_keys=3)
        pos = jnp.arange(NQ, dtype=jnp.int32)
        head = jnp.concatenate([
            jnp.ones((1,), bool),
            (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])])
        is_index = srcs < N
        run_head_slot = jax.lax.cummax(jnp.where(head, pos, -1))
        idx_head_slot = jax.lax.cummax(
            jnp.where(head & is_index, pos, -1))
        # a run matches iff its head is an index entry (index entries of
        # an equal key sort first); the head's src is the lower bound
        match = idx_head_slot == run_head_slot
        left_s = jax.lax.cummax(jnp.where(head & is_index, srcs, -1))
        cnt_x = jnp.cumsum(is_index.astype(jnp.int32)) - is_index
        cnt_start = jax.lax.cummax(jnp.where(head, cnt_x, -1))
        count_s = jnp.where(match, cnt_x - cnt_start, 0)
        # unsort: queries return to lane order at slots [N:]
        _, left_u, count_u = jax.lax.sort(
            (srcs, jnp.where(match, left_s, 0), count_s), num_keys=1)
        left = left_u[N:].reshape(B, S0)
        count = count_u[N:].reshape(B, S0)
        found = seed_ok & (count > 0) & (count <= UNI_POS_N_MAX)
    else:
        bucket = (win_a >> jnp.uint32(32 - 2 * fl)).astype(jnp.int32)
        residue = (win_b >> jnp.uint32(32 - 2 * resid_bases)).astype(jnp.int32)
        lo0 = hash_g[jnp.clip(bucket, 0, hash_g.shape[0] - 2)]
        hi0 = hash_g[jnp.clip(bucket + 1, 0, hash_g.shape[0] - 1)]

        # ONE lower-bound bisect; the equal-key range length comes from
        # the precomputed per-entry run table (ent_run[lower_bound]),
        # replacing the upper-bound bisect's max_bucket_bits dependent
        # gathers with a single key check + one gather
        lo, hi = lo0, hi0
        for _ in range(didx.max_bucket_bits):
            mid = (lo + hi) >> 1
            key = (kmer_g_u[jnp.clip(mid, 0, max(didx.n_kmer - 1, 0))]
                   >> entry_shift).astype(jnp.int32)
            go_right = key < residue
            active = lo < hi
            lo = jnp.where(active & go_right, mid + 1, lo)
            hi = jnp.where(active & ~go_right, mid, hi)
        left = lo
        left_c = jnp.clip(left, 0, max(didx.n_kmer - 1, 0))
        key_at = (kmer_g_u[left_c] >> entry_shift).astype(jnp.int32)
        exists = (key_at == residue) & (left < hi0)
        count = jnp.where(exists, didx.ent_run[left_c], 0)
        found = seed_ok & exists & (count > 0) & (count <= UNI_POS_N_MAX)

    if stop_after == "probe":
        return found, count, left

    # --- active-row compaction (see compact_rows docstring) -----------------
    rid = None
    over_budget = None
    if compact_rows:
        R = compact_rows
        eff0 = jnp.where(found, count, 0)
        act = jnp.sum(eff0, axis=1) > 0                  # (B,)
        rank = jnp.cumsum(act.astype(jnp.int32)) - 1     # (B,) inclusive-1
        n_act = rank[-1] + 1
        slot = jnp.where(act & (rank < R), rank, R)
        # rid[slot] = source row; unwritten slots stay B (out-of-range
        # sentinel, dropped by the caller's scatter-back)
        rid = (jnp.full((R + 1,), B, jnp.int32)
               .at[slot].set(jnp.arange(B, dtype=jnp.int32))[:R])
        slot_ok = jnp.arange(R, dtype=jnp.int32) < n_act  # (R,)
        over_budget = act & (rank >= R)                   # (B,)
        ridc = jnp.clip(rid, 0, B - 1)
        found = jnp.where(slot_ok[:, None], found[ridc], False)
        count = count[ridc]
        left = left[ridc]
        rw_u = rw_u[ridc]
        read_lens = read_lens[ridc]
        B = R
        # NF stays nf_mult * ORIGINAL rows: compaction removes only
        # hit-free rows, so the batch's total flat-lane demand is
        # unchanged — shrinking the pool to nf_mult*R made active rows
        # trip FLAT_OVERFLOW under compaction (measured 2026-08-20:
        # ~144 spurious host-fallback rows/batch on the bench world)

    # --- per-row hit layout (same packing order as seed_reads) -------------
    eff = jnp.where(found, count, 0)                    # (B, S0)
    cum = jnp.cumsum(eff, axis=1)                       # inclusive
    start = cum - eff
    row_hits = cum[:, -1]                               # (B,)
    overflow0 = jnp.maximum(row_hits - M, 0).astype(jnp.int32)
    # rows over the M cap take the host path regardless — give them zero
    # flat lanes instead of M wasted ones
    row_take = jnp.where(row_hits <= M, row_hits, 0)

    # --- flat lane layout ---------------------------------------------------
    row_start = jnp.cumsum(row_take) - row_take         # exclusive (B,)
    total = row_start[-1] + row_take[-1]
    row_fits = row_start + row_take <= NF
    cum_take = row_start + row_take                     # inclusive (B,)
    f_idx = jnp.arange(NF, dtype=jnp.int32)
    if lane_map == "scan":
        # map flat slot -> row. row_c[f] = #rows whose inclusive cumsum
        # <= f, a step function of the SORTED query axis (f_idx is an
        # iota): one B-element scatter-add at the row boundaries + one
        # cumsum over NF replaces the 14-iteration bisect (14 x NF
        # dependent gathers; the scatter is only B elements — the
        # earlier scatter-max + cummax failure was an NF-element
        # scatter)
        bump = (
            jnp.zeros((NF + 1,), jnp.int32)
            .at[jnp.minimum(cum_take, NF)]
            .add(1, mode="drop")
        )
        row_c = jnp.minimum(jnp.cumsum(bump)[:NF], B - 1)
    else:
        lo_r = jnp.zeros((NF,), jnp.int32)
        hi_r = jnp.full((NF,), B, jnp.int32)
        # candidates span [0, B] (B+1 values): ceil(log2(B+1)) iters
        for _ in range(max(1, B.bit_length())):
            mid = (lo_r + hi_r) >> 1
            c = cum_take[jnp.clip(mid, 0, B - 1)]
            go_right = c <= f_idx
            active = lo_r < hi_r
            lo_r = jnp.where(active & go_right, mid + 1, lo_r)
            hi_r = jnp.where(active & ~go_right, mid, hi_r)
        row_c = jnp.clip(lo_r, 0, B - 1)
    p = f_idx - row_start[row_c]                        # per-row hit ordinal
    lane_ok = (f_idx < total) & (p >= 0) & (p < row_take[row_c])

    # --- seed-of-lane: in-row upper bound over cum[row, :] ------------------
    cum_flat = cum.reshape(-1)
    lo = jnp.zeros((NF,), jnp.int32)
    hi = jnp.full((NF,), S0, jnp.int32)
    for _ in range(max(1, (S0 - 1).bit_length())):
        mid = (lo + hi) >> 1
        c = cum_flat[row_c * S0 + jnp.clip(mid, 0, S0 - 1)]
        go_right = c <= p
        active = lo < hi
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    seed_of = jnp.clip(lo, 0, S0 - 1)                   # (NF,)
    bs = row_c * S0 + seed_of
    h = p - (cum_flat[bs] - eff.reshape(-1)[bs])
    o2 = seed_of * SEED_STEP

    # --- per-entry attributes (precomputed tables; no searchsorted) --------
    entry = jnp.where(lane_ok, left.reshape(-1)[bs] + h, 0)
    entry_c = jnp.clip(entry, 0, max(didx.n_kmer - 1, 0))
    if ent == "pack":
        # one 16-byte row gather instead of 5 table gathers (the gather
        # wall is descriptor-bound; see DeviceIndex.ent_pack layout)
        rec = didx.ent_pack[entry_c]                    # (NF, 4)
        off = jnp.where(lane_ok, rec[:, 0], 0)
        uid = jnp.where(lane_ok, rec[:, 1], 0)
        off_l = jnp.where(lane_ok, rec[:, 2], 0)
        off_r = jnp.where(lane_ok, rec[:, 3] & 2047, 0)
        pos_n = jnp.where(lane_ok, rec[:, 3] >> 11, 0)
    else:
        off = jnp.where(lane_ok, didx.off_g[entry_c], 0)
        uid = jnp.where(lane_ok, didx.ent_uid[entry_c], 0)
        off_l = jnp.where(lane_ok, didx.ent_off_l[entry_c], 0)
        off_r = jnp.where(lane_ok, didx.ent_off_r[entry_c], 0)
        pos_n = jnp.where(lane_ok, didx.ent_pos_n[entry_c], 0)

    rl_f = read_lens[row_c]
    max_left = jnp.minimum(off_l, o2)
    max_right = jnp.minimum(off_r, rl_f - o2 - sk)

    if stop_after == "lanes":
        return entry, off, uid, max_left, max_right

    # --- MEM extension on flat lanes (v1 stepped semantics) -----------------
    uni_u = bc(didx.uni_words)
    nW = uni_u.shape[0]
    uw = lambda j: uni_u[jnp.clip(j, 0, nW - 1)]
    woff = off >> 4
    p0 = off + sk
    w0r = p0 >> 4
    if ext == "rows":
        # fetch the whole per-lane extension window
        # [woff-NE, woff+NE+2] as n_rows ALIGNED 32-word row gathers from
        # uni_words_pad (the PAD_WORDS margin keeps every row in bounds),
        # then barrel-rotate in registers so every step reads a STATIC
        # window column: ~2*NE+2 HBM descriptors per lane become n_rows
        # (2 for the 160/256 read classes). Bit-identical windows.
        from ..index.device import PAD_WORDS

        uni_rows = bc(didx.uni_words_pad).reshape(-1, 32)
        nR = uni_rows.shape[0]
        n_rows = (2 * NE + 2 + 31) // 32 + 1
        base_w = woff - NE + PAD_WORDS          # >= 0 (PAD_WORDS > max NE)
        r0 = jnp.clip(base_w >> 5, 0, max(nR - n_rows, 0))
        win = jnp.concatenate(
            [uni_rows[r0 + rr] for rr in range(n_rows)], axis=1)
        amt = base_w & 31
        for kk in (16, 8, 4, 2, 1):
            rolled = jnp.concatenate([win[:, kk:], win[:, :kk]], axis=1)
            win = jnp.where(((amt & kk) != 0)[:, None], rolled, win)
        # win[:, j] == packed unitig word (woff - NE + j), j < 2*NE+3
        delta_r = w0r - woff                     # 1 or 2 (search_k = 20)
    use_slab = read_win == "slab" or (read_win == "auto" and Wr <= 16)
    if use_slab:
        # read-side windows from ONE (NF, Wr) row-slab gather + per-step
        # select trees over the Wr in-register words: replaces the 2*NE
        # per-lane random rtab gathers (~2.9M gathers/batch) with one
        # slice-contiguous gather plus elementwise selects.
        # Same word-index clipping and shift arithmetic as
        # _read_win_table, so the windows are bit-identical.
        rw_lane = jnp.take(rw_u, row_c, axis=0)         # (NF, Wr)

        def _sel_word(idx):
            acc = rw_lane[:, 0]
            for kk in range(1, Wr):
                acc = jnp.where(idx == kk, rw_lane[:, kk], acc)
            return acc

        w0_f = (o2 >> 4).astype(jnp.int32)
        shs_f = ((o2 & 15) * 2).astype(jnp.uint32)
        pr_f = o2 + sk
        wr0_f = (pr_f >> 4).astype(jnp.int32)
        shr_f = ((pr_f & 15) * 2).astype(jnp.uint32)

        def _rwin(widx, shv):
            hi = _sel_word(jnp.clip(widx, 0, Wr - 1))
            lo = _sel_word(jnp.clip(widx + 1, 0, Wr - 1))
            lo_part = jnp.where(shv == 0, jnp.uint32(0),
                                lo >> (jnp.uint32(32) - shv))
            return (hi << shv) | lo_part

        def rwin_left(step):
            return _rwin(w0_f - (step + 1), shs_f)

        def rwin_right(step):
            return _rwin(wr0_f + step, shr_f)
    else:
        rtab = _read_win_table(rw_u, S0, sk, NE, Wr)    # (B, S0, 2NE)
        rtab_flat = rtab.reshape(-1)
        rbase = bs * (2 * NE)

        def rwin_left(step):
            return rtab_flat[rbase + step]

        def rwin_right(step):
            return rtab_flat[rbase + NE + step]

    sh_l = (off & 15).astype(jnp.uint32) * 2
    sh_r = (p0 & 15).astype(jnp.uint32) * 2
    lo_w = None if ext == "rows" else uw(woff)
    left_m = jnp.zeros_like(off)
    still = jnp.ones_like(off, dtype=bool)
    for step in range(NE):
        wr = rwin_left(step)
        if ext == "rows":
            hi_w = win[:, NE - step - 1]
            lo_cur = win[:, NE - step]
        else:
            hi_w = uw(woff - (step + 1))
            lo_cur = lo_w
        wu = (hi_w << sh_l) | jnp.where(
            sh_l == 0, jnp.uint32(0), lo_cur >> (jnp.uint32(32) - sh_l))
        x = wr ^ wu
        m = jnp.where(x == 0, 16, _ctz32(x) >> 1)
        take = jnp.where(still, jnp.minimum(m, max_left - left_m), 0)
        left_m = left_m + jnp.maximum(take, 0)
        still = still & (m >= 16) & (left_m < max_left)
        lo_w = hi_w
    left_m = jnp.minimum(left_m, max_left)

    hi_w = None if ext == "rows" else uw(w0r)
    right_m = jnp.zeros_like(off)
    still = jnp.ones_like(off, dtype=bool)
    for step in range(NE):
        wr = rwin_right(step)
        if ext == "rows":
            hi_cur = jnp.where(delta_r == 1, win[:, NE + 1 + step],
                               win[:, NE + 2 + step])
            lo_w2 = jnp.where(delta_r == 1, win[:, NE + 2 + step],
                              win[:, NE + 3 + step])
        else:
            hi_cur = hi_w
            lo_w2 = uw(w0r + step + 1)
        wu = (hi_cur << sh_r) | jnp.where(
            sh_r == 0, jnp.uint32(0), lo_w2 >> (jnp.uint32(32) - sh_r))
        x = wr ^ wu
        m = jnp.where(x == 0, 16, _clz32(x) >> 1)
        take = jnp.where(still, jnp.minimum(m, max_right - right_m), 0)
        right_m = right_m + jnp.maximum(take, 0)
        still = still & (m >= 16) & (right_m < max_right)
        hi_w = lo_w2
    right_m = jnp.minimum(right_m, max_right)

    read_pos = o2 - left_m
    uni_pos_off = off_l - left_m
    length = sk + left_m + right_m

    # --- coverage skip (B, S0) ----------------------------------------------
    # per-(row, seed) max of right_m without a scatter: lanes of a group
    # are contiguous on the flat axis, so a segmented doubling-scan max
    # keyed by bs propagates the group max to its FIRST lane, and the
    # first lane of group (b, s) sits at row_start[b] + start[b, s] — a
    # plain gather
    right_eff = jnp.where(lane_ok, right_m, -1)
    seg_max = right_eff
    s_step = 1
    while s_step < NF:
        sh_v = jnp.concatenate(
            [seg_max[s_step:], jnp.full((s_step,), -1, jnp.int32)])
        sh_id = jnp.concatenate(
            [bs[s_step:], jnp.full((s_step,), -1, bs.dtype)])
        seg_max = jnp.where(sh_id == bs, jnp.maximum(seg_max, sh_v),
                            seg_max)
        s_step *= 2
    grp_first = jnp.clip(row_start[:, None] + start, 0, NF - 1)  # (B, S0)
    per_seed_max_right = jnp.where(
        found & (row_take > 0)[:, None], seg_max[grp_first], -1)
    seed_used = _coverage_skip(found, per_seed_max_right, offs, sk, S0, B)
    valid_f = lane_ok & seed_used.reshape(-1)[bs]

    # --- gather back to the (B, M) SeedBatch layout --------------------------
    # the flat->(B, M) map is invertible (lane = row_start[b] + m), so the
    # writeback is M gathers per row instead of a serialized TPU scatter
    m_cols = jnp.arange(M, dtype=jnp.int32)[None, :]
    in_row_bm = m_cols < row_take[:, None]
    n_overflow = overflow0 + jnp.where(row_fits, 0, FLAT_OVERFLOW)
    if wb == "slice":
        # a row's lanes are CONTIGUOUS on the flat axis, so the writeback
        # is one (M, 6) dynamic slice per row (B descriptors) instead of
        # 6 full (B, M) lane gathers; the M-row zero pad absorbs rows at
        # the NF cap (flagged FLAT_OVERFLOW above)
        flat6 = jnp.stack(
            [uid, read_pos, uni_pos_off, length, pos_n,
             valid_f.astype(jnp.int32)], axis=1)             # (NF, 6)
        flat6 = jnp.concatenate(
            [flat6, jnp.zeros((M, 6), jnp.int32)], axis=0)
        rows_bm = jax.vmap(
            lambda s_: jax.lax.dynamic_slice(flat6, (s_, 0), (M, 6))
        )(jnp.clip(row_start, 0, NF))                        # (B, M, 6)
        valid_bm = in_row_bm & (rows_bm[:, :, 5] != 0)

        def pick(c):
            return jnp.where(valid_bm, rows_bm[:, :, c], 0)

        sb = SeedBatch(
            uid=pick(0), read_pos=pick(1), uni_pos_off=pick(2),
            length=pick(3), pos_n=pick(4), valid=valid_bm,
            n_overflow=n_overflow.astype(jnp.int32),
        )
        return (sb, rid, over_budget) if compact_rows else sb

    src_lane = jnp.clip(row_start[:, None] + m_cols, 0, NF - 1)  # (B, M)
    if wb == "rowgather":
        # ONE row gather of a stacked (NF, 6) table instead of 6 lane
        # gathers: same descriptor count as one gather, 6x fewer total
        # (rows are 24 contiguous bytes)
        flat6 = jnp.stack(
            [uid, read_pos, uni_pos_off, length, pos_n,
             valid_f.astype(jnp.int32)], axis=1)             # (NF, 6)
        rows_bm = flat6[src_lane]                            # (B, M, 6)
        valid_bm = in_row_bm & (rows_bm[:, :, 5] != 0)

        def pick(c):
            return jnp.where(valid_bm, rows_bm[:, :, c], 0)

        sb = SeedBatch(
            uid=pick(0), read_pos=pick(1), uni_pos_off=pick(2),
            length=pick(3), pos_n=pick(4), valid=valid_bm,
            n_overflow=n_overflow.astype(jnp.int32),
        )
        return (sb, rid, over_budget) if compact_rows else sb
    valid_bm = in_row_bm & valid_f[src_lane]

    def back(vals):
        return jnp.where(valid_bm, vals[src_lane], 0)
    sb = SeedBatch(
        uid=back(uid), read_pos=back(read_pos), uni_pos_off=back(uni_pos_off),
        length=back(length), pos_n=back(pos_n), valid=valid_bm,
        n_overflow=n_overflow.astype(jnp.int32),
    )
    return (sb, rid, over_budget) if compact_rows else sb


# -------------------------------------------------------------------------
# host-side (vectorized NumPy) merge + expand
# -------------------------------------------------------------------------

class ExpandedSeeds(NamedTuple):
    """Padded per-read reference seeds, ready for ops.chain.chain_batch."""
    read_begin: np.ndarray   # (B, S) int32
    read_end: np.ndarray
    ref_begin: np.ndarray
    ref_end: np.ndarray
    cov: np.ndarray
    seed_id: np.ndarray
    valid: np.ndarray        # (B, S) bool
    n_dropped: np.ndarray    # (B,) seeds lost to the S cap (0 in-parity)


def merge_expand_batch(sb: SeedBatch, idx, S: int,
                       rng: np.random.Generator | None = None) -> ExpandedSeeds:
    """merge_seed_in_unipath + expand_seed (deBGA_index.cpp:151-251),
    vectorized across the batch. ``idx`` is the host RdBGIndex (for
    uni_posp/uni_pos lookup)."""
    uid = np.asarray(sb.uid)
    read_pos = np.asarray(sb.read_pos)
    uni_off = np.asarray(sb.uni_pos_off)
    length = np.asarray(sb.length)
    pos_n = np.asarray(sb.pos_n)
    valid = np.asarray(sb.valid)
    B = uid.shape[0]

    rows, m_idx = np.nonzero(valid)
    if len(rows) == 0:
        z = np.zeros((B, S), np.int32)
        return ExpandedSeeds(z, z, z, z, z, z, np.zeros((B, S), bool),
                             np.zeros(B, np.int32))
    u = uid[rows, m_idx].astype(np.int64)
    rp = read_pos[rows, m_idx].astype(np.int64)
    uo = uni_off[rows, m_idx].astype(np.int64)
    ln = length[rows, m_idx].astype(np.int64)
    pn = pos_n[rows, m_idx].astype(np.int64)

    order = np.lexsort((rp, u, rows))
    rows, u, rp, uo, ln, pn = (a[order] for a in (rows, u, rp, uo, ln, pn))

    # adjacent-linked runs (same row+uid, increasing uni_off, read gap <= 3,
    # zero indel drift)
    n = len(rows)
    linked = np.zeros(n, dtype=bool)
    if n > 1:
        same = (rows[1:] == rows[:-1]) & (u[1:] == u[:-1]) & (uo[1:] > uo[:-1])
        diff = rp[1:] - rp[:-1] - ln[:-1]
        drift = (uo[1:] - uo[:-1]) - (rp[1:] - rp[:-1])
        linked[1:] = same & (diff <= WAITING_LEN) & (drift == 0)
    run_id = np.cumsum(~linked) - 1
    n_runs = run_id[-1] + 1
    first = np.nonzero(~linked)[0]
    last = np.append(first[1:], n) - 1

    contrib = ln.copy()
    if n > 1:
        diff_full = np.concatenate([[0], rp[1:] - rp[:-1] - ln[:-1]])
        inner = linked
        contrib = np.where(inner & (diff_full <= 0), diff_full + ln, ln)
    cov = np.zeros(n_runs, dtype=np.int64)
    np.add.at(cov, run_id, contrib)

    m_row = rows[first]
    m_uid = u[first]
    m_read_pos = rp[first]
    m_uni_off = uo[first]
    m_pos_n = pn[first]
    single = first == last
    m_len1 = np.where(single, ln[first], rp[last] + ln[last] - rp[first])
    m_len2 = np.where(single, ln[first], uo[last] + ln[last] - uo[first])

    # --- expand ----------------------------------------------------------
    # per-row merged order = sorted order; level-2 abort: drop this and all
    # later merged seeds of the row (deBGA_index.cpp:226 `return`)
    over2 = m_pos_n > POS_N_MAX_LEVEL2
    abort_from = np.full(B, np.iinfo(np.int64).max, dtype=np.int64)
    if over2.any():
        np.minimum.at(abort_from, m_row[over2], np.nonzero(over2)[0])
    keep = np.arange(n_runs) < abort_from[m_row]

    sample = (m_pos_n > POS_N_MAX) & keep
    full = ~sample & keep
    occ_count = np.where(full, m_pos_n, np.where(sample, RANDOM_NUM, 0))

    # seed_id within each row = merged index within row (expand_seed uses
    # the loop index i over vertexu_v)
    row_change = np.concatenate([[True], m_row[1:] != m_row[:-1]])
    row_start_run = np.maximum.accumulate(np.where(row_change, np.arange(n_runs), 0))
    seed_id_in_row = np.arange(n_runs) - row_start_run

    total = int(occ_count.sum())
    rep = np.repeat(np.arange(n_runs), occ_count)
    within = _ranges_np(occ_count)
    posp = idx.uni_posp
    upos = idx.uni_pos
    base = posp[m_uid[rep]]
    if rng is None:
        rng = np.random.default_rng(0)
    pick = np.where(
        sample[rep],
        (base + rng.integers(0, 1 << 30, size=total) % np.maximum(m_pos_n[rep], 1)),
        base + within,
    )
    ref_begin = upos[pick] + m_uni_off[rep]
    e_row = m_row[rep]
    e_read_begin = m_read_pos[rep]
    e_read_end = m_read_pos[rep] + m_len1[rep] - 1
    e_ref_end = ref_begin + m_len2[rep] - 1
    e_cov = cov[rep]
    e_sid = seed_id_in_row[rep]

    # --- pad to (B, S) ---------------------------------------------------
    out = {k: np.zeros((B, S), np.int32) for k in
           ["rb", "re", "fb", "fe", "cov", "sid"]}
    vmask = np.zeros((B, S), bool)
    # position of each expanded seed within its row:
    order2 = np.argsort(e_row, kind="stable")
    e_row = e_row[order2]
    per_row_pos = _ranges_np(np.bincount(e_row, minlength=B))
    sel = per_row_pos < S
    rsel = e_row[sel]
    csel = per_row_pos[sel]
    src = order2[sel]
    out["rb"][rsel, csel] = e_read_begin[src]
    out["re"][rsel, csel] = e_read_end[src]
    out["fb"][rsel, csel] = ref_begin[src]
    out["fe"][rsel, csel] = e_ref_end[src]
    out["cov"][rsel, csel] = e_cov[src]
    out["sid"][rsel, csel] = e_sid[src]
    vmask[rsel, csel] = True
    counts = np.bincount(e_row, minlength=B)
    n_dropped = np.maximum(counts - S, 0).astype(np.int32)

    return ExpandedSeeds(
        read_begin=out["rb"], read_end=out["re"], ref_begin=out["fb"],
        ref_end=out["fe"], cov=out["cov"], seed_id=out["sid"],
        valid=vmask, n_dropped=n_dropped,
    )


def _ranges_np(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


# -------------------------------------------------------------------------
# device merge + expand (same semantics as merge_expand_batch, minus the
# host round-trip; occurrence sampling uses a counter-based hash instead of
# a NumPy RNG — both are arbitrary relative to the reference's rand())
# -------------------------------------------------------------------------

class DeviceSeeds(NamedTuple):
    """Per-read reference seeds on device, (B, S) int32 / bool."""
    read_begin: jnp.ndarray
    read_end: jnp.ndarray
    ref_begin: jnp.ndarray
    ref_end: jnp.ndarray
    cov: jnp.ndarray
    seed_id: jnp.ndarray
    valid: jnp.ndarray
    n_dropped: jnp.ndarray   # (B,)


@functools.partial(jax.jit, static_argnames=("S",))
def merge_expand_device(sb: SeedBatch, didx: DeviceIndex, S: int,
                        sample_seed: jnp.ndarray | int = 0) -> DeviceSeeds:
    uid, rp, uo, ln, pn, valid = (
        sb.uid, sb.read_pos, sb.uni_pos_off, sb.length, sb.pos_n, sb.valid
    )
    B, M = uid.shape

    # ---- sort MEMs by (uid, read_pos), invalid last ---------------------
    # ONE stable two-key sort carrying packed payloads: XLA lowers each
    # extra (B, M) in-row take_along_axis to a general gather, so fields
    # ride the sort network instead.
    # read_pos/length fit 12 bits (read classes <= 512); pos_n is
    # clamped to 14 bits, lossless for every downstream use (the >500
    # sampling and >8000 abort thresholds, and the sampled modulo which
    # only applies at pos_n <= 8000).
    key1 = jnp.where(valid, uid, jnp.int32(0x7FFFFFFF))
    pk = (
        jnp.clip(rp, 0, 4095)
        | (jnp.clip(ln, 0, 4095) << 12)
        | (valid.astype(jnp.int32) << 24)
    )
    pn_c = jnp.minimum(pn, 16383)
    key1, rp, uo, pk, pn = jax.lax.sort(
        (key1, rp, uo, pk, pn_c), dimension=1, num_keys=2, is_stable=True)
    valid = (pk >> 24) != 0
    uid = jnp.where(valid, key1, 0)
    ln = (pk >> 12) & 4095

    # ---- adjacent-linked runs ------------------------------------------
    linked = jnp.zeros((B, M), dtype=bool)
    same = (uid[:, 1:] == uid[:, :-1]) & (uo[:, 1:] > uo[:, :-1]) \
        & valid[:, 1:] & valid[:, :-1]
    diff = rp[:, 1:] - rp[:, :-1] - ln[:, :-1]
    drift = (uo[:, 1:] - uo[:, :-1]) - (rp[:, 1:] - rp[:, :-1])
    linked = linked.at[:, 1:].set(
        same & (diff <= WAITING_LEN) & (drift == 0)
    )
    is_first = ~linked
    run_id = jnp.cumsum(is_first.astype(jnp.int32), axis=1) - 1  # (B, M)

    contrib = jnp.where(
        linked & (jnp.pad(diff, ((0, 0), (1, 0))) <= 0),
        jnp.pad(diff, ((0, 0), (1, 0))) + ln, ln
    )
    contrib = jnp.where(valid, contrib, 0)
    # segmented sums/boundaries via prefix trick on (B, M):
    csum = jnp.cumsum(contrib, axis=1)
    # positions of run firsts, compacted to the front: scatter-min of
    # each flagged column into its run slot (cheaper than the stable
    # argsort of ~flag it replaces — one (B, M) scatter vs a sort)
    flag = is_first & valid
    n_runs = jnp.sum(flag, axis=1)  # (B,)
    rows_b = jnp.arange(B, dtype=jnp.int32)[:, None]
    m_cols = jnp.arange(M, dtype=jnp.int32)[None, :]
    firsts = (
        jnp.full((B, M), M - 1, jnp.int32)
        .at[jnp.where(flag, rows_b, B), jnp.where(flag, run_id, 0)]
        .min(jnp.broadcast_to(m_cols, (B, M)), mode="drop")
    )

    run_slot = jnp.arange(M)[None, :]
    run_ok = run_slot < n_runs[:, None]
    fcol = jnp.where(run_ok, firsts, M - 1)
    # last element of run j = first of run j+1 minus 1 (or last valid);
    # firsts[j+1] is just the next column — a slice, not a gather
    nvalid = jnp.sum(valid, axis=1)
    firsts_next = jnp.concatenate([firsts[:, 1:], firsts[:, -1:]], axis=1)
    next_f = jnp.where(
        run_slot + 1 < n_runs[:, None], firsts_next, nvalid[:, None],
    )
    lcol = jnp.clip(next_f - 1, 0, M - 1)

    at = lambda a, c: jnp.take_along_axis(a, c, axis=1)
    pk_f = at(pk, fcol)                 # rp + ln of the run's first MEM
    pk_l = at(pk, lcol)                 # rp + ln of the run's last MEM
    m_uid = at(uid, fcol)
    m_rp = pk_f & 4095
    ln_f = (pk_f >> 12) & 4095
    m_uo = at(uo, fcol)
    m_pn = at(pn, fcol)
    csum_last = at(csum, lcol)
    csum_before = jnp.where(fcol > 0, at(csum, jnp.maximum(fcol - 1, 0)), 0)
    m_cov = csum_last - csum_before
    single = fcol == lcol
    rp_l = pk_l & 4095
    ln_l = (pk_l >> 12) & 4095
    m_len1 = jnp.where(single, ln_f, rp_l + ln_l - m_rp)
    m_len2 = jnp.where(single, ln_f, at(uo, lcol) + ln_l - m_uo)

    # ---- expand ---------------------------------------------------------
    over2 = run_ok & (m_pn > POS_N_MAX_LEVEL2)
    aborted = jnp.cumsum(over2.astype(jnp.int32), axis=1) > 0
    keep = run_ok & ~aborted
    occ = jnp.where(
        keep, jnp.where(m_pn > POS_N_MAX, RANDOM_NUM, m_pn), 0
    )
    cum = jnp.cumsum(occ, axis=1)
    start = cum - occ
    total = cum[:, -1]

    slot = jnp.arange(S, dtype=jnp.int32)[None, :]
    # upper_bound(cum, slot) as a compare-reduce: one elementwise
    # (B, S, M) compare where the vmapped searchsorted lowers to a while
    # loop
    src_run = jnp.sum(
        (cum[:, None, :] <= slot[:, :, None]).astype(jnp.int32), axis=2
    )
    src_run = jnp.clip(src_run, 0, M - 1)
    within = slot - jnp.take_along_axis(start, src_run, axis=1)
    slot_ok = slot < jnp.minimum(total[:, None], S)

    # packed per-run attributes: 3 src_run gathers instead of 6 (values
    # fit 12 bits for read classes <= 512; garbage in never-selected runs
    # is masked by slot_ok)
    mp_a = (m_rp & 4095) | ((m_len1 & 4095) << 12)
    mp_b = (m_len2 & 4095) | (jnp.clip(m_pn, 0, 16383) << 12)
    r_uid = jnp.take_along_axis(m_uid, src_run, axis=1)
    r_a = jnp.take_along_axis(mp_a, src_run, axis=1)
    r_b = jnp.take_along_axis(mp_b, src_run, axis=1)
    r_pn = r_b >> 12
    sampled = r_pn > POS_N_MAX
    h = (
        (slot.astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
        ^ (jnp.uint32(sample_seed) if isinstance(sample_seed, int)
           else sample_seed.astype(jnp.uint32))
        ^ (r_uid.astype(jnp.uint32) * jnp.uint32(2654435761))
    )
    pick_within = jnp.where(
        sampled,
        (h % jnp.maximum(r_pn, 1).astype(jnp.uint32)).astype(jnp.int32),
        within,
    )
    base = didx.uni_posp[jnp.clip(r_uid, 0, max(didx.n_uni - 1, 0))]
    occ_idx = jnp.clip(base + pick_within, 0, didx.uni_pos.shape[0] - 1)
    r_uo = jnp.take_along_axis(m_uo, src_run, axis=1)
    ref_begin = didx.uni_pos[occ_idx] + r_uo
    read_begin = r_a & 4095
    len1 = (r_a >> 12) & 4095
    len2 = r_b & 4095
    covv = jnp.take_along_axis(m_cov, src_run, axis=1)

    z = jnp.int32(0)
    return DeviceSeeds(
        read_begin=jnp.where(slot_ok, read_begin, z),
        read_end=jnp.where(slot_ok, read_begin + len1 - 1, z),
        ref_begin=jnp.where(slot_ok, ref_begin, z),
        ref_end=jnp.where(slot_ok, ref_begin + len2 - 1, z),
        cov=jnp.where(slot_ok, covv, z),
        seed_id=jnp.where(slot_ok, src_run, z),
        valid=slot_ok,
        n_dropped=jnp.maximum(total - S, 0),
    )


def _seg_last(v: jnp.ndarray, run_id: jnp.ndarray) -> jnp.ndarray:
    """Propagate each run's LAST-lane value leftward to every lane of the
    run (segmented doubling scan along the M axis): out[m] = v[m'] where
    m' is the last lane with run_id[m'] == run_id[m]. Pure shifts +
    selects — no gathers."""
    B, M = v.shape
    out = v
    s = 1
    while s < M:
        sh_v = jnp.concatenate([out[:, s:], out[:, -s:]], axis=1)
        sh_id = jnp.concatenate(
            [run_id[:, s:], jnp.full((B, s), -1, run_id.dtype)], axis=1)
        out = jnp.where(sh_id == run_id, sh_v, out)
        s *= 2
    return out


@functools.partial(jax.jit, static_argnames=("S",))
def merge_expand_device3(sb: SeedBatch, didx: DeviceIndex, S: int,
                         sample_seed: jnp.ndarray | int = 0) -> DeviceSeeds:
    """Device merge/expand with the expand-side run-attribute gathers
    replaced by one-hot masked sums over the tiny M axis: src_run is
    non-decreasing per row, so its one-hot factors out of the (B, S, M)
    compare the v2 variant already pays, and each attribute select is an
    elementwise reduce instead of a (B, M) take_along_axis gather.
    Bit-identical outputs (tested)."""
    uid, rp, uo, ln, pn, valid = (
        sb.uid, sb.read_pos, sb.uni_pos_off, sb.length, sb.pos_n, sb.valid
    )
    B, M = uid.shape

    # ---- sort MEMs by (uid, read_pos), invalid last (as v2) -------------
    key1 = jnp.where(valid, uid, jnp.int32(0x7FFFFFFF))
    pk = (
        jnp.clip(rp, 0, 4095)
        | (jnp.clip(ln, 0, 4095) << 12)
        | (valid.astype(jnp.int32) << 24)
    )
    pn_c = jnp.minimum(pn, 16383)
    key1, rp, uo, pk, pn = jax.lax.sort(
        (key1, rp, uo, pk, pn_c), dimension=1, num_keys=2, is_stable=True)
    valid = (pk >> 24) != 0
    uid = jnp.where(valid, key1, 0)
    ln = (pk >> 12) & 4095

    # ---- adjacent-linked runs (as v2) -----------------------------------
    linked = jnp.zeros((B, M), dtype=bool)
    same = (uid[:, 1:] == uid[:, :-1]) & (uo[:, 1:] > uo[:, :-1]) \
        & valid[:, 1:] & valid[:, :-1]
    diff = rp[:, 1:] - rp[:, :-1] - ln[:, :-1]
    drift = (uo[:, 1:] - uo[:, :-1]) - (rp[:, 1:] - rp[:, :-1])
    linked = linked.at[:, 1:].set(
        same & (diff <= WAITING_LEN) & (drift == 0)
    )
    is_first = ~linked
    run_id = jnp.cumsum(is_first.astype(jnp.int32), axis=1) - 1  # (B, M)

    contrib = jnp.where(
        linked & (jnp.pad(diff, ((0, 0), (1, 0))) <= 0),
        jnp.pad(diff, ((0, 0), (1, 0))) + ln, ln
    )
    contrib = jnp.where(valid, contrib, 0)
    csum = jnp.cumsum(contrib, axis=1)

    # ---- per-lane run attributes via segmented propagation (as v2) ------
    pk_l = _seg_last(pk, run_id)
    uo_l = _seg_last(uo, run_id)
    csum_l = _seg_last(csum, run_id)
    csum_before = jnp.concatenate(
        [jnp.zeros((B, 1), csum.dtype), csum[:, :-1]], axis=1)
    cov_all = csum_l - csum_before
    rp_l = pk_l & 4095
    ln_l = (pk_l >> 12) & 4095
    is_last = jnp.concatenate(
        [is_first[:, 1:], jnp.ones((B, 1), bool)], axis=1)
    len1 = jnp.where(is_last, ln, rp_l + ln_l - rp)
    len2 = jnp.where(is_last, ln, uo_l + ln_l - uo)

    # ---- compact run firsts into run slots: ONE payload sort (as v2) ----
    flag = is_first & valid
    n_runs = jnp.sum(flag, axis=1)  # (B,)
    m_cols = jnp.arange(M, dtype=jnp.int32)[None, :]
    ckey = jnp.where(flag, m_cols, jnp.int32(M))
    mp_a = (rp & 4095) | ((len1 & 4095) << 12)
    mp_b = (len2 & 4095) | (pn << 12)   # pn already clamped to 14 bits
    _, m_uid, m_uo, m_a, m_b, m_cov = jax.lax.sort(
        (jnp.broadcast_to(ckey, (B, M)), uid, uo, mp_a, mp_b, cov_all),
        dimension=1, num_keys=1, is_stable=True)
    m_pn = m_b >> 12

    # ---- expand: one-hot selection instead of per-attribute gathers -----
    run_slot = jnp.arange(M)[None, :]
    run_ok = run_slot < n_runs[:, None]
    over2 = run_ok & (m_pn > POS_N_MAX_LEVEL2)
    aborted = jnp.cumsum(over2.astype(jnp.int32), axis=1) > 0
    keep = run_ok & ~aborted
    occ = jnp.where(
        keep, jnp.where(m_pn > POS_N_MAX, RANDOM_NUM, m_pn), 0
    )
    cum = jnp.cumsum(occ, axis=1)
    start = cum - occ
    total = cum[:, -1]

    slot = jnp.arange(S, dtype=jnp.int32)[None, :]
    # cum is non-decreasing per row, so the upper-bound map slot -> run is
    # a step function: le[s, m] = cum[m] <= slot[s] is a prefix-of-ones
    # along M; src_run = popcount of the prefix and its one-hot is the
    # prefix edge — both fall out of ONE (B, S, M) compare
    le = cum[:, None, :] <= slot[:, :, None]            # (B, S, M)
    src_run = jnp.sum(le.astype(jnp.int32), axis=2)
    src_run = jnp.clip(src_run, 0, M - 1)
    oh = jnp.concatenate(
        [jnp.ones((B, S, 1), bool), le[:, :, :-1]], axis=2) & ~le

    def sel(a):  # (B, M) -> (B, S) masked-sum one-hot select
        return jnp.sum(jnp.where(oh, a[:, None, :], 0), axis=2)

    within = slot - sel(start)
    slot_ok = slot < jnp.minimum(total[:, None], S)

    r_uid = sel(m_uid)
    r_a = sel(m_a)
    r_b = sel(m_b)
    r_uo = sel(m_uo)
    covv = sel(m_cov)
    r_pn = r_b >> 12
    sampled = r_pn > POS_N_MAX
    h = (
        (slot.astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
        ^ (jnp.uint32(sample_seed) if isinstance(sample_seed, int)
           else sample_seed.astype(jnp.uint32))
        ^ (r_uid.astype(jnp.uint32) * jnp.uint32(2654435761))
    )
    pick_within = jnp.where(
        sampled,
        (h % jnp.maximum(r_pn, 1).astype(jnp.uint32)).astype(jnp.int32),
        within,
    )
    base = didx.uni_posp[jnp.clip(r_uid, 0, max(didx.n_uni - 1, 0))]
    occ_idx = jnp.clip(base + pick_within, 0, didx.uni_pos.shape[0] - 1)
    ref_begin = didx.uni_pos[occ_idx] + r_uo
    read_begin = r_a & 4095
    len1_r = (r_a >> 12) & 4095
    len2_r = r_b & 4095

    z = jnp.int32(0)
    return DeviceSeeds(
        read_begin=jnp.where(slot_ok, read_begin, z),
        read_end=jnp.where(slot_ok, read_begin + len1_r - 1, z),
        ref_begin=jnp.where(slot_ok, ref_begin, z),
        ref_end=jnp.where(slot_ok, ref_begin + len2_r - 1, z),
        cov=jnp.where(slot_ok, covv, z),
        seed_id=jnp.where(slot_ok, src_run, z),
        valid=slot_ok,
        n_dropped=jnp.maximum(total - S, 0),
    )
