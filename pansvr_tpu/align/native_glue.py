"""ctypes binding for the native engine host glue
(native/engine_glue.cpp): chain-hit extraction + the get_ksw_score
collect/replay walks + CIGAR merge + result ranking in C++.

The library is compiled from native/engine_glue.cpp at first use
(utils/native_build.py). align/engine.py falls back to the pure-Python
loops when it cannot be built, and tests assert both paths produce
identical SingleEndState results.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_i8 = ctypes.POINTER(ctypes.c_int8)
_u8 = ctypes.POINTER(ctypes.c_uint8)
_i16 = ctypes.POINTER(ctypes.c_int16)
_i32 = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.POINTER(ctypes.c_int64)


def available() -> bool:
    return get_lib() is not None


def get_lib():
    global _lib
    if _lib is None:
        from ..utils.native_build import ensure_built

        path = ensure_built("libpansvr_glue.so")
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.glue_collect.restype = ctypes.c_void_p
        lib.glue_collect.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i16, _i16, _i32, _i16, _i8, _i8, _i16, _i8,
            _u8, _u8, _i32, _u8, _u8, ctypes.c_int64,
            _i64, ctypes.c_int32, _i32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _i32,
        ]
        lib.glue_collect_paths.restype = ctypes.c_void_p
        lib.glue_collect_paths.argtypes = [
            ctypes.c_int32, ctypes.c_int32, _i32, ctypes.c_int32,
            _i32, _i32, _i16,
            _u8, _u8, _i32, _u8, ctypes.c_int64,
            _i64, ctypes.c_int32, _i32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _i32,
        ]
        lib.glue_req_sizes.argtypes = [ctypes.c_void_p, _i32, _i32]
        lib.glue_fill_dp.argtypes = [
            ctypes.c_void_p, _i32, ctypes.c_int32,
            _i32, _i32, _i32, _i32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.glue_req_meta.argtypes = [ctypes.c_void_p, _i32]
        lib.glue_set_dp_chunk.argtypes = [
            ctypes.c_void_p, _i32, ctypes.c_int32,
            _i8, ctypes.c_int32, _i32, ctypes.c_int32,
        ]
        lib.glue_set_dp_scalar.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, _u8, _i32, ctypes.c_int32,
        ]
        lib.glue_replay.argtypes = [ctypes.c_void_p]
        lib.glue_out_sizes.argtypes = [ctypes.c_void_p, _i64, _i64]
        lib.glue_copy_out.argtypes = [
            ctypes.c_void_p, _i32, _i32, _u8, _i32, _i32, _i32,
        ]
        lib.glue_free.argtypes = [ctypes.c_void_p]
        lib.glue_str_dup.argtypes = [
            _u8, _i32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32,
        ]
        lib.glue_signal_scan.argtypes = [
            _u8, _i64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32, _i32, _i32, _i32,
        ]
        lib.glue_bam_scan.restype = ctypes.c_int32
        lib.glue_bam_scan.argtypes = [
            _u8, ctypes.c_int64, ctypes.c_int32, _i64,
            _i64, _i32, _i32, _i32, _i32, _i32, _i32,
        ]
        lib.glue_signal_render.restype = ctypes.c_void_p
        lib.glue_signal_render.argtypes = [
            _u8, _i64, _i32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i64, _i32, _i32, _i32, _i32, _i32, _i64,
        ]
        lib.glue_signal_fq_fetch.argtypes = [ctypes.c_void_p, _u8]
        lib.glue_sv_load.argtypes = [
            _u8, _i64, ctypes.c_int32, _i32, _u8, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _i32, _u8, _i32, _i64,
            _u8, _i64,
        ]
        lib.glue_asm_run.restype = ctypes.c_void_p
        lib.glue_asm_run.argtypes = [
            _u8, _i64, ctypes.c_int32, _u8, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.glue_asm_sizes.argtypes = [ctypes.c_void_p, _i64]
        lib.glue_asm_copy.argtypes = [
            ctypes.c_void_p, _u8, _i64, _i32, _i64, _i32, _i64,
            _i32, _i64, _i32,
        ]
        lib.glue_asm_free.argtypes = [ctypes.c_void_p]
        lib.glue_extd2.restype = ctypes.c_int32
        lib.glue_extd2.argtypes = [
            _u8, ctypes.c_int32, _u8, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32, _u8, _i32,
        ]
        lib.glue_parse_comments.argtypes = [
            _u8, _i64, ctypes.c_int32, _i32,
        ]
        lib.glue_pe_emit.restype = ctypes.c_int64
        lib.glue_pe_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, _i32,
            _u8, _i64, _u8, _i64, _u8, _i64, _u8, _i64,
            _i32, _i32, _i32, _u8, _i64, _u8, _i64,
            _i32, _i32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _u8, _i64,
        ]
        lib.glue_emit_fetch.argtypes = [ctypes.c_void_p, _u8]
        lib.glue_stats_create.restype = ctypes.c_void_p
        lib.glue_stats_create.argtypes = [_i64, ctypes.c_int32]
        lib.glue_stats_scan.restype = ctypes.c_int64
        lib.glue_stats_scan.argtypes = [
            ctypes.c_void_p, _u8, ctypes.c_int64, _i32,
        ]
        lib.glue_stats_sizes.argtypes = [ctypes.c_void_p, _i64]
        lib.glue_stats_export.argtypes = [
            ctypes.c_void_p, _i32, _i64, _i32, _i64,
        ]
        lib.glue_stats_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def parse_comments(comments: list[str]) -> np.ndarray | None:
    """Signal comments -> (n, 8) int32 ori matrix
    [chr_id, ref_bg, read_bg, align_score, mapq, direction, unmapped, 0]
    (the native twin of pipeline.parse_signal_comment's OriResult).
    None when the library cannot be built."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(comments)
    off = np.zeros(n + 1, np.int64)
    if n:
        np.cumsum([len(c) for c in comments], out=off[1:])
    blob = np.frombuffer("".join(comments).encode() or b"\0", np.uint8)
    out = np.zeros((max(n, 1), 8), np.int32)
    if n:
        lib.glue_parse_comments(_p(blob, _u8), _p(off, _i64), n,
                                _p(out, _i32))
    return out[:n]


_EXTD2_OPS = "MID"


def extd2_native(lib, query: np.ndarray, target: np.ndarray, *,
                 match: int, mismatch: int, q: int, e: int, q2: int,
                 e2: int, w: int, zdrop: int, with_cigar: bool = True):
    """C++ extd2 (banded dual-affine DP + CIGAR), bit-identical to
    ops/ksw2_ref.extd2 (fuzz-tested). Returns an ops/ksw2_ref.Ez."""
    from ..ops.ksw2_ref import Ez

    qc = np.ascontiguousarray(query, np.uint8)
    tc = np.ascontiguousarray(target, np.uint8)
    scores = np.zeros(9, np.int32)
    cap = len(qc) + len(tc) + 2
    cig_op = np.zeros(cap, np.uint8)
    cig_len = np.zeros(cap, np.int32)
    n = lib.glue_extd2(
        _p(qc, _u8), len(qc), _p(tc, _u8), len(tc),
        match, mismatch, q, e, q2, e2, w, zdrop, int(with_cigar),
        _p(scores, _i32), _p(cig_op, _u8), _p(cig_len, _i32),
    )
    return Ez(
        score=int(scores[0]), mqe=int(scores[1]), mqe_t=int(scores[2]),
        mte=int(scores[3]), mte_q=int(scores[4]), max=int(scores[5]),
        max_q=int(scores[6]), max_t=int(scores[7]),
        zdropped=bool(scores[8]),
        cigar=[(_EXTD2_OPS[cig_op[k]], int(cig_len[k])) for k in range(n)],
    )


def signal_scan(lib, blob: bytes, offs: np.ndarray, *, min_isize: int,
                max_isize: int, max_tid: int, discard_full: bool,
                not_using_filter: bool, lowq_cutoff: int = 47):
    """One fc_signal block scanned natively: per-record score/clip/NM/XA
    columns, greedy in-block mate pairing, and the 7-rule pair filter.
    Returns (cols (n,8) int32, mate (n,), verdict (n,), reason (n,))."""
    n = len(offs) - 1
    blob_a = np.frombuffer(blob, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    cols = np.zeros((n, 8), np.int32)
    mate = np.zeros(n, np.int32)
    verdict = np.zeros(n, np.int32)
    reason = np.zeros(n, np.int32)
    lib.glue_signal_scan(
        _p(blob_a, _u8), _p(offs, _i64), n,
        min_isize, max_isize, max_tid,
        1 if discard_full else 0, 1 if not_using_filter else 0,
        lowq_cutoff,
        _p(cols, _i32), _p(mate, _i32), _p(verdict, _i32), _p(reason, _i32),
    )
    return cols, mate, verdict, reason


def bam_scan(lib, data):
    """Record boundaries + fixed-header columns of a decompressed BAM
    byte stream (complete records only). Returns (n, consumed, offs,
    lens, tid, pos, flag, l_seq, tlen). `data` may be bytes or a
    NumPy/bytearray buffer."""
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    cap = len(buf) // 36 + 2
    offs = np.empty(cap, np.int64)
    lens = np.empty(cap, np.int32)
    tid = np.empty(cap, np.int32)
    pos = np.empty(cap, np.int32)
    flag = np.empty(cap, np.int32)
    l_seq = np.empty(cap, np.int32)
    tlen = np.empty(cap, np.int32)
    consumed = np.zeros(1, np.int64)
    n = lib.glue_bam_scan(
        _p(buf, _u8), len(buf), cap, _p(consumed, _i64),
        _p(offs, _i64), _p(lens, _i32), _p(tid, _i32), _p(pos, _i32),
        _p(flag, _i32), _p(l_seq, _i32), _p(tlen, _i32),
    )
    return (n, int(consumed[0]), offs[:n], lens[:n], tid[:n], pos[:n],
            flag[:n], l_seq[:n], tlen[:n])


def signal_render(lib, blob, offs: np.ndarray, lens: np.ndarray, *,
                  mode: int, min_isize: int, max_isize: int, max_tid: int,
                  discard_full: bool, not_using_filter: bool,
                  emit_stat: bool, st_read_len: int, st_min: int,
                  st_mid: int, st_max: int, n_threads: int = 4,
                  lowq_cutoff: int = 47,
                  reason_counts: np.ndarray | None = None):
    """One fc_signal block parsed, paired, classified AND rendered to
    FASTQ bytes natively (mode 0 = positional in-block pairing, mode 1 =
    adjacent-name pairing of name-sorted phase-2 leftovers).
    Returns (fq_bytes, n_pairs, n_signal, stat_emitted, leftover_idx).
    reason_counts (int64[1024]) is accumulated in place when given."""
    n = len(lens)
    blob_a = np.frombuffer(blob, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    if reason_counts is None:
        reason_counts = np.zeros(1024, np.int64)
    fq_len = np.zeros(1, np.int64)
    n_pairs = np.zeros(1, np.int32)
    n_signal = np.zeros(1, np.int32)
    stat_emitted = np.zeros(1, np.int32)
    leftover = np.zeros(max(n, 1), np.int32)
    n_leftover = np.zeros(1, np.int32)
    h = lib.glue_signal_render(
        _p(blob_a, _u8), _p(offs, _i64), _p(lens, _i32), n, mode,
        min_isize, max_isize, max_tid,
        1 if discard_full else 0, 1 if not_using_filter else 0,
        lowq_cutoff,
        1 if emit_stat else 0, st_read_len, st_min, st_mid, st_max,
        n_threads,
        _p(fq_len, _i64), _p(n_pairs, _i32), _p(n_signal, _i32),
        _p(stat_emitted, _i32), _p(leftover, _i32), _p(n_leftover, _i32),
        _p(reason_counts, _i64),
    )
    fq = np.empty(int(fq_len[0]), np.uint8)
    lib.glue_signal_fq_fetch(ctypes.c_void_p(h), _p(fq, _u8))
    return (fq.tobytes(), int(n_pairs[0]), int(n_signal[0]),
            bool(stat_emitted[0]), leftover[: int(n_leftover[0])])


def sv_load(lib, blob: bytes, offs: np.ndarray, sv_meta: np.ndarray,
            sv_types: np.ndarray, min_score: int, full: bool):
    """Native fc_sv record conversion (tags + cigar_adjust + seq decode)
    over raw record bodies. Returns (nums (n,12) int32, cig_ops,
    cig_lens, cig_off, seq_bytes, seq_off) — the cigar/seq outputs are
    None when full=False."""
    n = len(offs) - 1
    blob_a = np.frombuffer(blob, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    nums = np.zeros((max(n, 1), 12), np.int32)
    if full:
        total = int(offs[-1])
        cap_cig = max(total // 4, 1)
        cap_seq = max(2 * total, 1)
        cig_ops = np.zeros(cap_cig, np.uint8)
        cig_lens = np.zeros(cap_cig, np.int32)
        cig_off = np.zeros(n + 1, np.int64)
        seq_blob = np.zeros(cap_seq, np.uint8)
        seq_off = np.zeros(n + 1, np.int64)
    else:
        cig_ops = np.zeros(1, np.uint8)
        cig_lens = np.zeros(1, np.int32)
        cig_off = np.zeros(max(n + 1, 2), np.int64)
        seq_blob = np.zeros(1, np.uint8)
        seq_off = np.zeros(max(n + 1, 2), np.int64)
    lib.glue_sv_load(
        _p(blob_a, _u8), _p(offs, _i64), n,
        _p(np.ascontiguousarray(sv_meta, np.int32), _i32),
        _p(np.ascontiguousarray(sv_types, np.uint8), _u8),
        sv_meta.shape[0], min_score, 1 if full else 0,
        _p(nums, _i32), _p(cig_ops, _u8), _p(cig_lens, _i32),
        _p(cig_off, _i64), _p(seq_blob, _u8), _p(seq_off, _i64),
    )
    if not full:
        return nums, None, None, None, None, None
    return nums, cig_ops, cig_lens, cig_off, seq_blob.tobytes(), seq_off


def asm_build_contigs(lib, reads: list, is_pseudo: list, wl: int,
                      min_coverage: int, min_conservative_coverage: int,
                      max_assembly_count: int, reject_read_reused: bool):
    """One word-length pass of the Manta-style assembler in C++
    (kmer maps + Tarjan repeats + greedy walks). Returns
    (success, global_max_count, contig dicts)."""
    blob = "".join(reads).encode()
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    pseudo = np.array(is_pseudo, np.uint8)
    blob_a = np.frombuffer(blob, np.uint8)
    ctx = lib.glue_asm_run(
        _p(blob_a, _u8), _p(offs, _i64), len(reads), _p(pseudo, _u8),
        wl, min_coverage, min_conservative_coverage, max_assembly_count,
        1 if reject_read_reused else 0,
    )
    sizes = np.zeros(7, np.int64)
    lib.glue_asm_sizes(ctx, _p(sizes, _i64))
    nc, n_seq, n_sup, n_rej, n_act, success, gmax = (int(x) for x in sizes)
    seq_blob = np.zeros(n_seq, np.uint8)
    seq_offs = np.zeros(nc + 1, np.int64)
    sup_ids = np.zeros(n_sup, np.int32)
    sup_offs = np.zeros(nc + 1, np.int64)
    rej_ids = np.zeros(n_rej, np.int32)
    rej_offs = np.zeros(nc + 1, np.int64)
    act_vals = np.zeros(3 * n_act, np.int32)
    act_offs = np.zeros(nc + 1, np.int64)
    meta = np.zeros((max(nc, 1), 8), np.int32)
    lib.glue_asm_copy(
        ctx, _p(seq_blob, _u8), _p(seq_offs, _i64), _p(sup_ids, _i32),
        _p(sup_offs, _i64), _p(rej_ids, _i32), _p(rej_offs, _i64),
        _p(act_vals, _i32), _p(act_offs, _i64), _p(meta, _i32),
    )
    lib.glue_asm_free(ctx)
    seq_bytes = seq_blob.tobytes()
    out = []
    for i in range(nc):
        a0, a1 = int(act_offs[i]), int(act_offs[i + 1])
        out.append(dict(
            seq=seq_bytes[seq_offs[i]:seq_offs[i + 1]].decode(),
            support=sup_ids[sup_offs[i]:sup_offs[i + 1]],
            reject=rej_ids[rej_offs[i]:rej_offs[i + 1]],
            actions=[(int(act_vals[3 * k]), int(act_vals[3 * k + 1]),
                      bool(act_vals[3 * k + 2])) for k in range(a0, a1)],
            meta=meta[i],
        ))
    return bool(success), gmax, out


def str_dup_counts(lib, codes: np.ndarray, lens: np.ndarray,
                   kmer_len: int) -> np.ndarray | None:
    """Per-row duplicate-k-mer counts (the STR pre-screen quantity)."""
    codes = np.ascontiguousarray(codes, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    n, L = codes.shape
    out = np.zeros(n, np.int32)
    lib.glue_str_dup(_p(codes, _u8), _p(lens, _i32), n, L, kmer_len,
                     _p(out, _i32))
    return out


def _p(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


class GlueBatch:
    """One batch's native collect/replay lifecycle."""

    @classmethod
    def from_paths(cls, lib, *, n_pad, L, chain_meta, path_a, path_b,
                   path_dfe, codes_f, codes_r, lens, packed_ref,
                   chr_starts, sv_st_pos, params):
        """Path-mode collect: chain selection + path gather ran on
        device (ops/collect.select_and_paths); only the compacted
        chain/path lanes reach C++."""
        self = cls.__new__(cls)
        self.lib = lib
        arrays = [chain_meta, path_a, path_b, path_dfe, codes_f, codes_r,
                  lens, packed_ref, chr_starts, sv_st_pos]
        dts = [np.int32, np.int32, np.int32, np.int16, np.uint8, np.uint8,
               np.int32, np.uint8, np.int64, np.int32]
        self._keep = [np.ascontiguousarray(a, dt)
                      for a, dt in zip(arrays, dts)]
        (chain_meta, path_a, path_b, path_dfe, codes_f, codes_r, lens,
         packed_ref, chr_starts, sv_st_pos) = self._keep
        n_req = np.zeros(1, np.int32)
        self.ctx = lib.glue_collect_paths(
            n_pad, L, _p(chain_meta, _i32), chain_meta.shape[0],
            _p(path_a, _i32), _p(path_b, _i32), _p(path_dfe, _i16),
            _p(codes_f, _u8), _p(codes_r, _u8), _p(lens, _i32),
            _p(packed_ref, _u8), len(packed_ref),
            _p(chr_starts, _i64), len(chr_starts) - 1, _p(sv_st_pos, _i32),
            params.match, params.mismatch, params.gap_open, params.gap_ex,
            params.gap_open2, params.gap_ex2, _p(n_req, _i32),
        )
        self.n_req = int(n_req[0])
        return self

    def __init__(self, lib, *, n_pad, L, K, s_rb, s_re, s_fb, s_dfe, pre,
                 hit_idx, hit_score, hit_final, codes_f, codes_r, lens,
                 active_mask, packed_ref, chr_starts, sv_st_pos, params):
        self.lib = lib
        # coerce to C-contiguous of the expected dtype (no-op copies on
        # the common path) and keep references alive for the ctx lifetime
        arrays = [s_rb, s_re, s_fb, s_dfe, pre, hit_idx, hit_score,
                  hit_final, codes_f, codes_r, lens, active_mask,
                  packed_ref, chr_starts, sv_st_pos]
        dts = [np.int16, np.int16, np.int32, np.int16, np.int8, np.int8,
               np.int16, np.int8, np.uint8, np.uint8, np.int32, np.uint8,
               np.uint8, np.int64, np.int32]
        self._keep = [np.ascontiguousarray(a, dt)
                      for a, dt in zip(arrays, dts)]
        (s_rb, s_re, s_fb, s_dfe, pre, hit_idx, hit_score, hit_final,
         codes_f, codes_r, lens, active_mask, packed_ref, chr_starts,
         sv_st_pos) = self._keep
        n_req = np.zeros(1, np.int32)
        self.ctx = lib.glue_collect(
            n_pad, L, K,
            _p(s_rb, _i16), _p(s_re, _i16), _p(s_fb, _i32), _p(s_dfe, _i16),
            _p(pre, _i8), _p(hit_idx, _i8), _p(hit_score, _i16),
            _p(hit_final, _i8),
            _p(codes_f, _u8), _p(codes_r, _u8), _p(lens, _i32),
            _p(active_mask, _u8),
            _p(packed_ref, _u8), len(packed_ref),
            _p(chr_starts, _i64), len(chr_starts) - 1, _p(sv_st_pos, _i32),
            params.match, params.mismatch, params.gap_open, params.gap_ex,
            params.gap_open2, params.gap_ex2, _p(n_req, _i32),
        )
        self.n_req = int(n_req[0])

    def req_sizes(self):
        ql = np.zeros(self.n_req, np.int32)
        tl = np.zeros(self.n_req, np.int32)
        if self.n_req:
            self.lib.glue_req_sizes(self.ctx, _p(ql, _i32), _p(tl, _i32))
        return ql, tl

    def req_meta(self):
        """(5, n_req) int32: flat query base, qlen_act, ref_st (clamped),
        tlen, reversed — enough for the DEVICE to build the DP code
        matrices from its resident read words + reference (saves the
        per-chunk qc/tc host-to-device copy)."""
        out = np.zeros((5, max(self.n_req, 1)), np.int32)
        if self.n_req:
            self.lib.glue_req_meta(self.ctx, _p(out, _i32))
        return out

    def fill_dp(self, members: np.ndarray, cq: int, ct: int, B: int):
        """Padded (B, cq)/(B, ct) int32 code matrices for one chunk."""
        qc = np.zeros((B, cq), np.int32)
        tc = np.zeros((B, ct), np.int32)
        ql = np.ones(B, np.int32)
        tl = np.ones(B, np.int32)
        members = np.ascontiguousarray(members, np.int32)
        self.lib.glue_fill_dp(self.ctx, _p(members, _i32), len(members),
                              _p(qc, _i32), _p(tc, _i32), _p(ql, _i32),
                              _p(tl, _i32), cq, ct)
        return qc, ql, tc, tl

    def set_dp_chunk(self, members: np.ndarray, ops: np.ndarray,
                     packed: np.ndarray):
        members = np.ascontiguousarray(members, np.int32)
        ops = np.ascontiguousarray(ops, np.int8)
        packed = np.ascontiguousarray(packed, np.int32)
        self.lib.glue_set_dp_chunk(
            self.ctx, _p(members, _i32), len(members),
            _p(ops, _i8), ops.shape[1], _p(packed, _i32), packed.shape[1],
        )

    def set_dp_scalar(self, req: int, ez):
        ops = np.array(
            [{"M": 0, "I": 1, "D": 2}[op] for op, _ in ez.cigar], np.uint8)
        lens = np.array([n for _, n in ez.cigar], np.int32)
        self.lib.glue_set_dp_scalar(
            self.ctx, req, int(ez.score), int(ez.mqe),
            1 if ez.zdropped else 0,
            _p(ops, _u8), _p(lens, _i32), len(ops),
        )

    def replay(self):
        """Returns (res_read, res_fields (N,8), cig_op, cig_len,
        res_cig_off, res_cig_n)."""
        self.lib.glue_replay(self.ctx)
        n_res = np.zeros(1, np.int64)
        n_cig = np.zeros(1, np.int64)
        self.lib.glue_out_sizes(self.ctx, _p(n_res, _i64), _p(n_cig, _i64))
        N, C = int(n_res[0]), int(n_cig[0])
        res_read = np.zeros(N, np.int32)
        res_fields = np.zeros((N, 8), np.int32)
        cig_op = np.zeros(C, np.uint8)
        cig_len = np.zeros(C, np.int32)
        res_cig_off = np.zeros(N, np.int32)
        res_cig_n = np.zeros(N, np.int32)
        if N:
            self.lib.glue_copy_out(
                self.ctx, _p(res_read, _i32), _p(res_fields, _i32),
                _p(cig_op, _u8), _p(cig_len, _i32), _p(res_cig_off, _i32),
                _p(res_cig_n, _i32),
            )
        return res_read, res_fields, cig_op, cig_len, res_cig_off, res_cig_n

    def replay_only(self):
        """glue_replay without copying result arrays back — the emit
        path consumes them in C++ (glue_pe_emit)."""
        self.lib.glue_replay(self.ctx)

    def pe_emit(self, n: int, ori8: np.ndarray, name_blob, name_off,
                seq_blob, seq_off, qual_blob, qual_off,
                comment_blob, comment_off, ec,
                skip_blob, skip_off) -> bytes:
        """PE pairing + BAM record encoding for the whole batch in C++;
        returns the concatenated encoded record stream (byte-identical
        to bam_out.emit_pair + io.bam._encode_record)."""
        sz = self.lib.glue_pe_emit(
            self.ctx, n, _p(ori8, _i32),
            _p(name_blob, _u8), _p(name_off, _i64),
            _p(seq_blob, _u8), _p(seq_off, _i64),
            _p(qual_blob, _u8), _p(qual_off, _i64),
            _p(comment_blob, _u8), _p(comment_off, _i64),
            _p(ec.sv_tid, _i32), _p(ec.sv_end_off, _i32),
            _p(ec.sv_key, _i32),
            _p(ec.svtag_blob, _u8), _p(ec.svtag_off, _i64),
            _p(ec.vcfid_blob, _u8), _p(ec.vcfid_off, _i64),
            _p(ec.ori_tid, _i32), _p(ec.ori_key, _i32), len(ec.ori_tid),
            ec.max_isize_adj, ec.min_isize_adj, ec.normal_read_len,
            _p(skip_blob, _u8), _p(skip_off, _i64),
        )
        out = np.empty(int(sz), np.uint8)
        if sz:
            self.lib.glue_emit_fetch(self.ctx, _p(out, _u8))
        return out.tobytes()

    def free(self):
        if self.ctx:
            self.lib.glue_free(self.ctx)
            self.ctx = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass
