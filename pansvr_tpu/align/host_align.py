"""Host reference implementation of the realignment engine (fc_aln).

Complete per-read-pair semantics of the reference's
single_end_handler::align + PE_score
(src/PanSVgenerateVCF/read_realignment.{hpp,cpp}), built on the index
query oracle (index/query.py), the scalar chaining reference
(ops/chain_ref.py) and the scalar DP reference (ops/ksw2_ref.py).

This module pins the glue semantics the device pipeline must reproduce
(STR detection, seed-skip rules, chain extraction cutoffs, the
get_ksw_score walk with its simple-compare fast path, CIGAR
reverse-merge, mapq, PE rescoring with SV end_offset insert-size logic).
The batched TPU pipeline in align/engine.py is validated against it.

Coordinates: packed-reference space is 0-based; emitted positions equal
the reference binary's emitted values (its two internal off-by-ones — the
anchor window shift and the chr_end_n offset — cancel, so its SAM POS
field is the 0-based genome position; verified in SURVEY notes).

Deliberate deviation: the reference breaks score ties with rand()
(read_realignment.cpp:246, hpp:553). We default to deterministic
last-wins/first-wins choices matching the C scan order with rand
removed; an optional rng reproduces the sampling distribution where it
matters statistically (expand_seed occurrence sampling).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..index import query as Q
from ..index.builder import RdBGIndex
from ..ops import chain_ref, ksw2_ref
from ..utils import dna

SEED_STEP = 5
LEN_KMER = 20
UNI_POS_N_MAX = 32
MIN_CHAIN_SCORE = 20         # hpp:31
MAX_CHAIN_SCORE_DIFF = 30    # cpp:396
MIN_CHAIN_SCORE_LOOP = 30    # cpp:397 (MIN_CHAIN_SOCRE)
MIN_ALN_SCORE = 40           # cpp:398
MAX_OUTPUT_NUMBER = 6
MIN_STR_REPEAT_COUNT = 4
MIN_STR_DETECT_LEN = 15
FORWARD, REVERSE = 0, 1


@dataclass
class AlignParams:
    match: int = 2
    mismatch: int = 12        # positive penalty, as the CLI flag
    gap_open: int = 16
    gap_ex: int = 1
    gap_open2: int = 32
    gap_ex2: int = 0
    zdrop: int = 400
    band: int = 200           # KSW_ALN_handler hardcodes 200 (cpp:817)


@dataclass(slots=True)
class OriResult:
    """Parsed original-alignment info from the signal comment
    (parse_ori_mapping_rst, hpp:392-429)."""
    chr_id: int = 0
    ref_bg: int = 0
    read_bg: int = 0          # soft-clip left
    align_score: int = 0
    mapq: int = 0
    direction: int = FORWARD
    unmapped: bool = True


@dataclass(slots=True)
class AlnResult:
    """MAX_IDX_OUTPUT equivalent."""
    align_score: int = 0
    chain_score: int = 0
    read_bg: int = 0
    mapq: int = 0
    chr_id: int = 0           # contig id pre-conversion; genome chrom after
    ref_bg: int = 0
    direction: int = FORWARD
    is_ori: bool = False
    cigar: list = field(default_factory=list)   # [(op, len)]
    sv_id: int = -1           # anchor contig index (sv_info)
    rst_idx: int = -1
    has_mate: bool = False
    mate_chr_id: int = 0
    mate_ref_bg: int = 0
    mate_sv_id: int = -1


class KswHandler:
    """KSW_ALN_handler (cpp:803-990): per-segment scoring + cigar."""

    LEFT, RIGHT, END2END = 0, 1, 2

    def __init__(self, idx: RdBGIndex, p: AlignParams):
        self.idx = idx
        self.p = p
        # packed reference cached on the index object: KswHandlers are
        # constructed per batch worker and this array is O(ref_len)
        if not hasattr(idx, "_packed_ref_cache"):
            idx._packed_ref_cache = np.where(
                idx.ref_codes >= 4, np.uint8(2), idx.ref_codes
            )
        self.packed_ref = idx._packed_ref_cache
        self._dp_lib = None   # lazy native-DP handle (False = unavailable)
        self.reset(None)

    def reset(self, read_codes):
        self.read = read_codes
        self.cigar_tmp: list[tuple[str, int]] = []
        self.read_score = 0
        self.total_q_len = 0
        self.is_simple = False

    def _ref(self, st, ln):
        """Fetch packed reference codes; out-of-range bases read as 0
        ('A'), mirroring the reference's zero-calloc'd overflow region
        (deBGA_index.cpp:37 loads ref.seq with 536 spare zero bytes)."""
        st = max(st, 0)
        seg = self.packed_ref[st : st + ln]
        if len(seg) < ln:
            seg = np.concatenate([seg, np.zeros(ln - len(seg), dtype=np.uint8)])
        return seg

    def get_mismatch(self, read_st, read_ed, ref_st, ref_ed) -> int:
        qlen = read_ed - read_st
        tlen = ref_ed - ref_st
        if ref_ed < ref_st:
            tlen = 0
            qlen += ref_st - ref_ed
        q = self.read[read_st : read_st + qlen]
        t = self._ref(ref_st, tlen)
        n = min(len(q), len(t))
        nm = int(np.count_nonzero(q[:n] != t[:n])) + (len(q) - n)
        return min(nm, 3)  # cap (cpp:921)

    def alignment(self, read_st, read_ed, ref_st, ref_ed, type_):
        p = self.p
        qlen = read_ed - read_st
        tlen = ref_ed - ref_st
        if ref_ed < ref_st:
            tlen = 0
            qlen += ref_st - ref_ed
        qseq = self.read[read_st : read_st + qlen]
        tseq = self._ref(ref_st, tlen)
        if type_ == self.LEFT:
            qseq = qseq[::-1]
            tseq = tseq[::-1]
        self.total_q_len += qlen

        # simple-compare fast path (cpp:945-955)
        self.is_simple = False
        simple_nm = 0
        if qlen == 0 or tlen == 0:
            self.is_simple = True
            simple_nm = qlen + tlen
        elif qlen == tlen or type_ != self.END2END:
            n = min(qlen, tlen)
            # the reference scans until the 6th mismatch (cpp:947-951);
            # the count it ends with is min(total, 6)
            simple_nm = min(
                int(np.count_nonzero(qseq[:n] != tseq[:n])), 6
            )
            if simple_nm == 1 or (simple_nm < 6 and (simple_nm << 3) < qlen):
                self.is_simple = True

        if self.is_simple:
            if qlen == 0 or tlen == 0:
                if simple_nm != 0:
                    s1 = p.gap_open + (simple_nm - 1) * p.gap_ex
                    s2 = p.gap_open2 + (simple_nm - 1) * p.gap_ex2
                    self.read_score -= min(s1, s2)
            else:
                self.read_score += qlen * p.match - simple_nm * (p.match + p.mismatch)
            if qlen == 0:
                self._push("D", tlen)
            elif tlen == 0:
                self._push("I", qlen)
            else:
                self._push("M", qlen)
            if ref_ed < ref_st:
                self._push("D", ref_ed - ref_st)  # negative-size marker
            return

        # full DP (align_non_splice, cpp:893-915)
        if qlen * tlen > 1_000_000:
            self._push("I", qlen)
            self._push("D", tlen)  # dummy, score 0 (cpp:895-907)
            return
        ez = self._run_dp(qseq, tseq)
        if type_ == self.END2END:
            self.read_score += ez.score if ez.score != ksw2_ref.NEG_INF else 0
            for op, n in reversed(ez.cigar):
                self._push(op, n)
        elif type_ == self.LEFT:
            self.read_score += ez.mqe if ez.mqe != ksw2_ref.NEG_INF else 0
            for op, n in ez.cigar:
                self._push(op, n)
        else:  # RIGHT
            self.read_score += ez.mqe if ez.mqe != ksw2_ref.NEG_INF else 0
            for op, n in reversed(ez.cigar):
                self._push(op, n)

    def _run_dp(self, qseq, tseq):
        """Banded dual-affine DP for one segment. Overridden by the batched
        engine to collect/replay requests against the device kernel.
        Uses the native C++ kernel when built (bit-identical to the
        ksw2_ref oracle, fuzz-tested in tests/test_native_glue.py)."""
        p = self.p
        if self._dp_lib is None:
            from . import native_glue

            self._dp_lib = native_glue.get_lib() or False
        if self._dp_lib:
            from . import native_glue

            return native_glue.extd2_native(
                self._dp_lib, qseq, tseq, match=p.match,
                mismatch=-p.mismatch, q=p.gap_open, e=p.gap_ex,
                q2=p.gap_open2, e2=p.gap_ex2, w=p.band, zdrop=p.zdrop,
            )
        return ksw2_ref.extd2(
            qseq, tseq, match=p.match, mismatch=-p.mismatch,
            q=p.gap_open, e=p.gap_ex, q2=p.gap_open2, e2=p.gap_ex2,
            w=p.band, zdrop=p.zdrop,
        )

    def _push(self, op, n):
        self.cigar_tmp.append((op, n))


def reverse_merge_cigar(cigar_tmp: list, read_len: int) -> list | None:
    """reverseGIGAR (hpp:277-301): reverse piece order, merge adjacent
    same-type ops, fold negative-size D into the preceding op, validate
    query length."""
    if not cigar_tmp:
        return None
    out = [list(cigar_tmp[-1])]
    for op, n in reversed(cigar_tmp[:-1]):
        top = out[-1]
        if n < 0:
            # negative deletion folds into previous (try_merge, hpp:157-170)
            assert op == "D"
            if top[0] == "M":
                top[1] += n
                if top[1] <= 0:
                    return None
            elif top[0] == "D":
                top[1] -= n
            else:
                return None
        elif top[0] == op or n == 0:
            top[1] += n
        else:
            out.append([op, n])
    if out and out[0][1] == 0:
        out.pop(0)
    total = sum(n for op, n in out if op in ("M", "I", "N", "S"))
    if total != read_len:
        return None
    return [(op, n) for op, n in out]


@dataclass(slots=True)
class SingleEndState:
    results: list
    ori: OriResult
    ori_unmapped: bool
    read_codes_fwd: np.ndarray
    read_codes_rev: np.ndarray
    primary: AlnResult | None = None
    secondary: AlnResult | None = None


class HostAligner:
    """Per-read alignment engine (single_end_handler equivalent)."""

    def __init__(self, idx: RdBGIndex, params: AlignParams | None = None,
                 rng: np.random.Generator | None = None,
                 ori_chrom_names: list[str] | None = None):
        self.idx = idx
        self.p = params or AlignParams()
        self.rng = rng or np.random.default_rng(0)
        self.ksw = KswHandler(idx, self.p)
        # original-BAM-header contig names: map ori tid <-> chrom name so PE
        # pairing can compare an ori result's chrom with an anchor's chrom
        self.ori_chrom_names = ori_chrom_names or []
        # anchor metadata per contig
        from ..anchor.builder import AnchorContig
        self.sv_info = [AnchorContig.parse_name(n) for n in idx.chr_names]

    # ---- seeding + chaining ---------------------------------------------

    def _detect_str(self, codes: np.ndarray):
        """STR/VNTR detection on the forward read (cpp:551-600).
        Returns (is_str, seed_list or None)."""
        n_kmer = len(codes) - LEN_KMER + 1
        if n_kmer <= 0:
            return False, None
        kmers = dna.kmer_codes(codes, LEN_KMER)
        uniq, counts = np.unique(kmers, return_counts=True)
        if len(uniq) >= n_kmer - MIN_STR_DETECT_LEN:
            return False, None
        cmap = dict(zip(uniq.tolist(), counts.tolist()))
        seed_list = np.array(
            [0 if cmap[k] >= MIN_STR_REPEAT_COUNT else 1 for k in kmers.tolist()],
            dtype=np.int32,
        )
        bg_str = int(np.sum(seed_list[:SEED_STEP] == 0))
        ed_str = int(np.sum(seed_list[n_kmer - SEED_STEP :] == 0))
        seed_list[:SEED_STEP] += 2
        # reference indexes read_l - LEN_KMER - i for i in 0..4
        for i in range(SEED_STEP):
            seed_list[n_kmer - 1 - i] += 4
        if bg_str < SEED_STEP and ed_str < SEED_STEP:
            picked = 0
            for off in range(n_kmer):
                if picked >= SEED_STEP:
                    break
                if seed_list[off] > 0:
                    continue
                seed_list[off] += 8
                picked += 1
        return True, seed_list

    def _seed_read(self, codes: np.ndarray, seed_list) -> list[Q.MEM]:
        idx = self.idx
        n_kmer = len(codes) - LEN_KMER + 1
        mems: list[Q.MEM] = []
        max_search_right = 0
        for off in range(0, n_kmer, SEED_STEP):
            if off + LEN_KMER - 1 <= max_search_right:
                continue
            if seed_list is not None and seed_list[off] == 0:
                continue
            window = codes[off : off + LEN_KMER]
            if (window >= 4).any():
                kmer = None
            else:
                kmer = Q.kmer_value(codes, off, LEN_KMER)
            if kmer is None:
                continue
            rng_res = Q.search_kmer(idx, kmer)
            if rng_res is None:
                continue
            lo, hi = rng_res
            if hi - lo > UNI_POS_N_MAX:
                continue
            max_right = 1
            for e in range(lo, hi):
                m = Q.mem_extend(idx, e, codes, off)
                mems.append(m)
                right = m.length - LEN_KMER - (off - m.read_pos) + 1
                max_right = max(max_right, right)
            max_search_right = off + LEN_KMER + max_right - 1
        return mems

    def _chain_direction(self, codes, is_str, seed_list):
        mems = self._seed_read(codes, seed_list)
        merged = Q.merge_seeds(mems)
        seeds = Q.expand_seeds(self.idx, merged, rng=self.rng)
        return chain_ref.chain_seeds(seeds, is_str=is_str)

    # ---- scoring walk (get_ksw_score, cpp:306-400) ----------------------

    def _score_chain(self, g: chain_ref.ChainGraph, max_index: int,
                     read_codes: np.ndarray):
        ksw = self.ksw
        ksw.reset(read_codes)
        p = self.p
        read_l = len(read_codes)
        MAXI = 0x7FFFFFFF

        aln_read_begin = read_l
        aln_read_end = read_l
        aln_ref_begin = MAXI
        aln_ref_end = MAXI
        last_aln_begin = read_l
        last_ref_begin = MAXI
        unitig_mis = 0

        node = max_index
        while True:
            mem_read_beg = int(g.read_begin[node])
            mem_read_end = int(g.read_end[node])
            mem_ref_beg = int(g.ref_begin[node])
            mem_ref_end = int(g.ref_end[node])

            aln_read_begin = min(aln_read_begin, mem_read_end)
            aln_ref_begin = min(aln_ref_begin, mem_ref_end)
            if aln_read_begin <= aln_read_end:
                if aln_read_end < last_aln_begin:
                    mem_len = last_aln_begin - aln_read_end
                    unitig_mis += ksw.get_mismatch(
                        aln_read_end, aln_read_end + mem_len,
                        last_ref_begin, last_ref_begin + mem_len,
                    )
                    ksw._push("M", mem_len)
                last_aln_begin = aln_read_begin
                if aln_ref_end == MAXI:
                    aln_ref_end = aln_ref_begin + (aln_read_end - aln_read_begin) + 30
                    ksw.alignment(aln_read_begin, aln_read_end,
                                  aln_ref_begin, aln_ref_end, KswHandler.RIGHT)
                else:
                    ksw.alignment(aln_read_begin, aln_read_end,
                                  aln_ref_begin, aln_ref_end, KswHandler.END2END)
            else:
                d_read = aln_read_end - aln_read_begin
                d_ref = aln_ref_end - aln_ref_begin
                if d_read != d_ref:
                    dl = abs(d_ref - d_read)
                    s1 = p.gap_open + (dl - 1) * p.gap_ex
                    s2 = p.gap_open2 + (dl - 1) * p.gap_ex2
                    ksw.read_score -= min(s1, s2)
            aln_read_end = mem_read_beg
            last_ref_begin = mem_ref_beg
            aln_ref_end = mem_ref_beg
            nxt = int(g.pre[node])
            if nxt == -1:
                break
            node = nxt

        if aln_read_end < last_aln_begin:
            mem_len = last_aln_begin - aln_read_end
            unitig_mis += ksw.get_mismatch(
                aln_read_end, aln_read_end + mem_len,
                last_ref_begin, last_ref_begin + mem_len,
            )
            ksw._push("M", mem_len)

        read_begin_alignment = 0
        if 0 < aln_read_end:
            ref_begin = max(0, aln_ref_end - aln_read_end - 30)
            ksw.alignment(0, aln_read_end, ref_begin, aln_ref_end,
                          KswHandler.LEFT)
            if aln_ref_end > ref_begin:
                if ksw.is_simple:
                    read_begin_alignment = aln_ref_end - ref_begin - 30
                else:
                    read_begin_alignment = aln_ref_end - ref_begin
        ksw.read_score += (read_l - ksw.total_q_len) * p.match
        ksw.read_score -= unitig_mis * (p.match + p.mismatch)
        return read_begin_alignment, ksw.read_score, ksw.cigar_tmp

    # ---- full single-end align (cpp:402-476) ----------------------------

    def align_read(self, seq: str, ori: OriResult) -> SingleEndState:
        p = self.p
        read_l = len(seq)
        codes_fwd = dna.fill_n(dna.encode(seq), seed=0)
        codes_rev = (codes_fwd[::-1] ^ 3).astype(np.uint8)
        st = SingleEndState(
            results=[], ori=ori,
            ori_unmapped=ori.unmapped or ori.chr_id > 24,
            read_codes_fwd=codes_fwd, read_codes_rev=codes_rev,
        )
        if not st.ori_unmapped and ori.align_score == read_l * p.match:
            return st  # refuse full-score reads (cpp:417)

        is_str, seed_list = self._detect_str(codes_fwd)
        graphs = []
        for d, codes in ((FORWARD, codes_fwd), (REVERSE, codes_rev)):
            sl = seed_list
            if d == REVERSE and sl is not None:
                sl = sl[::-1]
            graphs.append(self._chain_direction(codes, is_str, sl))

        results: list[AlnResult] = []
        chain_meta = []  # (graph, max_index) per result
        max_chain_score = 0
        for d in (FORWARD, REVERSE):
            g = graphs[d]
            for _ in range(MAX_OUTPUT_NUMBER):
                hit = chain_ref.extract_chain(g, rng=None)
                if hit is None:
                    break
                cs = int(hit.chain_score)
                max_chain_score = max(max_chain_score, cs)
                if cs + MAX_CHAIN_SCORE_DIFF < max_chain_score or cs < MIN_CHAIN_SCORE_LOOP:
                    break
                r = AlnResult(
                    chain_score=cs, direction=d,
                    read_bg=hit.read_begin, ref_bg=hit.ref_begin,
                )
                cid = self.idx.chr_of_pos(hit.ref_begin)
                r.chr_id = cid
                r.ref_bg = hit.ref_begin - int(self.idx.chr_starts[cid])
                results.append(r)
                chain_meta.append((g, hit.max_index))

        if not results or max_chain_score < MIN_CHAIN_SCORE:
            return st
        order = sorted(
            range(len(results)),
            key=lambda i: (-results[i].chain_score, chain_meta[i][1]),
        )
        results = [results[i] for i in order]
        chain_meta = [chain_meta[i] for i in order]

        kept = []
        for r, (g, mi) in zip(results, chain_meta):
            if r.chain_score + MAX_CHAIN_SCORE_DIFF < max_chain_score:
                break
            codes = codes_rev if r.direction == REVERSE else codes_fwd
            rba, score, cigar_tmp = self._score_chain(g, mi, codes)
            r.ref_bg -= rba
            r.align_score = max(score, 0)
            cig = reverse_merge_cigar(cigar_tmp, read_l)
            r.cigar = cig or []
            kept.append(r)
        kept.sort(key=lambda r: -r.align_score)
        if not kept or kept[0].align_score < MIN_ALN_SCORE:
            return st

        for i, r in enumerate(kept):
            r.sv_id = r.chr_id
            info = self.sv_info[r.sv_id]
            r.chr_id = -1  # resolved by caller via info.chrom
            r.ref_bg += info.st_pos - 1  # see module docstring: cancels to pos0
            r.is_ori = False
            r.rst_idx = i
            r.mapq = 0
        pri_minus_sec = kept[0].align_score - (kept[1].align_score if len(kept) > 1 else 0)
        kept[0].mapq = min(40, pri_minus_sec)
        st.results = kept
        return st

    def sv_of(self, r: AlnResult):
        return self.sv_info[r.sv_id] if r.sv_id >= 0 else None


# ---- PE pairing (PE_score, hpp:434-628) ---------------------------------

@dataclass(slots=True)
class PEPairing:
    max_score: int = 0
    max_1: AlnResult | None = None
    max_2: AlnResult | None = None
    isize: int = 0
    proper_mated: bool = False
    gain_better: bool = False


class PEScorer:
    def __init__(self, aligner: HostAligner, max_isize: int, min_isize: int,
                 normal_read_len: int):
        self.aligner = aligner
        self.max_isize = max_isize + 200
        self.min_isize = max(0, min_isize - 200)
        self.normal_read_len = normal_read_len

    def _end_offset(self, r: AlnResult) -> int:
        if r.is_ori or r.sv_id < 0:
            return 0
        return self.aligner.sv_info[r.sv_id].end_offset

    def _get_isize(self, p1, p2, d1, d2):
        if d1 == d2:
            return 0
        isize = self.normal_read_len + ((p2 - p1) if d1 == FORWARD else (p1 - p2))
        return isize if self.min_isize < isize < self.max_isize else 0

    def _proper_mated(self, se1, se2):
        if se1 is None or se2 is None:
            return 0
        c1 = self._emit_chrom(se1)
        c2 = self._emit_chrom(se2)
        if c1 != c2:
            return 0
        p1a = se1.ref_bg
        p1b = p1a + self._end_offset(se1)
        p2a = se2.ref_bg
        p2b = p2a + self._end_offset(se2)
        for pa, pb in ((p1a, p2a), (p1a, p2b), (p1b, p2a), (p1b, p2b)):
            isize = self._get_isize(pa, pb, se1.direction, se2.direction)
            if isize > 0:
                return isize
        return 0

    def _emit_chrom(self, r: AlnResult):
        """Chrom identity as a name string (the reference compares int tids
        resolved through the original BAM header)."""
        if r.is_ori:
            names = self.aligner.ori_chrom_names
            return names[r.chr_id] if 0 <= r.chr_id < len(names) else f"#{r.chr_id}"
        return self.aligner.sv_info[r.sv_id].chrom if r.sv_id >= 0 else "?"

    def pair(self, st1: SingleEndState, st2: SingleEndState) -> PEPairing:
        out = PEPairing()

        def candidates(st):
            c = list(st.results)
            if not st.ori_unmapped:
                c.append(self._ori_as_result(st))
            return c

        c1 = candidates(st1)
        c2 = candidates(st2)
        combos = (
            [(a, None) for a in c1]
            + [(None, b) for b in c2]
            + [(a, b) for a in c1 for b in c2]
        )
        for se1, se2 in combos:
            isize = self._proper_mated(se1, se2)
            basic = (se1.align_score if se1 else 0) + (se2.align_score if se2 else 0)
            final = basic + (0 if isize > 0 else -60) + (
                0 if ((se1 and not se1.is_ori) or (se2 and not se2.is_ori)) else 1
            )
            if final >= out.max_score:
                out.max_1, out.max_2 = se1, se2
                out.max_score = final
                out.isize = isize
                out.proper_mated = isize > 0
        out.gain_better = (
            out.max_score > 0
            and ((out.max_1 is not None and not out.max_1.is_ori)
                 or (out.max_2 is not None and not out.max_2.is_ori))
        )
        return out

    @staticmethod
    def _ori_as_result(st: SingleEndState) -> AlnResult:
        o = st.ori
        read_l = len(st.read_codes_fwd)
        cig = []
        if o.read_bg > 0:
            cig.append(("S", o.read_bg))
        cig.append(("M", read_l - o.read_bg))
        return AlnResult(
            align_score=o.align_score, chain_score=0, read_bg=o.read_bg,
            mapq=o.mapq, chr_id=o.chr_id,
            ref_bg=1 if o.ref_bg >= 0x7FFFFFFF else o.ref_bg,
            direction=o.direction, is_ori=True, cigar=cig, sv_id=-1,
        )
