"""SV-region assembly + VCF verdict (stage `fc_sv`).

Behavioral re-implementation of src/PanSVgenerateVCF/SignalAssembly.{hpp,cpp}
+ signalSAMLoader.hpp + SV_ref_sequence.hpp: load realigned reads grouped
by anchor-contig (SV tag), cluster nearby same-type SVs and pick the best
cluster member, assemble 300-bp blocks with the word-ladder assembler,
vote contig positions from the read-action journal, align contigs back to
the anchor with the contig scoring profile (2/10/24,2/32,1, band=zdrop=132),
build the per-base event matrix, and emit a PASS/FAIL VCF per SV.

Coordinates: we keep true anchor-contig offsets (the reference's pipeline
carries a systematic -1 from its position emission which its own
break-point constants absorb; ours uses bp1 = edge_len + 1 and
bp2 = contig_len - edge_len, the true offsets of the anchor breakpoints
in contig space — see align/host_align.py docstring).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..anchor.builder import AnchorContig
from ..io.bam import BamReader, cigar_adjust
from ..io.vcf import VCFRecord
from ..ops import ksw2_ref
from ..utils import dna
from .assembler import AssemblyManager

MIN_NEW_SUPPORT_READ = 2
SCORE_DIFF_L1 = 35
MAX_INDEL_LEN = 80
HEAD_MIN_MATCH_BASE = 20


@dataclass
class SvCallOptions:
    min_score: int = 50
    edge_len: int = 500
    max_cluster_distance: int = 150
    ab_block_size: int = 300
    rsf_block_size: int = 32
    normal_read_len: int = 150
    ave_read_depth: float = 30.0
    print_detail: bool = False     # -D: per-read pileup renderings
    depth_detail: bool = False     # -d: event-matrix dumps
    st_chr: int = 0
    ed_chr: int = 10_000


class SVRefSequence:
    """Anchor metadata + sequences + SV clustering (SV_ref_sequence)."""

    def __init__(self, contig_names: list[str], contig_seqs: dict,
                 ori_genome, ori_chrom_names: list[str],
                 max_cluster_distance: int = 150):
        self.sv_info = [AnchorContig.parse_name(n) for n in contig_names]
        self._seqs = contig_seqs          # name -> sequence str
        self._names = contig_names
        self.ori_genome = ori_genome      # Faidx-like over the ORIGINAL genome
        self.ori_chrom_names = ori_chrom_names
        self.used = [False] * len(self.sv_info)
        self._build_clusters(max_cluster_distance)

    def _build_clusters(self, max_dist: int):
        """build_SV_Cluster (SV_ref_sequence.hpp:183-215): chain same-chrom
        same-type SVs whose start positions step by <= max_dist."""
        n = len(self.sv_info)
        self.next_sv = [None] * n
        self.cluster_of = list(range(n))
        clustered = [False] * n
        for i in range(n):
            if clustered[i]:
                continue
            clustered[i] = True
            chrom = self.sv_info[i].chrom
            svt = self.sv_info[i].sv_type
            begin_pos = self.sv_info[i].st_pos
            prev = i
            for j in range(i + 1, n):
                if abs(self.sv_info[j].st_pos - begin_pos) > max_dist:
                    break
                if (self.sv_info[j].chrom == chrom
                        and self.sv_info[j].sv_type == svt
                        and not clustered[j]):
                    clustered[j] = True
                    begin_pos = max(begin_pos, self.sv_info[j].st_pos)
                    self.next_sv[prev] = j
                    self.cluster_of[j] = i
                    prev = j

    def cluster_members(self, sv_id: int) -> list[int]:
        root = self.cluster_of[sv_id]
        out = [root]
        while self.next_sv[out[-1]] is not None:
            out.append(self.next_sv[out[-1]])
        return out

    def sv_seq_codes(self, sv_id: int) -> np.ndarray:
        seq = self._seqs[self._names[sv_id]]
        codes = dna.encode(seq)
        return np.where(codes >= 4, np.uint8(2), codes)


@dataclass
class LoadedRead:
    pos: int            # contig-space offset (0-based, post cigar_adjust)
    cigar: list
    seq: str
    mapq: int
    score: int          # AS
    ori_score: int      # OS
    has_cs: bool        # new alignment (CS tag present)
    ori_unmapped: bool  # OA ends with 'U'
    xa_num: int
    rc_mapq: int
    rc_chr_id: int
    rec: object = None  # source record view (for the -D detail channel)


_CIGAR_OPS = "MIDNSHP=X"


def _sv_meta_arrays(sv_infos):
    """Flat per-SV metadata for the native loader (glue_sv_load)."""
    n = len(sv_infos)
    meta = np.zeros((max(n, 1), 5), np.int32)
    types = np.full(max(n, 1), 2, np.uint8)
    for i, info in enumerate(sv_infos):
        meta[i] = (info.st_pos, info.ed_pos, info.bp1, info.bp2,
                   info.length)
        types[i] = 0 if info.sv_type == "INS" else (
            1 if info.sv_type == "DEL" else 2)
    return meta, types


def _rec_to_loaded(rec, sv_infos) -> tuple[int, LoadedRead] | None:
    """signalSAMLoader per-record semantics: keep reads with AS >=
    min_score (checked by callers) and an SV tag, cigar_adjust(4,
    add_blank), region-2 position shift for original alignments;
    position converted to contig space."""
    sv_tag = rec.get_tag("SV")
    if sv_tag is None:
        return None
    score = rec.get_tag("AS") or 0
    cs = rec.get_tag("CS")
    if cs is None and rec.isize == 0:
        return None
    sv_id = int(str(sv_tag).split("_")[0])
    if sv_id >= len(sv_infos):
        return None
    info = sv_infos[sv_id]
    cig, pos_adj = cigar_adjust(rec.cigar, delete_small_tail=4,
                                add_blank=True)
    pos = rec.pos + pos_adj
    if cs is None and info.bp2 < pos < info.ed_pos:
        # original alignment right of the SV: shift into contig space
        if info.sv_type == "INS":
            adj = info.length - (info.bp1 - info.st_pos) - (info.ed_pos - info.bp2)
        elif info.sv_type == "DEL":
            adj = info.bp1 - info.bp2
        else:
            adj = 0
        pos += adj
    # genome pos -> contig offset (emitted pos = st_pos - 1 + offset)
    contig_pos = pos - (info.st_pos - 1)
    oa = str(rec.get_tag("OA") or ",,,,M;")
    rc = str(rec.get_tag("RC") or "")
    rc_fields = rc.split(",") if rc else []
    xa_num = 0
    rc_mapq = 60
    rc_chr = 0
    if len(rc_fields) >= 7:
        try:
            rc_chr = int(rc_fields[0])
            rc_mapq = int(rc_fields[4])
            xa_num = int(rc_fields[6])
        except ValueError:
            pass
    return sv_id, LoadedRead(
        pos=contig_pos, cigar=cig, seq=rec.seq, mapq=rec.mapq,
        score=score, ori_score=rec.get_tag("OS") or 0,
        has_cs=cs is not None,
        ori_unmapped=oa.rstrip(";").endswith("U"),
        xa_num=xa_num, rc_mapq=rc_mapq, rc_chr_id=rc_chr,
        rec=rec,
    )


def load_reads_by_sv(bam_path: str, sv_infos: list, min_score: int = 50):
    """Whole-file variant: group by SV id, sorted by position."""
    by_sv: dict[int, list[LoadedRead]] = {}
    with BamReader(bam_path) as rd:
        for rec in rd:
            if (rec.get_tag("AS") or 0) < min_score:
                continue
            out = _rec_to_loaded(rec, sv_infos)
            if out is not None:
                by_sv.setdefault(out[0], []).append(out[1])
    for lst in by_sv.values():
        lst.sort(key=lambda r: r.pos)
    return by_sv


class SvReadIndex:
    """Memory-bounded loader: one streaming pass records each kept
    record's (uncompressed offset, length) keyed by SV id — ints only —
    then each SV's reads are materialized on demand through block-level
    random access (io.bam.BamRandomReader). Same filters and per-SV
    ordering as load_reads_by_sv, so results are identical with memory
    O(region) instead of O(file) (signalSAMLoader.hpp:79-157 contract)."""

    def __init__(self, bam_path: str, sv_infos: list, min_score: int = 50):
        from ..align import native_glue
        from ..io.bam import BamRandomReader, BamReaderOffsets

        self.sv_infos = sv_infos
        self.min_score = min_score
        self.spans: dict[int, list[tuple[int, int]]] = {}
        self._lib = native_glue.get_lib()
        self._meta, self._types = _sv_meta_arrays(sv_infos)
        rd = BamReaderOffsets(bam_path)
        try:
            if self._lib is not None:
                self._index_native(rd)
            else:
                for uoff, ln, rec in rd.iter_with_spans():
                    if (rec.get_tag("AS") or 0) < min_score:
                        continue
                    sv_tag = rec.get_tag("SV")
                    if sv_tag is None:
                        continue
                    if rec.get_tag("CS") is None and rec.isize == 0:
                        continue
                    sv_id = int(str(sv_tag).split("_")[0])
                    if sv_id >= len(sv_infos):
                        continue
                    self.spans.setdefault(sv_id, []).append((uoff, ln))
        finally:
            rd.close()
        self._rand = BamRandomReader(bam_path)

    def _index_native(self, rd, block=100_000):
        """Index pass over raw bodies in one native call per block."""
        from ..align import native_glue

        bodies: list[bytes] = []
        spans: list[tuple[int, int]] = []

        def flush():
            if not bodies:
                return
            offs = np.zeros(len(bodies) + 1, np.int64)
            np.cumsum([len(b) for b in bodies], out=offs[1:])
            nums, *_ = native_glue.sv_load(
                self._lib, b"".join(bodies), offs, self._meta, self._types,
                self.min_score, full=False)
            for i in np.nonzero(nums[:, 0])[0]:
                self.spans.setdefault(int(nums[i, 1]), []).append(spans[i])
            bodies.clear()
            spans.clear()

        for uoff, ln, body in rd.iter_bodies_with_spans():
            bodies.append(body)
            spans.append((uoff, ln))
            if len(bodies) >= block:
                flush()
        flush()

    def sv_ids(self):
        return sorted(self.spans)

    def get(self, sv_id: int, default=None):
        if sv_id not in self.spans:
            return default if default is not None else []
        if self._lib is not None:
            out = self._get_native(sv_id)
        else:
            out = []
            for uoff, ln in self.spans[sv_id]:
                rec = self._rand.record_at(uoff, ln)
                conv = _rec_to_loaded(rec, self.sv_infos)
                if conv is not None:
                    out.append(conv[1])
        out.sort(key=lambda r: r.pos)
        return out

    def _get_native(self, sv_id: int):
        from ..align import native_glue
        from ..io.bam import LazyBamRecord

        bodies = [self._rand.read_span(uoff, ln)[4:]
                  for uoff, ln in self.spans[sv_id]]
        offs = np.zeros(len(bodies) + 1, np.int64)
        np.cumsum([len(b) for b in bodies], out=offs[1:])
        nums, cig_ops, cig_lens, cig_off, seq_bytes, seq_off = \
            native_glue.sv_load(
                self._lib, b"".join(bodies), offs, self._meta, self._types,
                self.min_score, full=True)
        out = []
        for i in range(len(bodies)):
            keep = int(nums[i, 0])
            if keep == 0:
                continue
            if keep == 2:  # >512 cigar ops: exact Python fallback
                conv = _rec_to_loaded(LazyBamRecord(bodies[i]),
                                      self.sv_infos)
                if conv is not None:
                    out.append(conv[1])
                continue
            c0, c1 = int(cig_off[i]), int(cig_off[i + 1])
            cig = [(_CIGAR_OPS[cig_ops[k]], int(cig_lens[k]))
                   for k in range(c0, c1)]
            out.append(LoadedRead(
                pos=int(nums[i, 2]), cigar=cig,
                seq=seq_bytes[seq_off[i]:seq_off[i + 1]].decode(),
                mapq=int(nums[i, 3]), score=int(nums[i, 4]),
                ori_score=int(nums[i, 5]), has_cs=bool(nums[i, 6]),
                ori_unmapped=bool(nums[i, 7]), xa_num=int(nums[i, 8]),
                rc_mapq=int(nums[i, 9]), rc_chr_id=int(nums[i, 10]),
                rec=LazyBamRecord(bodies[i]),
            ))
        return out

    def close(self):
        self._rand.close()


def read_score_filter_reason(r: LoadedRead) -> str:
    """readScoreFilter (SignalAssembly.cpp:163-198) with the reference's
    SCORE_FILTER reason strings (cpp:142-157) — the -D detail channel
    prints these verbatim."""
    if r.score < r.ori_score:
        return "SMALL_SCORE"
    if r.score == r.ori_score:
        return "SAME_SCORE"
    if r.score < r.ori_score + SCORE_DIFF_L1:
        if r.rc_mapq == 0 and r.xa_num > 2:
            return "XA_BIGGER_2"
        if r.rc_mapq == 0 and r.xa_num == 2 and r.rc_chr_id < 24:
            return "XA_2"
    return "SCORE_PASS"


def read_score_filter(r: LoadedRead) -> bool:
    return read_score_filter_reason(r) == "SCORE_PASS"


@dataclass
class SvVerdict:
    sv_id: int
    passed: bool
    fail_reason: str
    vcf: VCFRecord | None = None
    depth_bp1: float = 0.0
    depth_bp2: float = 0.0


CONTIG_DP = dict(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1,
                 w=132, zdrop=132)   # SignalAssembly.hpp:411-420 profile


def _scalar_contig_dp(qseq, tseq):
    """One contig<->anchor DP with the native C++ kernel when built
    (bit-identical to ksw2_ref, fuzz-tested), else the Python oracle."""
    from ..align import native_glue

    lib = native_glue.get_lib()
    if lib is not None:
        return native_glue.extd2_native(lib, qseq, tseq, **CONTIG_DP)
    return ksw2_ref.extd2(qseq, tseq, **CONTIG_DP)


class ContigDpBatcher:
    """Collect/replay batcher for contig<->anchor DP problems.

    fc_sv's DP calls are independent across SVs, so SvCaller first PLANS
    every SV (assembly + voting + DP request collection), then all
    requests run as batched device programs (ops/extd2_jax scan DP with
    the contig scoring profile), then verdicts are finished. The inline
    mode (device=False) resolves each request immediately with the
    scalar kernel — same results."""

    # largest device chunk: the (576, 704) class keeps a
    # (chunk, 1279, 704) uint8 direction matrix on the device
    MAX_CHUNK = 256

    def __init__(self, device: bool = False, Q: int = 576, T: int = 704):
        self.device = device
        self.Q, self.T = Q, T
        self.requests: list = []
        self.results: list = []

    def request(self, qseq: np.ndarray, tseq: np.ndarray) -> int:
        idx = len(self.requests)
        self.requests.append((qseq, tseq))
        if not self.device:
            self.results.append(_scalar_contig_dp(qseq, tseq))
        return idx

    def result(self, idx: int):
        return self.results[idx]

    def run(self):
        """Resolve all pending requests (device path)."""
        if not self.device or not self.requests:
            return
        from ..ops.extd2_jax import (
            Extd2Params, extd2_batch, ops_to_cigar, traceback_batch)
        from ..ops.ksw2_ref import Ez

        params = Extd2Params(
            match=CONTIG_DP["match"], mismatch=CONTIG_DP["mismatch"],
            q=CONTIG_DP["q"], e=CONTIG_DP["e"], q2=CONTIG_DP["q2"],
            e2=CONTIG_DP["e2"], w=CONTIG_DP["w"], zdrop=CONTIG_DP["zdrop"],
        )
        self.results = [None] * len(self.requests)
        small = []
        for k, (q, t) in enumerate(self.requests):
            if len(q) <= self.Q and len(t) <= self.T:
                small.append(k)
            else:
                self.results[k] = _scalar_contig_dp(q, t)
        for c0 in range(0, len(small), self.MAX_CHUNK):
            chunk = small[c0 : c0 + self.MAX_CHUNK]
            # power-of-two chunk rows bound the compiled shapes
            B = max(8, 1 << (len(chunk) - 1).bit_length())
            qc = np.zeros((B, self.Q), np.int32)
            tc = np.zeros((B, self.T), np.int32)
            ql = np.ones(B, np.int32)
            tl = np.ones(B, np.int32)
            for bi, k in enumerate(chunk):
                q, t = self.requests[k]
                qc[bi, : len(q)] = q
                tc[bi, : len(t)] = t
                ql[bi] = len(q)
                tl[bi] = len(t)
            res = extd2_batch(qc, ql, tc, tl, params=params)
            zdr = np.asarray(res.zdropped)
            mxt = np.asarray(res.max_t)
            mxq = np.asarray(res.max_q)
            i0 = np.where(~zdr, tl - 1, np.where(mxt >= 0, mxt, -1)).astype(np.int32)
            j0 = np.where(~zdr, ql - 1, np.where(mxq >= 0, mxq, -1)).astype(np.int32)
            ops, i_f, j_f = traceback_batch(res.dmat, res.st_arr, res.en_arr,
                                            i0, j0, K=self.Q + self.T)
            ops = np.asarray(ops)
            i_f = np.asarray(i_f)
            j_f = np.asarray(j_f)
            score = np.asarray(res.score)
            mqe = np.asarray(res.mqe)
            mx = np.asarray(res.max)
            for bi, k in enumerate(chunk):
                cig = ops_to_cigar(ops[bi], int(i_f[bi]), int(j_f[bi])) \
                    if i0[bi] >= 0 else []
                self.results[k] = Ez(
                    score=int(score[bi]), mqe=int(mqe[bi]), max=int(mx[bi]),
                    max_q=int(mxq[bi]), max_t=int(mxt[bi]),
                    zdropped=bool(zdr[bi]), cigar=cig,
                )
        self.requests = []


class SvCaller:
    def __init__(self, sf: SVRefSequence, opts: SvCallOptions | None = None,
                 detail_out=None, dp: ContigDpBatcher | None = None):
        self.sf = sf
        self.o = opts or SvCallOptions()
        self.am = AssemblyManager()
        self.detail = detail_out
        self.dp = dp or ContigDpBatcher(device=False)

    def call_sv(self, sv_id: int, reads: list[LoadedRead],
                cluster_reads: list[tuple[int, list[LoadedRead]]] = ()) -> SvVerdict:
        plan = self.plan_sv(sv_id, reads, cluster_reads)
        self.dp.run()
        return self.finish_sv(plan)

    def plan_sv(self, sv_id: int, reads: list[LoadedRead],
                cluster_reads: list[tuple[int, list[LoadedRead]]] = ()):
        o = self.o
        info = self.sf.sv_info[sv_id]
        sv_len = info.length
        tseq = self.sf.sv_seq_codes(sv_id)
        bp1 = o.edge_len + 1
        bp2 = sv_len - o.edge_len

        # ---- depth-cap + score filters, block assignment ---------------
        max_read_in_block = max(
            int(o.ave_read_depth * 2 * o.rsf_block_size / o.normal_read_len), 4
        )
        rsf_scores: dict[int, list[int]] = {}
        for r in reads:
            rsf_scores.setdefault(r.pos >> 5, []).append(r.score)
        rsf_cut = {}
        for blk, scores in rsf_scores.items():
            if len(scores) > max_read_in_block:
                scores.sort(reverse=True)
                rsf_cut[blk] = scores[max_read_in_block]
            else:
                rsf_cut[blk] = 0

        depth_counter = np.zeros(max(sv_len, 1), dtype=np.int32)
        ab_n = sv_len // o.ab_block_size + 1
        blocks: list[list[tuple[LoadedRead, bool]]] = [[] for _ in range(ab_n)]

        def add_reads(lst, is_main):
            for r in lst:
                if r.score < rsf_cut.get(r.pos >> 5, 0):
                    continue
                self._add_depth(depth_counter, r)
                verdict = read_score_filter_reason(r)
                if o.print_detail:
                    # the reference renders every read reaching the
                    # score filter, pass or fail (output_reads call
                    # site, SignalAssembly.cpp:327,352)
                    self._print_read_line(r, verdict, info)
                if verdict != "SCORE_PASS":
                    continue
                bid = min(max((r.pos) // o.ab_block_size, 0), ab_n - 1)
                blocks[bid].append((r, is_main))

        if o.print_detail:
            out = self.detail or sys.stderr
            print(f"== SV {sv_id} read pileup ==", file=out)
        add_reads(reads, True)
        for other_id, other_reads in cluster_reads:
            if other_id != sv_id:
                add_reads(other_reads, False)

        # ---- per-block assembly + contig handling (DP deferred) --------
        global_depth = _GlobalDepth(sv_len, tseq)
        pending: list[dict] = []

        for ab_idx, blk in enumerate(blocks):
            if not blk:
                continue
            self.am.clear()
            self.am.set_normal_mode()
            read_strs = []
            offsets = []
            mains = []
            score_flags = []
            for r, is_main in blk:
                read_strs.append(r.seq)
                offsets.append(r.pos)
                mains.append(is_main)
                score_flags.append(
                    r.ori_unmapped or r.score > r.ori_score
                )
                self.am.add_read(r.seq)
            contigs = self.am.assemble()
            for contig_id, contig in enumerate(contigs):
                if contig_id != 0 and (
                    contig.new_support_read <= MIN_NEW_SUPPORT_READ
                    and contig.word_length < 100
                ):
                    continue
                self._handle_contig(
                    contig, contig_id, ab_idx, read_strs, offsets, mains,
                    score_flags, tseq, sv_len, pending,
                )

        return dict(sv_id=sv_id, info=info, sv_len=sv_len, bp1=bp1, bp2=bp2,
                    global_depth=global_depth, pending=pending, tseq=tseq,
                    depth_counter=depth_counter)

    def _print_read_line(self, r: LoadedRead, verdict: str, info):
        """The reference's -D per-read rendering, field-for-field
        (output_reads + print_info, SignalAssembly.cpp:200-223,958-989):
        dash pileup from the adjusted cigar, then
        `pos P offset O <SCORE_FILTER> qname tid pos fwd FIR/SEC
        mapQ:N flag: N score: [AS, OS, CS][OA:..] [MV:..] [XA:..]
        [RC:..]<cigar>\\t<seq>`."""
        out = self.detail or sys.stderr
        # the reference's offset is bam_pos - st_pos (SignalAssembly.cpp
        # :69,201,219) = our loader-relative r.pos minus 1
        off0 = r.pos - 1
        line = ["-"] * max(off0, 0)
        seq_i = 0
        off = off0
        for op, ln in r.cigar:
            if op == "M":
                for _ in range(ln):
                    if off >= 0:
                        line.append(r.seq[seq_i]
                                    if seq_i < len(r.seq) else "?")
                    seq_i += 1
                    off += 1
            elif op == "I":
                seq_i += ln
            elif op == "D":
                for _ in range(ln):
                    if off >= 0:
                        line.append("-")
                    off += 1
            elif op == "N":
                for _ in range(ln):
                    if off >= 0:
                        line.append("N")
                    seq_i += 1
                    off += 1
            elif op == "S":
                for _ in range(ln):
                    if off >= 0:
                        line.append("-")
                    seq_i += 1
                    off += 1
        bam_pos = info.st_pos - 1 + r.pos
        rec = r.rec
        if rec is not None:
            tag = lambda t: (str(rec.get_tag(t))
                             if rec.get_tag(t) is not None else "(null)")
            cs = rec.get_tag("CS")
            prologue = (
                f"{rec.name} {rec.tid} {bam_pos} "
                f"{int(not rec.is_reverse)} "
                f"{'FIR' if rec.is_read1 else 'SEC'} "
                f"mapQ:{rec.mapq} flag: {rec.flag} "
                f"score: [{r.score}, {r.ori_score}, "
                f"{cs if cs is not None else -1}]"
                f"[OA:{tag('OA')}] [MV:{tag('MV')}] [XA:{tag('XA')}] "
                f"[RC:{tag('RC')}]"
            )
        else:
            prologue = (f"? ? {bam_pos} ? ? mapQ:{r.mapq} flag: ? "
                        f"score: [{r.score}, {r.ori_score}, -1]")
        cigar_s = "".join(f"{n}{op}" for op, n in r.cigar)
        print("".join(line)
              + f"pos {bam_pos} offset {off0} {verdict} "
              + prologue + cigar_s + "\t" + r.seq, file=out)

    def _print_depth_detail(self, plan, gd: "_GlobalDepth"):
        """The reference's -d event-matrix dump: per-base event codes
        around the breakpoints plus depth totals."""
        out = self.detail or sys.stderr
        bp1, bp2 = plan["bp1"], plan["bp2"]
        print(f"== SV {plan['sv_id']} event matrix bp1={bp1} bp2={bp2} ==",
              file=out)
        for name, bp in (("bp1", bp1), ("bp2", bp2)):
            lo = max(0, bp - 30)
            hi = min(gd.n, bp + 30)
            codes = "".join(str(int(gd.ei[i])) for i in range(lo, hi))
            depth = " ".join(str(int(gd.total[i]))
                             for i in range(lo, hi, 10))
            print(f"{name} [{lo},{hi}) events {codes} depth10 {depth}",
                  file=out)

    def finish_sv(self, plan) -> SvVerdict:
        """Resolve the planned DP requests into variations + verdict.
        Requires self.dp.run() to have been called (device mode)."""
        global_depth = plan["global_depth"]
        tseq = plan["tseq"]
        variations: list[dict] = []
        for p in plan["pending"]:
            ez = self.dp.result(p["dp"])
            if not ez.cigar:
                continue
            cig, pos_adj = cigar_adjust(ez.cigar, delete_small_tail=15,
                                        add_blank=False)
            self._extract_vars(
                cig, p["st"] + pos_adj, p["qcodes"], p["qdepth"], tseq,
                p["ab_idx"], p["contig_id"], global_depth, variations,
            )
        global_depth.finalize()
        if self.o.depth_detail:
            self._print_depth_detail(plan, global_depth)
        merged = _merge_variations(variations, global_depth)
        return self._verdict(plan["sv_id"], plan["info"], plan["sv_len"],
                             plan["bp1"], plan["bp2"], global_depth,
                             merged, plan["depth_counter"])

    # ------------------------------------------------------------------
    def _add_depth(self, depth_counter, r: LoadedRead):
        off = r.pos
        n = len(depth_counter)
        for op, ln in r.cigar:
            if op == "M":
                a = max(off, 0)
                b = min(off + ln, n)
                if b > a:
                    depth_counter[a:b] += 1
                off += ln
            elif op in ("D", "N", "S"):
                off += ln

    def _handle_contig(self, contig, contig_id, ab_idx, read_strs, offsets,
                       mains, score_flags, tseq, sv_len, pending):
        # position voting from the action journal
        removed = set()
        votes: dict[int, int] = {}
        contig_seq = contig.seq
        clen = len(contig_seq)
        contig_arr = np.frombuffer(contig_seq.encode(), np.uint8)
        contig_depth = np.zeros(clen, dtype=np.int32)
        used = 0
        bigger = 0
        smaller = 0
        wl = contig.word_length
        read_arrs: dict[int, np.ndarray] = {}
        for kmer_idx, rid, is_add in contig.actions:
            if rid >= len(read_strs) or not mains[rid]:
                continue
            if not is_add:
                removed.add(rid)
                continue
            if rid in removed:
                continue
            rseq = read_strs[rid]
            pos_read = _find_read_kmer(rseq, contig_seq, kmer_idx,
                                       contig.ass_begin_offset_in_contig, wl)
            if pos_read < 0:
                removed.add(rid)
                continue
            if score_flags[rid]:
                bigger += 1
            else:
                smaller += 1
            st_ref = kmer_idx - contig.ass_begin_offset_in_contig - pos_read
            st_read = 0
            if st_ref < 0:
                st_read = -st_ref
                st_ref = 0
            ed_ref = min(clen, st_ref + len(rseq) - st_read)
            rarr = read_arrs.get(rid)
            if rarr is None:
                rarr = read_arrs[rid] = np.frombuffer(rseq.encode(), np.uint8)
            seg_c = contig_arr[st_ref:ed_ref]
            seg_r = rarr[st_read : st_read + (ed_ref - st_ref)]
            eq = seg_c == seg_r
            if (len(eq) - int(eq.sum())) <= 8:
                contig_depth[st_ref:ed_ref] += eq
                used += 1
                sug = offsets[rid] - (kmer_idx - contig.ass_begin_offset_in_contig - pos_read)
                votes[sug] = votes.get(sug, 0) + 1
        if not votes:
            return
        max_sug, max_count = max(votes.items(), key=lambda kv: (kv[1], -kv[0]))
        if max_count * 2 <= used or used == 0:
            cands = sorted(
                s for s, c in votes.items() if c * 2 >= max_count or c > 5
            )
        else:
            cands = [max_sug]
        # low-coverage tail trim + depth floor
        tail = 0
        while tail < min(20, clen) and contig_depth[clen - tail - 1] < 2:
            tail += 1
        if tail:
            contig_seq = contig_seq[: clen - tail]
            contig_depth = contig_depth[: clen - tail]
            clen = len(contig_seq)
        contig_depth = np.maximum(contig_depth, 2)
        if bigger <= 1:
            return  # not enough reads beating the original aligner

        qcodes_full = np.where(dna.encode(contig_seq) >= 4, np.uint8(2),
                               dna.encode(contig_seq))
        for sug in cands:
            st = sug - 15
            q_st = 0
            if st < 0:
                if st < -15:
                    q_st = -st - 30
                st = 0
            ed = min(sug + clen + 60, sv_len)
            if ed < st + 20 or q_st > clen:
                continue
            dp_id = self.dp.request(qcodes_full[q_st:], tseq[st:ed])
            pending.append(dict(
                dp=dp_id, st=st, qcodes=qcodes_full[q_st:],
                qdepth=contig_depth[q_st:], ab_idx=ab_idx,
                contig_id=contig_id,
            ))

    def _extract_vars(self, cigar, ref_pos, qcodes, qdepth, tseq, ab_idx,
                      contig_id, global_depth, variations):
        """get_var (SignalAssembly.cpp:402-457): 20-match head check, then
        per-base events + SNP/INS/DEL variation records."""
        out = ref_pos
        qi = 0
        match_base = 0
        finished_head = False
        n = len(cigar)
        nt = len(tseq)
        nq = len(qcodes)
        nd = len(qdepth)
        for ci, (op, ln) in enumerate(cigar):
            if op == "M":
                # vectorized M run: positions are distinct, so the head
                # walk is a cumsum and the body is masked array updates
                i = np.arange(ln)
                t_idx = out + i
                q_idx = qi + i
                valid = (t_idx < nt) & (q_idx < nq)
                eq = np.zeros(ln, bool)
                if valid.any():
                    vt = t_idx[valid]
                    vq = q_idx[valid]
                    eq[valid] = tseq[vt] == qcodes[vq]
                body_from = 0
                if not finished_head:
                    delta = np.where(valid, np.where(eq, 1, -1), 0)
                    cum = match_base + np.cumsum(delta)
                    hit = np.nonzero(cum >= HEAD_MIN_MATCH_BASE)[0]
                    if len(hit):
                        finished_head = True
                        body_from = int(hit[0]) + 1
                        match_base = int(cum[hit[0]])
                    else:
                        body_from = ln
                        match_base = int(cum[-1]) if ln else match_base
                if body_from < ln:
                    sel = valid.copy()
                    sel[:body_from] = False
                    p = t_idx[sel]
                    qsel = q_idx[sel]
                    d = qdepth[np.minimum(qsel, nd - 1)]
                    global_depth.set_base_run(p, qcodes[qsel], ab_idx, d)
                    for k in np.nonzero(sel & ~eq)[0]:
                        oi = out + int(k)
                        qk = qi + int(k)
                        variations.append(dict(
                            ref=dna.decode(tseq[oi : oi + 1]),
                            alt=dna.decode(qcodes[qk : qk + 1]),
                            ref_position=oi, var_type="SNP",
                            depth=int(qdepth[min(qk, nd - 1)]),
                            assembly_part=ab_idx, contig_id=contig_id,
                        ))
                qi += ln
                out += ln
            elif op == "I":
                if 0 < ci < n - 1 and ln < MAX_INDEL_LEN:
                    if not finished_head:
                        match_base -= 2
                    else:
                        d = int(qdepth[min(qi, len(qdepth) - 1)])
                        variations.append(dict(
                            ref=dna.decode(tseq[out : out + 1]),
                            alt=dna.decode(qcodes[qi : qi + ln + 1]),
                            ref_position=out, var_type="INS", depth=d,
                            assembly_part=ab_idx, contig_id=contig_id,
                        ))
                        global_depth.set_base(out, 5, ab_idx, d * 2)
                qi += ln
            elif op == "D":
                if 0 < ci < n - 1 and ln < MAX_INDEL_LEN:
                    if not finished_head:
                        match_base -= 2
                    else:
                        d = int(qdepth[min(qi, len(qdepth) - 1)])
                        variations.append(dict(
                            ref=dna.decode(tseq[out : out + ln + 1]),
                            alt=dna.decode(qcodes[qi : qi + 1]),
                            ref_position=out, var_type="DEL", depth=d,
                            assembly_part=ab_idx, contig_id=contig_id,
                        ))
                        for k in range(ln):
                            if out + k < len(tseq):
                                global_depth.set_base(out + k, 4, ab_idx, d)
                out += ln
            elif op in ("S", "N"):
                out += ln

    # ------------------------------------------------------------------
    def _verdict(self, sv_id, info, sv_len, bp1, bp2, gd, merged,
                 depth_counter) -> SvVerdict:
        o = self.o
        has_ins = bp2 > bp1 + 10
        win = 10 if has_ins else 20
        b1 = gd.analyze(bp1 - win, bp1 + win)
        b2 = gd.analyze(bp2 - win, bp2 + win)
        bi = gd.analyze(bp1, bp2) if has_ins else None
        ins_part_len = bp2 - bp1

        fail = None
        svt = info.sv_type
        if has_ins:
            if not (svt.startswith("I") or svt.startswith("DU")):
                fail = "wrong_sv_type"
            elif b1["blank"] > 0 and b2["blank"] > 0:
                fail = "bp1_uncovered"
            elif (b1["blank"] > 0 and (b2["ins"] + b2["del"]) > 0) or \
                 (b2["blank"] > 0 and (b1["ins"] + b1["del"]) > 0):
                fail = "bp1_uncovered"
            elif bi["blank"] > 0.5 * ins_part_len:
                fail = "ins_uncovered"
            elif bi["del"] + bi["blank"] + 30 > ins_part_len:
                fail = "ins_length_not_enough"
        else:
            if not svt.startswith("DE"):
                fail = "wrong_sv_type"
            elif b1["blank"] > 0 or b2["blank"] > 0:
                fail = "bp1_uncovered"
            elif b1["ave_depth"] != 0 and b1["min_depth"] * 2 < b1["ave_depth"]:
                fail = "del_depth_change_sharply"
            else:
                ins_len = sum(
                    len(v["alt"])
                    for v in merged
                    if bp1 - 10 < v["ref_position"] < bp2 + 10
                    and gd.event_info(v["ref_position"]) == 8
                )
                del_len = info.bp2 - info.bp1
                if ins_len + 30 > del_len:
                    fail = "del_length_not_enough"

        depth_bp1 = float(np.mean(depth_counter[max(bp1 - win, 0) : bp1 + win]))
        depth_bp2 = float(np.mean(depth_counter[max(bp2 - win, 0) : bp2 + win]))
        min_read_depth = max(int(o.ave_read_depth * 0.1), 3)
        if fail is None and (depth_bp1 + depth_bp2) / 2 < min_read_depth:
            fail = "low_total_depth"
        ass_depth = (b1["ave_depth"] + b2["ave_depth"]) / 2
        if fail is None and ass_depth < min_read_depth:
            fail = "low_total_depth"

        if fail is not None:
            return SvVerdict(sv_id=sv_id, passed=False, fail_reason=fail,
                             depth_bp1=depth_bp1, depth_bp2=depth_bp2)

        # ---- construct REF/ALT + VCF record ---------------------------
        if has_ins:
            alt_chars = []
            ins_by_pos = {}
            for v in merged:
                if v["var_type"] == "INS":
                    ins_by_pos[v["ref_position"]] = v["alt"]
            # the reference walks [break_point1, break_point2-1] with its
            # break_point2 one past ours — include our bp2 so the ALT
            # (and SVLEN) match the binary's exactly (the 29 systematic
            # SVLEN-minus-one diffs of the earlier e2e compare)
            for pos in range(bp1, bp2 + 1):
                ei = gd.event_info(pos)
                if ei in (0, 2, 3, 4, 5, 6):
                    alt_chars.append("ACGT"[gd.max_base(pos)])
                elif ei == 8 and pos in ins_by_pos:
                    # insertion events contribute their recorded string
                    # minus its first base (SignalAssembly.cpp:594-601)
                    alt_chars.append(ins_by_pos[pos][1:])
            alt = "".join(alt_chars)
            ref = ""
        else:
            ref = self.sf.ori_genome.fetch(
                info.chrom, info.bp1, info.bp2 + 1
            )
            alt = ""

        anchor_base = "ACGT"[int(gd.ref_base(bp1 - 1))]
        st_pos = info.bp1
        # endPos = st_pos + ref.size() (SignalAssembly.cpp:646)
        end_pos = st_pos + len(ref)
        length = len(alt) - len(ref) + 1
        low_depth = (b1["ave_depth"] + b2["ave_depth"]) < 5
        is_het = (depth_bp1 + depth_bp2) / 2 < o.ave_read_depth * 0.45
        rec = VCFRecord(
            chrom=info.chrom,
            pos1=st_pos,  # reference emits its 0-based bp here; kept equal
            id=f"{info.new_ref_id}_{info.chrom}_{info.st_pos}_{info.length}_"
               f"{info.sv_type}_{info.vcf_id}",
            ref=anchor_base + ref,
            alts=[anchor_base + alt],
            qual=".",
            filter="LOW_DEPTH" if low_depth else "PASS",
            info={"SVTYPE": svt, "END": str(end_pos), "SVLEN": str(length)},
            format="GT:DP",
            samples=[
                f"{'0/1' if is_het else '1/1'}:"
                f"{int(depth_bp1)},{int(depth_bp2)},"
                f"{int(b1['ave_depth'])},{int(b2['ave_depth'])}"
            ],
        )
        return SvVerdict(sv_id=sv_id, passed=True, fail_reason="filter_pass",
                         vcf=rec, depth_bp1=depth_bp1, depth_bp2=depth_bp2)


# -------------------------------------------------------------------------

def _find_read_kmer(rseq: str, contig_seq: str, kmer_idx: int,
                    ass_begin: int, wl: int) -> int:
    """AddReadAction::set_read_pos: locate the contig word in the read
    (backward scan for left-extension actions). str.find/rfind are the
    C-speed equivalents of the reference's scan loops."""
    cpos = kmer_idx - ass_begin
    if cpos < 0 or cpos + wl > len(contig_seq):
        return -1
    word = contig_seq[cpos : cpos + wl]
    if len(rseq) < wl:
        return -1
    return rseq.rfind(word) if kmer_idx < 0 else rseq.find(word)


class _GlobalDepth:
    """GlobalDepthItem matrix (SignalAssembly.hpp:33-128)."""

    def __init__(self, sv_len: int, tseq: np.ndarray):
        self.n = sv_len
        self.counts = np.zeros((sv_len, 6), dtype=np.int32)
        self.tmp = np.zeros((sv_len, 6), dtype=np.int32)
        self.cur_block = np.full(sv_len, -1, dtype=np.int32)
        self.ref = tseq[:sv_len].astype(np.int32)
        self.total = np.zeros(sv_len, dtype=np.int32)
        self.maxb = np.zeros(sv_len, dtype=np.int32)

    def set_base(self, pos: int, base: int, ab_block: int, depth: int):
        if pos < 0 or pos >= self.n:
            return
        if self.cur_block[pos] == ab_block:
            self.tmp[pos, base] = max(self.tmp[pos, base], depth)
        else:
            # on block switch only THIS base's tmp folds into the counts
            # (GlobalDepthItem::set_base, SignalAssembly.hpp:41-49)
            self.cur_block[pos] = ab_block
            self.counts[pos, base] += self.tmp[pos, base]
            self.tmp[pos, base] = depth

    def set_base_run(self, pos: np.ndarray, base: np.ndarray, ab_block: int,
                     depth: np.ndarray):
        """Vectorized set_base over DISTINCT positions (one M run)."""
        m = (pos >= 0) & (pos < self.n)
        if not m.all():
            pos, base, depth = pos[m], base[m], depth[m]
        if len(pos) == 0:
            return
        same = self.cur_block[pos] == ab_block
        ps, bs = pos[same], base[same]
        self.tmp[ps, bs] = np.maximum(self.tmp[ps, bs], depth[same])
        pd, bd = pos[~same], base[~same]
        self.cur_block[pd] = ab_block
        self.counts[pd, bd] += self.tmp[pd, bd]
        self.tmp[pd, bd] = depth[~same]

    def finalize(self):
        self.counts += self.tmp
        self.total = self.counts.sum(axis=1)
        self.maxb = np.argmax(self.counts, axis=1)
        top = self.counts[np.arange(self.n), self.maxb]
        self.ei = np.where(
            self.total == 0, 1,
            np.where(self.maxb != self.ref, 3 + self.maxb,
                     np.where(top != self.total, 2, 0)),
        ).astype(np.int32)

    def ref_base(self, pos):
        return self.ref[np.clip(pos, 0, self.n - 1)]

    def max_base(self, pos):
        return int(self.maxb[pos])

    def event_info(self, pos) -> int:
        if pos < 0 or pos >= self.n:
            return 1
        if self.total[pos] == 0:
            return 1
        if self.maxb[pos] != self.ref[pos]:
            return 3 + int(self.maxb[pos])
        if self.counts[pos, self.maxb[pos]] != self.total[pos]:
            return 2
        return 0

    def analyze(self, st, ed):
        st = max(0, st)
        ed = min(self.n, ed)
        ei = self.ei[st:ed]
        out = dict(
            blank=int((ei == 1).sum()),
            snp=int(((ei >= 3) & (ei <= 6)).sum()),
            ins=int((ei == 8).sum()),
            term_del=0,
        )
        out["del"] = int((ei == 7).sum())
        m = (ei != 1) & (ei != 7)
        tot = self.total[st:ed][m]
        out["ave_depth"] = float(tot.sum()) / len(tot) if len(tot) else 0.0
        out["min_depth"] = int(tot.min()) if len(tot) else 0
        return out


def _merge_variations(variations: list[dict], gd: _GlobalDepth) -> list[dict]:
    """VI_list::sort_merge + simple depth filter."""
    variations.sort(key=lambda v: (
        v["ref_position"], v["var_type"], v["ref"], v["alt"],
        v["assembly_part"], v["contig_id"], -v["depth"],
    ))
    merged: list[dict] = []
    for v in variations:
        if merged and (
            merged[-1]["ref_position"] == v["ref_position"]
            and merged[-1]["var_type"] == v["var_type"]
            and merged[-1]["ref"] == v["ref"]
            and merged[-1]["alt"] == v["alt"]
        ):
            if merged[-1]["assembly_part"] != v["assembly_part"]:
                merged[-1]["depth"] += v["depth"]
                merged[-1]["assembly_part"] = v["assembly_part"]
            else:
                merged[-1]["depth"] = max(merged[-1]["depth"], v["depth"])
        else:
            merged.append(dict(v))
    out = []
    for v in merged:
        pos = v["ref_position"]
        if 0 <= pos < gd.n and v["depth"] * 4 >= gd.total[pos] and v["depth"] > 2:
            v["pass_filter"] = True
            out.append(v)
    return out


def run_sv_calling(bam_path: str, sf: SVRefSequence,
                   opts: SvCallOptions | None = None,
                   dp: ContigDpBatcher | None = None,
                   detail_out=None):
    """Full fc_sv pass over a realigned BAM: returns (verdicts, vcf_records).

    With a device ContigDpBatcher, every SV region is planned first
    (assembly + voting), then ALL contig<->anchor DP problems run as one
    batched device program, then verdicts are finished — the fc_sv analog
    of the realigner's collect/replay."""
    o = opts or SvCallOptions()
    # default DP = inline native C++ kernel (ContigDpBatcher device=False
    # -> _scalar_contig_dp); callers can pass ContigDpBatcher(device=True)
    # to batch the contig DP on the device instead
    caller = SvCaller(sf, o, dp=dp, detail_out=detail_out)
    index = SvReadIndex(bam_path, sf.sv_info, min_score=o.min_score)
    # chromosome-range sharding (the reference's -S/-E resumability
    # contract, generateVCFoptions.hpp:80-83): only SVs whose original
    # chromosome index falls in [st_chr, ed_chr] are handled here
    chrom_index = {c: i for i, c in enumerate(sf.ori_chrom_names)}
    plans = []
    for sv_id in index.sv_ids():
        if sf.used[sv_id]:
            continue
        ci = chrom_index.get(sf.sv_info[sv_id].chrom, 0)
        if not (o.st_chr <= ci <= o.ed_chr):
            continue
        members = sf.cluster_members(sv_id)
        for m in members:
            sf.used[m] = True
        member_reads = {m: index.get(m) for m in members}
        # pick the best cluster member by mapq-weighted score
        best_id, best_score = sv_id, -1
        for m in members:
            rs = member_reads[m]
            if not rs:
                continue
            hq = sum(1 for r in rs if r.has_cs and r.mapq > 5)
            tot_q = sum(r.mapq for r in rs if r.has_cs)
            n = sum(1 for r in rs if r.has_cs)
            score = hq * 10 + tot_q + n * 2
            if score > best_score:
                best_score, best_id = score, m
        reads = member_reads.get(best_id) or index.get(best_id)
        if not reads:
            continue
        cluster_reads = [(m, member_reads[m]) for m in members]
        plans.append(caller.plan_sv(best_id, reads, cluster_reads))
    index.close()
    caller.dp.run()
    verdicts = [caller.finish_sv(p) for p in plans]
    vcf_records = [v.vcf for v in verdicts if v.vcf is not None]
    return verdicts, vcf_records
