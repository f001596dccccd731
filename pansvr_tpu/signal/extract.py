"""Signal-read extraction (stage `fc_signal`).

Behavioral re-implementation of READ_SIGNAL_HANDLER
(src/PanSVgenerateVCF/getSignalRead.{hpp,cpp}): stream a position-sorted
BAM, greedily pair mates inside sliding blocks, score each read from its
CIGAR+NM, apply the 7-rule signal filter, and emit signal read pairs as
interleaved FASTQ whose comment encodes the original alignment (the
bridge contract parsed back by fc_aln, getSignalRead.cpp:158-249).

Insert-size statistics follow the same structure (first-100k sampling +
quantile distribution) with the Manta StatsManager's region-sampling
replaced by direct proper-pair sampling — a behavioral, not bit-exact,
equivalent (thresholds derived from quantiles of the same distribution).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..io.alignment import open_alignment
from ..io.bam import BamReader, BamRecord, LazyBamRecord
from ..utils import dna

MAX_ISIZE = 3000
SAM_LOAD_BUFF_SIZE = 1_000_000
SEARCH_REGION_MAX = 100_000_000
SEARCH_STEP = 64

# scoring defaults = fc_aln's (getSignalRead.hpp:20-25)
MATCH, MISMATCH = 2, 12
GAP_OPEN, GAP_EX, GAP_OPEN2, GAP_EX2 = 16, 1, 32, 0


@dataclass
class SignalStats:
    """BAM_STAT equivalent (getSignalRead.hpp:70-190)."""
    read_len: int = 0
    ave_read_depth: float = 0.0
    min_isize_l2: int = 0
    max_isize_l2: int = 0
    min_isize: int = 0
    mid_isize: int = 0
    max_isize: int = 0
    isize_distribution: list = field(default_factory=list)
    reason_flag_counter: dict = field(default_factory=dict)

    def status_file_text(self) -> str:
        """Status-file contract (getSignalRead.hpp:181-186)."""
        lines = [
            f"{self.ave_read_depth:f}_{self.read_len}_{self.min_isize_l2}_"
            f"{self.max_isize_l2}_{self.min_isize}_{self.max_isize}"
        ]
        lines += [f"{p:f}" for p in self.isize_distribution]
        return "\n".join(lines) + "\n"

    @classmethod
    def parse_status_text(cls, text: str) -> "SignalStats":
        lines = [l for l in text.splitlines() if l.strip()]
        parts = lines[0].split("_")
        st = cls(
            ave_read_depth=float(parts[0]), read_len=int(parts[1]),
            min_isize_l2=int(parts[2]), max_isize_l2=int(parts[3]),
            min_isize=int(parts[4]), max_isize=int(parts[5]),
        )
        st.mid_isize = (st.min_isize + st.max_isize) // 2
        st.isize_distribution = [float(l) for l in lines[1:]]
        return st


class _ReplayableChunks:
    """Shares ONE BGZF decompression among fc_signal's sequential
    consumers (first-100k column scan, StatsManager scan, signal block
    scan): each call to stream() replays the cached prefix and then
    continues pulling from the live chunk iterator, extending the
    cache. The reference pays this read twice (sampling_analysis_stat
    then the signal pass re-reads the BAM, getSignalRead.cpp:305); the
    early-breaking stats consumers touch only a prefix, so caching it
    is bounded. Past cap_bytes the cache stops growing and `truncated`
    tells the caller to fall back to a fresh reader."""

    def __init__(self, it, cap_bytes: int | None = None):
        if cap_bytes is None:
            cap_bytes = int(os.environ.get(
                "PANSVR_SIGNAL_CACHE_MB", "256")) << 20
        self._it = it
        self._cache: list[bytes] = []
        self._bytes = 0
        self._cap = cap_bytes
        self.truncated = False

    def stream(self):
        i = 0
        while True:
            if i < len(self._cache):
                yield self._cache[i]
                i += 1
                continue
            try:
                c = next(self._it)
            except StopIteration:
                return
            if self._bytes + len(c) <= self._cap:
                self._cache.append(c)
                self._bytes += len(c)
                i += 1
            else:
                self.truncated = True
            yield c


def compute_stats(bam_path: str, genome_size: float = 3.1e9,
                  sample_limit: int = 100_000, ref=None,
                  use_manta: bool = True, _chunks=None,
                  _ref_lens=None) -> SignalStats:
    """BAM_STAT::sampling_analysis_stat (getSignalRead.hpp:123-174):
    first-100k scan for the read-length mode and the two-sided-trim l2
    isize bounds, then the Manta StatsManager region sampling for the
    isize quantiles, pmf AND the depth estimate — the reference
    unconditionally overwrites its genome-normalized depth with the
    sampled spanned-region depth (hpp:171). When the sampling finds no
    high-confidence pairs (tiny/abnormal inputs), the direct
    proper-pair quantiles and genome_size-normalized depth stand in."""
    isize_hist = np.zeros(MAX_ISIZE, dtype=np.int64)
    len_hist = np.zeros(4096, dtype=np.int64)
    n = 0
    import struct as _struct

    from ..align import native_glue

    lib = None if _DISABLE_NATIVE else native_glue.get_lib()
    scan_ok = lib is not None
    _unpack = _struct.Struct("<Hiiii").unpack_from  # flag,l_seq,mtid,mpos,tlen

    def _column_scan(chunk_iter):
        # column scan: boundaries in C++, histograms in NumPy
        nonlocal n, isize_hist, len_hist
        carry = b""
        for chunk in chunk_iter:
            data = carry + chunk if carry else chunk
            nr, consumed, _, _, _, _, flag, l_seq, tlen = \
                native_glue.bam_scan(lib, data)
            carry = data[consumed:]
            if nr == 0:
                continue
            keep = (flag & 0x900) == 0
            take = min(int(keep.sum()), sample_limit - n)
            if take < int(keep.sum()):
                ki = np.nonzero(keep)[0][:take]
                l_seq, tlen = l_seq[ki], tlen[ki]
            else:
                l_seq, tlen = l_seq[keep], tlen[keep]
            n += take
            isz = np.abs(tlen)
            good = (isz > 0) & (isz < MAX_ISIZE)
            isize_hist += np.bincount(isz[good], minlength=MAX_ISIZE)
            ls = l_seq[l_seq < 4096]
            len_hist += np.bincount(ls, minlength=4096)
            if n >= sample_limit:
                break

    if _chunks is not None and scan_ok:
        # shared-stream mode: the caller (extract_signal) owns the
        # reader; both stats consumers replay one decompression
        _column_scan(_chunks.stream())
        return _finish_stats(
            bam_path, genome_size, ref, use_manta, n, isize_hist,
            len_hist, _chunks=_chunks, _ref_lens=_ref_lens)
    with open_alignment(bam_path, ref=ref) as rd:
        if scan_ok and hasattr(rd, "iter_chunks"):
            _column_scan(rd.iter_chunks())
        elif hasattr(rd, "iter_bodies"):
            # fixed-header-only scan: flag/l_seq/isize live at static
            # offsets, so the stats pass skips record-object construction
            for body in rd.iter_bodies():
                flag, l_seq, _, _, tlen = _unpack(body, 14)
                if flag & 0x900:  # secondary | supplementary
                    continue
                n += 1
                isz = abs(tlen)
                if 0 < isz < MAX_ISIZE:
                    isize_hist[isz] += 1
                if l_seq < 4096:
                    len_hist[l_seq] += 1
                if n >= sample_limit:
                    break
        else:
            for rec in rd:
                if rec.is_secondary or rec.is_supplementary:
                    continue
                n += 1
                isz = abs(rec.isize)
                if 0 < isz < MAX_ISIZE:
                    isize_hist[isz] += 1
                if rec.query_len < 4096:
                    len_hist[rec.query_len] += 1
                if n >= sample_limit:
                    break
    return _finish_stats(bam_path, genome_size, ref, use_manta, n,
                         isize_hist, len_hist)


def _finish_stats(bam_path, genome_size, ref, use_manta, n, isize_hist,
                  len_hist, _chunks=None, _ref_lens=None):
    st = SignalStats()
    if n == 0:
        return st
    # modal read length: first length covering > 60% (hpp:87-99)
    total_len = float((np.arange(4096) * len_hist).sum())
    mode = int(np.argmax(len_hist))
    st.read_len = mode if len_hist[mode] > 0.6 * n else int(total_len / n)
    st.ave_read_depth = st.read_len * n / genome_size
    # two-sided 1% trim (global_analysis_stat, hpp:101-121)
    cum = np.cumsum(isize_hist)
    total_isize = int(cum[-1])
    if total_isize > 0:
        lim = 0.01 * n
        st.min_isize_l2 = int(np.argmax(cum > lim))
        cum_r = np.cumsum(isize_hist[::-1])
        st.max_isize_l2 = MAX_ISIZE - 1 - int(np.argmax(cum_r > lim))
        # quantiles over proper-pair isizes (StatsManager::getInsertLen)
        def quantile(q):
            target = q * total_isize
            return int(np.argmax(cum >= max(target, 1)))
        st.min_isize = quantile(0.01)
        st.mid_isize = quantile(0.5)
        st.max_isize = quantile(0.99)
        denom = total_isize + 1
        st.isize_distribution = [
            float(isize_hist[i]) / denom
            for i in range(st.min_isize, st.max_isize)
        ]
    if use_manta:
        try:
            from .stats_manager import StatsManager

            sm = StatsManager().handle_bam(
                bam_path, ref=ref,
                _chunks=_chunks.stream() if _chunks is not None else None,
                _ref_lens=_ref_lens)
            frag = sm.tracker.frag
            hc = sm.tracker.counter.high_confidence_pairs
            if frag.total > 0 and hc >= 100:
                st.min_isize = sm.get_insert_len(0.01)
                st.mid_isize = sm.get_insert_len(0.5)
                st.max_isize = sm.get_insert_len(0.99)
                denom = hc + 1
                st.isize_distribution = [
                    float(frag.counts.get(i, 0)) / denom
                    for i in range(st.min_isize, st.max_isize)
                ]
                if sm.ave_depth > 0:
                    st.ave_read_depth = sm.ave_depth
        except Exception:
            pass  # CRAM or malformed input: the direct estimates stand
    return st


def score_by_cigar(rec: BamRecord) -> int:
    """getScoreByCigar (getSignalRead.cpp:36-77)."""
    score = 0
    gap_len = 0
    for op, ln in rec.cigar:
        if op in ("M", "="):
            score += ln * MATCH
        elif op in ("I", "D", "S", "H"):
            if op in ("I", "D"):
                gap_len += ln
            score -= min(GAP_OPEN + ln * GAP_EX, GAP_OPEN2 + ln * GAP_EX2)
    nm = rec.get_tag("NM") or 0
    score -= (MISMATCH + MATCH) * (nm - gap_len)
    return max(0, score)


def _xa_number(rec: BamRecord) -> int:
    """get_XA_number (getSignalRead.cpp:81-93)."""
    if rec.mapq > 0:
        return 0
    xa = rec.get_tag("XA")
    if xa is None:
        return 6
    return str(xa).count(";")


def _indel_nm(rec: BamRecord) -> int:
    """bam_has_INDEL_NM: NM counts mismatches+indel bases."""
    nm = rec.get_tag("NM") or 0
    return int(nm)


def _clips(rec: BamRecord) -> tuple[int, int]:
    sl = rec.cigar[0][1] if rec.cigar and rec.cigar[0][0] in "SH" else 0
    sr = rec.cigar[-1][1] if rec.cigar and rec.cigar[-1][0] in "SH" else 0
    return sl, sr


def _low_quality_len(rec: BamRecord, cutoff: int = 47) -> int:
    """get_bam_low_quality_num (bam_file.c:673-684): bases whose RAW
    phred value is below `cutoff`.

    The reference passes the char literal '/' (ASCII 47) but compares it
    against bam_get_qual's RAW phred values, not +33 ASCII — so with
    typical Illumina quals (phred <= 41) EVERY base counts as low
    quality, which neuters the NM/clip filter rules via the
    low-quality adjustment (getSignalRead.cpp:178-182). The intended
    semantics was presumably phred < 14 ('/' in ASCII encoding); the
    `-L` flag that would disable the adjustment is parsed but never
    read (dead flag). Default 47 reproduces the reference's actual
    behavior (golden-tested); pass cutoff=14 for the intended rule."""
    if not rec.qual:
        return 0
    return sum(1 for q in rec.qual if ord(q) - 33 < cutoff)


# test hooks: force the pure-Python scan (_DISABLE_NATIVE) or the
# column-scan path without the native FASTQ renderer (_DISABLE_RENDER)
_DISABLE_NATIVE = False
_DISABLE_RENDER = False


@dataclass
class SignalOptions:
    discard_both_full_match: bool = True   # -U
    not_using_filter: bool = False         # -D (dump all)
    max_tid: int = 24
    # raw-phred cutoff of the low-quality adjustment (see
    # _low_quality_len): 47 = the reference's actual behavior,
    # 14 = the intended ASCII-'/' rule
    lowq_phred_cutoff: int = 47


def _pair_comment(b, i, stats: SignalStats, emit_stat: bool,
                  pre=None) -> str:
    """The comment-field contract (getSignalRead.cpp:158-249). `pre`
    optionally carries the native scan's per-record columns
    ((score, soft_left, clip_sum, _, nm, xa) for each mate) so the
    cigar/tag walks are not redone in Python."""
    j = 1 - i
    isize = abs(b[0].isize)
    if pre is not None:
        sc, sl, cl, nm_c, xa_c = pre
        parts = [
            f"{b[i].tid}_{b[i].pos}_{sl[i]}_{sc[i]}_"
            f"{b[i].mapq}_{b[j].mapq}_{xa_c[i]}_{xa_c[j]}_{isize}_"
        ]
    else:
        cl = [sum(_clips(b[k])) for k in (0, 1)]
        nm_c = [_indel_nm(b[k]) for k in (0, 1)]
        xa_c = [_xa_number(b[k]) for k in (0, 1)]
        parts = [
            f"{b[i].tid}_{b[i].pos}_{_clips(b[i])[0]}_{score_by_cigar(b[i])}_"
            f"{b[i].mapq}_{b[j].mapq}_{xa_c[i]}_{xa_c[j]}_{isize}_"
        ]
    flags = []
    for k in (i, j):
        f = ""
        f += "F" if not b[k].is_reverse else "R"
        f += "Y" if b[k].is_unmapped else "N"
        f += "Y" if nm_c[k] > 8 else "N"
        f += "Y" if cl[k] > 10 else "N"
        flags.append(f)
    parts.append(f"{flags[0]}_{flags[1]}_")
    if emit_stat:
        parts.append(
            f"STAT_{stats.read_len}_{stats.min_isize}_{stats.mid_isize}_"
            f"{stats.max_isize}_"
        )
    parts.append(f"FLAG_{b[i].flag}_{b[i].mapq}_CIGAR_")
    parts.append("".join(f"{n}{op}" for op, n in b[i].cigar))
    parts.append("_")
    parts.append(f"MATE_{b[i].mtid}_{b[i].mpos}_{b[i].isize}_TAG_")
    for tag in ("XA", "MC", "SA"):
        v = b[i].get_tag(tag)
        if v is not None:
            parts.append(f"{tag}:Z:{v}_")
    nm = b[i].get_tag("NM")
    if nm is not None:
        parts.append(f"NM:i:{nm}_")
    return "".join(parts)


def _fastq_entry(rec: BamRecord, comment: str) -> str:
    seq = rec.seq
    qual = rec.qual or "I" * len(seq)
    if not rec.is_unmapped and rec.is_reverse:
        seq = dna.revcomp(seq)
        qual = qual[::-1]
    return f"@{rec.name} {comment}\n{seq}\n+\n{qual}\n"


class SignalExtractor:
    def __init__(self, stats: SignalStats, opts: SignalOptions | None = None):
        self.stats = stats
        self.opts = opts or SignalOptions()
        self.reason_counter: dict[int, int] = {}
        self._stat_emitted = False
        self.n_pairs = 0
        self.n_signal = 0

    def classify_pair(self, r1: BamRecord, r2: BamRecord):
        """Returns (is_signal, reason_flag) per the 7-rule filter
        (getSignalRead.cpp:137-191)."""
        o = self.opts
        b = [r1, r2]
        unmapped = [x.is_unmapped for x in b]
        mapq = [x.mapq for x in b]
        scores = [score_by_cigar(x) for x in b]
        tid = [x.tid for x in b]
        isize = abs(r1.isize)

        if o.discard_both_full_match:
            min_score = (r1.query_len + r2.query_len) * MATCH - 4 * (MATCH + MISMATCH)
            near_full = scores[0] + scores[1] >= min_score
            isize_ok = (
                isize != 0
                and self.stats.min_isize < isize < self.stats.max_isize
            )
            if (near_full and isize_ok and tid[0] == tid[1]
                    and tid[0] <= o.max_tid and tid[1] <= o.max_tid):
                return False, -1  # discarded entirely (not even dumped)

        direction = [not x.is_reverse for x in b]
        if r1.pos > r2.pos:
            direction[0], direction[1] = direction[1], direction[0]
        if (isize == r1.query_len and isize == r2.query_len
                and not direction[0] and direction[1]):
            direction[0], direction[1] = direction[1], direction[0]

        clip = [sum(_clips(x)) for x in b]
        lowq = [_low_quality_len(x, o.lowq_phred_cutoff) for x in b]
        indel_nm = [_indel_nm(x) for x in b]
        for k in range(2):
            clip[k] -= lowq[k]
            if clip[k] < 0:
                lowq[k] = -clip[k]
                clip[k] = 0
            lowq[k] >>= 1
            indel_nm[k] -= lowq[k]
            if indel_nm[k] < 0:
                indel_nm[k] = 0

        reason = 0
        if mapq[0] < 10 and mapq[1] < 10:
            reason += 1
        if unmapped[0] or unmapped[1]:
            reason += 2
        if isize > 1000:
            reason += 4
        if not direction[0] or direction[1]:
            reason += 8
        if indel_nm[0] + indel_nm[1] > 15:
            reason += 16
        if clip[0] + clip[1] > 10:
            reason += 32
        if tid[0] != tid[1] or tid[0] > o.max_tid or tid[1] > o.max_tid:
            reason += 64
        return (reason != 0) or o.not_using_filter, reason

    def emit_pair(self, r1: BamRecord, r2: BamRecord, out) -> bool:
        self.n_pairs += 1
        is_signal, reason = self.classify_pair(r1, r2)
        if reason >= 0:
            self.reason_counter[reason] = self.reason_counter.get(reason, 0) + 1
        if not is_signal:
            return False
        self._write_pair(r1, r2, out)
        return True

    def _write_pair(self, r1, r2, out, pre=None):
        b = [r1, r2]
        c1 = _pair_comment(b, 0, self.stats, not self._stat_emitted, pre)
        self._stat_emitted = True
        c2 = _pair_comment(b, 1, self.stats, False, pre)
        out.write(_fastq_entry(r1, c1))
        out.write(_fastq_entry(r2, c2))
        self.n_signal += 1


def extract_signal(bam_path: str, out_fq, stats: SignalStats | None = None,
                   opts: SignalOptions | None = None,
                   ref=None) -> SignalStats:
    """Full fc_signal pass: stats + block pairing + signal FASTQ.
    `bam_path` may be BAM or CRAM (CRAM needs `ref`, the reference
    genome, to reconstruct mapped sequences)."""
    from ..align import native_glue

    lib = native_glue.get_lib()
    native_ok = not _DISABLE_NATIVE and lib is not None
    use_render = native_ok and not _DISABLE_RENDER
    use_chunks = use_render
    rd0 = None
    rep = None
    if stats is None:
        # chunk sharing only pays off when the signal loop below will
        # also consume raw chunks (use_chunks); other paths re-read
        if use_chunks and not _DISABLE_NATIVE:
            rd0 = open_alignment(bam_path, ref=ref)
            if hasattr(rd0, "iter_chunks"):
                # share one BGZF decompression between the stats
                # consumers and (below) the signal scan
                rep = _ReplayableChunks(rd0.iter_chunks())
                stats = compute_stats(
                    bam_path, ref=ref, _chunks=rep,
                    _ref_lens=list(rd0.header.ref_lens))
                if rep.truncated:
                    rep = None  # cache overflow: re-read fresh below
            if rep is None:
                rd0.close()
                rd0 = None
        if stats is None:
            stats = compute_stats(bam_path, ref=ref)
    ex = SignalExtractor(stats, opts)
    unpaired: list[BamRecord] = []
    reason_arr = np.zeros(1024, np.int64) if use_render else None

    def _render_blob(blob, offs_a, lens_a, mode):
        """Native parse+pair+classify+FASTQ-render for one block; returns
        the leftover indices (mode 0) for phase 2."""
        fq, n_pairs, n_signal, stat_emitted, leftover = \
            native_glue.signal_render(
                lib, blob, offs_a, lens_a, mode=mode,
                min_isize=ex.stats.min_isize, max_isize=ex.stats.max_isize,
                max_tid=ex.opts.max_tid,
                discard_full=ex.opts.discard_both_full_match,
                not_using_filter=ex.opts.not_using_filter,
                lowq_cutoff=ex.opts.lowq_phred_cutoff,
                emit_stat=not ex._stat_emitted,
                st_read_len=ex.stats.read_len, st_min=ex.stats.min_isize,
                st_mid=ex.stats.mid_isize, st_max=ex.stats.max_isize,
                reason_counts=reason_arr,
            )
        out_fq.write(fq.decode("ascii"))
        ex.n_pairs += n_pairs
        ex.n_signal += n_signal
        if stat_emitted:
            ex._stat_emitted = True
        return leftover

    def _render_block(bodies_l, mode):
        blob = b"".join(bodies_l)
        lens_a = np.fromiter((len(b) for b in bodies_l), np.int64,
                             count=len(bodies_l))
        offs_a = np.zeros(len(bodies_l), np.int64)
        np.cumsum(lens_a[:-1], out=offs_a[1:])
        return _render_blob(blob, offs_a, lens_a.astype(np.int32), mode)


    with (rd0 if rd0 is not None else
          open_alignment(bam_path, ref=ref)) as rd:
        if use_chunks and hasattr(rd, "iter_chunks"):
            # fully native streaming: record boundaries + columns in C++,
            # block segmentation in NumPy, pair/classify/render in C++ —
            # no per-record Python at all
            # zero-copy block assembly: per-chunk memoryview slices
            # collect in seg_parts and concatenate ONCE at flush (the
            # bytearray+= / bytes() route copied every block twice)
            seg_parts: list = []
            seg_base = 0
            offs_parts: list[np.ndarray] = []
            lens_parts: list[np.ndarray] = []
            count = 0
            tid0 = pos0 = 0

            def flush_chunked():
                nonlocal seg_parts, seg_base, offs_parts, lens_parts, count
                if count:
                    blob = b"".join(seg_parts)
                    offs_a = np.concatenate(offs_parts)
                    lens_a = np.concatenate(lens_parts)
                    if count < 2:
                        unpaired.append(LazyBamRecord(
                            blob[int(offs_a[0]):int(offs_a[0] + lens_a[0])]))
                    else:
                        for i in _render_blob(blob, offs_a, lens_a, 0):
                            o, l = int(offs_a[i]), int(lens_a[i])
                            unpaired.append(LazyBamRecord(blob[o : o + l]))
                seg_parts = []
                seg_base = 0
                offs_parts, lens_parts = [], []
                count = 0

            carry = b""
            for chunk in (rep.stream() if rep is not None
                          else rd.iter_chunks()):
                data = carry + chunk if carry else chunk
                nr, consumed, offs_c, lens_c, tid_c, pos_c, flag_c, _, _ = \
                    native_glue.bam_scan(lib, data)
                carry = data[consumed:]
                if nr == 0:
                    continue
                keep = (flag_c & 0x900) == 0
                offs_k = offs_c[keep]
                lens_k = lens_c[keep]
                tid_k = tid_c[keep]
                pos_k = pos_c[keep]
                nk = len(offs_k)
                i = 0
                while i < nk:
                    if count == 0:
                        tid0 = int(tid_k[i])
                        pos0 = int(pos_k[i])
                    # run end within this chunk for the open block: first
                    # index with a tid change, a pos gap beyond the search
                    # region, or the record-count cap (the same boundary
                    # rule as the per-record loop below)
                    seg_t = tid_k[i:]
                    diff = np.nonzero(seg_t != tid0)[0]
                    j_tid = int(diff[0]) if len(diff) else nk - i
                    gap = pos_k[i : i + j_tid] > pos0 + SEARCH_REGION_MAX
                    j_pos = int(np.argmax(gap)) if gap.any() else j_tid
                    j = i + min(j_pos, SAM_LOAD_BUFF_SIZE - count)
                    if j > i:
                        first = int(offs_k[i])
                        last = int(offs_k[j - 1] + lens_k[j - 1])
                        seg_parts.append(memoryview(data)[first:last])
                        offs_parts.append(offs_k[i:j] - first + seg_base)
                        lens_parts.append(lens_k[i:j])
                        seg_base += last - first
                        count += j - i
                    if j < nk:
                        flush_chunked()  # next record starts a new block
                        if j == i:
                            continue  # cap hit exactly: re-enter with i
                    i = j
            flush_chunked()
        elif native_ok and hasattr(rd, "iter_bodies"):
            # raw-body streaming: block boundaries read tid/pos/flag at
            # fixed offsets; record objects exist only for signal pairs
            # and phase-2 leftovers
            import struct as _struct

            _tp = _struct.Struct("<ii").unpack_from
            bodies: list[bytes] = []
            tid0 = pos0 = 0

            def flush_bodies():
                if len(bodies) < 2:
                    unpaired.extend(LazyBamRecord(b) for b in bodies)
                    return
                if use_render:
                    for i in _render_block(bodies, 0):
                        unpaired.append(LazyBamRecord(bodies[i]))
                    return
                block = _BodyBlock(bodies)
                if not _pair_block_native(block, ex, out_fq, unpaired):
                    _pair_block(list(block), ex, out_fq, unpaired)

            for body in rd.iter_bodies():
                flag = body[14] | (body[15] << 8)
                if flag & 0x900:  # secondary | supplementary
                    continue
                tid, pos = _tp(body, 0)
                if bodies and (
                    tid != tid0
                    or pos - pos0 > SEARCH_REGION_MAX
                    or len(bodies) >= SAM_LOAD_BUFF_SIZE
                ):
                    flush_bodies()
                    bodies = []
                if not bodies:
                    tid0, pos0 = tid, pos
                bodies.append(body)
            flush_bodies()
        else:
            block: list[BamRecord] = []

            def flush_block():
                if len(block) < 2:
                    unpaired.extend(block)
                    return
                _pair_block(block, ex, out_fq, unpaired)

            it = rd.iter_lazy() if hasattr(rd, "iter_lazy") else rd
            for rec in it:
                if rec.is_secondary or rec.is_supplementary:
                    continue
                if block and (
                    rec.tid != block[0].tid
                    or rec.pos - block[0].pos > SEARCH_REGION_MAX
                    or len(block) >= SAM_LOAD_BUFF_SIZE
                ):
                    flush_block()
                    block = []
                block.append(rec)
            flush_block()

    # phase 2: name-sorted pairing of the leftovers (getSignalRead.cpp:436-488)
    unpaired.sort(key=lambda r: (r.name, not r.is_read1))
    if use_render and unpaired:
        bodies2 = [r._body for r in unpaired]
        if all(b is not None for b in bodies2):
            _render_block(bodies2, 1)
        else:
            use_render = False
    if not use_render:
        i = 0
        while i + 1 < len(unpaired):
            if unpaired[i].name == unpaired[i + 1].name:
                a, c = unpaired[i], unpaired[i + 1]
                if not a.is_read1:
                    a, c = c, a
                ex.emit_pair(a, c, out_fq)
                i += 2
            else:
                i += 1
    if reason_arr is not None:
        for r in np.nonzero(reason_arr)[0]:
            ex.reason_counter[int(r)] = (
                ex.reason_counter.get(int(r), 0) + int(reason_arr[r]))
    stats.reason_flag_counter = ex.reason_counter
    return stats


class _BodyBlock:
    """Sequence view over raw record bodies: LazyBamRecord objects are
    built (and cached) only for the indices actually touched — emitted
    signal pairs and phase-2 leftovers."""

    __slots__ = ("bodies", "_recs")

    def __init__(self, bodies: list):
        self.bodies = bodies
        self._recs: dict[int, LazyBamRecord] = {}

    def __len__(self):
        return len(self.bodies)

    def __getitem__(self, i: int):
        r = self._recs.get(i)
        if r is None:
            r = self._recs[i] = LazyBamRecord(self.bodies[i])
        return r

    def __iter__(self):
        for i in range(len(self.bodies)):
            yield self[i]


def _pair_block_native(block, ex: SignalExtractor, out_fq, unpaired) -> bool:
    """Native-scan form of _pair_block: the C++ pass parses every raw
    record body, pairs mates and runs the pair filter; Python only
    renders the FASTQ for pairs marked signal. Identical output to the
    Python path (tested). Returns False when the native library (or the
    raw bodies) are unavailable."""
    from ..align import native_glue

    lib = native_glue.get_lib()
    if lib is None:
        return False
    if isinstance(block, _BodyBlock):
        bodies = block.bodies
    else:
        bodies = []
        for r in block:
            body = getattr(r, "_body", None)
            if body is None:
                return False
            bodies.append(body)
    offs = np.zeros(len(bodies) + 1, np.int64)
    np.cumsum([len(b) for b in bodies], out=offs[1:])
    res = native_glue.signal_scan(
        lib, b"".join(bodies), offs,
        min_isize=ex.stats.min_isize, max_isize=ex.stats.max_isize,
        max_tid=ex.opts.max_tid, discard_full=ex.opts.discard_both_full_match,
        not_using_filter=ex.opts.not_using_filter,
        lowq_cutoff=ex.opts.lowq_phred_cutoff,
    )
    cols, mate, verdict, reason = res

    for i in np.nonzero(mate < 0)[0]:
        unpaired.append(block[i])
    # pairs visited by the Python loop: read1 member, mate not read1
    flags = cols[:, 7]
    is_r1 = (flags & 0x40) != 0
    m_ok = mate >= 0
    mate_c = np.where(m_ok, mate, 0)
    classified = m_ok & is_r1 & ~is_r1[mate_c]
    for i in np.nonzero(classified)[0]:
        ex.n_pairs += 1
        v = int(verdict[i])
        if v == -1:
            continue  # -U full-match discard (no reason count)
        rs = int(reason[i])
        ex.reason_counter[rs] = ex.reason_counter.get(rs, 0) + 1
        if v == 1:
            j = int(mate[i])
            pre = (
                (int(cols[i, 0]), int(cols[j, 0])),   # score_by_cigar
                (int(cols[i, 1]), int(cols[j, 1])),   # soft_left
                (int(cols[i, 2]), int(cols[j, 2])),   # clip sum
                (int(cols[i, 4]), int(cols[j, 4])),   # NM
                (int(cols[i, 5]), int(cols[j, 5])),   # xa_number
            )
            ex._write_pair(block[i], block[j], out_fq, pre)
    return True


def _pair_block(block, ex: SignalExtractor, out_fq, unpaired):
    """Greedy in-block mate pairing (getSignalRead.cpp:305-420)."""
    if _pair_block_native(block, ex, out_fq, unpaired):
        return
    n = len(block)
    mate = [-1] * n
    pos_of = {}
    by_pos: dict[int, list[int]] = {}
    for k, r in enumerate(block):
        by_pos.setdefault(r.pos, []).append(k)
    for i, r in enumerate(block):
        if mate[i] >= 0:
            continue
        if r.tid != r.mtid:
            continue
        if r.tid == -1:
            # both-unmapped pairs sit adjacent
            for k in (i + 1, i - 1):
                if 0 <= k < n and block[k].name == r.name and mate[k] < 0:
                    mate[i] = k
                    mate[k] = i
                    break
            continue
        for k in by_pos.get(r.mpos, []):
            m = block[k]
            if k != i and m.mpos == r.pos and m.name == r.name and mate[k] < 0:
                mate[i] = k
                mate[k] = i
                break
    for i, r in enumerate(block):
        if mate[i] < 0:
            unpaired.append(r)
    for i, r in enumerate(block):
        if mate[i] < 0 or not r.is_read1:
            continue
        m = block[mate[i]]
        if not m.is_read1:
            ex.emit_pair(r, m, out_fq)
