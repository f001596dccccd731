"""Manta-derived insert-size statistics (StatsManager / StatsTracker /
SizeDistribution port).

Behavioral re-implementation of
/root/reference/src/cpp_lib/statistics/{StatsTracker.hpp:34-426,
StatsManager.hpp:24-411, StatsTracker.cpp, StatsManager.cpp:143-222}:

  - region-sampled estimation: each chromosome is sampled from 20% of
    its length; buffers of 1000 proper-pair (FR) observations are
    accepted only when <1% are abnormal (fragment >= 5000), otherwise
    the sampler skips ahead by chrom_size/100;
  - fragment sizes are simplified to 4 significant digits above 1000
    (getSimplifiedFragSize) and accumulated in a SizeDistribution with
    1000-bin CDF quantiles (populateCdfQuantiles semantics);
  - convergence: once 100k observations are buffered in, quantiles
    p=0.05,0.15..0.95 of the old vs new distribution must agree within
    1 and the CDFs within 0.001 (isStatSetMatch) — estimation stops
    early on convergence;
  - finalization trims the distribution above the 0.9995 quantile;
  - average depth = total sampled bases / total sampled reference span;
  - getInsertLen(p) exposes the quantiles used by fc_signal (1%/50%/99%)
    and getBreakPoint_Distribution produces the DR/SH/UM breakpoint
    probability vectors the de novo caller consumes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

STATS_CHECK_CNT = 100_000
BUFFER_FULL = 1000
ABNORMAL_SIZE = 5000
ABNORMAL_FRAC = 0.01
FILTER_QUANT = 0.9995
QUANTILE_NUM = 1000


def simplified_frag_size(frag: int) -> int:
    """getSimplifiedFragSize (StatsTracker.cpp:324-335): keep the top 4
    decimal digits."""
    steps = 0
    while frag > 1000:
        frag //= 10
        steps += 1
    return frag * (10 ** steps)


class SizeDistribution:
    def __init__(self):
        self.counts: dict[int, int] = {}
        self.total = 0
        self._quantiles: np.ndarray | None = None

    def add(self, size: int, n: int = 1):
        self.counts[size] = self.counts.get(size, 0) + n
        self.total += n
        self._quantiles = None

    def _calc(self):
        q = np.zeros(QUANTILE_NUM, np.int64)
        fill = 0
        cum = 0
        for size in sorted(self.counts):
            cum += self.counts[size]
            cprob = cum / self.total
            fill_next = int(np.rint(cprob * QUANTILE_NUM))
            if fill_next > fill:
                q[fill:fill_next] = size
                fill = fill_next
        q[fill:] = q[fill - 1] if fill else 0
        self._quantiles = q

    def quantile(self, prob: float) -> int:
        if self.total == 0:
            return 0
        if self._quantiles is None:
            self._calc()
        b = int(np.ceil(prob * QUANTILE_NUM) - 1)
        return int(self._quantiles[min(max(b, 0), QUANTILE_NUM - 1)])

    def cdf(self, size: int) -> float:
        if self.total == 0:
            return 0.0
        cum = sum(n for s, n in self.counts.items() if s <= size)
        return cum / self.total

    def filter_over_quantile(self, prob: float):
        mx = self.quantile(prob)
        for s in [s for s in self.counts if s > mx]:
            self.total -= self.counts.pop(s)
        self._quantiles = None

    def matches(self, other: "SizeDistribution") -> bool:
        """isStatSetMatch (StatsTracker.cpp:161-175)."""
        p = 0.05
        while p < 1:
            if abs(self.quantile(p) - other.quantile(p)) >= 1:
                return False
            p += 0.1
        return True

    def copy(self) -> "SizeDistribution":
        d = SizeDistribution()
        d.counts = dict(self.counts)
        d.total = self.total
        return d

    def pmf(self) -> tuple[np.ndarray, int]:
        """(probability array indexed from min size, min size)."""
        if not self.counts:
            return np.zeros(1), 0
        lo = min(self.counts)
        hi = max(self.counts)
        arr = np.zeros(hi - lo + 1, np.float64)
        for s, n in self.counts.items():
            arr[s - lo] = n
        return arr / max(self.total, 1), lo


@dataclass
class ReadCounter:
    total: int = 0
    paired: int = 0
    unpaired: int = 0
    paired_low_mapq: int = 0
    high_confidence_pairs: int = 0


class StatsTracker:
    """Per-sample tracker (the reference keys by read group; fc_signal
    uses one group per BAM)."""

    def __init__(self):
        self.frag = SizeDistribution()
        self.counter = ReadCounter()
        self._buf_sizes: list[int] = []
        self._buf_rp = 0
        self._buf_abnormal = 0
        self._checked = False
        self._converged = False
        self._old: SizeDistribution | None = None
        self._finalized = False

    # -- record handling ------------------------------------------------
    def handle_basic(self, rec):
        self.handle_basic_f(rec.flag, rec.mapq)

    def handle_basic_f(self, flag: int, mapq: int):
        self.counter.total += 1
        if flag & 0x1:
            self.counter.paired += 1
            if mapq == 0:
                self.counter.paired_low_mapq += 1
        else:
            self.counter.unpaired += 1

    @staticmethod
    def _is_rp_f(flag, tid, mtid, pos, mpos) -> bool:
        """FR ('Rp') orientation: mates on opposite strands with the
        forward mate first."""
        if not (flag & 0x1) or (flag & 0x4) or (flag & 0x8):
            return False
        if tid != mtid:
            return False
        rev = flag & 0x10
        if bool(rev) == bool(flag & 0x20):
            return False
        if not rev:
            return pos <= mpos
        return mpos <= pos

    def handle_check(self, rec) -> str:
        return self.handle_check_f(rec.flag, rec.tid, rec.mtid, rec.pos,
                                   rec.mpos, rec.isize)

    def handle_check_f(self, flag, tid, mtid, pos, mpos, isize) -> str:
        """RGT_CONTINUE | RGT_BREAK | RGT_NORMAL."""
        if self._converged:
            return "CONTINUE"
        if self._is_rp_f(flag, tid, mtid, pos, mpos):
            frag = simplified_frag_size(abs(isize))
            self._buf_rp += 1
            if frag >= ABNORMAL_SIZE:
                self._buf_abnormal += 1
            self._buf_sizes.append(frag)
        if self._buf_rp >= BUFFER_FULL:
            normal = (self._buf_abnormal / self._buf_rp) < ABNORMAL_FRAC
            if normal:
                self._add_buffered()
            self._clear_buffer()
            if not normal:
                return "BREAK"
        if not self._checked:
            return "CONTINUE"
        self._convergence_test()
        return "NORMAL"

    def _add_buffered(self):
        for s in self._buf_sizes:
            self.frag.add(s)
            self.counter.high_confidence_pairs += 1
        if self.frag.total >= STATS_CHECK_CNT:
            self._checked = True

    def _clear_buffer(self):
        self._buf_sizes = []
        self._buf_rp = 0
        self._buf_abnormal = 0

    def _convergence_test(self):
        if self._old is not None and self.frag.matches(self._old):
            self._converged = True
        else:
            self._old = self.frag.copy()
            self._checked = False  # wait for the next 100k before re-test

    @property
    def converged(self) -> bool:
        return self._converged

    @property
    def checked(self) -> bool:
        return self._checked

    def finalize(self):
        if self._finalized:
            return
        if self._buf_rp and (self._buf_abnormal / self._buf_rp) < ABNORMAL_FRAC:
            self._add_buffered()
        self._clear_buffer()
        if self.frag.total:
            self.frag.filter_over_quantile(FILTER_QUANT)
        self._finalized = True


class StatsManager:
    """handleBamCramStats (StatsManager.cpp:143-222): region-sampled
    single-pass estimation over a position-sorted BAM."""

    def __init__(self):
        self.tracker = StatsTracker()
        self.ave_depth = 0.0

    def handle_bam(self, bam_path: str, ref=None, _chunks=None,
                   _ref_lens=None):
        """`_chunks` + `_ref_lens`: pre-decompressed record chunks from a
        caller that already paid the BGZF pass (extract_signal shares one
        decompression across its stats and render passes)."""
        if _chunks is not None and self.handle_chunks(_chunks, _ref_lens):
            return self
        from ..io.alignment import open_alignment

        # our BAM layer is streaming, not region-seekable mid-estimation,
        # so the chromosome slices are simulated on the stream: records
        # before each chromosome's 20% start point are skipped, and a
        # BREAK skips records until the next slice start
        with open_alignment(bam_path, ref=ref) as rd:
            if (not os.environ.get("PANSVR_NO_NATIVE_STATS")
                    and hasattr(rd, "iter_chunks")
                    and self.handle_chunks(rd.iter_chunks(),
                                           list(rd.header.ref_lens))):
                return self
            return self._handle_python(rd)

    def handle_chunks(self, chunk_iter, ref_lens) -> bool:
        """C++ per-record loop (glue_stats_scan): the same tracker
        semantics, fed raw decompressed chunks; the exported state is
        finalized by the Python SizeDistribution so every downstream
        query (status text, quantiles, breakpoint distributions) is
        identical to the Python path (tests/test_signal.py::
        test_native_stats_parity). False when the native library is
        unavailable.

        NOTE: the imported tracker is FINALIZE-ONLY — the native scan
        does not export the mid-convergence `_old` quantile snapshot, so
        a tracker returned by this path cannot be resumed with more
        records (finalize() is called below; further handle_* calls
        would restart the convergence cycle from scratch)."""
        from ..align import native_glue

        if (not native_glue.available()
                or os.environ.get("PANSVR_NO_NATIVE_STATS")):
            return False
        lib = native_glue.get_lib()
        import ctypes

        lens = np.asarray(list(ref_lens), np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ctx = lib.glue_stats_create(
            lens.ctypes.data_as(i64p), len(lens))
        try:
            conv = ctypes.c_int32(0)
            carry = b""
            for chunk in chunk_iter:
                data = carry + chunk if carry else chunk
                used = lib.glue_stats_scan(
                    ctx, ctypes.cast(data, u8p), len(data),
                    ctypes.byref(conv))
                carry = data[used:]
                if conv.value:
                    break
            sizes = np.zeros(2, np.int64)
            lib.glue_stats_sizes(ctx, sizes.ctypes.data_as(i64p))
            n_hist, n_buf = int(sizes[0]), int(sizes[1])
            hist_sizes = np.zeros(max(n_hist, 1), np.int32)
            hist_counts = np.zeros(max(n_hist, 1), np.int64)
            buf_sizes = np.zeros(max(n_buf, 1), np.int32)
            scal = np.zeros(12, np.int64)
            lib.glue_stats_export(
                ctx, hist_sizes.ctypes.data_as(i32p),
                hist_counts.ctypes.data_as(i64p),
                buf_sizes.ctypes.data_as(i32p),
                scal.ctypes.data_as(i64p))
        finally:
            lib.glue_stats_free(ctx)

        tr = self.tracker
        tr.frag.counts = {
            int(s): int(c)
            for s, c in zip(hist_sizes[:n_hist], hist_counts[:n_hist])
        }
        tr.frag.total = int(scal[0])
        tr.counter.total = int(scal[1])
        tr.counter.paired = int(scal[2])
        tr.counter.unpaired = int(scal[3])
        tr.counter.paired_low_mapq = int(scal[4])
        tr.counter.high_confidence_pairs = int(scal[5])
        tr._buf_sizes = [int(s) for s in buf_sizes[:n_buf]]
        tr._buf_rp = int(scal[6])
        tr._buf_abnormal = int(scal[7])
        tr._checked = bool(scal[8])
        tr._converged = bool(scal[9])
        tr.finalize()
        span = int(scal[11])
        self.ave_depth = int(scal[10]) / span if span > 0 else 0.0
        return True

    def _handle_python(self, rd):
        lens = list(rd.header.ref_lens)
        start_at = [int(l * 0.2) for l in lens]
        skip_until: dict[int, int] = {}
        total_base = 0
        span_lo: dict[int, int] = {}
        span_hi: dict[int, int] = {}
        if hasattr(rd, "iter_bodies"):
            # fixed-header-only scan over raw record bodies
            import struct as _struct

            _tp = _struct.Struct("<ii").unpack_from
            _mid = _struct.Struct("<Hiiii").unpack_from
            n_lens = len(lens)
            tr = self.tracker
            for body in rd.iter_bodies():
                if tr._converged:
                    break
                tid, pos = _tp(body, 0)
                if tid < 0 or tid >= n_lens:
                    continue
                if pos < start_at[tid]:
                    continue
                if pos < skip_until.get(tid, 0):
                    continue
                flag, l_seq, mtid, mpos, tlen = _mid(body, 14)
                if flag & 0x900:  # secondary | supplementary
                    continue
                total_base += l_seq
                span_lo.setdefault(tid, pos)
                span_hi[tid] = max(span_hi.get(tid, 0), pos)
                tr.handle_basic_f(flag, body[9])
                r = tr.handle_check_f(flag, tid, mtid, pos, mpos, tlen)
                if r == "BREAK":
                    skip_until[tid] = pos + max(1, lens[tid] // 100)
        else:
            for rec in rd:
                if self.tracker.converged:
                    break
                if rec.tid < 0 or rec.tid >= len(lens):
                    continue
                if rec.pos < start_at[rec.tid]:
                    continue
                if rec.pos < skip_until.get(rec.tid, 0):
                    continue
                if rec.is_secondary or rec.is_supplementary:
                    continue
                total_base += rec.query_len
                span_lo.setdefault(rec.tid, rec.pos)
                span_hi[rec.tid] = max(span_hi.get(rec.tid, 0), rec.pos)
                self.tracker.handle_basic(rec)
                r = self.tracker.handle_check(rec)
                if r == "BREAK":
                    skip_until[rec.tid] = rec.pos + max(
                        1, lens[rec.tid] // 100)
        self.tracker.finalize()
        span = sum(span_hi.get(t, 0) - span_lo.get(t, 0)
                   for t in span_lo)
        self.ave_depth = total_base / span if span > 0 else 0.0
        return self

    # -- queries --------------------------------------------------------
    def get_insert_len(self, prob: float, default_min=200, default_max=600):
        if self.tracker.frag.total == 0:
            return default_min if prob < 0.5 else default_max
        return self.tracker.frag.quantile(prob)

    def isize_distribution(self):
        return self.tracker.frag.pmf()

    def breakpoint_distributions(self, read_len: int):
        """getBreakPoint_Distribution (StatsManager.hpp:325-380)."""
        frag = self.tracker.frag
        total_rp = max(self.tracker.counter.high_confidence_pairs, 1)
        max_len = frag.quantile(0.99)
        max_p = max_len - 2 * read_len
        if max_p > 50:
            dr = np.zeros(max_p, np.float64)
            for i in range(1, max_p):
                cnt = frag.counts.get(i + 2 * read_len, 0)
                pi = (cnt / total_rp) / i
                dr[:i] += pi
            s = dr.sum()
            if s > 0:
                dr /= s
        else:
            dr = np.full(50, 0.02, np.float64)
        sh = np.full(10, 0.1, np.float64)
        min_len = frag.quantile(0.03)
        max_len = frag.quantile(0.97)
        st_um = min_len - read_len
        um = np.zeros(max(max_len - min_len, 1), np.float64)
        for i in range(len(um)):
            um[i] = frag.counts.get(i + min_len, 0) / total_rp
        return dr, sh, um, st_um
