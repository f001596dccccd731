"""Signal extraction on simulated BAMs."""

import io

import numpy as np
import pytest

from pansvr_tpu.io.bam import BamReader
from pansvr_tpu.signal.extract import (
    SignalOptions,
    SignalStats,
    compute_stats,
    extract_signal,
    score_by_cigar,
)
from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam


@pytest.fixture(scope="module")
def sim_bam(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sig")
    ds = make_dataset(
        seed=60, n_sv=6, n_pairs=600, types=("DEL", "INS"),
        chrom_lengths={"chr1": 300_000}, err_rate=0.0,
    )
    p = str(tmp / "sim.bam")
    write_sim_bam(ds, p)
    return ds, p


def test_stats(sim_bam):
    ds, p = sim_bam
    st = compute_stats(p, genome_size=300_000)
    assert st.read_len == 150
    # quantiles come from the Manta StatsManager sampling like the
    # reference's (measured on this BAM: the reference binary prints
    # MIN: 199 MIDDLE: 404 MAX: 513, ave_read_depth 0.58)
    assert 150 < st.min_isize < 450
    assert 350 < st.max_isize < 700
    assert st.min_isize < st.mid_isize < st.max_isize
    assert 0.3 < st.ave_read_depth < 1.2  # sampled local depth, not /3.1G
    assert len(st.isize_distribution) == st.max_isize - st.min_isize
    # status file round trip
    st2 = SignalStats.parse_status_text(st.status_file_text())
    assert st2.read_len == st.read_len
    assert st2.min_isize == st.min_isize
    assert len(st2.isize_distribution) == len(st.isize_distribution)


def test_score_by_cigar():
    from pansvr_tpu.io.bam import BamRecord
    r = BamRecord(cigar=[("M", 150)], tags=[("NM", "i", 0)])
    assert score_by_cigar(r) == 300
    r = BamRecord(cigar=[("M", 150)], tags=[("NM", "i", 2)])
    assert score_by_cigar(r) == 300 - 2 * 14
    r = BamRecord(cigar=[("S", 20), ("M", 130)], tags=[("NM", "i", 0)])
    assert score_by_cigar(r) == 260 - min(16 + 20, 32)


def test_extract_signal(sim_bam):
    ds, p = sim_bam
    out = io.StringIO()
    st = extract_signal(p, out, opts=SignalOptions(discard_both_full_match=True))
    fq = out.getvalue()
    lines = fq.splitlines()
    assert len(lines) % 8 == 0  # interleaved pairs, 4 lines per read
    n_pairs_out = len(lines) // 8
    # clean proper pairs are discarded; breakpoint pairs survive
    assert 0 < n_pairs_out < 300
    # first read's comment carries the STAT_ block
    assert "STAT_" in lines[0]
    # comments parse back: tid_pos_softLeft_score_mapq...
    head = lines[0].split(" ", 1)[1]
    fields = head.split("_")
    assert fields[0].lstrip("-").isdigit()
    # signal reads should be enriched near SV breakpoints
    names = set(l[1:].split(" ")[0] for l in lines[0::4])
    alt_frac = sum(1 for n in names if n.startswith("alt")) / len(names)
    assert alt_frac > 0.6


def test_native_scan_matches_python(sim_bam):
    """The C++ block scan (pairing + filter + comment columns) must give
    byte-identical FASTQ and identical telemetry vs the Python path."""
    from pansvr_tpu.align import native_glue
    from pansvr_tpu.signal import extract as ext

    assert native_glue.get_lib() is not None
    ds, p = sim_bam
    for opts in (SignalOptions(discard_both_full_match=True),
                 SignalOptions(discard_both_full_match=False,
                               not_using_filter=True)):
        out_r, out_n, out_p = io.StringIO(), io.StringIO(), io.StringIO()
        st_r = extract_signal(p, out_r, opts=opts)  # native FASTQ renderer
        orig = ext._pair_block_native
        ext._DISABLE_RENDER = True
        try:
            st_n = extract_signal(p, out_n, opts=opts)  # native column scan
            ext._pair_block_native = lambda *a: False
            ext._DISABLE_NATIVE = True
            st_p = extract_signal(p, out_p, opts=opts)  # pure Python
        finally:
            ext._pair_block_native = orig
            ext._DISABLE_RENDER = False
            ext._DISABLE_NATIVE = False
        assert out_r.getvalue() == out_p.getvalue()
        assert out_n.getvalue() == out_p.getvalue()
        assert st_r.reason_flag_counter == st_p.reason_flag_counter
        assert st_n.reason_flag_counter == st_p.reason_flag_counter
        assert (st_r.read_len, st_r.min_isize, st_r.max_isize) == \
            (st_p.read_len, st_p.min_isize, st_p.max_isize)


def test_extract_all_dump(sim_bam):
    ds, p = sim_bam
    out = io.StringIO()
    extract_signal(
        p, out,
        opts=SignalOptions(discard_both_full_match=False, not_using_filter=True),
    )
    n_reads_out = out.getvalue().count("\n@") + 1
    # dump mode emits every paired read
    assert n_reads_out >= 2 * 500


def test_stats_manager_region_sampling(tmp_path):
    """The Manta StatsManager port: region-sampled quantiles must agree
    with the directly computed proper-pair quantiles on a sim BAM, and
    the depth estimate must be in the right range."""
    import numpy as np

    from pansvr_tpu.signal.stats_manager import StatsManager
    from pansvr_tpu.io.bam import BamReader
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam

    ds = make_dataset(seed=55, n_sv=2, n_pairs=4000, types=("DEL",),
                      chrom_lengths={"chr1": 150_000}, err_rate=0.0,
                      sv_region_reads=False)
    bam = str(tmp_path / "sim.bam")
    write_sim_bam(ds, bam)
    sm = StatsManager().handle_bam(bam)

    # direct proper-pair isizes from the same sampled region (>=20%)
    sizes = []
    with BamReader(bam) as rd:
        clen = rd.header.ref_lens[0]
        for rec in rd:
            if rec.pos < int(clen * 0.2):
                continue
            if (rec.flag & 0x1) and not (rec.flag & 0xC) \
                    and rec.is_reverse != rec.mate_reverse \
                    and ((not rec.is_reverse and rec.pos <= rec.mpos)
                         or (rec.is_reverse and rec.mpos <= rec.pos)):
                sizes.append(abs(rec.isize))
    sizes = np.array(sizes)
    for p in (0.01, 0.5, 0.99):
        direct = float(np.quantile(sizes, p))
        got = sm.get_insert_len(p)
        assert abs(got - direct) <= max(20, direct * 0.05), \
            f"quantile {p}: {got} vs {direct}"
    assert sm.ave_depth > 0.5
    dr, sh, um, st_um = sm.breakpoint_distributions(150)
    assert abs(dr.sum() - 1.0) < 0.01 or len(dr) == 50
    assert len(sh) == 10


def test_native_stats_parity(tmp_path):
    """The native stats scan (glue_stats_scan) must export EXACTLY the
    tracker state the Python path computes — including through the 100k
    convergence test and the abnormal-buffer BREAK/skip path (ADVICE r3:
    nothing previously asserted native-vs-Python equality)."""
    import struct

    from pansvr_tpu.align import native_glue
    from pansvr_tpu.io.bam import BamHeader, BamWriter
    from pansvr_tpu.signal.stats_manager import StatsManager

    assert native_glue.available()

    clen = 1_000_000
    header = BamHeader(text="@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000000\n",
                       ref_names=["chr1"], ref_lens=[clen])
    bam = str(tmp_path / "stats.bam")

    # synthetic position-sorted records: proper FR pairs with a stable
    # isize distribution (converges shortly after the 100k check count),
    # one solid buffer of abnormal isizes early (trips BREAK + the
    # chrom/100 skip), plus unpaired / secondary / mapq-0 records so
    # every counter field is exercised.
    rng = np.random.RandomState(7)
    n = 120_000
    isizes = (400 + 30 * rng.randn(n)).astype(np.int64).clip(50, 4000)
    isizes[5_000:6_200] = 9_999           # > ABNORMAL_SIZE => BREAK
    pos0 = int(clen * 0.2)
    head = struct.Struct("<iiBBHHHiiii")
    with BamWriter(bam, header) as w:
        for k in range(n):
            pos = pos0 + 3 * k
            kind = k % 37
            if kind == 5:
                flag, mapq = 0x0, 30          # unpaired
            elif kind == 11:
                flag, mapq = 0x121, 0         # paired, rev, mapq 0
            elif kind == 17:
                flag, mapq = 0x901, 30        # secondary (skipped)
            else:
                flag, mapq = 0x61, 30         # paired, FR fwd, mate rev
            isz = int(isizes[k])
            body = head.pack(0, pos, 2, mapq, 0, 0, flag, 2, 0,
                             pos + isz - 2, isz)
            body += b"r\0" + b"\x11" + b"\x20\x20"   # name, seq, qual
            w.write_raw(body)

    import os as _os

    native = StatsManager().handle_bam(bam)
    _os.environ["PANSVR_NO_NATIVE_STATS"] = "1"
    try:
        python = StatsManager().handle_bam(bam)
    finally:
        del _os.environ["PANSVR_NO_NATIVE_STATS"]

    tn, tp = native.tracker, python.tracker
    assert tp._converged, "test world must reach the convergence path"
    assert tn._converged == tp._converged
    assert tn._checked == tp._checked
    assert tn.frag.total == tp.frag.total
    assert tn.frag.counts == tp.frag.counts
    for f in ("total", "paired", "unpaired", "paired_low_mapq",
              "high_confidence_pairs"):
        assert getattr(tn.counter, f) == getattr(tp.counter, f), f
    assert tn._buf_sizes == tp._buf_sizes
    assert tn._buf_rp == tp._buf_rp
    assert tn._buf_abnormal == tp._buf_abnormal
    assert native.ave_depth == python.ave_depth
    for p in (0.01, 0.5, 0.99):
        assert native.get_insert_len(p) == python.get_insert_len(p)
