"""Batched device engine vs the host aligner: identical results."""

import numpy as np
import pytest

from pansvr_tpu.align.engine import AlignEngine, EngineConfig
from pansvr_tpu.align.host_align import HostAligner, OriResult
from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.utils import dna
from pansvr_tpu.utils.simulate import DictGenome, make_dataset


@pytest.fixture(scope="module")
def world():
    ds = make_dataset(
        seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
        chrom_lengths={"chr1": 150_000},
    )
    contigs = list(
        build_anchor_contigs(ds.vcf_records, DictGenome(ds.genome), AnchorConfig())
    )
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    host = HostAligner(idx, ori_chrom_names=list(ds.genome))
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    return ds, idx, host, eng


def _cmp_states(sh, se, tag):
    assert len(sh.results) == len(se.results), (
        f"{tag}: result count {len(sh.results)} != {len(se.results)}"
    )
    for k, (rh, re_) in enumerate(zip(sh.results, se.results)):
        for f in ("align_score", "chain_score", "direction", "ref_bg",
                  "sv_id", "mapq"):
            assert getattr(rh, f) == getattr(re_, f), (
                f"{tag} result {k} field {f}: {getattr(rh, f)} != {getattr(re_, f)}"
            )
        assert rh.cigar == re_.cigar, f"{tag} result {k} cigar"


def test_engine_matches_host_on_sim_reads(world):
    ds, idx, host, eng = world
    reads = ds.reads[:60]
    seqs = [r.seq1 for r in reads] + [r.seq2 for r in reads]
    oris = [OriResult(unmapped=True)] * len(seqs)
    got = eng.align_batch(seqs, oris)
    n_with = 0
    for i, seq in enumerate(seqs):
        expect = host.align_read(seq, oris[i])
        _cmp_states(expect, got[i], f"read{i}")
        n_with += bool(expect.results)
    assert n_with > 20  # sanity: the comparison actually exercised alignments


def test_engine_matches_host_with_errors(world):
    ds, idx, host, eng = world
    rng = np.random.default_rng(41)
    # reads with indels relative to anchors
    contigs = list(idx.chr_names)
    seqs = []
    for t in range(24):
        cid = int(rng.integers(len(contigs)))
        s = idx.contig_seq_codes(cid)
        p = int(rng.integers(0, max(1, len(s) - 170)))
        codes = list(s[p : p + 160])
        for _ in range(int(rng.integers(0, 3))):
            g = int(rng.integers(-12, 13))
            pos = int(rng.integers(10, len(codes) - 14))
            if g > 0:
                codes[pos:pos] = [int(rng.integers(0, 4))] * g
            elif g < 0:
                del codes[pos : pos - g]
        for _ in range(int(rng.integers(0, 4))):
            pos = int(rng.integers(0, len(codes)))
            codes[pos] = (codes[pos] + 1) % 4
        seqs.append(dna.decode(np.array(codes[:160], dtype=np.uint8)))
    oris = [OriResult(unmapped=True)] * len(seqs)
    got = eng.align_batch(seqs, oris)
    for i, seq in enumerate(seqs):
        expect = host.align_read(seq, oris[i])
        _cmp_states(expect, got[i], f"mut{i}")


def test_engine_read_class_256(world):
    """250 bp reads must run through the device path (256 class), not the
    per-read host fallback, and still match the host aligner."""
    ds, idx, host, eng = world
    rng = np.random.default_rng(42)
    contigs = list(idx.chr_names)
    seqs = []
    for _ in range(24):
        cid = int(rng.integers(len(contigs)))
        start = int(idx.chr_starts[cid])
        end = int(idx.chr_starts[cid + 1])
        if end - start < 260:
            continue
        p = int(rng.integers(0, end - start - 250))
        codes = idx.ref_codes[start + p : start + p + 250].copy()
        codes = np.where(codes >= 4, np.uint8(0), codes)
        err = rng.random(250) < 0.01
        codes[err] = (codes[err] + 1) % 4
        seqs.append(dna.decode(codes))
    oris = [OriResult(unmapped=True)] * len(seqs)
    eng2 = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    got = eng2.align_batch(seqs, oris)
    assert eng2.prof.get("n_fallback", 0) == 0
    n_with = 0
    for i, seq in enumerate(seqs):
        expect = host.align_read(seq, oris[i])
        _cmp_states(expect, got[i], f"read{i}")
        n_with += bool(expect.results)
    assert n_with > len(seqs) // 2


def test_engine_long_read_class(world):
    """Reads in the 513..1600 range run through the device path in the
    1024/1600 classes (the reference's MAX_READ_LEN is 1600,
    read_realignment.hpp:322) and match the host aligner exactly."""
    ds, idx, host, eng = world
    rng = np.random.default_rng(43)
    names = list(idx.chr_names)
    seqs = []
    for i in range(6):
        name = names[i % len(names)]
        seq = idx.chr_seq(name) if hasattr(idx, "chr_seq") else None
        if seq is None:
            st = int(idx.chr_starts[i % len(names)])
            ed = int(idx.chr_starts[i % len(names) + 1])
            codes = idx.ref_codes[st:ed]
            seq = "".join("ACGTN"[min(c, 4)] for c in codes)
        L = min(700 + 37 * i, max(64, len(seq) - 2))
        p = int(rng.integers(0, max(1, len(seq) - L)))
        sub = np.frombuffer(seq[p : p + L].encode(), np.uint8).copy()
        mut = rng.random(L) < 0.01
        lut = {65: 67, 67: 71, 71: 84, 84: 65, 78: 65}
        for j in np.nonzero(mut)[0]:
            sub[j] = lut.get(int(sub[j]), 65)
        seqs.append(sub.tobytes().decode())
    oris = [OriResult(unmapped=True)] * len(seqs)
    got = eng.align_batch(seqs, oris)
    n_with = 0
    for i, seq in enumerate(seqs):
        expect = host.align_read(seq, oris[i])
        _cmp_states(expect, got[i], f"long{i}")
        n_with += bool(expect.results)
    assert n_with >= 3


def test_retier_widens_shapes_on_repeat_rich_reads():
    """Repeat-rich reads (shared segment across contigs) overflow the
    default caps; the engine must widen its shapes once the fallback
    rate crosses the threshold and then keep results identical to the
    host aligner with the device path active."""
    from pansvr_tpu.utils.simulate import random_genome

    rng = np.random.default_rng(7)
    shared = "".join(rng.choice(list("ACGT"), 900))
    contigs = []
    for i in range(3):
        base = "".join(rng.choice(list("ACGT"), 1400))
        seq = base[:500] + shared + base[500:]
        contigs.append(
            (f"{i}_chr1_{1 + i * 4000}_{len(seq)}_DEL_100_200_"
             f"{(i + 1) * 4000}_sv{i}", seq))
    idx = build_index(contigs, first_level_bases=10)
    reads = []
    for _ in range(3 * 256):
        _, seq = contigs[int(rng.integers(len(contigs)))]
        p = int(rng.integers(400, 500 + 900 - 150))
        reads.append(seq[p : p + 150])
    oris = [OriResult(unmapped=True)] * len(reads)
    eng = AlignEngine(idx)
    # lower the retier gate so the small test batches can trigger it
    eng.cfg.retier_threshold = 0.25
    B = 256
    last_fallback = None
    for b in range(3):
        eng._tier_window.append((1024, 1024))  # simulated heavy batches
        eng._tier_window.append((1024, 1024))
        states = eng.align_batch(reads[b * B : (b + 1) * B], oris[:B])
        last_fallback = eng._tier_window[-1][0] if eng._tier_window else 0
        assert all(s.results for s in states)
    assert eng.cfg.mem_slots > 32, "retier never triggered"
    assert last_fallback == 0, f"still {last_fallback} fallbacks after retier"
    # equality with the host on the widened shapes
    host = HostAligner(idx)
    st_e = eng.align_batch(reads[:32], oris[:32])
    for i in range(32):
        st_h = host.align_read(reads[i], oris[i])
        a = [(r.align_score, r.ref_bg, tuple(map(tuple, r.cigar or [])))
             for r in st_e[i].results]
        b2 = [(r.align_score, r.ref_bg, tuple(map(tuple, r.cigar or [])))
              for r in st_h.results]
        assert a == b2, f"read {i} differs post-retier"


def test_compact_front_parity():
    """Active-row compaction produces identical results to the
    uncompacted front across its adaptation (divisor growth + the
    act-window fine cap). Reads are drawn UNIFORMLY over the genome
    (sv_region_reads=False) so most rows hit no anchor k-mer — the
    regime compaction exists for (fc_aln signal reads away from any
    anchor window); SV-region-focused reads keep >25% of rows active
    and the budget correctly never engages."""
    import numpy as np

    from pansvr_tpu.align.engine import AlignEngine, EngineConfig
    from pansvr_tpu.align.host_align import OriResult

    ds = make_dataset(
        seed=41, n_sv=5, n_pairs=2200, types=("DEL", "INS"),
        chrom_lengths={"chr1": 300_000}, err_rate=0.02,
        sv_region_reads=False,
    )
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=11)
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    oris = [OriResult(unmapped=True)] * len(seqs)

    cfg_on = EngineConfig()
    cfg_on.compact_div = 8
    cfg_off = EngineConfig()
    cfg_off.compact_div = 1
    eng_on = AlignEngine(idx, config=cfg_on, ori_chrom_names=list(ds.genome))
    eng_off = AlignEngine(idx, config=cfg_off,
                          ori_chrom_names=list(ds.genome))
    B = 512
    for b0 in range(0, len(seqs), B):
        sa = eng_on.align_batch(seqs[b0 : b0 + B], oris[b0 : b0 + B])
        sb = eng_off.align_batch(seqs[b0 : b0 + B], oris[b0 : b0 + B])
        for a, b in zip(sa, sb):
            ra = [(r.align_score, r.chain_score, r.ref_bg, r.read_bg,
                   r.direction, r.sv_id, r.mapq, r.cigar)
                  for r in a.results]
            rb = [(r.align_score, r.chain_score, r.ref_bg, r.read_bg,
                   r.direction, r.sv_id, r.mapq, r.cigar)
                  for r in b.results]
            assert ra == rb
    # the peak-based budget must have engaged (compaction actually ran)
    assert eng_on._comp_cap > 0, "compaction never engaged"
    assert eng_off._comp_cap == 0


def test_device_collect_matches_host_collect(world):
    """collect='device' (ops/collect.select_and_paths + path-mode glue)
    produces identical results to collect='host' (C++ pre-chasing on the
    shipped chain tensors) — the round-5 link-diet path."""
    from pansvr_tpu.align import native_glue

    assert native_glue.get_lib() is not None
    ds, idx, host, _ = world
    seqs = [s for r in ds.reads[:48] for s in (r.seq1, r.seq2)]
    oris = [OriResult(unmapped=True) for _ in seqs]
    ea = AlignEngine(idx, ori_chrom_names=list(ds.genome),
                     config=EngineConfig(collect="device"))
    eb = AlignEngine(idx, ori_chrom_names=list(ds.genome),
                     config=EngineConfig(collect="host"))
    sa = ea.align_batch(seqs, oris)
    sb = eb.align_batch(seqs, oris)
    for k, (x, y) in enumerate(zip(sa, sb)):
        _cmp_states(y, x, f"read {k}")


def test_device_collect_budget_overflow_falls_back(world):
    """Reads over the NC/NP lane budgets take the exact host path and
    the engine widens collect_mult from the device-reported demand."""
    ds, idx, host, _ = world
    from pansvr_tpu.align import native_glue

    assert native_glue.get_lib() is not None
    seqs = [s for r in ds.reads[:48] for s in (r.seq1, r.seq2)]
    oris = [OriResult(unmapped=True) for _ in seqs]
    cfg = EngineConfig(collect="device")
    ea = AlignEngine(idx, ori_chrom_names=list(ds.genome), config=cfg)
    # sabotage the budgets: monkeypatch tiny NC/NP so overflow fires
    ea._collect_budgets = lambda n_pad: (8, 16)
    sa = ea.align_batch(seqs, oris)
    assert cfg.collect_mult > 1  # grew from the reported demand
    eb = AlignEngine(idx, ori_chrom_names=list(ds.genome),
                     config=EngineConfig(collect="host"))
    sb = eb.align_batch(seqs, oris)
    for k, (x, y) in enumerate(zip(sa, sb)):
        _cmp_states(y, x, f"read {k}")


def test_tuning_roundtrip(tmp_path, world):
    ds, idx, host, _ = world
    cfg = EngineConfig()
    eng = AlignEngine(idx, config=cfg)
    eng.cfg.nf_mult = 40
    eng.cfg.collect_mult = 4
    eng._k_spec = 16
    p = str(tmp_path / "tune.json")
    eng.save_tuning(p)
    cfg2 = EngineConfig()
    eng2 = AlignEngine(idx, config=cfg2)
    assert eng2.load_tuning(p)
    assert (cfg2.nf_mult, cfg2.collect_mult, eng2._k_spec) == (40, 4, 16)
    assert not eng2.load_tuning(str(tmp_path / "missing.json"))
