"""Full pipeline end-to-end: simulated genome + SVs + reads -> final VCF.

The round-1 north-star slice: planted deletions and insertions must come
back as PASS records at (near) the planted positions."""

import os

import numpy as np
import pytest

from pansvr_tpu.io.fasta import write_fasta
from pansvr_tpu.io.vcf import VCFReader, VCFWriter, minimal_header
from pansvr_tpu.pipeline import PipelineConfig, run_pipeline
from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam


@pytest.fixture(scope="module")
def pipeline_result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    ds = make_dataset(
        seed=77, n_sv=4, n_pairs=1600, types=("DEL", "INS"),
        chrom_lengths={"chr1": 200_000}, err_rate=0.0,
    )
    genome_fa = str(tmp / "genome.fa")
    write_fasta(genome_fa, ds.genome.items(), width=60)
    vcf = str(tmp / "svs.vcf")
    w = VCFWriter(vcf, minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    bam = str(tmp / "sim.bam")
    write_sim_bam(ds, bam)

    out_vcf = run_pipeline(
        vcf, genome_fa, bam, str(tmp / "work"),
        PipelineConfig(first_level_bases=11),
    )
    with VCFReader(out_vcf) as rd:
        records = list(rd)
    return ds, records, str(tmp / "work")


def test_pipeline_produces_calls(pipeline_result):
    ds, records, work = pipeline_result
    assert len(records) >= 1, "pipeline produced no VCF records"
    # intermediate artifacts exist (stage file contracts)
    for f in ("anchors.fa", "signal.fq", "status.txt", "realigned.bam"):
        assert os.path.exists(os.path.join(work, f))


def test_planted_svs_recovered(pipeline_result):
    ds, records, work = pipeline_result
    hits = 0
    for sv in ds.svs:
        for rec in records:
            if (
                rec.chrom == sv.chrom
                and abs(rec.pos1 - sv.pos1) <= 40
                and rec.sv_type == sv.sv_type
            ):
                hits += 1
                break
    # with clean 30x-ish simulated data most planted SVs must come back
    assert hits >= len(ds.svs) * 0.5, (
        f"only {hits}/{len(ds.svs)} planted SVs recovered: "
        f"{[(r.chrom, r.pos1, r.sv_type, r.filter) for r in records]}"
    )


def test_sv_lengths_reasonable(pipeline_result):
    ds, records, work = pipeline_result
    for rec in records:
        if rec.sv_type == "DEL":
            assert len(rec.ref) > len(rec.alts[0])
        elif rec.sv_type == "INS":
            assert len(rec.alts[0]) > len(rec.ref)


@pytest.fixture(scope="module")
def hidden_sv_world(tmp_path_factory):
    """World where half the planted SVs are HIDDEN from the input VCF:
    their reads can't be explained by the anchor pan-genome, so they land
    in the -p original-alignment side-channel (de novo caller input)."""
    tmp = tmp_path_factory.mktemp("hidden")
    ds = make_dataset(
        seed=78, n_sv=6, n_pairs=1600, types=("DEL", "INS"),
        chrom_lengths={"chr1": 250_000}, err_rate=0.0,
    )
    write_fasta(str(tmp / "g.fa"), ds.genome.items(), width=60)
    w = VCFWriter(str(tmp / "s.vcf"),
                  minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records[: len(ds.vcf_records) // 2]:
        w.write(r)
    w.close()
    write_sim_bam(ds, str(tmp / "sim.bam"))
    run_pipeline(
        str(tmp / "s.vcf"), str(tmp / "g.fa"), str(tmp / "sim.bam"),
        str(tmp / "work"),
        PipelineConfig(first_level_bases=11),
    )
    hidden = ds.vcf_records[len(ds.vcf_records) // 2 :]
    return ds, hidden, str(tmp)


def test_output_ori_side_channel(hidden_sv_world):
    """-p side-channel: pairs unexplained by either reference get their
    ORIGINAL alignments written (read_realignment.cpp:775-798): whole
    pairs, original soft-clipped CIGARs, MS pair-score tag."""
    from pansvr_tpu.io.bam import BamReader

    ds, hidden, tmp = hidden_sv_world
    with BamReader(os.path.join(tmp, "work", "output_ori.bam")) as rd:
        names = list(rd.header.ref_names)
        recs = list(rd)
    assert set(names) == set(ds.genome)
    assert len(recs) > 0, "hidden SVs must leave unexplained pairs"
    mapped = [r for r in recs if not (r.flag & 4)]
    assert mapped, "originally-mapped unexplained reads expected"
    assert any(op == "S" for r in mapped for op, _ in r.cigar), \
        "breakpoint reads should keep their original soft-clipped CIGARs"
    for r in recs:
        assert r.get_tag("MS") is not None
    pairs = {}
    for r in recs:
        pairs.setdefault(r.name, []).append(r)
    for name, rs in pairs.items():
        assert len(rs) == 2, f"{name}: side-channel must emit whole pairs"


def test_denovo_recovers_hidden_svs(hidden_sv_world):
    """Full reference workflow: fc_aln -p side-channel -> sv_calling must
    recover SVs that were absent from the input VCF (panSVR_run.sh's
    NovaSV stage on output_ori.bam)."""
    from pansvr_tpu.assembly.denovo import DeNovoCaller, DeNovoOptions
    from pansvr_tpu.io.bai import sort_bam
    from pansvr_tpu.io.fasta import Faidx

    ds, hidden, tmp = hidden_sv_world
    sort_bam(os.path.join(tmp, "work", "output_ori.bam"),
             os.path.join(tmp, "work", "ori_sorted.bam"))
    caller = DeNovoCaller(Faidx(os.path.join(tmp, "g.fa")),
                          DeNovoOptions(min_support=3))
    recs = caller.call_bam(os.path.join(tmp, "work", "ori_sorted.bam"))
    assert recs, "no de novo calls from the side-channel BAM"
    n_hit = 0
    for h in hidden:
        if any(r.chrom == h.chrom and abs(r.pos1 - h.pos1) <= 20 for r in recs):
            n_hit += 1
    # two-sided clip assembly resolves long INS (possibly IMPRECISE);
    # every hidden SV must come back at the right position
    assert n_hit == len(hidden), f"recovered {n_hit}/{len(hidden)}"


def test_sv_calling_device_dp_matches_inline(pipeline_result):
    """ContigDpBatcher device path (batched scan DP) must yield the same
    verdicts/VCF records as the inline scalar-DP path."""
    from pansvr_tpu.assembly.sv_call import (
        ContigDpBatcher,
        SVRefSequence,
        SvCallOptions,
        run_sv_calling,
    )
    from pansvr_tpu.io.fasta import Faidx, read_fasta

    ds, records, work = pipeline_result
    bam = os.path.join(work, "realigned.bam")
    anchors = os.path.join(work, "anchors.fa")
    genome_fa = os.path.join(work, "..", "genome.fa")
    seqs = read_fasta(anchors)
    names = list(seqs)

    def fresh_sf():
        return SVRefSequence(names, seqs, Faidx(genome_fa),
                             list(ds.genome))

    opts = SvCallOptions()
    _, vcf_inline = run_sv_calling(bam, fresh_sf(), opts)
    _, vcf_device = run_sv_calling(
        bam, fresh_sf(), opts,
        dp=ContigDpBatcher(device=True),
    )
    assert len(vcf_inline) == len(vcf_device)
    for a, b in zip(vcf_inline, vcf_device):
        assert (a.chrom, a.pos1, a.ref, a.alts, a.info) == \
            (b.chrom, b.pos1, b.ref, b.alts, b.info)


def test_sv_detail_channels(pipeline_result, capsys):
    """-D/-d stderr renderings (the reference's de facto debug channel,
    SignalAssembly.cpp:200-223): pileup lines + event-matrix dumps."""
    import io

    from pansvr_tpu.assembly.sv_call import (
        SVRefSequence, SvCallOptions, SvCaller, SvReadIndex,
    )
    from pansvr_tpu.io.fasta import Faidx, read_fasta

    ds, records, work = pipeline_result
    bam = os.path.join(work, "realigned.bam")
    seqs = read_fasta(os.path.join(work, "anchors.fa"))
    sf = SVRefSequence(list(seqs), seqs,
                       Faidx(os.path.join(work, "..", "genome.fa")),
                       list(ds.genome))
    out = io.StringIO()
    opts = SvCallOptions(print_detail=True, depth_detail=True)
    caller = SvCaller(sf, opts, detail_out=out)
    idx = SvReadIndex(bam, sf.sv_info)
    sv_id = idx.sv_ids()[0]
    plan = caller.plan_sv(sv_id, idx.get(sv_id))
    caller.dp.run()
    caller.finish_sv(plan)
    text = out.getvalue()
    assert "read pileup" in text and "event matrix" in text
    assert any(line.startswith("-") for line in text.splitlines())
    idx.close()
