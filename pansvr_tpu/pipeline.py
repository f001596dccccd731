"""End-to-end pipeline orchestration (panSVR_run.sh equivalent).

Stages (SURVEY.md §0): anchor-reference construction -> RdBG index ->
signal extraction -> batched device realignment -> per-SV assembly ->
VCF. Stage artifacts use the same file contracts as the reference
(anchor FASTA metadata names, signal FASTQ comments, realigned-BAM tags,
status file) so stages are independently re-runnable and interoperable.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .align.bam_out import emit_ori_pair, emit_pair, min_filter_score
from .align.engine import AlignEngine
from .align.host_align import OriResult, PEScorer
from .anchor.builder import AnchorConfig, build_anchor_contigs
from .assembly.sv_call import SVRefSequence, SvCallOptions, run_sv_calling
from .index.builder import build_index
from .io.bam import BamHeader, BamWriter
from .io.fasta import Faidx, write_fasta
from .io.vcf import VCFReader, VCFWriter
from .signal.extract import SignalOptions, SignalStats, extract_signal


@dataclass
class PipelineConfig:
    anchor: AnchorConfig = None
    signal: SignalOptions = None
    first_level_bases: int | str = "auto"
    batch_size: int = 2048
    genome_size: float | None = None
    # >1: S5 runs as N fc_sv worker subprocesses over contiguous
    # anchor-contig ranges, parts merged (panSVR_run.sh fan-out analog)
    sv_shards: int = 1

    def __post_init__(self):
        if self.anchor is None:
            self.anchor = AnchorConfig()
        if self.signal is None:
            # the reference driver runs `signal -D -U` (panSVR_run.sh:51):
            # dump every pair EXCEPT full-match proper pairs — the 7-rule
            # filter is bypassed in the production pipeline
            self.signal = SignalOptions(discard_both_full_match=True,
                                        not_using_filter=True)


def parse_signal_comment(comment: str):
    """Inverse of signal.extract._pair_comment: recover the original
    alignment info (parse_ori_mapping_rst, read_realignment.hpp:392-429)
    plus the STAT block if present."""
    fields = comment.split("_")
    ori = OriResult(
        chr_id=int(fields[0]),
        ref_bg=int(fields[1]),
        read_bg=int(fields[2]),
        align_score=int(fields[3]),
        mapq=int(fields[4]),
    )
    flags = fields[9]
    ori.direction = 0 if flags[0] == "F" else 1
    ori.unmapped = flags[1] == "Y"
    stats = None
    if "STAT" in fields:
        k = fields.index("STAT")
        stats = dict(
            read_len=int(fields[k + 1]), min_isize=int(fields[k + 2]),
            mid_isize=int(fields[k + 3]), max_isize=int(fields[k + 4]),
        )
    return ori, stats


def read_signal_fastq(path_or_fh):
    """Yield (name, seq, qual, comment) from a signal FASTQ."""
    own = isinstance(path_or_fh, str)
    fh = open(path_or_fh) if own else path_or_fh
    try:
        while True:
            h = fh.readline()
            if not h:
                break
            seq = fh.readline().strip()
            fh.readline()
            qual = fh.readline().strip()
            name, _, comment = h[1:].strip().partition(" ")
            yield name, seq, qual, comment
    finally:
        if own:
            fh.close()


def run_pipeline(sv_vcf: str, genome_fa: str, bam: str, workdir: str,
                 cfg: PipelineConfig | None = None) -> str:
    """Full run; returns the path of the final VCF. Stage walls (with
    their start/end wall-clock times) and the realignment engine's phase
    counters go to <workdir>/run_stats.json."""
    import json
    import sys
    import time as _time

    cfg = cfg or PipelineConfig()
    os.makedirs(workdir, exist_ok=True)
    genome = Faidx(genome_fa)

    _t0 = _time.time()
    _last = [_t0]
    run_stats: dict = {"stages": []}

    def _stage(msg, name):
        now = _time.time()
        print(f"[pansvr +{now - _t0:7.1f}s] {msg} "
              f"({now - _last[0]:.1f}s)", file=sys.stderr, flush=True)
        run_stats["stages"].append(
            dict(stage=name, start=_last[0], end=now, wall_s=now - _last[0]))
        _last[0] = now

    # ---- S1: anchor reference --------------------------------------------
    anchors_fa = os.path.join(workdir, "anchors.fa")
    with VCFReader(sv_vcf) as reader:
        contigs = list(build_anchor_contigs(reader, genome, cfg.anchor))
    write_fasta(anchors_fa, ((c.name, c.seq) for c in contigs), width=70)
    if not contigs:
        raise ValueError("no anchor contigs built from the input VCF")
    _stage(f"S1 anchor reference: {len(contigs)} contigs", "anchor")

    # ---- S2: index -------------------------------------------------------
    idx = build_index(
        [(c.name, c.seq) for c in contigs],
        first_level_bases=cfg.first_level_bases,
    )
    _stage(f"S2 index: {len(idx.uni_seqf) - 1} unitigs", "index")

    # ---- S3: signal extraction ------------------------------------------
    signal_fq = os.path.join(workdir, "signal.fq")
    with open(signal_fq, "w") as fh:
        # depth + isize quantiles come from the StatsManager region
        # sampling (the reference overwrites its 3.1 Gbp-normalized
        # depth with the sampled one, getSignalRead.hpp:171);
        # cfg.genome_size only changes the non-converged fallback
        pre_stats = None
        if cfg.genome_size:
            from .signal.extract import compute_stats

            pre_stats = compute_stats(bam, genome_size=cfg.genome_size)
        stats = extract_signal(bam, fh, stats=pre_stats, opts=cfg.signal)
    with open(os.path.join(workdir, "status.txt"), "w") as fh:
        fh.write(stats.status_file_text())
    _stage("S3 signal extraction", "signal")

    # ---- S4: realignment -------------------------------------------------
    from .io.bam import BamReader

    with BamReader(bam) as rd:
        ori_names = list(rd.header.ref_names)
        ori_lens = list(rd.header.ref_lens)
    eng = AlignEngine(idx, ori_chrom_names=ori_names)
    pe = PEScorer(
        eng.host,
        max_isize=stats.max_isize or 600,
        min_isize=stats.min_isize or 200,
        normal_read_len=stats.read_len or 150,
    )
    header = BamHeader.from_sam_text(
        "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ori_names, ori_lens)
        )
    )
    realigned_bam = os.path.join(workdir, "realigned.bam")
    ori_bam = os.path.join(workdir, "output_ori.bam")
    filt = min_filter_score(stats.read_len or 150)
    writer = BamWriter(realigned_bam, header)
    ori_writer = BamWriter(ori_bam, header)
    B = cfg.batch_size
    n_emitted = 0
    n_reads = 0
    step = 2 * (B // 2)

    def chunk_stream():
        """Stream the signal FASTQ in engine-batch chunks (the 2M-pair
        pipeline-block analog, read_realignment.cpp:22-24,109): memory
        stays O(batch), not O(file). A trailing unpaired record is
        dropped exactly like the reference's paired kseq loop."""
        buf = []
        for rec in read_signal_fastq(signal_fq):
            buf.append(rec)
            if len(buf) == step:
                yield buf
                buf = []
        if len(buf) >= 2:
            yield buf[: len(buf) // 2 * 2]

    import itertools
    chunks_a, chunks_b = itertools.tee(chunk_stream())

    def batch_stream():
        for chunk in chunks_b:
            yield ([p[1] for p in chunk],
                   [parse_signal_comment(p[3])[0] for p in chunk])

    for chunk, states in zip(chunks_a, eng.align_stream(batch_stream())):
        n_reads += len(chunk)
        for k in range(0, len(chunk) - 1, 2):
            st1, st2 = states[k], states[k + 1]
            pr = pe.pair(st1, st2)
            for rec in emit_ori_pair(
                pr, st1, st2,
                chunk[k][0], chunk[k][1], chunk[k][2],
                chunk[k + 1][1], chunk[k + 1][2],
                chunk[k][3], chunk[k + 1][3], header, filt, ori_names,
            ):
                ori_writer.write(rec)
            if not pr.gain_better:
                continue
            pe_recs = emit_pair(
                eng.host, pr, st1, st2,
                chunk[k][0], chunk[k][1], chunk[k][2],
                chunk[k + 1][1], chunk[k + 1][2],
                chunk[k][3], chunk[k + 1][3], header,
            )
            for rec in pe_recs:
                writer.write(rec)
                n_emitted += 1
    writer.close()
    ori_writer.close()
    _stage(f"S4 realignment: {n_reads} reads, {n_emitted} records emitted",
           "fc_aln")
    run_stats["fc_aln"] = dict(reads=n_reads, records=n_emitted,
                               batch=B, engine=dict(eng.prof))

    def _write_stats():
        with open(os.path.join(workdir, "run_stats.json"), "w") as fh:
            json.dump(run_stats, fh, indent=1)

    # ---- S5: SV calling --------------------------------------------------
    out_vcf = os.path.join(workdir, "result.vcf")
    if cfg.sv_shards > 1:
        from .parallel.fanout import run_sv_fanout

        run_sv_fanout(
            anchors_fa, realigned_bam, genome_fa, out_vcf,
            n_shards=cfg.sv_shards,
            status_file=os.path.join(workdir, "status.txt"),
            edge_len=cfg.anchor.edge_len,
        )
        _stage("S5 SV calling (fan-out)", "fc_sv")
        _write_stats()
        return out_vcf
    sf = SVRefSequence(
        [c.name for c in contigs],
        {c.name: c.seq for c in contigs},
        genome,
        ori_names,
    )
    opts = SvCallOptions(
        edge_len=cfg.anchor.edge_len,
        normal_read_len=stats.read_len or 150,
        ave_read_depth=max(stats.ave_read_depth, 1.0),
    )
    verdicts, vcf_records = run_sv_calling(realigned_bam, sf, opts)

    header_lines = (
        ["##fileformat=VCFv4.2", "##source=pansvr_tpu"]
        + [f"##contig=<ID={n},length={l}>" for n, l in zip(ori_names, ori_lens)]
        + ["##INFO=<ID=SVTYPE,Number=1,Type=String,Description=\"Type of structural variant\">",
           "##INFO=<ID=END,Number=1,Type=Integer,Description=\"End position\">",
           "##INFO=<ID=SVLEN,Number=1,Type=Integer,Description=\"SV length\">",
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample"]
    )
    w = VCFWriter(out_vcf, header_lines)
    for rec in vcf_records:
        w.write(rec)
    w.close()
    _stage(f"S5 SV calling: {len(vcf_records)} records", "fc_sv")
    _write_stats()
    return out_vcf
