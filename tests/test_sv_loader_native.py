"""Native fc_sv record loader (glue_sv_load: tags + cigar_adjust + seq
decode in C++) vs the Python path: identical LoadedReads per SV."""

import numpy as np
import pytest

from pansvr_tpu.align import native_glue


def test_native_sv_loader_matches_python(tmp_path):
    import os

    from pansvr_tpu.assembly.sv_call import SvReadIndex, SVRefSequence
    from pansvr_tpu.io.fasta import Faidx, write_fasta
    from pansvr_tpu.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu.pipeline import PipelineConfig, run_pipeline
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam

    ds = make_dataset(seed=91, n_sv=5, n_pairs=1600, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 220_000}, err_rate=0.002)
    genome_fa = str(tmp_path / "genome.fa")
    write_fasta(genome_fa, ds.genome.items(), width=60)
    vcf = str(tmp_path / "svs.vcf")
    w = VCFWriter(vcf, minimal_header(
        [(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    bam = str(tmp_path / "sim.bam")
    write_sim_bam(ds, bam)
    work = str(tmp_path / "work")
    run_pipeline(vcf, genome_fa, bam, work,
                 PipelineConfig(first_level_bases=11))
    realigned = os.path.join(work, "realigned.bam")

    from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu.io.vcf import VCFReader

    with VCFReader(vcf) as rd:
        contigs = list(build_anchor_contigs(rd, Faidx(genome_fa),
                                            AnchorConfig()))
    sf = SVRefSequence([c.name for c in contigs],
                       {c.name: c.seq for c in contigs},
                       Faidx(genome_fa), list(ds.genome))

    ld_n = SvReadIndex(realigned, sf.sv_info)
    ld_p = SvReadIndex(realigned, sf.sv_info)
    ld_p._lib = None  # force the Python path
    ld_p.spans = {}
    from pansvr_tpu.io.bam import BamReaderOffsets
    rd2 = BamReaderOffsets(realigned)
    for uoff, ln, rec in rd2.iter_with_spans():
        if (rec.get_tag("AS") or 0) < ld_p.min_score:
            continue
        if rec.get_tag("SV") is None:
            continue
        if rec.get_tag("CS") is None and rec.isize == 0:
            continue
        sv_id = int(str(rec.get_tag("SV")).split("_")[0])
        if sv_id >= len(sf.sv_info):
            continue
        ld_p.spans.setdefault(sv_id, []).append((uoff, ln))
    rd2.close()

    assert ld_n.spans == ld_p.spans, "index pass differs"
    assert ld_n.sv_ids(), "no reads indexed"
    for sv_id in ld_n.sv_ids():
        a = ld_n.get(sv_id)
        b = ld_p.get(sv_id)
        assert len(a) == len(b), f"SV {sv_id}: count"
        for x, y in zip(a, b):
            assert (x.pos, x.cigar, x.seq, x.mapq, x.score, x.ori_score,
                    x.has_cs, x.ori_unmapped, x.xa_num, x.rc_mapq,
                    x.rc_chr_id) == \
                   (y.pos, y.cigar, y.seq, y.mapq, y.score, y.ori_score,
                    y.has_cs, y.ori_unmapped, y.xa_num, y.rc_mapq,
                    y.rc_chr_id), f"SV {sv_id} read differs"
    ld_n.close()
    ld_p.close()
