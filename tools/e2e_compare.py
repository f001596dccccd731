"""End-to-end final-VCF comparison vs the reference binaries.

Builds a simulated world, runs the REFERENCE pipeline (deBGA index +
fc_aln + fc_sv binaries from tools/build_reference.sh) and OUR pipeline
(device engine + run_sv_calling) on the same signal reads, then matches
the two call sets with the tolerance comparator (io/vcf_compare) and
prints per-class counts plus every MISSED/EXTRA call with nearby-call
context — the parity-hunt harness VERDICT round 1 item 8 asked for.

Usage: JAX_PLATFORMS=cpu python tools/e2e_compare.py [seed] [n_sv] [n_pairs]
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# force the CPU backend so the comparison never depends on a device
try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

PANSVR_BIN = "/tmp/refbuild/Release/panSVR"
DEBGA_BIN = "/tmp/refbuild/deBGA_release/deBGA"


def main(seed=777, n_sv=64, n_pairs=25_000, workdir="/tmp/e2e_compare"):
    import numpy as np

    from pansvr_tpu.align.bam_out import emit_pair
    from pansvr_tpu.align.engine import AlignEngine
    from pansvr_tpu.align.host_align import PEScorer
    from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu.assembly.sv_call import (
        SVRefSequence, SvCallOptions, run_sv_calling)
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.io.bai import build_bai, sort_bam
    from pansvr_tpu.io.bam import BamHeader, BamWriter
    from pansvr_tpu.io.fasta import Faidx, write_fasta
    from pansvr_tpu.io.vcf import VCFReader, VCFWriter, minimal_header, parse_vcf_line
    from pansvr_tpu.io.vcf_compare import SVCall, compare_calls
    from pansvr_tpu.pipeline import parse_signal_comment, read_signal_fastq
    from pansvr_tpu.signal.extract import SignalOptions, extract_signal
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam

    W = workdir
    os.makedirs(W, exist_ok=True)
    ds = make_dataset(seed=seed, n_sv=n_sv, n_pairs=n_pairs,
                      types=("DEL", "INS"),
                      chrom_lengths={"chr1": 2_000_000}, err_rate=0.001)
    write_fasta(f"{W}/genome.fa", ds.genome.items(), width=60)
    for stale in (f"{W}/genome.fa.fai",):
        if os.path.exists(stale):
            os.unlink(stale)
    w = VCFWriter(f"{W}/svs.vcf",
                  minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    write_sim_bam(ds, f"{W}/sim.bam")
    with open(f"{W}/anchors.fa", "w") as fh:
        with VCFReader(f"{W}/svs.vcf") as rd:
            contigs = list(build_anchor_contigs(
                rd, Faidx(f"{W}/genome.fa"), AnchorConfig()))
        write_fasta(fh, ((c.name, c.seq) for c in contigs), width=70)
    with open(f"{W}/signal.fq", "w") as fh:
        stats = extract_signal(f"{W}/sim.bam", fh, opts=SignalOptions(
            discard_both_full_match=False, not_using_filter=True))
    with open(f"{W}/header.sam", "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c, s in ds.genome.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{len(s)}\n")

    # ---- reference pipeline ---------------------------------------------
    os.makedirs(f"{W}/idx", exist_ok=True)
    subprocess.run([DEBGA_BIN, "index", "-k", "22", f"{W}/anchors.fa",
                    f"{W}/idx/"], check=True, capture_output=True)
    subprocess.run(
        [PANSVR_BIN, "fc_aln", "-t", "8", "-o", f"{W}/ref_aln.bam",
         f"{W}/idx/", f"{W}/signal.fq", f"{W}/header.sam"],
        check=True, capture_output=True, timeout=1800)
    sort_bam(f"{W}/ref_aln.bam", f"{W}/ref_sorted.bam")
    build_bai(f"{W}/ref_sorted.bam")
    subprocess.run(
        [PANSVR_BIN, "fc_sv", "-o", f"{W}/ref_result.vcf", f"{W}/idx/",
         f"{W}/ref_sorted.bam", f"{W}/header.sam", f"{W}/genome.fa"],
        capture_output=True, timeout=1800)
    ref_calls = []
    for l in open(f"{W}/ref_result.vcf"):
        if l.startswith("#") or l.count("\t") < 7:
            continue
        r = parse_vcf_line(l)
        svt = r.info.get("SVTYPE", "?")
        svlen = int(str(r.info.get("SVLEN", "0")).split(",")[0] or 0)
        ref_calls.append(SVCall(chrom=r.chrom, pos1=r.pos1, sv_type=svt,
                                svlen=svlen, end=r.pos1 + abs(svlen),
                                filter=r.filter, rec=r))
    print(f"reference calls: {len(ref_calls)}")

    # ---- our pipeline ----------------------------------------------------
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=12)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    pe = PEScorer(eng.host, max_isize=stats.max_isize or 600,
                  min_isize=stats.min_isize or 200, normal_read_len=150)
    header = BamHeader.from_sam_text(open(f"{W}/header.sam").read())
    pairs = list(read_signal_fastq(f"{W}/signal.fq"))
    writer = BamWriter(f"{W}/our_realigned.bam", header)
    chunksz = 4096
    chunks = [pairs[i : i + chunksz]
              for i in range(0, len(pairs) - 1, chunksz)]

    def stream():
        for ch in chunks:
            yield ([p[1] for p in ch],
                   [parse_signal_comment(p[3])[0] for p in ch])

    for ch, states in zip(chunks, eng.align_stream(stream())):
        for k in range(0, len(ch) - 1, 2):
            pr = pe.pair(states[k], states[k + 1])
            if not pr.gain_better:
                continue
            for rec in emit_pair(eng.host, pr, states[k], states[k + 1],
                                 ch[k][0], ch[k][1], ch[k][2],
                                 ch[k + 1][1], ch[k + 1][2],
                                 ch[k][3], ch[k + 1][3], header):
                writer.write(rec)
    writer.close()
    sf = SVRefSequence([c.name for c in contigs],
                       {c.name: c.seq for c in contigs},
                       Faidx(f"{W}/genome.fa"), list(ds.genome))
    _, recs = run_sv_calling(
        f"{W}/our_realigned.bam", sf,
        SvCallOptions(ave_read_depth=max(stats.ave_read_depth, 1.0),
                      normal_read_len=150))
    our_calls = [
        SVCall(chrom=r.chrom, pos1=r.pos1, sv_type=r.sv_type,
               svlen=r.sv_len if r.sv_type != "DEL" else -abs(r.sv_len),
               end=r.pos1 + abs(r.sv_len), filter=r.filter)
        for r in recs
    ]
    print(f"our calls: {len(our_calls)}")

    # ---- compare ---------------------------------------------------------
    for c in ref_calls:
        c.svlen = -abs(c.svlen) if c.sv_type == "DEL" else abs(c.svlen)
    res = compare_calls(ref_calls, our_calls, pos_tol=20, min_size_sim=0.9)
    for line in res.summary_lines():
        print(line)
    # context for each miss: the nearest our-call of any type
    for m in res.missed:
        near = sorted(
            our_calls, key=lambda c: (c.chrom != m.chrom,
                                      abs(c.pos1 - m.pos1)))[:2]
        print(f"  MISSED {m.key()} filter={m.filter}; nearest ours: "
              + ", ".join(f"{c.key()}[{c.filter}]" for c in near))
    for m in res.matches:
        if m.cls != "EXACT":
            print(f"  {m.cls}: ref {m.truth.key()} ~ ours {m.query.key()}")
    return res


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)
