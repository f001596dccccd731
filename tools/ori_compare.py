"""Compare our `-p` output_ori side-channel against the reference
binary's own (read_realignment.cpp:775-798 emit rules; our
align/bam_out.emit_ori_pair). Runs both fc_aln passes on the same
signal FASTQ and diffs the ori BAMs record-by-record.

Usage: JAX_PLATFORMS=cpu python tools/ori_compare.py [seed] [n_sv] [n_pairs]
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# force the CPU backend
try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

PANSVR_BIN = "/tmp/refbuild/Release/panSVR"
DEBGA_BIN = "/tmp/refbuild/deBGA_release/deBGA"


def main(seed=777, n_sv=48, n_pairs=20_000, workdir="/tmp/ori_compare"):
    from pansvr_tpu.align.bam_out import (
        emit_ori_pair, emit_pair, min_filter_score)
    from pansvr_tpu.align.engine import AlignEngine
    from pansvr_tpu.align.host_align import PEScorer
    from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.io.bam import BamHeader, BamReader, BamWriter
    from pansvr_tpu.io.fasta import Faidx, write_fasta
    from pansvr_tpu.io.vcf import VCFReader, VCFWriter, minimal_header
    from pansvr_tpu.pipeline import parse_signal_comment, read_signal_fastq
    from pansvr_tpu.signal.extract import SignalOptions, extract_signal
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam

    W = workdir
    os.makedirs(W, exist_ok=True)
    ds = make_dataset(seed=seed, n_sv=n_sv, n_pairs=n_pairs,
                      types=("DEL", "INS"),
                      chrom_lengths={"chr1": 2_000_000}, err_rate=0.001)
    write_fasta(f"{W}/genome.fa", ds.genome.items(), width=60)
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

    os.makedirs(f"{W}/idx", exist_ok=True)
    subprocess.run([DEBGA_BIN, "index", "-k", "22", f"{W}/anchors.fa",
                    f"{W}/idx/"], check=True, capture_output=True)
    subprocess.run(
        [PANSVR_BIN, "fc_aln", "-t", "1", "-o", f"{W}/ref_aln.bam",
         "-p", f"{W}/ref_ori.bam",
         f"{W}/idx/", f"{W}/signal.fq", f"{W}/header.sam"],
        check=True, capture_output=True, timeout=1800)

    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=12)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    pe = PEScorer(eng.host, max_isize=stats.max_isize or 600,
                  min_isize=stats.min_isize or 200, normal_read_len=150)
    header = BamHeader.from_sam_text(open(f"{W}/header.sam").read())
    pairs = list(read_signal_fastq(f"{W}/signal.fq"))
    filt = min_filter_score(stats.read_len or 150)
    ori_writer = BamWriter(f"{W}/our_ori.bam", header)
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
            for rec in emit_ori_pair(
                pr, states[k], states[k + 1],
                ch[k][0], ch[k][1], ch[k][2],
                ch[k + 1][1], ch[k + 1][2],
                ch[k][3], ch[k + 1][3], header, filt, header.ref_names,
            ):
                ori_writer.write(rec)
    ori_writer.close()

    def key_set(path):
        out = {}
        with BamReader(path) as rd:
            for r in rd:
                k = (r.name, r.flag, r.tid, r.pos, r.mapq,
                     tuple(r.cigar), r.seq, r.mtid, r.mpos, r.isize)
                out[k] = out.get(k, 0) + 1
        return out

    ref = key_set(f"{W}/ref_ori.bam")
    ours = key_set(f"{W}/our_ori.bam")
    only_ref = {k: n for k, n in ref.items() if ours.get(k, 0) < n}
    only_ours = {k: n for k, n in ours.items() if ref.get(k, 0) < n}
    print(f"reference ori records: {sum(ref.values())}  "
          f"ours: {sum(ours.values())}")
    print(f"records only in reference: {sum(only_ref.values())}")
    print(f"records only in ours: {sum(only_ours.values())}")
    for k in list(only_ref)[:5]:
        print("  REF-ONLY:", k[:6])
    for k in list(only_ours)[:5]:
        print("  OURS-ONLY:", k[:6])
    return only_ref, only_ours


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)
