"""Command-line interface mirroring the reference's subcommand surface
(src/main.cpp:47-80): fc_anchor_ref, fc_index, fc_signal, fc_aln, fc_sv,
assembly_test, tools, plus `run` (the panSVR_run.sh equivalent driving
all stages) and `bench`.

Usage: python -m pansvr_tpu <command> [options]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _fl_arg(v: str):
    """--first-level: an int, or 'auto' (size the 4^fl bucket table to
    the k-mer population; see index.builder.resolve_first_level)."""
    return v if v == "auto" else int(v)


def _cmd_fc_anchor_ref(args):
    from ..anchor.builder import AnchorConfig, run_anchor_ref
    from ..io.fasta import Faidx

    cfg = AnchorConfig(
        edge_len=args.edge_len, min_sv_len=args.min_sv_len,
        sv_type=args.sv_type, discard_decoy=args.discard_decoy,
    )
    run_anchor_ref(args.vcf, Faidx(args.ref), sys.stdout, cfg)


def _cmd_fc_index(args):
    from ..index.builder import build_index
    from ..index.store import save_index
    from ..io.fasta import read_fasta

    idx = build_index(
        list(read_fasta(args.anchors_fa).items()),
        first_level_bases=args.first_level,
    )
    save_index(idx, args.index_dir)
    print(
        f"index: {len(idx.chr_names)} contigs, {idx.n_kmers} kmers, "
        f"{idx.n_unitigs} unitigs -> {args.index_dir}", file=sys.stderr,
    )


def _cmd_fc_signal(args):
    from ..signal.extract import SignalOptions, extract_signal

    opts = SignalOptions(
        discard_both_full_match=args.discard_full_match,
        not_using_filter=args.not_use_filter,
    )
    ref = None
    if args.ref:
        from ..io.fasta import Faidx
        ref = Faidx(args.ref)
    out = open(args.output, "w") if args.output != "-" else sys.stdout
    stats = extract_signal(args.bam, out, opts=opts, ref=ref)
    if args.status_file:
        with open(args.status_file, "w") as fh:
            fh.write(stats.status_file_text())


def _cmd_fc_aln(args):
    from ..align.bam_out import emit_ori_pair, emit_pair, min_filter_score
    from ..align.engine import AlignEngine
    from ..align.host_align import PEScorer
    from ..io.bam import BamHeader, BamWriter
    from ..pipeline import parse_signal_comment, read_signal_fastq
    from ..signal.extract import SignalStats

    from ..index.store import load_any

    # store dir (mmap'd flat arrays), legacy rdbg.pkl, or a deBGA dir —
    # the mmap load keeps host RSS ~O(touched pages), not O(index)
    idx = load_any(args.index_dir)
    header = BamHeader.from_sam_text(open(args.header_sam).read())
    stats = SignalStats.parse_status_text(open(args.status_file).read()) \
        if args.status_file else SignalStats(read_len=150, min_isize=200, max_isize=600)

    eng = AlignEngine(idx, ori_chrom_names=header.ref_names)
    # persisted lane-budget tuning: the converged shapes of a previous
    # run on this index start the engine at the right compiles at once
    tune_path = os.path.join(args.index_dir, "engine_tune.json") \
        if os.path.isdir(args.index_dir) else None
    if tune_path:
        eng.load_tuning(tune_path)
    pe = PEScorer(eng.host, stats.max_isize or 600, stats.min_isize or 200,
                  stats.read_len or 150)
    writer = BamWriter(args.output, header)
    ori_writer = BamWriter(args.output_ori, header) if args.output_ori else None
    filt = min_filter_score(stats.read_len or 150)
    B = args.batch
    step = 2 * (B // 2)

    def chunk_stream():
        """Stream the signal FASTQ in engine-batch chunks (the 2M-pair
        pipeline-block analog, read_realignment.cpp:22-24,109): memory
        stays O(batch). A trailing unpaired record is dropped exactly
        like the reference's paired kseq loop."""
        buf = []
        for rec in read_signal_fastq(args.signal_fq):
            buf.append(rec)
            if len(buf) == step:
                yield buf
                buf = []
        if len(buf) >= 2:
            yield buf[: len(buf) // 2 * 2]

    import contextlib
    import itertools

    # native emit: the whole PE-pair + record-encode tail runs in C++
    # (glue_pe_emit) and the stream yields encoded blobs — unless the
    # -p ori side-channel needs Python states, or the glue isn't built
    use_native_emit = ori_writer is None and not os.environ.get(
        "PANSVR_NO_NATIVE_EMIT")
    if use_native_emit:
        from ..align import native_glue
        use_native_emit = native_glue.available()
    if use_native_emit:
        from ..align.bam_out import EmitContext

        eng.set_native_emit(EmitContext(
            eng.host, header, stats.max_isize or 600,
            stats.min_isize or 200, stats.read_len or 150))
        chunks_a = iter(())

        def batch_stream():
            for chunk in chunk_stream():
                comments = [p[3] for p in chunk]
                oris = native_glue.parse_comments(comments)
                if oris is None:
                    oris = [parse_signal_comment(c)[0] for c in comments]
                yield ([p[1] for p in chunk], oris,
                       ([p[0] for p in chunk], [p[2] for p in chunk],
                        comments))
    else:
        chunks_a, chunks_b = itertools.tee(chunk_stream())

        def batch_stream():
            for chunk in chunks_b:
                yield ([p[1] for p in chunk],
                       [parse_signal_comment(p[3])[0] for p in chunk])

    # --trace DIR: structured device profiling (xplane/perfetto) around
    # the whole realignment stream — the device analog of the reference's
    # cputime() stage timers (read_realignment.cpp:71-73,105)
    tracer = contextlib.nullcontext()
    if getattr(args, "trace", None):
        import jax

        tracer = jax.profiler.trace(args.trace)
    with tracer:
        _run_aln_stream(chunks_a, eng, pe, writer, ori_writer, header,
                        filt, batch_stream)
    if tune_path:
        try:
            eng.save_tuning(tune_path)
        except OSError:
            pass
    if getattr(args, "trace", None):
        phases = {k: round(v, 3) for k, v in eng.prof.items()
                  if isinstance(v, float)}
        print(f"[fc_aln] engine phases (s): {phases}", file=sys.stderr)


def _run_aln_stream(chunks_a, eng, pe, writer, ori_writer, header, filt,
                    batch_stream):
    """Consume align_stream batches, PE-score and write BAM records.

    Emission runs on a single writer thread pipelined one batch behind
    the engine (the reference's kt_pipeline step2 analog,
    read_realignment.cpp:165-176): the Python emit work overlaps the
    engine's GIL-released device waits, and single-thread writes keep
    BAM record order deterministic.

    With native emit enabled on the engine, align_stream yields encoded
    record blobs straight from C++ (byte-identical to this path,
    tests/test_native_emit.py) and only the BGZF write remains here."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..align.bam_out import emit_ori_pair, emit_pair

    if getattr(eng, "_emit_ctx", None) is not None and ori_writer is None:
        for blob in eng.align_stream(batch_stream()):
            writer.write_blob(blob)
        writer.close()
        return

    def emit_chunk(chunk, states):
        for k in range(0, len(chunk) - 1, 2):
            pr = pe.pair(states[k], states[k + 1])
            if ori_writer is not None:
                for rec in emit_ori_pair(
                    pr, states[k], states[k + 1],
                    chunk[k][0], chunk[k][1], chunk[k][2],
                    chunk[k + 1][1], chunk[k + 1][2],
                    chunk[k][3], chunk[k + 1][3], header, filt,
                    header.ref_names,
                ):
                    ori_writer.write(rec)
            if not pr.gain_better:
                continue
            for rec in emit_pair(
                eng.host, pr, states[k], states[k + 1],
                chunk[k][0], chunk[k][1], chunk[k][2],
                chunk[k + 1][1], chunk[k + 1][2],
                chunk[k][3], chunk[k + 1][3], header,
            ):
                writer.write(rec)

    pool = ThreadPoolExecutor(1)
    futs: deque = deque()
    try:
        for chunk, states in zip(chunks_a, eng.align_stream(batch_stream())):
            futs.append(pool.submit(emit_chunk, chunk, states))
            while len(futs) > 2:
                futs.popleft().result()
        while futs:
            futs.popleft().result()
    finally:
        pool.shutdown(wait=True)
    writer.close()
    if ori_writer is not None:
        ori_writer.close()


def _cmd_fc_sv(args):
    from ..assembly.sv_call import SVRefSequence, SvCallOptions, run_sv_calling
    from ..io.bam import BamReader
    from ..io.fasta import Faidx, read_fasta
    from ..io.vcf import VCFWriter
    from ..signal.extract import SignalStats

    anchors = read_fasta(args.anchors_fa)
    with BamReader(args.bam) as rd:
        ori_names = list(rd.header.ref_names)
    stats = SignalStats.parse_status_text(open(args.status_file).read()) \
        if args.status_file else SignalStats(read_len=150, ave_read_depth=30.0)
    sf = SVRefSequence(list(anchors.keys()), anchors, Faidx(args.ref), ori_names)
    opts = SvCallOptions(
        edge_len=args.edge_len,
        normal_read_len=stats.read_len or 150,
        ave_read_depth=max(stats.ave_read_depth, 1.0),
        st_chr=args.st_chr, ed_chr=args.ed_chr,
        print_detail=args.print_detail, depth_detail=args.depth_detail,
    )
    verdicts, records = run_sv_calling(args.bam, sf, opts)
    out = open(args.output, "w") if args.output != "-" else sys.stdout
    out.write("##fileformat=VCFv4.2\n##source=pansvr_tpu\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample\n")
    for rec in records:
        out.write(rec.to_line() + "\n")
    n_pass = sum(1 for v in verdicts if v.passed)
    print(f"{n_pass}/{len(verdicts)} SV regions PASS", file=sys.stderr)


def _cmd_run(args):
    from ..pipeline import PipelineConfig, run_pipeline

    out = run_pipeline(args.vcf, args.ref, args.bam, args.workdir,
                       PipelineConfig(first_level_bases=args.first_level,
                                      batch_size=args.batch,
                                      sv_shards=args.sv_shards))
    print(out)


def _cmd_assembly_test(args):
    from ..assembly.assembler import AssemblyManager

    am = AssemblyManager()
    for line in sys.stdin:
        seq = line.strip()
        if seq:
            am.add_read(seq)
    for c in am.assemble():
        print(
            f"CONTIG size: [{len(c.seq)}] seedCount: [{c.seed_read_count}] "
            f"supportReads: [{len(c.support_reads)}] "
            f"ending_reason: [{c.ending_reason[0]} {c.ending_reason[1]}]"
        )
        print(c.seq)


def _cmd_sv_calling(args):
    from ..assembly.denovo import DeNovoCaller, DeNovoOptions
    from ..io.fasta import Faidx

    caller = DeNovoCaller(
        Faidx(args.ref),
        DeNovoOptions(min_support=args.min_support),
    )
    records = caller.call_bam(args.bam)
    out = open(args.output, "w") if args.output != "-" else sys.stdout
    out.write("##fileformat=VCFv4.2\n##source=pansvr_tpu-denovo\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample\n")
    for rec in records:
        out.write(rec.to_line() + "\n")
    print(f"{len(records)} de novo SV calls", file=sys.stderr)


def _cmd_tools(args):
    from . import tools

    tools.dispatch(args.tool, args.tool_args)


def main(argv=None):
    p = argparse.ArgumentParser(prog="pansvr_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("fc_anchor_ref", help="VCF+ref -> anchor FASTA (stdout)")
    s.add_argument("ref")
    s.add_argument("vcf")
    s.add_argument("-e", "--edge-len", type=int, default=500)
    s.add_argument("-m", "--min-sv-len", type=int, default=50)
    s.add_argument("-T", "--sv-type", default="ALL")
    s.add_argument("-J", "--discard-decoy", action="store_true")
    s.set_defaults(fn=_cmd_fc_anchor_ref)

    s = sub.add_parser("fc_index", help="anchor FASTA -> RdBG index dir")
    s.add_argument("anchors_fa")
    s.add_argument("index_dir")
    s.add_argument("--first-level", type=_fl_arg, default="auto")
    s.set_defaults(fn=_cmd_fc_index)

    s = sub.add_parser("fc_signal", help="BAM/CRAM -> signal FASTQ")
    s.add_argument("bam")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("-s", "--status-file", default="status.txt")
    s.add_argument("-U", "--discard-full-match", action="store_true")
    s.add_argument("-D", "--not-use-filter", action="store_true")
    s.add_argument("-f", "--ref", default=None,
                   help="reference FASTA (required for CRAM input)")
    s.set_defaults(fn=_cmd_fc_signal)

    s = sub.add_parser("fc_aln", help="signal FASTQ -> realigned BAM")
    s.add_argument("index_dir")
    s.add_argument("signal_fq")
    s.add_argument("header_sam")
    s.add_argument("-o", "--output", default="output.bam")
    s.add_argument("-p", "--output-ori", default=None,
                   help="side-channel BAM of ORIGINAL alignments for pairs "
                        "neither reference explains (de novo caller input)")
    s.add_argument("-r", "--status-file", default=None)
    s.add_argument("-b", "--batch", type=int, default=2048)
    s.add_argument("--trace", default=None, metavar="DIR",
                   help="write a JAX profiler (xplane/perfetto) trace of "
                        "the realignment stream to DIR and print the "
                        "engine phase timers")
    s.set_defaults(fn=_cmd_fc_aln)

    s = sub.add_parser("fc_sv", help="realigned BAM -> VCF")
    s.add_argument("anchors_fa")
    s.add_argument("bam")
    s.add_argument("ref")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("-r", "--status-file", default=None)
    s.add_argument("-e", "--edge-len", type=int, default=500)
    s.add_argument("-S", "--st-chr", type=int, default=0)
    s.add_argument("-E", "--ed-chr", type=int, default=10000)
    s.add_argument("-D", "--print-detail", action="store_true",
                   help="per-read pileup renderings to stderr")
    s.add_argument("-d", "--depth-detail", action="store_true",
                   help="event-matrix dumps to stderr")
    s.set_defaults(fn=_cmd_fc_sv)

    s = sub.add_parser("run", help="full pipeline (panSVR_run.sh equivalent)")
    s.add_argument("ref")
    s.add_argument("vcf")
    s.add_argument("bam")
    s.add_argument("workdir")
    s.add_argument("--first-level", type=_fl_arg, default="auto")
    s.add_argument("-b", "--batch", type=int, default=2048,
                   help="realignment engine batch (reads)")
    s.add_argument("--sv-shards", type=int, default=1,
                   help="fan fc_sv out over N worker processes "
                        "(panSVR_run.sh per-chromosome fan-out analog)")
    s.set_defaults(fn=_cmd_run)

    s = sub.add_parser("assembly_test", help="assemble reads from stdin")
    s.set_defaults(fn=_cmd_assembly_test)

    s = sub.add_parser("sv_calling", help="de novo SV caller (NovaSV analog)")
    s.add_argument("ref")
    s.add_argument("bam")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("-m", "--min-support", type=int, default=3)
    s.set_defaults(fn=_cmd_sv_calling)

    s = sub.add_parser("tools", help="analysis toolbox")
    s.add_argument("tool")
    s.add_argument("tool_args", nargs="*")
    s.set_defaults(fn=_cmd_tools)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
