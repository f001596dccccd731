"""Native PE-pair + BAM-emit (glue_pe_emit) byte-parity vs the Python
path (PEScorer.pair + bam_out.emit_pair + io.bam._encode_record) on a
simulated SV world, including the host-fallback splice."""

import numpy as np
import pytest

from pansvr_tpu.align import native_glue



def _world():
    from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.signal.extract import SignalOptions, extract_signal
    from pansvr_tpu.utils.simulate import DictGenome, make_dataset, write_sim_bam
    import io as _io
    import os
    import tempfile

    ds = make_dataset(seed=77, n_sv=10, n_pairs=1200, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 300_000}, err_rate=0.02)
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=12)
    with tempfile.TemporaryDirectory() as td:
        bam = os.path.join(td, "sim.bam")
        write_sim_bam(ds, bam)
        fq = _io.StringIO()
        extract_signal(bam, fq, opts=SignalOptions(
            discard_both_full_match=False, not_using_filter=True))
        fq.seek(0)
        from pansvr_tpu.pipeline import read_signal_fastq

        records = list(read_signal_fastq(fq))
    return ds, idx, records


def test_native_emit_byte_parity():
    from pansvr_tpu.align.bam_out import EmitContext, emit_pair
    from pansvr_tpu.align.engine import AlignEngine
    from pansvr_tpu.align.host_align import PEScorer
    from pansvr_tpu.io.bam import BamHeader, _encode_record
    from pansvr_tpu.pipeline import parse_signal_comment

    ds, idx, records = _world()
    records = records[: len(records) // 2 * 2]
    assert len(records) > 400
    header = BamHeader(text="@HD\tVN:1.6\n",
                       ref_names=list(ds.genome),
                       ref_lens=[len(s) for s in ds.genome.values()])

    oris = [parse_signal_comment(r[3])[0] for r in records]
    names = [r[0] for r in records]
    seqs = [r[1] for r in records]
    quals = [r[2] for r in records]
    comments = [r[3] for r in records]

    # --- Python reference path ---------------------------------------
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    pe = PEScorer(eng.host, max_isize=600, min_isize=200,
                  normal_read_len=150)
    B = 512
    py_bytes = []
    for b0 in range(0, len(records), B):
        states = eng.align_batch(seqs[b0 : b0 + B], oris[b0 : b0 + B])
        for k in range(0, len(states) - 1, 2):
            pr = pe.pair(states[k], states[k + 1])
            if not pr.gain_better:
                continue
            for rec in emit_pair(
                eng.host, pr, states[k], states[k + 1], names[b0 + k],
                seqs[b0 + k], quals[b0 + k], seqs[b0 + k + 1],
                quals[b0 + k + 1], comments[b0 + k], comments[b0 + k + 1],
                header,
            ):
                py_bytes.append(_encode_record(rec))
    py_blob = b"".join(py_bytes)
    assert len(py_blob) > 10_000

    # --- native path ----------------------------------------------------
    eng2 = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    ec = EmitContext(eng2.host, header, max_isize=600, min_isize=200,
                     normal_read_len=150)
    eng2.set_native_emit(ec)

    def batches():
        for b0 in range(0, len(records), B):
            yield (seqs[b0 : b0 + B], oris[b0 : b0 + B],
                   (names[b0 : b0 + B], quals[b0 : b0 + B],
                    comments[b0 : b0 + B]))

    native_blob = b"".join(eng2.align_stream(batches()))
    assert native_blob == py_blob


def test_native_emit_fallback_splice():
    """A pair with an out-of-class (oversize) read takes the host path;
    its records must splice into the blob at the right position."""
    from pansvr_tpu.align.bam_out import EmitContext, emit_pair
    from pansvr_tpu.align.engine import AlignEngine
    from pansvr_tpu.align.host_align import OriResult, PEScorer
    from pansvr_tpu.io.bam import BamHeader, _encode_record

    ds, idx, records = _world()
    records = records[:64]
    header = BamHeader(text="@HD\tVN:1.6\n",
                       ref_names=list(ds.genome),
                       ref_lens=[len(s) for s in ds.genome.values()])
    from pansvr_tpu.pipeline import parse_signal_comment

    oris = [parse_signal_comment(r[3])[0] for r in records]
    names = [r[0] for r in records]
    seqs = [r[1] for r in records]
    quals = [r[2] for r in records]
    comments = [r[3] for r in records]
    # make pair #3 oversize: stretch read 6 beyond the largest class
    big = seqs[6] * 12
    seqs[6] = big[:1700]
    quals[6] = "I" * len(seqs[6])

    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    pe = PEScorer(eng.host, 600, 200, 150)
    states = eng.align_batch(seqs, oris)
    py_bytes = []
    for k in range(0, len(states) - 1, 2):
        pr = pe.pair(states[k], states[k + 1])
        if not pr.gain_better:
            continue
        for rec in emit_pair(eng.host, pr, states[k], states[k + 1],
                             names[k], seqs[k], quals[k], seqs[k + 1],
                             quals[k + 1], comments[k], comments[k + 1],
                             header):
            py_bytes.append(_encode_record(rec))
    py_blob = b"".join(py_bytes)

    eng2 = AlignEngine(idx, ori_chrom_names=list(ds.genome))
    ec = EmitContext(eng2.host, header, 600, 200, 150)
    eng2.set_native_emit(ec)
    native_blob = b"".join(eng2.align_stream(
        [(seqs, oris, (names, quals, comments))]))
    assert native_blob == py_blob


def test_stream_depth_parity():
    """align_stream stream_depth=2 (two fronts in flight + deferred DP
    phase) is byte-identical to stream_depth=1 and to align_batch."""
    from pansvr_tpu.align.bam_out import EmitContext
    from pansvr_tpu.align.engine import AlignEngine, EngineConfig
    from pansvr_tpu.io.bam import BamHeader
    from pansvr_tpu.pipeline import parse_signal_comment

    ds, idx, records = _world()
    records = records[: len(records) // 2 * 2]
    header = BamHeader(text="@HD\tVN:1.6\n",
                       ref_names=list(ds.genome),
                       ref_lens=[len(s) for s in ds.genome.values()])
    oris = [parse_signal_comment(r[3])[0] for r in records]
    names = [r[0] for r in records]
    seqs = [r[1] for r in records]
    quals = [r[2] for r in records]
    comments = [r[3] for r in records]
    B = 256  # several batches in flight

    blobs = []
    for depth in (1, 2):
        cfg = EngineConfig()
        cfg.stream_depth = depth
        eng = AlignEngine(idx, config=cfg, ori_chrom_names=list(ds.genome))
        eng.set_native_emit(EmitContext(
            eng.host, header, max_isize=600, min_isize=200,
            normal_read_len=150))

        def batches():
            for b0 in range(0, len(records), B):
                yield (seqs[b0 : b0 + B], oris[b0 : b0 + B],
                       (names[b0 : b0 + B], quals[b0 : b0 + B],
                        comments[b0 : b0 + B]))

        blobs.append(b"".join(eng.align_stream(batches())))
    assert blobs[0] == blobs[1]
    assert len(blobs[0]) > 10_000

    # plain state-list streaming (no emit), depth 2 vs align_batch
    cfg = EngineConfig()
    eng_a = AlignEngine(idx, config=cfg, ori_chrom_names=list(ds.genome))
    eng_b = AlignEngine(idx, config=cfg, ori_chrom_names=list(ds.genome))
    got = []
    for states in eng_a.align_stream(
            (seqs[b0 : b0 + B], oris[b0 : b0 + B])
            for b0 in range(0, len(records), B)):
        got.extend(states)
    want = []
    for b0 in range(0, len(records), B):
        want.extend(eng_b.align_batch(seqs[b0 : b0 + B],
                                      oris[b0 : b0 + B]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        ra = [(r.align_score, r.chain_score, r.ref_bg, r.read_bg,
               r.direction, r.sv_id, r.cigar) for r in a.results]
        rb = [(r.align_score, r.chain_score, r.ref_bg, r.read_bg,
               r.direction, r.sv_id, r.cigar) for r in b.results]
        assert ra == rb
