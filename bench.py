"""Benchmark: reads realigned per second per chip through the FULL
fc_aln stage — signal-FASTQ in, realigned BAM out, including original-
alignment parsing, seeding + chaining + banded DP + CIGAR on device,
PE rescoring and BAM record emission. This is the same work the
reference `fc_aln` stage does end to end (read_realignment.cpp:26-176),
so vs_baseline compares equal stages.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline divides by the reference fc_aln rate measured by
tools/measure_cpu_baseline.py on the IDENTICAL signal FASTQ (committed
in tools/cpu_baseline.json). Details
(device, per-pass rates, engine phase split) go to stderr.

Runs only on a GPU: with none visible it exits non-zero and prints no
result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_FILE = os.path.join(ROOT, "tools", "cpu_baseline.json")

# bump when the world recipe changes (baseline must be re-measured)
WORLD_VERSION = "v4-250k-e2"
WORLD_DIR = os.path.join(ROOT, ".bench_world", WORLD_VERSION)


def build_world(seed=123, n_sv=64, n_pairs=30_000):
    """Small in-memory world (kept for tools/profile_front.py A/Bs)."""
    from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(
        seed=seed, n_sv=n_sv, n_pairs=n_pairs, types=("DEL", "INS"),
        chrom_lengths={"chr1": 2_000_000},
    )
    contigs = list(
        build_anchor_contigs(ds.vcf_records, DictGenome(ds.genome), AnchorConfig())
    )
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=12)
    return ds, idx


def build_bench_world(n_pairs=250_000, seed=123, n_sv=64,
                      err_rate=0.02):
    """Fully materialized stage inputs on disk, cached under WORLD_DIR:
    genome/svs/BAM, anchors, our RdBG index pickle, header/status files
    and the signal FASTQ produced with the reference driver's flags
    (-D -U, panSVR_run.sh:51). Both this bench and the CPU-baseline tool
    consume the SAME signal.fq, so the two sides of vs_baseline measure
    identical work."""
    import pickle

    done = os.path.join(WORLD_DIR, ".done")
    if os.path.exists(done):
        return WORLD_DIR
    from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.io.fasta import write_fasta
    from pansvr_tpu.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu.signal.extract import (
        SignalOptions, compute_stats, extract_signal)
    from pansvr_tpu.utils.simulate import (
        DictGenome, make_dataset, write_sim_bam)

    os.makedirs(WORLD_DIR, exist_ok=True)
    ds = make_dataset(
        seed=seed, n_sv=n_sv, n_pairs=n_pairs, types=("DEL", "INS"),
        chrom_lengths={"chr1": 2_000_000}, err_rate=err_rate,
    )
    write_fasta(f"{WORLD_DIR}/genome.fa", ds.genome.items(), width=60)
    w = VCFWriter(f"{WORLD_DIR}/svs.vcf",
                  minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    write_sim_bam(ds, f"{WORLD_DIR}/sim.bam")

    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    with open(f"{WORLD_DIR}/anchors.fa", "w") as fh:
        for c in contigs:
            fh.write(f">{c.name}\n{c.seq}\n")
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=12)
    with open(f"{WORLD_DIR}/rdbg.pkl", "wb") as fh:
        pickle.dump(idx, fh)

    with open(f"{WORLD_DIR}/header.sam", "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c, s in ds.genome.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{len(s)}\n")
    stats = compute_stats(f"{WORLD_DIR}/sim.bam")
    with open(f"{WORLD_DIR}/status.sam", "w") as fh:
        fh.write(stats.status_file_text())
    with open(f"{WORLD_DIR}/signal.fq", "w") as fh:
        extract_signal(f"{WORLD_DIR}/sim.bam", fh, stats=stats,
                       opts=SignalOptions(discard_both_full_match=True,
                                          not_using_filter=True))
    open(done, "w").write(WORLD_VERSION)
    return WORLD_DIR


def _run_fc_aln(work: str, out_bam: str,
                batch: int = int(os.environ.get("PANSVR_BATCH", 8192))):
    """The full fc_aln stage, in-process (same path as
    `python -m pansvr_tpu fc_aln`). Returns (n_reads, wall_s, engine)."""
    import pickle

    from pansvr_tpu.align.engine import AlignEngine
    from pansvr_tpu.align.host_align import PEScorer
    from pansvr_tpu.align.bam_out import min_filter_score
    from pansvr_tpu.cli.main import _run_aln_stream
    from pansvr_tpu.io.bam import BamHeader, BamWriter
    from pansvr_tpu.pipeline import parse_signal_comment, read_signal_fastq
    from pansvr_tpu.signal.extract import SignalStats

    with open(os.path.join(work, "rdbg.pkl"), "rb") as fh:
        idx = pickle.load(fh)
    header = BamHeader.from_sam_text(open(f"{work}/header.sam").read())
    stats = SignalStats.parse_status_text(open(f"{work}/status.sam").read())
    cfg_kw = {}
    if os.environ.get("PANSVR_STREAM_DEPTH"):
        cfg_kw["stream_depth"] = int(os.environ["PANSVR_STREAM_DEPTH"])
    if os.environ.get("PANSVR_DP_CHUNK"):
        cfg_kw["dp_chunk"] = int(os.environ["PANSVR_DP_CHUNK"])
    if os.environ.get("PANSVR_COLLECT"):
        cfg_kw["collect"] = os.environ["PANSVR_COLLECT"]
    if os.environ.get("PANSVR_CHAIN_COPY"):
        cfg_kw["chain_copy"] = os.environ["PANSVR_CHAIN_COPY"]
    from pansvr_tpu.align.engine import EngineConfig

    eng = AlignEngine(idx, ori_chrom_names=header.ref_names,
                      config=EngineConfig(**cfg_kw) if cfg_kw else None)
    eng.load_tuning(f"{work}/engine_tune.json")
    pe = PEScorer(eng.host, stats.max_isize or 600, stats.min_isize or 200,
                  stats.read_len or 150)
    filt = min_filter_score(stats.read_len or 150)
    from pansvr_tpu.align import native_glue
    native_emit = native_glue.available() and not os.environ.get(
        "PANSVR_NO_NATIVE_EMIT")
    if native_emit:
        from pansvr_tpu.align.bam_out import EmitContext

        eng.set_native_emit(EmitContext(
            eng.host, header, stats.max_isize or 600,
            stats.min_isize or 200, stats.read_len or 150))
        print("[bench] native emit: PE-pair + BAM-encode in C++",
              file=sys.stderr)

    records = list(read_signal_fastq(f"{work}/signal.fq"))
    records = records[: len(records) // 2 * 2]

    def run_once(recs, out_path):
        import itertools

        writer = BamWriter(out_path, header)
        step = 2 * (batch // 2)

        def chunk_stream():
            for b0 in range(0, len(recs), step):
                chunk = recs[b0 : b0 + step]
                if len(chunk) >= 2:
                    yield chunk[: len(chunk) // 2 * 2]

        if native_emit:
            chunks_a = iter(())

            def batch_stream():
                from pansvr_tpu.align import native_glue as ng

                for chunk in chunk_stream():
                    comments = [p[3] for p in chunk]
                    oris = ng.parse_comments(comments)
                    if oris is None:
                        oris = [parse_signal_comment(c)[0]
                                for c in comments]
                    yield ([p[1] for p in chunk], oris,
                           ([p[0] for p in chunk], [p[2] for p in chunk],
                            comments))
        else:
            chunks_a, chunks_b = itertools.tee(chunk_stream())

            def batch_stream():
                for chunk in chunks_b:
                    yield ([p[1] for p in chunk],
                           [parse_signal_comment(p[3])[0] for p in chunk])

        t0 = time.perf_counter()
        _run_aln_stream(chunks_a, eng, pe, writer, None, header, filt,
                        batch_stream)
        return time.perf_counter() - t0

    # warm-up: compile every shape on a prefix (the persistent cache
    # makes later processes cheap, but in-run timing must exclude it)
    run_once(records[: 4 * batch], out_bam + ".warmup.bam")
    eng.save_tuning(f"{work}/engine_tune.json")
    eng.prof.clear()
    wall = run_once(records, out_bam)
    return len(records), wall, eng


def _device_or_exit():
    """The GPU this bench measures; exits non-zero without one. Prints
    platform, device_kind, device count and the card's name and power
    limit to stderr."""
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        sys.exit(f"[bench] no usable jax backend: {e}")
    d = devs[0]
    if d.platform != "gpu":
        sys.exit(f"[bench] platform {d.platform!r} is not a GPU; the "
                 "bench measures the card only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[bench] device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)} card={card.stdout.strip() or 'n/a'}",
          file=sys.stderr, flush=True)
    return devs


def main():
    _device_or_exit()
    from pansvr_tpu.utils.jaxcache import enable_cache

    enable_cache()
    # device DP self-check: the compiled scan DP vs the scalar oracle on
    # this card, so every recorded number is backed by a fresh parity
    # pass (full gate: python -m pytest tests/test_onchip.py -m gpu)
    try:
        from pansvr_tpu.ops.onchip_check import run_onchip_parity

        chk = run_onchip_parity(quick=True)
        print(f"[bench] device DP parity OK: {chk}", file=sys.stderr,
              flush=True)
    except AssertionError as e:
        print(f"[bench] DEVICE DP PARITY FAILED: {e}", file=sys.stderr,
              flush=True)
        sys.exit(2)

    work = build_bench_world()
    n_reads = sum(1 for _ in open(f"{work}/signal.fq")) // 4
    print(f"[bench] world {WORLD_VERSION}: {n_reads} signal reads",
          file=sys.stderr, flush=True)

    # median of three full-stage passes
    rates = []
    eng = None
    for p in range(3):
        n, wall, eng = _run_fc_aln(work, f"{work}/bench_out_{p}.bam")
        rates.append(n / wall)
        print(f"[bench] pass {p}: {n / wall:.0f} reads/s ({wall:.1f}s)",
              file=sys.stderr, flush=True)
    reads_per_s = sorted(rates)[1]

    # device-only rate from the engine phase profile of the last pass
    # (sync_* rows are device execution + result transfer waits)
    prof = {k: round(v, 3) for k, v in (eng.prof or {}).items()
            if isinstance(v, float)}
    dev_wait = prof.get("sync_chain", 0) + prof.get("sync_dp", 0)
    if dev_wait > 0:
        print(f"[bench] engine phases (s): {prof}", file=sys.stderr)
        print(f"[bench] device-wait-bound rate: {n_reads / dev_wait:.0f} "
              f"reads/s", file=sys.stderr)

    vs_baseline = 0.0
    base_path = BASELINE_FILE
    if os.path.exists(base_path):
        try:
            base = json.load(open(base_path))
            if base.get("world") not in (None, WORLD_VERSION):
                print(f"[bench] WARNING: baseline world "
                      f"{base.get('world')} != {WORLD_VERSION}",
                      file=sys.stderr)
            cpu = float(base.get("cpu_reads_per_s_32t", 0))
            if cpu > 0:
                vs_baseline = reads_per_s / cpu
        except Exception:
            pass

    result = {
        "metric": "reads_realigned_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs_baseline, 3),
        "n_passes": len(rates),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
