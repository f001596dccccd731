"""Multiprocess fc_aln fan-out: one worker process per card.

The serial host fraction of the realignment stage is the Amdahl ceiling
of any multi-card deployment — the device programs shard over a mesh
(parallel.mesh), but one Python host feeds them all. This module is the kt_pipeline/kt_for process analog
(read_realignment.cpp:98-176) at deployment granularity: the signal
FASTQ splits into contiguous pair-aligned shards, one `pansvr_tpu
fc_aln` subprocess per shard owns its own device plus ALL of its host
glue (prep, collect, replay, PE-emit, BGZF write), and the shard BAMs
merge in input order — byte-identical record streams to the unsharded
run (tested), mirroring the reference's stage file contracts.

On a multi-GPU host, pass per-worker env pinning one card each,
worker_env={"CUDA_VISIBLE_DEVICES": "{shard}"}: each JAX process
reserves most of a card's memory when it starts, so two workers must
never share one. The virtual test runs workers on the CPU backend.
"""

from __future__ import annotations

import os
import subprocess
import sys

from ..io.bam import BamReader, BamWriter


def split_signal_fastq(signal_fq: str, out_prefix: str,
                       n_shards: int) -> list[str]:
    """Split an interleaved signal FASTQ into n contiguous pair-aligned
    shards (trailing unpaired record dropped, like the paired kseq
    loop). Returns the shard paths."""
    # pass 1: count records
    n_rec = 0
    with open(signal_fq, "rb", buffering=1 << 20) as fh:
        for _ in fh:
            n_rec += 1
    n_rec //= 4
    n_pairs = n_rec // 2
    n_shards = max(1, min(n_shards, max(n_pairs, 1)))
    per = -(-n_pairs // n_shards)
    paths = []
    with open(signal_fq, "rb", buffering=1 << 20) as fh:
        for s in range(n_shards):
            lo = min(s * per, n_pairs)
            hi = min(lo + per, n_pairs)
            path = f"{out_prefix}.shard{s}.fq"
            paths.append(path)
            with open(path, "wb", buffering=1 << 20) as out:
                for _ in range((hi - lo) * 8):
                    out.write(fh.readline())
    return paths


def merge_bam_shards(shard_bams: list[str], out_bam: str) -> None:
    """Concatenate shard BAM record streams under one header (shard
    order = input order, so the merged stream equals the unsharded
    run's)."""
    first = BamReader(shard_bams[0])
    with BamWriter(out_bam, first.header) as w:
        for path in shard_bams:
            r = first if path == shard_bams[0] else BamReader(path)
            for body in r.iter_bodies():
                w.write_raw(body)


def run_aln_fanout(index_dir: str, signal_fq: str, header_sam: str,
                   out_bam: str, n_shards: int,
                   status_file: str | None = None, batch: int = 8192,
                   worker_env: dict | None = None,
                   timeout: float = 7200.0, max_retries: int = 1) -> str:
    """Run fc_aln over `n_shards` worker processes and merge the BAMs.
    Failed/timed-out shards re-dispatch up to `max_retries` times (same
    elasticity contract as run_sv_fanout)."""
    env = dict(os.environ)
    if worker_env:
        env.update(worker_env)

    shards = split_signal_fastq(signal_fq, out_bam, n_shards)

    def shard_cmd(s, part):
        cmd = [sys.executable, "-m", "pansvr_tpu", "fc_aln",
               "-o", part, "-b", str(batch),
               index_dir, shards[s], header_sam]
        if status_file:
            cmd += ["-r", status_file]
        return cmd

    def spawn(s, part):
        e = dict(env)
        e.update({k: v.format(shard=s) if isinstance(v, str) else v
                  for k, v in (worker_env or {}).items()})
        return subprocess.Popen(shard_cmd(s, part), env=e,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)

    parts = [f"{out_bam}.shard{s}.bam" for s in range(len(shards))]
    procs = [(s, parts[s], spawn(s, parts[s])) for s in range(len(shards))]
    for attempt in range(max_retries + 1):
        failures = []
        for s, part, pr in procs:
            try:
                _, err = pr.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pr.kill()
                _, err = pr.communicate()
                failures.append((s, part, "timeout", err))
                continue
            if pr.returncode != 0:
                failures.append((s, part, f"rc={pr.returncode}", err))
        if not failures:
            break
        if attempt == max_retries:
            s, _, why, err = failures[0]
            tail = (err or b"").decode(errors="replace")[-2000:]
            raise RuntimeError(
                f"fc_aln shard {s} failed ({why}) after "
                f"{max_retries + 1} attempts.\n{tail}")
        procs = []
        for s, part, why, _ in failures:
            print(f"[aln-fanout] re-dispatching shard {s} ({why})",
                  file=sys.stderr, flush=True)
            procs.append((s, part, spawn(s, part)))

    merge_bam_shards(parts, out_bam)
    for p in parts + shards:
        if os.path.exists(p):
            os.unlink(p)
    return out_bam
