"""Measure the reference CPU panSVR realignment throughput for
bench.py's vs_baseline ratio — on the SAME signal FASTQ bench.py times.

Uses bench.build_bench_world() (cached under .bench_world/): genome + BAM +
anchors + signal.fq produced with the reference driver's flags (-D -U).
The reference side gets its own deBGA index over the same anchors
(built by the reference binaries), then `panSVR fc_aln` is timed at
1/4/8/32 threads, full stage (FASTQ -> BAM) — identical work to what
bench.py times on the GPU side.

NOTE: this host has 4 physical cores, so the "32-thread" rate is the
4-core saturation rate (32 threads cannot exceed it); we report every
tier so the saturation point is visible in the data.

Writes /tmp/pansvr_cpu_baseline.json; copy to tools/cpu_baseline.json
to commit it as the fallback.

Usage: PYTHONPATH=/root/repo python tools/measure_cpu_baseline.py
Requires tools/build_reference.sh to have been run.
"""

import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PANSVR = "/tmp/refbuild/Release/panSVR"
DEBGA = "/tmp/refbuild/deBGA_release/deBGA"
OUT = "/tmp/pansvr_cpu_baseline.json"


def main():
    from bench import WORLD_VERSION, build_bench_world

    work = build_bench_world()
    n_reads = sum(1 for _ in open(f"{work}/signal.fq")) // 4
    print(f"world {WORLD_VERSION}: {n_reads} signal reads")

    # reference-built anchor FASTA + deBGA index over the same genome/VCF
    ref_dir = f"{work}/refside"
    if not os.path.exists(f"{ref_dir}/.done"):
        shutil.rmtree(ref_dir, ignore_errors=True)
        os.makedirs(f"{ref_dir}/idx", exist_ok=True)
        for f in (f"{work}/genome.fa.fai",):
            if os.path.exists(f):
                os.unlink(f)
        with open(f"{ref_dir}/anchors.fa", "w") as fh:
            subprocess.run(
                [PANSVR, "fc_anchor_ref", f"{work}/genome.fa",
                 f"{work}/svs.vcf"],
                stdout=fh, stderr=subprocess.DEVNULL, check=True)
        subprocess.run(
            [DEBGA, "index", "-k", "22", f"{ref_dir}/anchors.fa",
             f"{ref_dir}/idx/"],
            check=True, capture_output=True)
        open(f"{ref_dir}/.done", "w").write("ok")

    res = {"world": WORLD_VERSION, "n_reads": n_reads,
           "host_cores": os.cpu_count()}
    for threads in (1, 4, 8, 32):
        t0 = time.time()
        r = subprocess.run(
            [PANSVR, "fc_aln", "-t", str(threads),
             "-o", f"{ref_dir}/aln_t{threads}.bam", f"{ref_dir}/idx/",
             f"{work}/signal.fq", "--", f"{work}/header.sam"],
            capture_output=True, cwd=ref_dir)
        dt = time.time() - t0
        if r.returncode != 0:
            print(f"t={threads}: FAILED rc={r.returncode}\n"
                  f"{r.stderr.decode()[-500:]}")
            continue
        rate = n_reads / dt
        res[f"cpu_reads_per_s_{threads}t"] = round(rate, 1)
        print(f"t={threads}: {dt:.1f}s  {rate:.0f} reads/s")

    json.dump(res, open(OUT, "w"), indent=1)
    print(f"wrote {OUT}; copy to tools/cpu_baseline.json to commit")


if __name__ == "__main__":
    main()
