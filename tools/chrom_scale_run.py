"""Chromosome-scale end-to-end run: ours vs the reference binaries.

Builds a ~100 Mbp / 2,000-SV (DEL+INS+DUP) / 5 M-pair world once
(cached under /tmp), then runs each pipeline stage side by side,
recording wall seconds and peak RSS (GB) per stage into
/tmp/pansvr_chrom_scale/report.json — the table PERF.md publishes.
Stages run as subprocesses so RSS is per-stage
(resource.getrusage(RUSAGE_CHILDREN) between stages is useless; we
spawn `python -c` / the reference binary under a fresh process).

Ours runs first_level_bases=14 (the reference's whole-genome hash
level, deBGA index.c). fc_aln (ours) needs the GPU; pass --stages to
run subsets (e.g. everything but aln on a host without one).

Usage: python tools/chrom_scale_run.py [--stages gen,anchor,index,signal,aln,sv]
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PY = sys.executable
W = "/tmp/pansvr_chrom_scale"
REPORT = f"{W}/report.json"
REF = "/tmp/refbuild/Release/panSVR"
DEBGA = "/tmp/refbuild/deBGA_release/deBGA"

N_SV = 2000
N_PAIRS = 5_000_000
CHROM_LENGTHS = {"chr1": 60_000_000, "chr2": 40_000_000}


def _load_report():
    try:
        return json.load(open(REPORT))
    except Exception:
        return {}


def _save_report(rep):
    os.makedirs(W, exist_ok=True)
    with open(REPORT, "w") as fh:
        json.dump(rep, fh, indent=1, sort_keys=True)
        fh.write("\n")


_RSS_WRAPPER = (
    "import subprocess,resource,sys;"
    "p=subprocess.run(sys.argv[2:]);"
    "r=resource.getrusage(resource.RUSAGE_CHILDREN);"
    "open(sys.argv[1],'w').write(str(r.ru_maxrss));"
    "sys.exit(p.returncode)"
)


def run_timed(name, argv, rep, env=None, check=True):
    """Run argv under a tiny wrapper process whose RUSAGE_CHILDREN
    covers exactly this stage (no /usr/bin/time in this image): wall +
    the child's own peak RSS, per-stage."""
    print(f"[chrom] {name}: {' '.join(argv[:4])}...", flush=True)
    t0 = time.perf_counter()
    e = dict(os.environ)
    if env:
        e.update(env)
    tf = f"{W}/.rss_{name}.txt"
    p = subprocess.run([PY, "-c", _RSS_WRAPPER, tf] + argv, env=e)
    wall = time.perf_counter() - t0
    rss_gb = 0.0
    try:
        rss_gb = int(open(tf).read().strip()) / 1e6  # KB -> GB (linux)
    except Exception:
        pass
    rep[name] = {"wall_s": round(wall, 1), "peak_rss_gb": round(rss_gb, 2),
                 "rc": p.returncode}
    _save_report(rep)
    print(f"[chrom] {name}: {wall:.1f}s rss={rss_gb:.2f}GB rc={p.returncode}",
          flush=True)
    if check and p.returncode != 0:
        raise RuntimeError(f"{name} failed rc={p.returncode}")


GEN_SRC = f"""
import sys, os
sys.path.insert(0, {REPO!r})
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam
from pansvr_tpu.io.fasta import write_fasta
from pansvr_tpu.io.vcf import VCFWriter, minimal_header
W = {W!r}
ds = make_dataset(seed=99, n_sv={N_SV}, n_pairs={N_PAIRS},
                  types=("DEL", "INS", "DUP"),
                  chrom_lengths={CHROM_LENGTHS!r}, err_rate=0.01)
write_fasta(f"{{W}}/genome.fa", ds.genome.items(), width=60)
w = VCFWriter(f"{{W}}/svs.vcf",
              minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
[w.write(r) for r in ds.vcf_records]
w.close()
with open(f"{{W}}/header.sam", "w") as fh:
    fh.write("@HD\\tVN:1.6\\tSO:coordinate\\n")
    for c, s in ds.genome.items():
        fh.write(f"@SQ\\tSN:{{c}}\\tLN:{{len(s)}}\\n")
write_sim_bam(ds, f"{{W}}/sim.bam")
open(f"{{W}}/.gen_done", "w").write("ok")
"""

ANCHOR_SRC = f"""
import sys, os
sys.path.insert(0, {REPO!r})
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from pansvr_tpu.anchor.builder import run_anchor_ref
from pansvr_tpu.io.fasta import Faidx
W = {W!r}
run_anchor_ref(f"{{W}}/svs.vcf", Faidx(f"{{W}}/genome.fa"),
               open(f"{{W}}/anchors.fa", "w"))
"""

INDEX_SRC = f"""
import sys, os
sys.path.insert(0, {REPO!r})
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.index.store import save_index
from pansvr_tpu.io.fasta import read_fasta
W = {W!r}
contigs = list(read_fasta(f"{{W}}/anchors.fa").items())
idx = build_index(contigs, first_level_bases="auto")
print(f"[index] fl={{idx.first_level_bases}} n_kmers={{idx.n_kmers}}")
save_index(idx, f"{{W}}/rdbg")
"""

SIGNAL_SRC = f"""
import sys, os
sys.path.insert(0, {REPO!r})
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from pansvr_tpu.signal.extract import SignalOptions, extract_signal
W = {W!r}
with open(f"{{W}}/signal.fq", "w") as fh:
    stats = extract_signal(
        f"{{W}}/sim.bam", fh,
        opts=SignalOptions(discard_both_full_match=True,
                           not_using_filter=True))
with open(f"{{W}}/status.sam", "w") as fh:
    fh.write(stats.status_file_text())
"""

ALN_SRC = f"""
import sys, os
sys.path.insert(0, {REPO!r})
from pansvr_tpu.cli.main import main
W = {W!r}
sys.argv = ["pansvr", "fc_aln", "-o", f"{{W}}/our_aln.bam",
            "-b", "8192", "-r", f"{{W}}/status.sam",
            W, f"{{W}}/signal.fq", f"{{W}}/header.sam"]
main()
"""

SORT_SRC = f"""
import sys, os
sys.path.insert(0, {REPO!r})
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from pansvr_tpu.io.bai import build_bai, sort_bam
W = {W!r}
src = sys.argv[1]; dst = sys.argv[2]
sort_bam(src, dst)
build_bai(dst)
"""

SV_SRC = f"""
import sys, os
sys.path.insert(0, {REPO!r})
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from pansvr_tpu.cli.main import main
W = {W!r}
bam = sys.argv[1]; out = sys.argv[2]
sys.argv = ["pansvr", "fc_sv", "-o", out, "-r", f"{{W}}/status.sam",
            f"{{W}}/anchors.fa", bam, f"{{W}}/genome.fa"]
main()
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", default="gen,anchor,index,signal,aln,sv")
    args = ap.parse_args()
    stages = set(args.stages.split(","))
    rep = _load_report()
    os.makedirs(W, exist_ok=True)

    if "gen" in stages and not os.path.exists(f"{W}/.gen_done"):
        run_timed("gen_world", [PY, "-c", GEN_SRC], rep)

    if "anchor" in stages:
        run_timed("anchor_ours", [PY, "-c", ANCHOR_SRC], rep)
        if os.path.exists(REF):
            for p in (f"{W}/genome.fa.fai",):
                pass  # our Faidx writes no .fai the reference would trust
            run_timed("anchor_ref",
                      ["bash", "-c",
                       f"{REF} fc_anchor_ref {W}/genome.fa {W}/svs.vcf "
                       f"> {W}/ref_anchors.fa"], rep, check=False)

    if "index" in stages:
        run_timed("index_ours", [PY, "-c", INDEX_SRC], rep)
        if os.path.exists(DEBGA):
            os.makedirs(f"{W}/idx", exist_ok=True)
            run_timed("index_debga",
                      [DEBGA, "index", "-k", "22", f"{W}/anchors.fa",
                       f"{W}/idx/"], rep, check=False)

    if "signal" in stages:
        run_timed("signal_ours", [PY, "-c", SIGNAL_SRC], rep)
        if os.path.exists(REF):
            run_timed("signal_ref",
                      ["bash", "-c",
                       f"{REF} fc_signal -N -r {W}/ref_status.sam "
                       f"{W}/sim_namesorted.bam > {W}/ref_signal.fq"
                       if os.path.exists(f"{W}/sim_namesorted.bam") else
                       f"{REF} fc_signal -r {W}/ref_status.sam "
                       f"{W}/sim.bam > {W}/ref_signal.fq"],
                      rep, check=False)

    if "aln" in stages:
        # ours needs the GPU; the reference runs 4 threads (all
        # cores of this host)
        run_timed("aln_ours", [PY, "-c", ALN_SRC], rep, check=False)
        if os.path.exists(REF) and os.path.exists(f"{W}/idx/unipath_g.hash"):
            run_timed("aln_ref_4t",
                      ["bash", "-c",
                       f"{REF} fc_aln -t 4 -o {W}/ref_aln.bam {W}/idx/ "
                       f"{W}/signal.fq {W}/header.sam"], rep, check=False)

    if "sv" in stages:
        if os.path.exists(f"{W}/our_aln.bam"):
            run_timed("sort_ours", [PY, "-c", SORT_SRC, f"{W}/our_aln.bam",
                                    f"{W}/our_sorted.bam"], rep)
            run_timed("sv_ours", [PY, "-c", SV_SRC, f"{W}/our_sorted.bam",
                                  f"{W}/our_result.vcf"], rep, check=False)
        if os.path.exists(f"{W}/ref_aln.bam") and os.path.exists(REF):
            run_timed("sort_ref_bam", [PY, "-c", SORT_SRC,
                                       f"{W}/ref_aln.bam",
                                       f"{W}/ref_sorted.bam"], rep)
            run_timed("sv_ref",
                      ["bash", "-c",
                       f"{REF} fc_sv -o {W}/ref_result.vcf {W}/idx/ "
                       f"{W}/ref_sorted.bam {W}/header.sam {W}/genome.fa"],
                      rep, check=False)

    print(json.dumps(rep, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
