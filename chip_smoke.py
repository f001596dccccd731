#!/usr/bin/env python3
"""Run pansvr_tpu end to end on one NVIDIA GPU and check what comes out.

    python chip_smoke.py

from the root of a checkout, on a machine with one GPU. Phases, in
order; the first failure exits non-zero:

  1. device   jax must see a GPU (never falls back to the CPU); prints
              the card's name and power limit from nvidia-smi;
  2. native   the BGZF codec and the engine glue are built from
              native/*.cpp and loaded (the engine takes slower host
              paths without them);
  3. DP gate  ops/onchip_check.run_onchip_parity(): the scan DP compiled
              for the card vs the scalar oracle at every engine class,
              both scoring profiles, zero mismatches;
  4. run      a simulated world from a fixed seed (2,000 DEL/INS/DUP SVs
              on two chromosomes of 10 Mbp, 200,000 SV-region read
              pairs; cached under .smoke_world/) through the `run` CLI
              in-process: anchors -> index -> signal -> fc_aln on the GPU
              at batch 8192 -> fc_sv;
  5. compare  the realigned BAM equals, record for record, what fc_aln
              writes for all the same signal reads under
              JAX_PLATFORMS=cpu in a subprocess; the VCF recovers the
              planted SVs at tests/test_pipeline.py's rate;
  6. report   stage walls, fc_aln reads/s with compile time apart, the
              engine's host-fallback counters, device peak memory.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORLD_BASE = os.path.join(ROOT, ".smoke_world")

SEED = 2024
N_SV = 2000
N_PAIRS = 200_000
CHROM_LEN = 10_000_000           # two chromosomes
BATCH = 8192
MIN_RECOVERY = 0.5               # tests/test_pipeline.py rate
MAX_HOST_SHARE = 0.5             # reads allowed on the host fallback

CARD = "?"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1):
    print(f"[smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---- phase 1 ---------------------------------------------------------------
def phase_device():
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        fail(f"jax found no usable backend: {e}")
    if devs[0].platform != "gpu":
        fail(f"jax's default backend is {devs[0].platform!r}, not a GPU; "
             "this script runs only on the card")
    global CARD
    CARD = card_line()
    log(CARD)
    log(f"[smoke] jax {jax.__version__}: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    return devs


# ---- phase 2 ---------------------------------------------------------------
def phase_native():
    from pansvr_tpu.align import native_glue
    from pansvr_tpu.io import native_bgzf
    from pansvr_tpu.utils.native_build import lib_path

    t = time.perf_counter()
    glue, bgzf = native_glue.get_lib(), native_bgzf.get_lib()
    if glue is None or bgzf is None:
        fail("native libraries could not be built from native/*.cpp")
    for name in ("libpansvr_glue.so", "libpansvr_bgzf.so"):
        p = lib_path(name)
        if not os.path.exists(p):
            fail(f"{p} missing after the build")
    log(f"[smoke] native: glue + bgzf built from native/*.cpp and loaded "
        f"({time.perf_counter() - t:.1f}s set-up)")


# ---- phase 3 ---------------------------------------------------------------
def phase_gate():
    from pansvr_tpu.ops.onchip_check import run_onchip_parity

    t = time.perf_counter()
    out = run_onchip_parity()
    for r in out["classes"]:
        log(f"[smoke] [{CARD}] DP gate {r['profile']} {r['Q']}x{r['T']} "
            f"x{r['lanes']} lanes ({r['distinct']} distinct): "
            f"mismatches={r['mismatches']} "
            f"compile+run {r['first_call_s']:.2f}s")
    log(f"[smoke] DP gate passed ({time.perf_counter() - t:.1f}s, sharded "
        f"check {'skipped: one device' if not out['sharded_dp'] else 'ok'})")


# ---- phase 4 ---------------------------------------------------------------
def world_dir() -> str:
    return os.path.join(
        WORLD_BASE, f"s{SEED}_sv{N_SV}_p{N_PAIRS}_c2x{CHROM_LEN // 1_000_000}M")


def make_world(d: str) -> float:
    """Generate (or reuse) genome.fa, svs.vcf, sim.bam under d; returns
    the generation seconds (0 when cached)."""
    if os.path.exists(os.path.join(d, ".done")):
        return 0.0
    from pansvr_tpu.io.fasta import write_fasta
    from pansvr_tpu.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam

    t = time.perf_counter()
    os.makedirs(d, exist_ok=True)
    ds = make_dataset(seed=SEED, n_sv=N_SV, n_pairs=N_PAIRS,
                      types=("DEL", "INS", "DUP"),
                      chrom_lengths={"chr1": CHROM_LEN, "chr2": CHROM_LEN})
    write_fasta(os.path.join(d, "genome.fa"), ds.genome.items(), width=60)
    w = VCFWriter(os.path.join(d, "svs.vcf"),
                  minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    write_sim_bam(ds, os.path.join(d, "sim.bam"))
    with open(os.path.join(d, "truth.json"), "w") as fh:
        json.dump([[s.chrom, s.pos1, s.sv_type] for s in ds.svs], fh)
    open(os.path.join(d, ".done"), "w").close()
    return time.perf_counter() - t


class CompileClock:
    """Records jax's trace/lower/compile(-or-cache-load) events as
    wall-clock intervals, so a stage's compile share can be taken out of
    its wall. Nested jits report nested intervals, so within() measures
    their union."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.spans: list[tuple[float, float]] = []

        def on(event, duration, **_):
            if event in self.EVENTS:
                end = time.time()
                self.spans.append((end - duration, end))

        jax.monitoring.register_event_duration_secs_listener(on)

    def within(self, t0: float, t1: float) -> float:
        total, reach = 0.0, t0
        for a, b in sorted(self.spans):
            a, b = max(a, reach), min(b, t1)
            if b > a:
                total += b - a
                reach = b
        return total


def phase_run(clock: CompileClock) -> tuple[str, dict]:
    from pansvr_tpu.cli.main import main as cli_main

    d = world_dir()
    gen_s = make_world(d)
    log(f"[smoke] world {os.path.basename(d)}: "
        + (f"generated in {gen_s:.1f}s (set-up)" if gen_s else
           "cached (set-up 0 s)"))
    work = os.path.join(d, "work_gpu")
    t = time.perf_counter()
    cli_main(["run", os.path.join(d, "genome.fa"), os.path.join(d, "svs.vcf"),
              os.path.join(d, "sim.bam"), work, "--batch", str(BATCH)])
    log(f"[smoke] run pipeline finished in {time.perf_counter() - t:.1f}s")
    with open(os.path.join(work, "run_stats.json")) as fh:
        stats = json.load(fh)
    return work, stats


# ---- phase 5 ---------------------------------------------------------------
def _bodies(path: str) -> list[bytes]:
    from pansvr_tpu.io.bam import BamReader

    with BamReader(path) as rd:
        return [bytes(b) for b in rd.iter_bodies()]


def phase_compare_bam(work: str) -> None:
    """fc_aln under JAX_PLATFORMS=cpu, in a subprocess that does not open
    the card, on all of the run's signal reads: its records must equal
    the GPU run's, in order."""
    d = os.path.dirname(work)
    cpu = os.path.join(d, "work_cpu")
    os.makedirs(cpu, exist_ok=True)
    with open(os.path.join(work, "signal.fq")) as fh:
        n = sum(1 for _ in fh) // 4
    from pansvr_tpu.io.bam import BamReader

    with BamReader(os.path.join(work, "realigned.bam")) as rd:
        hdr = rd.header
    with open(os.path.join(cpu, "header.sam"), "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:unsorted\n" + "".join(
            f"@SQ\tSN:{c}\tLN:{ln}\n"
            for c, ln in zip(hdr.ref_names, hdr.ref_lens)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    py = [sys.executable, "-m", "pansvr_tpu"]
    t = time.perf_counter()
    for cmd in (py + ["fc_index", os.path.join(work, "anchors.fa"),
                      os.path.join(cpu, "index")],
                py + ["fc_aln", os.path.join(cpu, "index"),
                      os.path.join(work, "signal.fq"),
                      os.path.join(cpu, "header.sam"),
                      "-o", os.path.join(cpu, "realigned.bam"),
                      "-p", os.path.join(cpu, "output_ori.bam"),
                      "-r", os.path.join(work, "status.txt"),
                      "-b", str(BATCH)]):
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True)
        if r.returncode != 0:
            fail(f"CPU reference run failed: {' '.join(cmd[2:4])}\n"
                 f"{r.stderr[-3000:]}")
    cpu_s = time.perf_counter() - t
    gpu_recs = _bodies(os.path.join(work, "realigned.bam"))
    cpu_recs = _bodies(os.path.join(cpu, "realigned.bam"))
    if not cpu_recs:
        fail("the CPU run wrote no records")
    if len(gpu_recs) != len(cpu_recs):
        fail(f"record count differs: GPU {len(gpu_recs)} vs CPU "
             f"{len(cpu_recs)} for {n} signal reads")
    bad = [i for i, (a, b) in enumerate(zip(gpu_recs, cpu_recs)) if a != b]
    if bad:
        fail(f"{len(bad)} of {len(cpu_recs)} records differ between the GPU "
             f"and CPU fc_aln runs (first at record {bad[0]})")
    log(f"[smoke] compare BAM: all {len(cpu_recs)} records for all {n} "
        f"signal reads equal record for record to fc_aln under "
        f"JAX_PLATFORMS=cpu ({cpu_s:.1f}s for fc_index + fc_aln on the "
        f"CPU)")


def phase_compare_vcf(work: str) -> None:
    from pansvr_tpu.io.vcf import VCFReader

    with open(os.path.join(os.path.dirname(work), "truth.json")) as fh:
        truth = json.load(fh)
    with VCFReader(os.path.join(work, "result.vcf")) as rd:
        recs = list(rd)
    by_key: dict = {}
    for r in recs:
        by_key.setdefault((r.chrom, r.sv_type), []).append(r.pos1)
    hits = sum(
        any(abs(p - pos1) <= 40 for p in by_key.get((chrom, t), ()))
        for chrom, pos1, t in truth)
    log(f"[smoke] compare VCF: {len(recs)} calls; {hits}/{len(truth)} "
        f"planted SVs recovered (type match, |pos| <= 40; need "
        f">= {MIN_RECOVERY:.0%})")
    if hits < MIN_RECOVERY * len(truth):
        fail(f"only {hits}/{len(truth)} planted SVs recovered")


# ---- phase 6 ---------------------------------------------------------------
def phase_report(stats: dict, clock: CompileClock, dev) -> None:
    for s in stats["stages"]:
        log(f"[smoke] [{CARD}] stage {s['stage']}: {s['wall_s']:.2f}s wall")
    fa = stats["fc_aln"]
    st = next(s for s in stats["stages"] if s["stage"] == "fc_aln")
    comp = clock.within(st["start"], st["end"])
    wall = st["wall_s"]
    eng = fa["engine"]
    n = fa["reads"]
    log(f"[smoke] [{CARD}] fc_aln: {n} reads at batch {fa['batch']} in "
        f"{wall:.2f}s = {n / wall:.1f} reads/s; compile (trace+lower+"
        f"compile or cache load) {comp:.2f}s of it; excluding compile "
        f"{n / max(wall - comp, 1e-9):.1f} reads/s")
    log(f"[smoke] [{CARD}] engine: n_fallback={int(eng.get('n_fallback', 0))}"
        f" n_budget_fallback={int(eng.get('n_budget_fallback', 0))}"
        f" n_dp_big={int(eng.get('n_dp_big', 0))}"
        f" n_dp_req={int(eng.get('n_dp_req', 0))}"
        f" n_dp_chunks={int(eng.get('n_dp_chunks', 0))}")
    phases = {k: round(v, 3) for k, v in eng.items()
              if not k.startswith("n_")}
    log(f"[smoke] [{CARD}] engine phases (s): {phases}")
    ms = dev.memory_stats() or {}
    log(f"[smoke] [{CARD}] device peak_bytes_in_use="
        f"{ms.get('peak_bytes_in_use', 'n/a')}")
    if n and eng.get("n_fallback", 0) > MAX_HOST_SHARE * n:
        fail(f"{int(eng['n_fallback'])}/{n} reads took the host path")


def main() -> None:
    devs = phase_device()
    sys.path.insert(0, ROOT)
    try:
        import pansvr_tpu  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the pansvr_tpu package next to this "
             f"script: {e}", code=2)
    from pansvr_tpu.utils.jaxcache import enable_cache

    enable_cache()
    t0 = time.perf_counter()
    phase_native()
    phase_gate()
    clock = CompileClock()
    work, stats = phase_run(clock)
    phase_compare_bam(work)
    phase_compare_vcf(work)
    phase_report(stats, clock, devs[0])
    log(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
