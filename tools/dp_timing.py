"""Per-chunk time of the scan DP at the engine's DP classes, on the GPU.

    python tools/dp_timing.py [--unroll 1,2,4,8] [--reps 20] [--trace DIR]

For every class (the realigner's (48, 64) x 2048, (96, 128) x 512 and
(176, 256) x 128 lanes, and the contig class (576, 704) x 256) and every
unroll factor, compiles the engine's fused DP program (align.engine.
_device_dp: forward sweep + traceback + pack) and prints the compile time
and the median per-chunk time over --reps calls, each ending in
block_until_ready. The unroll factor is applied to both scans
(ops/extd2_jax FWD_UNROLL and TB_UNROLL).

With --trace DIR, one call per class at the first unroll factor is
traced with jax.profiler; the reduction prints the device kernel count
per chunk, the device busy time (union of kernel intervals) and the idle
share of the call's device span.

Refuses to run without a GPU: these are device numbers.
"""

from __future__ import annotations

import argparse
import glob
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CLASSES = (("aln", 48, 64, 2048), ("aln", 96, 128, 512),
           ("aln", 176, 256, 128), ("sv", 576, 704, 256))


def device_busy(trace_dir: str) -> dict:
    """Kernel count, busy union and span over the GPU planes of the
    newest trace under trace_dir."""
    import jax

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    iv = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        print("    trace lines: " + ", ".join(
            f"{ln.name}({len(list(ln.events))})" for ln in plane.lines))
        for line in plane.lines:
            # stream lines carry the kernels; skip XLA's op/module summary
            # lines, which repeat the same intervals
            if "Stream" not in line.name:
                continue
            iv.extend((e.start_ns, e.start_ns + e.duration_ns)
                      for e in line.events)
    if not iv:
        return dict(kernels=0, busy_ms=0.0, span_ms=0.0, idle_share=None)
    iv.sort()
    busy, reach = 0, iv[0][0]
    for a, b in iv:
        a = max(a, reach)
        if b > a:
            busy += b - a
            reach = b
    span = iv[-1][1] - iv[0][0]
    return dict(kernels=len(iv), busy_ms=busy / 1e6, span_ms=span / 1e6,
                idle_share=1 - busy / span if span else None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--unroll", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        sys.exit("dp_timing: no GPU visible; device times need the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; jax {jax.__version__} "
          f"{jax.devices()[0].device_kind}", flush=True)

    from pansvr_tpu.align.engine import _device_dp
    from pansvr_tpu.ops import extd2_jax
    from pansvr_tpu.ops.onchip_check import ALN, SV, _pad, class_pairs
    from pansvr_tpu.utils.jaxcache import enable_cache

    enable_cache()
    rng = np.random.default_rng(1)
    inputs = {}
    for prof, Q, T, B in CLASSES:
        qc, ql, tc, tl, _ = _pad(class_pairs(rng, Q, T, 64), Q, T, B)
        inputs[(prof, Q, T, B)] = (qc, ql, tc, tl)

    for u in [int(x) for x in args.unroll.split(",")]:
        extd2_jax.FWD_UNROLL = extd2_jax.TB_UNROLL = u
        jax.clear_caches()
        for prof, Q, T, B in CLASSES:
            qc, ql, tc, tl = (jax.device_put(a) for a in
                              inputs[(prof, Q, T, B)])
            params = ALN if prof == "aln" else SV
            t = time.perf_counter()
            _device_dp(qc, ql, tc, tl, params=params,
                       K=Q + T).block_until_ready()
            comp = time.perf_counter() - t
            times = []
            for _ in range(args.reps):
                t = time.perf_counter()
                _device_dp(qc, ql, tc, tl, params=params,
                           K=Q + T).block_until_ready()
                times.append(time.perf_counter() - t)
            med = statistics.median(times)
            print(f"[{card}] unroll={u} {prof} {Q}x{T} x{B} lanes: compile "
                  f"{comp:.2f}s, chunk median {med * 1e3:.3f} ms (min "
                  f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; "
                  f"{args.reps} reps) = {B / med:.0f} problems/s",
                  flush=True)
            if args.trace and u == int(args.unroll.split(",")[0]):
                d = os.path.join(args.trace, f"{prof}_{Q}x{T}_u{u}")
                with jax.profiler.trace(d):
                    _device_dp(qc, ql, tc, tl, params=params,
                               K=Q + T).block_until_ready()
                r = device_busy(d)
                idle = "n/a" if r["idle_share"] is None \
                    else f"{r['idle_share']:.3f}"
                print(f"[{card}]   trace: {r['kernels']} device kernels "
                      f"per chunk ({r['kernels'] / (2 * (Q + T) - 1):.1f} "
                      f"per scan step), busy {r['busy_ms']:.3f} ms of a "
                      f"{r['span_ms']:.3f} ms device span, idle share "
                      f"{idle}", flush=True)


if __name__ == "__main__":
    main()
