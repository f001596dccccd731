"""Multi-chip weak-scaling accounting on the virtual CPU mesh.

For n in DEVICE_COUNTS, a fresh subprocess (xla_force_host_platform_
device_count must precede jax init) builds an n-device mesh, runs the
REAL engine (AlignEngine(mesh=...), depth-2 pipelined align_stream,
scan DP backend — CPU-portable) over a weak-scaled workload
(PER_DEV reads per device), and reports:

  wall_s            total stream wall
  per_dev_rate      reads/s/device (weak-scaling efficiency =
                    rate(n)/rate(1))
  host_frac         serial host fraction: time in host-only phases
                    (host_submit/collect/replay/fallback/emit) over wall

Virtual CPU devices share the same cores, so absolute rates are
meaningless; what this measures is the SHARDING overhead structure —
collective/partition cost growth and the serial host fraction that
bounds real-chip scaling by Amdahl. Results append to
/tmp/pansvr_multichip_scaling.json and are summarized in PERF.md.

Usage: python tools/multichip_scaling.py [per_dev] [counts_csv]
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD_SRC = """
import os, sys, time, json
n = int(sys.argv[1]); per_dev = int(sys.argv[2])
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (
    flags + f" --xla_force_host_platform_device_count={n}").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "@@REPO@@")
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from jax.sharding import Mesh
from __graft_entry__ import _build_world
from pansvr_tpu.align.engine import AlignEngine, EngineConfig
from pansvr_tpu.align.host_align import OriResult

B = n * per_dev
idx, didx, codes, words, lens = _build_world(
    B=B, L=160, n_contigs=8, contig_len=20000, seed=11)
seqs = ["".join("ACGT"[c] for c in row) for row in codes]
oris = [OriResult(unmapped=True)] * len(seqs)
mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("data",))
cfg = EngineConfig(stream_depth=2)
eng = AlignEngine(idx, config=cfg, mesh=mesh)

def batches():
    step = max(1024, B // 4)
    for i in range(0, B, step):
        yield seqs[i:i+step], oris[i:i+step]

# warm-up compile pass
for _ in eng.align_stream(batches()):
    pass
eng.prof.clear()
t0 = time.perf_counter()
out = []
for states in eng.align_stream(batches()):
    out.extend(states)
wall = time.perf_counter() - t0
host_keys = ("host_submit", "host_collect", "host_replay",
             "host_fallback")
host_s = sum(float(eng.prof.get(k, 0.0)) for k in host_keys)
print(json.dumps(dict(
    n=n, B=B, wall_s=round(wall, 3),
    reads_per_s=round(B / wall, 1),
    per_dev_rate=round(B / wall / n, 1),
    host_s=round(host_s, 3),
    host_frac=round(host_s / wall, 3) if wall > 0 else 0.0,
    n_aligned=sum(bool(s.results) for s in out),
)))
""".replace("@@REPO@@", REPO)


def main():
    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    counts = [int(c) for c in (sys.argv[2].split(",")
                               if len(sys.argv) > 2 else ("1", "2", "4", "8"))]
    rows = []
    for n in counts:
        r = subprocess.run(
            [sys.executable, "-c", CHILD_SRC, str(n), str(per_dev)],
            capture_output=True, text=True)
        line = [l for l in r.stdout.splitlines() if l.startswith("{")]
        if not line:
            print(f"n={n}: FAILED\n{r.stderr[-2000:]}", file=sys.stderr)
            continue
        row = json.loads(line[-1])
        rows.append(row)
        base = rows[0]["per_dev_rate"] if rows else 1
        eff = row["per_dev_rate"] / base if base else 0
        print(f"n={row['n']}: B={row['B']} wall={row['wall_s']}s "
              f"{row['reads_per_s']} reads/s "
              f"({row['per_dev_rate']}/dev, weak-eff {eff:.2f}) "
              f"host_frac={row['host_frac']}", flush=True)
    with open("/tmp/pansvr_multichip_scaling.json", "w") as fh:
        json.dump(rows, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
