"""Multi-device / multi-host sharding for the realignment pipeline.

The reference's parallelism is single-node (kt_for threads + bash
fan-out, SURVEY.md §2.2); the device scale-out replaces it with:

  - data parallelism over a device mesh for the realignment inner loop:
    reads sharded over the 'data' axis, the RdBG index replicated per
    device, per-shard statistics merged with psum;
  - region sharding for SV calling across hosts (the analog of the
    reference's per-chromosome fc_sv fan-out, panSVR_run.sh:61-91):
    contiguous anchor-contig ranges per worker, VCF parts concatenated.

Multi-host execution uses the same shard_map program under
jax.distributed initialization; this module only fixes the shardings
(reads never cross hosts; only scalar stats do).
Validated by tests/test_distributed.py: two OS processes under
jax.distributed form one 4-device CPU mesh and run the engine's sharded
front with per-shard parity against a single-device reference.
"""

from __future__ import annotations

import numpy as np


def make_data_mesh(n_devices: int | None = None):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def sharded_realign_front(mesh, didx, S0: int, S: int):
    """Build a jitted, mesh-sharded version of the engine's front program
    (seeding + merge/expand + stats): reads data-parallel, index
    replicated, per-shard seed counts psum-reduced into a global total.

    Returns fn(words, lens, mask) -> (DeviceSeeds, stats3, total_seeds).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.seeding import merge_expand_device3, seed_reads

    def step(words, lens, mask):
        sb = seed_reads(didx, words, lens, mask, S0=S0)
        es = merge_expand_device3(sb, didx, S=S)
        stats3 = jnp.stack([
            sb.n_overflow,
            es.n_dropped.astype(jnp.int32),
            es.valid.sum(axis=1).astype(jnp.int32),
        ])
        total = jax.lax.psum(es.valid.sum(), "data")
        return es, stats3, total

    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"), P(None, "data"), P()),
        check_vma=False,
    ))


def shard_sv_regions(n_sv: int, n_shards: int, shard_id: int) -> range:
    """Contiguous anchor-contig range for one fc_sv worker (the
    chromosome-range analog of generateVCFoptions' -S/-E options)."""
    per = (n_sv + n_shards - 1) // n_shards
    lo = shard_id * per
    return range(lo, min(lo + per, n_sv))


def merge_vcf_parts(part_paths: list[str], out_path: str):
    """Concatenate per-shard VCF parts (the driver's `cat vcfparts`
    merge, panSVR_run.sh:93-95 — with the `>`-vs-`>>` bug fixed)."""
    header_written = False
    with open(out_path, "w") as out:
        for p in part_paths:
            with open(p) as fh:
                for line in fh:
                    if line.startswith("#"):
                        if not header_written:
                            out.write(line)
                        continue
                    out.write(line)
            header_written = True
