"""Worker for the 2-process jax.distributed CPU dryrun
(tests/test_distributed.py). Each process contributes 2 virtual CPU
devices to a 4-device global 'data' mesh and runs the engine's REAL
sharded front program (align.engine._sharded_front) on a global batch;
every process checks its addressable output shards against a
single-device reference computed locally. Exit 0 = parity.

Usage: dist_worker.py <coordinator> <num_processes> <process_id>
"""

import os
import sys

# tests/test_distributed.py sets JAX_PLATFORMS/XLA_FLAGS in the spawn
# environment; these are a fallback for direct invocation.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=2")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import jax

    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=n_proc, process_id=pid)
    assert jax.process_count() == n_proc, jax.process_count()
    assert len(jax.devices()) == 2 * n_proc, len(jax.devices())

    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pansvr_tpu.align import engine as E
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.index.device import to_device
    from pansvr_tpu.ops.seeding import (
        merge_expand_device3, pack_reads, seed_reads_flat)
    from pansvr_tpu.utils import dna

    # deterministic tiny world, identical on every process
    rng = np.random.default_rng(11)
    contig = "".join(rng.choice(list("ACGT"), 4000))
    idx = build_index([("c0_0_1_100_DEL_500_600_4000_sv0", contig)],
                      first_level_bases=11)
    didx = to_device(idx)

    B, L = 16, 120
    reads = []
    for _ in range(B):
        p = int(rng.integers(0, len(contig) - L))
        codes = dna.encode(contig[p : p + L])
        m = rng.random(L) < 0.02
        codes[m] = (codes[m] + 1) % 4
        reads.append(codes)
    words = pack_reads(np.stack(reads))
    lens = np.full(B, L, np.int32)
    S0 = (L - idx.search_k) // 5 + 1
    mask = np.ones((B, S0), bool)

    mesh = Mesh(np.array(jax.devices()), ("data",))

    def to_global(arr, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda i: np.asarray(arr[i]))

    didx_g = jax.tree.map(lambda a: to_global(np.asarray(a), P()), didx)
    words_g = to_global(words, P("data"))
    lens_g = to_global(lens, P("data"))
    mask_g = to_global(mask, P("data"))

    S, M = 32, 32
    fr = E._sharded_front(mesh, S0, S, M, "v5", 9, 32)
    es, stats3 = fr(didx_g, words_g, lens_g, mask_g)

    # single-device reference (local, no mesh)
    sb_ref = seed_reads_flat(didx, words, lens, mask, S0=S0, M=M,
                             n_ext_steps=9, nf_mult=32)
    es_ref = merge_expand_device3(sb_ref, didx, S=S)

    for name in ("read_begin", "read_end", "ref_begin", "ref_end",
                 "cov", "valid"):
        got = getattr(es, name)
        want = np.asarray(getattr(es_ref, name))
        for shard in got.addressable_shards:
            rows = shard.index[0]
            assert np.array_equal(np.asarray(shard.data), want[rows]), (
                f"proc {pid}: field {name} shard {shard.index} differs")
    print(f"dist_worker {pid}: parity OK over "
          f"{jax.process_count()} processes / {len(jax.devices())} devices")


if __name__ == "__main__":
    main()
