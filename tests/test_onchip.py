"""Device DP parity gate (ops/onchip_check.py).

On the card (`python -m pytest tests/test_onchip.py -m gpu`) the full
gate compiles the scan DP for the GPU at every engine class and both
scoring profiles. On the CPU the same code runs at the smallest class
and as the sharded program on the 8-device virtual mesh."""

import numpy as np
import pytest

from pansvr_tpu.ops.onchip_check import (
    ALN,
    check_sharded_dp,
    class_pairs,
    run_onchip_parity,
)


@pytest.mark.gpu
def test_gpu_compiled_parity():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("no GPU visible")
    out = run_onchip_parity()
    for row in out["classes"]:
        print(f"[gate] {row}")
    assert len(out["classes"]) == 4
    assert all(r["mismatches"] == 0 for r in out["classes"])


def test_gate_smallest_class_cpu():
    out = run_onchip_parity(quick=True)
    (row,) = out["classes"]
    assert (row["Q"], row["T"], row["lanes"]) == (48, 64, 2048)
    assert row["mismatches"] == 0


def test_sharded_scan_dp_parity():
    """shard_map'd scan DP over the 8 virtual devices equals the
    single-device program bit-for-bit and the oracle lane-for-lane."""
    rng = np.random.default_rng(3)
    n = check_sharded_dp(class_pairs(rng, 176, 256, 12), ALN)
    assert n == 8 * 16, "expected the 8-device virtual mesh"
