"""Test configuration: the suite runs on the CPU backend with 8 virtual
devices, so the multi-device paths (jax.sharding.Mesh / shard_map) run
without a GPU.

Tests marked `gpu` need the card: `python -m pytest tests -m gpu` leaves
the default backend alone, and each such test skips itself when no GPU
is visible (so it skips in the CPU run)."""

import os


def pytest_configure(config):
    if config.option.markexpr.strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
