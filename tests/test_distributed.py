"""Multi-host execution evidence for the shard_map programs: two OS
processes under jax.distributed form one 4-device CPU mesh and run the
engine's real sharded front (align.engine._sharded_front) on a global
batch, each asserting parity of its addressable shards against a
single-device reference (tests/dist_worker.py). This validates the
claim in parallel/mesh.py that the same shard_map program runs under
jax.distributed — the CPU-mesh analog of a 2-host deployment
(real multi-host pods are unavailable in this environment)."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(420)
def test_two_process_distributed_front():
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=360)
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert "parity OK over 2 processes / 4 devices" in out, out[-1500:]
