"""Multi-process execution test: 2 processes x 4 virtual CPU devices.

Proves the code path a multi-host deployment uses — per-process
``jax.distributed.initialize`` (local coordinator), a process-spanning
global mesh, ``shard_map`` + collectives crossing process boundaries —
by spawning two worker subprocesses (``tests/_dist_worker.py``) that run
the dp and halo PFDR solvers on the same problem and compare against
single-process solutions.

The reference has no multi-process capability of any kind (SURVEY §2.6);
this is a new-framework capability.
"""
import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_dp_and_halo_solvers():
    nproc = 2
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)        # workers set their own device count
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep
        + env.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests._dist_worker", str(pid),
             str(nproc), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(nproc)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"worker {pid} output:\n{out}"
