"""Helpers of the port's multi-rank tests: worlds of CPU processes on
gloo, and the reference's side on forced host devices.

A world is `n` Python processes, each running the same code with
``sys.argv[1:] == [rank, n, init_file, out_dir]``; they meet through
``init_method=file://init_file`` (no TCP port, so parallel test workers
cannot collide) and each runs with one intra-op thread.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLD_PRELUDE = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, INIT, OUT = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + INIT, rank=RANK,
                        world_size=WORLD)
"""


def start_world(n: int, code: str, out_dir: str):
    """Start `n` ranks of WORLD_PRELUDE + `code`; returns the processes."""
    init = os.path.join(out_dir, "pg_init")
    if os.path.exists(init):
        os.unlink(init)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    src = WORLD_PRELUDE + textwrap.dedent(code)
    return [subprocess.Popen([sys.executable, "-c", src, str(r), str(n), init,
                              out_dir], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(n)]


def start_python(code: str, env_extra=None):
    """One Python process running `code` with the repository's src on its
    path (and `env_extra` in its environment)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               **(env_extra or {}))
    return [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)]


def finish(procs, timeout: float) -> list:
    """Wait for every process (killing all of them past `timeout`
    seconds); raise with the first failure's stderr.  Returns stdouts."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"rc {p.returncode}:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def reference_env(devices: int) -> dict:
    """The environment of a reference subprocess with `devices` forced
    host devices (set before its first jax import)."""
    return {"XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
            "JAX_PLATFORMS": "cpu"}
