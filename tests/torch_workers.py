"""Launcher of the port's multi-process tests: N copies of a test file run
as a script (``python tests/test_torch_x.py worker MODE RANK WORLD PORT
OUT [ARGS...]``), joined over gloo at a free localhost port.  Each worker
imports only torch and the port (no conftest, no JAX); each has a
timeout, and all are killed on the first failure."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from godot_whisper_tpu_torch.parallel import procs  # noqa: E402
from godot_whisper_tpu_torch.parallel.procs import free_port  # noqa: E402,F401


def worker_env(threads: int = 1) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(threads)
    env.pop("XLA_FLAGS", None)
    return env


def run_procs(cmds, log_dir: str, timeout: float = 300.0, env=None):
    """``procs.run_procs`` from the repo's root with the workers'
    environment; a failed process fails the test."""
    try:
        return procs.run_procs(cmds, log_dir, timeout=timeout,
                               env=env or worker_env(), cwd=REPO)
    except RuntimeError as e:
        raise AssertionError(str(e)) from None


def run_workers(script: str, mode: str, world: int, out_dir: str,
                *args, timeout: float = 300.0):
    """``world`` workers of ``script`` in ``mode``; worker r writes under
    ``out_dir`` (by its own naming)."""
    port = free_port()
    cmds = [[sys.executable, script, "worker", mode, str(r), str(world),
             str(port), str(out_dir), *map(str, args)]
            for r in range(world)]
    return run_procs(cmds, out_dir, timeout=timeout)


def worker_args(argv):
    """(mode, rank, world, port, out_dir, extra args) of a worker's
    command line."""
    mode, rank, world, port, out = argv[2:7]
    return mode, int(rank), int(world), int(port), out, argv[7:]


def init_gloo(rank: int, world: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
