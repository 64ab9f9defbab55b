"""Running a set of processes together, for a multi-process run on one
machine (the ranks of a ``torch.distributed`` world joined at a
localhost port): each has a timeout, and all are killed on the first
failure.  ``tests/torch_workers.py`` and ``chip_smoke.py``'s phase 16
launch their ranks through it."""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    """A free localhost TCP port (bound to 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(cmds: Sequence[Sequence[str]], log_dir: str,
              timeout: float = 300.0, env: Optional[dict] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run every command at once, each one's output to
    ``log_dir/proc{i}.log``; returns the outputs.  The first to fail or
    outlive ``timeout`` seconds kills the rest, and then this raises
    RuntimeError with that process's output."""
    paths = [os.path.join(log_dir, f"proc{i}.log") for i in range(len(cmds))]
    files = [open(p, "w") for p in paths]
    procs = [subprocess.Popen(list(c), env=env, cwd=cwd, stdout=f,
                              stderr=subprocess.STDOUT)
             for c, f in zip(cmds, files)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    logs = []
    for path in paths:
        with open(path, errors="replace") as f:
            logs.append(f.read())
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"process {i} of {len(procs)} exited {p.returncode} "
                f"(timeout {timeout} s):\n{logs[i][-6000:]}")
    return logs
