"""Spawning a ``torch.distributed`` world of CPU processes for the
data-parallel tests (``tests/test_torch_dp.py``, ``test_torch_delivery.py``,
``test_torch_launch.py``).

Each rank is ``python -c <code> <args>`` with torchrun's environment set
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and ``PYTHONPATH`` at ``src``; the
code joins the group at the ``file://`` rendezvous it is given (a path under
the test's ``tmp_path``, never a TCP port).  :func:`start_world` returns the
live processes, :func:`finish_world` waits for them under one deadline and
kills every rank still running, so a hung collective fails one test instead
of the whole run.
"""
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]


def rank_env(rank: int, world: int, extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(ROOT / "src"), RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
    env.update(extra or {})
    return env


def start_world(argv: Sequence[str], world: int,
                extra_env: Optional[Dict[str, str]] = None) -> List[subprocess.Popen]:
    """``world`` ranks of ``python argv...``, started together."""
    return [subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
                             env=rank_env(r, world, extra_env))
            for r in range(world)]


def finish_world(procs: List[subprocess.Popen], timeout_s: float) -> List[Tuple[int, str, str]]:
    """(returncode, stdout, stderr) of every rank; a rank still running at
    the deadline is killed (and reported with its kill's return code)."""
    deadline = time.monotonic() + timeout_s
    out = []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
                e += f"\n[killed after {timeout_s} s]"
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def run_world(argv: Sequence[str], world: int, timeout_s: float,
              extra_env: Optional[Dict[str, str]] = None) -> List[Tuple[int, str, str]]:
    return finish_world(start_world(argv, world, extra_env), timeout_s)


def init_url(tmp: Path, name: str = "rendezvous") -> str:
    """A fresh ``file://`` rendezvous under ``tmp``."""
    path = tmp / name
    if path.exists():
        path.unlink()
    return f"file://{path}"
