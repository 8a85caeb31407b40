"""The port's benchmark: one run of one cell, from the root of a checkout.

    python3 h100bench/run.py --workload resnet18.s3-80ms --seed 7 --seconds 30 --trace 0

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``.  Exits non-zero, and
prints no result, without enough cards, or if JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the monotonic clock (Linux: /proc/self/stat)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_environment() -> None:
    """Every cache in fixed directories of the checkout; the port's package
    and this folder on the path."""
    cache = HERE / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """JAX or the JAX package in this process, by whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card() -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out["power_limit"] = "unknown"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_environment()
    from benchlib.manifest import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    from benchlib import harness, result

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                      T_START, trace_dir=HERE / "_traces")
    found = forbidden_modules()
    if found:
        print(f"h100bench: {', '.join(found)} loaded in the benchmark's process", file=sys.stderr)
        return 4
    line = result.result_line(cell, out, bool(args.trace), _card())
    result.print_checks(out["numbers"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
