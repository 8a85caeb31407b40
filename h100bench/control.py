"""The check's control and faults, read at a cell's own size, for its limits.

    python3 h100bench/control.py --workload resnet18.s3-80ms --seeds 101 102 103

For each seed: the reference in float32 (the truth), the reference at the
configuration's ``control_precision`` (the precision below the one it
states) put in the program's place, and the reference with each fault a
training cell can have (half of the batch left out, one answer altered
where it is produced), each compared with the truth by the numbers that
decide ``correct``.  A step that leaves its state unchanged reads 1 in
``change_gap`` by construction and needs no run.  One JSON line a seed.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

import torch  # noqa: E402

from benchlib import check  # noqa: E402
from benchlib.data import make_image_pool, make_token_set  # noqa: E402
from benchlib.manifest import load_cell  # noqa: E402

FAULTS = ("half_batch", "altered")


def readings(cell, seed: int, device: torch.device) -> dict:
    cfg, traffic = cell.config, cell.traffic
    steps = cfg["bench"]["checked_steps"]
    inputs = (make_image_pool(seed, traffic["images"]) if cfg["family"] == "resnet"
              else make_token_set(seed, traffic["tokens"], cfg["vocab_size"]))
    truth = check.reference_readings(cfg, traffic, seed, device, inputs, steps)
    out = {"seed": seed}
    sides = [("control", cfg["control_precision"], "")] + [(f, "float32", f) for f in FAULTS]
    for name, precision, fault in sides:
        t0 = time.monotonic()
        got = check.reference_readings(cfg, traffic, seed, device, inputs, steps,
                                       precision, fault)
        out[name] = check.numbers(cfg, got, truth, steps)
        out[name]["seconds"] = time.monotonic() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(HERE.parent, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
