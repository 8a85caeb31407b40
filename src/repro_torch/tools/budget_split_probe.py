"""Which ways the autotuner probes the thread budget's IO/CPU split, on one
CUDA card, at the budgets given.

    PYTHONPATH=src python -m repro_torch.tools.budget_split_probe 68 68 65

Runs chip_smoke's ``--thread-budget`` run once per budget, in the order
given: full-size ResNet-18 through the staged pipeline, 8192 items of
115 KB behind simulated S3 at 20 ms, batch 64, 384 steps over 3 epochs.
Prints one JSON line a run: the split's probes as (batch, value before,
value probed), whether they went both ways, the split's events, io + cpu
workers at each epoch's end, items/s after the first step and the card's
busy share.  Prints the card's name and power limit first.

Imports nothing of JAX and nothing of the JAX package.  Needs a card.
"""
from __future__ import annotations

import json
import subprocess
import sys

# chip_smoke's AUTO_ARGS (its MAIN_ARGS at 8192 items, 384 steps, through
# the pipeline with 4 staging buffers)
ARGS = [
    "--full", "--device", "cuda", "--device-ingest",
    "--items", "8192", "--avg-kb", "115", "--batch-size", "64",
    "--latency", "0.02", "--loader", "threaded", "--workers", "4", "--fetchers", "16",
    "--steps", "384", "--optimizer", "sgd", "--log-every", "128",
    "--pipeline", "--staging-buffers", "4",
]


def budget_run(budget: int) -> dict:
    from repro_torch.core.autotune import AutotuneController
    from repro_torch.launch import train as launch

    probes, log = [], AutotuneController._log

    def logging(ctrl, action, knob, value, tput):
        if action == "probe" and knob == "io_cpu_split":
            probes.append([ctrl._batches, ctrl._probe.old_value, ctrl._probe.new_value])
        return log(ctrl, action, knob, value, tput)

    AutotuneController._log = logging
    try:
        report = launch.run(ARGS + ["--thread-budget", str(budget)])
    finally:
        AutotuneController._log = log
    ends = sorted(sp.t1 for sp in report.tracer.spans("run_training_batch"))
    return {
        "budget": budget, "split_probes": probes,
        "both_ways": {new > old for _, old, new in probes} == {True, False},
        "split_events": [[e.batch, e.action, e.value, e.tput]
                         for e in report.loader.autotuner.events if e.knob == "io_cpu_split"],
        "io_plus_cpu_per_epoch": [st["io_workers"] + st["cpu_workers"]
                                  for st in report.stages],
        "items_per_s_after_first_step": (len(ends) - 1) * 64 / (ends[-1] - ends[0]),
        "busy_fraction": report.util.busy_fraction,
    }


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("budget_split_probe needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    for budget in [int(b) for b in argv] or [68]:
        print(json.dumps(budget_run(budget)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
