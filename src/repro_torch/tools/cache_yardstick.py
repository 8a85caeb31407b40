"""The paper's cache claim on one CUDA card: does the ResNet path trained from
simulated S3 behind a cache run "as if the data were on local drives"?

    PYTHONPATH=src python -m repro_torch.tools.cache_yardstick 3

Runs chip_smoke's main cell (full-width ResNet-18, SGD, batch 64, 1024
items of 115 KB, 20 ms GETs, 4 workers x 16 fetchers, ``--device-ingest``)
for 6 epochs (96 steps) three ways: from simulated S3 (``uncached``),
behind a 256 MiB memory cache tier that holds the whole set
(``cache_mb``), and from memory (``store_memory``, the local-drive
yardstick); the three in turns, the order rotated each round, for the
rounds given (default 3).  Prints the card's name and power limit, then one
JSON line a run (items/s of each epoch, the card's busy share, the s3sim
GETs of the run) and a last line with, per way, the median items/s of
epochs 2-6 over all rounds.  Epoch 1 runs from the first step's start and
holds the cache's fill, so it is left out.

Imports nothing of JAX and nothing of the JAX package.  Needs a card
unless ``--device cpu`` is among the extra launcher flags, which follow the
rounds and override the cell's (a rehearsal: ``1 --device cpu --smoke
--items 32 --batch-size 8 --steps 12``).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

CELL = [
    "--arch", "resnet18-imagenet", "--full", "--device", "cuda", "--device-ingest",
    "--items", "1024", "--avg-kb", "115", "--batch-size", "64",
    "--latency", "0.02", "--loader", "threaded", "--workers", "4", "--fetchers", "16",
    "--steps", "96", "--epochs", "6", "--optimizer", "sgd", "--log-every", "96",
]
WAYS = {"uncached": [], "cache_mb": ["--cache-mb", "256"], "store_memory": ["--store", "memory"]}


def epoch_rates(tracer, per_epoch: int, batch: int) -> list:
    """Items/s of each epoch: its steps' items over the time from the end of
    the previous epoch's last step (the first step's start for epoch 1) to
    the end of its own last step."""
    spans = sorted(tracer.spans("run_training_batch"), key=lambda sp: sp.t0)
    out, start = [], spans[0].t0 if spans else 0.0
    for i in range(0, len(spans), per_epoch):
        chunk = spans[i:i + per_epoch]
        out.append(len(chunk) * batch / (chunk[-1].t1 - start))
        start = chunk[-1].t1
    return out


def gets(store) -> int:
    """GETs that reached the simulated S3 store under ``store``."""
    while store is not None:
        if hasattr(store, "stats"):
            return store.stats.gets
        store = getattr(store, "base", None)
    return 0


def run_way(way: str, extra: list, rnd: int) -> dict:
    from repro_torch.launch import train as launch

    args = CELL + WAYS[way] + extra
    parsed = launch.parse_args(args)
    report = launch.run(args)
    rates = epoch_rates(report.tracer, parsed.items // parsed.batch_size, parsed.batch_size)
    return {"round": rnd, "way": way, "args": args, "steps": report.result.steps,
            "items_per_s_per_epoch": rates, "items_per_s": report.items_per_s,
            "busy_fraction": report.util.busy_fraction,
            "s3_gets": gets(report.loader.dataset.store)}


def main(argv: list) -> int:
    import torch

    rounds = int(argv[0]) if argv else 3
    extra = list(argv[1:])
    if "cpu" not in extra:
        if not torch.cuda.is_available():
            raise SystemExit("cache_yardstick needs a CUDA card")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(),
              flush=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    ways = list(WAYS)
    later = {way: [] for way in ways}
    for rnd in range(rounds):
        for way in ways[rnd % len(ways):] + ways[:rnd % len(ways)]:
            out = run_way(way, extra, rnd)
            later[way] += out["items_per_s_per_epoch"][1:]
            print(json.dumps(out), flush=True)
    print(json.dumps({"median_items_per_s_epochs_2_on": {
        way: statistics.median(r) if r else None for way, r in later.items()},
        "epochs_counted": {way: len(r) for way, r in later.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
