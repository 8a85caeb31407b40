"""Fault tolerance end to end, two scenarios: the port's twin of the
reference's ``examples/elastic_restart.py``.

Scenario 1, checkpoint/restart (single host, exact resume):
1. Run A trains 12 steps with a checkpoint every 4 (its "node" then fails).
2. A fresh trainer, from a junk init, restores the step-8 checkpoint: the
   model and optimizer state AND the loader cursor, and replays steps 9-12.
3. An uninterrupted run B trains 12 steps.
4. The resumed losses equal B's at every step (within ``rel=1e-5``, the
   reference test's tolerance): the deterministic resumable sampler and the
   in-order loader make checkpoint/restart exact.

Scenario 2, elastic fleet (lease-based membership, union-exact epoch), on
the port's :mod:`repro_torch.core.elastic`:
1. Host A joins an elastic coord dir, claims shards from the shared epoch
   board, consumes 3 batches, then leaves cleanly.
2. Host B joins the SAME epoch, takes over A's unfinished shards at their
   confirmed cursors, and drains the rest.
3. The union of A's and B's batches equals the batch set one uncoordinated
   loader produces: nothing lost, nothing made up.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import shutil
import tempfile
from typing import List, Optional

import torch

from repro_torch.config import AttentionConfig, ElasticConfig, LoaderConfig, ModelConfig, TrainConfig
from repro_torch.core.loader import ConcurrentDataLoader
from repro_torch.data.dataset import ImageDataset, SyntheticTokenDataset
from repro_torch.data.imagenet_synth import SyntheticImageStore
from repro_torch.data.store import SimulatedS3Store
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import CheckpointCallback, Trainer

CFG = ModelConfig(
    name="lm-tiny", family="decoder", num_layers=2, d_model=128, d_ff=512, vocab_size=1024,
    attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=32),
)
TCFG = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=2)
STEPS, CKPT_EVERY = 12, 4


def make_loader() -> ConcurrentDataLoader:
    return ConcurrentDataLoader(
        SyntheticTokenDataset(256, 128, CFG.vocab_size),
        LoaderConfig(impl="threaded", batch_size=8, num_workers=2, num_fetch_workers=4, seed=7),
    )


def init_state(seed: int, device: torch.device):
    return init_train_state(CFG, TCFG, torch.Generator(device).manual_seed(seed), device)


def losses_of(history) -> List[float]:
    return [h["loss"] for h in history]


def checkpoint_restart_scenario(device: torch.device) -> dict:
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        # run A: 12 steps; only its step-8 checkpoint is used below
        loader = make_loader()
        manager = CheckpointManager(ckpt_dir, keep=10)
        trainer = Trainer(make_train_step(CFG, TCFG), init_state(0, device),
                          callbacks=[CheckpointCallback(manager, CKPT_EVERY, loader=loader)],
                          device=device)
        res_a = trainer.fit(loader, epochs=100, max_steps=STEPS)
        manager.wait()
        print(f"run A: {res_a.steps} steps, checkpoints at {manager.steps()}")

        # restart: fresh trainer from a junk init, restore the step-8 checkpoint
        loader2 = make_loader()
        manager2 = CheckpointManager(ckpt_dir, keep=10)
        trainer2 = Trainer(make_train_step(CFG, TCFG), init_state(99, device), device=device)
        trainer2.state, meta = manager2.restore(trainer2.state, step=8)
        trainer2.global_step = meta["step"]
        loader2.load_state_dict(meta["extra"]["loader"])
        print(f"restart: restored step {meta['step']}, loader cursor {meta['extra']['loader']}")
        res_resumed = trainer2.fit(loader2, epochs=100, max_steps=STEPS,
                                   start_epoch=meta["extra"]["loader"]["epoch"])

        # run B: uninterrupted
        res_b = Trainer(make_train_step(CFG, TCFG), init_state(0, device),
                        device=device).fit(make_loader(), epochs=100, max_steps=STEPS)

        tail_b = losses_of(res_b.history)[8:]
        tail_resumed = losses_of(res_resumed.history)
        print(f"reference  steps 9-12 losses: {[round(x, 6) for x in tail_b]}")
        print(f"resumed    steps 9-12 losses: {[round(x, 6) for x in tail_resumed]}")
        assert len(tail_b) == len(tail_resumed) == STEPS - 8, (tail_b, tail_resumed)
        assert all(math.isclose(a, b, rel_tol=1e-5) for a, b in zip(tail_b, tail_resumed)), \
            "resume diverged from the uninterrupted run!"
        print("PASS: the interrupted and resumed run equals the uninterrupted run")
        return {"checkpoints": manager.steps(), "reference": tail_b, "resumed": tail_resumed}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# --- scenario 2: elastic fleet ---------------------------------------------
N_ITEMS, BATCH = 96, 8


def make_image_dataset() -> ImageDataset:
    store = SyntheticImageStore(N_ITEMS, seed=0, avg_kb=2)
    sim = SimulatedS3Store(store, latency_mean_s=0.002, bandwidth_per_conn=1e9,
                           max_connections=64)
    return ImageDataset(sim, N_ITEMS, out_size=16)


def make_elastic_loader(coord_dir: str, host: int) -> ConcurrentDataLoader:
    cfg = LoaderConfig(
        impl="threaded", batch_size=BATCH, num_workers=2, num_fetch_workers=4, seed=7,
        elastic=ElasticConfig(enabled=True, coord_dir=coord_dir, lease_ttl_s=5.0,
                              heartbeat_interval_s=0.2, shard_batches=2, claim_poll_s=0.01),
    )
    return ConcurrentDataLoader(make_image_dataset(), cfg, host_id=host, num_hosts=1)


def batch_key(b) -> tuple:
    return tuple(sorted(float(x) for x in b["image"].sum(axis=(1, 2, 3))))


def elastic_fleet_scenario() -> dict:
    coord_dir = tempfile.mkdtemp(prefix="repro_torch_fleet_")
    try:
        # host A: join, consume 3 batches, leave mid-epoch
        dl_a = make_elastic_loader(coord_dir, host=0)
        it = iter(dl_a)
        first = [batch_key(next(it)) for _ in range(3)]
        it.shutdown()
        dl_a.release_coordination()  # a clean leave: its claims are reapable at once
        print(f"host A delivered {len(first)} batches, then left")

        # host B: join the same epoch, drain what the board still owes
        dl_b = make_elastic_loader(coord_dir, host=1)
        rest = [batch_key(b) for b in dl_b]
        dl_b.release_coordination()
        print(f"host B took over and delivered {len(rest)} batches")

        # the union must match what one uncoordinated loader produces
        ref = sorted(batch_key(b) for b in ConcurrentDataLoader(
            make_image_dataset(),
            LoaderConfig(impl="threaded", batch_size=BATCH, num_workers=2,
                         num_fetch_workers=4, seed=7)))
        union = sorted(set(first) | set(rest))
        assert union == ref, "handoff lost or fabricated batches!"
        dup = len(first) + len(rest) - len(set(first) | set(rest))
        print(f"PASS: union of A+B covers the epoch exactly "
              f"({len(ref)} batches, {dup} at-least-once duplicate(s))")
        return {"first": len(first), "rest": len(rest), "batches": len(ref), "duplicates": dup}
    finally:
        shutil.rmtree(coord_dir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("=== scenario 1: checkpoint/restart (exact resume) ===")
    restart = checkpoint_restart_scenario(device)
    print("\n=== scenario 2: elastic fleet (union-exact handoff) ===")
    fleet = elastic_fleet_scenario()
    return {"restart": restart, "fleet": fleet}


if __name__ == "__main__":
    main()
