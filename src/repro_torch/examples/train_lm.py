"""Train a language model end to end through the concurrent data pipeline:
the port's twin of the reference's ``examples/train_lm.py``.

Default: a ~10M-parameter decoder for 30 steps.  ``--model-100m --steps
300`` trains a ~100M-parameter GQA decoder for a few hundred steps.

Demonstrates: packed-token object store behind simulated S3 ->
ConcurrentDataLoader (threaded fetchers, hedged requests) -> device
prefetch ring -> train step with gradient accumulation -> asynchronous
checkpoints (:class:`~repro_torch.train.checkpoint.CheckpointManager`).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--model-100m] [--steps N]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 4 --items 32
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch.config import AttentionConfig, LoaderConfig, ModelConfig, StoreConfig, TrainConfig
from repro_torch.core import make_loader
from repro_torch.core.tracing import Tracer
from repro_torch.data.dataset import TokenDataset, build_token_store
from repro_torch.data.store import InMemoryStore, build_store
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import CheckpointCallback, LoggingCallback, Trainer, TrainResult
from repro_torch.tree import leaves


def model_cfg(big: bool) -> ModelConfig:
    if big:  # ~100M params
        return ModelConfig(
            name="lm-100m", family="decoder", num_layers=12, d_model=768, d_ff=2048,
            vocab_size=32_000,
            attention=AttentionConfig(kind="gqa", num_heads=12, num_kv_heads=4, head_dim=64),
        )
    return ModelConfig(  # ~10M params
        name="lm-10m", family="decoder", num_layers=4, d_model=256, d_ff=1024,
        vocab_size=8_000,
        attention=AttentionConfig(kind="gqa", num_heads=8, num_kv_heads=4, head_dim=32),
    )


def main(argv: Optional[List[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_cfg(args.model_100m)
    tcfg = TrainConfig(optimizer="adamw", learning_rate=3e-4, microbatches=args.microbatches,
                       warmup_steps=10, total_steps=max(args.steps, 20))
    tracer = Tracer()
    base = InMemoryStore()
    build_token_store(base, args.items, args.seq_len, cfg.vocab_size)
    store = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02), base=base)
    dataset = TokenDataset(store, args.items, args.seq_len, tracer=tracer)
    loader = make_loader(
        LoaderConfig(impl="threaded", batch_size=args.batch_size, num_workers=4,
                     num_fetch_workers=16, hedge_requests=True),
        dataset, tracer=tracer,
    )
    state = init_train_state(cfg, tcfg, torch.Generator(device).manual_seed(0), device)
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"{cfg.name}: {n/1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch_size}x{args.seq_len} tokens, threaded loader over s3sim, "
          f"device {device}", flush=True)

    manager = CheckpointManager(args.ckpt_dir, keep=2)
    trainer = Trainer(
        make_train_step(cfg, tcfg), state,
        callbacks=[
            LoggingCallback(log_every_n_steps=10, sink=lambda s: print("  " + s, flush=True)),
            CheckpointCallback(manager, every_steps=max(args.steps // 2, 10), loader=loader),
        ],
        tracer=tracer, device=device,
    )
    try:
        res = trainer.fit(loader, epochs=1_000_000, max_steps=args.steps)
    finally:
        loader.close()
    manager.wait()
    toks = res.steps * args.batch_size * args.seq_len
    print(f"\ndone: loss {res.history[0]['loss']:.3f} -> {res.last_metrics['loss']:.3f} "
          f"in {res.wall_s:.1f}s ({toks/res.wall_s:.0f} tok/s); checkpoint at {args.ckpt_dir}")
    return res


if __name__ == "__main__":
    main()
