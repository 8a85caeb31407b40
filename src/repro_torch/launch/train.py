"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-imagenet --full \
        --device-ingest --items 1024 --batch-size 64 --avg-kb 115 --steps 48 --optimizer sgd
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-imagenet --full \
        --device-ingest --items 1024 --batch-size 64 --avg-kb 115 --steps 48 --optimizer sgd \
        --cache-mb 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --device cpu \
        --items 16 --batch-size 4 --seq-len 64 --steps 4 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-imagenet --device cpu \
        --device-ingest --items 32 --batch-size 8 --steps 6 --optimizer sgd --pipeline \
        --staging-buffers 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-imagenet --device cpu \
        --device-ingest --items 256 --batch-size 8 --steps 64 --optimizer sgd --pipeline \
        --autotune

Wires the stack together: a synthetic dataset in an object store behind
simulated S3 -> dataset -> ``make_loader`` (the paper's loader, or with
``--pipeline`` the staged pipeline, collating into pinned staging buffers
with ``--staging-buffers N``) -> device prefetch ring (H2D, then the
``ingest_norm`` kernel with ``--device-ingest``) -> train step -> Trainer,
and prints the paper's Table-3 columns (throughput + accelerator busy
stats) and, with ``--pipeline``, the per-stage stats at the end.
``--autotune`` moves the loader's knobs online between batches (and
``--thread-budget N`` co-tunes the pipeline's io/cpu split under N threads);
``--hedge`` duplicates straggling GETs.  ``--cache-mb N`` puts an N MiB
in-memory LRU cache tier (the paper's Varnish analogue) in front of the
store; the launcher passes no tracer to it, as the reference's does.
``--arch resnet18-imagenet`` trains the paper's own model on synthetic
ImageNet; ``--arch granite-8b`` (the default, as the reference's) the
dense decoder (or another
registered LM: ``minicpm3-4b`` with MLA, ``granite-moe-3b-a800m`` and
``qwen2-moe-a2.7b`` with MoE, ``rwkv6-7b``, the hybrid ``jamba-v0.1-52b``,
the VLM stub ``internvl2-26b`` with no patch embeddings in its batches) on
packed token sequences of ``--seq-len`` tokens streamed through the same
loader.  The encoder-decoder (``whisper-large-v3``) is refused with a
``SystemExit``: its batches need frames, which the token dataset does not
carry (the reference's launcher fails there with a ``KeyError``); it trains
through ``train.steps.make_train_step``.
``--smoke`` (default) uses the reduced config; ``--full`` the real widths.
``--device`` defaults to ``cuda`` and raises when no card is present.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.config import (
    AutotuneConfig,
    CacheConfig,
    LoaderConfig,
    ModelConfig,
    PipelineConfig,
    StoreConfig,
    TrainConfig,
    get_arch,
)
from repro_torch.core import make_loader
from repro_torch.core.tracing import BATCH_TO_DEVICE, Tracer
from repro_torch.core.utilization import UtilStats, accelerator_stats
from repro_torch.data.dataset import ImageDataset, MapDataset, TokenDataset, build_token_store
from repro_torch.data.imagenet_synth import build_synthetic_imagenet
from repro_torch.data.store import InMemoryStore, build_store
from repro_torch.device import resolve_device
from repro_torch.train.steps import (
    init_resnet_train_state,
    init_train_state,
    make_resnet_train_step,
    make_train_step,
)
from repro_torch.train.trainer import Callback, LoggingCallback, Trainer, TrainResult
from repro_torch.tree import leaves


@dataclass
class RunReport:
    cfg: ModelConfig
    result: TrainResult
    util: UtilStats
    tracer: Tracer
    state: dict
    items_per_s: float
    batches_transferred: int
    batch_to_device_s: float
    # the loader's stage_stats() at the end of each epoch (empty for the
    # legacy loader): each epoch's pipeline iterator has its own staging pool
    stages: List[Dict[str, Any]] = field(default_factory=list)
    # the loader itself: with --autotune, loader.autotuner.events is the
    # controller's audit trail
    loader: Any = None
    # the knob values the autotuner had set at the end of each epoch
    # (loader._tuned; empty dicts without --autotune)
    tuned: List[Dict[str, int]] = field(default_factory=list)


class EpochStages(Callback):
    """Keeps ``loader.stage_stats()`` and the autotuned knob values at the
    end of every epoch (the ring has shut the epoch's iterator down by then,
    so the snapshot is final)."""

    def __init__(self, loader) -> None:
        self.loader = loader
        self.stats: List[Dict[str, Any]] = []
        self.tuned: List[Dict[str, int]] = []

    def on_epoch_end(self, trainer, epoch: int) -> None:
        stats = self.loader.stage_stats()
        if stats is not None:
            self.stats.append(stats)
        self.tuned.append(dict(self.loader._tuned))


def build_dataset(cfg: ModelConfig, args, tracer: Tracer) -> MapDataset:
    """Materialize a synthetic dataset behind the requested store stack:
    ImageNet-like images for the resnet family, packed token sequences
    otherwise."""
    scfg = StoreConfig(
        kind=args.store,
        latency_mean_s=args.latency,
        cache=CacheConfig(memory_bytes=args.cache_mb * 1 << 20),
    )
    if cfg.family == "resnet":
        base = build_synthetic_imagenet(num_items=args.items, avg_kb=args.avg_kb)
        return ImageDataset(
            build_store(scfg, base=base), args.items, out_size=cfg.image_size, tracer=tracer,
            sim_decode_s_per_mb=0.052,
            epilogue="device" if args.device_ingest else "host",
        )
    base = InMemoryStore()
    build_token_store(base, args.items, args.seq_len, cfg.vocab_size)
    return TokenDataset(build_store(scfg, base=base), args.items, args.seq_len, tracer=tracer)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--avg-kb", type=float, default=48.0,
                    help="mean encoded image size (the paper's ImageNet: 115)")
    ap.add_argument("--seq-len", type=int, default=256, help="tokens per LM sequence")
    ap.add_argument("--store", choices=["memory", "s3sim"], default="s3sim")
    ap.add_argument("--latency", type=float, default=0.02)
    ap.add_argument("--cache-mb", type=int, default=0,
                    help="in-memory LRU cache tier in front of the store, in MiB "
                         "(0 = no cache)")
    ap.add_argument("--loader", choices=["vanilla", "threaded", "asyncio"],
                    default="threaded")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--fetchers", type=int, default=16)
    ap.add_argument("--hedge", action="store_true",
                    help="hedged requests (straggler mitigation)")
    ap.add_argument("--pipeline", action="store_true",
                    help="staged streaming pipeline (fetch/decode/augment on "
                         "dedicated IO+CPU executors)")
    ap.add_argument("--reorder", choices=["strict", "window"], default="strict",
                    help="pipeline batch assembly: strict (bit-identical "
                         "stream) or window (first-N-ready composition)")
    ap.add_argument("--reorder-window", type=int, default=4)
    ap.add_argument("--io-workers", type=int, default=0,
                    help="pipeline IO executor width (0 = workers*fetchers)")
    ap.add_argument("--cpu-workers", type=int, default=0,
                    help="pipeline CPU executor width (0 = 4)")
    ap.add_argument("--cpu-executor", choices=["thread", "process"], default="thread",
                    help="pipeline decode+augment executor: 'thread' or 'process' "
                         "(spawned worker processes, which import no torch)")
    ap.add_argument("--staging-buffers", type=int, default=0,
                    help="pinned host staging: collate into this many reusable "
                         "buffer sets that the ring copies from, pinned in place "
                         "when it copies to a card (0 = plain np.stack collate)")
    ap.add_argument("--device-ingest", action="store_true",
                    help="resnet only: host stages stop at raw uint8 HWC and the "
                         "ingest_norm kernel runs cast+normalize on the device after "
                         "H2D (4x fewer host-side bytes per image)")
    ap.add_argument("--autotune", action="store_true",
                    help="online knob control (closed-loop io/cpu/queue/"
                         "outstanding tuning)")
    ap.add_argument("--thread-budget", type=int, default=0,
                    help="co-tune the pipeline io/cpu split (and executor "
                         "kind) as ONE knob under this fixed total width; "
                         "implies --autotune (0 = independent knobs)")
    ap.add_argument("--optimizer", default="adamw",
                    help="adamw, adafactor or sgd (another name raises at make_optimizer)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none", choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> RunReport:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    if args.device_ingest and cfg.family != "resnet":
        raise SystemExit("--device-ingest requires an image (resnet) arch")
    if cfg.family == "encdec":
        raise SystemExit(
            f"{cfg.name} is an encoder-decoder: the token dataset carries no frames, so this "
            "launcher cannot train it; train it through train.steps.make_train_step on "
            "batches that hold 'frames' (B, encoder_seq_len, frontend_dim or d_model) "
            "beside 'tokens' and 'targets'")
    tcfg = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression, total_steps=args.steps)
    tracer = Tracer()
    loader = make_loader(
        LoaderConfig(
            impl=args.loader, batch_size=args.batch_size, num_workers=args.workers,
            num_fetch_workers=args.fetchers, seed=args.seed,
            hedge_requests=args.hedge,
            autotune=AutotuneConfig(
                enabled=args.autotune or args.thread_budget > 0,
                thread_budget=args.thread_budget,
            ),
            pipeline=PipelineConfig(
                enabled=args.pipeline, reorder=args.reorder,
                reorder_window=args.reorder_window, io_workers=args.io_workers,
                cpu_workers=args.cpu_workers, cpu_executor=args.cpu_executor,
                staging_buffers=args.staging_buffers,
            ),
        ),
        build_dataset(cfg, args, tracer),
        tracer=tracer,
    )
    if cfg.family == "resnet":
        state = init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(args.seed),
                                        device)
        step_fn = make_resnet_train_step(cfg, tcfg)
    else:
        # drawn on the card when training there: a full-width model in moments
        state = init_train_state(cfg, tcfg, torch.Generator(device).manual_seed(args.seed),
                                 device)
        step_fn = make_train_step(cfg, tcfg)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M loader={args.loader} "
          f"pipeline={args.pipeline} store={args.store} device={device}", flush=True)

    ingest_fn = None
    if args.device_ingest:
        from repro_torch.kernels.ingest_norm.ops import make_ingest_fn

        ingest_fn = make_ingest_fn()
    stages = EpochStages(loader)
    trainer = Trainer(
        step_fn, state,
        callbacks=[LoggingCallback(log_every_n_steps=args.log_every,
                                   sink=lambda s: print("  " + s, flush=True)), stages],
        tracer=tracer, ingest_fn=ingest_fn, device=device,
    )
    t0 = time.monotonic()
    try:
        result = trainer.fit(loader, epochs=args.epochs, max_steps=args.steps)
    finally:
        loader.close()
    t1 = time.monotonic()

    util = accelerator_stats(tracer, t0, t1)
    items_per_s = result.steps * args.batch_size / result.wall_s
    h2d = tracer.spans(BATCH_TO_DEVICE)
    print(
        f"\nsteps={result.steps} wall={result.wall_s:.1f}s "
        f"items/s={items_per_s:.1f} "
        f"loss={result.last_metrics.get('loss', float('nan')):.4f}"
    )
    print(
        f"accelerator: util_zero={util.util_zero_pct:.1f}% "
        f"util_pos_avg={util.util_pos_avg:.1f}% busy={100 * util.busy_fraction:.1f}%",
        flush=True,
    )
    if stages.stats:
        print(f"pipeline stages: {stages.stats[-1]}", flush=True)
    if loader.autotuner is not None:
        print(f"autotune: {len(loader.autotuner.events)} events, "
              f"knobs {stages.tuned[-1] if stages.tuned else {}}", flush=True)
    return RunReport(cfg, result, util, tracer, trainer.state, items_per_s,
                     len(h2d), sum(s.duration for s in h2d), stages.stats,
                     loader, stages.tuned)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
