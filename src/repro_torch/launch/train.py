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
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-imagenet --device cpu \
        --device-ingest --items 32 --batch-size 8 --steps 12 --ckpt-dir /tmp/ck --ckpt-every 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-imagenet --device cpu \
        --device-ingest --items 32 --batch-size 8 --steps 12 --ckpt-dir /tmp/ck --ckpt-every 4 \
        --resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-imagenet --device cpu \
        --device-ingest --items 32 --batch-size 8 --steps 6 --delivery sharded
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch resnet18-imagenet --device cpu --dist-backend gloo --delivery sharded \
        --device-ingest --items 32 --batch-size 8 --steps 6 --optimizer sgd
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch resnet18-imagenet --full --device cuda:0 --dist-backend gloo \
        --delivery sharded --device-ingest --items 1024 --batch-size 64 --steps 16 \
        --optimizer sgd

Wires the stack together: a synthetic dataset in an object store behind
simulated S3 -> dataset -> ``make_loader`` (the paper's loader, or with
``--pipeline`` the staged pipeline, collating into pinned staging buffers
with ``--staging-buffers N``) -> device prefetch ring (H2D, then the
``ingest_norm`` kernel with ``--device-ingest``) -> train step -> Trainer,
and prints the paper's Table-3 columns (throughput + accelerator busy
stats) and, with ``--pipeline``, the per-stage stats at the end.
``--autotune`` moves the loader's knobs online between batches (and
``--thread-budget N`` co-tunes the pipeline's io/cpu split under N threads);
``--hedge`` duplicates straggling GETs.  ``--ckpt-dir D`` saves the train
state every ``--ckpt-every`` steps (asynchronously, the reference's layout,
the newest 3 kept) with the loader cursor of the trainer's step, and
``--resume`` restores the newest complete checkpoint under D and its loader
cursor, then trains on to ``--steps``: the resumed steps see the same
batches, in the same order, as an unbroken run's.  ``--delivery sharded``
turns the staged pipeline on with one delivery lane for each visible
device along ``--delivery-axis`` (one lane on the CPU), whose threads copy
each batch's rows to the card, so the device ring copies nothing
(:mod:`repro_torch.core.delivery`; lanes on distinct cards are refused).  ``--cache-mb N`` puts an N MiB
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

Under torchrun (``WORLD_SIZE`` in the environment) the launcher trains data
parallel, one process a card, in one process group
(:mod:`repro_torch.launch.dist`; ``--dist-backend nccl`` (default) or
``gloo``, rendezvous at ``--dist-init``, default ``env://``).  ``--device
cuda`` is each rank's ``cuda:LOCAL_RANK``; ``--device cuda:0`` puts every
rank on card 0 (over gloo: NCCL takes one rank a card).  The global
``--batch-size`` is split over the ranks (it must divide); each rank
loads its contiguous slice of every global batch, and with ``--delivery
sharded`` the mesh is the group's, one lane a rank.  The step reduces
gradients and metrics over the group and BatchNorm takes the global
batch's statistics, so W ranks compute what the reference computes on a
W-device mesh.  Rank 0 prints, and writes the checkpoint; its last lines
add each rank's busy share, the gradient all-reduce's ms a step and
whether every rank's parameters hold the same bits.  Without torchrun's
environment the launcher runs in one process, as before.
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
    DeliverySpec,
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
from repro_torch.convert import checkpoint_layout
from repro_torch.data.dataset import ImageDataset, MapDataset, TokenDataset, build_token_store
from repro_torch.data.imagenet_synth import build_synthetic_imagenet
from repro_torch.data.store import InMemoryStore, build_store
from repro_torch.device import resolve_device
from repro_torch.launch import dist
from repro_torch.train.steps import (
    init_resnet_train_state,
    init_train_state,
    make_resnet_train_step,
    make_train_step,
)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import (
    Callback,
    CheckpointCallback,
    LoggingCallback,
    Trainer,
    TrainResult,
)
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
    # with --resume: the step the run restored (None: it started fresh)
    resumed_from: Optional[int] = None
    # under a process group: rank, world_size, backend, each rank's busy
    # share and composed batches, the gradient all-reduce's calls, ms a
    # step and bytes, and the (min, max) of the ranks' parameter checksums
    data_parallel: Dict[str, Any] = field(default_factory=dict)


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
    ap.add_argument("--transport", choices=["pipe", "shm"], default="pipe",
                    help="process CPU stage result transport: 'pipe' (pickle both "
                         "ways) or 'shm' (zero-copy shared-memory slabs; only "
                         "meaningful with --cpu-executor process)")
    ap.add_argument("--staging-buffers", type=int, default=0,
                    help="pinned host staging: collate into this many reusable "
                         "buffer sets that the ring copies from, pinned in place "
                         "when it copies to a card (0 = plain np.stack collate)")
    ap.add_argument("--device-ingest", action="store_true",
                    help="resnet only: host stages stop at raw uint8 HWC and the "
                         "ingest_norm kernel runs cast+normalize on the device after "
                         "H2D (4x fewer host-side bytes per image)")
    ap.add_argument("--delivery", choices=["host", "sharded"], default="host",
                    help="batch delivery: 'host' (one host batch, the device ring "
                         "copies it) or 'sharded' (per-mesh-slice assembler lanes "
                         "copy their rows to the card; turns --pipeline on)")
    ap.add_argument("--delivery-axis", default="data",
                    help="mesh axis the batch dim is sharded over")
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
    ap.add_argument("--warmup-steps", type=int, default=TrainConfig.warmup_steps,
                    help="steps of the learning rate's linear warmup")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none", choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-backend", choices=list(dist.BACKENDS), default="nccl",
                    help="process group backend under torchrun (one process a card)")
    ap.add_argument("--dist-init", default="env://",
                    help="process group rendezvous under torchrun: env:// or file://<path>")
    return ap.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> RunReport:
    """Train as the flags say; under torchrun's environment, as one rank of a
    data-parallel process group that this call starts and tears down."""
    args = parse_args(argv)
    if not dist.env_world_size() or dist.is_initialized():
        return _run(args, dist.device() or resolve_device(args.device))
    device = dist.init_process_group(args.dist_backend, args.dist_init, args.device)
    try:
        return _run(args, device)
    finally:
        dist.destroy_process_group()


def _say(*lines: str) -> None:
    """Print on rank 0 (every process without a group)."""
    if dist.rank() == 0:
        for line in lines:
            print(line, flush=True)


def _data_parallel_report(trainer: Trainer, step_fn, util: UtilStats,
                          stages: List[Dict[str, Any]]) -> Dict[str, Any]:
    """What a data-parallel run reports, gathered from every rank (each
    gather is a collective: every rank calls this at the end)."""
    reduce = step_fn.grad_reduce
    composed = sum(ln["composed"] for st in stages
                   for ln in (st.get("delivery") or {}).get("lanes", []))
    lo, hi = dist.checksum_range({k: v for k, v in trainer.state.items() if k != "step"})
    return {
        "rank": dist.rank(), "world_size": dist.world_size(), "backend": dist.backend(),
        "busy_ranks": dist.all_gather_object(util.busy_fraction),
        "composed_ranks": dist.all_gather_object(composed),
        "grad_allreduce_calls": reduce.calls,
        "grad_allreduce_ms_per_step": 1e3 * reduce.seconds / max(reduce.calls, 1),
        "grad_allreduce_bytes": reduce.bytes // max(reduce.calls, 1),
        "checksum_min": lo, "checksum_max": hi,
    }


def _run(args: argparse.Namespace, device: torch.device) -> RunReport:
    cfg = get_arch(args.arch, smoke=args.smoke)
    world = dist.world_size()
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} does not split over {world} ranks")
    if args.device_ingest and cfg.family != "resnet":
        raise SystemExit("--device-ingest requires an image (resnet) arch")
    if cfg.family == "encdec":
        raise SystemExit(
            f"{cfg.name} is an encoder-decoder: the token dataset carries no frames, so this "
            "launcher cannot train it; train it through train.steps.make_train_step on "
            "batches that hold 'frames' (B, encoder_seq_len, frontend_dim or d_model) "
            "beside 'tokens' and 'targets'")
    tcfg = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                       warmup_steps=args.warmup_steps,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression, total_steps=args.steps)
    tracer = Tracer()
    delivery = DeliverySpec.host()
    if args.delivery == "sharded":
        from repro_torch.launch.mesh import make_mesh

        if dist.is_initialized():
            # the group's mesh: one lane a rank, each on its own device
            mesh = make_mesh((world,), (args.delivery_axis,))
        else:
            # one lane per visible card along the delivery axis (one on the CPU)
            lanes = [device] if device.type == "cpu" else None
            n = 1 if device.type == "cpu" else torch.cuda.device_count()
            mesh = make_mesh((n,), (args.delivery_axis,), lanes)
        delivery = DeliverySpec.sharded(mesh, axis=args.delivery_axis)
    loader = make_loader(
        LoaderConfig(
            impl=args.loader, batch_size=args.batch_size, num_workers=args.workers,
            num_fetch_workers=args.fetchers, seed=args.seed,
            hedge_requests=args.hedge,
            autotune=AutotuneConfig(
                enabled=args.autotune or args.thread_budget > 0,
                thread_budget=args.thread_budget,
            ),
            delivery=delivery,
            pipeline=PipelineConfig(
                enabled=args.pipeline or args.delivery == "sharded", reorder=args.reorder,
                reorder_window=args.reorder_window, io_workers=args.io_workers,
                cpu_workers=args.cpu_workers, cpu_executor=args.cpu_executor,
                transport=args.transport, staging_buffers=args.staging_buffers,
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
    _say(f"arch={cfg.name} params={n_params/1e6:.1f}M loader={args.loader} "
         f"pipeline={args.pipeline} store={args.store} device={device}"
         + (f" ranks={world} backend={dist.backend()}" if dist.is_initialized() else ""))

    ingest_fn = None
    if args.device_ingest:
        from repro_torch.kernels.ingest_norm.ops import make_ingest_fn

        ingest_fn = make_ingest_fn()
    stages = EpochStages(loader)
    callbacks: List[Callback] = [LoggingCallback(log_every_n_steps=args.log_every,
                                                 sink=lambda s: print("  " + s, flush=True)),
                                 stages]
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, keep=3, layout=checkpoint_layout(cfg))
        callbacks.append(CheckpointCallback(manager, args.ckpt_every, loader=loader))
    trainer = Trainer(step_fn, state, callbacks=callbacks, tracer=tracer,
                      ingest_fn=ingest_fn, device=device)
    start_epoch, resumed_from = 0, None
    if manager is not None and args.resume and manager.latest_step() is not None:
        trainer.state, meta = manager.restore(trainer.state)
        trainer.global_step = resumed_from = int(meta.get("step", 0))
        if "loader" in meta.get("extra", {}):
            loader.load_state_dict(meta["extra"]["loader"])
            start_epoch = loader.state_dict()["epoch"]
        _say(f"resumed from step {trainer.global_step}")
    t0 = time.monotonic()
    try:
        result = trainer.fit(loader, epochs=args.epochs, max_steps=args.steps,
                             start_epoch=start_epoch)
    finally:
        loader.close()
    t1 = time.monotonic()
    if manager is not None:
        manager.wait()

    util = accelerator_stats(tracer, t0, t1)
    items_per_s = result.steps * args.batch_size / result.wall_s
    h2d = tracer.spans(BATCH_TO_DEVICE)
    dp = (_data_parallel_report(trainer, step_fn, util, stages.stats)
          if dist.is_initialized() else {})
    busy = (" busy_ranks=" + ",".join(f"{100 * b:.1f}%" for b in dp["busy_ranks"])
            if dp else "")
    _say(
        f"\nsteps={result.steps} wall={result.wall_s:.1f}s "
        f"items/s={items_per_s:.1f} "
        f"loss={result.last_metrics.get('loss', float('nan')):.4f}",
        f"accelerator: util_zero={util.util_zero_pct:.1f}% "
        f"util_pos_avg={util.util_pos_avg:.1f}% busy={100 * util.busy_fraction:.1f}%{busy} "
        f"(spans read: {util.source})",
    )
    if dp:
        _say(f"data parallel: ranks={dp['world_size']} backend={dp['backend']} "
             f"grad_allreduce_ms={dp['grad_allreduce_ms_per_step']:.2f} a step "
             f"({dp['grad_allreduce_bytes']} bytes) "
             f"params_equal={dp['checksum_min'] == dp['checksum_max']}")
    if stages.stats:
        _say(f"pipeline stages: {stages.stats[-1]}")
    if loader.autotuner is not None:
        _say(f"autotune: {len(loader.autotuner.events)} events, "
             f"knobs {stages.tuned[-1] if stages.tuned else {}}")
    return RunReport(cfg, result, util, tracer, trainer.state, items_per_s,
                     len(h2d), sum(s.duration for s in h2d), stages.stats,
                     loader, stages.tuned, resumed_from, dp)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
