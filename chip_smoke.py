#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — needs ``torch.cuda.is_available()``; prints nvidia-smi's name
   and power limit.
2. build   — compiles every kernel of the main path from ``csrc/`` with nvcc
   for sm_90a.
3. kernels — each kernel's wrapper on the card against its plain PyTorch
   version, at the main path's shapes and at ragged ones, with timings.
4. model   — one ResNet train step on the card against the same step on the
   CPU, from the same converted weights, TF32 off.
5. main    — the main path through its launcher: full-width ResNet-18
   trained from simulated S3 through the paper's loader with the
   ``ingest_norm`` epilogue on the card.  Launch counts are reset just
   before and read just after.

Then the ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.  Any
failed check or exception exits non-zero without the last line.  Imports
nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Device-memory bandwidth by card (NVIDIA data sheets), for the bytes bound.
BANDWIDTH = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]

MAIN_BS = 64
MAIN_BATCH = (MAIN_BS, 224, 224, 3)
MAIN_ARGS = [
    "--full", "--device", "cuda", "--device-ingest",
    "--items", "1024", "--avg-kb", "115", "--batch-size", str(MAIN_BS),
    "--latency", "0.02", "--loader", "threaded", "--workers", "4", "--fetchers", "16",
    "--steps", "48", "--optimizer", "sgd", "--log-every", "8",
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bandwidth(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    return 3.35e12


def device_ms(fn, runs: int = 20, per_run: int = 10, warmup: int = 3) -> float:
    """Device time of one call: the median over ``runs`` of CUDA-event time
    around ``per_run`` back-to-back calls, divided by ``per_run``.  Each run's
    calls queue up behind a ~10 ms sleep kernel, so the events time the
    device executing them and not the host enqueueing them."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # cycles
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def call_ms(fn, calls: int = 50) -> float:
    """Wall time of one call as a caller sees it, host overhead included:
    ``calls`` back-to-back calls, then a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def phase_kernels(torch, ops, ref, bw: float) -> dict:
    from repro_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

    gen = torch.Generator().manual_seed(0)
    limits = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    cases = []
    for shape in [MAIN_BATCH, (3, 31, 17, 3), (2, 24, 24, 4), (1, 9, 40, 1), (5, 8, 8, 2)]:
        C = shape[-1]
        if shape == MAIN_BATCH:
            mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
        else:
            mean, std = torch.linspace(0.4, 0.5, C), torch.linspace(0.2, 0.3, C)
        img = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            got = ops.ingest_norm(img, mean, std, dt)
            want = ref.ingest_norm_ref(img, mean.cuda(), std.cuda(), dt)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != dt:
                fail(f"ingest_norm {shape} {dt}: got {tuple(got.shape)} {got.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            cases.append({"shape": list(shape), "dtype": str(dt), "max_abs_err": err,
                          "limit": limits[dt]})
            if not err <= limits[dt]:
                fail(f"ingest_norm {shape} {dt}: max abs err {err} > {limits[dt]}")
    B, H, W, C = MAIN_BATCH
    img = torch.randint(0, 256, MAIN_BATCH, dtype=torch.uint8, generator=gen).cuda()
    mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
    mean_d, std_d = mean.cuda(), std.cuda()
    kernel = lambda: ops.ingest_norm(img, mean, std)  # noqa: E731
    plain = lambda: ref.ingest_norm_ref(img, mean_d, std_d)  # noqa: E731
    kernel_ms, plain_ms = device_ms(kernel), device_ms(plain)
    kernel_call_ms, plain_call_ms = call_ms(kernel), call_ms(plain)
    nbytes = B * H * W * C * (1 + 4)  # u8 in, f32 out, each touched once
    main_err = next(c["max_abs_err"] for c in cases
                    if c["shape"] == list(MAIN_BATCH) and c["dtype"] == str(torch.float32))
    out = {"phase": "kernels", "cases": cases, "kernel": "ingest_norm",
           "shape": list(MAIN_BATCH), "out_dtype": "float32", "max_abs_err": main_err,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "kernel_call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
           "bound_ms": nbytes / bw * 1e3, "bound_bytes": nbytes}
    emit(out)
    return out


def phase_model(torch) -> dict:
    import numpy as np

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.convert import resnet_state_from_jax, to_jax
    from repro_torch.models.resnet import init_resnet
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.steps import make_resnet_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("resnet18-imagenet", smoke=True)
    tcfg = TrainConfig(optimizer="sgd", learning_rate=0.1, warmup_steps=1)
    params, bn = init_resnet(cfg, torch.Generator().manual_seed(1), "cpu")
    np_params, np_bn = to_jax(params), to_jax(bn)  # the reference's layout
    rng = np.random.default_rng(2)
    batch = {"image": rng.standard_normal((8, 3, cfg.image_size, cfg.image_size),
                                          dtype=np.float32),
             "label": rng.integers(0, cfg.num_classes, 8).astype(np.int32)}
    losses = {}
    for dev in ("cpu", "cuda"):
        p, s = resnet_state_from_jax(np_params, np_bn, dev)
        state = {"params": p, "bn": s, "opt": make_optimizer(tcfg).init(p), "step": 0}
        step = make_resnet_train_step(cfg, tcfg)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        losses[dev] = []
        for _ in range(2):
            state, m = step(state, b)
            losses[dev].append(m["loss"].item())
    diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    out = {"phase": "model", "arch": cfg.name, "steps": 2, "loss_cpu": losses["cpu"],
           "loss_cuda": losses["cuda"], "max_loss_diff": diff, "limit": 1e-4,
           "cudnn_allow_tf32": False, "matmul_allow_tf32": False}
    emit(out)
    if not all(math.isfinite(x) for x in losses["cuda"]) or not diff <= 1e-4:
        fail(f"train step on the card differs from the CPU: {losses}")
    return out


def span_stats(tracer) -> dict:
    out = {}
    for name in ("get_batch", "batch_to_device", "run_training_batch"):
        ds = [s.duration for s in tracer.spans(name)]
        out[name] = {"count": len(ds), "total_s": sum(ds),
                     "median_ms": 1e3 * statistics.median(ds) if ds else None,
                     "max_ms": 1e3 * max(ds) if ds else None}
    return out


def isolated_step_ms(torch, report, steps: int = 10) -> float:
    """Median host-clock time of the main path's train step on one batch
    already on the card, with no loader running: what the card needs."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.steps import make_resnet_train_step

    step = make_resnet_train_step(report.cfg, TrainConfig(optimizer="sgd"))
    gen = torch.Generator().manual_seed(3)
    size = report.cfg.image_size
    batch = {"image": torch.randn(MAIN_BS, 3, size, size, generator=gen).cuda(),
             "label": torch.randint(0, report.cfg.num_classes, (MAIN_BS,), generator=gen).cuda()}
    state, times = report.state, []
    for i in range(steps + 2):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_main(torch, ops) -> dict:
    from repro_torch.launch import train as launch
    from repro_torch.tree import leaves

    # PyTorch's defaults, stated: cuDNN convolutions in TF32, matmuls in f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.ingest_norm.launches = 0
    report = launch.run(MAIN_ARGS)
    launches = ops.ingest_norm.launches
    losses = [h["loss"] for h in report.result.history]
    devices = sorted({str(p.device.type) for p in leaves(report.state["params"])})
    # throughput after the first step (cuDNN set-up and the loader's first
    # fill happen before it ends)
    ends = sorted(s.t1 for s in report.tracer.spans("run_training_batch"))
    steady = (len(ends) - 1) * MAIN_BS / (ends[-1] - ends[0]) if len(ends) > 1 else None
    out = {
        "phase": "main", "arch": report.cfg.name, "args": MAIN_ARGS,
        "steps": report.result.steps, "epochs": report.result.epochs,
        "wall_s": report.result.wall_s, "items_per_s": report.items_per_s,
        "items_per_s_after_first_step": steady,
        "first_step_ms": 1e3 * report.tracer.spans("run_training_batch")[0].duration,
        "batches_transferred": report.batches_transferred,
        "batch_to_device_total_s": report.batch_to_device_s,
        "ingest_norm_launches": launches,
        "spans": span_stats(report.tracer),
        "isolated_step_ms": isolated_step_ms(torch, report),
        "util_zero_pct": report.util.util_zero_pct, "util_pos_avg": report.util.util_pos_avg,
        "busy_fraction": report.util.busy_fraction, "util_wall_s": report.util.wall_s,
        "first_loss": losses[0] if losses else None, "last_loss": losses[-1] if losses else None,
        "param_devices": devices,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(out)
    if report.result.steps < 48 or report.result.epochs < 3:
        fail(f"main path ran {report.result.steps} steps over {report.result.epochs} epochs")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss on the main path: {losses}")
    if launches == 0 or launches != report.batches_transferred:
        fail(f"ingest_norm launched {launches} times for "
             f"{report.batches_transferred} batches transferred")
    if devices != ["cuda"]:
        fail(f"params live on {devices}, not on cuda")
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repo")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    bw = bandwidth(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "bandwidth_bytes_per_s": bw})

    # 2. build
    from repro_torch.kernels.ingest_norm import ops, ref

    t0 = time.monotonic()
    built = ops.build()
    emit({"phase": "build", "kernel": "ingest_norm", "seconds": time.monotonic() - t0,
          "nvcc_seconds": built.seconds, "library": built.path.name,
          "ptxas": [ln.strip() for ln in built.log.splitlines() if "ptxas info" in ln]})

    # 3.-5.
    kern = phase_kernels(torch, ops, ref, bw)
    phase_model(torch)
    main_out = phase_main(torch, ops)

    emit({"kernels": [{
        "name": "ingest_norm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ingest_norm/csrc/ingest_norm.cu",
        "replaces": "src/repro/kernels/ingest_norm/kernel.py:29",
        "launches": main_out["ingest_norm_launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"],
        "kernel_ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
