"""Where the time of the port's LM train step goes, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.tools.profile_lm_step [--arch rwkv6-7b-4l]

Builds one of chip_smoke's LM main-path steps (``--arch granite-8b-4l``, the
default, or ``rwkv6-7b-4l``: the model at full width, depth cut to 4
layers, batch 4 x 4096 tokens, 2 microbatches, AdamW, remat), with the
batch already on the card and no loader, and prints JSON lines:

* ``pieces``: CUDA-event times of the whole step, of the forward loss alone
  (``make_eval_step``), of forward + backward alone, of the optimizer update
  alone, and (granite) of ``forward_train`` with ``attention_impl="pallas"``
  (the flash kernel, forward only);
* ``profile``: ``torch.profiler`` over two steps: device time by
  kernel category and the top kernels, and the device's busy share of the
  profiled wall time (the union of kernel intervals over the window);
* ``attention``: the plain attention the step trains through (``_sdpa`` on
  one microbatch's q, k, v), alone: the device time of its forward and of
  its forward + backward, and its kernels by the same categories.  Under
  remat a step runs, per microbatch and layer, one forward and one forward
  + backward of it, so scaled by microbatches x layers these say how much
  of the step, and of each category, the attention takes (granite);
* ``rwkv_scan``: the same for the plain chunked WKV scan the RWKV step
  trains through (``wkv_scan_chunked`` on one microbatch's r, k, v, w).

Imports nothing of JAX and nothing of the JAX package.  Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from collections import defaultdict

LAYERS, STEPS = 4, 2  # chip_smoke's LM depth; profiled steps
ARCHS = {"granite-8b-4l": "granite-8b", "rwkv6-7b-4l": "rwkv6-7b"}  # chip_smoke's names

CATEGORIES = [
    ("matmul", re.compile(r"gemm|nvjet|xmma|cutlass|cublas|sm90_|Kernel2", re.I)),
    ("flash_attention", re.compile(r"flash_fwd_kernel")),
    ("softmax", re.compile(r"softmax", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    # "nocast" is in the name of every gpu_kernel_impl_nocast elementwise kernel
    ("copy_cast", re.compile(r"copy|memcpy|memset|(?<!no)cast", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def category(name: str) -> str:
    for cat, pat in CATEGORIES:
        if pat.search(name):
            return cat
    return "other"


def event_ms(torch, fn, reps: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def profiled(torch, fn, calls: int) -> dict:
    """``fn`` run ``calls`` times under ``torch.profiler``: wall ms, kernel
    intervals, and device ms by category and by kernel, each per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat, by_kernel, intervals = defaultdict(float), defaultdict(float), []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        dur_ms = (evt.time_range.end - evt.time_range.start) / 1e3
        by_cat[category(evt.name)] += dur_ms / calls
        by_kernel[evt.name] += dur_ms / calls
        intervals.append((evt.time_range.start, evt.time_range.end))
    return {"wall_ms": wall_ms / calls, "intervals": intervals, "by_cat": by_cat,
            "by_kernel": by_kernel}


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in microseconds, as ms."""
    busy_us, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return busy_us / 1e3


def component(torch, phase: str, fwd, fwd_bwd, per_step: int, step_ms: float,
              step_cats: dict, **fields) -> None:
    """One piece of the step alone: CUDA-event times of its forward and its
    forward + backward, and its kernels by category, scaled to a step that
    runs each of them ``per_step`` times."""

    def remat():  # what a block's remat runs of it per microbatch
        fwd()
        fwd_bwd()

    fwd_ms, fwd_bwd_ms = event_ms(torch, fwd), event_ms(torch, fwd_bwd)
    prof = profiled(torch, remat, 2)
    cats = {c: ms * per_step for c, ms in sorted(prof["by_cat"].items(), key=lambda kv: -kv[1])}
    emit({"phase": phase, **fields, "forward_ms": fwd_ms, "forward_backward_ms": fwd_bwd_ms,
          "ms_per_step": (fwd_ms + fwd_bwd_ms) * per_step,
          "share_of_step": (fwd_ms + fwd_bwd_ms) * per_step / step_ms,
          "ms_per_step_by_category": cats,
          "share_of_step_category": {c: cats.get(c, 0.0) / ms
                                     for c, ms in step_cats.items() if ms}})


def main(argv=None) -> int:
    import torch

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.models.layers import _sdpa
    from repro_torch.models.rwkv6 import wkv_scan_chunked
    from repro_torch.models.transformer import forward_train
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.steps import init_train_state, make_eval_step, make_train_step
    from repro_torch.tree import leaves

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="granite-8b-4l")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(ARCHS[args.arch]), num_layers=LAYERS)
    B, S, micro = 4, 4096, 2
    tcfg = TrainConfig(optimizer="adamw", learning_rate=3e-4, microbatches=micro,
                       total_steps=1000)
    gen = torch.Generator("cuda").manual_seed(0)
    state = init_train_state(cfg, tcfg, gen, "cuda")
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                              dtype=torch.int32) for k in ("tokens", "targets")}
    step = make_train_step(cfg, tcfg)

    def run_step():
        nonlocal state
        state, m = step(state, batch)
        m["loss"].item()

    params = state["params"]
    plist = leaves(params)
    eval_ref = make_eval_step(cfg)
    mb = {k: v[: B // micro] for k, v in batch.items()}

    def fwd_bwd():
        loss, _ = forward_train(params, mb, cfg)
        torch.autograd.grad(loss, plist)

    opt = make_optimizer(tcfg)
    grads = [torch.zeros_like(p) for p in plist]
    torch.cuda.reset_peak_memory_stats()
    step_ms = event_ms(torch, run_step)
    pieces = {
        "phase": "pieces", "arch": args.arch, "num_layers": cfg.num_layers, "batch": B,
        "seq_len": S, "microbatches": micro, "nvidia_smi": smi,
        "step_ms": step_ms,
        "forward_ms_ref": event_ms(torch, lambda: eval_ref(params, batch)),
        "forward_backward_ms_per_microbatch": event_ms(torch, fwd_bwd),
        "optimizer_ms": event_ms(torch, lambda: opt.update(grads, state["opt"], params, 10_000)),
        "tokens_per_s": B * S / step_ms * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    if cfg.attention is not None:
        eval_flash = make_eval_step(dataclasses.replace(cfg, attention_impl="pallas"))
        pieces["forward_ms_flash"] = event_ms(torch, lambda: eval_flash(params, batch))
    emit(pieces)
    del grads

    prof = profiled(torch, run_step, STEPS)
    step_cats = dict(sorted(prof["by_cat"].items(), key=lambda kv: -kv[1]))
    top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "steps": STEPS, "wall_ms_per_step": prof["wall_ms"],
          "kernel_ms_per_step": sum(step_cats.values()),
          "busy_ms_per_step": busy_ms(prof["intervals"]) / STEPS,
          "device_busy_share": (busy_ms(prof["intervals"]) / STEPS / prof["wall_ms"]
                                if prof["wall_ms"] else None),
          "kernels_seen": len(prof["intervals"]),
          "ms_per_step_by_category": step_cats,
          "top_kernels_ms_per_step": [[name[:120], ms] for name, ms in top]})
    if not prof["intervals"]:
        print("torch.profiler recorded no device kernels: device times not measured",
              file=sys.stderr)
        return 1

    per_step = micro * cfg.num_layers
    runs = f"{micro} microbatches x {cfg.num_layers} layers, each one forward and one " \
           "forward + backward"
    b = B // micro
    if cfg.family == "rwkv":
        # the plain chunked scan alone, on one microbatch's r, k, v, w as the
        # time-mix hands them over: (b,S,H,D) fp32, decays drawn as the
        # reference's kernel tests draw them
        H, D = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        n = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        r, k, v = n(b, S, H, D) * 0.5, n(b, S, H, D) * 0.5, n(b, S, H, D)
        w = torch.exp(-torch.exp(n(b, S, H, D) * 0.5 - 0.6))
        u = n(H, D) * 0.1
        s0 = torch.zeros((b, H, D, D), device="cuda")
        inputs = [t.requires_grad_(True) for t in (r, k, v, w, u)]
        g_y = n(b, S, H, D)

        def scan_fwd():
            with torch.no_grad():
                wkv_scan_chunked(r, k, v, w, u, s0)

        def scan_fwd_bwd():
            y, _ = wkv_scan_chunked(r, k, v, w, u, s0)
            torch.autograd.grad(y, inputs, g_y)

        component(torch, "rwkv_scan", scan_fwd, scan_fwd_bwd, per_step, step_ms, step_cats,
                  shape=[b, S, H, D], dtype="float32", route="wkv_scan_chunked",
                  runs_per_step=runs)
        return 0

    # the plain attention alone, on one microbatch's q, k, v as the model
    # hands them to _sdpa: q (b,S,Hkv,G,D), k, v (b,S,Hkv,D), bf16
    a = cfg.attention
    shapes = [(b, S, a.num_kv_heads, a.q_heads_per_kv, a.head_dim),
              (b, S, a.num_kv_heads, a.head_dim),
              (b, S, a.num_kv_heads, a.head_dim)]
    q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for s in shapes)
    g_out = torch.randn(shapes[0], generator=gen, device="cuda", dtype=torch.bfloat16)

    def attn_fwd():
        with torch.no_grad():
            _sdpa(q, k, v, causal=True, q_offset=0)

    def attn_fwd_bwd():
        out = _sdpa(q, k, v, causal=True, q_offset=0)
        torch.autograd.grad(out, (q, k, v), g_out)

    component(torch, "attention", attn_fwd, attn_fwd_bwd, per_step, step_ms, step_cats,
              q=list(shapes[0]), kv=list(shapes[1]), dtype="bfloat16",
              route="_sdpa_chunked" if S >= 4096 else "_sdpa_dense", runs_per_step=runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
