#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — needs ``torch.cuda.is_available()``; prints nvidia-smi's name
   and power limit.
2. build   — compiles every kernel of the main paths from ``csrc/`` with
   nvcc for sm_90a, one nvcc per source, all started together.
3. kernels — each kernel's wrapper on the card against its plain PyTorch
   version, at the main path's shapes and at ragged ones, with timings:
   ``ingest_norm`` (each case naming its vector or scalar path; warm-L2
   and cold-L2 times; ptxas's registers, spills and shared memory, and
   resident blocks an SM), then ``flash_attention`` (each case naming its route,
   the bf16 tensor-core kernel or the CUDA-core one; the library yardstick
   ``scaled_dot_product_attention``, timed only; the fp32 CUDA-core kernel
   timed at the path shape too).
4. model   — one ResNet train step on the card against the same step on the
   CPU, from the same converted weights, TF32 off.
5. model_lm — two AdamW steps of the granite-8b smoke decoder on the card
   against the CPU (fp32, TF32 off), and the flash route's forward loss
   against the plain attention's on the card.
6. main    — the ResNet path through its launcher: full-width ResNet-18
   trained from simulated S3 through the paper's loader with the
   ``ingest_norm`` epilogue on the card.
6b. main_pipeline — (a) the same ResNet path through ``make_loader`` and
   the staged pipeline with ``staging_buffers=4``: H2D straight from the
   pooled staging buffers, pinned in place, then ``ingest_norm``; gated on
   every copy reading a pooled pinned set, launches equal to batches
   transferred, no detached lease and at most 4 sets an epoch; then the
   same with the process CPU executor; both printed beside ``main``'s
   figures.  Then three checks on the card at full image size: (b) with
   one staging buffer, a delay kernel in front of every copy and a
   consumer that waits before each step, every device batch after
   ``ingest_norm`` equals the legacy loader's, and a ring planted to
   release the buffer before its copy landed is seen to differ; (c) window
   reorder keeps each window's label multiset; (d) the process CPU
   executor (2 spawned workers, whose samples report that ``torch`` is not
   in their ``sys.modules``) equals the thread executor.
6c. main_autotune — the staged-pipeline path at 8192 items (128 batches
   an epoch, 3 epochs, 384 steps) three times: fixed knobs, ``--autotune``,
   and ``--thread-budget 68``; each held to every gate of (a), and the two
   tuned runs to the fixed run's stream (a digest of labels and u8 image
   bytes taken on the card after each copy, before ``ingest_norm``), to
   at least one probe, to every tuning event inside its knob's bounds, and
   (budget run) to io + cpu workers = 68 each epoch and to split probes
   both up and down; (e) the same budget's CPU executor knob turned on the
   ring's thread, to processes and back mid-epoch, at full image size:
   the device stream equals the thread-only one, the processes decode
   without torch and every spawn runs on the pool's pump; prints the figures,
   the events by action, each epoch's tuned knobs, what the utilization
   signal read at every window the controller judged, and
   ``available_cpu_count()``.
7. main_lm — the LM path: full-width granite-8b (depth cut to 4 layers)
   trained from simulated S3 through the launcher, then its forward loss
   through ``make_eval_step`` with ``attention_impl="pallas"`` (the flash
   kernel) over 4 loader batches against the plain attention's.
8. kernels/rwkv6_wkv and kernels/rmsnorm — each new kernel against its
   plain version at the reference tests' cases and the path's shape, with
   timings (rmsnorm with the library yardstick ``F.rms_norm``; rwkv6_wkv
   with its ptxas report and resident blocks an SM at every head dim).
9. model_rwkv — two AdamW steps of the rwkv6-7b smoke model on the card
   against the CPU (fp32, TF32 off).
10. main_rwkv — the RWKV path: full-width rwkv6-7b (depth cut to 4 layers)
   trained from simulated S3 through the launcher, then 4 loader batches
   walked through the trained blocks, each layer's time-mix run through
   the WKV kernel (``wkv_impl``) beside the plain chunked scan; the kernel
   gated on the real r, k, v, w, and RMSNorm on a real residual.
11. main_serve — the serving path: granite-8b whole (36 layers, full
   width) through ``launch/serve.py`` at the reference launcher's defaults
   (32 requests of 2-16 prompt tokens, 8 slots, max_len 256, 32 new
   tokens each): (a) tokens/s, TTFT and total latency, ticks, decode and
   prefill ms behind synchronizes, peak memory of the init and of serving,
   gated on the reference's token accounting and tick bound; (b) 4
   requests' pooled tokens held to the batch-1 decode on the same weights
   (each within SERVE_TIE_TOL of the batch-1 maximum); (c) 2 requests' last
   decode step against a cacheless forward; (d) the engine with
   ``attention_impl="pallas"``: no flash launch; (e) one 16384-token prompt
   prefilled in 2 chunks against one pass; (f) the granite and RWKV smoke
   models served on the card against the CPU, fp32; (g) rwkv6-7b at full
   width, 4 layers, 8 requests over 4 slots, held as in (b).  No kernel
   runs on this path (the reference takes no Pallas route with a cache).
9b. model_families — two AdamW steps of the minicpm3-4b (MLA),
   granite-moe-3b-a800m (MoE), jamba-v0.1-52b (hybrid, 8 layers and 16
   in stacked blocks), whisper-large-v3 (encoder-decoder, batches with
   frames) and internvl2-26b (VLM, batches with patch embeddings) smoke
   models on the card against the CPU (fp32, TF32 off), loss and aux loss.
12. main_mla — minicpm3-4b at full width (depth 62 cut to 4) trained from
   simulated S3 through the launcher as main_lm, then served whole (62
   layers) through ``launch/serve.py`` at the reference launcher's
   defaults, with main_serve's (a), (b), (c) and (e), and the absorbed
   MLA decode against the expanded one (``MLA_ABSORB_MAX_S = 0``) on the
   engine's pooled cache.
13. main_moe — granite-moe-3b-a800m at full width (32 cut to 4) trained
   the same way (aux loss positive), gather against einsum dispatch on one
   full-width layer at the training shape (fp32, within 2e-5), then
   granite-moe-3b-a800m served whole with (a) and (b), and
   qwen2-moe-a2.7b served whole (15.15 B parameters) with (a), its init
   and serving peaks against the card's memory, finite logits, and pooled
   against batch-1 decode printed, not gated (its decode capacity of 4
   drops assignments a batch-1 decode keeps, as the reference's does),
   beside the ticks where a live slot lost an assignment.  No kernel runs
   on the MLA or MoE paths (no Pallas route in the reference's MLA or
   MoE).
14. main_hybrid — jamba-v0.1-52b: (t) trained through the launcher at its
   smoke widths (full width does not train on one card), main_lm's loader
   and steps, aux loss positive; (a) one full-width period (8 layers, 13.30
   B parameters) served through ``launch/serve.py`` at the reference
   launcher's defaults, main_serve's figures; (b) pooled against batch-1
   decode printed, not gated (decode capacity 2), beside the ticks where a
   live slot lost an assignment; (c) one served Mamba layer's state
   carried from a 4092-token prefill through 4 decode steps against the
   cacheless scan (gated), and that layer over 16384 tokens timed at
   several scan chunks; (e) a 16384-token prompt in one pass (never
   chunked): time, the Mamba scan's share, peak, finite logits; (k) the
   flash kernel on its attention layer: ``make_eval_step`` with
   ``attention_impl="pallas"`` against ``"ref"`` over 4 batches of 2 x
   4096 tokens, flash launched 4 times and no other kernel; (f) the smoke
   model and its stacked variant served on the card against the CPU.
15. main_encdec — whisper-large-v3 whole (32 + 32 layers, full width,
   1.60 B parameters): (t) 8 AdamW steps through ``make_train_step`` at
   batch 8 (frames (8, 1500, 1280), 448 text tokens a row, drawn on the
   card from a seed), the last under torch.profiler, gated on finite
   losses, the last below the first and a held-out batch's loss falling;
   (k) ``make_eval_step`` with the flash kernel on the decoder's cacheless
   self-attention against the plain attention over 2 of those batches,
   flash launched 32 x 2 times and no other kernel, the losses within
   5e-3, and the kernel alone at that shape, (8, 20, 448, 64) bf16 (the
   D = 64 tensor-core route), beside its plain version and SDPA; (a)
   served through ``launch/serve.py`` at the reference launcher's defaults
   (8 slots: the reference's engine serves one), main_serve's figures and
   the cross-KV cache's size; (b) pooled against batch-1 decode; (c)
   teacher-forced decode against a cacheless forward over the same
   frames; (f) the smoke model served on the card against the CPU; (v)
   internvl2-26b at full width, depth 48 cut to 4 (2.72 B parameters), its
   flash eval over 2 batches of 2 x 2048 tokens with 1024 patch
   embeddings, flash launched 4 x 2 times.

Launch counts are set to 0 just before each main path and read just after
(for main_pipeline and main_autotune, around each launcher run; for main_rwkv, before and
after its eval walk; for main_serve, around its launcher run, and flash's
again around (d); for main_mla, main_moe and main_hybrid, around each
launcher run, and for main_hybrid around its flash eval (k); for
main_encdec around its training steps, its launcher run and each flash
eval, (k) and (v); rmsnorm, which no model calls, counts its own phase's
checked calls).  Each main
phase prints its wall time (``phase_wall``).
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
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Device-memory bandwidth and dense bf16 tensor-core peak by card (NVIDIA
# data sheets), for the bytes and operations bounds.  The first key found in
# the card's name wins ("NVIDIA H100 80GB HBM3" is the SXM part).
BANDWIDTH = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
PEAK_BF16 = [("H200", 989.4e12), ("H100 NVL", 835.5e12), ("H100 PCIe", 756.5e12),
             ("H100", 989.4e12)]
# fp32 on the CUDA cores (no tensor cores), for the WKV kernel's bound
PEAK_FP32 = [("H200", 67e12), ("H100 NVL", 60e12), ("H100 PCIe", 51e12), ("H100", 67e12)]

MAIN_BS = 64
MAIN_BATCH = (MAIN_BS, 224, 224, 3)
MAIN_ARGS = [
    "--full", "--device", "cuda", "--device-ingest",
    "--items", "1024", "--avg-kb", "115", "--batch-size", str(MAIN_BS),
    "--latency", "0.02", "--loader", "threaded", "--workers", "4", "--fetchers", "16",
    "--steps", "48", "--optimizer", "sgd", "--log-every", "8",
]

# The staged pipeline on the same path: MAIN_ARGS through make_loader with
# PipelineConfig(enabled=True, staging_buffers=PIPE_DEPTH) (io_workers 64 =
# workers x fetchers, cpu_workers 4: the reference's defaults)
PIPE_DEPTH = 4
PIPE_ARGS = MAIN_ARGS + ["--pipeline", "--staging-buffers", str(PIPE_DEPTH)]
# and once with the process CPU executor (4 spawned workers)
PROC_ARGS = PIPE_ARGS + ["--cpu-executor", "process"]
# its checks: 224x224 crops of 115 KB images behind the same simulated S3;
# 16 batches of 32 for the one-buffer reuse and window checks, the first
# 256 items (8 batches) for the process executor
CHECK_ITEMS, CHECK_BS, CHECK_WINDOW, CHECK_WAIT_S = 512, 32, 4, 0.05
PROC_ITEMS, PROC_WORKERS = 256, 2
# the one-buffer check holds a delay kernel (about 0.1 s) on the ring's side
# stream in front of every copy, so each copy lands well after the ring
# thread could collate the next batch into the same buffer
CHECK_DELAY_CYCLES = 200_000_000
STAGE_SPANS = ("get_batch", "batch_to_device", "run_training_batch", "stage_fetch",
               "stage_decode", "stage_augment", "stage_collate")


def with_values(args: list, **values) -> list:
    """``args`` with the value after each ``--flag`` (``flag`` spelt with
    underscores) replaced."""
    out = list(args)
    for flag, value in values.items():
        out[out.index("--" + flag.replace("_", "-")) + 1] = str(value)
    return out


# The autotuned path: the pipeline cell at 8192 items, 128 batches an epoch
# over 3 epochs, so the controller has windows to act in each epoch (a
# window closes after 4 batches and 0.2 s) even after a probe of the
# outstanding-batches knob to its ceiling (64) has dispatched half an epoch
# ahead; fixed knobs, then --autotune, then --thread-budget AUTO_BUDGET, the
# fixed run's width (64 IO + 4 CPU).
AUTO_ITEMS, AUTO_STEPS, AUTO_BUDGET = 8192, 384, 68
AUTO_ARGS = with_values(PIPE_ARGS, items=AUTO_ITEMS, steps=AUTO_STEPS, log_every=128)
AUTO_RUNS = [("fixed", AUTO_ARGS), ("autotune", AUTO_ARGS + ["--autotune"]),
             ("thread_budget", AUTO_ARGS + ["--thread-budget", str(AUTO_BUDGET)])]
# The live CPU executor swap under the same budget, turned by its knob on
# the ring's thread between batches as the controller turns it: 16 batches
# of 32 at full image size, to the process kind after batch 2 and back after
# batch 10 (the controller itself flips it only while the util gate is open)
SWAP_FLIPS = {2: 1, 10: 0}

# The LM path: granite-8b at full width, depth cut to 4 of its 36 layers (36
# layers with AdamW need about 132 GB, more than one card holds) and
# registered under LM_ARCH, granite's 4096-token context, 2 microbatches a
# step, 8 batches an epoch so 16 steps cross an epoch boundary.
LM_ARCH, LM_LAYERS = "granite-8b-4l", 4
LM_BS, LM_SEQ, LM_ITEMS, LM_STEPS, LM_EVAL_BATCHES = 4, 4096, 32, 16, 4
LM_ARGS = [
    "--arch", LM_ARCH, "--full", "--device", "cuda",
    "--items", str(LM_ITEMS), "--batch-size", str(LM_BS), "--seq-len", str(LM_SEQ),
    "--microbatches", "2", "--latency", "0.02", "--loader", "threaded", "--workers", "4",
    "--fetchers", "16", "--steps", str(LM_STEPS), "--optimizer", "adamw", "--log-every", "4",
]
LM_REDUCED = {"num_layers": "36 -> 4 (AdamW state of 36 layers does not fit one card)",
              "items": "32 packed sequences of 4097 tokens", "steps": 16}
# flash_attention at the LM path's shape: q (B,Hq,S,D), kv (B,Hkv,S,D), bf16, causal
FLASH_Q, FLASH_KV = (LM_BS, 32, LM_SEQ, 128), (LM_BS, 8, LM_SEQ, 128)

# The RWKV path: rwkv6-7b at full width, depth cut to 4 of its 32 layers
# (32 layers are 7.53 B parameters, about 120 GB with fp32 AdamW state),
# with main_lm's loader settings, sequences, batch and steps.
RWKV_ARCH, RWKV_LAYERS = "rwkv6-7b-4l", 4
RWKV_ARGS = [a if a != LM_ARCH else RWKV_ARCH for a in LM_ARGS]
RWKV_REDUCED = {"num_layers": "32 -> 4 (AdamW state of 32 layers does not fit one card)",
                "items": "32 packed sequences of 4097 tokens", "steps": 16}
# the WKV kernel at the path's shape: r, k, v, w (B,S,H,D) fp32, 64 heads of 64
WKV_SHAPE = (LM_BS, LM_SEQ, 64, 64)
WKV_CHUNK = 32  # the chunk of the plain scan, for the underflow readings
# RMSNorm at the LM phases' residual stream: (B*S, d_model)
RMS_SHAPE = (LM_BS * LM_SEQ, 4096)
ROW_REL_BF16 = 5e-3  # a bf16 output row's error relative to its norm, as flash's gate

# The serving path: granite-8b whole (36 layers, full width) through
# launch/serve.py at the reference launcher's defaults (32 requests of
# 2-16 prompt tokens and 32 new ones, 8 slots, max_len 256).  Tolerances on
# bf16 logits (random weights put them within about +-5; bf16's spacing
# there is 1/32): a greedy token is a tie where its logit is within
# SERVE_TIE_TOL of the largest; a decode step against a cacheless forward,
# and chunked against single-pass prefill, within SERVE_LOGIT_TOL over the
# whole vocabulary; card against CPU in fp32 with TF32 off within 1e-4.
SERVE_ARGS = ["--arch", "granite-8b", "--full", "--device", "cuda"]
SERVE_TIE_TOL, SERVE_LOGIT_TOL, SERVE_DEVICE_TOL = 0.125, 0.25, 1e-4
SERVE_CHECKED, SERVE_CACHELESS, SERVE_PALLAS_REQUESTS = 4, 2, 4
SERVE_PROFILED = 4  # decode ticks and prefills under torch.profiler after the run
SERVE_LONG, SERVE_LONG_NEW = 16_384, 4  # one prompt of 2 x PREFILL_CHUNK tokens
# RWKV serving: rwkv6-7b at full width, main_rwkv's 4 layers, 8 requests over 4 slots
RWKV_SERVE_REQUESTS, RWKV_SERVE_SLOTS = 8, 4

# The MLA and MoE families.  Training: minicpm3-4b (depth 62 -> 4) and
# granite-moe-3b-a800m (32 -> 4) at full width with main_lm's loader,
# sequences, batch, microbatches and steps.  Serving: minicpm3-4b,
# granite-moe-3b-a800m and qwen2-moe-a2.7b whole, through launch/serve.py at
# the reference launcher's defaults, held as main_serve's granite-8b.
MLA_ARCH, MOE_ARCH, QWEN_ARCH = "minicpm3-4b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b"
MLA_TRAIN_ARCH, MOE_TRAIN_ARCH, FAMILY_LAYERS = "minicpm3-4b-4l", "granite-moe-3b-a800m-4l", 4
MLA_TRAIN_ARGS = [a if a != LM_ARCH else MLA_TRAIN_ARCH for a in LM_ARGS]
MOE_TRAIN_ARGS = [a if a != LM_ARCH else MOE_TRAIN_ARCH for a in LM_ARGS]
MLA_REDUCED = {"num_layers": "62 -> 4, as main_lm", "items": LM_REDUCED["items"],
               "steps": LM_STEPS}
MOE_REDUCED = {"num_layers": "32 -> 4, as main_lm", "items": LM_REDUCED["items"],
               "steps": LM_STEPS}
MLA_SERVE_ARGS = ["--arch", MLA_ARCH, "--full", "--device", "cuda"]
MOE_SERVE_ARGS = ["--arch", MOE_ARCH, "--full", "--device", "cuda"]
QWEN_SERVE_ARGS = ["--arch", QWEN_ARCH, "--full", "--device", "cuda"]
# gather against einsum dispatch on one full-width granite-moe layer at the
# training shape (a microbatch: 2 x 4096 tokens), fp32 with TF32 off, within
# the reference's tests/test_moe_dispatch.py tolerance
MOE_ROUTE_TOL = 2e-5

# The hybrid family, jamba-v0.1-52b.  Training at its smoke widths through
# the launcher with main_lm's loader, sequences, batch, microbatches and
# steps: at full width even 4 layers (6.88 B parameters) do not train on
# one card (ROADMAP §1 item 4.7).  Serving: one full-width period of 8
# layers (13.30 B parameters, every sublayer kind: 7 Mamba mixers and
# attention at index 3, MoE FFNs at the odd indices), registered as
# HYBRID_SERVE_ARCH, at the reference launcher's defaults.
HYBRID_ARCH, HYBRID_SERVE_ARCH, HYBRID_SERVE_LAYERS = "jamba-v0.1-52b", "jamba-v0.1-52b-8l", 8
HYBRID_STACKED_LAYERS = 16  # the smoke model in two stacked blocks of 8
HYBRID_TRAIN_ARGS = [HYBRID_ARCH if a == LM_ARCH else a for a in LM_ARGS if a != "--full"]
HYBRID_TRAIN_REDUCED = {
    "widths": "smoke config (d_model 64, 8 layers): full width does not train on one card "
              "(4 layers are 6.88 B parameters, 110 GB with AdamW state; ROADMAP 4.7)",
    "items": LM_REDUCED["items"], "steps": LM_STEPS}
HYBRID_SERVE_ARGS = ["--arch", HYBRID_SERVE_ARCH, "--full", "--device", "cuda"]
HYBRID_SERVE_REDUCED = {"num_layers": "32 -> 8, one period"}
# (c) the Mamba state carried from prefill to decode on one served layer:
# HYBRID_CARRY_S hidden states, the last HYBRID_CARRY_DECODE of them decoded
# one at a time; each decoded output row within HYBRID_CARRY_TOL of its
# norm of the cacheless row (bf16 compute: 2^-8 relative spacing, the single
# token's projections rounded apart from the batched ones', about 5
# spacings), the fp32 state after them within HYBRID_CARRY_TOL of the
# single pass's largest entry
HYBRID_CARRY_S, HYBRID_CARRY_DECODE, HYBRID_CARRY_TOL = 4096, 4, 2e-2
HYBRID_SCAN_CHUNKS = (64, 128, 256, 512)  # the Mamba scan's chunk, timed at full width
# (k) the flash kernel on the hybrid's attention layer: make_eval_step over
# LM_EVAL_BATCHES batches of HYBRID_EVAL_BS x LM_SEQ tokens, within
# main_lm's 5e-3 of the plain attention's loss
HYBRID_EVAL_BS, HYBRID_EVAL_TOL = 2, 5e-3

# The encoder-decoder, whisper-large-v3 whole (32 + 32 layers, d_model 1280,
# 20 heads of 64, 1.60 B parameters; nothing cut).  (t) ENCDEC_STEPS AdamW
# steps through make_train_step at batch ENCDEC_BS: frames (8, 1500, 1280)
# and ENCDEC_TEXT text tokens a row (whisper's n_text_ctx), drawn on the
# card from a seed, tokens and targets from a Zipf (1/rank) unigram over the
# vocabulary, as text's are (uniform targets leave nothing to learn but the
# logits' scale); whisper-large's peak learning rate, 1.75e-4
# (arXiv:2212.04356, Appendix F), warmed up linearly over the 8 steps (at
# 3e-4 from the first step the loss jumped from 11.2 to 16.7 and 17.6);
# the last step under torch.profiler.  (k) make_eval_step
# with the flash kernel against the plain attention over ENCDEC_EVAL_BATCHES
# of those batches, within main_lm's 5e-3; the flash call at the model's
# shape timed beside the plain attention and SDPA.  (a) served through
# launch/serve.py at the reference launcher's defaults, main_serve's (b),
# (c) against a cacheless forward over the same (zero) frames, and (f).
# (v) internvl2-26b at full width, depth 48 -> 4, make_eval_step with the
# flash kernel against the plain attention over 2 batches of VLM_EVAL_BS x
# VLM_EVAL_SEQ tokens with its 1024 patch embeddings.
ENCDEC_ARCH, VLM_ARCH = "whisper-large-v3", "internvl2-26b"
ENCDEC_BS, ENCDEC_TEXT, ENCDEC_STEPS, ENCDEC_EVAL_BATCHES = 8, 448, 8, 2
ENCDEC_LR, ENCDEC_EVAL_TOL = 1.75e-4, 5e-3
ENCDEC_SERVE_ARGS = ["--arch", ENCDEC_ARCH, "--full", "--device", "cuda"]
VLM_EVAL_ARCH, VLM_LAYERS, VLM_EVAL_BS, VLM_EVAL_SEQ = "internvl2-26b-4l", 4, 2, 2048
VLM_REDUCED = {"num_layers": "48 -> 4 (48 layers are 19.88 B parameters, 79.5 GB of fp32 "
                             "weights)"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def lookup(table, name: str):
    """The card's entry in ``table``, or None for a card the table does not
    know: no other card's number is quoted for it."""
    for key, value in table:
        if key in name:
            return value
    return None


def bound_ms(nbytes: float, flops: float, bw, peak):
    """(least time in ms, what bounds it): the larger of ``nbytes`` over the
    memory rate and ``flops`` over the peak; None where a rate this bound
    needs is unknown for the card."""
    t_bytes = nbytes / bw * 1e3 if bw else None
    t_ops = 0.0 if not flops else (flops / peak * 1e3 if peak else None)
    if t_bytes is None or t_ops is None:
        return None, "operations" if flops else "bytes"
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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


def cold_ms(fn, scratch, runs: int = 20) -> float:
    """Device time of one call with a cold L2: the median over ``runs`` of
    CUDA-event time around a single call, each after a write of ``scratch``
    (more than the 50 MB L2).  The sleep kernel ahead keeps the device busy
    while the host enqueues the write, the events and the call, so the
    events time the kernel alone."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # cycles
        scratch.fill_(1)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_of(log: str, pattern: str) -> list:
    """The entries of ``ptxas_summary(log)`` whose mangled name matches
    ``pattern``."""
    import re

    return [e for e in ptxas_summary(log) if re.search(pattern, e["entry"])]


def phase_kernels(torch, ops, ref, bw) -> dict:
    from repro_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

    gen = torch.Generator().manual_seed(0)
    limits = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    cases = []
    for shape in [MAIN_BATCH, (3, 31, 17, 3), (2, 24, 24, 4), (1, 9, 40, 1), (5, 8, 8, 2),
                  (2, 224, 224, 4), (2, 30, 224, 3)]:
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
            cases.append({"shape": list(shape), "dtype": str(dt),
                          "path": ops.path_for(img.shape, dt, img.data_ptr()),
                          "max_abs_err": err, "limit": limits[dt]})
            if not err <= limits[dt]:
                fail(f"ingest_norm {shape} {dt}: max abs err {err} > {limits[dt]}")
    B, H, W, C = MAIN_BATCH
    img = torch.randint(0, 256, MAIN_BATCH, dtype=torch.uint8, generator=gen).cuda()
    mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
    mean_d, std_d = mean.cuda(), std.cuda()
    kernel = lambda: ops.ingest_norm(img, mean, std)  # noqa: E731
    plain = lambda: ref.ingest_norm_ref(img, mean_d, std_d)  # noqa: E731
    kernel_ms, plain_ms = device_ms(kernel), device_ms(plain)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    kernel_cold_ms = cold_ms(kernel, scratch)
    del scratch
    kernel_call_ms, plain_call_ms = call_ms(kernel), call_ms(plain)
    nbytes = B * H * W * C * (1 + 4)  # u8 in, f32 out, each touched once
    main_err = next(c["max_abs_err"] for c in cases
                    if c["shape"] == list(MAIN_BATCH) and c["dtype"] == str(torch.float32))
    log = ops.build().log
    out = {"phase": "kernels", "cases": cases, "kernel": "ingest_norm",
           "shape": list(MAIN_BATCH), "out_dtype": "float32",
           "path": ops.path_for(MAIN_BATCH, torch.float32, img.data_ptr()),
           "max_abs_err": main_err,
           "kernel_ms": kernel_ms, "kernel_cold_ms": kernel_cold_ms, "plain_ms": plain_ms,
           "kernel_call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
           "bound_ms": bound_ms(nbytes, 0, bw, None)[0], "bound_bytes": nbytes,
           "cold_gb_per_s": nbytes / kernel_cold_ms / 1e6,
           "ptxas": {"f32 C=3 vector": ptxas_of(log, r"ingest_norm_kernelIfLi3ELb1E"),
                     "f32 C=3 scalar": ptxas_of(log, r"ingest_norm_kernelIfLi3ELb0E"),
                     "spilling": [e for e in ptxas_summary(log) if e.get("spill_bytes")]},
           "occupancy": [ops.occupancy(C, torch.float32, path) for path in ("vector", "scalar")]}
    emit(out)
    return out


def ptxas_summary(log: str) -> list:
    """Each kernel entry's registers, spills and static shared memory from
    nvcc's ``-Xptxas -v`` log."""
    import re

    out, entry = [], {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = {"entry": m.group(1)}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and "entry" in entry:
            smem = re.search(r"(\d+) bytes smem", line)
            entry.update(registers=int(m.group(1)),
                         static_smem_bytes=int(smem.group(1)) if smem else 0)
            out.append(entry)
            entry = {}
    return out


def phase_flash(torch, ops, ref, bw, peak) -> dict:
    """flash_attention against its plain version at the LM path's shape and
    at ragged, small ones, every head dim the wrapper takes, each case on
    the route the wrapper gives it; device times of the bf16 kernel, the
    plain version, the library yardstick ``scaled_dot_product_attention``
    and the fp32 CUDA-core kernel at the path shape."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(0)
    limits = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's TOL
    # Each output row's error relative to its own size.  An elementwise
    # limit alone is blind where the outputs are small (late rows average
    # thousands of keys); a skipped rescale or a dropped or repeated kv tile
    # moves a row by 1e-2 to 1 of its norm, where bf16 rounding moves it
    # about 1e-3.
    row_limits = {torch.float32: 1e-5, torch.bfloat16: 5e-3}

    def inputs(qshape, kvshape, dt):
        # unscaled N(0,1): the scaled scores have unit spread, so the
        # softmax is peaked and the running max moves across kv tiles
        q, k, v = (torch.randn(s, generator=gen) for s in (qshape, kvshape, kvshape))
        return q.to(dt).cuda(), k.to(dt).cuda(), v.to(dt).cuda()

    def check(q, k, v, causal, dt, label):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != dt:
            fail(f"flash_attention {label}: got {tuple(got.shape)} {got.dtype}")
        diff, ref_f = got.float() - want.float(), want.float()
        err = diff.abs().max().item()
        tol = limits[dt]  # |got - want| <= atol + rtol * |want|, as assert_allclose
        close = bool(torch.all(diff.abs() <= tol + tol * ref_f.abs()).item())
        row_err = (diff.norm(dim=-1) / ref_f.norm(dim=-1).clamp_min(1e-30)).max().item()
        ok = close and row_err <= row_limits[dt]
        case = {"q": list(q.shape), "kv": list(k.shape), "dtype": str(dt), "causal": causal,
                "route": ops.route(dt, q.shape[-1]), "max_abs_err": err, "rtol": tol,
                "atol": tol, "max_row_rel_err": row_err, "row_rel_limit": row_limits[dt],
                "ok": ok}
        if not ok:
            emit({"phase": "kernels/flash_attention", "failed_case": case})
            fail(f"flash_attention {label}: max abs err {err} (rtol=atol={tol}), "
                 f"row-relative err {row_err} (limit {row_limits[dt]})")
        return case

    cases = []
    for S in (50, 200):
        for D in ops.HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = inputs((2, 4, S, D), (2, 2, S, D), dt)
                cases.append(check(q, k, v, True, dt, f"S={S} D={D}"))
                T = S if S <= ops.REF_BLOCK_K else 256  # non-causal at a block-multiple T
                q, k, v = inputs((2, 4, S, D), (2, 2, T, D), dt)
                cases.append(check(q, k, v, False, dt, f"S={S} T={T} D={D} non-causal"))
    q, k, v = inputs(FLASH_Q, FLASH_KV, torch.bfloat16)
    main_case = check(q, k, v, True, torch.bfloat16, "path shape")
    cases.append(main_case)

    kernel = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: ref.attention_ref(q, k, v, causal=True)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    kernel_ms = device_ms(kernel, runs=10, per_run=2)
    plain_ms = device_ms(plain, runs=5, per_run=2, warmup=1)
    library_ms = device_ms(library, runs=10, per_run=5)
    q32, k32, v32 = q.float(), k.float(), v.float()
    fp32_case = check(q32, k32, v32, True, torch.float32, "path shape fp32")
    fp32_kernel_ms = device_ms(lambda: ops.flash_attention(q32, k32, v32, causal=True),
                               runs=3, per_run=1, warmup=1)
    del q32, k32, v32
    B, Hq, S, D = FLASH_Q
    Hkv = FLASH_KV[1]
    flops = 2.0 * B * Hq * S * S * D  # q k^T and p v over the causal triangle
    nbytes = B * (2 * Hq * S + 2 * Hkv * S) * D * 2  # q, o and k, v in bf16, once each
    bound, bound_by = bound_ms(nbytes, flops, bw, peak)
    lib = ops.build_tensor_core()
    out = {"phase": "kernels/flash_attention", "kernel": "flash_attention",
           "q": list(FLASH_Q), "kv": list(FLASH_KV), "dtype": "bfloat16", "causal": True,
           "route": ops.route(torch.bfloat16, D),
           "max_abs_err": main_case["max_abs_err"],
           "max_row_rel_err": main_case["max_row_rel_err"], "cases": cases,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "scaled_dot_product_attention(q, k, v, is_causal=True, "
                           "enable_gqa=True)",
           "kernel_tflops": flops / kernel_ms / 1e9,
           "fp32_kernel_ms": fp32_kernel_ms, "fp32_route": fp32_case["route"],
           "fp32_max_abs_err": fp32_case["max_abs_err"],
           "tensor_core_ptxas": ptxas_summary(lib.log),
           "tensor_core_dynamic_smem_bytes": {
               d: lib.lib.flash_attention_sm90_smem_bytes(d) for d in ops.TENSOR_CORE_HEAD_DIMS},
           "bound_ms": bound, "bound_by": bound_by, "flops": flops, "bound_bytes": nbytes,
           "bytes_bound_ms": nbytes / bw * 1e3 if bw else None,
           "ops_bound_ms": flops / peak * 1e3 if peak else None, "peak_bf16_flops": peak}
    emit(out)
    return out


def phase_model(torch) -> dict:
    import numpy as np

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.convert import resnet_state_from_jax, resnet_to_jax
    from repro_torch.models.resnet import init_resnet
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.steps import make_resnet_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("resnet18-imagenet", smoke=True)
    tcfg = TrainConfig(optimizer="sgd", learning_rate=0.1, warmup_steps=1)
    params, bn = init_resnet(cfg, torch.Generator().manual_seed(1), "cpu")
    np_params, np_bn = resnet_to_jax(params), resnet_to_jax(bn)  # the reference's layout
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


def phase_model_lm(torch) -> dict:
    """The granite-8b smoke decoder: two AdamW steps on the card against the
    CPU from the same converted weights, in fp32 with TF32 off (so the two
    devices differ only in summation order), and on the card the flash
    route's forward loss against the plain attention's in bf16."""
    import dataclasses

    import numpy as np

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.convert import lm_params_from_jax, to_jax
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.steps import lm_train_state, make_eval_step, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("granite-8b", smoke=True)
    f32 = dataclasses.replace(cfg, dtype="float32")
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=1)
    np_params = to_jax(init_lm(cfg, torch.Generator().manual_seed(1), "cpu"))
    rng = np.random.default_rng(2)
    batches = [{k: rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    losses = {}
    for dev in ("cpu", "cuda"):
        state = lm_train_state(lm_params_from_jax(np_params, dev), tcfg)
        step = make_train_step(f32, tcfg)
        losses[dev] = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses[dev].append(m["loss"].item())
    diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    params = lm_params_from_jax(np_params, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in batches[0].items()}
    pallas = dataclasses.replace(cfg, attention_impl="pallas")
    loss_flash = make_eval_step(pallas)(params, batch)["loss"].item()
    loss_ref = make_eval_step(cfg)(params, batch)["loss"].item()
    out = {"phase": "model_lm", "arch": cfg.name, "steps": 2, "dtype_steps": "float32",
           "loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"], "max_loss_diff": diff,
           "limit": 1e-4, "loss_flash_bf16": loss_flash, "loss_ref_bf16": loss_ref,
           "flash_vs_ref": abs(loss_flash - loss_ref), "flash_limit": 5e-3,
           "cudnn_allow_tf32": False, "matmul_allow_tf32": False}
    emit(out)
    if not all(math.isfinite(x) for x in losses["cuda"]) or not diff <= 1e-4:
        fail(f"LM train steps on the card differ from the CPU: {losses}")
    if not abs(loss_flash - loss_ref) <= 5e-3:
        fail(f"flash route loss {loss_flash} vs plain attention {loss_ref} on the card")
    return out


def span_stats(tracer, names=("get_batch", "batch_to_device", "run_training_batch")) -> dict:
    out = {}
    for name in names:
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


def run_figures(out: dict) -> dict:
    """The figures the main runs are compared by: items/s over the run and
    after the first step, the Table-3 columns and the step's span medians."""
    return {k: out[k] for k in ("items_per_s", "items_per_s_after_first_step", "wall_s",
                                "first_step_ms", "util_zero_pct", "util_pos_avg",
                                "busy_fraction")} | {
        "batch_to_device_median_ms": out["spans"]["batch_to_device"]["median_ms"],
        "batch_to_device_total_s": out["batch_to_device_total_s"],
        "get_batch_median_ms": out["spans"]["get_batch"]["median_ms"],
        "run_training_batch_median_ms": out["spans"]["run_training_batch"]["median_ms"]}


class ModulesProbe:
    """Wraps a split dataset for the process-executor check: every sample
    gains ``torch_loaded``, whether ``torch`` was in ``sys.modules`` of the
    process that ran its augment stage.  Defined at module level, so a
    spawned CPU worker unpickles it from this script, which imports no
    torch at module level."""

    def __init__(self, data) -> None:
        self.data = data

    def __len__(self) -> int:
        return len(self.data)

    def set_epoch(self, epoch: int) -> None:
        self.data.set_epoch(epoch)

    def supports_split(self) -> bool:
        return True

    def get_raw(self, index: int) -> bytes:
        return self.data.get_raw(index)

    async def aget_raw(self, index: int) -> bytes:
        return await self.data.aget_raw(index)

    def decode_raw(self, raw: bytes, index: int):
        return self.data.decode_raw(raw, index)

    def augment_item(self, decoded, index: int) -> dict:
        return {**self.data.augment_item(decoded, index), "torch_loaded": "torch" in sys.modules}

    def __getitem__(self, index: int) -> dict:
        return self.augment_item(self.decode_raw(self.get_raw(index), index), index)

    async def aget_item(self, index: int) -> dict:
        return self[index]


class H2DWatch:
    """For the runs inside it, wraps the device prefetch ring's transfer and
    records, for every batch it copied to the card, the state the copy left
    behind, read without changing it: whether the batch lies in a pooled
    staging set's own buffers (same ``data_ptr``) and that set is pinned in
    place (the pool's flag, and ``is_pinned()`` on the buffers' memory).
    Nothing here pins: only the ring can have.  What the ring copied from is
    its own record, each ``batch_to_device`` span's ``source``
    (:func:`h2d_sources`)."""

    def __init__(self) -> None:
        self.rows: list = []

    def __enter__(self) -> "H2DWatch":
        import torch

        from repro_torch.core.prefetch import DevicePrefetchRing

        self.cls, self.put = DevicePrefetchRing, DevicePrefetchRing._put_device
        watch = self

        def put(ring, batch):
            out = watch.put(ring, batch)
            bufs = getattr(batch, "_bufs", None)
            if bufs is None:
                watch.rows.append("unstaged")
            elif not batch.pooled:
                watch.rows.append("past_depth")
            else:
                own = all(v.ctypes.data == bufs[k].ctypes.data
                          and torch.from_numpy(v).is_pinned() for k, v in batch.items())
                watch.rows.append("pooled_pinned" if bufs.pinned and own
                                  else "pooled_unpinned")
            return out

        DevicePrefetchRing._put_device = put
        return self

    def __exit__(self, *exc) -> None:
        self.cls._put_device = self.put

    def counts(self) -> dict:
        return {r: self.rows.count(r) for r in sorted(set(self.rows))}


def h2d_sources(tracer) -> dict:
    """What the ring says each copy to the card read: the ``source`` tag of
    every ``batch_to_device`` span, counted."""
    tags = [str(s.args.get("source")) for s in tracer.spans("batch_to_device")]
    return {t: tags.count(t) for t in sorted(set(tags))}


def pipeline_run(torch, ops, args: list, label: str, steps: int = 48):
    """One run of the ResNet path through the launcher and the staged
    pipeline, its launches counted from 0 and every H2D watched; fails on
    any gate of (a).  Returns its figures and the launcher's report."""
    from repro_torch.launch import train as launch
    from repro_torch.tree import leaves

    ops.ingest_norm.launches = 0
    with H2DWatch() as watch:
        report = launch.run(args)
    launches = ops.ingest_norm.launches
    losses = [h["loss"] for h in report.result.history]
    devices = sorted({str(p.device.type) for p in leaves(report.state["params"])})
    ends = sorted(sp.t1 for sp in report.tracer.spans("run_training_batch"))
    staging = [st["staging"] for st in report.stages]
    out = {
        "label": label, "args": args, "steps": report.result.steps,
        "epochs": report.result.epochs, "wall_s": report.result.wall_s,
        "items_per_s": report.items_per_s,
        "items_per_s_after_first_step":
            (len(ends) - 1) * MAIN_BS / (ends[-1] - ends[0]) if len(ends) > 1 else None,
        "first_step_ms": 1e3 * report.tracer.spans("run_training_batch")[0].duration,
        "util_zero_pct": report.util.util_zero_pct, "util_pos_avg": report.util.util_pos_avg,
        "busy_fraction": report.util.busy_fraction,
        "batches_transferred": report.batches_transferred,
        "batch_to_device_total_s": report.batch_to_device_s,
        "h2d": watch.counts(), "h2d_sources": h2d_sources(report.tracer),
        "ingest_norm_launches": launches,
        "spans": span_stats(report.tracer, STAGE_SPANS),
        "queues_per_epoch": [{k: st[k] for k in ("decode_queue", "done_queue",
                                                 "in_flight_samples", "io_workers",
                                                 "cpu_workers", "cpu_executor")}
                             for st in report.stages],
        "staging_per_epoch": staging,
        "cpu_pool_per_epoch": [st.get("cpu_pool") for st in report.stages],
        "bytes_copied": report.tracer.counter("bytes_copied"),
        "first_loss": losses[0] if losses else None, "last_loss": losses[-1] if losses else None,
        "param_devices": devices,
    }
    emit({"phase": "main_pipeline_run", **out})
    n = report.batches_transferred
    if report.result.steps < steps or report.result.epochs < 3:
        fail(f"{label}: ran {report.result.steps} steps over {report.result.epochs} epochs")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss: {losses}")
    if launches == 0 or launches != n:
        fail(f"{label}: ingest_norm launched {launches} times for {n} batches transferred")
    if out["h2d_sources"] != {"staging": n} or watch.counts() != {"pooled_pinned": n}:
        fail(f"{label}: of {n} copies to the card, not all read a pooled pinned staging set: "
             f"ring's sources {out['h2d_sources']}, sets after the copy {watch.counts()}")
    # the ring collates the next batch only after the last copy landed and
    # its set was released, so one set, registered once, serves each epoch
    if len(staging) != report.result.epochs or any(
            st["detached"] or st["allocs"] != 1 or st["registered"] != 1
            or st["reuses"] != st["leases"] - 1 for st in staging):
        fail(f"{label}: staging did not serve each epoch from one set registered once: "
             f"{staging}")
    if any(p and p["crashes"] for p in out["cpu_pool_per_epoch"]):
        fail(f"{label}: process workers crashed: {out['cpu_pool_per_epoch']}")
    if devices != ["cuda"]:
        fail(f"{label}: params live on {devices}, not on cuda")
    return out, report


def early_release_ring(torch):
    """The device prefetch ring with the fault the one-buffer check exists
    for: a staged batch's buffers are released as soon as its copy is
    enqueued, and the ring moves on without waiting for it, so the next
    collate writes into the buffer before the DMA has read it."""
    from repro_torch.core.prefetch import DevicePrefetchRing

    class EarlyRelease(DevicePrefetchRing):
        def _put_device(self, batch):
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                host, _ = batch.pin()
                dev = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
                batch.release_after(dev)  # the planted fault: before the copy landed
                dev = self.ingest_fn(dev)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            return dev, ready

    return EarlyRelease


def delayed(torch, ring_cls):
    """``ring_cls`` with a delay kernel on its side stream in front of every
    copy, so each copy lands well after the ring thread could collate the
    next batch into the same buffer."""

    class Delayed(ring_cls):
        def _put_device(self, batch):
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                torch.cuda._sleep(CHECK_DELAY_CYCLES)
            return super()._put_device(batch)

    return Delayed


def device_stream(torch, loader, ingest_fn, tracer, wait_s: float = 0.0,
                  ring_cls=None) -> list:
    """Every batch of one epoch through the device prefetch ring (or
    ``ring_cls``) and the ingest_norm epilogue, kept on the card; with
    ``wait_s`` the consumer sleeps before each step, so the ring runs ahead
    of it."""
    from repro_torch.core.prefetch import DevicePrefetchRing

    ring = (ring_cls or DevicePrefetchRing)(iter(loader), depth=2, tracer=tracer,
                                            ingest_fn=ingest_fn, device="cuda")
    out = []
    try:
        for batch in ring:
            if wait_s:
                time.sleep(wait_s)
            out.append(batch)
    finally:
        ring.close()
    torch.cuda.synchronize()
    return out


def phase_main_pipeline(torch, ops, legacy: dict, smi: str) -> dict:
    from repro_torch.config import LoaderConfig, PipelineConfig, StoreConfig
    from repro_torch.core import make_loader
    from repro_torch.core.prefetch import DevicePrefetchRing
    from repro_torch.core.tracing import Tracer
    from repro_torch.data.dataset import ImageDataset
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet
    from repro_torch.data.store import build_store
    from repro_torch.kernels.ingest_norm.ops import make_ingest_fn

    # (a) the main run, as phase_main's but through make_loader and the
    # staged pipeline; then the same with the process CPU executor
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    main, _ = pipeline_run(torch, ops, PIPE_ARGS, "pipeline")
    proc_run, _ = pipeline_run(torch, ops, PROC_ARGS, "pipeline_process")
    out = {
        "phase": "main_pipeline", "nvidia_smi": smi, "args": PIPE_ARGS,
        "ingest_norm_launches": main["ingest_norm_launches"],
        "batches_transferred": main["batches_transferred"],
        "figures": {"pipeline": run_figures(main), "pipeline_process": run_figures(proc_run),
                    "legacy": run_figures(legacy)},
        "stage_medians_ms": {
            r["label"]: {k: v["median_ms"] for k, v in r["spans"].items()}
            for r in (main, proc_run)},
        "queues_last_epoch": {r["label"]: r["queues_per_epoch"][-1] for r in (main, proc_run)},
    }
    emit(out)

    # (b)-(d): checks at full image size, each stream through the ring and
    # the ingest_norm epilogue on the card
    ingest = make_ingest_fn()
    base = build_synthetic_imagenet(num_items=CHECK_ITEMS, avg_kb=115.0)

    def loader(n, pipeline=PipelineConfig(), probe=False):
        store = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02), base=base)
        data = ImageDataset(store, n, out_size=224, sim_decode_s_per_mb=0.052,
                            epilogue="device")
        return make_loader(LoaderConfig(impl="threaded", batch_size=CHECK_BS, num_workers=4,
                                        num_fetch_workers=16, seed=0, pipeline=pipeline),
                           ModulesProbe(data) if probe else data)

    def same(x, y, skip=()) -> bool:
        keys = sorted(set(x) - set(skip))
        return keys == sorted(set(y) - set(skip)) and all(torch.equal(x[k], y[k]) for k in keys)

    def differing(a, b, skip=()) -> int:
        if len(a) != len(b):
            fail(f"streams of {len(a)} and {len(b)} batches")
        return sum(not same(x, y, skip) for x, y in zip(a, b, strict=True))

    # (b) one staging buffer, a consumer that waits, each copy held behind a
    # delay kernel: the ring must give the legacy stream, and the same run
    # with its buffer released before the copy landed must not
    one = PipelineConfig(enabled=True, staging_buffers=1)
    want = device_stream(torch, loader(CHECK_ITEMS), ingest, Tracer())
    reuse_loader, tracer = loader(CHECK_ITEMS, one), Tracer()
    with H2DWatch() as watch:
        got = device_stream(torch, reuse_loader, ingest, tracer, wait_s=CHECK_WAIT_S,
                            ring_cls=delayed(torch, DevicePrefetchRing))
    reuse = reuse_loader.stage_stats()["staging"]
    reuse_differing = differing(got, want)
    planted = device_stream(torch, loader(CHECK_ITEMS, one), ingest, Tracer(),
                            wait_s=CHECK_WAIT_S,
                            ring_cls=delayed(torch, early_release_ring(torch)))
    planted_differing = differing(planted, want)
    reuse_batches = len(got)
    del planted
    # (c) window reorder: each window's label multiset is strict's
    win = device_stream(torch, loader(CHECK_ITEMS, PipelineConfig(
        enabled=True, reorder="window", reorder_window=CHECK_WINDOW, staging_buffers=2)),
        ingest, Tracer())

    def windows(stream):
        labels = [b["label"].cpu().tolist() for b in stream]
        return [sorted(sum(labels[i:i + CHECK_WINDOW], []))
                for i in range(0, len(labels), CHECK_WINDOW)]

    window_ok = (len(win) == len(got)
                 and [len(b["label"]) for b in win] == [len(b["label"]) for b in got]
                 and windows(win) == windows(got))
    window_same_order = differing(win, got) == 0
    del want, got, win
    # (d) the process CPU executor against the thread executor; each sample
    # says whether torch was loaded where its augment stage ran
    thread = device_stream(torch, loader(PROC_ITEMS, PipelineConfig(enabled=True), probe=True),
                           ingest, Tracer())
    proc_loader = loader(PROC_ITEMS, PipelineConfig(
        enabled=True, cpu_executor="process", cpu_workers=PROC_WORKERS), probe=True)
    try:
        proc = device_stream(torch, proc_loader, ingest, Tracer())
        pool = proc_loader.stage_stats()["cpu_pool"]
    finally:
        proc_loader.close()
    proc_differing = differing(proc, thread, skip=("torch_loaded",))
    loaded = {"thread": sorted({bool(x) for b in thread for x in b["torch_loaded"].tolist()}),
              "process": sorted({bool(x) for b in proc for x in b["torch_loaded"].tolist()})}
    checks = {
        "phase": "main_pipeline_checks", "items": CHECK_ITEMS, "batch": CHECK_BS,
        "one_buffer": {"batches": reuse_batches, "staging": reuse, "h2d": watch.counts(),
                       "h2d_sources": h2d_sources(tracer),
                       "consumer_wait_s": CHECK_WAIT_S, "delay_cycles": CHECK_DELAY_CYCLES,
                       "batches_differing_from_legacy": reuse_differing,
                       "planted_early_release_batches_differing": planted_differing},
        "window": {"window": CHECK_WINDOW, "multisets_equal": window_ok,
                   "same_order_as_strict": window_same_order},
        "process": {"items": PROC_ITEMS, "workers": PROC_WORKERS, "batches": len(proc),
                    "batches_differing_from_thread": proc_differing, "pool": pool,
                    "torch_in_sys_modules": loaded},
    }
    emit(checks)
    if reuse_batches < 12 or reuse["leases"] < reuse_batches or reuse_differing:
        fail(f"one staging buffer: {reuse_differing} device batches differ from the legacy "
             f"stream ({reuse})")
    if (reuse["allocs"] != 1 or reuse["detached"] or reuse["registered"] != 1
            or reuse["reuses"] != reuse["leases"] - 1
            or h2d_sources(tracer) != {"staging": reuse_batches}
            or watch.counts() != {"pooled_pinned": reuse_batches}):
        fail(f"one staging buffer: {reuse}, ring's sources {h2d_sources(tracer)}, "
             f"sets after the copy {watch.counts()}")
    if not planted_differing:
        fail("one staging buffer: a release planted ahead of the copy went unseen")
    if not window_ok:
        fail("window reorder changed a window's label multiset")
    if len(proc) != PROC_ITEMS // CHECK_BS or proc_differing:
        fail(f"process executor: {len(proc)} batches, {proc_differing} differ from thread")
    if loaded != {"thread": [True], "process": [False]}:
        fail(f"torch in sys.modules where samples were augmented: {loaded}")
    if pool["crashes"] or pool["workers"] != PROC_WORKERS:
        fail(f"process workers: {pool}")
    out["checks"] = checks
    return out


class DeviceDigest:
    """For the runs inside it, wraps each device prefetch ring's ingest
    epilogue: every batch the ring copied to the card first leaves a digest
    there, on the ring's stream, before ``ingest_norm`` reads it: the
    labels, each sample's u8 byte sum, and each sample's sum of every byte
    times (its position mod 251, plus 1).  Read after the run."""

    def __enter__(self) -> "DeviceDigest":
        import torch

        from repro_torch.core.prefetch import DevicePrefetchRing

        self.cls, self.init = DevicePrefetchRing, DevicePrefetchRing.__init__
        self.rows: list = []
        watch = self

        def digest(dev):
            img = dev["image"]
            flat = img.reshape(img.shape[0], -1)
            w = torch.arange(flat.shape[1], device=img.device, dtype=torch.int32) % 251 + 1
            return torch.cat([dev["label"].reshape(-1).to(torch.int64),
                              flat.sum(1, dtype=torch.int64),
                              (flat.to(torch.int32) * w).sum(1, dtype=torch.int64)])

        def init(ring, it, **kw):
            # wrapped before the ring's thread starts, so its first batch too
            inner = kw["ingest_fn"]

            def digesting(dev):
                watch.rows.append(digest(dev))
                return inner(dev)

            watch.init(ring, it, **{**kw, "ingest_fn": digesting})

        DevicePrefetchRing.__init__ = init
        return self

    def __exit__(self, *exc) -> None:
        self.cls.__init__ = self.init

    def digests(self, torch) -> list:
        torch.cuda.synchronize()
        return [tuple(t.cpu().tolist()) for t in self.rows]


class JudgedWindows:
    """For the runs inside it, records every window the autotuner closes:
    the batch count, the window's batches/s, the phase the controller was in
    and what its utilization signal read then; and every probe as (batch,
    knob, value before, value probed)."""

    def __enter__(self) -> "JudgedWindows":
        from repro_torch.core.autotune import AutotuneController

        self.cls = AutotuneController
        self.step, self.log = AutotuneController._step, AutotuneController._log
        self.rows: list = []
        self.probes: list = []
        watch = self

        def step(ctrl, tput):
            util = ctrl.util_fn() if ctrl.util_fn is not None else None
            watch.rows.append({"batch": ctrl._batches, "batches_per_s": tput,
                               "phase": ctrl._phase, "util": util})
            return watch.step(ctrl, tput)

        def log(ctrl, action, knob, value, tput):
            if action == "probe":
                p = ctrl._probe
                watch.probes.append([ctrl._batches, knob, p.old_value, p.new_value])
            return watch.log(ctrl, action, knob, value, tput)

        AutotuneController._step, AutotuneController._log = step, log
        return self

    def __exit__(self, *exc) -> None:
        self.cls._step, self.cls._log = self.step, self.log


class Swapping:
    """Iterates ``loader`` for the device ring and, after each batch named
    in ``flips``, sets the loader's ``cpu_executor`` knob to its value, on
    the ring's thread between batches, as the controller does.  Records the
    thread and the value applied."""

    def __init__(self, loader, flips: dict) -> None:
        self.loader, self.flips, self.turns = loader, flips, []

    def __iter__(self):
        it = iter(self.loader)  # binds this epoch's knobs
        knob = next(k for k in self.loader.autotuner.knobs if k.name == "cpu_executor")
        for i, batch in enumerate(it):
            yield batch
            if i in self.flips:
                self.turns.append([threading.current_thread().name, knob.set(self.flips[i])])


def executor_swap_check(torch) -> dict:
    """(e) The budget pipeline's CPU stage swapped from threads to spawned
    processes and back in the middle of an epoch at full image size: the
    device stream equals the thread-only stream, the processes decoded
    samples without torch loaded, and every spawn ran on the stage's pump
    thread, none on the ring's."""
    from repro_torch.config import AutotuneConfig, LoaderConfig, PipelineConfig, StoreConfig
    from repro_torch.core import make_loader
    from repro_torch.core import pipeline as P
    from repro_torch.core.tracing import Tracer
    from repro_torch.data.dataset import ImageDataset
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet
    from repro_torch.data.store import build_store
    from repro_torch.kernels.ingest_norm.ops import make_ingest_fn

    ingest = make_ingest_fn()
    base = build_synthetic_imagenet(num_items=CHECK_ITEMS, avg_kb=115.0)

    def loader(tuned: bool):
        store = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02), base=base)
        data = ImageDataset(store, CHECK_ITEMS, out_size=224, sim_decode_s_per_mb=0.052,
                            epilogue="device")
        # the controller is built and binds its knobs, but never closes a
        # window; 4 batches outstanding, so the processes get the epoch's
        # middle to decode
        at = AutotuneConfig(enabled=True, thread_budget=AUTO_BUDGET, interval_batches=10**6)
        return make_loader(LoaderConfig(
            impl="threaded", batch_size=CHECK_BS, num_workers=4, prefetch_factor=1,
            num_fetch_workers=16, seed=0,
            pipeline=PipelineConfig(enabled=True, staging_buffers=2),
            autotune=at if tuned else AutotuneConfig()), ModulesProbe(data))

    spawned_on: list = []
    spawn = P._CPUProcessPool.spawn_one

    def recording(pool):
        spawned_on.append(threading.current_thread().name)
        spawn(pool)

    want = device_stream(torch, loader(False), ingest, Tracer())
    swap_loader = loader(True)
    swapping = Swapping(swap_loader, SWAP_FLIPS)
    P._CPUProcessPool.spawn_one = recording
    try:
        got = device_stream(torch, swapping, ingest, Tracer())
        stats = swap_loader.stage_stats()
    finally:
        P._CPUProcessPool.spawn_one = spawn
        swap_loader.close()
    keys = sorted(set(want[0]) - {"torch_loaded"}) if want else []
    differ = sum(not all(torch.equal(x[k], y[k]) for k in keys)
                 for x, y in zip(got, want)) + abs(len(got) - len(want))
    loaded = {"thread": sorted({bool(v) for b in want for v in b["torch_loaded"].tolist()}),
              "swapped": sorted({bool(v) for b in got for v in b["torch_loaded"].tolist()})}
    out = {"phase": "main_autotune_swap", "items": CHECK_ITEMS, "batch": CHECK_BS,
           "thread_budget": AUTO_BUDGET, "flips": SWAP_FLIPS, "turns": swapping.turns,
           "spawned_on": sorted(set(spawned_on)), "spawns": len(spawned_on),
           "batches": len(got), "batches_differing_from_thread": differ,
           "torch_in_sys_modules": loaded, "cpu_executor_at_end": stats["cpu_executor"],
           "cpu_pool": stats.get("cpu_pool"), "transport": stats.get("transport"),
           "io_plus_cpu": stats["io_workers"] + stats["cpu_workers"]}
    emit(out)
    if len(got) != CHECK_ITEMS // CHECK_BS or differ:
        fail(f"executor swap: {differ} of {len(got)} device batches differ from the thread "
             "stream")
    if [t[1] for t in swapping.turns] != list(SWAP_FLIPS.values()) or any(
            t[0] != "device-prefetch" for t in swapping.turns):
        fail(f"executor swap: knob turns {swapping.turns}, wanted {SWAP_FLIPS} on the ring")
    if not spawned_on or set(spawned_on) != {"pipe-cpu-pool-pump"}:
        fail(f"executor swap: spawns ran on {sorted(set(spawned_on))}, not only the pump")
    if (not out["transport"] or not out["transport"]["pipe_samples"]
            or out["cpu_pool"]["crashes"] or loaded["swapped"] != [False, True]
            or out["cpu_executor_at_end"] != "thread" or out["io_plus_cpu"] != AUTO_BUDGET):
        fail(f"executor swap: {out}")
    return out


def epoch_rates(tracer, per_epoch: int) -> list:
    """Items/s of each epoch: its steps' items over the time from the end of
    the previous epoch's last step (the run's first step start for epoch
    0) to the end of its own last step."""
    spans = sorted(tracer.spans("run_training_batch"), key=lambda sp: sp.t0)
    out, start = [], spans[0].t0 if spans else 0.0
    for i in range(0, len(spans), per_epoch):
        chunk = spans[i:i + per_epoch]
        out.append(len(chunk) * MAIN_BS / (chunk[-1].t1 - start))
        start = chunk[-1].t1
    return out


def phase_main_autotune(torch, ops, legacy: dict, pipe: dict, smi: str) -> dict:
    """The pipeline cell three times (fixed knobs, --autotune,
    --thread-budget), each through pipeline_run's gates, the tuned runs
    held to the fixed run's device stream and to their knobs' bounds."""
    from repro_torch.core.utilization import available_cpu_count

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cores = available_cpu_count()
    runs, streams = {}, {}
    for label, args in AUTO_RUNS:
        with DeviceDigest() as digest, JudgedWindows() as windows:
            out, report = pipeline_run(torch, ops, args, label, steps=AUTO_STEPS)
        streams[label] = digest.digests(torch)
        auto = report.loader.autotuner
        events = list(auto.events) if auto is not None else []
        bounds = {k.name: (k.lo, k.hi) for k in auto.knobs} if auto is not None else {}
        actions = [e.action for e in events]
        runs[label] = {
            "run": out, "figures": run_figures(out),
            "items_per_s_per_epoch": epoch_rates(report.tracer, AUTO_ITEMS // MAIN_BS),
            "stage_medians_ms": {k: v["median_ms"] for k, v in out["spans"].items()},
            "queues_per_epoch": out["queues_per_epoch"],
            "tuned_per_epoch": report.tuned,
            "knob_bounds": bounds,
            "events_by_action": {a: actions.count(a) for a in sorted(set(actions))},
            "events": [[e.batch, e.action, e.knob, e.value, e.tput] for e in events],
            "judged_windows": windows.rows,
            "probes": windows.probes,
            "batches_digested": len(streams[label]),
        }
        emit({"phase": "main_autotune_run", "label": label,
              **{k: v for k, v in runs[label].items() if k != "run"}})
    want = streams["fixed"]
    differing = {label: sum(a != b for a, b in zip(streams[label], want))
                 + abs(len(streams[label]) - len(want)) for label in ("autotune", "thread_budget")}
    out = {
        "phase": "main_autotune", "nvidia_smi": smi, "available_cpu_count": cores,
        "items": AUTO_ITEMS, "steps": AUTO_STEPS, "thread_budget": AUTO_BUDGET,
        "launches": {label: r["run"]["ingest_norm_launches"] for label, r in runs.items()},
        "batches_transferred": {label: r["run"]["batches_transferred"]
                                for label, r in runs.items()},
        "figures": {**{label: r["figures"] for label, r in runs.items()},
                    "pipeline_48_steps": pipe, "legacy_48_steps": run_figures(legacy)},
        "items_per_s_per_epoch": {label: r["items_per_s_per_epoch"] for label, r in runs.items()},
        "tuned_per_epoch": {label: r["tuned_per_epoch"] for label, r in runs.items()},
        "events_by_action": {label: r["events_by_action"] for label, r in runs.items()},
        "batches_differing_from_fixed": differing,
    }
    emit(out)
    if len(want) < AUTO_STEPS or any(differing.values()):
        fail(f"autotuned runs' device streams differ from the fixed run's ({len(want)} "
             f"batches): {differing}")
    for label in ("autotune", "thread_budget"):
        r = runs[label]
        if not r["events_by_action"].get("probe"):
            fail(f"{label}: the controller never probed: {r['events_by_action']}")
        outside = [e for e in r["events"] if e[2] != "-" and not (
            e[2] in r["knob_bounds"]
            and r["knob_bounds"][e[2]][0] <= e[3] <= r["knob_bounds"][e[2]][1])]
        if outside:
            fail(f"{label}: tuning events outside their knob's bounds: {outside}")
    budget = runs["thread_budget"]
    sums = [q["io_workers"] + q["cpu_workers"] for q in budget["queues_per_epoch"]]
    if sums != [AUTO_BUDGET] * len(sums) or len(sums) < 3:
        fail(f"thread budget {AUTO_BUDGET}: io + cpu workers per epoch {sums}")
    # the budget run's coupled split acted on the card both ways (a down
    # move runs with the util gate closed too; a flip of the executor kind
    # does not, so (e) turns that knob itself)
    split = {"up" if new > old else "down"
             for _, knob, old, new in budget["probes"] if knob == "io_cpu_split"}
    if split != {"up", "down"}:
        fail(f"thread budget: io_cpu_split probed {sorted(split)}, not both ways: "
             f"{budget['probes']}")
    out["swap"] = executor_swap_check(torch)
    return out


def phase_main_lm(torch, flash_ops, ingest_ops) -> dict:
    import dataclasses

    from repro_torch.config import LoaderConfig, register_arch, replace
    from repro_torch.configs import granite_8b
    from repro_torch.core.loader import ConcurrentDataLoader
    from repro_torch.core.prefetch import DevicePrefetchRing
    from repro_torch.core.tracing import Tracer
    from repro_torch.launch import train as launch
    from repro_torch.train.steps import make_eval_step
    from repro_torch.tree import leaves

    register_arch(LM_ARCH, lambda: replace(granite_8b.full(), num_layers=LM_LAYERS),
                  granite_8b.smoke)
    # PyTorch's defaults, stated; the LM computes in bf16
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.flash_attention.launches = 0
    ingest_ops.ingest_norm.launches = 0
    report = launch.run(LM_ARGS)
    train_peak = torch.cuda.max_memory_allocated()
    # the flash forward loss of the trained model on loader batches
    args = launch.parse_args(LM_ARGS)
    loader = ConcurrentDataLoader(
        launch.build_dataset(report.cfg, args, Tracer()),
        LoaderConfig(impl="threaded", batch_size=LM_BS, num_workers=4, num_fetch_workers=16,
                     seed=1))
    ring = DevicePrefetchRing(iter(loader), depth=2, device="cuda")
    try:
        batches = [b for _, b in zip(range(LM_EVAL_BATCHES), ring)]
    finally:
        ring.close()
    params = report.state["params"]
    pallas = dataclasses.replace(report.cfg, attention_impl="pallas")
    eval_flash = make_eval_step(pallas)
    loss_flash = [eval_flash(params, b)["loss"].item() for b in batches]
    flash_launches = flash_ops.flash_attention.launches
    ingest_launches = ingest_ops.ingest_norm.launches
    eval_ref = make_eval_step(report.cfg)
    loss_ref = [eval_ref(params, b)["loss"].item() for b in batches]
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in report.result.history]
    devices = sorted({str(p.device.type) for p in leaves(params)})
    ends = sorted(sp.t1 for sp in report.tracer.spans("run_training_batch"))
    steady = (len(ends) - 1) * LM_BS / (ends[-1] - ends[0]) if len(ends) > 1 else None
    n_params = sum(p.numel() for p in leaves(params))
    diffs = [abs(a - b) for a, b in zip(loss_flash, loss_ref)]
    out = {
        "phase": "main_lm", "arch": report.cfg.name, "args": LM_ARGS, "reduced": LM_REDUCED,
        "num_layers": report.cfg.num_layers, "d_model": report.cfg.d_model,
        "d_ff": report.cfg.d_ff, "vocab_size": report.cfg.vocab_size, "params": n_params,
        "steps": report.result.steps, "epochs": report.result.epochs,
        "wall_s": report.result.wall_s, "items_per_s": report.items_per_s,
        "tokens_per_s": report.items_per_s * LM_SEQ,
        "items_per_s_after_first_step": steady,
        "tokens_per_s_after_first_step": steady * LM_SEQ if steady else None,
        "first_step_ms": 1e3 * report.tracer.spans("run_training_batch")[0].duration,
        "spans": span_stats(report.tracer),
        "util_zero_pct": report.util.util_zero_pct, "util_pos_avg": report.util.util_pos_avg,
        "busy_fraction": report.util.busy_fraction,
        "max_memory_allocated_train_bytes": train_peak, "max_memory_allocated_bytes": peak,
        "first_loss": losses[0] if losses else None, "last_loss": losses[-1] if losses else None,
        "losses": losses, "param_devices": devices,
        "eval_batches": len(batches), "eval_loss_flash": loss_flash, "eval_loss_ref": loss_ref,
        "eval_max_diff": max(diffs) if diffs else None, "eval_limit": 5e-3,
        "flash_attention_launches": flash_launches,
        "flash_attention_launches_expected": report.cfg.num_layers * len(batches),
        "flash_attention_route": flash_ops.route(
            getattr(torch, report.cfg.dtype), report.cfg.attention.head_dim),
        "ingest_norm_launches": ingest_launches,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(out)
    if report.result.steps < LM_STEPS or report.result.epochs < 2:
        fail(f"LM path ran {report.result.steps} steps over {report.result.epochs} epochs")
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss on the LM path: {losses}")
    if devices != ["cuda"]:
        fail(f"LM params live on {devices}, not on cuda")
    if len(batches) != LM_EVAL_BATCHES or not all(d <= 5e-3 for d in diffs):
        fail(f"flash eval loss {loss_flash} vs plain attention {loss_ref}")
    if flash_launches != report.cfg.num_layers * LM_EVAL_BATCHES:
        fail(f"flash_attention launched {flash_launches} times, not "
             f"{report.cfg.num_layers} layers x {LM_EVAL_BATCHES} eval batches")
    return out


def wkv_inputs(torch, B, S, H, D, gen, device):
    """r, k, v, w, u drawn as tests/test_kernels.py::_wkv_inputs draws them:
    decays exp(-exp(N(0, 0.5) - 0.6)), mostly 0.4-0.75."""
    n = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    r, k, v = n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5, n(B, S, H, D)
    w = torch.exp(-torch.exp(n(B, S, H, D) * 0.5 - 0.6))
    return r, k, v, w, n(H, D) * 0.1


def wkv_check(torch, ops, ref, args, tol, label) -> dict:
    """The kernel against its plain version on the same inputs, as
    assert_allclose at rtol = atol = ``tol``, for y and sT."""
    y, sT = ops.wkv(*args)
    want_y, want_s = ref.wkv_plain(*args)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, got, want in (("y", y, want_y), ("sT", sT, want_s)):
        diff = (got - want).abs()
        errs[name] = diff.max().item()
        ok = ok and bool(torch.all(diff <= tol + tol * want.abs()).item())
    case = {"shape": list(args[0].shape), "s0_nonzero": bool(args[5].any().item()),
            "max_abs_err_y": errs["y"], "max_abs_err_sT": errs["sT"], "rtol": tol, "atol": tol,
            "ok": ok}
    if not ok:
        emit({"phase": "kernels/rwkv6_wkv", "failed_case": case})
        fail(f"rwkv6_wkv {label}: max abs err y {errs['y']}, sT {errs['sT']} (tol {tol})")
    return case


def phase_wkv(torch, ops, ref, bw, peak_f32) -> dict:
    """rwkv6_wkv against its plain version at tests/test_kernels.py's cases
    (2e-4, 5e-4 with a nonzero s0), at every head dim with S off the staged
    tile, and at the path's shape; device times of the kernel and of the
    plain version (no single PyTorch call computes the recurrence)."""
    gen = torch.Generator("cuda").manual_seed(0)
    dev = "cuda"
    cases = []
    for B, S, H, D in [(2, 32, 3, 16), (2, 64, 3, 16), (2, 48, 3, 16), (2, 40, 3, 16),
                       (2, 40, 3, 64), (1, 77, 2, 128),
                       (1, 300, 2, 8), (2, 150, 2, 16), (2, 100, 3, 32), (2, 70, 2, 64)]:
        r, k, v, w, u = wkv_inputs(torch, B, S, H, D, gen, dev)
        cases.append(wkv_check(torch, ops, ref, (r, k, v, w, u, torch.zeros(
            (B, H, D, D), device=dev)), 2e-4, f"B={B} S={S} H={H} D={D}"))
    for B, S, H, D in [(1, 16, 2, 8), (2, 40, 3, 64)]:
        r, k, v, w, u = wkv_inputs(torch, B, S, H, D, gen, dev)
        s0 = torch.randn((B, H, D, D), generator=gen, device=dev) * 0.3
        cases.append(wkv_check(torch, ops, ref, (r, k, v, w, u, s0), 5e-4,
                               f"B={B} S={S} H={H} D={D} nonzero s0"))
    B, S, H, D = WKV_SHAPE
    r, k, v, w, u = wkv_inputs(torch, B, S, H, D, gen, dev)
    zeros = torch.zeros((B, H, D, D), device=dev)
    main_case = wkv_check(torch, ops, ref, (r, k, v, w, u, zeros), 2e-4, "path shape")
    cases.append(main_case)
    s0 = torch.randn((B, H, D, D), generator=gen, device=dev) * 0.3
    cases.append(wkv_check(torch, ops, ref, (r, k, v, w, u, s0), 5e-4, "path shape, s0"))
    kernel_ms = device_ms(lambda: ops.wkv(r, k, v, w, u, zeros))
    plain_ms = device_ms(lambda: ref.wkv_plain(r, k, v, w, u, zeros), runs=3,
                         per_run=1, warmup=1)
    # r, k, v, w, y (B,S,H,D), s0 and sT (B,H,D,D) and u (H,D) in fp32, each
    # once; 5 D^2 flops a token and head (D fmas for y, a multiply and an fma
    # for S), at the fp32 CUDA-core peak
    nbytes = 4 * (5 * B * S * H * D + 2 * B * H * D * D + H * D)
    flops = 5.0 * D * D * B * S * H
    bound, bound_by = bound_ms(nbytes, flops, bw, peak_f32)
    out = {"phase": "kernels/rwkv6_wkv", "kernel": "rwkv6_wkv", "shape": list(WKV_SHAPE),
           "dtype": "float32", "max_abs_err": main_case["max_abs_err_y"], "cases": cases,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound, "bound_by": bound_by, "bound_bytes": nbytes, "flops": flops,
           "bytes_bound_ms": nbytes / bw * 1e3 if bw else None,
           "ops_bound_ms": flops / peak_f32 * 1e3 if peak_f32 else None,
           "peak_fp32_flops": peak_f32, "kernel_gb_per_s": nbytes / kernel_ms / 1e6,
           "layout": ops.LAYOUT[D], "ptxas": ptxas_of(ops.build().log, r"wkv_kernel"),
           "occupancy": [ops.occupancy(d) for d in ops.HEAD_DIMS]}
    emit(out)
    return out


def phase_rmsnorm(torch, ops, ref, bw) -> dict:
    """rmsnorm against its plain version at tests/test_kernels.py's shapes
    and dtypes (TOL: 1e-5 f32, 2e-2 bf16), the row-masking case, and the LM
    residual stream's shape; device times of the kernel, the plain version
    and the library yardstick ``F.rms_norm``.  ``launches`` counts this
    phase's checked calls: no model path calls the kernel."""
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(0)
    limits = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    ops.rmsnorm.launches = 0
    cases = []

    def check(x, scale, label):
        got, want = ops.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        tol = limits[x.dtype]
        if got.shape != x.shape or got.dtype != x.dtype:
            fail(f"rmsnorm {label}: got {tuple(got.shape)} {got.dtype}")
        diff = (got.float() - want.float()).abs()
        ok = bool(torch.all(diff <= tol + tol * want.float().abs()).item())
        case = {"shape": list(x.shape), "x_dtype": str(x.dtype), "scale_dtype": str(scale.dtype),
                "max_abs_err": diff.max().item(), "rtol": tol, "atol": tol, "ok": ok}
        if not ok:
            emit({"phase": "kernels/rmsnorm", "failed_case": case})
            fail(f"rmsnorm {label}: max abs err {case['max_abs_err']} (tol {tol})")
        cases.append(case)
        return case

    for shape in [(8, 128), (4, 16, 256), (1, 384), (130, 128), (7, 128), (9, 100)]:
        x = torch.randn(shape, generator=gen, device="cuda")
        scale = torch.randn(shape[-1:], generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            check(x.to(dt), scale.to(dt), f"{shape} {dt}")
    x32 = torch.randn(RMS_SHAPE, generator=gen, device="cuda")
    scale = torch.randn(RMS_SHAPE[-1:], generator=gen, device="cuda")
    x = x32.bfloat16()
    main_case = check(x, scale, "path shape, bf16 x, fp32 scale")
    main32 = check(x32, scale, "path shape, fp32")
    launches = ops.rmsnorm.launches
    d = RMS_SHAPE[-1]
    kernel_ms = device_ms(lambda: ops.rmsnorm(x, scale))
    plain_ms = device_ms(lambda: ref.rmsnorm_ref(x, scale))
    library_ms = device_ms(lambda: F.rms_norm(x, (d,), weight=scale, eps=1e-6))
    scale_bf16 = scale.bfloat16()
    library_bf16_scale_ms = device_ms(lambda: F.rms_norm(x, (d,), weight=scale_bf16, eps=1e-6))
    kernel32_ms = device_ms(lambda: ops.rmsnorm(x32, scale))
    n = RMS_SHAPE[0]
    nbytes = n * d * 2 * 2 + d * 4  # bf16 x read and y written once, fp32 scale
    nbytes32 = n * d * 4 * 2 + d * 4
    out = {"phase": "kernels/rmsnorm", "kernel": "rmsnorm", "shape": list(RMS_SHAPE),
           "x_dtype": "bfloat16", "scale_dtype": "float32",
           "max_abs_err": main_case["max_abs_err"], "max_abs_err_fp32": main32["max_abs_err"],
           "cases": cases, "launches": launches,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "F.rms_norm(x, (d,), weight=scale, eps=1e-6)",
           "library_bf16_scale_ms": library_bf16_scale_ms, "kernel_fp32_ms": kernel32_ms,
           "bound_ms": bound_ms(nbytes, 0, bw, None)[0], "bound_by": "bytes",
           "bound_bytes": nbytes, "bound_fp32_ms": bound_ms(nbytes32, 0, bw, None)[0],
           "kernel_gb_per_s": nbytes / kernel_ms / 1e6,
           "note": "no model path calls rmsnorm (apply_norm is plain, as in the reference); "
                   "launches counts this phase's checked calls"}
    emit(out)
    return out


def phase_model_rwkv(torch) -> dict:
    """The rwkv6-7b smoke model: two AdamW steps on the card against the CPU
    from the same weights, in fp32 with TF32 off (the devices differ only in
    summation order)."""
    import dataclasses

    import numpy as np

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.convert import lm_params_from_jax, to_jax
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.steps import lm_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("rwkv6-7b", smoke=True), dtype="float32")
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=1)
    np_params = to_jax(init_lm(cfg, torch.Generator().manual_seed(1), "cpu"))
    rng = np.random.default_rng(2)
    batches = [{k: rng.integers(0, cfg.vocab_size, (4, 72)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    losses = {}
    for dev in ("cpu", "cuda"):
        state = lm_train_state(lm_params_from_jax(np_params, dev), tcfg)
        step = make_train_step(cfg, tcfg)
        losses[dev] = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses[dev].append(m["loss"].item())
    diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    out = {"phase": "model_rwkv", "arch": cfg.name, "steps": 2, "dtype": "float32",
           "seq_len": 72, "loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"],
           "max_loss_diff": diff, "limit": 1e-4, "cudnn_allow_tf32": False,
           "matmul_allow_tf32": False}
    emit(out)
    if not all(math.isfinite(x) for x in losses["cuda"]) or not diff <= 1e-4:
        fail(f"RWKV train steps on the card differ from the CPU: {losses}")
    return out


def decay_readings(torch, w) -> dict:
    """The smallest decay, and the largest 1/P_incl over a WKV_CHUNK-token
    chunk (the division the chunked form makes; fp32 underflows past about
    1e38), of w (B, S, H, D)."""
    B, S, H, D = w.shape
    n = S // WKV_CHUNK * WKV_CHUNK
    logw = torch.log(w[:, :n].clamp_min(1e-12)).reshape(B, n // WKV_CHUNK, WKV_CHUNK, H, D)
    neg_log_p = -torch.cumsum(logw, dim=2)  # -log P_incl
    return {"min_w": w.min().item(), "max_log10_inv_p_incl": neg_log_p.max().item() / math.log(10),
            "min_chunk_mean_w": torch.exp(-neg_log_p[:, :, -1] / WKV_CHUNK).min().item()}


def phase_main_rwkv(torch, wkv_ops, wkv_ref, rms_ops, ingest_ops, flash_ops) -> dict:
    """The RWKV path: rwkv6-7b-4l trained through the launcher, then the
    trained model's blocks walked over 4 loader batches with each layer's
    time-mix run through the WKV kernel beside the plain chunked scan."""
    from repro_torch.config import LoaderConfig, register_arch, replace
    from repro_torch.configs import rwkv6_7b
    from repro_torch.core.loader import ConcurrentDataLoader
    from repro_torch.core.prefetch import DevicePrefetchRing
    from repro_torch.core.tracing import Tracer
    from repro_torch.launch import train as launch
    from repro_torch.models.layers import apply_embedding, apply_norm
    from repro_torch.models.rwkv6 import apply_rwkv_timemix
    from repro_torch.models.transformer import _apply_sublayer, layer_kinds
    from repro_torch.tree import leaves, unbind

    register_arch(RWKV_ARCH, lambda: replace(rwkv6_7b.full(), num_layers=RWKV_LAYERS),
                  rwkv6_7b.smoke)
    # PyTorch's defaults, stated; the model computes in bf16
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counted in (wkv_ops.wkv, ingest_ops.ingest_norm, flash_ops.flash_attention):
        counted.launches = 0
    report = launch.run(RWKV_ARGS)
    train_launches = wkv_ops.wkv.launches  # the training path runs the plain scan
    train_peak = torch.cuda.max_memory_allocated()
    cfg, params = report.cfg, report.state["params"]
    args = launch.parse_args(RWKV_ARGS)
    loader = ConcurrentDataLoader(
        launch.build_dataset(cfg, args, Tracer()),
        LoaderConfig(impl="threaded", batch_size=LM_BS, num_workers=4, num_fetch_workers=16,
                     seed=1))
    ring = DevicePrefetchRing(iter(loader), depth=2, device="cuda")
    try:
        batches = [b for _, b in zip(range(LM_EVAL_BATCHES), ring)]
    finally:
        ring.close()

    # The eval walk: per batch and layer, the time-mix on the layer's normed
    # input through the kernel and through the plain scan, then the layer.
    captured, readings, row_errs = {}, [], []

    def wkv_recorded(r, k, v, w, u, s0):
        readings.append(decay_readings(torch, w))
        if not captured:
            captured.update(r=r, k=k, v=v, w=w, u=u, s0=s0)
        return wkv_ops.wkv(r, k, v, w, u, s0)

    kinds = layer_kinds(cfg)
    blocks = unbind(params["blocks"])
    residual = None
    with torch.no_grad():
        for b in batches:
            x = apply_embedding(params["embed"], b["tokens"], cfg)
            positions = torch.arange(x.shape[1], device=x.device)
            for li, bp in enumerate(blocks):
                p = bp["sub0"]
                if residual is None and li == len(blocks) - 1:
                    residual = (x, p["ln1"])
                h = apply_norm(p["ln1"], x, cfg)
                plain, _ = apply_rwkv_timemix(p["tm"], h, cfg, scan_mode="chunk")
                kern, _ = apply_rwkv_timemix(p["tm"], h, cfg, wkv_impl=wkv_recorded)
                diff = (kern.float() - plain.float()).norm(dim=-1)
                row_errs.append((diff / plain.float().norm(dim=-1).clamp_min(1e-30)).max().item())
                x, _, _ = _apply_sublayer(p, x, cfg, kinds[li], positions=positions)
    walk_launches = wkv_ops.wkv.launches
    ingest_launches, flash_launches = ingest_ops.ingest_norm.launches, \
        flash_ops.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()

    with torch.no_grad():  # u and the norm scales are trained parameters
        # the kernel against its plain version on the trained model's real inputs
        real_case = wkv_check(torch, wkv_ops, wkv_ref,
                              tuple(captured[k] for k in ("r", "k", "v", "w", "u", "s0")),
                              2e-4, "real r, k, v, w")
        # RMSNorm on a real residual (bf16 x, fp32 scale) against apply_norm
        x, ln = residual
        got, want = rms_ops.rmsnorm(x, ln["scale"]), apply_norm(ln, x, cfg)
        torch.cuda.synchronize()
    rms_err = (got.float() - want.float()).abs()
    rms_ok = bool(torch.all(rms_err <= 2e-2 + 2e-2 * want.float().abs()).item())

    losses = [h["loss"] for h in report.result.history]
    devices = sorted({str(t.device.type) for t in leaves(params)})
    ends = sorted(sp.t1 for sp in report.tracer.spans("run_training_batch"))
    steady = (len(ends) - 1) * LM_BS / (ends[-1] - ends[0]) if len(ends) > 1 else None
    expected = cfg.num_layers * len(batches)
    out = {
        "phase": "main_rwkv", "arch": cfg.name, "args": RWKV_ARGS, "reduced": RWKV_REDUCED,
        "num_layers": cfg.num_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "vocab_size": cfg.vocab_size, "heads": cfg.d_model // cfg.rwkv.head_dim,
        "head_dim": cfg.rwkv.head_dim, "params": sum(t.numel() for t in leaves(params)),
        "steps": report.result.steps, "epochs": report.result.epochs,
        "wall_s": report.result.wall_s, "items_per_s": report.items_per_s,
        "tokens_per_s": report.items_per_s * LM_SEQ,
        "items_per_s_after_first_step": steady,
        "tokens_per_s_after_first_step": steady * LM_SEQ if steady else None,
        "first_step_ms": 1e3 * report.tracer.spans("run_training_batch")[0].duration,
        "spans": span_stats(report.tracer),
        "util_zero_pct": report.util.util_zero_pct, "util_pos_avg": report.util.util_pos_avg,
        "busy_fraction": report.util.busy_fraction,
        "max_memory_allocated_train_bytes": train_peak, "max_memory_allocated_bytes": peak,
        "first_loss": losses[0] if losses else None, "last_loss": losses[-1] if losses else None,
        "losses": losses, "param_devices": devices,
        "wkv_launches_in_training": train_launches,
        "eval_batches": len(batches), "wkv_launches": walk_launches,
        "wkv_launches_expected": expected,
        "timemix_max_row_rel_err": max(row_errs) if row_errs else None,
        "timemix_row_rel_limit": ROW_REL_BF16,
        "real_inputs_case": real_case,
        "decays": {"min_w": min(d["min_w"] for d in readings),
                   "max_log10_inv_p_incl": max(d["max_log10_inv_p_incl"] for d in readings),
                   "min_chunk_mean_w": min(d["min_chunk_mean_w"] for d in readings),
                   "chunk": WKV_CHUNK} if readings else None,
        "rmsnorm_real_residual": {"shape": list(x.shape), "x_dtype": str(x.dtype),
                                  "scale_dtype": str(ln["scale"].dtype),
                                  "max_abs_err": rms_err.max().item(), "rtol": 2e-2,
                                  "atol": 2e-2, "ok": rms_ok},
        "ingest_norm_launches": ingest_launches, "flash_attention_launches": flash_launches,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(out)
    if report.result.steps < LM_STEPS or report.result.epochs < 2:
        fail(f"RWKV path ran {report.result.steps} steps over {report.result.epochs} epochs")
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss on the RWKV path: {losses}")
    if devices != ["cuda"]:
        fail(f"RWKV params live on {devices}, not on cuda")
    if len(batches) != LM_EVAL_BATCHES or not row_errs or not max(row_errs) <= ROW_REL_BF16:
        fail(f"time-mix through the WKV kernel vs the plain scan: row-relative errors {row_errs}")
    if walk_launches != expected:
        fail(f"rwkv6_wkv launched {walk_launches} times, not {cfg.num_layers} layers x "
             f"{LM_EVAL_BATCHES} eval batches")
    if not rms_ok:
        fail(f"rmsnorm on a real residual: max abs err {rms_err.max().item()}")
    return out


class SyncTimer:
    """Wraps functions of ``module`` with host timers behind
    ``torch.cuda.synchronize()`` on both sides, so a call's time is the
    device finishing its work; ``restore`` puts them back."""

    def __init__(self, torch, module, names) -> None:
        self.torch, self.module = torch, module
        self.real = {name: getattr(module, name) for name in names}
        self.times = {name: [] for name in names}
        for name, fn in self.real.items():
            setattr(module, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.times[name].append(time.perf_counter() - t0)
            return out
        return run

    def restore(self) -> None:
        for name, fn in self.real.items():
            setattr(self.module, name, fn)


def order_stat(xs, q: float) -> float:
    """The reference launcher's percentile: sorted(xs)[int(q * n)]."""
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


def serve_batch(torch, cfg, tokens):
    """A prompt batch as the engine builds one: the tokens and, for the
    encoder-decoder, zero frames (the frontend stub)."""
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(
            (tokens.shape[0], cfg.encoder_seq_len or 1500, cfg.frontend_dim or cfg.d_model),
            dtype=torch.float32, device=tokens.device)
    return batch


def forced_logits(torch, cfg, params, prompt, tokens, max_len, device="cuda"):
    """Sequential batch-1 decode fed ``tokens`` (teacher forcing; the twin
    of ``tests/test_serve.py``'s reference_greedy) through the family's
    serving programs: each step's logits in fp32, (len(tokens), V)."""
    from repro_torch.serve.steps import make_serve_fns

    fns = make_serve_fns(cfg, device)
    logits, cache = fns["prefill"](
        params, serve_batch(torch, cfg, torch.tensor([list(prompt)], device=device)),
        fns["init_cache"](1, max_len))
    steps = [logits[0].float()]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = fns["decode"](params, cache, torch.tensor([[tok]], device=device),
                                      len(prompt) + i)
        steps.append(logits[0].float())
    return torch.stack(steps)


def held_to_batch1(torch, cfg, params, requests, max_len, tol) -> dict:
    """Pooled against sequential: each request's engine tokens fed to the
    batch-1 decode; at every step the engine's token must have a logit
    within ``tol`` of the batch-1 maximum.  Counts exact matches and ties
    (within ``tol``, not the argmax); keeps each request's last step."""
    out = {"requests": len(requests), "steps": 0, "exact": 0, "ties": 0, "max_gap": 0.0,
           "tolerance": tol, "last_steps": []}
    for req in requests:
        steps = forced_logits(torch, cfg, params, req.prompt.tolist(), req.output, max_len)
        toks = torch.tensor(req.output, device=steps.device)
        gaps = steps.max(-1).values - steps.gather(1, toks[:, None])[:, 0]
        exact = int((steps.argmax(-1) == toks).sum().item())
        out["steps"] += len(req.output)
        out["exact"] += exact
        out["ties"] += len(req.output) - exact
        out["max_gap"] = max(out["max_gap"], gaps.max().item())
        out["last_steps"].append(steps[-1])
    out["ok"] = out["max_gap"] <= tol
    return out


def pooled_and_cacheless(torch, cfg, params, done, max_len: int, phase: str,
                         gate: bool = True, cacheless: bool = True):
    """(b) SERVE_CHECKED requests' pooled tokens held to the batch-1 decode
    (``held_to_batch1``) and (c) SERVE_CACHELESS of them: the last decode
    step's logits against a cacheless forward (a prefill of the whole
    sequence), each emitted and, with ``gate``, gated."""
    from repro_torch.models import transformer

    checked = done[:: len(done) // SERVE_CHECKED][:SERVE_CHECKED]
    pooled = held_to_batch1(torch, cfg, params, checked, max_len, SERVE_TIE_TOL)
    lasts, diffs = pooled.pop("last_steps"), []
    for req, last in zip(checked[:SERVE_CACHELESS] if cacheless else [], lasts):
        seq = req.prompt.tolist() + req.output[:-1]
        logits, _ = transformer.prefill(
            params, {"tokens": torch.tensor([seq], device="cuda")}, cfg,
            transformer.init_cache(cfg, 1, len(seq), "cuda"))
        diffs.append((logits[0].float() - last).abs().max().item())
    emit({"phase": phase, "check": "b_pooled_vs_sequential", "arch": cfg.name,
          "uids": [r.uid for r in checked], "gated": gate, **pooled})
    if cacheless:
        emit({"phase": phase, "check": "c_cache_vs_cacheless", "arch": cfg.name,
              "max_abs_diff": diffs, "tolerance": SERVE_LOGIT_TOL})
    if gate and not pooled["ok"]:
        fail(f"{cfg.name}: pooled decode left the batch-1 maximum by {pooled['max_gap']}")
    if cacheless and not max(diffs) <= SERVE_LOGIT_TOL:
        fail(f"{cfg.name}: last decode step against a cacheless forward: {diffs}")
    return pooled, diffs


def serve_path(torch, counted, serve_args: list, smi: str, phase: str, reduced=None):
    """A serving phase's (a): ``launch/serve.py`` with ``serve_args``, the
    init's peak read apart from serving's, prefill and decode behind
    synchronizes, every counted kernel's launches set to 0 just before the
    run and read just after; gated on the reference's token accounting and
    tick bound and on no kernel launch.  ``reduced`` names the cuts of a
    registered arch.  The family's module (``models.encdec`` for the
    encoder-decoder, else ``models.transformer``) has its init, prefill
    and decode wrapped.  Returns (report, args, figures)."""
    from repro_torch.config import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import encdec, transformer
    from repro_torch.tree import leaves

    args = serve.parse_args(serve_args)
    model, init_name = (encdec, "init_encdec") \
        if get_arch(args.arch, smoke=args.smoke).family == "encdec" else (transformer, "init_lm")
    init = {}
    real_init = getattr(model, init_name)

    def timed_init(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = real_init(*a, **kw)
        torch.cuda.synchronize()
        init.update(s=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated(),
                    param_bytes=sum(t.numel() * t.element_size() for t in leaves(params)))
        torch.cuda.reset_peak_memory_stats()
        return params

    setattr(model, init_name, timed_init)
    timer = SyncTimer(torch, model, ("prefill", "decode_step"))
    allocated_before = torch.cuda.memory_allocated()  # what earlier phases left
    for fn in counted.values():
        fn.launches = 0
    try:
        report = serve.run(serve_args)
    finally:
        timer.restore()
        setattr(model, init_name, real_init)
    launches = {name: fn.launches for name, fn in counted.items()}
    serve_peak = torch.cuda.max_memory_allocated()
    cfg, eng, done = report.cfg, report.engine, report.done
    ttfts = [r.t_first_token - r.t_submit for r in done]
    totals = [r.t_done - r.t_submit for r in done]
    tick_bound = args.requests * (args.max_new - 1) / args.slots + args.max_new
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(eng.cache))
    path = {
        "arch": cfg.name, "args": serve_args, **({"reduced": reduced} if reduced else {}),
        "num_layers": cfg.num_layers,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "params": sum(t.numel() for t in leaves(eng.params)), "requests": len(done),
        "slots": args.slots, "max_len": args.max_len, "max_new": args.max_new,
        "prompt_lens": [len(r.prompt) for r in sorted(done, key=lambda r: r.uid)],
        "wall_s": report.wall_s,
        "tokens_generated": eng.tokens_generated, "tokens_per_s": report.tokens_per_s,
        "ttft_p50_s": order_stat(ttfts, 0.5), "ttft_p95_s": order_stat(ttfts, 0.95),
        "total_p50_s": order_stat(totals, 0.5), "total_p95_s": order_stat(totals, 0.95),
        "ticks": eng.ticks, "ticks_bound": tick_bound,
        "decode_calls": len(timer.times["decode_step"]),
        "decode_ms_median": 1e3 * statistics.median(timer.times["decode_step"]),
        "decode_ms_min": 1e3 * min(timer.times["decode_step"]),
        "prefill_calls": len(timer.times["prefill"]),
        "prefill_ms_median": 1e3 * statistics.median(timer.times["prefill"]),
        "init_s": init["s"], "init_peak_bytes": init["peak"],
        "param_bytes": init["param_bytes"], "cache_bytes": cache_bytes,
        "max_memory_allocated_bytes": serve_peak, "allocated_before_bytes": allocated_before,
        "device_total_bytes": torch.cuda.get_device_properties(0).total_memory,
        "launches": launches, "nvidia_smi": smi,
    }
    emit({"phase": phase, "check": "a_path", **path})
    want = args.requests * (args.max_new - 1)
    if len(done) != args.requests or any(len(r.output) != args.max_new for r in done):
        fail(f"{cfg.name} serving returned {[len(r.output) for r in done]} tokens for "
             f"{args.requests} requests of {args.max_new}")
    if eng.tokens_generated != want or eng.ticks > tick_bound:
        fail(f"{cfg.name} serving accounted {eng.tokens_generated} tokens (want {want}) in "
             f"{eng.ticks} ticks (at most {tick_bound})")
    if any(launches.values()):
        fail(f"a kernel launched on the {cfg.name} serving path: {launches}")
    return report, args, path


def serve_profile(torch, report, max_len: int, phase: str) -> dict:
    """Where a tick's time goes: torch.profiler over pooled decode ticks and
    batch-1 prefills after the run, each call's device busy time (the
    union of its kernels) against its wall time."""
    from repro_torch.serve.steps import make_serve_fns
    from repro_torch.tools.profile_lm_step import busy_ms, profiled

    cfg, eng = report.cfg, report.engine
    fns = make_serve_fns(cfg, "cuda")
    first = min(report.done, key=lambda r: r.uid)
    toks = torch.tensor(eng.last_token[:, None], device="cuda")
    one = serve_batch(torch, cfg, torch.tensor(first.prompt[None], device="cuda"))
    where = {}
    for name, fn in (
            ("decode", lambda: fns["decode"](eng.params, eng.cache, toks, eng.positions)),
            ("prefill", lambda: fns["prefill"](eng.params, one, fns["init_cache"](1, max_len)))):
        prof = profiled(torch, fn, SERVE_PROFILED)
        busy = busy_ms(prof["intervals"]) / SERVE_PROFILED
        where[name] = {"calls": SERVE_PROFILED, "wall_ms": prof["wall_ms"],
                       "device_busy_ms": busy, "idle_share": 1 - busy / prof["wall_ms"],
                       "kernels_per_call": len(prof["intervals"]) / SERVE_PROFILED,
                       "device_ms_by_category": dict(sorted(
                           prof["by_cat"].items(), key=lambda kv: -kv[1]))}
    emit({"phase": phase, "check": "a_profile", "arch": cfg.name,
          "prompt_len": len(first.prompt), **where})
    return where


def long_prefill(torch, cfg, params, phase: str) -> dict:
    """One SERVE_LONG-token prompt prefilled in 2 chunks of PREFILL_CHUNK
    and in one pass, then SERVE_LONG_NEW - 1 decode steps after each: time,
    peak, last logits within SERVE_LOGIT_TOL and the same tokens (gated)."""
    import numpy as np

    from repro_torch.models import transformer

    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (1, SERVE_LONG)).astype(np.int32)).to("cuda")
    chunk = transformer.PREFILL_CHUNK
    long_runs = {}
    for label, value in (("chunked", chunk), ("single_pass", 2 * SERVE_LONG)):
        transformer.PREFILL_CHUNK = value
        try:
            cache = transformer.init_cache(cfg, 1, SERVE_LONG + SERVE_LONG_NEW, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, cache = transformer.prefill(params, {"tokens": prompt}, cfg, cache)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            last, toks = logits[0].float(), [int(logits[0].argmax())]
            for i in range(SERVE_LONG_NEW - 1):
                logits, cache = transformer.decode_step(
                    params, cache, torch.tensor([[toks[-1]]], device="cuda"), SERVE_LONG + i,
                    cfg)
                toks.append(int(logits[0].argmax()))
        finally:
            transformer.PREFILL_CHUNK = chunk
        long_runs[label] = {"prefill_ms": ms, "max_memory_allocated_bytes": peak,
                            "tokens": toks, "last": last}
        del cache, logits
        torch.cuda.empty_cache()
    diff = (long_runs["chunked"].pop("last") - long_runs["single_pass"].pop("last")).abs().max()
    out = {"phase": phase, "check": "e_chunked_prefill", "arch": cfg.name,
           "prompt_len": SERVE_LONG, "prefill_chunk": chunk, **long_runs,
           "max_abs_diff": diff.item(), "tolerance": SERVE_LOGIT_TOL}
    emit(out)
    if not diff.item() <= SERVE_LOGIT_TOL or \
            long_runs["chunked"]["tokens"] != long_runs["single_pass"]["tokens"]:
        fail(f"{cfg.name}: chunked prefill against a single pass: {diff.item()}, {long_runs}")
    return out


def card_vs_cpu(torch, cfgs, phase: str) -> list:
    """(f) Smoke models served on the card against the CPU from the same
    weights, fp32 with TF32 off: a prefill and 4 decode steps' logits
    within SERVE_DEVICE_TOL (the card fed the CPU's greedy tokens), and the
    engine's tokens equal (gated)."""
    import numpy as np

    from repro_torch.config import ServeSpec
    from repro_torch.convert import lm_params_from_jax, to_jax
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.steps import make_serve_fns
    from repro_torch.train.steps import init_params_for

    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = []
    for scfg in cfgs:
        np_params = to_jax(init_params_for(scfg, torch.Generator().manual_seed(2), "cpu"))
        prompts = np.random.default_rng(3).integers(1, scfg.vocab_size, (2, 12)).astype(np.int32)
        logits, tokens, fed = {}, {}, []
        for dev in ("cpu", "cuda"):  # the card is fed the CPU's greedy tokens
            sp = lm_params_from_jax(np_params, dev, requires_grad=False)
            fns = make_serve_fns(scfg, dev)
            out, cache = fns["prefill"](sp, serve_batch(torch, scfg,
                                                        torch.from_numpy(prompts).to(dev)),
                                        fns["init_cache"](2, 20))
            steps = [out.cpu()]
            for i in range(4):
                if dev == "cpu":
                    fed.append(steps[-1].argmax(-1))
                out, cache = fns["decode"](sp, cache, fed[i][:, None].to(dev),
                                           np.array([12 + i, 12 + i]))
                steps.append(out.cpu())
            logits[dev] = torch.stack(steps)
            eng_d = ServeEngine(scfg, sp, spec=ServeSpec(num_slots=2, max_len=32), device=dev)
            for p in prompts.tolist() + [[5, 7], [9, 9, 9]]:
                eng_d.submit(p, max_new_tokens=6)
            tokens[dev] = [r.output for r in sorted(eng_d.run_until_drained(),
                                                    key=lambda r: r.uid)]
        smoke.append({"arch": scfg.name, "num_layers": scfg.num_layers,
                      "max_abs_diff": (logits["cpu"] - logits["cuda"]).abs().max().item(),
                      "tokens_equal": tokens["cpu"] == tokens["cuda"]})
    emit({"phase": phase, "check": "f_card_vs_cpu", "dtype": "float32",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "tolerance":
          SERVE_DEVICE_TOL, "prefill_then_decode_steps": 4, "cases": smoke})
    if not all(c["max_abs_diff"] <= SERVE_DEVICE_TOL and c["tokens_equal"] for c in smoke):
        fail(f"serving on the card against the CPU: {smoke}")
    return smoke


def phase_main_serve(torch, counted, smi: str) -> dict:
    """The serving path, granite-8b whole on the card: (a) the launcher at
    the reference's defaults; (b) pooled against sequential decode; (c) a
    decode step against a cacheless forward; (d) no flash launch with a
    cache; (e) chunked prefill of 16384 tokens against a single pass; (f)
    card against CPU at smoke size; (g) RWKV served at full width."""
    import dataclasses

    import numpy as np

    from repro_torch.config import ServeSpec, get_arch, register_arch, replace
    from repro_torch.configs import rwkv6_7b
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    flash = counted["flash_attention"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    # (a) the path
    report, args, path = serve_path(torch, counted, SERVE_ARGS, smi, "main_serve")
    cfg, eng, done = report.cfg, report.engine, sorted(report.done, key=lambda r: r.uid)
    params = eng.params
    serve_profile(torch, report, args.max_len, "main_serve")

    # (b) pooled equals sequential, and (c) cache equals no cache
    pooled, cacheless = pooled_and_cacheless(torch, cfg, params, done, args.max_len,
                                             "main_serve")

    # (d) no kernel with a cache, attention_impl="pallas"
    flash.launches = 0
    pallas = ServeEngine(dataclasses.replace(cfg, attention_impl="pallas"), params,
                         spec=ServeSpec(num_slots=args.slots, max_len=args.max_len),
                         device="cuda")
    for req in done[:SERVE_PALLAS_REQUESTS]:
        pallas.submit(req.prompt, max_new_tokens=args.max_new)
    pdone = sorted(pallas.run_until_drained(), key=lambda r: r.uid)
    same = sum(a.output == b.output for a, b in zip(pdone, done))
    emit({"phase": "main_serve", "check": "d_pallas_with_cache", "requests": len(pdone),
          "flash_attention_launches": flash.launches, "outputs_equal_to_a": same})
    if flash.launches or any(len(r.output) != args.max_new for r in pdone):
        fail(f"attention_impl='pallas' with a cache: {flash.launches} flash launches")
    del pallas

    # (e) chunked prefill at full width: 2 chunks of PREFILL_CHUNK against one pass
    long_prefill(torch, cfg, params, "main_serve")
    del params, report, eng, done
    torch.cuda.empty_cache()

    # (f) card against CPU at smoke size, fp32, TF32 off
    card_vs_cpu(torch, [dataclasses.replace(get_arch(arch, smoke=True), dtype="float32")
                        for arch in ("granite-8b", "rwkv6-7b")], "main_serve")

    # (g) RWKV: rwkv6-7b at full width, depth 4, 8 requests over 4 slots
    register_arch(RWKV_ARCH, lambda: replace(rwkv6_7b.full(), num_layers=RWKV_LAYERS),
                  rwkv6_7b.smoke)
    rcfg = get_arch(RWKV_ARCH)
    rparams = transformer.init_lm(rcfg, torch.Generator("cuda").manual_seed(0), "cuda")
    reng = ServeEngine(rcfg, rparams, spec=ServeSpec(num_slots=RWKV_SERVE_SLOTS,
                                                     max_len=args.max_len), device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(RWKV_SERVE_REQUESTS):
        reng.submit(rng.integers(1, rcfg.vocab_size, size=int(rng.integers(2, 17))),
                    max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    rdone = sorted(reng.run_until_drained(), key=lambda r: r.uid)
    rwall = time.perf_counter() - t0
    rpooled = held_to_batch1(torch, rcfg, rparams, rdone, args.max_len, SERVE_TIE_TOL)
    rpooled.pop("last_steps")
    rwant = RWKV_SERVE_REQUESTS * (args.max_new - 1)
    emit({"phase": "main_serve", "check": "g_rwkv", "arch": rcfg.name,
          "num_layers": rcfg.num_layers, "reduced": {"num_layers": "32 -> 4, as main_rwkv"},
          "requests": len(rdone), "slots": RWKV_SERVE_SLOTS, "ticks": reng.ticks,
          "tokens_generated": reng.tokens_generated, "wall_s": rwall,
          "tokens_per_s": reng.tokens_generated / rwall, **rpooled})
    if len(rdone) != RWKV_SERVE_REQUESTS or any(len(r.output) != args.max_new for r in rdone) \
            or reng.tokens_generated != rwant or not rpooled["ok"]:
        fail(f"RWKV serving: {len(rdone)} requests, {reng.tokens_generated} tokens "
             f"(want {rwant}), max gap {rpooled['max_gap']}")
    del rparams, reng
    torch.cuda.empty_cache()
    return {**path, "pooled": pooled, "cacheless": cacheless, "rwkv": rpooled}


def phase_model_families(torch) -> dict:
    """The minicpm3-4b (MLA), granite-moe-3b-a800m (MoE), jamba-v0.1-52b
    (hybrid: one block of 8 layers, and HYBRID_STACKED_LAYERS in stacked
    blocks), whisper-large-v3 (encoder-decoder, its batches with frames)
    and internvl2-26b (VLM, with patch embeddings) smoke models: two AdamW
    steps on the card against the CPU from the same weights, in fp32 with
    TF32 off (the devices differ only in summation order): loss and aux
    loss within 1e-4."""
    import dataclasses

    import numpy as np

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.convert import lm_params_from_jax, to_jax
    from repro_torch.train.steps import init_params_for, lm_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=1)
    cases = []
    f32 = [dataclasses.replace(get_arch(arch, smoke=True), dtype="float32")
           for arch in (MLA_ARCH, MOE_ARCH, HYBRID_ARCH, ENCDEC_ARCH, VLM_ARCH)]
    for cfg in f32 + [dataclasses.replace(f32[2], num_layers=HYBRID_STACKED_LAYERS)]:
        np_params = to_jax(init_params_for(cfg, torch.Generator().manual_seed(1), "cpu"))
        rng = np.random.default_rng(2)
        batches = [{k: rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
                    for k in ("tokens", "targets")} for _ in range(2)]
        for b in batches:
            if cfg.family == "encdec":
                b["frames"] = rng.standard_normal(
                    (4, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
            if cfg.num_patch_tokens:
                b["patch_embeds"] = rng.standard_normal(
                    (4, cfg.num_patch_tokens, cfg.frontend_dim)).astype(np.float32)
        got = {}
        for dev in ("cpu", "cuda"):
            state = lm_train_state(lm_params_from_jax(np_params, dev), tcfg)
            step = make_train_step(cfg, tcfg)
            got[dev] = []
            for b in batches:
                state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
                got[dev] += [m["loss"].item(), m["aux_loss"].item()]
        cases.append({"arch": cfg.name, "num_layers": cfg.num_layers,
                      "loss_aux_cpu": got["cpu"], "loss_aux_cuda": got["cuda"],
                      "max_diff": max(abs(a - b) for a, b in zip(got["cpu"], got["cuda"])),
                      "finite": all(math.isfinite(x) for x in got["cuda"])})
    out = {"phase": "model_families", "steps": 2, "dtype": "float32", "seq_len": 64,
           "cases": cases, "limit": 1e-4, "cudnn_allow_tf32": False, "matmul_allow_tf32": False}
    emit(out)
    if not all(c["finite"] and c["max_diff"] <= 1e-4 for c in cases):
        fail(f"MLA / MoE / hybrid / encdec / VLM train steps on the card differ from the CPU: "
             f"{cases}")
    return out


def train_family(torch, counted, base, train_arch: str, train_args: list, reduced: dict,
                 phase: str):
    """A family's LM path: ``base`` at full width, depth cut to
    FAMILY_LAYERS and registered as ``train_arch`` (or, with ``base``
    None, ``train_arch`` as registered), trained from simulated S3
    through the launcher with ``train_args``; every counted kernel's
    launches set to 0 just before the run and read just after.  Gated on
    the steps and epochs, finite losses, parameters on the card and no
    kernel launch.  Returns (report, figures)."""
    import dataclasses

    from repro_torch.config import register_arch, replace
    from repro_torch.launch import train as launch
    from repro_torch.tree import leaves

    if base is not None:
        register_arch(train_arch, lambda: replace(base.full(), num_layers=FAMILY_LAYERS),
                      base.smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    report = launch.run(train_args)
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg, params = report.cfg, report.state["params"]
    losses = [h["loss"] for h in report.result.history]
    aux = [h["aux_loss"] for h in report.result.history]
    devices = sorted({str(p.device.type) for p in leaves(params)})
    ends = sorted(sp.t1 for sp in report.tracer.spans("run_training_batch"))
    steady = (len(ends) - 1) * LM_BS / (ends[-1] - ends[0]) if len(ends) > 1 else None
    out = {
        "phase": phase, "check": "train", "arch": cfg.name, "args": train_args,
        "reduced": reduced, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "attention": dataclasses.asdict(cfg.attention),
        "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
        "ssm": dataclasses.asdict(cfg.ssm) if cfg.ssm else None,
        "params": sum(p.numel() for p in leaves(params)),
        "steps": report.result.steps, "epochs": report.result.epochs,
        "wall_s": report.result.wall_s, "tokens_per_s": report.items_per_s * LM_SEQ,
        "tokens_per_s_after_first_step": steady * LM_SEQ if steady else None,
        "first_step_ms": 1e3 * report.tracer.spans("run_training_batch")[0].duration,
        "spans": span_stats(report.tracer),
        "busy_fraction": report.util.busy_fraction, "util_zero_pct": report.util.util_zero_pct,
        "max_memory_allocated_bytes": peak, "losses": losses, "aux_losses": aux,
        "param_devices": devices, "launches": launches,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(out)
    if report.result.steps < LM_STEPS or report.result.epochs < 2:
        fail(f"{cfg.name} ran {report.result.steps} steps over {report.result.epochs} epochs")
    if not losses or not all(math.isfinite(x) for x in losses + aux):
        fail(f"non-finite loss on the {cfg.name} path: {losses}, aux {aux}")
    if devices != ["cuda"]:
        fail(f"{cfg.name} params live on {devices}, not on cuda")
    if any(launches.values()):
        fail(f"a kernel launched on the {cfg.name} training path: {launches}")
    return report, out


def add_launches(*runs) -> dict:
    return {name: sum(r["launches"][name] for r in runs) for name in runs[0]["launches"]}


def phase_main_mla(torch, counted, smi: str) -> dict:
    """The MLA family, minicpm3-4b: trained at full width (4 layers), then
    served whole through the launcher: (a) figures; (b) pooled against
    batch-1 decode; (c) a decode step against a cacheless forward; the
    absorbed decode against the expanded one (MLA_ABSORB_MAX_S = 0) on the
    engine's pooled cache at its per-slot positions; (e) chunked against
    single-pass prefill of SERVE_LONG tokens."""
    from repro_torch.configs import minicpm3_4b
    from repro_torch.models import layers, transformer

    report, train = train_family(torch, counted, minicpm3_4b, MLA_TRAIN_ARCH, MLA_TRAIN_ARGS,
                                 MLA_REDUCED, "main_mla")
    del report
    torch.cuda.empty_cache()
    report, args, path = serve_path(torch, counted, MLA_SERVE_ARGS, smi, "main_mla")
    cfg, eng, done = report.cfg, report.engine, sorted(report.done, key=lambda r: r.uid)
    params = eng.params
    serve_profile(torch, report, args.max_len, "main_mla")
    pooled, cacheless = pooled_and_cacheless(torch, cfg, params, done, args.max_len,
                                             "main_mla")
    toks = torch.tensor(eng.last_token[:, None], device="cuda")
    absorbed, _ = transformer.decode_step(params, eng.cache, toks, eng.positions, cfg)
    absorb_max = layers.MLA_ABSORB_MAX_S
    layers.MLA_ABSORB_MAX_S = 0
    try:
        expanded, _ = transformer.decode_step(params, eng.cache, toks, eng.positions, cfg)
    finally:
        layers.MLA_ABSORB_MAX_S = absorb_max
    branches = (absorbed.float() - expanded.float()).abs().max().item()
    emit({"phase": "main_mla", "check": "absorbed_vs_expanded", "arch": cfg.name,
          "positions": eng.positions.tolist(), "max_abs_diff": branches,
          "tolerance": SERVE_LOGIT_TOL})
    if not branches <= SERVE_LOGIT_TOL:
        fail(f"{cfg.name}: absorbed against expanded decode: {branches}")
    long = long_prefill(torch, cfg, params, "main_mla")
    del params, report, eng, done, absorbed, expanded
    torch.cuda.empty_cache()
    return {"train": train, "serve": path, "pooled": pooled, "cacheless": cacheless,
            "absorbed_vs_expanded": branches, "long": long,
            "launches": add_launches(train, path)}


def moe_route_check(torch) -> dict:
    """Gather against einsum dispatch on one full-width granite-moe layer at
    the training shape (a microbatch of LM_BS // 2 x LM_SEQ tokens, groups of
    128), fp32 with TF32 off, within MOE_ROUTE_TOL; each route's CUDA-event
    time beside it."""
    from repro_torch.config import replace
    from repro_torch.configs import granite_moe_3b_a800m
    from repro_torch.models import moe
    from repro_torch.tools.profile_lm_step import event_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(granite_moe_3b_a800m.full(), dtype="float32")
    gen = torch.Generator("cuda").manual_seed(0)
    p = moe.init_moe(gen, cfg)
    x = torch.randn((LM_BS // 2, LM_SEQ, cfg.d_model), generator=gen, device="cuda")
    routes = {d: replace(cfg, moe=replace(cfg.moe, dispatch=d)) for d in ("einsum", "gather")}
    with torch.no_grad():
        (y1, a1), (y2, a2) = (moe.apply_moe(p, x, routes[d]) for d in ("einsum", "gather"))
        ms = {d: event_ms(torch, lambda d=d: moe.apply_moe(p, x, routes[d])) for d in routes}
        N = x.shape[0] * x.shape[1]
        G = -(-N // cfg.moe.group_size)
        gsz = -(-N // G)
        capacity = max(int(gsz * cfg.moe.top_k / cfg.moe.num_experts * moe.CAPACITY_FACTOR),
                       cfg.moe.top_k)
        keep = moe._router_assignments(p, x.reshape(G, gsz, -1), cfg.moe, capacity)[3]
    ok = torch.allclose(y1, y2, atol=MOE_ROUTE_TOL, rtol=MOE_ROUTE_TOL) and \
        abs(a1.item() - a2.item()) <= 1e-5 * abs(a2.item())
    out = {"check": "gather_vs_einsum", "shape": list(x.shape), "dtype": "float32",
           "groups": G, "group_size": gsz, "capacity": capacity,
           "assignments": keep.numel(), "dropped": int((~keep).sum()),
           "max_abs_diff": (y1 - y2).abs().max().item(), "aux": [a1.item(), a2.item()],
           "tolerance": MOE_ROUTE_TOL, "ms": ms, "ok": ok}
    del p, x, y1, y2
    torch.cuda.empty_cache()
    return out


class DropWatch:
    """During a serving run: each pooled decode tick's live slots (read after
    the engine admits) and every MoE layer's keep mask of that tick (kept
    on the card, read after the run).  ``summary`` counts the ticks where a
    live slot lost an assignment.  ``restore`` puts the functions back."""

    def __init__(self, torch, moe, transformer, engine_cls, slots: int) -> None:
        self.torch, self.mods = torch, (moe, transformer, engine_cls)
        self.real = (moe._router_assignments, transformer.decode_step, engine_cls._admit)
        self.ticks, self.live, self.in_decode = [], [], False
        route, decode, admit = self.real

        def watched_admit(eng):
            admit(eng)
            self.live = [a is not None for a in eng.active]

        def watched_decode(*args, **kwargs):
            pooled = args[2].shape[0] == slots
            if pooled:
                self.ticks.append((self.live, []))
            self.in_decode = pooled
            try:
                return decode(*args, **kwargs)
            finally:
                self.in_decode = False

        def watched_route(*args):
            out = route(*args)
            if self.in_decode:
                self.ticks[-1][1].append(out[3].clone())
            return out

        moe._router_assignments = watched_route
        transformer.decode_step = watched_decode
        engine_cls._admit = watched_admit

    def restore(self) -> None:
        moe, transformer, engine_cls = self.mods
        moe._router_assignments, transformer.decode_step, engine_cls._admit = self.real

    def summary(self) -> dict:
        torch = self.torch
        out = {"decode_ticks": len(self.ticks), "ticks_live_slot_lost": 0,
               "live_assignments_lost": 0, "idle_assignments_lost": 0}
        for live, keeps in self.ticks:
            lost = (~torch.stack(keeps)[:, 0]).sum(dim=(0, 2)).cpu()  # (slots,) over layers
            mask = torch.tensor(live)
            out["ticks_live_slot_lost"] += int((lost[mask] > 0).any())
            out["live_assignments_lost"] += int(lost[mask].sum())
            out["idle_assignments_lost"] += int(lost[~mask].sum())
        return out


def phase_main_moe(torch, counted, smi: str) -> dict:
    """The MoE family: granite-moe-3b-a800m trained at full width (4 layers,
    the config's einsum dispatch; aux loss positive), gather against einsum
    on one full-width layer, then granite-moe-3b-a800m served whole (pooled
    held to batch-1: its decode capacity, max(int(8 * 8 / 40 * 1.25), 8) =
    8, never drops) and qwen2-moe-a2.7b served whole (15.15 B parameters;
    pooled against batch-1 printed, not gated: its decode capacity is
    max(int(8 * 4 / 60 * 1.25), 4) = 4, so a pooled tick can drop an
    assignment that batch-1 keeps, as in the reference; the ticks where a
    live slot lost one are counted)."""
    from repro_torch.configs import granite_moe_3b_a800m
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer
    from repro_torch.serve.engine import ServeEngine

    report, train = train_family(torch, counted, granite_moe_3b_a800m, MOE_TRAIN_ARCH,
                                 MOE_TRAIN_ARGS, MOE_REDUCED, "main_moe")
    del report
    if not all(a > 0 for a in train["aux_losses"]):
        fail(f"{MOE_TRAIN_ARCH}: aux loss not positive: {train['aux_losses']}")
    route = moe_route_check(torch)
    emit({"phase": "main_moe", **route})
    if not route["ok"]:
        fail(f"gather against einsum dispatch on the card: {route}")

    report, args, granite = serve_path(torch, counted, MOE_SERVE_ARGS, smi, "main_moe")
    done = sorted(report.done, key=lambda r: r.uid)
    serve_profile(torch, report, args.max_len, "main_moe")
    gpooled, _ = pooled_and_cacheless(torch, report.cfg, report.engine.params, done,
                                      args.max_len, "main_moe", cacheless=False)
    del report, done
    torch.cuda.empty_cache()

    slots = serve.parse_args(QWEN_SERVE_ARGS).slots
    watch = DropWatch(torch, moe, transformer, ServeEngine, slots)
    try:
        report, args, qwen = serve_path(torch, counted, QWEN_SERVE_ARGS, smi, "main_moe")
    finally:
        watch.restore()
    drops = watch.summary()
    del watch
    cfg, eng, done = report.cfg, report.engine, sorted(report.done, key=lambda r: r.uid)
    serve_profile(torch, report, args.max_len, "main_moe")
    toks = torch.tensor(eng.last_token[:, None], device="cuda")
    logits, _ = transformer.decode_step(eng.params, eng.cache, toks, eng.positions, cfg)
    finite = bool(torch.isfinite(logits).all())
    qpooled, _ = pooled_and_cacheless(torch, cfg, eng.params, done, args.max_len, "main_moe",
                                      gate=False, cacheless=False)
    emit({"phase": "main_moe", "check": "qwen_drops", "arch": cfg.name, "slots": slots,
          "decode_capacity": max(int(args.slots * cfg.moe.top_k / cfg.moe.num_experts
                                     * moe.CAPACITY_FACTOR), cfg.moe.top_k),
          **drops, "finite_logits": finite,
          "pooled_not_gated": "capacity is set per group, so a pooled tick can drop an "
                              "assignment that batch-1 decode keeps, as in the reference"})
    if not finite:
        fail(f"{cfg.name}: non-finite logits after serving")
    del logits, report, eng, done
    torch.cuda.empty_cache()
    return {"train": train, "route": route, "granite": granite, "granite_pooled": gpooled,
            "qwen": qwen, "qwen_pooled": qpooled, "qwen_drops": drops,
            "launches": add_launches(train, granite, qwen)}


def mamba_carry(torch, cfg, params) -> dict:
    """(c) The Mamba state carried from prefill into decode at full width,
    on the served weights of one Mamba layer (``sub0``): HYBRID_CARRY_S
    hidden states drawn from a seed through ``apply_mamba`` without a cache,
    against a prefill of the first HYBRID_CARRY_S - HYBRID_CARRY_DECODE
    into ``init_mamba_cache`` and single-token decode steps for the rest;
    each decoded row within HYBRID_CARRY_TOL of its norm, and the fp32
    state and conv window after them against a single pass's (prefill of
    all HYBRID_CARRY_S) within HYBRID_CARRY_TOL of each one's largest
    entry.  Gated."""
    from repro_torch.models import ssm

    p = params["blocks"]["sub0"]["mamba"]
    S, n = HYBRID_CARRY_S, HYBRID_CARRY_DECODE
    gen = torch.Generator("cuda").manual_seed(4)
    h = torch.randn((1, S, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        full, _ = ssm.apply_mamba(p, h, cfg)
        _, one_pass = ssm.apply_mamba(p, h, cfg, cache=ssm.init_mamba_cache(cfg, 1, "cuda"))
        _, cache = ssm.apply_mamba(p, h[:, :S - n], cfg,
                                   cache=ssm.init_mamba_cache(cfg, 1, "cuda"))
        rows = []
        for i in range(S - n, S):
            y, cache = ssm.apply_mamba(p, h[:, i:i + 1], cfg, cache=cache)
            rows.append(y[0, 0].float())
    want, got = full[0, S - n:].float(), torch.stack(rows)
    row_rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    scale = {k: one_pass[k].abs().max().item() for k in ("ssm", "conv")}
    state_diff = (cache["ssm"] - one_pass["ssm"]).abs().max().item()
    conv_diff = (cache["conv"] - one_pass["conv"]).abs().max().item()
    out = {"phase": "main_hybrid", "check": "c_mamba_carry", "arch": cfg.name,
           "layer": "blocks/sub0/mamba", "tokens": S, "decoded": n, "dtype": cfg.dtype,
           "scan_chunk": ssm.SCAN_CHUNK, "row_rel_err": row_rel,
           "state_max_abs_diff": state_diff, "state_max_abs": scale["ssm"],
           "conv_max_abs_diff": conv_diff, "conv_max_abs": scale["conv"],
           "tolerance": HYBRID_CARRY_TOL,
           "finite": bool(torch.isfinite(full).all() and torch.isfinite(cache["ssm"]).all())}
    emit(out)
    if not (out["finite"] and max(row_rel) <= HYBRID_CARRY_TOL
            and state_diff <= HYBRID_CARRY_TOL * scale["ssm"]
            and conv_diff <= HYBRID_CARRY_TOL * scale["conv"]):
        fail(f"{cfg.name}: Mamba state carried from prefill to decode: {out}")
    return out


def scan_chunk_sweep(torch, cfg, params) -> dict:
    """The Mamba scan's chunk on one served layer (``sub0``): ``apply_mamba``
    over 1 x SERVE_LONG hidden states drawn from a seed at each of
    HYBRID_SCAN_CHUNKS tokens a chunk, CUDA-event ms (median of 3 after a
    warm-up) and the peak above what was allocated before.  Printed, not
    gated: it says why ``ssm.SCAN_CHUNK`` is what it is."""
    from repro_torch.models import ssm
    from repro_torch.tools.profile_lm_step import event_ms

    p = params["blocks"]["sub0"]["mamba"]
    gen = torch.Generator("cuda").manual_seed(6)
    h = torch.randn((1, SERVE_LONG, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    chosen, times, peaks = ssm.SCAN_CHUNK, {}, {}
    try:
        with torch.inference_mode():
            for chunk in HYBRID_SCAN_CHUNKS:
                ssm.SCAN_CHUNK = chunk
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                times[chunk] = event_ms(torch, lambda: ssm.apply_mamba(p, h, cfg))
                peaks[chunk] = torch.cuda.max_memory_allocated() - base
    finally:
        ssm.SCAN_CHUNK = chosen
    del h
    torch.cuda.empty_cache()
    out = {"phase": "main_hybrid", "check": "c_scan_chunk", "arch": cfg.name,
           "layer": "blocks/sub0/mamba", "tokens": SERVE_LONG, "scan_chunk": chosen,
           "apply_mamba_ms": times, "peak_above_bytes": peaks}
    emit(out)
    return out


def hybrid_long_prefill(torch, cfg, params) -> dict:
    """(e) One SERVE_LONG-token prompt prefilled in one pass (a hybrid is
    never chunked): its time (the Mamba scan's share behind synchronizes),
    peak memory, finite logits (gated).  Then, printed and not gated (MoE
    groups differ), the whole model's last logits after a single pass of
    its first HYBRID_CARRY_S tokens against a prefill of all but the last
    SERVE_LONG_NEW of them and single-token decode steps over those: at
    SERVE_LONG the shorter prefill (16380, off the 1024 grid) takes the
    dense attention branch, as the reference's does, whose fp32 scores
    alone are 34 GB beside the 53 GB of weights."""
    import numpy as np

    from repro_torch.models import ssm, transformer

    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (1, SERVE_LONG)).astype(np.int32)).to("cuda")
    cache = transformer.init_cache(cfg, 1, SERVE_LONG, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = SyncTimer(torch, ssm, ("_scan_chunked",))
    t0 = time.perf_counter()
    try:
        logits, cache = transformer.prefill(params, {"tokens": prompt}, cfg, cache)
        torch.cuda.synchronize()
    finally:
        timer.restore()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    last = logits[0].float()
    finite = bool(torch.isfinite(last).all())
    del cache, logits
    torch.cuda.empty_cache()
    S, head = HYBRID_CARRY_S, HYBRID_CARRY_S - SERVE_LONG_NEW
    one, _ = transformer.prefill(params, {"tokens": prompt[:, :S]}, cfg,
                                 transformer.init_cache(cfg, 1, S, "cuda"))
    cache = transformer.init_cache(cfg, 1, S, "cuda")
    logits, cache = transformer.prefill(params, {"tokens": prompt[:, :head]}, cfg, cache)
    for i in range(head, S):
        logits, cache = transformer.decode_step(params, cache, prompt[:, i:i + 1], i, cfg)
    diff = (logits[0].float() - one[0].float()).abs().max().item()
    same = int(logits[0].argmax()) == int(one[0].argmax())
    del cache, logits, one
    torch.cuda.empty_cache()
    out = {"phase": "main_hybrid", "check": "e_single_pass_prefill", "arch": cfg.name,
           "prompt_len": SERVE_LONG, "chunked": False, "prefill_ms": ms,
           "mamba_scan_ms": 1e3 * sum(timer.times["_scan_chunked"]),
           "mamba_scan_calls": len(timer.times["_scan_chunked"]),
           "max_memory_allocated_bytes": peak,
           "device_total_bytes": torch.cuda.get_device_properties(0).total_memory,
           "finite_logits": finite, "tail_prompt_len": S, "decoded_tail": SERVE_LONG_NEW,
           "tail_max_abs_diff_not_gated": diff, "tail_same_argmax": same}
    emit(out)
    if not finite:
        fail(f"{cfg.name}: non-finite logits after a {SERVE_LONG}-token single-pass prefill")
    return out


def hybrid_flash_eval(torch, counted, cfg, params) -> dict:
    """(k) The kernel on the hybrid's path: ``flash_eval`` on the served
    model over LM_EVAL_BATCHES batches of HYBRID_EVAL_BS x LM_SEQ tokens
    drawn from a seed, flash launched once a batch per attention layer."""
    import numpy as np

    from repro_torch.models import transformer

    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (HYBRID_EVAL_BS, LM_SEQ))
                                    .astype(np.int32)).to("cuda") for k in ("tokens", "targets")}
               for _ in range(LM_EVAL_BATCHES)]
    attn_layers = sum(m == "attn" for m, _ in transformer.layer_kinds(cfg))
    return flash_eval(torch, counted, cfg, params, batches, "main_hybrid", attn_layers,
                      HYBRID_EVAL_TOL, batch=[HYBRID_EVAL_BS, LM_SEQ],
                      attention_layers=attn_layers)


def phase_main_hybrid(torch, counted, smi: str) -> dict:
    """The hybrid family, jamba-v0.1-52b: (t) trained through the launcher
    at its smoke widths; (a) one full-width period (8 layers, 13.30 B
    parameters) served through ``launch/serve.py`` at the reference
    launcher's defaults; (b) pooled against batch-1 decode, printed and
    not gated (its decode capacity, max(int(8 * 2 / 16 * 1.25), 2) = 2,
    drops assignments a batch-1 decode keeps, as the reference's does),
    beside the ticks where a live slot lost an assignment; (c) the Mamba
    state's carry from prefill to decode, and one Mamba layer timed at
    each of HYBRID_SCAN_CHUNKS; (e) a SERVE_LONG-token prompt in
    one pass; (k) the flash kernel on its attention layer, ``make_eval_step``
    with ``attention_impl="pallas"`` against ``"ref"``; (f) the smoke model
    and its stacked variant on the card against the CPU."""
    import dataclasses

    from repro_torch.config import get_arch, register_arch, replace
    from repro_torch.configs import jamba_v0_1_52b
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer
    from repro_torch.serve.engine import ServeEngine

    # (t) the launcher's training run at smoke widths
    report, train = train_family(torch, counted, None, HYBRID_ARCH, HYBRID_TRAIN_ARGS,
                                 HYBRID_TRAIN_REDUCED, "main_hybrid")
    del report
    if not all(a > 0 for a in train["aux_losses"]):
        fail(f"{HYBRID_ARCH}: aux loss not positive: {train['aux_losses']}")
    torch.cuda.empty_cache()

    # (a) one full-width period served
    register_arch(HYBRID_SERVE_ARCH,
                  lambda: replace(jamba_v0_1_52b.full(), num_layers=HYBRID_SERVE_LAYERS),
                  jamba_v0_1_52b.smoke)
    slots = serve.parse_args(HYBRID_SERVE_ARGS).slots
    watch = DropWatch(torch, moe, transformer, ServeEngine, slots)
    try:
        report, args, path = serve_path(torch, counted, HYBRID_SERVE_ARGS, smi, "main_hybrid",
                                        reduced=HYBRID_SERVE_REDUCED)
    finally:
        watch.restore()
    drops = watch.summary()
    del watch
    cfg, eng, done = report.cfg, report.engine, sorted(report.done, key=lambda r: r.uid)
    params = eng.params
    serve_profile(torch, report, args.max_len, "main_hybrid")

    # (b) pooled against batch-1 decode, not gated
    pooled, _ = pooled_and_cacheless(torch, cfg, params, done, args.max_len, "main_hybrid",
                                     gate=False, cacheless=False)
    emit({"phase": "main_hybrid", "check": "b_drops", "arch": cfg.name, "slots": slots,
          "decode_capacity": max(int(slots * cfg.moe.top_k / cfg.moe.num_experts
                                     * moe.CAPACITY_FACTOR), cfg.moe.top_k),
          **drops, "pooled_not_gated": "capacity is set per group, so a pooled tick can drop "
                                       "an assignment that batch-1 decode keeps, as in the "
                                       "reference"})
    del report, eng
    carry = mamba_carry(torch, cfg, params)  # (c)
    chunks = scan_chunk_sweep(torch, cfg, params)
    long = hybrid_long_prefill(torch, cfg, params)  # (e)
    flash = hybrid_flash_eval(torch, counted, cfg, params)  # (k)
    del params, done
    torch.cuda.empty_cache()

    # (f) the smoke model, one block and stacked, on the card against the CPU
    smoke = dataclasses.replace(get_arch(HYBRID_ARCH, smoke=True), dtype="float32")
    card_vs_cpu(torch, [smoke, dataclasses.replace(smoke, num_layers=HYBRID_STACKED_LAYERS)],
                "main_hybrid")
    return {"train": train, "serve": path, "pooled": pooled, "drops": drops, "carry": carry,
            "scan_chunks": chunks, "long": long, "flash": flash,
            "launches": add_launches(train, path, flash)}


def encdec_batches(torch, cfg, n: int, seed: int) -> list:
    """``n`` training batches of ENCDEC_BS rows drawn on the card: frames
    N(0, 1), tokens and targets from a 1/rank unigram over the vocabulary."""
    gen = torch.Generator("cuda").manual_seed(seed)
    zipf = 1.0 / torch.arange(1, cfg.vocab_size + 1, dtype=torch.float32, device="cuda")
    fd = cfg.frontend_dim or cfg.d_model

    def text():
        return torch.multinomial(zipf, ENCDEC_BS * ENCDEC_TEXT, replacement=True,
                                 generator=gen).view(ENCDEC_BS, ENCDEC_TEXT).to(torch.int32)

    return [{"frames": torch.randn((ENCDEC_BS, cfg.encoder_seq_len, fd), generator=gen,
                                   device="cuda"),
             "tokens": text(), "targets": text()} for _ in range(n)]


def encdec_train(torch, counted, cfg, smi: str):
    """(t) whisper-large-v3 whole trained ENCDEC_STEPS AdamW steps through
    ``make_train_step``, the weights drawn on the card with
    ``init_train_state``; every counted kernel's launches set to 0 just
    before the steps and read just after.  Gated on finite losses, the last
    step's below the first's and a held-out batch's loss (``make_eval_step``)
    lower after the steps than before them (Adam's first update, every
    weight moved by the learning rate, raises the next step's loss at full
    width), parameters on the card and no kernel launch (training takes
    the plain attention).  Returns (state, batches, figures)."""
    from repro_torch.config import TrainConfig
    from repro_torch.tools.profile_lm_step import busy_ms, profiled
    from repro_torch.train.steps import init_train_state, make_eval_step, make_train_step
    from repro_torch.tree import leaves

    tcfg = TrainConfig(optimizer="adamw", learning_rate=ENCDEC_LR, warmup_steps=ENCDEC_STEPS,
                       total_steps=ENCDEC_STEPS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    batches = encdec_batches(torch, cfg, ENCDEC_STEPS, seed=1)
    held_out = encdec_batches(torch, cfg, 1, seed=2)[0]
    step, evaluate = make_train_step(cfg, tcfg), make_eval_step(cfg)
    held_before = evaluate(state["params"], held_out)["loss"].item()
    torch.cuda.reset_peak_memory_stats()
    losses, grad_norms, step_s, prof = [], [], [], None
    for fn in counted.values():
        fn.launches = 0
    for i, batch in enumerate(batches):
        def run(batch=batch):
            nonlocal state
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            grad_norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == len(batches) - 1:  # the last step under the profiler
            prof = profiled(torch, run, 1)
        else:
            run()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counted.items()}
    held_after = evaluate(state["params"], held_out)["loss"].item()
    steady = step_s[1:-1]  # after the first, before the profiled one
    busy = busy_ms(prof["intervals"])
    devices = sorted({p.device.type for p in leaves(state["params"])})
    out = {"phase": "main_encdec", "check": "t_train", "arch": cfg.name,
           "num_layers": cfg.num_layers, "num_encoder_layers": cfg.num_encoder_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
           "heads": cfg.attention.num_heads, "head_dim": cfg.attention.head_dim,
           "params": sum(p.numel() for p in leaves(state["params"])),
           "batch": ENCDEC_BS, "encoder_frames": cfg.encoder_seq_len, "text_tokens": ENCDEC_TEXT,
           "optimizer": "adamw", "learning_rate": ENCDEC_LR, "warmup_steps": ENCDEC_STEPS,
           "steps": len(losses),
           "losses": losses, "grad_norms": grad_norms,
           "held_out_loss_before": held_before, "held_out_loss_after": held_after,
           "step_s": step_s,
           "step_s_median_after_first": statistics.median(steady),
           "tokens_per_s_after_first_step": len(steady) * ENCDEC_BS * ENCDEC_TEXT / sum(steady),
           "frames_per_s_after_first_step":
               len(steady) * ENCDEC_BS * cfg.encoder_seq_len / sum(steady),
           "profiled_step": {"wall_ms": prof["wall_ms"], "device_busy_ms": busy,
                             "busy_share": busy / prof["wall_ms"],
                             "kernels": len(prof["intervals"]),
                             "device_ms_by_category": dict(sorted(
                                 prof["by_cat"].items(), key=lambda kv: -kv[1]))},
           "init_s": init_s, "init_peak_bytes": init_peak,
           "step_peak_bytes": torch.cuda.max_memory_allocated(),
           "device_total_bytes": torch.cuda.get_device_properties(0).total_memory,
           "param_devices": devices, "launches": launches,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, "nvidia_smi": smi}
    emit(out)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] \
            or not held_after < held_before:
        fail(f"{cfg.name} training losses not finite and falling: {losses}, held-out "
             f"{held_before} -> {held_after}")
    if devices != ["cuda"]:
        fail(f"{cfg.name} params live on {devices}, not on cuda")
    if any(launches.values()):
        fail(f"a kernel launched on the {cfg.name} training path: {launches}")
    return state, batches, out


def flash_eval(torch, counted, cfg, weights, batches, phase: str, layers: int, bound: float,
               **fields) -> dict:
    """``make_eval_step`` with ``attention_impl="pallas"`` against ``"ref"``
    on ``weights`` over ``batches``; every counted kernel's launches set to 0 just before
    the flash pass and read just after.  Gated on finite losses within
    ``bound``, flash launched ``layers`` times a batch and no other kernel."""
    import dataclasses

    from repro_torch.train.steps import make_eval_step

    eval_flash = make_eval_step(dataclasses.replace(cfg, attention_impl="pallas"))
    eval_ref = make_eval_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_flash = [eval_flash(weights, b)["loss"].item() for b in batches]
    flash_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    t0 = time.perf_counter()
    loss_ref = [eval_ref(weights, b)["loss"].item() for b in batches]
    ref_s = time.perf_counter() - t0
    diffs = [abs(a - b) for a, b in zip(loss_flash, loss_ref)]
    want = layers * len(batches)
    out = {"phase": phase, "check": "k_flash_eval", "arch": cfg.name, **fields,
           "eval_batches": len(batches), "eval_loss_flash": loss_flash, "eval_loss_ref": loss_ref,
           "eval_max_diff": max(diffs), "eval_limit": bound, "flash_wall_s": flash_s,
           "ref_wall_s": ref_s, "launches": launches,
           "flash_attention_launches_expected": want,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    if not all(math.isfinite(x) for x in loss_flash) or max(diffs) > bound:
        fail(f"{cfg.name}: flash eval loss {loss_flash} vs plain attention {loss_ref}")
    if launches["flash_attention"] != want or \
            any(v for name, v in launches.items() if name != "flash_attention"):
        fail(f"{cfg.name}: launches on the flash eval {launches}, want flash_attention {want}")
    return out


def flash_at_model_shape(torch, cfg, flash_ops, flash_ref, bw, peak) -> dict:
    """The flash kernel alone at the encoder-decoder's decoder shape, q, k, v
    (ENCDEC_BS, H, ENCDEC_TEXT, 64) bf16, causal (the D = 64 tensor-core
    route): against its plain version, timed beside it and SDPA."""
    import torch.nn.functional as F

    a = cfg.attention
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v = (torch.randn((ENCDEC_BS, a.num_heads, ENCDEC_TEXT, a.head_dim), generator=gen,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = flash_ref.attention_ref(q, k, v, causal=True).float()
    diff = (got.float() - want).abs()
    err = diff.max().item()
    close = bool(torch.all(diff <= 2e-2 + 2e-2 * want.abs()).item())  # phase_flash's bf16 limit
    S, D = ENCDEC_TEXT, a.head_dim
    flops = 2.0 * ENCDEC_BS * a.num_heads * S * S * D  # q k^T and p v over the causal triangle
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read once, out written once
    bound, bound_by = bound_ms(nbytes, flops, bw, peak)
    out = {"phase": "main_encdec", "check": "k_flash_shape", "shape": list(q.shape),
           "dtype": "bfloat16", "route": flash_ops.route(q.dtype, D), "max_abs_err": err,
           "tolerance": "2e-2 + 2e-2 * |plain|", "close": close,
           "kernel_ms": device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True)),
           "plain_ms": device_ms(lambda: flash_ref.attention_ref(q, k, v, causal=True)),
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True)),
           "bound_ms": bound, "bound_by": bound_by, "flops": flops, "bound_bytes": nbytes}
    emit(out)
    if not close:
        fail(f"flash at the encoder-decoder's shape: max abs err {err}")
    return out


def encdec_cacheless(torch, cfg, params, done, max_len: int) -> list:
    """(c) SERVE_CACHELESS requests' teacher-forced decode logits (every
    step) against a cacheless forward of the same tokens over the same zero
    frames (the twin of ``tests/test_archs_smoke.py``'s
    ``test_decode_matches_forward_gqa``), within SERVE_LOGIT_TOL (gated)."""
    from repro_torch.models import encdec
    from repro_torch.models.layers import apply_lm_head, apply_norm

    diffs = []
    for req in done[:SERVE_CACHELESS]:
        P = len(req.prompt)
        forced = forced_logits(torch, cfg, params, req.prompt.tolist(), req.output, max_len)
        seq = torch.tensor([req.prompt.tolist() + req.output[:-1]], device="cuda")
        with torch.inference_mode():
            batch = serve_batch(torch, cfg, seq)
            enc = encdec.encode(params, batch["frames"], cfg)
            x = encdec._with_positions(params, seq, cfg)
            x = encdec._decoder(params, x, cfg, torch.arange(seq.shape[1], device="cuda"),
                                enc=enc)
            full = apply_lm_head(params["lm_head"], apply_norm(params["final_norm"], x, cfg),
                                 cfg)[0, P - 1:].float()
        diffs.append((full - forced).abs().max().item())
    emit({"phase": "main_encdec", "check": "c_decode_vs_cacheless", "arch": cfg.name,
          "uids": [r.uid for r in done[:SERVE_CACHELESS]], "steps_each": len(done[0].output),
          "max_abs_diff": diffs, "tolerance": SERVE_LOGIT_TOL})
    if not max(diffs) <= SERVE_LOGIT_TOL:
        fail(f"{cfg.name}: teacher-forced decode against a cacheless forward: {diffs}")
    return diffs


def phase_main_encdec(torch, counted, smi: str, flash_ops, flash_ref, bw, peak) -> dict:
    """The encoder-decoder, whisper-large-v3 whole: (t) trained through
    ``make_train_step``; (k) the flash kernel on its decoder's cacheless
    self-attention through ``make_eval_step``, and alone at that shape; (a)
    served through ``launch/serve.py`` at the reference launcher's defaults,
    the cross-KV cache's size beside; (b) pooled against batch-1 decode; (c)
    teacher-forced decode against a cacheless forward; (f) the smoke model
    served on the card against the CPU; then (v) the VLM stub, internvl2-26b
    at full width (4 layers), its flash eval."""
    import dataclasses

    import numpy as np

    from repro_torch.config import get_arch, register_arch, replace
    from repro_torch.configs import internvl2_26b
    from repro_torch.models import transformer
    from repro_torch.tree import leaves

    cfg = get_arch(ENCDEC_ARCH)
    # (t) and (k) on the trained weights
    state, batches, train = encdec_train(torch, counted, cfg, smi)
    params = state["params"]
    del state["opt"]
    torch.cuda.empty_cache()
    flash = flash_eval(torch, counted, cfg, params, batches[:ENCDEC_EVAL_BATCHES], "main_encdec",
                       cfg.num_layers, ENCDEC_EVAL_TOL,
                       batch=[ENCDEC_BS, ENCDEC_TEXT], encoder_frames=cfg.encoder_seq_len,
                       decoder_layers=cfg.num_layers)
    shape = flash_at_model_shape(torch, cfg, flash_ops, flash_ref, bw, peak)
    del state, params, batches
    torch.cuda.empty_cache()

    # (a) served whole
    report, args, path = serve_path(torch, counted, ENCDEC_SERVE_ARGS, smi, "main_encdec")
    cfg, eng, done = report.cfg, report.engine, sorted(report.done, key=lambda r: r.uid)
    params = eng.params
    cross = {k: eng.cache[k].numel() * eng.cache[k].element_size() for k in eng.cache}
    emit({"phase": "main_encdec", "check": "a_cache", "arch": cfg.name,
          "leaves": {k: list(t.shape) for k, t in eng.cache.items()}, "bytes": cross,
          "cross_kv_bytes": cross["cross_k"] + cross["cross_v"],
          "self_kv_bytes": cross["k"] + cross["v"]})
    profile = serve_profile(torch, report, args.max_len, "main_encdec")
    # (b) pooled against batch-1 decode, gated; (c) against a cacheless forward
    pooled, _ = pooled_and_cacheless(torch, cfg, params, done, args.max_len, "main_encdec",
                                     cacheless=False)
    cacheless = encdec_cacheless(torch, cfg, params, done, args.max_len)
    del params, report, eng, done
    torch.cuda.empty_cache()
    # (f) the smoke model served on the card against the CPU
    card_vs_cpu(torch, [dataclasses.replace(get_arch(ENCDEC_ARCH, smoke=True), dtype="float32")],
                "main_encdec")

    # (v) the VLM stub at full width, depth cut
    register_arch(VLM_EVAL_ARCH, lambda: replace(internvl2_26b.full(), num_layers=VLM_LAYERS),
                  internvl2_26b.smoke)
    vcfg = get_arch(VLM_EVAL_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vparams = transformer.init_lm(vcfg, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    vbatches = [{"tokens": torch.from_numpy(rng.integers(
                     0, vcfg.vocab_size, (VLM_EVAL_BS, VLM_EVAL_SEQ)).astype(np.int32)).cuda(),
                 "targets": torch.from_numpy(rng.integers(
                     0, vcfg.vocab_size, (VLM_EVAL_BS, VLM_EVAL_SEQ)).astype(np.int32)).cuda(),
                 "patch_embeds": torch.from_numpy(rng.standard_normal(
                     (VLM_EVAL_BS, vcfg.num_patch_tokens, vcfg.frontend_dim)).astype(
                         np.float32)).cuda()}
                for _ in range(ENCDEC_EVAL_BATCHES)]
    vlm = flash_eval(torch, counted, vcfg, vparams, vbatches, "main_encdec", vcfg.num_layers,
                     ENCDEC_EVAL_TOL, reduced=VLM_REDUCED, num_layers=vcfg.num_layers,
                     d_model=vcfg.d_model, heads=[vcfg.attention.num_heads,
                                                  vcfg.attention.num_kv_heads],
                     params=sum(t.numel() for t in leaves(vparams)), init_s=init_s,
                     batch=[VLM_EVAL_BS, VLM_EVAL_SEQ],
                     patch_embeds=[VLM_EVAL_BS, vcfg.num_patch_tokens, vcfg.frontend_dim],
                     nvidia_smi=smi)
    del vparams, vbatches
    torch.cuda.empty_cache()
    return {"train": train, "flash": flash, "flash_shape": shape, "serve": path,
            "profile": profile, "pooled": pooled, "cacheless": cacheless, "vlm": vlm,
            "launches": add_launches(train, flash, path),
            "launches_vlm": vlm["launches"]}


def timed(torch, name: str, fn, *args):
    """A main phase's result, its wall time printed on a line of its own."""
    t0 = time.perf_counter()
    out = fn(torch, *args)
    emit({"phase": name, "check": "phase_wall", "wall_s": time.perf_counter() - t0})
    return out


def build_all(builders) -> dict:
    """Build every kernel library at once, one nvcc per source."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {name: pool.submit(build) for name, build in builders.items()}
        built = {name: f.result() for name, f in futures.items()}
    wall = time.monotonic() - t0
    for name, b in built.items():
        emit({"phase": "build", "kernel": name, "wall_s_all": wall,
              "nvcc_seconds": b.seconds, "library": b.path.name,
              "ptxas": [ln.strip() for ln in b.log.splitlines() if "ptxas info" in ln]})
    return built


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
    bw, peak = lookup(BANDWIDTH, name), lookup(PEAK_BF16, name)
    peak_f32 = lookup(PEAK_FP32, name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "bandwidth_bytes_per_s": bw,
          "peak_bf16_flops": peak, "peak_fp32_flops": peak_f32})

    # 2. build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ingest_norm import ops, ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref

    build_all({"ingest_norm": ops.build, "flash_attention": flash_ops.build_cuda_core,
               "flash_attention_sm90": flash_ops.build_tensor_core, "rwkv6_wkv": wkv_ops.build,
               "rmsnorm": rms_ops.build})

    # 3.-10.
    kern = phase_kernels(torch, ops, ref, bw)
    flash = phase_flash(torch, flash_ops, flash_ref, bw, peak)
    wkv = phase_wkv(torch, wkv_ops, wkv_ref, bw, peak_f32)
    rms = phase_rmsnorm(torch, rms_ops, rms_ref, bw)
    torch.cuda.empty_cache()
    phase_model(torch)
    phase_model_lm(torch)
    phase_model_rwkv(torch)
    phase_model_families(torch)
    main_out = timed(torch, "main", phase_main, ops)
    pipe_out = timed(torch, "main_pipeline", phase_main_pipeline, ops, main_out, smi)
    auto_out = timed(torch, "main_autotune", phase_main_autotune, ops, main_out,
                     pipe_out["figures"]["pipeline"], smi)
    lm_out = timed(torch, "main_lm", phase_main_lm, flash_ops, ops)
    rwkv_out = timed(torch, "main_rwkv", phase_main_rwkv, wkv_ops, wkv_ref, rms_ops, ops,
                     flash_ops)
    counted = {"ingest_norm": ops.ingest_norm, "flash_attention": flash_ops.flash_attention,
               "rwkv6_wkv": wkv_ops.wkv, "rmsnorm": rms_ops.rmsnorm}
    serve_out = timed(torch, "main_serve", phase_main_serve, counted, smi)
    mla_out = timed(torch, "main_mla", phase_main_mla, counted, smi)
    moe_out = timed(torch, "main_moe", phase_main_moe, counted, smi)
    hybrid_out = timed(torch, "main_hybrid", phase_main_hybrid, counted, smi)
    encdec_out = timed(torch, "main_encdec", phase_main_encdec, counted, smi, flash_ops,
                       flash_ref, bw, peak)
    family = {name: {"launches_mla": mla_out["launches"][name],
                     "launches_moe": moe_out["launches"][name],
                     "launches_hybrid": hybrid_out["launches"][name],
                     "launches_encdec": encdec_out["launches"][name],
                     "launches_vlm": encdec_out["launches_vlm"][name]} for name in counted}

    emit({"kernels": [{
        "name": "ingest_norm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ingest_norm/csrc/ingest_norm.cu",
        "replaces": "src/repro/kernels/ingest_norm/kernel.py:29",
        "launches": main_out["ingest_norm_launches"],
        "launches_pipeline": pipe_out["ingest_norm_launches"],
        "launches_autotune": auto_out["launches"]["autotune"],
        "launches_thread_budget": auto_out["launches"]["thread_budget"],
        "launches_serve": serve_out["launches"]["ingest_norm"],
        **family["ingest_norm"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"],
        "kernel_ms": kern["kernel_ms"],
        "kernel_cold_ms": kern["kernel_cold_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
        "launches": lm_out["flash_attention_launches"],
        "launches_serve": serve_out["launches"]["flash_attention"],
        **family["flash_attention"],
        "max_abs_err": flash["max_abs_err"],
        "ms": flash["kernel_ms"],
        "kernel_ms": flash["kernel_ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "fp32_kernel_ms": flash["fp32_kernel_ms"],
        "fp32_source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "encdec_shape": {k: encdec_out["flash_shape"][k] for k in (
            "shape", "route", "max_abs_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")},
    }, {
        "name": "rwkv6_wkv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:78",
        "launches": rwkv_out["wkv_launches"],
        "launches_serve": serve_out["launches"]["rwkv6_wkv"],
        **family["rwkv6_wkv"],
        "max_abs_err": wkv["max_abs_err"],
        "ms": wkv["kernel_ms"],
        "kernel_ms": wkv["kernel_ms"],
        "plain_ms": wkv["plain_ms"],
        "bound_ms": wkv["bound_ms"],
        "bound_by": wkv["bound_by"],
        "library_ms": None,
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:26",
        "launches": rms["launches"],
        "launches_serve": serve_out["launches"]["rmsnorm"],
        **family["rmsnorm"],
        "max_abs_err": rms["max_abs_err"],
        "ms": rms["kernel_ms"],
        "kernel_ms": rms["kernel_ms"],
        "plain_ms": rms["plain_ms"],
        "bound_ms": rms["bound_ms"],
        "bound_by": "bytes",
        "library_ms": rms["library_ms"],
        "note": rms["note"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
