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
6d. main_cache — the ResNet path behind the cache tiers: (a) the launcher
   at main's cell with ``--cache-mb 256`` (a memory tier that holds the
   whole 118 MB set) and with ``--store memory`` (the local-drive
   yardstick): items/s of each epoch beside main's, the Table-3 columns,
   the memory tier's hits, misses and hit rate and the s3sim GETs of each
   epoch; gated on zero GETs and a memory hit rate of 1.0 in epochs 2-3,
   finite losses and launches equal to batches moved.  (b) a 32 MiB memory
   tier over a 256 MiB journal-coordinated disk tier under ``build/``,
   through ``make_loader`` and the staged pipeline, training 3 epochs of
   512 items at batch 32 with the cache knobs on the epoch-cadence
   controller: its device stream (main_autotune's digest) equals the
   uncached fixed-knob loader's, every tuning event lies inside its knob's
   bounds, at each epoch's end both tiers lie within their capacities and
   the journal's bytes equal the entry files', epochs 2-3 reach a combined
   hit rate of 0.99; a restart over the same directory serves its epoch
   from the disk tier (hit rate >= 0.99, at most 1 % of items from s3sim)
   with the first epoch's stream; the run's trace is dumped to
   ``build/chip_smoke_cache_trace.json`` and its span count printed by
   lane.  (c) an elastic fleet: the card trains from an elastic legacy
   loader while a spawned CPU member (no torch) joins after its 4th batch;
   gated on the members' claims covering the epoch exactly once, every
   card batch matching the u8 bytes of the items it claimed, and an empty
   membership board once both left.
6e. main_formats — the loader's data plane and its serving mirror: (a)
   main_pipeline's process-executor cell through the launcher with
   ``--transport shm`` (1 MiB slots, as many a worker slab as fit in half
   of /dev/shm's free bytes, printed, at most 32 and at least 8): items/s
   of each epoch beside the pipe transport's run, the transport's samples,
   fallbacks by reason, fallback rate, bytes copied a sample and slab
   peak; gated on main_pipeline (a)'s gates, samples through the slab, no
   oversize or ragged fallback, fewer bytes copied a sample than the pipe
   run, no torch mapped in the CPU workers and no segment left under
   /dev/shm after the loader closes.  (b) 128 items at full image size
   through ``make_loader`` (2 process workers): the shm transport's device
   stream (main_autotune's digest) equals the pipe transport's and the
   thread executor's, again with every worker armed to die mid slab write
   (crashes and respawns seen) and with the slab cap set to 8 mid-epoch;
   samples augmented without torch.  (c) 2048 items converted to a
   label-clustered columnar store behind s3sim, full-width ResNet-18
   trained 3 epochs under ``label < 250`` (about a quarter of the rows):
   the device stream equals the row store's with the rejected rows removed,
   a filtered epoch moves at most half the origin bytes of an unfiltered
   epoch drained on the host, launches equal batches moved.  (d) main's
   1024 items as 16 tar shards of 64 behind s3sim, 2 epochs of one
   full-width SGD step a batch of 64 (host-normalized f32: no
   ``ingest_norm``): 16 GETs an epoch, each epoch's labels the store's,
   every member the bytes of its item.  (e) benchmarks/bench_serve.py's
   trace at its quick sizes, uncoalesced and through the read path, over a
   memory and a disk tier in front of s3sim: interactive p50 / p99 / p999
   of each; gated on one primary fetch a key a coalesce window, the disk
   tier within its bound at every 50 ms sample, the scraper within its
   byte budget, every payload the store's.  Host only; no kernel runs.
6f. main_resume — checkpointing, fault tolerance and sharded delivery on
   full-width ResNet-18 from s3sim with ``--device-ingest``: (a) the
   launcher in child processes (deterministic algorithms, cuDNN's search
   off, ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), 12 AdamW steps of 32 over 320
   items: run B unbroken, run A with ``--ckpt-dir --ckpt-every 4``
   SIGKILLed (its whole session) as soon as its step-8 checkpoint exists,
   then A again with ``--resume`` (and B again under PyTorch's defaults,
   its losses against B's printed: whether the settings were needed); gated on the resume starting from the
   newest complete step (a ``.tmp-`` directory left by the kill, or one
   standing in for it, never counts), every resumed loss within rel 1e-5
   of B's at that step (the largest difference printed), the killed run's
   printed losses B's, and launches equal to batches moved in each
   finished child.  (b) 256 items at batch 32 through ``make_loader``
   and the staged pipeline, over a one-lane mesh on cuda:0 and through
   host delivery, each through the device ring and ``ingest_norm``: the
   f32 batches bit-equal, the sharded ring copying nothing (no
   ``batch_to_device`` span, 0 bytes) while the lane records a
   ``lane_h2d`` span a batch, items/s of both.  (c) a sharded loader
   stopped after 5 batches, its state (lane block included) loaded by a
   fresh one: batches 6-8 bit-equal to an unbroken run's.  (d) the full
   ResNet-18 AdamW state's checkpoint: bytes, the time
   ``save(blocking=False)`` blocks, the background write, the step right
   after a save against steps without one (figures, not gates).
6g. main_dp — data parallelism over a process group, one process a rank,
   each rank a child running the launcher (TF32 off): (a) two ranks on the
   one card over gloo (``--device cuda:0``; NCCL takes one rank a card),
   full-width ResNet-18 at global batch 64 (32 a rank), SGD,
   ``--device-ingest``, ``--delivery sharded``, one epoch of 16 steps from
   main's simulated S3 store, at ``--lr`` DP_LR with no warmup (the
   parameters move), against one process at the same seed, items and
   global batch: per-step losses within DP_TOL (relative; 16 steps amplify
   the card's rounding).  Before it, the first step alone (one batch, all
   three processes at once): loss, gradient norm and the update of the
   parameters and of BatchNorm's running statistics (the 2-norm of the
   difference over that of the one process's update) within
   DP_FIRST_TOL.  Both: every rank's parameters bit-equal (a checksum
   all-reduced as a min and a max), each rank's ``ingest_norm`` launches
   equal to the batches its lane moved; prints items/s of the 16-step
   runs, the gradient all-reduce's ms a step (gloo, through the host,
   timed alone by CUDA events), each rank's busy share and lane times and
   the lane skew across ranks (``chip_dp_faults.py`` shows these gates
   failing on planted faults).  (b) NCCL at world size
   1, 4 steps, after the same run with no process group in one process,
   deterministic algorithms on: bit-equal losses, one gradient all-reduce
   a step.
7. main_lm — the LM path: full-width granite-8b (depth cut to 4 layers)
   trained from simulated S3 through the launcher, then its forward loss
   through ``make_eval_step`` with ``attention_impl="pallas"`` (the flash
   kernel) over 4 loader batches against the plain attention's.
7b. main_roofline — the dry run's op counter (``launch/op_cost.py``) on
   the main paths, on fake CPU tensors counted for the card
   (``kernels.cost.for_card``: no allocation, no launch), against the
   times main and main_lm measured (nothing timed twice): (a) the
   ResNet-18 train step at batch 64 on the f32 batch ``isolated_step_ms``
   times, main's TF32 flags: FLOPs by compute class, bytes, achieved
   TFLOP/s, the roofline bound and its share of ``isolated_step_ms``,
   ``step_mfu`` (model FLOPs, 3 x the counted forward, over peak x step
   time) and ``step_hfu`` (counted FLOPs over class peak x step time); its
   ``ingest_norm`` epilogue counted apart (one launch, gated); (b)
   granite-8b-4l's train step at main_lm's shape: counted FLOPs over 6 N D
   (gated in [1.0, 2.5]), the live-bytes tracker's peak against
   ``max_memory_allocated()`` around one step on the card from a fresh
   state (gated in [0.75, 1.33]), ``step_mfu`` (6 N D) and ``step_hfu``
   from main_lm's median step after the first; (c) main_lm's flash eval
   over one batch counted: ``flash_attention`` once a layer at
   phase_flash's FLOPs (gated).  The card's peaks come from
   ``launch/roofline.py`` and each kernel's bound from its ``ops.cost``,
   as every phase's.
8. kernels/rwkv6_wkv and kernels/rmsnorm — each new kernel against its
   plain version at the reference tests' cases and the path's shape, with
   timings (rmsnorm with the library yardstick ``F.rms_norm``; rwkv6_wkv
   with its ptxas report and resident blocks an SM at every head dim).
9. model_rwkv — two AdamW steps of the rwkv6-7b smoke model on the card
   against the CPU (fp32, TF32 off).
10. main_rwkv — the RWKV path: full-width rwkv6-7b (depth cut to 4 layers)
   trained 8 steps over 16 sequences from simulated S3 through the
   launcher, then 4 loader batches
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
   simulated S3 through the launcher as main_lm (8 steps over 16
   sequences since main_resume joined the script), then served at full
   width with its depth cut from 62 to 16 (for the time budget) through
   ``launch/serve.py`` at the reference launcher's defaults, with main_serve's (a), (b), (c) and (e), and the absorbed
   MLA decode against the expanded one (``MLA_ABSORB_MAX_S = 0``) on the
   engine's pooled cache.
13. main_moe — granite-moe-3b-a800m at full width (32 cut to 4) trained
   the same way (8 steps over 16 sequences) (aux loss positive), gather against einsum dispatch on one
   full-width layer at the training shape (fp32, within 2e-5), then
   granite-moe-3b-a800m served at full width, its depth cut from 32 to 8
   (for the time budget), with (a) and (b), and
   qwen2-moe-a2.7b served whole (15.15 B parameters) with (a), its init
   and serving peaks against the card's memory, finite logits, and pooled
   against batch-1 decode printed, not gated (its decode capacity of 4
   drops assignments a batch-1 decode keeps, as the reference's does),
   beside the ticks where a live slot lost an assignment.  No kernel runs
   on the MLA or MoE paths (no Pallas route in the reference's MLA or
   MoE).
14. main_hybrid — jamba-v0.1-52b: (t) trained through the launcher at its
   smoke widths (full width does not train on one card), main_lm's loader,
   main_mla's 8 steps over 16 sequences, aux loss positive; (a) one full-width period (8 layers, 13.30
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
(for main_pipeline and main_autotune, around each launcher run; for main_cache, around
each launcher run and each training run of (b) and (c); for main_formats, around
its launcher run (a), each device stream of (b) and the training run of (c);
for main_resume, inside each child of (a) (the killed run's count dies with
it) and around each device stream of (b); for main_dp, inside each child;
for main_rwkv, before and
after its eval walk; for main_serve, around its launcher run, and flash's
again around (d); for main_mla, main_moe and main_hybrid, around each
launcher run, and for main_hybrid around its flash eval (k); for
main_encdec around its training steps, its launcher run and each flash
eval, (k) and (v); rmsnorm, which no model calls, counts its own phase's
checked calls; main_roofline launches no kernel: a fake launch moves no
count).  Each main
phase prints its wall time (``phase_wall``).
Then the ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.  Any
failed check or exception exits non-zero without the last line.  Imports
nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN_BS = 64
MAIN_BATCH = (MAIN_BS, 224, 224, 3)
MAIN_ARGS = [
    "--arch", "resnet18-imagenet", "--full", "--device", "cuda", "--device-ingest",
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
# with main_lm's loader settings, sequences and batch; 8 steps over 16
# sequences (4 batches an epoch, so the steps still cross an epoch
# boundary): its host-bound steps (3.4-5.5 s each) are the script's first
# cut when the whole run nears its time budget.
RWKV_ARCH, RWKV_LAYERS = "rwkv6-7b-4l", 4
RWKV_ITEMS, RWKV_STEPS = 16, 8
RWKV_ARGS = with_values([a if a != LM_ARCH else RWKV_ARCH for a in LM_ARGS],
                        items=RWKV_ITEMS, steps=RWKV_STEPS)
RWKV_REDUCED = {"num_layers": "32 -> 4 (AdamW state of 32 layers does not fit one card)",
                "items": "16 packed sequences of 4097 tokens", "steps": RWKV_STEPS}
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
# sequences, batch, microbatches and steps.  Serving: qwen2-moe-a2.7b whole,
# minicpm3-4b and granite-moe-3b-a800m at full width with their depth cut
# from 62 to 16 and from 32 to 8 to keep the script inside its time limit,
# through launch/serve.py at the reference launcher's defaults, held as
# main_serve's granite-8b.
MLA_ARCH, MOE_ARCH, QWEN_ARCH = "minicpm3-4b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b"
MLA_TRAIN_ARCH, MOE_TRAIN_ARCH, FAMILY_LAYERS = "minicpm3-4b-4l", "granite-moe-3b-a800m-4l", 4
# Their training runs 8 steps over 16 sequences (4 batches an epoch, so the
# steps still cross an epoch boundary), main_rwkv's cut, to keep the script
# inside its time budget since main_resume joined it.
FAMILY_ITEMS, FAMILY_STEPS = 16, 8
MLA_TRAIN_ARGS = with_values([a if a != LM_ARCH else MLA_TRAIN_ARCH for a in LM_ARGS],
                             items=FAMILY_ITEMS, steps=FAMILY_STEPS)
MOE_TRAIN_ARGS = with_values([a if a != LM_ARCH else MOE_TRAIN_ARCH for a in LM_ARGS],
                             items=FAMILY_ITEMS, steps=FAMILY_STEPS)
MLA_REDUCED = {"num_layers": "62 -> 4, as main_lm",
               "items": "16 packed sequences of 4097 tokens", "steps": FAMILY_STEPS}
MOE_REDUCED = {"num_layers": "32 -> 4, as main_lm",
               "items": "16 packed sequences of 4097 tokens", "steps": FAMILY_STEPS}
MLA_SERVE_ARCH, MLA_SERVE_LAYERS = "minicpm3-4b-16l", 16
MOE_SERVE_ARCH, MOE_SERVE_LAYERS = "granite-moe-3b-a800m-8l", 8
MLA_SERVE_ARGS = ["--arch", MLA_SERVE_ARCH, "--full", "--device", "cuda"]
MOE_SERVE_ARGS = ["--arch", MOE_SERVE_ARCH, "--full", "--device", "cuda"]
MLA_SERVE_REDUCED = {"num_layers": "62 -> 16, for the time budget"}
MOE_SERVE_REDUCED = {"num_layers": "32 -> 8, for the time budget"}
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
# Its smoke training (host-bound: 4-5 s a step) runs main_mla's 8 steps over
# 16 sequences, cut like theirs for the script's time budget.
HYBRID_TRAIN_ARGS = with_values(
    [HYBRID_ARCH if a == LM_ARCH else a for a in LM_ARGS if a != "--full"],
    items=FAMILY_ITEMS, steps=FAMILY_STEPS)
HYBRID_TRAIN_REDUCED = {
    "widths": "smoke config (d_model 64, 8 layers): full width does not train on one card "
              "(4 layers are 6.88 B parameters, 110 GB with AdamW state; ROADMAP 4.7)",
    "items": "16 packed sequences of 4097 tokens", "steps": FAMILY_STEPS}
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


def kernel_bounds(card, cost) -> dict:
    """A kernel's registered cost (its ``ops.cost``) on this card
    (``roofline.card_peaks``; None for a card the table does not know): the
    least time in ms and what bounds it, and the bytes and operations
    bounds apart."""
    from repro_torch.launch.roofline import bound_ms

    bound, by = bound_ms(cost.bytes, cost.flops, card, cost.compute_class)
    return {"bound_ms": bound, "bound_by": by, "bound_bytes": cost.bytes, "flops": cost.flops,
            "bytes_bound_ms": cost.bytes / card.hbm_bytes_per_s * 1e3 if card else None,
            "ops_bound_ms": (cost.flops / card.peak_flops[cost.compute_class] * 1e3
                             if card else None)}


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


def phase_kernels(torch, ops, ref, card) -> dict:
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
    bounds = kernel_bounds(card, ops.cost(MAIN_BATCH, torch.float32))  # u8 in, f32 out
    nbytes = bounds["bound_bytes"]
    main_err = next(c["max_abs_err"] for c in cases
                    if c["shape"] == list(MAIN_BATCH) and c["dtype"] == str(torch.float32))
    log = ops.build().log
    out = {"phase": "kernels", "cases": cases, "kernel": "ingest_norm",
           "shape": list(MAIN_BATCH), "out_dtype": "float32",
           "path": ops.path_for(MAIN_BATCH, torch.float32, img.data_ptr()),
           "max_abs_err": main_err,
           "kernel_ms": kernel_ms, "kernel_cold_ms": kernel_cold_ms, "plain_ms": plain_ms,
           "kernel_call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
           "bound_ms": bounds["bound_ms"], "bound_bytes": nbytes,
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


def phase_flash(torch, ops, ref, card) -> dict:
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
    D = FLASH_Q[3]
    # q k^T and p v over the causal triangle; q, o and k, v in bf16, once each
    bounds = kernel_bounds(card, ops.cost(FLASH_Q, FLASH_KV, torch.bfloat16))
    flops = bounds["flops"]
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
           **bounds, "peak_bf16_flops": card.peak_flops["bf16"] if card else None}
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
        "items_per_s_per_epoch": epoch_rates(report.tracer, 1024 // MAIN_BS),
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
    proc_run, proc_report = pipeline_run(torch, ops, PROC_ARGS, "pipeline_process")
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
        # the pipe transport's figures, which main_formats (a) is compared with
        "process_run": {
            "items_per_s": proc_run["items_per_s"],
            "items_per_s_per_epoch": epoch_rates(proc_report.tracer, MAIN_PER_EPOCH),
            "bytes_copied": proc_run["bytes_copied"],
            "samples": sum(st["transport"]["pipe_samples"] + st["transport"]["shm_samples"]
                           for st in proc_report.stages if st.get("transport")),
            "transport": transport_totals(proc_report.stages)},
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


# main_cache: the ResNet path behind the cache tiers (paper §2.4: S3 with a
# cache "as if the data were on local drives").  (a) the launcher at main's
# cell with --cache-mb CACHE_MB (a memory tier that holds the whole 118 MB
# set), then with --store memory, the local-drive yardstick.
CACHE_MB = 256
CACHE_ARGS = MAIN_ARGS + ["--cache-mb", str(CACHE_MB)]
LOCAL_ARGS = MAIN_ARGS + ["--store", "memory"]
MAIN_PER_EPOCH = 1024 // MAIN_BS
# (b) the two-tier stack (32 MiB memory over a 256 MiB journal-coordinated
# disk tier under build/) through make_loader and the staged pipeline, with
# the cache knobs on the epoch-cadence controller, then a restart over the
# same directory; (c) an elastic fleet of the card member and one spawned
# CPU member.  Both at 512 items of 115 KB, 224x224 crops, batch 32.
TIER_ITEMS, TIER_BS, TIER_EPOCHS = 512, 32, 3
TIER_MEM, TIER_DISK = 32 << 20, 256 << 20
TIER_MAX_MEM, TIER_MAX_DISK = 128 << 20, 512 << 20
ELASTIC_JOIN_AFTER = 4  # the CPU member is started after this many card batches
ELASTIC_PEER_WAIT_S = 20.0  # how long the card member waits for the peer to join
ELASTIC_PEER_LIMIT_S = 180.0  # the CPU member's own time limit
CACHE_TRACE = ROOT / "build" / "chip_smoke_cache_trace.json"
TIER_SPANS = ("get_batch", "batch_to_device", "run_training_batch", "stage_fetch",
              "stage_decode", "stage_augment", "stage_collate")


class EpochCacheWatch:
    """For the launcher runs inside it, records at every epoch's end the
    memory tier's and the simulated S3 store's counters of the run's store
    stack (read from the loader the launcher's ``EpochStages`` callback
    holds), so per-epoch deltas can be taken after the run."""

    def __enter__(self) -> "EpochCacheWatch":
        from repro_torch.launch import train as launch

        self.cls, self.end = launch.EpochStages, launch.EpochStages.on_epoch_end
        self.rows: list = []
        watch = self

        def on_epoch_end(cb, trainer, epoch):
            watch.rows.append(store_counters(cb.loader.dataset.store))
            return watch.end(cb, trainer, epoch)

        launch.EpochStages.on_epoch_end = on_epoch_end
        return self

    def __exit__(self, *exc) -> None:
        self.cls.on_epoch_end = self.end


def store_counters(store) -> dict:
    """Cumulative counters of a store stack: each cache tier's hits,
    misses, bytes used and capacity, and the simulated S3 store's GETs."""
    out = {}
    walk = store
    while walk is not None:
        if hasattr(walk, "cache_stats"):
            for tier, st in walk.cache_stats().items():
                cap = getattr(walk, tier).capacity
                out[tier] = {"hits": st.hits, "misses": st.misses,
                             "bytes_used": st.bytes_used, "capacity": cap,
                             "admitted": st.admitted, "evictions": st.evictions}
        if hasattr(walk, "stats"):
            out["s3_gets"] = walk.stats.gets
        walk = getattr(walk, "base", None)
    return out


def per_epoch(rows: list) -> list:
    """Per-epoch deltas of :func:`store_counters` rows (cumulative), with
    each tier's hit rate and the combined hit rate (lookups not sent to the
    origin, over lookups at the outer tier)."""
    out, prev = [], {}
    for row in rows:
        e = {"s3_gets": row.get("s3_gets", 0) - prev.get("s3_gets", 0)}
        for tier in ("memory", "disk"):
            if tier in row:
                d = {k: row[tier][k] - prev.get(tier, {}).get(k, 0)
                     for k in ("hits", "misses", "admitted", "evictions")}
                n = d["hits"] + d["misses"]
                e[tier] = {**d, "hit_rate": d["hits"] / n if n else None,
                           "bytes_used": row[tier]["bytes_used"],
                           "capacity": row[tier]["capacity"]}
        outer = e.get("memory") or e.get("disk")
        inner = e.get("disk") or e.get("memory")
        n = outer["hits"] + outer["misses"] if outer else 0
        e["combined_hit_rate"] = (n - inner["misses"]) / n if n else None
        out.append(e)
        prev = row
    return out


def cache_launcher_run(torch, ops, args: list, label: str) -> dict:
    """One launcher run of the ResNet path, its launches counted from 0
    and its store counted at each epoch's end; gated on finite losses and
    launches equal to batches transferred."""
    from repro_torch.launch import train as launch

    ops.ingest_norm.launches = 0
    with EpochCacheWatch() as watch:
        report = launch.run(args)
    launches = ops.ingest_norm.launches
    losses = [h["loss"] for h in report.result.history]
    out = {"label": label, "args": args, "steps": report.result.steps,
           "epochs": report.result.epochs, "wall_s": report.result.wall_s,
           "items_per_s": report.items_per_s,
           "items_per_s_per_epoch": epoch_rates(report.tracer, MAIN_PER_EPOCH),
           "util_zero_pct": report.util.util_zero_pct,
           "util_pos_avg": report.util.util_pos_avg,
           "busy_fraction": report.util.busy_fraction,
           "batches_transferred": report.batches_transferred,
           "ingest_norm_launches": launches, "spans": span_stats(report.tracer),
           "store_per_epoch": per_epoch(watch.rows),
           "first_loss": losses[0] if losses else None,
           "last_loss": losses[-1] if losses else None}
    emit({"phase": "main_cache_run", **out})
    if report.result.steps < 48 or report.result.epochs < 3:
        fail(f"{label}: ran {report.result.steps} steps over {report.result.epochs} epochs")
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss: {losses}")
    if launches == 0 or launches != report.batches_transferred:
        fail(f"{label}: ingest_norm launched {launches} times for "
             f"{report.batches_transferred} batches transferred")
    return out


def entry_file_bytes(d: str) -> int:
    """Bytes of a disk tier's finished entry files (no coordination files,
    no writer's tmp file)."""
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if not f.startswith(".") and ".tmp" not in f)


def tier_dataset(store):
    from repro_torch.data.dataset import ImageDataset

    return ImageDataset(store, TIER_ITEMS, out_size=224, sim_decode_s_per_mb=0.052,
                        epilogue="device")


def tier_loader(store, tracer, autotune: bool):
    """make_loader over ``store``: the staged pipeline with 2 staging
    buffers at the reference's widths; with ``autotune``, the loader's knobs
    and the cache knobs (32 -> at most 128 MiB of memory; the journal-shared
    disk tier's capacity is the fleet's, not a knob) on a controller fed
    once per epoch."""
    from repro_torch.config import AutotuneConfig, LoaderConfig, PipelineConfig
    from repro_torch.core import make_loader

    at = AutotuneConfig(enabled=True, tune_cache=True, cache_cadence="epoch",
                        cache_epoch_windows=1, max_memory_cache_bytes=TIER_MAX_MEM,
                        max_disk_cache_bytes=TIER_MAX_DISK) if autotune else AutotuneConfig()
    return make_loader(LoaderConfig(
        impl="threaded", batch_size=TIER_BS, num_workers=4, num_fetch_workers=16, seed=0,
        pipeline=PipelineConfig(enabled=True, staging_buffers=2), autotune=at),
        tier_dataset(store), tracer=tracer)


def tier_train(torch, loader, tracer, epochs: int, callbacks=(), device="cuda"):
    """Trains full-width ResNet-18 (SGD) over ``loader`` for ``epochs``
    through the Trainer, ``ingest_norm`` after each copy to the card;
    returns the Trainer's result."""
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.kernels.ingest_norm.ops import make_ingest_fn
    from repro_torch.train.steps import init_resnet_train_state, make_resnet_train_step
    from repro_torch.train.trainer import Trainer

    cfg, tcfg = get_arch("resnet18-imagenet"), TrainConfig(optimizer="sgd")
    state = init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(0), device)
    trainer = Trainer(make_resnet_train_step(cfg, tcfg), state, callbacks=list(callbacks),
                      tracer=tracer, ingest_fn=make_ingest_fn(), device=device)
    return trainer.fit(loader, epochs=epochs)


def two_tier_check(torch, ops, smi: str) -> dict:
    """(b) The two-tier stack through make_loader: its device stream held to
    the uncached fixed-knob loader's, the cache tuning events to their
    knobs' bounds, the tiers to their capacities and the journal to the
    disk at each epoch's end, and epochs 2-3 to a combined hit rate of at
    least 0.99; then a restart over the same directory for one epoch."""
    import shutil

    from repro_torch.config import CacheConfig, StoreConfig
    from repro_torch.core.tracing import Tracer
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet
    from repro_torch.data.store import build_store
    from repro_torch.train.trainer import Callback

    base = build_synthetic_imagenet(num_items=TIER_ITEMS, avg_kb=115.0)
    cache_dir = ROOT / "build" / "chip_smoke_cache_tier"
    shutil.rmtree(cache_dir, ignore_errors=True)
    scfg = StoreConfig(kind="s3sim", latency_mean_s=0.02, cache=CacheConfig(
        memory_bytes=TIER_MEM, dir=str(cache_dir), disk_bytes=TIER_DISK, coord="journal"))

    class EpochEnd(Callback):
        """At each epoch's end: the store's counters and the tiers against
        their capacities and the journal against the files."""

        def __init__(self, store) -> None:
            self.store, self.rows, self.checks = store, [], []

        def on_epoch_end(self, trainer, epoch) -> None:
            mem, disk = self.store.memory, self.store.disk
            self.rows.append(store_counters(self.store))
            self.checks.append({
                "epoch": epoch, "memory_used": mem.used_bytes, "memory_capacity": mem.capacity,
                "disk_used": disk.used_bytes, "disk_capacity": disk.capacity,
                "journal_bytes": disk.journal.used_bytes(),
                "entry_file_bytes": entry_file_bytes(str(cache_dir)),
                "journal_entries": disk.journal.entry_count()})

    # the uncached, fixed-knob loader: the stream to hold the others to
    ops.ingest_norm.launches = 0
    with DeviceDigest() as digest:
        fixed = tier_train(torch, tier_loader(build_store(StoreConfig(
            kind="s3sim", latency_mean_s=0.02), base=base), Tracer(), False), Tracer(),
            TIER_EPOCHS)
    want = digest.digests(torch)
    fixed_launches = ops.ingest_norm.launches

    tracer = Tracer()
    store = build_store(scfg, base=base, tracer=tracer)
    loader = tier_loader(store, tracer, True)
    watch = EpochEnd(store)
    ops.ingest_norm.launches = 0
    with DeviceDigest() as digest:
        result = tier_train(torch, loader, tracer, TIER_EPOCHS, [watch])
    got = digest.digests(torch)
    launches = ops.ingest_norm.launches
    tracer.dump(str(CACHE_TRACE))
    epochs = per_epoch(watch.rows)
    cache_ctrl = loader.cache_autotuner
    cache_events = [[e.batch, e.action, e.knob, e.value, e.tput] for e in cache_ctrl.events]
    cache_bounds = {k.name: (k.lo, k.hi) for k in cache_ctrl.knobs}
    main_events = [[e.batch, e.action, e.knob, e.value] for e in loader.autotuner.events]
    main_bounds = {k.name: (k.lo, k.hi) for k in loader.autotuner.knobs}
    tiers = [str(s.args.get("tier")) for s in tracer.spans("cache_get")]
    lanes = {name: len(tracer.spans(name)) for name in TIER_SPANS}
    lanes["cache_get"] = {t: tiers.count(t) for t in sorted(set(tiers))}

    # restart: a fresh store over the same directory, a fresh loader
    restart_store = build_store(scfg, base=base)
    restart_rows = [store_counters(restart_store)]
    ops.ingest_norm.launches = 0
    with DeviceDigest() as digest:
        tier_train(torch, tier_loader(restart_store, Tracer(), False), Tracer(), 1)
    restart = digest.digests(torch)
    restart_launches = ops.ingest_norm.launches
    restart_rows.append(store_counters(restart_store))
    shutil.rmtree(cache_dir, ignore_errors=True)
    restart_epoch = per_epoch(restart_rows)[1]
    per = TIER_ITEMS // TIER_BS
    out = {"phase": "main_cache_tiers", "nvidia_smi": smi, "items": TIER_ITEMS,
           "batch": TIER_BS, "epochs": TIER_EPOCHS, "steps": result.steps,
           "store": {"memory_bytes": TIER_MEM, "disk_bytes": TIER_DISK, "coord": "journal",
                     "max_memory_cache_bytes": TIER_MAX_MEM,
                     "max_disk_cache_bytes": TIER_MAX_DISK},
           "per_epoch": epochs, "epoch_end_checks": watch.checks,
           "cache_knob_bounds": cache_bounds, "cache_events": cache_events,
           "loader_events_by_action": {a: sum(e[1] == a for e in main_events)
                                       for a in sorted({e[1] for e in main_events})},
           "batches_digested": len(got),
           "batches_differing_from_uncached": sum(a != b for a, b in zip(got, want))
           + abs(len(got) - len(want)),
           "ingest_norm_launches": {"uncached": fixed_launches, "tiered": launches,
                                    "restart": restart_launches},
           "batches_transferred": {"uncached": len(want), "tiered": len(got),
                                   "restart": len(restart)},
           "restart": {**restart_epoch,
                       "batches_differing_from_epoch_1": sum(
                           a != b for a, b in zip(restart, got[:per]))
                       + abs(len(restart) - per)},
           "trace": str(CACHE_TRACE.relative_to(ROOT)), "span_counts": lanes}
    emit(out)
    if len(want) != TIER_EPOCHS * per or out["batches_differing_from_uncached"]:
        fail(f"two-tier stream: {out['batches_differing_from_uncached']} of {len(got)} "
             f"batches differ from the uncached loader's ({len(want)})")
    for label, n, m in (("uncached", fixed_launches, len(want)), ("tiered", launches, len(got)),
                        ("restart", restart_launches, len(restart))):
        if n == 0 or n != m:
            fail(f"two-tier {label}: ingest_norm launched {n} times for {m} batches moved")
    outside = [e for e in cache_events if e[2] != "-" and not (
        e[2] in cache_bounds and cache_bounds[e[2]][0] <= e[3] <= cache_bounds[e[2]][1])]
    outside += [e for e in main_events if e[2] != "-" and not (
        e[2] in main_bounds and main_bounds[e[2]][0] <= e[3] <= main_bounds[e[2]][1])]
    if outside:
        fail(f"two-tier: tuning events outside their knob's bounds: {outside}")
    if "cache_mem_bytes" not in cache_bounds or "cache_disk_bytes" in cache_bounds:
        fail(f"two-tier: cache knobs {cache_bounds}")
    for c in watch.checks:
        if (c["memory_used"] > c["memory_capacity"] or c["disk_used"] > c["disk_capacity"]
                or c["journal_bytes"] != c["entry_file_bytes"]
                or c["journal_bytes"] != c["disk_used"]):
            fail(f"two-tier: tiers over capacity or journal off the disk: {c}")
    if len(epochs) != TIER_EPOCHS or any(
            e["combined_hit_rate"] is None or e["combined_hit_rate"] < 0.99
            for e in epochs[1:]):
        fail(f"two-tier: epochs 2-3 combined hit rates "
             f"{[e['combined_hit_rate'] for e in epochs]}")
    rs = restart_epoch
    if (rs["disk"]["hit_rate"] is None or rs["disk"]["hit_rate"] < 0.99
            or rs["s3_gets"] > TIER_ITEMS // 100
            or out["restart"]["batches_differing_from_epoch_1"]):
        fail(f"restart over the disk tier: {out['restart']}")
    return out


def elastic_peer(src: str, coord_dir: str, flag: str, out_path: str, items: int) -> None:
    """The fleet's CPU member (a spawned process): waits for ``flag``, joins
    the elastic fleet under ``coord_dir`` with the card member's loader
    settings, drains its claims of the epoch without training, leaves, and
    writes what it delivered and whether ``torch`` was ever imported."""
    import os

    sys.path.insert(0, src)
    deadline = time.monotonic() + ELASTIC_PEER_LIMIT_S
    while not os.path.exists(flag) and time.monotonic() < deadline:
        time.sleep(0.01)
    loader = elastic_loader(coord_dir, items, host=1)
    batches = sum(1 for _ in loader)
    loader.release_coordination()
    with open(out_path, "w") as f:
        json.dump({"delivered": loader.sampler.delivered_log, "batches": batches,
                   "member": loader._elastic.member,
                   "torch_loaded": "torch" in sys.modules}, f)


def elastic_loader(coord_dir: str, items: int, host: int):
    """A legacy elastic loader over 115 KB images behind simulated S3, 2
    workers a batch outstanding each, so claims advance a shard (2 batches)
    at a time and a member joining mid-epoch finds shards left."""
    from repro_torch.config import ElasticConfig, LoaderConfig, StoreConfig
    from repro_torch.core.loader import ConcurrentDataLoader
    from repro_torch.data.dataset import ImageDataset
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet
    from repro_torch.data.store import build_store

    store = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02),
                        base=build_synthetic_imagenet(num_items=items, avg_kb=115.0))
    data = ImageDataset(store, items, out_size=224, sim_decode_s_per_mb=0.052,
                        epilogue="device")
    cfg = LoaderConfig(impl="threaded", batch_size=TIER_BS, num_workers=2, prefetch_factor=1,
                       num_fetch_workers=16, seed=0, elastic=ElasticConfig(
                           enabled=True, coord_dir=coord_dir, lease_ttl_s=30.0,
                           heartbeat_interval_s=0.2, shard_batches=2, claim_poll_s=0.01))
    return ConcurrentDataLoader(data, cfg, host_id=host, num_hosts=1)


def host_digest(items: list) -> tuple:
    """DeviceDigest's row for a batch, computed on the host from the items
    (u8 HWC images and labels) the batch was claimed for."""
    import numpy as np

    labels = [int(it["label"]) for it in items]
    flat = [np.ascontiguousarray(it["image"]).reshape(-1).astype(np.int64) for it in items]
    w = np.arange(flat[0].size, dtype=np.int64) % 251 + 1
    return tuple(labels + [int(f.sum()) for f in flat] + [int((f * w).sum()) for f in flat])


def elastic_check(torch, ops, smi: str) -> dict:
    """(c) The card member trains from an elastic legacy loader; a spawned
    CPU member (no torch) joins after the card's 4th batch.  Gated on the
    two members' claims covering the epoch exactly once, every batch moved
    to the card matching the u8 bytes of the items it claimed, and the
    membership board empty once both left."""
    import multiprocessing
    import shutil

    from repro_torch.core.coord import MembershipBoard
    from repro_torch.core.sampler import epoch_permutation
    from repro_torch.core.tracing import Tracer
    from repro_torch.data.dataset import ImageDataset
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet
    from repro_torch.train.trainer import Callback

    coord_dir = ROOT / "build" / "chip_smoke_elastic"
    shutil.rmtree(coord_dir, ignore_errors=True)
    coord_dir.mkdir(parents=True)
    flag, peer_out = coord_dir / "peer.go", coord_dir.parent / "chip_smoke_elastic_peer.json"
    peer_out.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    peer = ctx.Process(target=elastic_peer, args=(str(SRC), str(coord_dir), str(flag),
                                                  str(peer_out), TIER_ITEMS))
    peer.start()
    board = MembershipBoard(str(coord_dir), member="chip_smoke-observer")

    class JoinAfter(Callback):
        """After the card's ELASTIC_JOIN_AFTER-th batch, lets the peer in
        and waits (a bounded time) until it is a live member; later batches
        take a little longer, as a busier trainer's would."""

        def __init__(self) -> None:
            self.joined_at = None

        def on_train_batch_end(self, trainer, metrics, idx) -> None:
            if idx + 1 == ELASTIC_JOIN_AFTER:
                flag.touch()
                t0, deadline = time.monotonic(), time.monotonic() + ELASTIC_PEER_WAIT_S
                while len(board.live()) < 2 and time.monotonic() < deadline:
                    time.sleep(0.01)
                self.joined_at = time.monotonic() - t0
            elif idx + 1 > ELASTIC_JOIN_AFTER:
                time.sleep(0.1)

    loader = elastic_loader(str(coord_dir), TIER_ITEMS, host=0)
    join = JoinAfter()
    ops.ingest_norm.launches = 0
    try:
        with DeviceDigest() as digest:
            result = tier_train(torch, loader, Tracer(), 1, [join])
        rows = digest.digests(torch)
    finally:
        flag.touch()  # a peer still waiting goes ahead (and finds the epoch done)
        peer.join(timeout=ELASTIC_PEER_LIMIT_S)
        if peer.is_alive():
            peer.kill()
            peer.join(timeout=10)
    launches = ops.ingest_norm.launches
    card = [tuple(x) for x in loader.sampler.delivered_log]
    peer_rep = json.loads(peer_out.read_text()) if peer_out.exists() else {}
    peer_batches = [tuple(x) for x in peer_rep.get("delivered", [])]
    # what the card should have received: each claimed batch's items, read
    # past simulated S3 from the same synthetic set
    nb = TIER_ITEMS // TIER_BS
    perm = epoch_permutation(TIER_ITEMS, 0, 0, True)
    data = ImageDataset(build_synthetic_imagenet(num_items=TIER_ITEMS, avg_kb=115.0),
                        TIER_ITEMS, out_size=224, epilogue="device")
    data.set_epoch(0)
    expected = [host_digest([data[int(i)] for i in perm[gb * TIER_BS:(gb + 1) * TIER_BS]])
                for _, gb in card]
    mismatched = sum(a != b for a, b in zip(rows, expected)) + abs(len(rows) - len(expected))
    claimed = sorted(gb for _, gb in card + peer_batches)
    live_after = board.live()
    out = {"phase": "main_cache_elastic", "nvidia_smi": smi, "items": TIER_ITEMS,
           "batch": TIER_BS, "batches_in_epoch": nb, "card_steps": result.steps,
           "card_batches": [gb for _, gb in card], "peer_batches": [gb for _, gb in peer_batches],
           "peer_member": peer_rep.get("member"), "peer_exitcode": peer.exitcode,
           "peer_torch_loaded": peer_rep.get("torch_loaded"),
           "peer_join_wait_s": join.joined_at, "ingest_norm_launches": launches,
           "batches_moved_to_card": len(rows), "card_batches_mismatched": mismatched,
           "live_members_after": sorted(live_after)}
    emit(out)
    if peer.exitcode != 0 or peer_rep.get("torch_loaded") is not False:
        fail(f"elastic: the CPU member exited {peer.exitcode}, torch loaded: "
             f"{peer_rep.get('torch_loaded')}")
    if claimed != list(range(nb)) or {e for e, _ in card + peer_batches} != {0}:
        fail(f"elastic: the members' claims {claimed} do not cover the epoch's {nb} "
             "batches exactly once")
    if not card or mismatched:
        fail(f"elastic: {mismatched} of {len(rows)} card batches differ from their claimed "
             "items")
    if launches == 0 or launches != len(rows):
        fail(f"elastic: ingest_norm launched {launches} times for {len(rows)} batches moved")
    if live_after:
        fail(f"elastic: members still live after both left: {live_after}")
    return out


def phase_main_cache(torch, ops, legacy: dict, smi: str) -> dict:
    """(a) the launcher with --cache-mb beside --store memory and main's
    uncached run; (b) the two-tier stack and its restart; (c) an elastic
    member on the card with a spawned CPU member."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cached = cache_launcher_run(torch, ops, CACHE_ARGS, "cache_mb")
    local = cache_launcher_run(torch, ops, LOCAL_ARGS, "store_memory")
    epochs = cached["store_per_epoch"]
    out = {"phase": "main_cache_launcher", "nvidia_smi": smi, "cache_mb": CACHE_MB,
           "items_per_s_per_epoch": {"uncached_main": legacy.get("items_per_s_per_epoch"),
                                     "cache_mb": cached["items_per_s_per_epoch"],
                                     "store_memory": local["items_per_s_per_epoch"]},
           "table3": {label: {k: r[k] for k in ("util_zero_pct", "util_pos_avg",
                                                 "busy_fraction", "items_per_s")}
                      for label, r in (("uncached_main", legacy), ("cache_mb", cached),
                                       ("store_memory", local))},
           "memory_tier_per_epoch": [e.get("memory") for e in epochs],
           "s3_gets_per_epoch": [e["s3_gets"] for e in epochs],
           "launches": {"cache_mb": cached["ingest_norm_launches"],
                        "store_memory": local["ingest_norm_launches"]},
           "batches_transferred": {"cache_mb": cached["batches_transferred"],
                                   "store_memory": local["batches_transferred"]}}
    emit(out)
    emit({"phase": "main_cache", "check": "phase_wall", "part": "a",
          "wall_s": time.perf_counter() - t0})
    if len(epochs) < 3 or any(e["s3_gets"] or not e.get("memory")
                              or e["memory"]["hit_rate"] != 1.0 for e in epochs[1:3]):
        fail(f"--cache-mb {CACHE_MB}: epochs 2-3 made s3sim GETs or missed the memory tier: "
             f"{epochs}")
    t0 = time.perf_counter()
    out["tiers"] = two_tier_check(torch, ops, smi)
    emit({"phase": "main_cache", "check": "phase_wall", "part": "b",
          "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    out["elastic"] = elastic_check(torch, ops, smi)
    emit({"phase": "main_cache", "check": "phase_wall", "part": "c",
          "wall_s": time.perf_counter() - t0})
    out["launches_total"] = (out["launches"]["cache_mb"] + out["launches"]["store_memory"]
                             + sum(out["tiers"]["ingest_norm_launches"].values())
                             + out["elastic"]["ingest_norm_launches"])
    return out


# main_formats: the loader's data plane on the ResNet path and its serving
# mirror.  (a) main's process-executor cell (PROC_ARGS) with the shared-memory
# transport, through the launcher: 1 MiB slots, as many a worker slab as fit
# in half of /dev/shm's free bytes, at most PipelineConfig's 32 and at least
# 8.  (b) the same transport through make_loader at full image size, 128
# items at batch 32 over 2 workers: its device stream against the pipe's and
# the thread executor's, then with every worker crashed mid slab write, then
# with the slab cap set to 8 mid-epoch.  (c) 2048 items converted to a
# columnar store (label-clustered, a chunk a row) behind s3sim, trained 3
# epochs under the reference benchmark's 25 %-selectivity predicate
# (benchmarks/bench_columnar.py:59), beside one unfiltered epoch drained on
# the host.  (d) main's 1024 items as 16 tar shards of 64 behind s3sim, 2
# epochs of one step a batch.  (e) benchmarks/bench_serve.py's trace at its
# quick sizes, both of its cells, over a memory tier and a disk tier under
# build/ in front of s3sim.
FORMATS_SLOT_BYTES = 1 << 20
FORMATS_MAX_SLOTS, FORMATS_MIN_SLOTS = 32, 8
SHM_ARGS = PROC_ARGS + ["--transport", "shm"]
SHM_LAUNCHER_WORKERS = 4  # PipelineConfig's cpu_workers 0 derives 4
SHM_ITEMS, SHM_BS, SHM_WORKERS, SHM_CAP, SHM_CAP_AFTER = 128, 32, 2, 8, 1
COL_ITEMS, COL_EPOCHS = 2048, 3
COL_PREDICATE = (("label", "<", 250),)
COL_BYTES_RATIO = 0.5  # bench_columnar's own claim (benchmarks/bench_columnar.py:221-224)
SHARD_ITEMS, SHARD_PER, SHARD_EPOCHS = 1024, 64, 2
FORMATS_DIR = ROOT / "build" / "chip_smoke_formats"
# bench_serve's quick scale (the full one replays 10 s a cell over 512
# items; the phase's budget takes the quick one)
READ = {"items": 256, "duration_s": 6.0, "base_rate": 50.0, "bursts": 3,
        "burst_size": 64, "zipf_alpha": 1.1, "mem_bytes": 1536 * 1024,
        "disk_bytes": 4 * 1024 * 1024, "scrape_rate": 384 * 1024.0,
        "scrape_burst": 192 * 1024, "latency_mean_s": 0.02, "latency_sigma": 0.5,
        "bandwidth_per_conn": 50e6, "nic_bandwidth": 1.2e9, "max_connections": 256}
READ_MAX_OBJ, READ_CLIENTS, READ_SCRAPERS = 48 * 1024, 64, 2
READ_REDUCED = {"items": "512 -> 256", "duration_s": "10 -> 6", "bursts": "5 -> 3"}


def dev_shm_slots(workers: int) -> dict:
    """1 MiB slots a worker slab: as many as let ``workers`` slabs fill at
    most half of /dev/shm's free bytes, capped at PipelineConfig's 32; a
    write past a short /dev/shm is a SIGBUS in the worker, so fewer than 8
    fails the phase."""
    import os

    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    slots = min(FORMATS_MAX_SLOTS, free // 2 // (workers * FORMATS_SLOT_BYTES))
    out = {"dev_shm_free_bytes": free, "workers": workers,
           "slot_bytes": FORMATS_SLOT_BYTES, "slab_slots": slots,
           "slab_bytes_all_workers": slots * workers * FORMATS_SLOT_BYTES}
    emit({"phase": "main_formats", "check": "dev_shm", **out})
    if slots < FORMATS_MIN_SLOTS:
        fail(f"/dev/shm holds {free} free bytes: fewer than {FORMATS_MIN_SLOTS} slots of "
             f"{FORMATS_SLOT_BYTES} bytes a worker fit in half of it for {workers} workers")
    return out


class SlabSlots:
    """For the launcher runs inside it, gives the loader config the launcher
    builds ``slots`` slots a worker slab (the launcher has no flag for it, as
    the reference's has none)."""

    def __init__(self, slots: int) -> None:
        self.slots = slots

    def __enter__(self) -> "SlabSlots":
        from dataclasses import replace

        from repro_torch.launch import train as launch

        self.mod, self.make = launch, launch.make_loader
        make, slots = self.make, self.slots

        def sized(cfg, dataset, **kw):
            return make(replace(cfg, pipeline=replace(cfg.pipeline, slab_slots=slots)),
                        dataset, **kw)

        launch.make_loader = sized
        return self

    def __exit__(self, *exc) -> None:
        self.mod.make_loader = self.make


def maps_torch(pid: int) -> bool:
    """Whether process ``pid`` has torch's shared library mapped (an
    ``import torch`` loads it)."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)


def segments_left(names: list) -> list:
    """Those of ``names`` (shared-memory segments) still under /dev/shm."""
    import os

    return [n for n in names if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]


def transport_totals(stages: list) -> dict:
    """Each epoch's ``stage_stats()["transport"]`` summed over the run."""
    rows = [st["transport"] for st in stages if st.get("transport")]
    fallbacks: dict = {}
    for r in rows:
        for why, n in r["fallbacks"].items():
            fallbacks[why] = fallbacks.get(why, 0) + n
    shm = sum(r["shm_samples"] for r in rows)
    pipe = sum(r["pipe_samples"] for r in rows)
    return {"kind": rows[-1]["kind"] if rows else None, "shm_samples": shm,
            "pipe_samples": pipe, "fallbacks": fallbacks,
            "fallback_rate": sum(fallbacks.values()) / (shm + pipe) if shm + pipe else 0.0,
            "transport_bytes_copied": sum(r["bytes_copied"] for r in rows),
            "slab_slots": rows[-1].get("slab_slots") if rows else None,
            "slots_peak_per_worker": max((r.get("slots_peak_per_worker", 0) for r in rows),
                                         default=0)}


class PoolWatch:
    """For the runs inside it, records at each process pool's ``close`` (the
    launcher closes its loader after the run) the live workers' pids,
    whether each has torch mapped, and the names of every slab the pool
    made, retired ones included."""

    def __enter__(self) -> "PoolWatch":
        from repro_torch.core.pipeline import _CPUProcessPool

        self.cls, self.close = _CPUProcessPool, _CPUProcessPool.close
        self.pids, self.torch_mapped, self.names = [], [], []
        watch = self

        def close(pool):
            pids = [w.proc.pid for w in pool.workers]
            watch.pids += pids
            watch.torch_mapped += [maps_torch(pid) for pid in pids]
            watch.names += [sl.name for sl in pool._slabs]
            return watch.close(pool)

        _CPUProcessPool.close = close
        return self

    def __exit__(self, *exc) -> None:
        self.cls.close = self.close


def shm_launcher_check(torch, ops, pipe_proc: dict, slots: int, smi: str) -> dict:
    """(a) main's process-executor cell with ``--transport shm`` through the
    launcher, every gate of main_pipeline (a) held too."""
    with SlabSlots(slots), PoolWatch() as watch:
        run, report = pipeline_run(torch, ops, SHM_ARGS, "pipeline_shm")
    pids, torch_mapped, names = watch.pids, watch.torch_mapped, watch.names
    left = segments_left(names)
    tr = transport_totals(report.stages)
    samples = tr["shm_samples"] + tr["pipe_samples"]
    per_sample = run["bytes_copied"] / samples if samples else None
    pipe_per_sample = (pipe_proc["bytes_copied"] / pipe_proc["samples"]
                       if pipe_proc["samples"] else None)
    out = {"phase": "main_formats", "check": "a_shm_launcher", "nvidia_smi": smi,
           "args": SHM_ARGS, "slab_slots": slots,
           "items_per_s_per_epoch": {"pipe_process": pipe_proc["items_per_s_per_epoch"],
                                     "shm_process": epoch_rates(report.tracer,
                                                                MAIN_PER_EPOCH)},
           "items_per_s": {"pipe_process": pipe_proc["items_per_s"],
                           "shm_process": run["items_per_s"]},
           "transport": tr, "transport_per_epoch": [st.get("transport") for st in report.stages],
           "bytes_copied_per_sample": {"pipe_process": pipe_per_sample,
                                       "shm_process": per_sample},
           "ingest_norm_launches": run["ingest_norm_launches"],
           "batches_transferred": run["batches_transferred"],
           "busy_fraction": run["busy_fraction"],
           "worker_pids": pids, "workers_with_torch_mapped": sum(torch_mapped),
           "slab_segments": len(names), "segments_left_after_close": left}
    emit(out)
    if tr["kind"] != "shm" or tr["shm_samples"] <= 0:
        fail(f"(a) the shm transport moved no sample: {tr}")
    if tr["fallbacks"].get("oversize", 0) or tr["fallbacks"].get("ragged", 0):
        fail(f"(a) oversize or ragged fallbacks for 150,528-byte samples: {tr['fallbacks']}")
    if per_sample is None or pipe_per_sample is None or per_sample >= pipe_per_sample:
        fail(f"(a) bytes copied a sample {per_sample} not under the pipe run's "
             f"{pipe_per_sample}")
    if not pids or any(torch_mapped):
        fail(f"(a) CPU workers {pids} with torch mapped: {torch_mapped}")
    if left:
        fail(f"(a) segments left under /dev/shm after close: {left}")
    return out


class Capping:
    """Iterates ``loader`` and sets its slab cap (the slab knob's setter) to
    ``cap`` after batch ``after``, on the consumer's thread between batches,
    as the autotuner does."""

    def __init__(self, loader, after: int, cap: int) -> None:
        self.loader, self.after, self.cap, self.applied = loader, after, cap, None

    def __iter__(self):
        it = iter(self.loader)
        for i, batch in enumerate(it):
            yield batch
            if i == self.after:
                self.applied = it._set_slab_slots(self.cap)


def arm_every_worker(it) -> int:
    """Arms the mid-slab-write crash in every worker of the iterator's pool
    as soon as the pump has spawned them, so each dies on its first task
    sent after the message; returns the workers armed."""
    pool = it.cpu.pool
    deadline = time.monotonic() + 60
    while len(pool.workers) < it.cpu.width:
        if time.monotonic() > deadline:
            fail(f"(b) the pool spawned {len(pool.workers)} of {it.cpu.width} workers")
        time.sleep(0.001)
    for i in range(len(pool.workers)):
        pool.inject_crash(mode="mid_slab_write", worker=i)
    return len(pool.workers)


def shm_stream_check(torch, ops, slots: int, smi: str) -> dict:
    """(b) The device stream of the shm transport at full image size against
    the pipe's and the thread executor's (main_autotune's digest, taken on
    the card before ingest_norm), then with every worker crashed mid slab
    write, then with the slab cap set mid-epoch; each sample says whether
    torch was loaded where it was augmented, and no loader leaves a segment
    behind."""
    from repro_torch.config import LoaderConfig, PipelineConfig, StoreConfig
    from repro_torch.core import make_loader
    from repro_torch.core.tracing import Tracer
    from repro_torch.data.dataset import ImageDataset
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet
    from repro_torch.data.store import build_store
    from repro_torch.kernels.ingest_norm.ops import make_ingest_fn

    ingest = make_ingest_fn()
    base = build_synthetic_imagenet(num_items=SHM_ITEMS, avg_kb=115.0)

    def loader(executor: str, transport: str = "pipe"):
        store = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02), base=base)
        data = ImageDataset(store, SHM_ITEMS, out_size=224, sim_decode_s_per_mb=0.052,
                            epilogue="device")
        return make_loader(LoaderConfig(
            impl="threaded", batch_size=SHM_BS, num_workers=4, num_fetch_workers=16, seed=0,
            pipeline=PipelineConfig(enabled=True, cpu_executor=executor,
                                    cpu_workers=SHM_WORKERS, transport=transport,
                                    slab_slots=slots, staging_buffers=2)),
            ModulesProbe(data))

    runs, digests = {}, {}
    for label, executor, transport in (("thread", "thread", "pipe"),
                                       ("pipe", "process", "pipe"),
                                       ("shm", "process", "shm"),
                                       ("shm_crash", "process", "shm"),
                                       ("shm_cap", "process", "shm")):
        ld = loader(executor, transport)
        src, armed, capping = ld, None, None
        try:
            if label == "shm_crash":
                src = iter(ld)
                armed = arm_every_worker(src)
            elif label == "shm_cap":
                src = capping = Capping(ld, SHM_CAP_AFTER, SHM_CAP)
            ops.ingest_norm.launches = 0
            with DeviceDigest() as dig:
                batches = device_stream(torch, src, ingest, Tracer())
            launches = ops.ingest_norm.launches
            digests[label] = dig.digests(torch)
            stats = ld.stage_stats()
            pool = ld._cpu_pool
            names = [s.name for s in pool._slabs] if pool is not None else []
        finally:
            ld.close()
        loaded = sorted({bool(x) for b in batches for x in b["torch_loaded"].tolist()})
        runs[label] = {"batches": len(batches), "ingest_norm_launches": launches,
                       "transport": stats.get("transport"), "cpu_pool": stats.get("cpu_pool"),
                       "torch_in_sys_modules": loaded, "armed_workers": armed,
                       "cap_applied": capping.applied if capping else None,
                       "slab_segments": len(names), "segments_left": segments_left(names)}
        del batches
    want = digests["thread"]
    out = {"phase": "main_formats", "check": "b_shm_stream", "nvidia_smi": smi,
           "items": SHM_ITEMS, "batch": SHM_BS, "workers": SHM_WORKERS, "slab_slots": slots,
           "cap": SHM_CAP, "cap_after_batch": SHM_CAP_AFTER,
           "streams_equal_thread": {k: v == want for k, v in digests.items()},
           "runs": runs,
           "ingest_norm_launches": sum(r["ingest_norm_launches"] for r in runs.values()),
           "batches_transferred": sum(r["batches"] for r in runs.values())}
    emit(out)
    n = SHM_ITEMS // SHM_BS
    for label, r in runs.items():
        if r["batches"] != n or digests[label] != want:
            fail(f"(b) {label}: {r['batches']} batches, stream equal to the thread "
                 f"executor's: {digests[label] == want}")
        if r["ingest_norm_launches"] != r["batches"]:
            fail(f"(b) {label}: ingest_norm launched {r['ingest_norm_launches']} times for "
                 f"{r['batches']} batches")
        if r["segments_left"]:
            fail(f"(b) {label}: segments left after close: {r['segments_left']}")
        want_loaded = [True] if label == "thread" else [False]
        if r["torch_in_sys_modules"] != want_loaded:
            fail(f"(b) {label}: torch in sys.modules where samples were augmented: "
                 f"{r['torch_in_sys_modules']}")
        if label.startswith("shm") and not r["transport"]["shm_samples"]:
            fail(f"(b) {label}: no sample took the slab: {r['transport']}")
    crash = runs["shm_crash"]["cpu_pool"]
    if crash["crashes"] < 1 or crash["respawns"] < 1:
        fail(f"(b) the armed crash never fired: {crash}")
    if runs["shm_cap"]["cap_applied"] != min(SHM_CAP, slots):
        fail(f"(b) the slab cap was not applied: {runs['shm_cap']['cap_applied']}")
    return out


def columnar_check(torch, ops, base, labels: list, smi: str) -> dict:
    """(c) Full-width ResNet-18 trained 3 epochs from a columnar store behind
    s3sim under a 25 %-selectivity predicate: its device stream against the
    row store's with the rejected rows removed, its origin bytes an epoch
    against one unfiltered epoch's."""
    import numpy as np

    from repro_torch.config import LoaderConfig, SamplerPredicate, StoreConfig
    from repro_torch.core import make_loader
    from repro_torch.core.sampler import ShardedBatchSampler
    from repro_torch.core.tracing import Tracer
    from repro_torch.data.columnar import ColumnarImageDataset, ColumnarStore, convert_store
    from repro_torch.data.dataset import ImageDataset
    from repro_torch.data.store import InMemoryStore, build_store
    from repro_torch.train.trainer import Callback

    class EpochBytes(Callback):
        """Keeps the origin store's bytes read and GETs at every epoch's end."""

        def __init__(self, store) -> None:
            self.store, self.rows = store, []

        def on_epoch_end(self, trainer, epoch: int) -> None:
            st = self.store.stats
            self.rows.append((st.bytes_read, st.gets))

    t0 = time.perf_counter()
    col_base = InMemoryStore()
    shards = convert_store(base, COL_ITEMS, ColumnarStore(col_base))  # cluster_by="label"
    convert_s = time.perf_counter() - t0

    def dataset():
        s3 = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02), base=col_base)
        return s3, ColumnarImageDataset(ColumnarStore(s3), COL_ITEMS, out_size=224,
                                        sim_decode_s_per_mb=0.052, epilogue="device")

    def config(**kw):
        return LoaderConfig(impl="threaded", batch_size=MAIN_BS, num_workers=4,
                            num_fetch_workers=16, seed=0, **kw)

    s3, ds = dataset()
    mask = ds.predicate_mask(COL_PREDICATE)  # the footers: the index's only GETs
    footer_bytes, footer_gets = s3.stats.bytes_read, s3.stats.gets
    tracer, watch = Tracer(), EpochBytes(s3)
    loader = make_loader(config(sampler=SamplerPredicate(clauses=COL_PREDICATE)), ds,
                         tracer=tracer)
    ops.ingest_norm.launches = 0
    with DeviceDigest() as dig:
        result = tier_train(torch, loader, tracer, COL_EPOCHS, callbacks=[watch])
    launches = ops.ingest_norm.launches
    got = dig.digests(torch)
    rows, prev = [], (footer_bytes, footer_gets)
    for r in watch.rows:
        rows.append({"bytes": r[0] - prev[0], "gets": r[1] - prev[1]})
        prev = r
    losses = [h["loss"] for h in result.history]

    # the row store's stream with the rejected rows removed, on the host
    keep = np.asarray(labels[:COL_ITEMS]) < COL_PREDICATE[0][2]
    rows_ds = ImageDataset(base, COL_ITEMS, out_size=224, epilogue="device")
    sampler = ShardedBatchSampler(COL_ITEMS, MAIN_BS, shuffle=True, seed=0)
    want = []
    for e in range(COL_EPOCHS):
        sampler.set_epoch(e)
        rows_ds.set_epoch(e)
        order = [i for b in sampler for i in b.indices if keep[i]]
        for lo in range(0, len(order) - MAIN_BS + 1, MAIN_BS):
            want.append(host_digest([rows_ds[i] for i in order[lo:lo + MAIN_BS]]))

    # one unfiltered epoch drained on the host: the yardstick for bytes
    s3_all, ds_all = dataset()
    t1 = time.perf_counter()
    drained = sum(1 for _ in make_loader(config(), ds_all))
    drain_s = time.perf_counter() - t1
    unfiltered = s3_all.stats.bytes_read
    filtered = footer_bytes + max(r["bytes"] for r in rows)
    out = {"phase": "main_formats", "check": "c_columnar", "nvidia_smi": smi,
           "items": COL_ITEMS, "predicate": COL_PREDICATE, "shards": shards,
           "convert_s": convert_s, "rows_kept": int(mask.sum()),
           "rows_kept_row_store": int(keep.sum()),
           "batches_an_epoch": int(mask.sum()) // MAIN_BS, "steps": result.steps,
           "items_per_s_per_epoch": epoch_rates(tracer, int(mask.sum()) // MAIN_BS),
           "origin_per_epoch": rows, "footer_bytes": footer_bytes, "footer_gets": footer_gets,
           "unfiltered_epoch": {"batches": drained, "bytes": unfiltered,
                                "gets": s3_all.stats.gets, "wall_s": drain_s},
           "bytes_ratio": filtered / unfiltered if unfiltered else None,
           "stream_equal_row_store": got == want, "device_batches": len(got),
           "row_store_batches": len(want), "ingest_norm_launches": launches,
           "batches_transferred": len(got),
           "first_loss": losses[0] if losses else None,
           "last_loss": losses[-1] if losses else None}
    emit(out)
    if not np.array_equal(mask, keep):
        fail("(c) the columnar predicate mask differs from the row store's labels")
    if got != want or not got:
        fail(f"(c) the filtered stream ({len(got)} batches) differs from the row store's "
             f"with the rejected rows removed ({len(want)} batches)")
    if out["bytes_ratio"] is None or out["bytes_ratio"] > COL_BYTES_RATIO:
        fail(f"(c) a filtered epoch moved {out['bytes_ratio']} of an unfiltered one's bytes")
    if launches != len(got):
        fail(f"(c) ingest_norm launched {launches} times for {len(got)} batches")
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"(c) non-finite loss: {losses}")
    return out


def shards_check(torch, base, labels: list, smi: str) -> dict:
    """(d) Full-width ResNet-18, one SGD step a batch of 64, fed from tar
    shards streamed from s3sim; the dataset emits host-normalized f32, so no
    ingest_norm runs here."""
    import io
    import tarfile

    import numpy as np

    from repro_torch.config import StoreConfig, TrainConfig, get_arch
    from repro_torch.data.dataset import collate
    from repro_torch.data.imagenet_synth import item_key
    from repro_torch.data.shards import ShardedIterableDataset, write_shards
    from repro_torch.data.store import InMemoryStore, build_store
    from repro_torch.train.steps import init_resnet_train_state, make_resnet_train_step

    keys = [item_key(i) for i in range(SHARD_ITEMS)]
    shard_base = InMemoryStore()
    shard_keys = write_shards(base, shard_base, keys, items_per_shard=SHARD_PER)
    members = []
    for sk in shard_keys:
        with tarfile.open(fileobj=io.BytesIO(shard_base.get(sk)), mode="r") as tar:
            members += [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]
    members_ok = ([n for n, _ in members] == [k.replace("/", "__") for k in keys]
                  and all(d == base.get(k) for (_, d), k in zip(members, keys, strict=True)))
    s3 = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02), base=shard_base)
    ds = ShardedIterableDataset(s3, shard_keys, out_size=224)
    cfg, tcfg = get_arch("resnet18-imagenet"), TrainConfig(optimizer="sgd")
    state = init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    step = make_resnet_train_step(cfg, tcfg)
    want = sorted(labels[:SHARD_ITEMS])
    epochs, losses = [], []
    for e in range(SHARD_EPOCHS):
        ds.set_epoch(e)
        gets0, buf, seen, steps = s3.stats.gets, [], [], 0
        t0 = time.perf_counter()
        for item in ds:
            buf.append(item)
            seen.append(int(item["label"]))
            if len(buf) == MAIN_BS:
                b = collate(buf)
                buf = []
                state, m = step(state, {"image": torch.from_numpy(b["image"]).cuda(),
                                        "label": torch.from_numpy(b["label"]).cuda()})
                losses.append(m["loss"])
                steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs.append({"gets": s3.stats.gets - gets0, "steps": steps, "wall_s": wall,
                       "items_per_s": steps * MAIN_BS / wall,
                       "labels_equal_store": sorted(seen) == want})
    losses = [float(x.item()) for x in losses]
    out = {"phase": "main_formats", "check": "d_tar_shards", "nvidia_smi": smi,
           "items": SHARD_ITEMS, "items_per_shard": SHARD_PER, "shards": len(shard_keys),
           "members_equal_items": members_ok, "epochs": epochs,
           "ingest_norm": "not run: the shard dataset emits host-normalized f32",
           "first_loss": losses[0] if losses else None,
           "last_loss": losses[-1] if losses else None}
    emit(out)
    if not members_ok:
        fail("(d) a tar member's name or bytes differ from its item object")
    for e, row in enumerate(epochs):
        if row["gets"] != len(shard_keys) or not row["labels_equal_store"]:
            fail(f"(d) epoch {e}: {row['gets']} GETs for {len(shard_keys)} shards, labels "
                 f"equal to the store's: {row['labels_equal_store']}")
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"(d) non-finite loss: {losses}")
    return out


def read_trace(keys: list, rng) -> list:
    """bench_serve's interactive trace: (t_offset, key) arrivals, a
    diurnal-modulated Zipf background plus same-instant flash crowds on cold
    keys, one distinct key a burst."""
    w = [1.0 / (i + 1) ** READ["zipf_alpha"] for i in range(len(keys))]
    tot, acc, cdf = sum(w), 0.0, []
    for x in w:
        acc += x / tot
        cdf.append(acc)

    def pick() -> int:
        u, lo, hi = rng.random(), 0, len(cdf) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if cdf[mid] < u:
                lo = mid + 1
            else:
                hi = mid
        return lo

    events, t, dur = [], 0.0, READ["duration_s"]
    while t < dur:
        rate = READ["base_rate"] * (1.0 + 0.6 * math.sin(2.0 * math.pi * t / dur))
        t += rng.expovariate(max(rate, 1.0))
        events.append((t, keys[pick()]))
    cold = keys[len(keys) // 2:]
    for b in range(READ["bursts"]):
        tb = dur * (b + 0.5) / READ["bursts"]
        events.extend((tb, cold[(b * 37) % len(cold)]) for _ in range(READ["burst_size"]))
    events.sort(key=lambda ev: ev[0])
    return events


def order_pctl(xs: list, q: float) -> float:
    s = sorted(xs)
    return s[min(int(len(s) * q), len(s) - 1)] if s else 0.0


def read_cell(spec, cell: str) -> dict:
    """One of bench_serve's cells: 64 client threads replay the trace and 2
    scraper threads scan cold keys closed-loop for its duration, through a
    ReadPath over a memory tier and a disk tier in front of s3sim; every
    served payload is held to the store's bytes and the disk tier's bytes
    are sampled every 50 ms."""
    import os
    import random
    import shutil

    from repro_torch.core import make_read_path
    from repro_torch.data.cache import (
        DiskTierCache,
        MemoryTierCache,
        TieredCacheStore,
        make_admission,
    )
    from repro_torch.data.store import InMemoryStore, SimulatedS3Store

    rng = random.Random(7)
    base = InMemoryStore()

    def fill(prefix: str, n: int) -> list:
        out = []
        for i in range(n):
            k = f"{prefix}/{i:05d}"
            base.put(k, bytes([i % 251]) * rng.randint(16 * 1024, READ_MAX_OBJ))
            out.append(k)
        return out

    keys, scrape_keys = fill("obj", READ["items"]), fill("scan", 512)
    disk_dir = FORMATS_DIR / f"read_{cell}"
    shutil.rmtree(disk_dir, ignore_errors=True)
    disk_dir.mkdir(parents=True)
    s3 = SimulatedS3Store(base, latency_mean_s=READ["latency_mean_s"],
                          latency_sigma=READ["latency_sigma"],
                          bandwidth_per_conn=READ["bandwidth_per_conn"],
                          nic_bandwidth=READ["nic_bandwidth"],
                          max_connections=READ["max_connections"], seed=7,
                          overload_penalty=2.0)
    store = TieredCacheStore(s3, memory=MemoryTierCache(READ["mem_bytes"]),
                             disk=DiskTierCache(str(disk_dir), READ["disk_bytes"],
                                                make_admission("admit-all")))
    trace = read_trace(keys, random.Random(11))
    rp = make_read_path(spec, store)
    lat = {"interactive": [], "scraper": []}
    wrong = [0]
    lock, stop, peak = threading.Lock(), threading.Event(), [0]

    def disk_bytes() -> int:
        total = 0
        for f in os.listdir(disk_dir):
            if not f.startswith("."):
                try:
                    total += os.path.getsize(disk_dir / f)
                except OSError:
                    pass  # unlinked mid-scan by a live writer
        return total

    def poll() -> None:
        while not stop.is_set():
            peak[0] = max(peak[0], disk_bytes())
            time.sleep(0.05)

    def served(key: str, tenant: str) -> float:
        r = rp.get(key, tenant=tenant)
        if r.data != base.get(key):
            with lock:
                wrong[0] += 1
        return r.latency_s

    t0 = time.monotonic()

    def client(shard: list) -> None:
        out = []
        for toff, key in shard:
            dt = t0 + toff - time.monotonic()
            if dt > 0:
                time.sleep(dt)
            out.append(served(key, "interactive"))
        with lock:
            lat["interactive"].extend(out)

    def scraper(tid: int) -> None:
        out, i = [], tid
        while not stop.is_set():
            out.append(served(scrape_keys[i % len(scrape_keys)], "scraper"))
            i += READ_SCRAPERS
        with lock:
            lat["scraper"].extend(out)

    shards = [trace[j::READ_CLIENTS] for j in range(READ_CLIENTS)]
    threads = [threading.Thread(target=client, args=(s,)) for s in shards if s]
    threads += [threading.Thread(target=scraper, args=(i,)) for i in range(READ_SCRAPERS)]
    poller = threading.Thread(target=poll)
    poller.start()
    for t in threads:
        t.start()
    time.sleep(READ["duration_s"])
    stop.set()  # the scrapers stop issuing; requests in flight drain
    for t in threads:
        t.join()
    window = time.monotonic() - t0
    poller.join()
    peak[0] = max(peak[0], disk_bytes())
    stats = rp.stats()
    audit = rp.audit_max_fetches_per_window(
        spec.coalesce_window_s if spec.coalesce_window_s > 0 else 0.05)
    rp.close()
    ia = lat["interactive"]
    return {"cell": cell, "requests": {k: len(v) for k, v in lat.items()},
            "interactive_ms": {q: 1e3 * order_pctl(ia, p) for q, p in
                               (("p50", 0.50), ("p99", 0.99), ("p999", 0.999))},
            "scraper_p99_ms": 1e3 * order_pctl(lat["scraper"], 0.99),
            "tenants": stats["tenants"], "hedge": stats["hedge"],
            "audit_max_fetches_per_window": audit, "peak_disk_bytes": peak[0],
            "disk_bytes_bound": READ["disk_bytes"], "scrape_window_s": window,
            "payloads_wrong": wrong[0], "origin_gets": s3.stats.gets}


def read_path_check(smi: str) -> dict:
    """(e) bench_serve's two cells, uncoalesced and the read path; host
    only, as the reference's read path is: no kernel runs here."""
    from repro_torch.config import ServeSpec, TenantPolicy

    served_spec = ServeSpec(
        coalesce_window_s=0.1, hedge="slo", slo_p99_s=3.0 * READ["latency_mean_s"],
        hedge_min_s=0.005, hedge_budget_fraction=0.1,
        tenants=(TenantPolicy(tenant="scraper", rate_bytes_per_s=READ["scrape_rate"],
                              burst_bytes=READ["scrape_burst"]),))
    cells = [read_cell(ServeSpec(coalesce_window_s=0.0, hedge="off"), "uncoalesced"),
             read_cell(served_spec, "readpath")]
    served = cells[1]
    budget = (READ["scrape_rate"] * served["scrape_window_s"] + READ["scrape_burst"]
              + READ_SCRAPERS * READ_MAX_OBJ)
    scraper_bytes = served["tenants"]["scraper"]["backend_bytes"]
    out = {"phase": "main_formats", "check": "e_read_path", "nvidia_smi": smi,
           "scale": READ, "reduced": READ_REDUCED, "cells": cells,
           "scraper_budget_bytes": budget, "scraper_backend_bytes": scraper_bytes,
           "p99_ratio_readpath_over_uncoalesced": (
               served["interactive_ms"]["p99"] / cells[0]["interactive_ms"]["p99"]
               if cells[0]["interactive_ms"]["p99"] else None)}
    emit(out)
    if served["audit_max_fetches_per_window"] > 1:
        fail(f"(e) {served['audit_max_fetches_per_window']} primary fetches of one key in "
             "one coalesce window")
    for c in cells:
        if c["peak_disk_bytes"] > READ["disk_bytes"]:
            fail(f"(e) {c['cell']}: the disk tier held {c['peak_disk_bytes']} bytes of "
                 f"{READ['disk_bytes']}")
        if c["payloads_wrong"] or not c["requests"]["interactive"]:
            fail(f"(e) {c['cell']}: {c['payloads_wrong']} payloads differ from the store's "
                 f"over {c['requests']} requests")
    if scraper_bytes > budget:
        fail(f"(e) the scraper's backend bytes {scraper_bytes} exceed its budget {budget}")
    return out


def phase_main_formats(torch, ops, pipe_out: dict, smi: str) -> dict:
    """(a) the shm transport through the launcher; (b) its device stream,
    a crash and a cap through make_loader; (c) columnar with pushdown; (d)
    tar shards; (e) the read path."""
    from repro_torch.data import codec
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet, item_key

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    parts, walls = {}, {}
    t0 = time.perf_counter()
    shm = dev_shm_slots(SHM_LAUNCHER_WORKERS)
    parts["a"] = shm_launcher_check(torch, ops, pipe_out["process_run"], shm["slab_slots"], smi)
    walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts["b"] = shm_stream_check(torch, ops, shm["slab_slots"], smi)
    walls["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = build_synthetic_imagenet(num_items=COL_ITEMS, avg_kb=115.0)
    labels = [codec.decode_image(base.get(item_key(i))).label for i in range(COL_ITEMS)]
    parts["c"] = columnar_check(torch, ops, base, labels, smi)
    walls["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts["d"] = shards_check(torch, base, labels, smi)
    walls["d"] = time.perf_counter() - t0
    del base
    t0 = time.perf_counter()
    parts["e"] = read_path_check(smi)
    walls["e"] = time.perf_counter() - t0
    for part, wall in walls.items():
        emit({"phase": "main_formats", "check": "phase_wall", "part": part, "wall_s": wall})
    launches = {p: parts[p]["ingest_norm_launches"] for p in ("a", "b", "c")}
    return {"parts": parts, "launches": launches, "launches_total": sum(launches.values())}


# The crash/resume path (main_resume).  (a) full-width ResNet-18 from s3sim
# with --device-ingest through the launcher in subprocesses: 12 steps of 32
# over 320 items (10 batches an epoch, so the resumed steps 9-12 cross an
# epoch boundary), the launcher's default optimizer (AdamW: the checkpoint
# holds both moments), a checkpoint every 4 steps; run A is SIGKILLed once
# its step-8 checkpoint exists, then resumed; each resumed loss within the
# reference test's rel=1e-5 of the unbroken run B's.  The children run
# with deterministic algorithms (RESUME_CHILD), cuDNN's algorithm search
# off: a resumed process may otherwise pick other convolution algorithms.
RESUME_ITEMS, RESUME_BS, RESUME_STEPS, RESUME_EVERY, RESUME_KILL_AT = 320, 32, 12, 4, 8
RESUME_TOL = 1e-5
RESUME_ARGS = [
    "--arch", "resnet18-imagenet", "--full", "--device", "cuda", "--device-ingest",
    "--items", str(RESUME_ITEMS), "--avg-kb", "115", "--batch-size", str(RESUME_BS),
    "--latency", "0.02", "--loader", "threaded", "--workers", "4", "--fetchers", "16",
    "--steps", str(RESUME_STEPS), "--log-every", "1", "--seed", "0",
]
RESUME_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
if sys.argv[2] == "deterministic":
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
from repro_torch.kernels.ingest_norm import ops
from repro_torch.launch import train
ops.ingest_norm.launches = 0
report = train.run(sys.argv[3:])
start = report.resumed_from or 0
print("RESUME_CHILD " + json.dumps({
    "resumed_from": report.resumed_from, "steps": report.result.steps,
    "losses": {start + i + 1: h["loss"] for i, h in enumerate(report.result.history)},
    "launches": ops.ingest_norm.launches, "batches_transferred": report.batches_transferred,
    "items_per_s": report.items_per_s, "wall_s": report.result.wall_s,
    "deterministic": torch.are_deterministic_algorithms_enabled(),
    "cudnn_benchmark": torch.backends.cudnn.benchmark}), flush=True)
'''
# (b), (c): make_loader with the staged pipeline (2 staging buffers) over
# 256 items of 115 KB behind s3sim at batch 32: 8 batches, through a
# one-lane mesh over cuda:0 and through host delivery; (c) stops a sharded
# loader after 5 batches and resumes a fresh one from its state.
SHARD_ITEMS, SHARD_BS, SHARD_STOP = 256, 32, 5
# (d) the full ResNet-18 AdamW train state, saved asynchronously under
# build/ while the step runs on a batch already on the card
CKPT_COST_BS, CKPT_COST_STEPS, CKPT_COST_SAVES = 32, 6, 3


def resume_child(args: list, deterministic: bool = True):
    """The launcher with ``args`` in a child process of its own session,
    deterministic algorithms on (RESUME_CHILD), or PyTorch's defaults."""
    env = dict(os.environ)
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    mode = "deterministic" if deterministic else "defaults"
    return subprocess.Popen([sys.executable, "-c", RESUME_CHILD, str(SRC), mode, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True)


def child_report(proc, label: str, timeout: float = 600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    lines = [ln for ln in out.splitlines() if ln.startswith("RESUME_CHILD ")]
    if proc.returncode != 0 or not lines:
        fail(f"main_resume {label}: exit {proc.returncode}\n{out[-3000:]}\n{err[-3000:]}")
    rec = json.loads(lines[-1][len("RESUME_CHILD "):])
    rec["losses"] = {int(k): v for k, v in rec["losses"].items()}
    return rec


def printed_losses(out: str) -> dict:
    """The ``step=N loss=X`` lines a launcher printed, by step."""
    found = (re.match(r"\s*step=(\d+) loss=(\S+)", ln) for ln in out.splitlines())
    return {int(m.group(1)): float(m.group(2)) for m in found if m}


def crash_resume_check(smi: str) -> dict:
    """(a) Runs B (unbroken) and A (checkpoints every RESUME_EVERY steps)
    side by side; A is SIGKILLed (its whole session) as soon as
    ``step_00000008`` exists, then resumed with ``--resume`` while B
    finishes.  Gated on the
    resume starting from the newest complete step with no ``.tmp-``
    directory counted, every resumed loss within RESUME_TOL of B's at that
    step, the killed run's printed losses B's, and each finished child's
    ingest_norm launches equal to the batches it moved."""
    import shutil

    ckpt = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt_args = RESUME_ARGS + ["--ckpt-dir", str(ckpt), "--ckpt-every", str(RESUME_EVERY)]
    t0 = time.perf_counter()
    run_b = resume_child(RESUME_ARGS)
    run_a = resume_child(ckpt_args)
    target = ckpt / f"step_{RESUME_KILL_AT:08d}"
    while not target.is_dir():
        if run_a.poll() is not None:
            out, err = run_a.communicate()
            fail(f"main_resume: run A ended ({run_a.returncode}) before its step "
                 f"{RESUME_KILL_AT} checkpoint\n{out[-2000:]}\n{err[-2000:]}")
        time.sleep(0.01)
    os.killpg(run_a.pid, signal.SIGKILL)
    killed_s = time.perf_counter() - t0
    a_out, _ = run_a.communicate()
    at_kill = sorted(os.listdir(ckpt))
    printed_a = printed_losses(a_out)
    residue = [d for d in at_kill if ".tmp" in d]
    planted = None
    if not residue:
        # a writer killed mid-write leaves its tmp directory: stand one in
        # for the step after the kill, with half a file in it
        planted = f"step_{RESUME_STEPS:08d}.tmp-{run_a.pid + 1}"
        (ckpt / planted).mkdir()
        (ckpt / planted / "arrays_h0.npz").write_bytes(b"PK\x03\x04" + bytes(1000))
    complete = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt) if ".tmp" not in d)
    run_c = resume_child(ckpt_args + ["--resume"])  # beside what is left of B
    # B again with PyTorch's defaults: whether this path needed the settings
    run_p = resume_child(RESUME_ARGS, deterministic=False)
    b = child_report(run_b, "run B")
    resume = child_report(run_c, "resumed run")
    plain = child_report(run_p, "run B with PyTorch's defaults")
    wall = time.perf_counter() - t0
    diffs = {s: abs(loss - b["losses"][s]) / abs(b["losses"][s])
             for s, loss in resume["losses"].items()}
    abs_diffs = {s: abs(loss - b["losses"][s]) for s, loss in resume["losses"].items()}
    out = {
        "phase": "main_resume", "check": "a_crash_resume", "nvidia_smi": smi,
        "args": RESUME_ARGS, "ckpt_every": RESUME_EVERY, "killed_after_step": RESUME_KILL_AT,
        "killed_at_s": killed_s, "dir_at_kill": at_kill, "tmp_residue_at_kill": residue,
        "planted_tmp": planted, "complete_steps": complete,
        "killed_run_printed_steps": sorted(printed_a),
        "resumed_from": resume["resumed_from"], "resumed_steps": sorted(resume["losses"]),
        "losses_unbroken": b["losses"], "losses_resumed": resume["losses"],
        "max_rel_diff": max(diffs.values()) if diffs else None,
        "max_abs_diff": max(abs_diffs.values()) if abs_diffs else None,
        "tolerance_rel": RESUME_TOL,
        "deterministic": [b["deterministic"], resume["deterministic"]],
        "cudnn_benchmark": [b["cudnn_benchmark"], resume["cudnn_benchmark"]],
        # not a gate: the unbroken run under PyTorch's defaults against B
        "defaults_run": {"deterministic": plain["deterministic"],
                         "losses_bit_equal_to_unbroken": plain["losses"] == b["losses"],
                         "max_abs_diff": max(abs(plain["losses"][s] - b["losses"][s])
                                             for s in b["losses"])},
        "items_per_s": {"unbroken": b["items_per_s"], "resumed": resume["items_per_s"]},
        "launches": {"unbroken": b["launches"], "resumed": resume["launches"]},
        "batches_transferred": {"unbroken": b["batches_transferred"],
                                "resumed": resume["batches_transferred"]},
        "wall_s": wall,
    }
    emit(out)
    if complete != list(range(RESUME_EVERY, RESUME_KILL_AT + 1, RESUME_EVERY)):
        fail(f"main_resume: complete checkpoints {complete} after the kill")
    if resume["resumed_from"] != max(complete):
        fail(f"main_resume: resumed from {resume['resumed_from']}, newest complete {complete}")
    want_steps = list(range(RESUME_KILL_AT + 1, RESUME_STEPS + 1))
    if sorted(resume["losses"]) != want_steps or sorted(b["losses"]) != list(
            range(1, RESUME_STEPS + 1)):
        fail(f"main_resume: steps {sorted(resume['losses'])} resumed, "
             f"{sorted(b['losses'])} unbroken")
    if not all(math.isfinite(x) for x in list(b["losses"].values())
               + list(resume["losses"].values())):
        fail(f"main_resume: a non-finite loss: {b['losses']}, {resume['losses']}")
    if out["max_rel_diff"] > RESUME_TOL:
        fail(f"main_resume: resumed losses {resume['losses']} against {b['losses']}")
    if not printed_a or any(abs(v - round(b["losses"][s], 4)) > 1e-4
                            for s, v in printed_a.items()):
        fail(f"main_resume: the killed run printed {printed_a}, unbroken {b['losses']}")
    for rec, label in ((b, "unbroken"), (resume, "resumed")):
        if rec["launches"] == 0 or rec["launches"] != rec["batches_transferred"]:
            fail(f"main_resume {label}: ingest_norm launched {rec['launches']} times for "
                 f"{rec['batches_transferred']} batches transferred")
    out["launches_total"] = b["launches"] + resume["launches"] + plain["launches"]
    if plain["launches"] != plain["batches_transferred"]:
        fail(f"main_resume defaults run: ingest_norm launched {plain['launches']} times for "
             f"{plain['batches_transferred']} batches transferred")
    return out


def shard_loader(base, delivery, tracer):
    from repro_torch.config import LoaderConfig, PipelineConfig, StoreConfig
    from repro_torch.core import make_loader
    from repro_torch.data.dataset import ImageDataset
    from repro_torch.data.store import build_store

    store = build_store(StoreConfig(kind="s3sim", latency_mean_s=0.02), base=base)
    return make_loader(LoaderConfig(
        impl="threaded", batch_size=SHARD_BS, num_workers=4, num_fetch_workers=16, seed=0,
        pipeline=PipelineConfig(enabled=True, staging_buffers=2), delivery=delivery),
        ImageDataset(store, SHARD_ITEMS, out_size=224, sim_decode_s_per_mb=0.052,
                     epilogue="device"), tracer=tracer)


def sharded_checks(torch, ops, smi: str) -> dict:
    """(b) one epoch through a one-lane mesh over cuda:0 against host
    delivery, each through the device ring and ingest_norm: bit-equal f32
    batches, the sharded ring copying nothing (no ``batch_to_device`` span,
    0 bytes) while the lane records one ``lane_h2d`` a batch, and
    ingest_norm launched once a batch; items/s of each.  (c) a sharded
    loader stopped after SHARD_STOP batches, its state (with the lane
    block) loaded by a fresh one: the rest of the epoch bit-equal to an
    unbroken run's."""
    from repro_torch.config import DeliverySpec
    from repro_torch.core.prefetch import DevicePrefetchRing
    from repro_torch.core.tracing import BATCH_TO_DEVICE, LANE_H2D, Tracer
    from repro_torch.data.imagenet_synth import build_synthetic_imagenet
    from repro_torch.launch.mesh import make_mesh

    base = build_synthetic_imagenet(num_items=SHARD_ITEMS, avg_kb=115.0)
    mesh = make_mesh((1,), ("data",))
    ingest = ops.make_ingest_fn()
    nb = SHARD_ITEMS // SHARD_BS
    runs = {}
    for label, delivery in (("host", DeliverySpec.host()),
                            ("sharded", DeliverySpec.sharded(mesh))):
        tracer = Tracer()
        loader = shard_loader(base, delivery, tracer)
        torch.cuda.synchronize()
        ops.ingest_norm.launches = 0
        t0 = time.perf_counter()
        ring = DevicePrefetchRing(iter(loader), depth=2, transfer=not loader.delivers_device_batches,
                                  tracer=tracer, ingest_fn=ingest, device="cuda")
        try:
            batches = list(ring)
        finally:
            ring.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = loader.stage_stats()
        runs[label] = {"batches": batches, "wall_s": wall,
                       "items_per_s": len(batches) * SHARD_BS / wall,
                       "launches": ops.ingest_norm.launches,
                       "ring_bytes": ring.bytes_transferred,
                       "batch_to_device_spans": len(tracer.spans(BATCH_TO_DEVICE)),
                       "lane_h2d_spans": len(tracer.spans(LANE_H2D)),
                       "copy_ms": [1e3 * sp.duration for sp in tracer.spans(
                           LANE_H2D if loader.delivers_device_batches else BATCH_TO_DEVICE)],
                       "delivery": stats.get("delivery")}
    host, sharded = runs["host"], runs["sharded"]
    equal = len(host["batches"]) == len(sharded["batches"]) == nb and all(
        set(h) == set(s) and all(torch.equal(h[k], s[k]) for k in h)
        for h, s in zip(host["batches"], sharded["batches"]))
    dtypes = sorted({str(b["image"].dtype) for b in sharded["batches"]})
    lanes = sharded["delivery"]["lanes"]
    out_b = {"phase": "main_resume", "check": "b_sharded_one_lane", "nvidia_smi": smi,
             "items": SHARD_ITEMS, "batch_size": SHARD_BS, "batches": nb,
             "bit_equal": equal, "image_dtypes": dtypes,
             "lane_h2d_mean_ms": 1e3 * lanes[0]["h2d_mean_s"],
             "lane_collate_mean_ms": 1e3 * lanes[0]["collate_mean_s"],
             "staging": sharded["delivery"].get("staging"),
             **{f"{k}_{label}": runs[label][k] for label in runs for k in (
                 "items_per_s", "wall_s", "launches", "ring_bytes", "batch_to_device_spans",
                 "lane_h2d_spans", "copy_ms")}}
    emit(out_b)
    if not equal or dtypes != ["torch.float32"]:
        fail(f"main_resume (b): sharded batches differ from host delivery's ({dtypes})")
    if sharded["ring_bytes"] != 0 or sharded["batch_to_device_spans"] != 0:
        fail(f"main_resume (b): the sharded ring copied {sharded['ring_bytes']} bytes in "
             f"{sharded['batch_to_device_spans']} spans")
    if sharded["lane_h2d_spans"] != nb or host["batch_to_device_spans"] < nb:
        fail(f"main_resume (b): lane_h2d {sharded['lane_h2d_spans']}, host copies "
             f"{host['batch_to_device_spans']}, batches {nb}")
    for label, r in runs.items():
        if r["launches"] != len(r["batches"]):
            fail(f"main_resume (b) {label}: ingest_norm launched {r['launches']} times for "
                 f"{len(r['batches'])} batches")
    del runs, host, sharded

    # (c) lane-cursor resume, raw u8 batches on the card
    unbroken = [dict(b) for b in shard_loader(base, DeliverySpec.sharded(mesh), Tracer())]
    first = shard_loader(base, DeliverySpec.sharded(mesh), Tracer())
    it = iter(first)
    for _ in range(SHARD_STOP):
        next(it)
    state = first.state_dict()
    it.shutdown()
    fresh = shard_loader(base, DeliverySpec.sharded(mesh), Tracer())
    fresh.load_state_dict(json.loads(json.dumps(state)))
    rest = list(fresh)
    torch.cuda.synchronize()
    equal_c = len(rest) == nb - SHARD_STOP and all(
        all(torch.equal(r[k], u[k]) for k in u) for r, u in zip(rest, unbroken[SHARD_STOP:]))
    out_c = {"phase": "main_resume", "check": "c_lane_cursor_resume", "nvidia_smi": smi,
             "stopped_after": SHARD_STOP, "state": state, "resumed_batches": len(rest),
             "bit_equal": equal_c,
             "devices": sorted({str(v.device) for b in rest for v in b.values()})}
    emit(out_c)
    lanes_c = state.get("delivery", {}).get("lanes", [])
    if [ln["next_batch"] for ln in lanes_c] != [SHARD_STOP] or state["next_batch"] != SHARD_STOP:
        fail(f"main_resume (c): state {state}")
    if not equal_c or out_c["devices"] != ["cuda:0"]:
        fail(f"main_resume (c): the resumed batches differ from the unbroken run's")
    return {"b": out_b, "c": out_c, "launches_sharded": out_b["launches_sharded"]}


def ckpt_cost_check(torch, smi: str) -> dict:
    """(d) The full ResNet-18 train state (params, BatchNorm, AdamW's two
    moments, step): bytes written, how long ``save(blocking=False)`` blocks
    for its snapshot, how long the background write takes, and the step
    time right after a save against steps without one.  Figures, not
    gates (the write must succeed and restore must hold the saved step)."""
    import shutil

    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.convert import checkpoint_layout
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.steps import init_resnet_train_state, make_resnet_train_step
    from repro_torch.tree import leaves

    cfg, tcfg = get_arch("resnet18-imagenet"), TrainConfig(optimizer="adamw")
    state = init_resnet_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    step = make_resnet_train_step(cfg, tcfg)
    gen = torch.Generator().manual_seed(4)
    batch = {"image": torch.randn(CKPT_COST_BS, 3, 224, 224, generator=gen).cuda(),
             "label": torch.randint(0, cfg.num_classes, (CKPT_COST_BS,), generator=gen).cuda()}

    def timed_step():
        nonlocal state
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        timed_step()
    plain = [timed_step() for _ in range(CKPT_COST_STEPS)]
    root = ROOT / "build" / "chip_smoke_ckpt_cost"
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(str(root), keep=1, layout=checkpoint_layout(cfg))
    snapshot, write, after, blocked = [], [], [], []
    for _ in range(CKPT_COST_SAVES):
        t0 = time.perf_counter()
        mgr.save(state["step"], state, blocking=False)
        blocked.append((time.perf_counter() - t0) * 1e3)
        snapshot.append(mgr.last_snapshot_s * 1e3)
        after.append(timed_step())
        mgr.wait()
        write.append(mgr.last_write_s * 1e3)
        timed_step()
    restored, meta = mgr.restore(state)
    npz = root / f"step_{meta['step']:08d}" / "arrays_h0.npz"
    out = {"phase": "main_resume", "check": "d_ckpt_cost", "nvidia_smi": smi,
           "batch_size": CKPT_COST_BS,
           "params": sum(p.numel() for p in leaves(state["params"])),
           "bytes_arrays": mgr.last_bytes, "bytes_file": os.path.getsize(npz),
           "save_blocks_ms": blocked, "snapshot_ms": snapshot, "write_ms": write,
           "step_ms_without_save": plain, "step_ms_after_save": after,
           "step_ms_without_save_median": statistics.median(plain),
           "step_ms_after_save_median": statistics.median(after),
           "restored_step": restored["step"]}
    emit(out)
    if restored["step"] != meta["step"] or mgr.last_bytes <= 0:
        fail(f"main_resume (d): restored step {restored['step']}, meta {meta}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def phase_main_resume(torch, ops, smi: str) -> dict:
    """(a) a SIGKILLed launcher run resumed from its newest checkpoint
    against an unbroken one; (b) sharded delivery on one lane against host
    delivery; (c) the lane-cursor resume; (d) the checkpoint's cost."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    walls, parts = {}, {}
    t0 = time.perf_counter()
    parts["a"] = crash_resume_check(smi)
    walls["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts["bc"] = sharded_checks(torch, ops, smi)
    walls["bc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts["d"] = ckpt_cost_check(torch, smi)
    walls["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for part, wall in walls.items():
        emit({"phase": "main_resume", "check": "phase_wall", "part": part, "wall_s": wall})
    return {"parts": parts, "launches_resume": parts["a"]["launches_total"],
            "launches_sharded": parts["bc"]["launches_sharded"]}


# main_dp: data parallelism over a process group, one process a rank.
# (a) two ranks on the one card over gloo (NCCL takes one rank a card),
# --device cuda:0, full-width ResNet-18 at global batch 64 (32 a rank), SGD
# at a learning rate that moves the parameters (no warmup), --device-ingest,
# --delivery sharded, from main's simulated S3 store, for one step of one
# batch and for one epoch of 16 steps, against one process at the same
# seed, items and global batch (one lane); TF32 off in every child.  (b) NCCL at world size 1, 4 steps, after the
# same run with no process group in one process, deterministic algorithms
# on: bit-equal losses.
DP_STEPS, DP_RANKS = 16, 2
DP_LR = 0.05
DP_ARGS = with_values(MAIN_ARGS, steps=DP_STEPS, log_every=1) + [
    "--delivery", "sharded", "--seed", "0", "--lr", str(DP_LR), "--warmup-steps", "0"]
# (a)'s first step: one batch, one step from the seed's weights, where no
# training dynamics amplify the card's rounding: the loss, the gradient
# norm, and the update of the parameters and of BatchNorm's running
# statistics (2-norm of the difference over 2-norm of the one process's
# update) within these relative tolerances
DP_FIRST_ARGS = with_values(DP_ARGS, items=MAIN_BS, steps=1)
DP_FIRST_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "params": 2e-2, "bn": 1e-3}
# (a)'s 16 steps: each step's loss within this relative tolerance of the
# one process's (16 SGD steps amplify the card's rounding, and one process
# run twice differs too)
DP_TOL = 5e-3
DP_NCCL_ITEMS, DP_NCCL_STEPS = 256, 4
DP_NCCL_ARGS = with_values(DP_ARGS, items=DP_NCCL_ITEMS, steps=DP_NCCL_STEPS)
DP_RENDEZVOUS = ROOT / "build" / "chip_smoke_dp_rendezvous"
DP_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
if sys.argv[2] == "nccl":
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
from repro_torch.kernels.ingest_norm import ops
from repro_torch.launch import train
from repro_torch.tree import flatten


def one(args, state_out=""):
    ops.ingest_norm.launches = 0
    report = train.run(args)
    lanes = [ln for st in report.stages for ln in (st.get("delivery") or {}).get("lanes", [])]
    if state_out and report.data_parallel.get("rank", 0) == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    flatten({"params": report.state["params"], "bn": report.state["bn"]}).items()},
                   state_out)
    return {"losses": [h["loss"] for h in report.result.history],
            "grad_norms": [h["grad_norm"] for h in report.result.history],
            "steps": report.result.steps, "items_per_s": report.items_per_s,
            "wall_s": report.result.wall_s, "launches": ops.ingest_norm.launches,
            "lane_batches": sum(ln["composed"] for ln in lanes),
            "lane_h2d_mean_ms": [1e3 * ln["h2d_mean_s"] for ln in lanes],
            "lane_collate_mean_ms": [1e3 * ln["collate_mean_s"] for ln in lanes],
            "ring_copies": report.batches_transferred,
            "busy_fraction": report.util.busy_fraction,
            "data_parallel": report.data_parallel}


if sys.argv[2] == "nccl":
    # no process group, then an NCCL group of one, in this one process
    rec = {"plain": one(sys.argv[4:])}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    rec["group"] = one(sys.argv[4:] + ["--dist-backend", "nccl", "--dist-init", sys.argv[3]])
else:
    rec = {"run": one(sys.argv[4:], sys.argv[3])}
print("DP_CHILD " + json.dumps(rec), flush=True)
"""


def dp_child(mode: str, args: list, env: dict = None, source: str = DP_CHILD):
    """A DP_CHILD process, TF32 off: ``run`` trains once with ``args[1:]``
    (a rank when ``env`` holds torchrun's variables) and, when ``args[0]``
    names a file, saves the final parameters and BatchNorm statistics there
    (rank 0's under a group); ``nccl`` trains with no process group and then
    in an NCCL group of one at ``args[0]``'s rendezvous, with deterministic
    algorithms (cuDNN's search off)."""
    full = dict(os.environ, **(env or {}))
    if mode == "nccl":
        full["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    return subprocess.Popen([sys.executable, "-c", source, str(SRC), mode, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=full, start_new_session=True)


def dp_report(procs: list, label: str, timeout: float = 300) -> list:
    """Each child's DP_CHILD record; kills every child still running when
    one fails or the deadline passes."""
    deadline = time.monotonic() + timeout
    recs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            lines = [ln for ln in out.splitlines() if ln.startswith("DP_CHILD ")]
            if p.returncode != 0 or not lines:
                fail(f"main_dp {label}: exit {p.returncode}\n{out[-3000:]}\n{err[-3000:]}")
            recs.append(json.loads(lines[-1][len("DP_CHILD "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return recs


def rendezvous_url() -> str:
    DP_RENDEZVOUS.parent.mkdir(parents=True, exist_ok=True)
    if DP_RENDEZVOUS.exists():
        DP_RENDEZVOUS.unlink()
    return f"file://{DP_RENDEZVOUS}"


def dp_state_path(label: str) -> Path:
    path = ROOT / "build" / f"chip_smoke_dp_state_{label}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def dp_one_process(label: str, args: list) -> "subprocess.Popen":
    """One process, one lane, the whole global batch; its final state is
    saved at ``dp_state_path(label)``."""
    return dp_child("run", [str(dp_state_path(label)), *args])


def dp_two_ranks(label: str, args: list, source: str = DP_CHILD) -> list:
    """DP_RANKS gloo ranks sharing cuda:0, rank 0's final state saved at
    ``dp_state_path(label)``."""
    rank_args = with_values(args, device="cuda:0") + [
        "--dist-backend", "gloo", "--dist-init", rendezvous_url()]
    # the host's cores split over the ranks' intra-op threads (two ranks of
    # PyTorch's default width oversubscribe the host's cores)
    threads = str(max((os.cpu_count() or DP_RANKS) // DP_RANKS, 1))
    return [dp_child("run", [str(dp_state_path(label)), *rank_args],
                     {"RANK": str(r), "WORLD_SIZE": str(DP_RANKS), "LOCAL_RANK": str(r),
                      "OMP_NUM_THREADS": threads}, source)
            for r in range(DP_RANKS)]


def dp_runs(procs: list, label: str) -> list:
    return [r["run"] for r in dp_report(procs, label)]


def dp_state_gap(label: str, ref: str) -> dict:
    """How far run ``label``'s saved final state lies from run ``ref``'s,
    over how far ``ref`` moved it from the seed's initial state (global
    2-norms in float64, parameters and BatchNorm's running statistics
    apart)."""
    import torch

    from repro_torch.config import get_arch
    from repro_torch.models import resnet
    from repro_torch.tree import flatten

    params0, bn0 = resnet.init_resnet(get_arch("resnet18-imagenet", smoke=False),
                                      torch.Generator().manual_seed(0), "cpu")
    init = flatten({"params": params0, "bn": bn0})
    one = torch.load(dp_state_path(ref))
    other = torch.load(dp_state_path(label))
    if set(one) != set(other) or set(one) != set(init):
        fail("main_dp (a): state keys differ between the runs and the initial state")
    out = {}
    for part in ("params", "bn"):
        keys = [k for k in one if k.startswith(part + "/")]
        gap = sum(float((other[k].double() - one[k].double()).square().sum()) for k in keys)
        moved = sum(float((one[k].double() - init[k].double()).square().sum()) for k in keys)
        out[part] = {"gap": math.sqrt(gap), "moved": math.sqrt(moved),
                     "rel": math.sqrt(gap / moved) if moved else float("inf")}
    return out


def rel_diffs(a: list, b: list) -> list:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def dp_compare(one: dict, ranks: list, gap: dict) -> dict:
    """A two-rank run against the one process: the largest relative
    difference of the losses and of the gradient norms over the steps, and
    the state's (``dp_state_gap``)."""
    lead = ranks[0]
    return {"loss": max(rel_diffs(lead["losses"], one["losses"]), default=float("inf")),
            "grad_norm": max(rel_diffs(lead["grad_norms"], one["grad_norms"]),
                             default=float("inf")),
            "params": gap["params"]["rel"], "bn": gap["bn"]["rel"]}


def dp_gate(first: dict, run: dict) -> list:
    """(a)'s gates on the two-rank runs against the one process (``first``:
    the first step's, ``run``: the 16 steps'; each {"one", "ranks", "gap"}):
    each a failure message, none when they pass."""
    bad = []
    for part, rec, steps in (("first step", first, 1), ("run", run, DP_STEPS)):
        one, ranks = rec["one"], rec["ranks"]
        lead = ranks[0]
        dp = lead["data_parallel"]
        for label, r in [("one process", one)] + [(f"rank {i}", x) for i, x in enumerate(ranks)]:
            if r["steps"] != steps or len(r["losses"]) != steps:
                bad.append(f"{part}, {label}: {r['steps']} steps")
            if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
                bad.append(f"{part}, {label}: a non-finite loss or gradient norm")
            if r["launches"] == 0 or r["launches"] != r["lane_batches"] or r["ring_copies"]:
                bad.append(f"{part}, {label}: ingest_norm launched {r['launches']} times for "
                           f"{r['lane_batches']} batches its lane moved ({r['ring_copies']} "
                           "ring copies)")
        if dp["backend"] != "gloo" or dp["world_size"] != DP_RANKS:
            bad.append(f"{part}: a group of {dp['world_size']} over {dp['backend']}")
        if (any(x["losses"] != lead["losses"] for x in ranks)
                or dp["checksum_min"] != dp["checksum_max"]):
            bad.append(f"{part}: the ranks differ: checksums {dp['checksum_min']}, "
                       f"{dp['checksum_max']}")
        if dp["grad_allreduce_calls"] != steps:
            bad.append(f"{part}: {dp['grad_allreduce_calls']} gradient all-reduces for "
                       f"{steps} steps")
    diff = dp_compare(first["one"], first["ranks"], first["gap"])
    for key, tol in DP_FIRST_TOL.items():
        if not diff[key] <= tol:
            bad.append(f"first step: {key} {diff[key]} from the one process's (relative) > {tol}")
    loss = dp_compare(run["one"], run["ranks"], run["gap"])["loss"]
    if not loss <= DP_TOL:
        bad.append(f"run: losses {loss} from the one process's (relative) > {DP_TOL}: "
                   f"{run['ranks'][0]['losses']} against {run['one']['losses']}")
    return bad


def dp_first_step(label: str, source: str = DP_CHILD, one: dict = None) -> dict:
    """(a)'s first step: the one process (unless given) and the two ranks,
    all at once (one step each; nothing here is timed)."""
    procs = ([] if one is not None else [dp_one_process("one_first", DP_FIRST_ARGS)])
    recs = dp_runs(procs + dp_two_ranks(label + "_first", DP_FIRST_ARGS, source),
                   f"(a) first step, {label}")
    one = one if one is not None else recs.pop(0)
    return {"one": one, "ranks": recs, "gap": dp_state_gap(label + "_first", "one_first")}


def dp_run(label: str, source: str = DP_CHILD, one: dict = None) -> dict:
    """(a)'s 16 steps: the one process (unless given), then the two ranks."""
    if one is None:
        one, = dp_runs([dp_one_process("one", DP_ARGS)], "(a) one process")
    ranks = dp_runs(dp_two_ranks(label, DP_ARGS, source), f"(a) {label}")
    return {"one": one, "ranks": ranks, "gap": dp_state_gap(label, "one")}


def two_ranks_check(smi: str) -> dict:
    """(a) Two gloo ranks sharing cuda:0 against one process, SGD at a
    learning rate that moves the parameters.  First step (one batch):
    loss, gradient norm and the update of the parameters and BatchNorm's
    running statistics within DP_FIRST_TOL.  16 steps: each loss within
    DP_TOL.  Both: every rank's parameters bit-equal (checksums
    all-reduced as a min and a max), each rank's ingest_norm launches
    equal to the batches its lane moved (the ring copies nothing).  Prints
    items/s of both 16-step runs, the gradient all-reduce's ms a step (gloo
    through the host), the lane skew across ranks and the 16 steps' gaps
    (not gated beyond the losses)."""
    t0 = time.perf_counter()
    first = dp_first_step("ranks")
    run = dp_run("ranks")
    bad = dp_gate(first, run)
    one, ranks = run["one"], run["ranks"]
    lead = ranks[0]
    dp = lead["data_parallel"]
    composed = dp["composed_ranks"]
    out = {
        "phase": "main_dp", "check": "a_two_ranks_one_card", "nvidia_smi": smi,
        "args": DP_ARGS, "ranks": DP_RANKS, "backend": dp["backend"],
        "device": "cuda:0 (every rank)", "cudnn_allow_tf32": False, "matmul_allow_tf32": False,
        "global_batch": MAIN_BS, "rows_a_rank": MAIN_BS // DP_RANKS,
        "intra_op_threads_a_rank": int(max((os.cpu_count() or DP_RANKS) // DP_RANKS, 1)),
        "host_cpu_count": os.cpu_count(),
        "first_step": dp_compare(first["one"], first["ranks"], first["gap"]),
        "first_step_tolerance_rel": DP_FIRST_TOL,
        "first_step_grad_norms": [first["one"]["grad_norms"], first["ranks"][0]["grad_norms"]],
        "run": dp_compare(one, ranks, run["gap"]), "run_tolerance_rel_loss": DP_TOL,
        "state_gap": run["gap"],
        "losses_one_process": one["losses"], "losses_two_ranks": lead["losses"],
        "grad_norms_one_process": one["grad_norms"], "grad_norms_two_ranks": lead["grad_norms"],
        "losses_equal_on_every_rank": all(r["losses"] == lead["losses"] for r in ranks),
        "checksum_min": dp["checksum_min"], "checksum_max": dp["checksum_max"],
        "params_bit_equal": dp["checksum_min"] == dp["checksum_max"],
        "items_per_s_one_process": one["items_per_s"],
        "items_per_s_two_ranks": lead["items_per_s"],
        "wall_s_one_process": one["wall_s"], "wall_s_two_ranks": lead["wall_s"],
        "grad_allreduce_ms_per_step_gloo_through_host": dp["grad_allreduce_ms_per_step"],
        "grad_allreduce_calls": dp["grad_allreduce_calls"],
        "grad_allreduce_bytes": dp["grad_allreduce_bytes"],
        "busy_ranks": dp["busy_ranks"], "busy_one_process": one["busy_fraction"],
        "lane_batches_ranks": composed, "lane_skew": max(composed) - min(composed),
        "lane_h2d_mean_ms_ranks": [r["lane_h2d_mean_ms"] for r in ranks],
        "lane_collate_mean_ms_ranks": [r["lane_collate_mean_ms"] for r in ranks],
        "lane_h2d_mean_ms_one_process": one["lane_h2d_mean_ms"],
        "launches_ranks": [r["launches"] for r in ranks], "launches_one_process": one["launches"],
        "launches_first_step": [first["one"]["launches"]] + [r["launches"] for r in first["ranks"]],
        "failures": bad, "wall_s": time.perf_counter() - t0,
    }
    emit(out)
    if bad:
        fail("main_dp (a): " + "; ".join(bad))
    return out


def nccl_check(smi: str) -> dict:
    """(b) NCCL at world size 1 on the card after the same run with no
    process group, in one process with deterministic algorithms: bit-equal
    losses (the second run's batches come from blocks the first run freed);
    the group's gradient all-reduce ran once a step."""
    t0 = time.perf_counter()
    rec, = dp_report([dp_child("nccl", [rendezvous_url(), *DP_NCCL_ARGS])], "nccl")
    plain, group = rec["plain"], rec["group"]
    dp = group["data_parallel"]
    out = {"phase": "main_dp", "check": "b_nccl_world_one", "nvidia_smi": smi,
           "args": DP_NCCL_ARGS, "backend": dp.get("backend"), "world_size": dp.get("world_size"),
           "losses_no_group": plain["losses"], "losses_nccl": group["losses"],
           "bit_equal": plain["losses"] == group["losses"],
           "grad_allreduce_calls": dp.get("grad_allreduce_calls"),
           "grad_allreduce_ms_per_step_nccl_one_rank": dp.get("grad_allreduce_ms_per_step"),
           "items_per_s_no_group": plain["items_per_s"], "items_per_s_nccl": group["items_per_s"],
           "launches": [plain["launches"], group["launches"]],
           "lane_batches": [plain["lane_batches"], group["lane_batches"]],
           "wall_s": time.perf_counter() - t0}
    emit(out)
    if dp.get("backend") != "nccl" or dp.get("world_size") != 1:
        fail(f"main_dp (b): the group was {dp}")
    if plain["data_parallel"] or len(plain["losses"]) != DP_NCCL_STEPS:
        fail(f"main_dp (b): the run without a group reported {plain['data_parallel']}, "
             f"{len(plain['losses'])} steps")
    if not out["bit_equal"] or not all(math.isfinite(x) for x in plain["losses"]):
        fail(f"main_dp (b): NCCL losses {group['losses']} against {plain['losses']}")
    if dp["grad_allreduce_calls"] != DP_NCCL_STEPS:
        fail(f"main_dp (b): {dp['grad_allreduce_calls']} gradient all-reduces")
    for r in (plain, group):
        if r["launches"] == 0 or r["launches"] != r["lane_batches"]:
            fail(f"main_dp (b): ingest_norm launched {r['launches']} times for "
                 f"{r['lane_batches']} batches")
    return out


def phase_main_dp(torch, smi: str) -> dict:
    """(a) two gloo ranks sharing the card against one process; (b) NCCL at
    world size 1 against no process group."""
    torch.cuda.empty_cache()
    try:
        a = two_ranks_check(smi)
    finally:
        for path in ROOT.glob("build/chip_smoke_dp_state_*.pt"):
            path.unlink()
    b = nccl_check(smi)
    launches = {"two_ranks": a["launches_ranks"], "one_process": a["launches_one_process"],
                "first_step": a["launches_first_step"], "nccl_world_one": b["launches"]}
    return {"a": a, "b": b, "launches": launches,
            "launches_total": (sum(a["launches_ranks"]) + a["launches_one_process"]
                               + sum(a["launches_first_step"]) + sum(b["launches"]))}


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
    steps = sorted(report.tracer.spans("run_training_batch"), key=lambda sp: sp.t1)
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
        "step_ms_after_first_median": (1e3 * statistics.median(sp.duration for sp in steps[1:])
                                       if len(steps) > 1 else None),
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



def roofline_row(card, cost, step_ms: float, model_flops: float) -> dict:
    """A counted step against its measured time: FLOPs by class, bytes,
    achieved TFLOP/s, the roofline's terms and bound, the bound's share of
    the step, ``step_mfu`` (model FLOPs over peak x step time) and
    ``step_hfu`` (every counted FLOP, recompute included, over class peak x
    step time)."""
    from repro_torch.launch.roofline import Roofline, step_hfu, step_mfu

    roof = Roofline(cost.flops_by_class, cost.traffic_bytes, cost.wire_bytes, model_flops, 1,
                    card)
    step_s = step_ms / 1e3
    return {"flops_by_class": cost.flops_by_class, "flops": cost.flops,
            "bytes": cost.traffic_bytes, "ops": cost.ops, "kernels": cost.kernels,
            "flags": cost.flags, "step_ms": step_ms, "model_flops": model_flops,
            "achieved_tflops": cost.flops / step_ms / 1e9,
            "t_compute_ms": roof.t_compute * 1e3,
            "t_compute_by_class_ms": {c: t * 1e3 for c, t in roof.t_compute_by_class.items()},
            "t_memory_ms": roof.t_memory * 1e3, "bound_ms": roof.bound_time * 1e3,
            "bound_by": roof.dominant, "bound_share_of_step": roof.bound_time * 1e3 / step_ms,
            "step_mfu": step_mfu(model_flops, cost.flops_by_class, step_s, card),
            "step_hfu": step_hfu(cost.flops_by_class, step_s, card),
            "top_flops": cost.top_flops[:5], "top_bytes": cost.top_bytes[:5]}


def measured_step_peak(torch, cfg, tcfg) -> dict:
    """One train step of ``cfg`` on the card from a fresh state drawn there
    and a random batch at main_lm's shape: ``max_memory_allocated()`` over
    the step after ``reset_peak_memory_stats()``, with what was allocated
    before it (the state, the batch and anything left on the card)."""
    from repro_torch.train.steps import init_train_state, make_train_step

    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(5)
    state = init_train_state(cfg, tcfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (LM_BS, LM_SEQ + 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
    del toks
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, metrics = make_train_step(cfg, tcfg)(state, batch)
    loss = metrics["loss"].item()
    out = {"measured_peak_bytes": torch.cuda.max_memory_allocated(),
           "allocated_before_bytes": before, "one_step_loss": loss}
    del state, batch, metrics
    torch.cuda.empty_cache()
    return out


def phase_main_roofline(torch, ingest_ops, flash_ops, main_out: dict, lm_out: dict,
                        flash_out: dict, card, smi: str) -> dict:
    """The main paths' steps counted by the dry run's op counter on fake
    CPU tensors under ``for_card`` (no allocation, no launch: each kernel
    wrapper counts its kernel) against the times main and main_lm measured:
    (a) the ResNet-18 train step at batch 64 on an f32 batch, main's flags,
    against ``isolated_step_ms``, which times that step on such a batch
    (model FLOPs 3 x its counted forward); the ``ingest_norm`` epilogue
    counted apart (one launch at its registered bytes); (b) granite-8b-4l's
    train step at main_lm's shape: counted FLOPs over 6 N D (gated in
    [1.0, 2.5]), the live-bytes tracker's peak against
    ``max_memory_allocated()`` around one step on the card (gated in
    [0.75, 1.33]), and step_mfu (6 N D) and step_hfu from main_lm's median
    step after the first; (c) main_lm's flash eval pass over one batch:
    ``flash_attention`` counted once a layer at phase_flash's FLOPs
    (gated)."""
    import dataclasses

    from repro_torch.config import ShapeConfig, TrainConfig, get_arch
    from repro_torch.kernels.cost import for_card
    from repro_torch.launch import op_cost
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import resnet
    from repro_torch.models.counting import count_active_params
    from repro_torch.train.steps import make_eval_step, make_resnet_train_step, make_train_step

    # main's flags, stated: cuDNN convolutions in TF32, matmuls in fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    one = make_mesh((1, 1), ("data", "model"), ["cpu"])

    # (a) the ResNet path's step on the batch isolated_step_ms times, and
    # its ingest epilogue apart
    cfg = get_arch("resnet18-imagenet")
    tcfg = TrainConfig(optimizer="sgd")
    step, ingest = make_resnet_train_step(cfg, tcfg), ingest_ops.make_ingest_fn()
    B, H, W, C = MAIN_BATCH
    mode = op_cost.fake_mode()
    state = S.state_specs(cfg, tcfg, one, mode=mode)
    with mode, for_card():
        batch = {"image": torch.empty((B, C, H, W)),
                 "label": torch.zeros(B, dtype=torch.int64)}
        res = op_cost.count(step, state, batch)[1]
        with torch.no_grad():
            fwd = op_cost.count(lambda st, b: resnet.resnet_loss(
                st["params"], st["bn"], b, cfg, train=True), state, batch)[1]
        raw = {"image": torch.empty(MAIN_BATCH, dtype=torch.uint8),
               "label": torch.zeros(B, dtype=torch.int64)}
        epi = op_cost.count(ingest, raw)[1]
    a = {"arch": cfg.name, "batch": MAIN_BS, "image_dtype": "float32",
         "forward_flops": fwd.flops, "flops_over_3fwd": res.flops / (3 * fwd.flops),
         **roofline_row(card, res, main_out["isolated_step_ms"], 3 * fwd.flops),
         "ingest": {"kernels": epi.kernels, "bytes": epi.traffic_bytes,
                    "flops": epi.flops}}

    # (b) granite-8b-4l at main_lm's shape: the count, and one step on the card
    cfg = get_arch(LM_ARCH)  # registered by main_lm
    tcfg = TrainConfig(optimizer="adamw", microbatches=2)
    shape = ShapeConfig("main_lm", LM_SEQ, LM_BS, "train")
    mode = op_cost.fake_mode()
    state = S.state_specs(cfg, tcfg, one, mode=mode)
    batch = S.input_specs(cfg, shape, one, mode=mode)
    with mode, for_card():
        lm = op_cost.count(make_train_step(cfg, tcfg), state, batch)[1]
    del state, batch
    six_nd = 6.0 * count_active_params(cfg) * LM_BS * LM_SEQ
    card_step = measured_step_peak(torch, cfg, tcfg)
    b = {"arch": cfg.name, "batch": LM_BS, "seq": LM_SEQ, "microbatches": 2,
         "optimizer": "adamw", "model_flops_6nd": six_nd, "flops_over_6nd": lm.flops / six_nd,
         "predicted_peak_bytes": lm.peak_live_bytes, **card_step,
         "peak_ratio": lm.peak_live_bytes / card_step["measured_peak_bytes"],
         "adopted_bytes": lm.start_live_bytes,
         **roofline_row(card, lm, lm_out["step_ms_after_first_median"], six_nd)}

    # (c) main_lm's flash eval pass over one batch
    pallas = dataclasses.replace(cfg, attention_impl="pallas")
    mode = op_cost.fake_mode()
    params = S.param_specs_only(cfg, one, dtype=None, mode=mode)
    batch = S.input_specs(cfg, shape, one, mode=mode)
    with mode, for_card():
        ev = op_cost.count(make_eval_step(pallas), params, batch)[1]
    calls, flash_flops, flash_bytes = ev.per_op.get("kernel:flash_attention", (0, 0.0, 0.0))
    c = {"arch": cfg.name, "batch": LM_BS, "seq": LM_SEQ, "num_layers": cfg.num_layers,
         "kernels": ev.kernels, "flash_flops_per_call": flash_flops / max(calls, 1),
         "phase_flash_flops": flash_out["flops"], "flash_bytes_per_call":
         flash_bytes / max(calls, 1), "flops": ev.flops, "bytes": ev.traffic_bytes}
    out = {"phase": "main_roofline", "nvidia_smi": smi,
           "card": dataclasses.asdict(card) if card else None,
           "a_resnet_step": a, "b_lm_step": b, "c_flash_eval": c}
    emit(out)
    if a["kernels"] != {} or a["ingest"]["kernels"] != {"ingest_norm": 1}:
        fail(f"the ResNet step counted kernels {a['kernels']}, its epilogue "
             f"{a['ingest']['kernels']}, not none and one ingest_norm")
    if not 1.0 <= b["flops_over_6nd"] <= 2.5:
        fail(f"granite-8b-4l's counted FLOPs are {b['flops_over_6nd']:.3f} x 6ND")
    if not 0.75 <= b["peak_ratio"] <= 1.33:
        fail(f"predicted peak {lm.peak_live_bytes} against measured "
             f"{card_step['measured_peak_bytes']}")
    if c["kernels"] != {"flash_attention": cfg.num_layers} or \
            c["flash_flops_per_call"] != flash_out["flops"]:
        fail(f"flash eval counted {c['kernels']} at {c['flash_flops_per_call']} FLOPs a call")
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


def phase_wkv(torch, ops, ref, card) -> dict:
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
    # once; 5 D^2 flops a token and head, at the fp32 CUDA-core peak
    bounds = kernel_bounds(card, ops.cost(B, S, H, D))
    nbytes = bounds["bound_bytes"]
    out = {"phase": "kernels/rwkv6_wkv", "kernel": "rwkv6_wkv", "shape": list(WKV_SHAPE),
           "dtype": "float32", "max_abs_err": main_case["max_abs_err_y"], "cases": cases,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
           **bounds, "peak_fp32_flops": card.peak_flops["fp32"] if card else None,
           "kernel_gb_per_s": nbytes / kernel_ms / 1e6,
           "layout": ops.LAYOUT[D], "ptxas": ptxas_of(ops.build().log, r"wkv_kernel"),
           "occupancy": [ops.occupancy(d) for d in ops.HEAD_DIMS]}
    emit(out)
    return out


def phase_rmsnorm(torch, ops, ref, card) -> dict:
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
    # bf16 (or fp32) x read and y written once, fp32 scale
    bounds = kernel_bounds(card, ops.cost(RMS_SHAPE, torch.bfloat16, torch.float32))
    nbytes = bounds["bound_bytes"]
    bounds32 = kernel_bounds(card, ops.cost(RMS_SHAPE, torch.float32, torch.float32))
    out = {"phase": "kernels/rmsnorm", "kernel": "rmsnorm", "shape": list(RMS_SHAPE),
           "x_dtype": "bfloat16", "scale_dtype": "float32",
           "max_abs_err": main_case["max_abs_err"], "max_abs_err_fp32": main32["max_abs_err"],
           "cases": cases, "launches": launches,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "F.rms_norm(x, (d,), weight=scale, eps=1e-6)",
           "library_bf16_scale_ms": library_bf16_scale_ms, "kernel_fp32_ms": kernel32_ms,
           "bound_ms": bounds["bound_ms"], "bound_by": "bytes",
           "bound_bytes": nbytes, "bound_fp32_ms": bounds32["bound_ms"],
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
    if report.result.steps < RWKV_STEPS or report.result.epochs < 2:
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
    want_steps = int(train_args[train_args.index("--steps") + 1])
    if report.result.steps < want_steps or report.result.epochs < 2:
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
    served at full width, depth MLA_SERVE_LAYERS, through the launcher:
    (a) figures; (b) pooled against
    batch-1 decode; (c) a decode step against a cacheless forward; the
    absorbed decode against the expanded one (MLA_ABSORB_MAX_S = 0) on the
    engine's pooled cache at its per-slot positions; (e) chunked against
    single-pass prefill of SERVE_LONG tokens."""
    from repro_torch.config import register_arch, replace
    from repro_torch.configs import minicpm3_4b
    from repro_torch.models import layers, transformer

    report, train = train_family(torch, counted, minicpm3_4b, MLA_TRAIN_ARCH, MLA_TRAIN_ARGS,
                                 MLA_REDUCED, "main_mla")
    del report
    torch.cuda.empty_cache()
    register_arch(MLA_SERVE_ARCH,
                  lambda: replace(minicpm3_4b.full(), num_layers=MLA_SERVE_LAYERS),
                  minicpm3_4b.smoke)
    report, args, path = serve_path(torch, counted, MLA_SERVE_ARGS, smi, "main_mla",
                                    reduced=MLA_SERVE_REDUCED)
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
    on one full-width layer, then granite-moe-3b-a800m served at full width,
    depth MOE_SERVE_LAYERS (pooled held to batch-1: its decode capacity,
    max(int(8 * 8 / 40 * 1.25), 8) = 8, never drops) and qwen2-moe-a2.7b served whole (15.15 B parameters;
    pooled against batch-1 printed, not gated: its decode capacity is
    max(int(8 * 4 / 60 * 1.25), 4) = 4, so a pooled tick can drop an
    assignment that batch-1 keeps, as in the reference; the ticks where a
    live slot lost one are counted)."""
    from repro_torch.config import register_arch, replace
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

    register_arch(MOE_SERVE_ARCH,
                  lambda: replace(granite_moe_3b_a800m.full(), num_layers=MOE_SERVE_LAYERS),
                  granite_moe_3b_a800m.smoke)
    report, args, granite = serve_path(torch, counted, MOE_SERVE_ARGS, smi, "main_moe",
                                       reduced=MOE_SERVE_REDUCED)
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


def flash_at_model_shape(torch, cfg, flash_ops, flash_ref, card) -> dict:
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
    D = a.head_dim
    # q k^T and p v over the causal triangle; q, k, v read once, out written once
    bounds = kernel_bounds(card, flash_ops.cost(q.shape, k.shape, q.dtype))
    out = {"phase": "main_encdec", "check": "k_flash_shape", "shape": list(q.shape),
           "dtype": "bfloat16", "route": flash_ops.route(q.dtype, D), "max_abs_err": err,
           "tolerance": "2e-2 + 2e-2 * |plain|", "close": close,
           "kernel_ms": device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=True)),
           "plain_ms": device_ms(lambda: flash_ref.attention_ref(q, k, v, causal=True)),
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True)),
           **{key: bounds[key] for key in ("bound_ms", "bound_by", "flops", "bound_bytes")}}
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


def phase_main_encdec(torch, counted, smi: str, flash_ops, flash_ref, card) -> dict:
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
    shape = flash_at_model_shape(torch, cfg, flash_ops, flash_ref, card)
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
    from repro_torch.launch.roofline import card_peaks

    card = card_peaks(name)  # NVIDIA's data-sheet rates; None for a card it does not know
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "bandwidth_bytes_per_s": card.hbm_bytes_per_s if card else None,
          "peak_bf16_flops": card.peak_flops["bf16"] if card else None,
          "peak_fp32_flops": card.peak_flops["fp32"] if card else None,
          "card_peaks": dataclasses.asdict(card) if card else None})

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
    kern = phase_kernels(torch, ops, ref, card)
    flash = phase_flash(torch, flash_ops, flash_ref, card)
    wkv = phase_wkv(torch, wkv_ops, wkv_ref, card)
    rms = phase_rmsnorm(torch, rms_ops, rms_ref, card)
    torch.cuda.empty_cache()
    phase_model(torch)
    phase_model_lm(torch)
    phase_model_rwkv(torch)
    phase_model_families(torch)
    main_out = timed(torch, "main", phase_main, ops)
    pipe_out = timed(torch, "main_pipeline", phase_main_pipeline, ops, main_out, smi)
    auto_out = timed(torch, "main_autotune", phase_main_autotune, ops, main_out,
                     pipe_out["figures"]["pipeline"], smi)
    cache_out = timed(torch, "main_cache", phase_main_cache, ops, main_out, smi)
    formats_out = timed(torch, "main_formats", phase_main_formats, ops, pipe_out, smi)
    resume_out = timed(torch, "main_resume", phase_main_resume, ops, smi)
    dp_out = timed(torch, "main_dp", phase_main_dp, smi)
    lm_out = timed(torch, "main_lm", phase_main_lm, flash_ops, ops)
    timed(torch, "main_roofline", phase_main_roofline, ops, flash_ops, main_out, lm_out, flash,
          card, smi)
    rwkv_out = timed(torch, "main_rwkv", phase_main_rwkv, wkv_ops, wkv_ref, rms_ops, ops,
                     flash_ops)
    counted = {"ingest_norm": ops.ingest_norm, "flash_attention": flash_ops.flash_attention,
               "rwkv6_wkv": wkv_ops.wkv, "rmsnorm": rms_ops.rmsnorm}
    serve_out = timed(torch, "main_serve", phase_main_serve, counted, smi)
    mla_out = timed(torch, "main_mla", phase_main_mla, counted, smi)
    moe_out = timed(torch, "main_moe", phase_main_moe, counted, smi)
    hybrid_out = timed(torch, "main_hybrid", phase_main_hybrid, counted, smi)
    encdec_out = timed(torch, "main_encdec", phase_main_encdec, counted, smi, flash_ops,
                       flash_ref, card)
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
        "launches_cache_mb": cache_out["launches"]["cache_mb"],
        "launches_store_memory": cache_out["launches"]["store_memory"],
        "launches_two_tier": cache_out["tiers"]["ingest_norm_launches"],
        "launches_elastic": cache_out["elastic"]["ingest_norm_launches"],
        "launches_formats": formats_out["launches_total"],
        "launches_formats_by_part": formats_out["launches"],
        "launches_resume": resume_out["launches_resume"],
        "launches_sharded": resume_out["launches_sharded"],
        "launches_dp": dp_out["launches_total"],
        "launches_dp_by_run": dp_out["launches"],
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
