"""Shared arithmetic of the metric readers in ``metrics/``."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from benchlib import arith

STEP_SPAN = "run_training_batch"


def images(run) -> bool:
    return run.cfg["family"] == "resnet"


def items_per_s(run) -> Optional[float]:
    if not images(run) or run.window_s <= 0:
        return None
    return run.steps * run.items_per_step / run.window_s


def cpu_stage_ms(run) -> Optional[float]:
    if not images(run):
        return None
    decode = window_spans_s(run, "stage_decode")
    augment = window_spans_s(run, "stage_augment")
    if not decode:
        return None
    return 1e3 * (sum(decode) + sum(augment)) / len(decode)


def step_gaps_s(run) -> List[float]:
    """Seconds between one step span's end and the next one's start, for
    consecutive steps inside the window: the trainer's wait for a batch."""
    steps = sorted((s for s in run.spans_named(STEP_SPAN)
                    if s.t0 >= run.t0 and s.t1 <= run.t1), key=lambda s: s.t0)
    return [b.t0 - a.t1 for a, b in zip(steps, steps[1:])]


def mean_ms(xs: List[float]) -> Optional[float]:
    return 1e3 * float(np.mean(xs)) if xs else None


def p95_ms(xs: List[float]) -> Optional[float]:
    return 1e3 * float(np.percentile(xs, 95)) if xs else None


def window_spans_s(run, name: str) -> List[float]:
    return [s.t1 - s.t0 for s in run.spans_named(name) if s.t0 >= run.t0 and s.t1 <= run.t1]


def model_flops_per_step(run) -> float:
    if images(run):
        return arith.resnet_train_flops_per_image(run.cfg) * run.items_per_step
    seq = run.traffic["tokens"]["seq_len"]
    return arith.decoder_train_flops_per_token(run.cfg, seq) * run.tokens_per_step


def peak_flops(run) -> float:
    if images(run):
        return arith.PEAK_FLOPS[run.cfg["precision"]["compute"]]
    return arith.PEAK_FLOPS[{"bfloat16": "bf16", "float32": "fp32"}[run.cfg["torch_dtype"]]]


def step_mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the window's steps over their own time times the peak:
    the summed ``run_training_batch`` spans, each of which ends in the
    trainer's ``.item()`` and so covers the step's device work, while the
    waits for a batch between spans are left out."""
    steps = window_spans_s(run, STEP_SPAN)
    if not steps or sum(steps) <= 0:
        return None
    return 100.0 * len(steps) * model_flops_per_step(run) / (sum(steps) * peak_flops(run))


def device_idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
