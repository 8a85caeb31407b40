"""Shared arithmetic of the readers of the train step's phases.

The program records, with its tracer on, inside each ``run_training_batch``
span (tagged ``step``): the step's device phases ``step_fwd_bwd`` (one a
microbatch), ``step_grad_reduce`` (under a process group) and
``step_optimizer``, on a card timed by CUDA events and mapped onto the
host's monotonic clock (``clock="device"``), and the host's ``step_sync``
(the metrics' ``.item()``); before each step the trainer's ``ring_wait``.
A program that records none of them gives every reader here ``None``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from benchlib import devtrace, readers

RING_WAIT = "ring_wait"
STEP_SYNC = "step_sync"
FWD_BWD = "step_fwd_bwd"
OPTIMIZER = "step_optimizer"
DEVICE_PHASES = (FWD_BWD, "step_grad_reduce", OPTIMIZER)

Interval = Tuple[float, float]


def _inside(run, s) -> bool:
    return s.t0 >= run.t0 and s.t1 <= run.t1


def window_steps(run) -> List:
    """The window's ``run_training_batch`` spans, in order."""
    return sorted((s for s in run.spans_named(readers.STEP_SPAN) if _inside(run, s)),
                  key=lambda s: s.t0)


def by_step(run, names: Sequence[str], device_clock: bool = False) -> Dict[int, List]:
    """The spans named in ``names`` of each window step that has any, by the
    trainer's step number (``device_clock``: those on the device's clock only)."""
    numbers = {s.args.get("step") for s in window_steps(run)}
    out: Dict[int, List] = {}
    for s in run.spans:
        if s.name in names and s.args.get("step") in numbers and (
                not device_clock or s.args.get("clock") == "device"):
            out.setdefault(s.args["step"], []).append(s)
    return out


def phase_ms(run, name: str) -> Optional[float]:
    """Milliseconds a step in the spans ``name`` (summed over a step's
    microbatches), mean over the window's steps that recorded it."""
    if readers.images(run):
        return None
    steps = by_step(run, (name,))
    if not steps:
        return None
    return 1e3 * sum(s.duration for ss in steps.values() for s in ss) / len(steps)


def ring_wait_ms(run) -> Optional[float]:
    if readers.images(run):
        return None
    return readers.mean_ms([s.duration for s in run.spans_named(RING_WAIT) if _inside(run, s)])


def covered_s(outer: Interval, spans: Sequence) -> float:
    """Seconds of ``outer`` that the spans cover."""
    a, b = outer
    return sum(y - x for x, y in devtrace.union(
        (max(s.t0, a), min(s.t1, b)) for s in spans))


def dispatch_ms(run) -> Optional[float]:
    """Mean self time of the window's ``run_training_batch`` spans less
    their ``step_sync`` child: the host's time to enqueue a step."""
    if readers.images(run):
        return None
    syncs = by_step(run, (STEP_SYNC,))
    steps = [s for s in window_steps(run) if s.args.get("step") in syncs]
    return readers.mean_ms([s.duration - covered_s((s.t0, s.t1), syncs[s.args["step"]])
                            for s in steps])


def intersection_s(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """Seconds in both of two lists of disjoint intervals, each in order."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_clock_gaps(run) -> List[Interval]:
    """The device trace's idle gaps on the host's clock, the trace's window
    stretched to the run's about its middle.  The harness maps the trace by
    one offset, the mean of its two marker kernels' (so the window's middle
    is where the mean puts it), but the trace's clock runs at another rate
    than the host's (6 to 210 ppm apart on the cards measured: up to 3 ms
    at a 30 s window's ends), while each step's spans are anchored to the
    host's clock anew."""
    trace = run.trace
    mid = (trace.t0 + trace.t1) / 2
    scale = (run.t1 - run.t0) / trace.window_s
    return [(mid + (a - mid) * scale, mid + (b - mid) * scale) for a, b in trace.idle_gaps()]


def launch_idle_ms(run) -> Optional[float]:
    """Device idle a step inside the union of that step's device phase
    spans: the gaps between consecutive kernels, and the device waiting
    for the host's launches mid-phase.  The rest of the window's idle lies
    between phases and between steps."""
    if readers.images(run) or run.trace is None:
        return None
    steps = by_step(run, DEVICE_PHASES, device_clock=True)
    if not steps:
        return None
    gaps = host_clock_gaps(run)
    idle = sum(intersection_s(devtrace.union((s.t0, s.t1) for s in ss), gaps)
               for ss in steps.values())
    return 1e3 * idle / len(steps)
