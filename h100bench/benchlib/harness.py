"""One run of one cell: set-up, the measured window, the check.

Set-up builds the program once, drives it from the seed through its first
steps (the checked steps among them) and hands the same trainer, loader
and state to the window, which opens once ``bench.warmup_steps`` steps
have completed and closes at the first step to complete ``--seconds``
later.  Every step's loss is read with ``.item()`` by the trainer, so a
step that completed on the host has completed on the device.  After the
window the program is freed and the reference follows the checked steps.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from benchlib import check, devtrace
from benchlib.manifest import Cell
from benchlib.program import Program, make_inputs
from repro_torch.train.trainer import Callback


class StopWindow(Exception):
    """Raised by the window's callback to end ``Trainer.fit``."""


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: str
    cfg: Dict
    traffic: Dict
    setup_s: float
    t0: float  # window, host monotonic clock
    t1: float
    steps: int  # steps completed in the window
    items_per_step: int
    tokens_per_step: int
    spans: List[Any] = field(default_factory=list)  # the program's, in the window
    trace: Optional[devtrace.DeviceTrace] = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def spans_named(self, name: str) -> List[Any]:
        return [s for s in self.spans if s.name == name]


class Window(Callback):
    def __init__(self, seconds: float, warmup: int, probe: check.Probe,
                 trace_path: Optional[Path], device: torch.device) -> None:
        self.seconds, self.warmup, self.probe = seconds, warmup, probe
        self.trace_path, self.device = trace_path, device
        self.cuda = device.type == "cuda"
        self.t0 = self.t1 = 0.0
        self.step0 = self.steps = 0
        self.marks: List[float] = []
        self.prof = None
        self.step_ends: List[float] = []  # host clock at each step's end

    def on_train_batch_start(self, trainer, batch, idx) -> None:
        self.probe.batch(trainer.global_step, batch)

    def _mark(self) -> None:
        """A marker kernel on an idle device, and the host's time of its launch."""
        torch.cuda.synchronize(self.device)
        self.marks.append(time.monotonic())
        torch.cuda._sleep(devtrace.MARKER_CYCLES)
        torch.cuda.synchronize(self.device)

    def on_train_batch_end(self, trainer, metrics, idx) -> None:
        n = trainer.global_step
        self.step_ends.append(time.monotonic())
        self.probe.after(n, trainer.state, metrics)
        if n == self.warmup:
            if self.cuda:
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
                if self.prof is not None:
                    self._mark()
            self.t0, self.step0 = time.monotonic(), n
        elif n > self.warmup and time.monotonic() - self.t0 >= self.seconds:
            self.t1, self.steps = time.monotonic(), n - self.step0
            if self.prof is not None:
                self._mark()
                self.prof.stop()
                self.trace_path.parent.mkdir(parents=True, exist_ok=True)
                self.prof.export_chrome_trace(str(self.trace_path))
                self.prof = None
            raise StopWindow


def apply_precision(cfg: Dict) -> None:
    p = cfg.get("precision", {})
    torch.backends.cudnn.allow_tf32 = bool(p.get("cudnn_allow_tf32", True))
    torch.backends.cuda.matmul.allow_tf32 = bool(p.get("matmul_allow_tf32", False))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, trace_dir: Optional[Path] = None,
        fault: Optional[Callable[[Program], None]] = None) -> Dict:
    """One run: the window's record, the numbers compared and the device's
    peak memory.  ``fault`` plants a fault in the built program (tests only).
    Prints the set-up's phases and the window's steps by 5 s slice to
    standard error."""
    cfg = cell.config
    apply_precision(cfg)
    bench = cfg["bench"]
    phases = {"imports": time.monotonic() - t_start}
    t = time.monotonic()
    inputs = make_inputs(cfg, cell.traffic, seed)
    phases["inputs"] = time.monotonic() - t
    probe = check.Probe(cfg, bench["checked_steps"], seed, device)
    trace_path = (trace_dir / f"{cell.name}-{seed}.json") if trace else None
    window = Window(seconds, bench["warmup_steps"], probe, trace_path, device)
    t = time.monotonic()
    prog = Program(cfg, cell.traffic, seed, inputs, device, [window], traced=trace)
    phases["program"] = time.monotonic() - t
    t = time.monotonic()
    prog.warm()
    if trace_path is not None:
        # started before the loader is, so the profiler's own start-up (seconds
        # on the card) does not let the loader run ahead of the first steps
        window.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        window.prof.start()
    phases["warm"] = time.monotonic() - t
    if fault is not None:
        fault(prog)
    try:
        prog.fit()
        raise RuntimeError("training ended before the window closed")
    except StopWindow:
        pass
    finally:
        prog.close()
    if window.t0 == 0.0:
        raise RuntimeError("the window never opened")
    ends = window.step_ends
    phases["first_step"] = ends[0] - t - phases["warm"]
    phases["later_warmup_steps"] = [b - a for a, b in zip(ends, ends[1:window.step0])]
    print(f"setup phases (s): {phases}", file=sys.stderr, flush=True)
    slices = [0] * max(1, int(window.t1 - window.t0) // 5)
    for e in ends[window.step0:]:
        slices[min(int((e - window.t0) // 5), len(slices) - 1)] += 1
    print(f"window steps by 5 s slice: {slices[:-1]} + {slices[-1]} in the rest",
          file=sys.stderr, flush=True)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    spans = [s for s in prog.tracer.spans() if s.t1 >= window.t0 and s.t0 <= window.t1]
    images = cfg["family"] == "resnet"
    spec = cell.traffic["images" if images else "tokens"]
    record = RunRecord(
        cell.name, cfg, cell.traffic, window.t0 - t_start, window.t0, window.t1, window.steps,
        spec["batch"], 0 if images else spec["batch"] * spec["seq_len"], spans)
    if trace_path is not None:
        record.trace = devtrace.load(trace_path, (window.marks[0], window.marks[1]))
        trace_path.unlink()  # hundreds of MB a run; the record keeps what is read
    # the program's state is freed before the reference runs
    del prog, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(cfg, cell.traffic, seed, device, probe, inputs)
    return {"record": record, "numbers": numbers, "memory_peak_bytes": memory_peak}
