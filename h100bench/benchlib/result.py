"""The result line and the compared numbers beside their limits."""
from __future__ import annotations

import math
import sys
from typing import Dict

from benchlib import check, devtrace
from benchlib.manifest import Cell, read_metrics


def result_line(cell: Cell, out: Dict, trace: bool, card: Dict) -> Dict:
    record = out["record"]
    device = dict(card, memory_peak_bytes=int(out["memory_peak_bytes"]))
    line = {
        "correct": check.passed(out["numbers"]),
        "attempted": record.steps,
        "failed": 0,
        "metrics": read_metrics(cell, record, trace),
        "device": device,
    }
    if trace and record.trace is not None:
        device["busy_s"] = record.trace.busy_s()
        device["window_s"] = record.trace.window_s
        line["breakdown"] = {
            "device_ops": record.trace.top_ops(10),
            "idle_gaps": devtrace.name_gaps(record.trace.idle_gaps(), record.spans, 10),
        }
    # JSON has no infinity: a number that is not finite is written as 1e300
    line["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else 1e300,
                          "limit": c["limit"]} for k, c in out["numbers"].items()}
    return line


def print_checks(numbers: Dict[str, Dict[str, float]]) -> None:
    for name, c in numbers.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct: {check.passed(numbers)}", file=sys.stderr, flush=True)
