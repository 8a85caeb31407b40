"""Serving launcher: continuous batching over a registered architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --device cpu \
        --smoke --requests 32 --slots 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --full

Submits a synthetic request burst to the ServeEngine (slot-pooled KV cache,
per-slot prefill, pooled decode; slots refill as requests finish) and prints
per-request TTFT / total latency plus engine throughput.  The flags and
defaults are the reference's (``repro/launch/serve.py``), with ``--device``
(default ``cuda``, which raises when no card is present).  Weights are
random, drawn from ``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, ServeSpec, get_arch
from repro_torch.device import resolve_device
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.steps import init_params_for


@dataclass
class ServeReport:
    cfg: ModelConfig
    engine: ServeEngine
    done: List[Request]
    wall_s: float  # submit of the first request to the drain
    tokens_per_s: float  # engine.tokens_generated / wall_s, as the reference prints it


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> ServeReport:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    params = init_params_for(cfg, torch.Generator(device).manual_seed(args.seed), device)
    engine = ServeEngine(cfg, params, spec=ServeSpec(num_slots=args.slots,
                                                     max_len=args.max_len), device=device)

    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for _ in range(args.requests):
        n = int(rng.integers(2, args.prompt_len + 1))
        engine.submit(rng.integers(1, cfg.vocab_size, size=n),
                      max_new_tokens=args.max_new)
    done = engine.run_until_drained()
    wall = time.monotonic() - t0

    ttfts = sorted((r.t_first_token - r.t_submit) for r in done)
    totals = sorted((r.t_done - r.t_submit) for r in done)
    toks = engine.tokens_generated
    print(f"arch={cfg.name} slots={args.slots} requests={len(done)} "
          f"ticks={engine.ticks} device={device}")
    print(f"throughput: {toks / wall:.1f} tok/s ({toks} tokens in {wall:.1f}s)")
    print(f"ttft   p50={ttfts[len(ttfts) // 2] * 1e3:.0f}ms "
          f"p95={ttfts[int(0.95 * len(ttfts))] * 1e3:.0f}ms")
    print(f"total  p50={totals[len(totals) // 2] * 1e3:.0f}ms "
          f"p95={totals[int(0.95 * len(totals))] * 1e3:.0f}ms", flush=True)
    if not all(r.output for r in done):
        raise RuntimeError("some requests produced no tokens")
    return ServeReport(cfg, engine, done, wall, toks / wall)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
