"""How ``correct`` is decided: the program's first steps against the reference.

The probe reads, through the window's own call and feed, what the first
``checked_steps`` steps received (the ingested image batch and labels, or
the tokens and targets), each step's loss, the first moment of the
optimizer after step 1 (the gradient as the optimizer got it: clipped,
and for SGD plus the weight decay) and the change of every parameter and
BatchNorm statistic after the last checked step, before the next one
runs.  It also keeps what the window's last step received, where the
recycled staging buffers and the device ring are in steady use.  The
reference works all of it out again from the seed's data and weights, in
float32 with TF32 off, and the numbers compared are:

* ``input_gap``: the largest absolute difference of an ingested pixel;
  ``label_mismatch`` / ``token_mismatch``: labels or tokens that differ,
  over the checked steps and the window's last step;
* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``, ``change_gap``, ``bn_gap``: by the worst leaf, the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.  A stacked layer
  leaf counts a layer at a time.  ``change_gap`` leaves out leaves whose
  reference gradient is under a thousandth of the median leaf's.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from benchlib import weights as W
from reference import data as RD
from reference import decoder as RDEC
from reference import optim as ROPT
from reference import resnet as RRES

LAYER_PREFIX = "blocks/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of nested dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


@torch.no_grad()
def leaf_norms(tensors: Dict[str, torch.Tensor], stacked: bool) -> Dict[str, float]:
    """Float32 norm of every leaf; with ``stacked``, a layer leaf's layers apart."""
    out: Dict[str, float] = {}
    for path, t in tensors.items():
        t = t.detach().float()
        if stacked and path.startswith(LAYER_PREFIX):
            for i, part in enumerate(t.unbind(0)):
                out[f"{path}[{i}]"] = part.norm().item()
        else:
            out[path] = t.norm().item()
    return out


@dataclass
class Readings:
    """One side's readings of the checked steps."""

    inputs: List[Any] = field(default_factory=list)  # per step: (x, labels) or (tokens, targets)
    losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)
    bn_norms: Dict[str, float] = field(default_factory=dict)
    window_step: Optional[int] = None  # the window's last step, and what it received
    window_inputs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class Probe:
    """The program's readings, taken from the trainer's callbacks."""

    def __init__(self, cfg: Dict, steps: int, seed: int, device: torch.device) -> None:
        self.cfg, self.steps, self.seed, self.device = cfg, steps, seed, device
        self.images = cfg["family"] == "resnet"
        self.got = Readings()

    def batch(self, step: int, batch: Dict[str, torch.Tensor]) -> None:
        keys = ("image", "label") if self.images else ("tokens", "targets")
        if step < self.steps:
            self.got.inputs.append(tuple(batch[k].detach().to("cpu", copy=True) for k in keys))
        else:
            # a copy on the device, each step replacing the last: the host
            # reads only the window's last step, once the window has closed
            self.got.window_step = step
            self.got.window_inputs = tuple(batch[k].detach().clone() for k in keys)

    def after(self, n: int, state: Dict, metrics: Dict[str, float]) -> None:
        if n > self.steps:
            return
        self.got.losses.append(float(metrics["loss"]))
        stacked = not self.images
        if n == 1:
            moment = state["opt"]["m" if self.images else "mu"]
            self.got.grad_norms = leaf_norms(_flatten(moment), stacked)
        if n == self.steps:
            params = _flatten(state["params"])
            p_leaves, s_leaves = ((W.resnet_leaves(self.cfg)) if self.images
                                  else (W.decoder_leaves(self.cfg), []))
            start = W.draw(p_leaves, self.seed, self.device)
            self.got.change_norms = leaf_norms(
                {k: params[k].detach() - start.pop(k) for k in list(start)}, stacked)
            del start
            if s_leaves:
                stats = _flatten(state["bn"])
                s0 = W.draw(s_leaves, self.seed, self.device)
                self.got.bn_norms = leaf_norms({k: stats[k] - s0[k] for k in s0}, False)


# -- the reference ------------------------------------------------------------


def _no_tf32():
    class Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

        def __exit__(self, *exc):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
    return Ctx()


def reference_readings(cfg: Dict, traffic: Dict, seed: int, device: torch.device,
                       inputs: Any, steps: int, precision: str = "float32",
                       fault: str = "") -> Readings:
    """The reference's readings of the first ``steps`` steps, at float32 or at
    the control's precision ("bfloat16" for the ResNet, "fp8" for the
    decoder).  ``fault`` plants one of the faults a check has to catch:
    "half_batch" (the loss a mean over the batch's first half) or
    "altered" (one label or target token changed where the batch is made,
    so the step trains on it and the probe reads it)."""
    with _no_tf32():
        if cfg["family"] == "resnet":
            return _resnet(cfg, traffic, seed, device, inputs, steps, precision, fault)
        return _decoder(cfg, traffic, seed, device, inputs, steps, precision, fault)


def _half(x: torch.Tensor, fault: str) -> torch.Tensor:
    return x[: x.shape[0] // 2] if fault == "half_batch" else x


def _alter(y: torch.Tensor, fault: str, modulus: int) -> torch.Tensor:
    if fault != "altered":
        return y
    y = y.clone()
    y.view(-1)[0] = (y.view(-1)[0] + 1) % modulus
    return y


def step_inputs(cfg: Dict, traffic: Dict, seed: int, inputs: Any, step: int,
                dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """What step ``step`` should receive, on the CPU: the ingested images and
    labels, or the tokens and targets."""
    if cfg["family"] == "resnet":
        spec = traffic["images"]
        u8, labels = RD.image_batch(inputs.pixels, inputs.labels, inputs.keys, spec["batch"],
                                    seed, step, cfg["image_size"])
        return RD.normalize(u8, dtype), torch.from_numpy(labels)
    toks, tgts = RD.token_batch(inputs.tokens, traffic["tokens"]["batch"], seed, step)
    return (torch.from_numpy(np.ascontiguousarray(toks)),
            torch.from_numpy(np.ascontiguousarray(tgts)))


def _resnet(cfg, traffic, seed, device, pool, steps, precision, fault) -> Readings:
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    p_leaves, s_leaves = W.resnet_leaves(cfg)
    P = {k: v.requires_grad_(True) for k, v in W.draw(p_leaves, seed, device).items()}
    S = W.draw(s_leaves, seed, device)
    opt = cfg["optimizer"]
    state = ROPT.init_state(opt, P)
    out = Readings()
    names = list(P)
    for step in range(steps):
        x, y = step_inputs(cfg, traffic, seed, pool, step, dtype)
        y = _alter(y, fault, cfg["num_classes"])
        out.inputs.append((x.float(), y))
        xd, yd = _half(x.to(device), fault), _half(y.to(device), fault)
        loss, S = RRES.loss(cfg, P, S, xd, yd, dtype)
        grads = dict(zip(names, torch.autograd.grad(loss, [P[n] for n in names])))
        out.losses.append(loss.item())
        ROPT.update(opt, state, P, grads, step)
        if step == 0:
            out.grad_norms = leaf_norms(state["m"], False)
    start = W.draw(p_leaves, seed, device)
    out.change_norms = leaf_norms({k: P[k].detach() - start[k] for k in P}, False)
    s0 = W.draw(s_leaves, seed, device)
    out.bn_norms = leaf_norms({k: S[k] - s0[k] for k in S}, False)
    return out


def _decoder(cfg, traffic, seed, device, tokset, steps, precision, fault) -> Readings:
    spec = traffic["tokens"]
    leaves = W.decoder_leaves(cfg)
    P = W.draw(leaves, seed, device)
    opt = cfg["optimizer"]
    state = ROPT.init_state(opt, P)
    out = Readings()
    for step in range(steps):
        t, y = step_inputs(cfg, traffic, seed, tokset, step)
        y = _alter(y, fault, cfg["vocab_size"])
        out.inputs.append((t, y))
        td, yd = _half(t.to(device), fault), _half(y.to(device), fault)
        mb = spec["microbatches"] if td.shape[0] % spec["microbatches"] == 0 else 1
        loss, grads = RDEC.grads(cfg, P, td, yd, mb, fp8=precision == "fp8")
        out.losses.append(loss)
        ROPT.update(opt, state, P, grads, step)
        del grads
        if step == 0:
            out.grad_norms = leaf_norms(state["m"], True)
    del state
    start = W.draw(leaves, seed, device)
    out.change_norms = leaf_norms({k: P[k] - start.pop(k) for k in list(P)}, True)
    return out


# -- the comparison -----------------------------------------------------------


def _worst(gaps: Iterable[float]) -> float:
    """The largest gap; a NaN reads as infinitely far."""
    return max((g if math.isfinite(g) else math.inf for g in gaps), default=0.0)


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    if not ref:
        return 0.0
    if set(got) != set(ref):
        return math.inf
    floor = statistics.median(ref.values())
    return _worst(abs(got[k] - ref[k]) / max(ref[k], floor) for k in ref
                  if keep is None or k in keep)


def numbers(cfg: Dict, got: Readings, ref: Readings, steps: int) -> Dict[str, float]:
    """The numbers compared, of ``got`` (the program, or a control) against
    the reference."""
    out: Dict[str, float] = {}
    seen = min(len(got.inputs), len(got.losses))
    if seen != steps:
        return {"checked_steps_missing": float(steps - seen)}
    pairs = list(zip(got.inputs, ref.inputs))
    if ref.window_inputs is not None:
        pairs.append((tuple(t.cpu() for t in got.window_inputs), ref.window_inputs))
    if cfg["family"] == "resnet":
        gaps, mismatch = [], 0
        for (x, y), (xr, yr) in pairs:
            if x.shape != xr.shape or y.shape != yr.shape:
                return {"input_shape": math.inf}
            gaps.append((x.float() - xr).abs().max().item())  # a NaN pixel reads NaN
            mismatch += int((y.long() != yr.long()).sum())
        out["input_gap"] = _worst(gaps)
        out["label_mismatch"] = float(mismatch)
    else:
        mismatch = 0
        for (t, y), (tr, yr) in pairs:
            if t.shape != tr.shape or y.shape != yr.shape:
                return {"input_shape": math.inf}
            mismatch += int((t.long() != tr.long()).sum() + (y.long() != yr.long()).sum())
        out["token_mismatch"] = float(mismatch)
    out["loss_gap"] = _worst(abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses))
    out["grad_gap"] = _leaf_gap(got.grad_norms, ref.grad_norms)
    floor = statistics.median(ref.grad_norms.values()) if ref.grad_norms else 0.0
    moved = {k for k, v in ref.grad_norms.items() if v >= 1e-3 * floor}
    out["change_gap"] = _leaf_gap(got.change_norms, ref.change_norms, moved)
    if cfg["family"] == "resnet":
        out["bn_gap"] = _leaf_gap(got.bn_norms, ref.bn_norms)
    return out


def compare(cfg: Dict, traffic: Dict, seed: int, device: torch.device, probe: Probe,
            inputs: Any) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` of the program against the reference."""
    steps = cfg["bench"]["checked_steps"]
    ref = reference_readings(cfg, traffic, seed, device, inputs, steps)
    if probe.got.window_step is None:
        return {"window_step_missing": {"value": math.inf, "limit": 0.0}}
    ref.window_inputs = step_inputs(cfg, traffic, seed, inputs, probe.got.window_step)
    limits = cfg["check_limits"]
    got = numbers(cfg, probe.got, ref, steps)
    return {k: {"value": v, "limit": limits.get(k, 0.0)} for k, v in got.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
