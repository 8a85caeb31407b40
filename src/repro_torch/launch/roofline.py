"""Roofline of a counted program on one card (the counterpart of the
reference's ``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = sum over compute classes of FLOPs / the class's peak
    memory     = bytes / the card's memory rate
    collective = wire bytes / the card's NVLink rate, one way

The FLOPs and bytes come from :mod:`repro_torch.launch.op_cost`, which
counts the aten ops and kernels the port dispatches.  A compute class is
where the card does the work: ``"bf16"`` (tensor cores in bf16 or fp16),
``"tf32"`` (tensor cores on fp32 inputs with TF32 allowed) and ``"fp32"``
(the CUDA cores).  One peak for all of them would be wrong by up to 15x
on this card.

The card constants are NVIDIA's data-sheet figures (H100 Tensor Core GPU
data sheet; H200 data sheet): dense rates (no structured sparsity), the
SXM parts at 700 W, the PCIe and NVL parts at their board power.  A card
runs slower under a lower power limit, so every time derived from these
is a bound at the data-sheet clocks.  Collective wire bytes use the ring
factors of the reference's ``parse_collectives``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class CardPeaks:
    name: str
    hbm_bytes_per_s: float  # device memory rate
    peak_flops: Dict[str, float]  # compute class -> dense FLOP/s
    hbm_bytes: float  # device memory size
    nvlink_bytes_per_s: float  # NVLink rate one way, for the collective term


# First key found in the card's name wins ("NVIDIA H100 80GB HBM3" is the
# SXM part, so "H100" comes last).
CARDS: Tuple[Tuple[str, CardPeaks], ...] = (
    ("H200", CardPeaks("H200 SXM", 4.8e12,
                       {"bf16": 989.4e12, "tf32": 494.7e12, "fp32": 67e12}, 141e9, 450e9)),
    ("H100 NVL", CardPeaks("H100 NVL", 3.9e12,
                           {"bf16": 835.5e12, "tf32": 417.5e12, "fp32": 60e12}, 94e9, 300e9)),
    ("H100 PCIe", CardPeaks("H100 PCIe", 2.0e12,
                            {"bf16": 756.5e12, "tf32": 378e12, "fp32": 51e12}, 80e9, 300e9)),
    ("H100", CardPeaks("H100 SXM", 3.35e12,
                       {"bf16": 989.4e12, "tf32": 494.7e12, "fp32": 67e12}, 80e9, 450e9)),
)
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"  # the card the port runs on


def card_peaks(name: str) -> Optional[CardPeaks]:
    """The card's constants, or None for a card the table does not know:
    no other card's number is quoted for it."""
    for key, peaks in CARDS:
        if key in name:
            return peaks
    return None


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Wire bytes a device sends for one collective whose result is
    ``nbytes``, over a group of ``group`` (ring algorithm, as the
    reference's ``parse_collectives``):

      all-gather:          N * (g-1)/g     (result is the gathered tensor)
      reduce-scatter:      N * g * (g-1)/g (result is the scattered shard)
      all-reduce:          2N * (g-1)/g    (RS + AG)
      all-to-all:          N * (g-1)/g
      collective-permute:  N
    """
    if group <= 1 and kind != "collective-permute":
        return 0.0  # a single participant sends nothing
    frac = (group - 1) / group if group > 1 else 1.0
    if kind == "all-gather":
        return nbytes * frac
    if kind == "reduce-scatter":
        return nbytes * group * frac
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind == "all-to-all":
        return nbytes * frac
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclass
class Roofline:
    flops_by_class: Dict[str, float]  # per device
    hbm_bytes_per_device: float
    wire_bytes_per_device: Optional[float]  # None where not counted
    model_flops_total: float
    num_devices: int
    card: CardPeaks = field(default_factory=lambda: card_peaks(DEFAULT_CARD))

    @property
    def flops_per_device(self) -> float:
        return sum(self.flops_by_class.values())

    @property
    def t_compute_by_class(self) -> Dict[str, float]:
        return {c: f / self.card.peak_flops[c] for c, f in sorted(self.flops_by_class.items())}

    @property
    def t_compute(self) -> float:
        return sum(self.t_compute_by_class.values())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / self.card.hbm_bytes_per_s

    @property
    def t_collective(self) -> Optional[float]:
        if self.wire_bytes_per_device is None:
            return None
        return self.wire_bytes_per_device / self.card.nvlink_bytes_per_s

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        if self.t_collective is not None:
            terms["collective"] = self.t_collective
        return terms

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x devices): << 1 means recompute or
        work beyond the model's dominates; a little over 1 where the program
        skips work the formula counts (a first layer's input gradient)."""
        total = self.flops_per_device * self.num_devices
        return self.model_flops_total / total if total else float("nan")

    @property
    def mfu_upper_bound(self) -> float:
        """Roofline MFU: the useful share of the counted FLOPs times the
        share of the bound the compute term takes; with one compute class,
        model FLOPs / (devices x peak x bound time), the reference's."""
        if not self.bound_time:
            return float("nan")
        return self.useful_flops_fraction * self.t_compute / self.bound_time

    def row(self) -> Dict[str, object]:
        return {
            "t_compute_s": self.t_compute,
            "t_compute_by_class_s": self.t_compute_by_class,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_mfu": self.mfu_upper_bound,
            "card": self.card.name,
        }


def bound_ms(nbytes: float, flops: float, card: Optional[CardPeaks],
             compute_class: str = "bf16") -> Tuple[Optional[float], str]:
    """(least time in ms, what bounds it) of one piece of work: the larger
    of ``nbytes`` over the memory rate and ``flops`` over the class's peak;
    None where the card is unknown."""
    by = "operations" if flops else "bytes"
    if card is None:
        return None, by
    t_bytes = nbytes / card.hbm_bytes_per_s * 1e3
    t_ops = flops / card.peak_flops[compute_class] * 1e3 if flops else 0.0
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def step_hfu(flops_by_class: Dict[str, float], step_s: float,
             card: Optional[CardPeaks]) -> Optional[float]:
    """Hardware-FLOP utilisation of a measured step: every counted FLOP
    (recompute included) over (its class's peak x step time), summed over
    classes."""
    if card is None or not step_s:
        return None
    return sum(f / card.peak_flops[c] for c, f in flops_by_class.items()) / step_s


def step_mfu(model_flops: float, flops_by_class: Dict[str, float], step_s: float,
             card: Optional[CardPeaks]) -> Optional[float]:
    """Model-FLOP utilisation of a measured step: the useful share of the
    counted FLOPs (``model_flops`` over them) times :func:`step_hfu`; with
    one compute class, model FLOPs over (peak x step time), the usual MFU
    and :attr:`Roofline.mfu_upper_bound`'s numerator."""
    hfu = step_hfu(flops_by_class, step_s, card)
    counted = sum(flops_by_class.values())
    if hfu is None or not counted:
        return None
    return model_flops / counted * hfu

