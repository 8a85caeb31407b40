"""Frozen-dataclass configuration for the port's slices, and the arch registry.

A trimmed copy of ``repro/config.py``: only the fields the ResNet, dense
decoder (LM, with gqa/mha or mla attention, and MoE FFNs, and the VLM
stub's patch prefix), RWKV-6, hybrid (Mamba-1 with attention, jamba) and
encoder-decoder (whisper) slices read, with the reference's
names and defaults (``LoaderConfig`` drops ``pin_device`` and
``device_prefetch``, which the reference declares but never reads; the
ring's depth is ``Trainer(device_prefetch=...)``; ``RWKVConfig`` drops
``token_shift`` and ``MoEConfig`` drops ``router_jitter``, for the same
reason).  ``LoaderConfig`` keeps the
reference's warn-once flat-kwarg shim (``pipeline=True, reorder=...``
folded into :class:`PipelineConfig`).  ``PipelineConfig`` has no
``transport`` or slab fields until the shared-memory transport is ported,
and :class:`AutotuneConfig` no field of a feature the port lacks (the
multi-host lease and shedding, cache knobs, slab knob, lane-skew gate,
serving bounds).  :class:`ServeSpec` sizes the serving engine only; the
reference's read-path fields come with its read path.  ``replace()``
(from dataclasses) derives variants.
"""
from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    """Attention flavour. kind: mha | gqa | mla."""

    kind: str = "gqa"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    # MLA (multi-head latent attention, MiniCPM3/DeepSeek style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    causal: bool = True
    rope: bool = True
    rope_theta: float = 10_000.0

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k mixture of experts."""

    num_experts: int = 8
    top_k: int = 2
    expert_d_ff: int = 512
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    load_balance_coef: float = 0.01
    # dispatch: "einsum" (dense one-hot (g, E, C) dispatch and combine
    # tensors) or "gather" (tokens scattered into the (E, C) expert buffer
    # and gathered back); the two give the same result
    dispatch: str = "einsum"
    # token-group size for routing: capacity is set per group
    group_size: int = 4096
    # pad the stacked expert weights to this count (0 = no padding);
    # padded experts receive no tokens
    pad_experts_to: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective scan (for jamba) — d_inner = expand * d_model."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 'Finch' data-dependent decay."""

    head_dim: int = 64
    decay_lora: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"  # decoder | encdec | resnet | rwkv | hybrid
    num_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32_000
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # hybrid (jamba): per-layer mixer pattern, period repeats over num_layers.
    # entries: "attn" | "mamba"; moe_every_k: every k-th layer uses MoE MLP.
    hybrid_attn_period: int = 0  # 0 = not hybrid; jamba: 8 with attn at index 3
    hybrid_attn_index: int = 3
    moe_every_k: int = 0  # 0 = never; jamba: 2
    # enc-dec
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0  # whisper: 1500 frames
    # vlm stub
    num_patch_tokens: int = 0  # internvl: 1024 patch embeddings
    frontend_dim: int = 0  # dim of precomputed frontend embeddings (0 = d_model)
    # resnet
    resnet_blocks: Tuple[int, ...] = ()
    resnet_width: int = 64
    num_classes: int = 1000
    image_size: int = 224
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    # which attention implementation the model uses: "ref" (plain PyTorch)
    # or "pallas" (the reference's name; here the hand-written flash kernel)
    attention_impl: str = "ref"


@dataclass(frozen=True)
class StoreConfig:
    kind: str = "s3sim"  # memory | s3sim
    # SimulatedS3 latency model (lognormal)
    latency_mean_s: float = 0.08
    latency_sigma: float = 0.5
    bandwidth_per_conn: float = 25e6  # bytes/s per connection
    nic_bandwidth: float = 1.2e9  # bytes/s aggregate
    max_connections: int = 256
    failure_rate: float = 0.0
    # congestion-collapse exponent when the NIC is oversubscribed (0 = off)
    overload_penalty: float = 0.0


@dataclass(frozen=True)
class AutotuneConfig:
    """Closed-loop knob control for the loader (online analogue of the
    paper's Fig. 10/11 grid search).

    A hill-climbing controller with hysteresis observes windowed throughput
    and adjusts, at a safe between-batch boundary: per-worker fetch
    concurrency, the prefetch outstanding window, the staged pipeline's
    stage widths and queue depth, hedging on/off, and (when attached) the
    device prefetch ring depth.  All knobs are clamped to the bounds below.
    """

    enabled: bool = False
    # measurement window: closes after at least `interval_batches` batches
    # AND `min_window_s` wall time (delivery is bursty: a batch-count-only
    # window can span microseconds and measure buffer pops)
    interval_batches: int = 4
    min_window_s: float = 0.2
    # measured windows to observe before the first probe (the first window is
    # warped by the prefetch burst + worker startup)
    warmup_windows: int = 1
    # accept a move only if windowed throughput improves by this fraction;
    # revert if it regresses by more than it (hysteresis dead-band)
    rel_improvement: float = 0.05
    # knob bounds (inclusive)
    min_fetch_workers: int = 1
    max_fetch_workers: int = 64
    min_outstanding: int = 1
    max_outstanding: int = 64
    min_device_prefetch: int = 1
    max_device_prefetch: int = 8
    # per-knob coarse->fine step schedule for integer knobs; () derives
    # (2 * step_factor, step_factor)
    step_schedule: Tuple[int, ...] = ()
    # multiplicative fine step for integer knobs (value *= step / value //= step)
    step_factor: int = 2
    # allow the controller to trial-toggle hedged requests
    tune_hedge: bool = False
    # consecutive plateau windows (per knob) before the controller goes quiescent
    patience: int = 3
    # jump back to the best settled state when a window collapses below half
    # of its throughput (disable where the environment itself is non-stationary)
    collapse_restore: bool = True
    # exploration heartbeat: while quiescent, re-probe once every this many
    # windows (0 = off)
    reprobe_windows: int = 8
    # accelerator-utilization gate: with a utilization signal (the trainer
    # wires repro_torch.core.utilization.recent_busy_fraction) at or above
    # this fraction, upward probes are skipped.  0 disables the gate.
    util_gate: float = 0.9
    # staged-pipeline stage knobs: CPU executor width and the fetch->decode
    # queue depth (the IO executor reuses min/max_fetch_workers)
    min_cpu_workers: int = 1
    max_cpu_workers: int = 32
    min_stage_queue: int = 4
    max_stage_queue: int = 512
    # budget co-tuning (staged pipeline + split datasets only).  0 keeps the
    # independent io_workers/cpu_workers knobs; >0 fixes the TOTAL executor
    # width and replaces them with one coupled "io_cpu_split" knob (value =
    # IO width; CPU width = budget - value)
    thread_budget: int = 0
    # with thread_budget set and a process-capable dataset, also expose the
    # CPU executor KIND (thread vs spawn-process) as a binary knob
    tune_cpu_executor: bool = True
    # shuffle-entropy floor (reorder="window" pipelines): upward probes of
    # the reorder_window knob are skipped while the delivered stream's
    # within-batch entropy sits below it.  0.0 disables the gate.
    min_shuffle_entropy: float = 0.0
    # reorder_window knob bounds (window-mode pipelines only)
    min_reorder_window: int = 1
    max_reorder_window: int = 64


@dataclass(frozen=True)
class PipelineConfig:
    """Staged streaming pipeline (repro_torch.core.pipeline): replaces the
    worker/fetcher path with an explicit stage graph (fetch-raw -> decode ->
    augment -> collate) on dedicated IO and CPU executors with sample-level
    out-of-order completion.  ``enabled=False`` (the default) keeps the
    legacy path; the sub-config is truthy iff enabled, so ``if
    cfg.pipeline:`` reads the same either way."""

    enabled: bool = False
    # batch assembly: "strict" (every batch holds exactly its sampler-assigned
    # samples in order, bit-identical to the legacy stream) or "window"
    # (within each group of `reorder_window` batches, slots are filled by
    # whichever of the group's samples finish first)
    reorder: str = "strict"
    reorder_window: int = 4
    # stage sizing.  0 = derive: io_workers = num_workers * num_fetch_workers
    # (the legacy loader's fetch-thread count), cpu_workers = 4
    io_workers: int = 0
    cpu_workers: int = 0
    # decode+augment executor: "thread" (gated thread pool, for GIL-releasing
    # decoders) or "process" (spawn-based worker processes; needs the split
    # path and a picklable dataset; persists across epochs on the loader;
    # results come back pickled over each worker's pipe)
    cpu_executor: str = "thread"
    # bounded fetch->decode queue, in samples: a full queue stalls the IO
    # stage (the pipeline's backpressure)
    stage_queue_depth: int = 64
    # pinned host staging (repro_torch.core.staging): >0 collates batches
    # straight into a pool of this many reusable page-aligned buffer sets
    # that the device prefetch ring copies from and recycles after the copy
    # lands (a CUDA ring pins each pooled set in place the first time it
    # copies from it).  Default collate only; 0 = off.
    staging_buffers: int = 0

    def __bool__(self) -> bool:
        return self.enabled


@dataclass(frozen=True)
class LoaderConfig:
    impl: str = "threaded"  # vanilla | threaded | asyncio
    batch_size: int = 256
    num_workers: int = 4
    prefetch_factor: int = 4
    num_fetch_workers: int = 16
    batch_pool: int = 0  # >0 enables batch disassembly (threaded impl only)
    lazy_init: bool = True
    drop_last: bool = True
    shuffle: bool = True
    seed: int = 0
    # straggler mitigation: hedge a fetch when it exceeds p95 * hedge_factor
    hedge_requests: bool = False
    hedge_factor: float = 3.0
    hedge_min_s: float = 0.05
    timeout_s: float = 120.0
    # staged streaming pipeline (see PipelineConfig).  The flat kwargs
    # (pipeline=<bool>, reorder=..., io_workers=..., ...) still construct the
    # nested form through the shim below; reads of the flat names delegate.
    pipeline: PipelineConfig = PipelineConfig()
    # online knob control (off by default: behaviour is bit-identical to a
    # statically configured loader when disabled)
    autotune: AutotuneConfig = AutotuneConfig()

    # -- legacy flat reads (the write path is shimmed in __init__) ----------
    @property
    def reorder(self) -> str:
        return self.pipeline.reorder

    @property
    def reorder_window(self) -> int:
        return self.pipeline.reorder_window

    @property
    def io_workers(self) -> int:
        return self.pipeline.io_workers

    @property
    def cpu_workers(self) -> int:
        return self.pipeline.cpu_workers

    @property
    def cpu_executor(self) -> str:
        return self.pipeline.cpu_executor

    @property
    def stage_queue_depth(self) -> int:
        return self.pipeline.stage_queue_depth


# Deprecation shim, as the reference's: each flat pipeline kwarg warns and is
# folded into the nested sub-config; ``dataclasses.replace`` passes the
# nested fields straight through, so the shim never re-fires on derived
# configs.
_LEGACY_PIPELINE_KWARGS = (
    "reorder", "reorder_window", "io_workers", "cpu_workers",
    "cpu_executor", "stage_queue_depth",
)

_loader_config_init = LoaderConfig.__init__


@functools.wraps(_loader_config_init)
def _loader_config_shim_init(self, *args: Any, **kwargs: Any) -> None:
    legacy = {}
    for name in _LEGACY_PIPELINE_KWARGS:
        if name in kwargs:
            warnings.warn(
                f"LoaderConfig({name}=...) is deprecated and will be removed;"
                f" pass pipeline=PipelineConfig({name}=...) instead",
                DeprecationWarning, stacklevel=2,
            )
            legacy[name] = kwargs.pop(name)
    pipe = kwargs.get("pipeline")
    if isinstance(pipe, bool):
        warnings.warn(
            "LoaderConfig(pipeline=<bool>) is deprecated and will be removed;"
            " pass pipeline=PipelineConfig(enabled=...) instead",
            DeprecationWarning, stacklevel=2,
        )
        kwargs["pipeline"] = PipelineConfig(enabled=pipe, **legacy)
    elif legacy:
        kwargs["pipeline"] = replace(
            pipe if pipe is not None else PipelineConfig(), **legacy
        )
    _loader_config_init(self, *args, **kwargs)


LoaderConfig.__init__ = _loader_config_shim_init  # type: ignore[method-assign]


@dataclass(frozen=True)
class ServeSpec:
    """Sizing of the continuous-batching engine (:mod:`repro_torch.serve`):
    ``num_slots`` requests decode together over a pooled KV cache of
    ``max_len`` positions a slot."""

    num_slots: int = 4
    max_len: int = 512


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw | adafactor | sgd
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"  # cosine | constant | linear
    total_steps: int = 1000
    microbatches: int = 1  # gradient accumulation over leading-dim splits
    grad_compression: str = "none"  # none | bf16 | int8_ef


ARCH_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str, full: Callable[[], ModelConfig],
                  smoke: Callable[[], ModelConfig]) -> None:
    ARCH_REGISTRY[name] = full
    SMOKE_REGISTRY[name] = smoke


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  triggers registration

    reg = SMOKE_REGISTRY if smoke else ARCH_REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(reg)}")
    return reg[name]()


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401  triggers registration

    return sorted(ARCH_REGISTRY)
