"""Frozen-dataclass configuration for the port's slices, and the arch registry.

A trimmed copy of ``repro/config.py``: only the fields the ResNet, dense
decoder (LM) and RWKV-6 training slices read, with the reference's names and
defaults (``LoaderConfig`` drops ``pin_device`` and ``device_prefetch``,
which the reference declares but never reads; the ring's depth is
``Trainer(device_prefetch=...)``; ``RWKVConfig`` drops ``token_shift``, for
the same reason).  ``LoaderConfig.pipeline`` takes only the nested
:class:`PipelineConfig`: the reference's flat-kwarg shim (``pipeline=True,
reorder=...``) is not ported, and ``PipelineConfig`` has no ``transport``
or slab fields until the shared-memory transport is ported.  MoE, SSM, MLA, enc-dec and VLM fields
come with their slices.  ``replace()`` (from dataclasses) derives variants.
"""
from __future__ import annotations

from dataclasses import dataclass, replace  # noqa: F401  (replace re-exported)
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    """Attention flavour. kind: mha | gqa (mla comes with its slice)."""

    kind: str = "gqa"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    causal: bool = True
    rope: bool = True
    rope_theta: float = 10_000.0

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 'Finch' data-dependent decay."""

    head_dim: int = 64
    decay_lora: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"  # decoder | resnet | rwkv
    num_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32_000
    attention: Optional[AttentionConfig] = None
    rwkv: Optional[RWKVConfig] = None
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
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
    # staged streaming pipeline (see PipelineConfig); nested form only
    pipeline: PipelineConfig = PipelineConfig()


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
