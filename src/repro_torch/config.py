"""Frozen-dataclass configuration for the port's slices, and the arch registry.

A trimmed copy of ``repro/config.py``: only the fields the ResNet, dense
decoder (LM, with gqa/mha or mla attention, and MoE FFNs, and the VLM
stub's patch prefix), RWKV-6, hybrid (Mamba-1 with attention, jamba) and
encoder-decoder (whisper) slices and the loader layer read, with the
reference's names and defaults (``LoaderConfig`` drops ``pin_device`` and
``device_prefetch``, which the reference declares but never reads; the
ring's depth is ``Trainer(device_prefetch=...)``; ``RWKVConfig`` drops
``token_shift`` and ``MoEConfig`` drops ``router_jitter``, for the same
reason).  ``LoaderConfig`` and ``StoreConfig`` keep the reference's
warn-once flat-kwarg shims (``pipeline=True, reorder=...`` folded into
:class:`PipelineConfig`; ``cache_bytes=..., cache_dir=...`` into
:class:`CacheConfig`).  Ported with the loader layer: the cache tiers
(:class:`CacheConfig`, ``StoreConfig.root``/``cache``), elastic membership
(:class:`ElasticConfig`, ``LoaderConfig.elastic``), and
:class:`AutotuneConfig`'s cache knobs, up-probe lease (``coord_dir``) and
fleet shedding (``shed_*``).  Not yet ported, so without a field:
``PipelineConfig``'s ``transport`` and slab fields (shared-memory
transport), ``LoaderConfig.sampler`` (predicate pushdown),
``LoaderConfig.delivery`` (sharded delivery) and :class:`AutotuneConfig`'s
slab knob, lane-skew gate and serving bounds.  :class:`ServeSpec` sizes the
serving engine only; the reference's read-path fields come with its read
path.  ``replace()`` (from dataclasses) derives variants.
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
class CacheConfig:
    """Cache-tier block of a :class:`StoreConfig` (paper §2.4; Varnish
    analogue).  When both ``memory_bytes`` and ``dir`` are set, build_store
    assembles one two-tier TieredCacheStore (memory LRU over bounded disk)
    instead of nesting single-tier caches."""

    memory_bytes: int = 0  # memory tier capacity; 0 = no memory tier
    dir: str = ""  # disk tier directory; "" = no disk tier
    disk_bytes: int = 0  # disk tier capacity; 0 = unbounded (legacy)
    # memory-tier lock striping.  Default 1 = exact global LRU with items
    # cacheable up to the full capacity (the legacy CachedStore semantics).
    # Raising it trades strict LRU for less lock contention AND caps the
    # largest cacheable item at memory_bytes // shards — opt in only
    # when single objects are far smaller than the memory budget.
    shards: int = 1
    # disk-tier admission: admit-all | size-threshold | second-hit | tinylfu
    admission: str = "admit-all"
    admission_max_item_bytes: int = 1 << 20  # size-threshold policy cutoff
    # multi-host disk-tier coordination (repro_torch.core.coord) when several
    # processes/hosts point ``dir`` at one shared directory:
    #   ""        — off: in-process accounting only (single-host, the default)
    #   "journal" — shared accounting: one fcntl-locked byte journal under
    #               dir/.coord bounds the tier across all writers
    #   "shard"   — partitioned keyspace: this host only caches keys where
    #               host_shard(key, n_hosts) == host_id (capacity is per-host)
    #               but opportunistically reads peers' entries off the shared
    #               disk
    coord: str = ""
    coord_host_id: int = 0
    coord_num_hosts: int = 1


@dataclass(frozen=True)
class StoreConfig:
    kind: str = "s3sim"  # memory | localfs | s3sim
    root: str = ""  # for localfs
    # SimulatedS3 latency model (lognormal)
    latency_mean_s: float = 0.08
    latency_sigma: float = 0.5
    bandwidth_per_conn: float = 25e6  # bytes/s per connection
    nic_bandwidth: float = 1.2e9  # bytes/s aggregate
    max_connections: int = 256
    failure_rate: float = 0.0
    # congestion collapse model: when the NIC is oversubscribed (more active
    # transfers than nic_bandwidth / bandwidth_per_conn supports), each GET's
    # service time is additionally scaled by (oversubscription)**overload_penalty
    # — the queueing/bufferbloat tail real links exhibit.  0 = off (the
    # legacy monotone model, where extra concurrency never hurts).
    overload_penalty: float = 0.0
    # cache tiers (see CacheConfig).  The historical flat ``cache_*`` kwargs
    # still construct the nested form through a deprecation shim; reads of
    # the old flat names delegate below.
    cache: CacheConfig = CacheConfig()

    # -- legacy flat reads (the write path is shimmed in __init__) ----------
    @property
    def cache_bytes(self) -> int:
        return self.cache.memory_bytes

    @property
    def cache_dir(self) -> str:
        return self.cache.dir

    @property
    def disk_cache_bytes(self) -> int:
        return self.cache.disk_bytes

    @property
    def cache_shards(self) -> int:
        return self.cache.shards

    @property
    def cache_admission(self) -> str:
        return self.cache.admission

    @property
    def admission_max_item_bytes(self) -> int:
        return self.cache.admission_max_item_bytes

    @property
    def cache_coord(self) -> str:
        return self.cache.coord

    @property
    def cache_coord_host_id(self) -> int:
        return self.cache.coord_host_id

    @property
    def cache_coord_num_hosts(self) -> int:
        return self.cache.coord_num_hosts


# Deprecation shim, as the reference's: each flat cache kwarg warns and is
# folded into the nested CacheConfig; ``dataclasses.replace`` passes the
# nested field straight through, so the shim never re-fires on derived
# configs.
_LEGACY_CACHE_KWARGS = {
    "cache_bytes": "memory_bytes",
    "cache_dir": "dir",
    "disk_cache_bytes": "disk_bytes",
    "cache_shards": "shards",
    "cache_admission": "admission",
    "admission_max_item_bytes": "admission_max_item_bytes",
    "cache_coord": "coord",
    "cache_coord_host_id": "coord_host_id",
    "cache_coord_num_hosts": "coord_num_hosts",
}

_store_config_init = StoreConfig.__init__


@functools.wraps(_store_config_init)
def _store_config_shim_init(self, *args: Any, **kwargs: Any) -> None:
    legacy = {}
    for flat, nested in _LEGACY_CACHE_KWARGS.items():
        if flat in kwargs:
            warnings.warn(
                f"StoreConfig({flat}=...) is deprecated and will be removed;"
                f" pass cache=CacheConfig({nested}=...) instead",
                DeprecationWarning, stacklevel=2,
            )
            legacy[nested] = kwargs.pop(flat)
    if legacy:
        cache = kwargs.get("cache")
        kwargs["cache"] = replace(
            cache if cache is not None else CacheConfig(), **legacy
        )
    _store_config_init(self, *args, **kwargs)


StoreConfig.__init__ = _store_config_shim_init  # type: ignore[method-assign]


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
    # cache-tier knobs (attached when the dataset's store stack contains a
    # TieredCacheStore).  Capacity knobs exist only when the matching
    # max_*_cache_bytes names an explicit ceiling ABOVE the configured
    # capacity (default 0 = no capacity knob): growth is almost always
    # throughput-positive, so a default ceiling would let the hill climber
    # silently walk a cache the user sized for their RAM/disk up to it.
    # The admission-policy knob is attached whenever a disk tier exists.
    tune_cache: bool = True
    min_memory_cache_bytes: int = 1 << 20
    max_memory_cache_bytes: int = 0
    min_disk_cache_bytes: int = 1 << 22
    max_disk_cache_bytes: int = 0
    tune_admission: bool = True
    # cache-knob cadence.  Capacity knobs pay off on *epoch* timescales in
    # full-pass regimes (a shuffled pass has no intra-epoch repeats, so a
    # bigger cache only shows up one epoch later):
    #   "batch" — cache knobs ride the per-batch controller (legacy; right
    #             for within-epoch-repeat workloads)
    #   "epoch" — the loader runs a second controller for the cache knobs,
    #             fed once per completed epoch, judging on
    #             cache_epoch_windows-epoch throughput windows
    cache_cadence: str = "batch"
    cache_epoch_windows: int = 2
    # multi-host cooperative tuning (repro_torch.core.coord.UpProbeLease): when
    # coord_dir names a directory shared by co-located hosts, upward
    # concurrency/hedging probes require holding the fleet-wide up-probe
    # lease — one tenant probes a saturated NIC while the others hold or
    # refine downward.  "" = off (single-host, the default; behaviour is
    # bit-identical to a lease-free controller).  A crashed holder's lease
    # expires after coord_ttl_s.
    coord_dir: str = ""
    coord_ttl_s: float = 30.0
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
    # -- cooperative down-shedding (repro_torch.core.coord.CongestionBoard) -
    # AIMD across the fleet: a host whose window collapses below
    # shed_collapse_fraction of its best settled throughput posts a shed
    # event to coord_dir's CongestionBoard, and EVERY host (poster included)
    # multiplicatively cuts its concurrency knobs by shed_md_factor, holds
    # shed_hold_windows windows, then recovers additively toward the
    # pre-shed values over shed_recover_windows windows.  Per-host hill
    # climbing only gives back its own last probe step under collapse; the
    # board is what makes the whole fleet back off together.  0.0 = off
    # (the default: existing coord_dir fleets keep lease-gating only).
    # Requires coord_dir.
    shed_collapse_fraction: float = 0.0
    shed_md_factor: float = 0.5  # multiplicative-decrease factor per shed
    shed_hold_windows: int = 2  # windows to sit at the cut point
    shed_recover_windows: int = 8  # windows to climb back additively
    # fleet-wide shed rate limit: a collapse seen by N hosts injects ONE
    # shed event, not N stacked halvings (enforced under the board lock)
    shed_min_interval_s: float = 5.0


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
class ElasticConfig:
    """Elastic fleet membership + work claiming (repro_torch.core.elastic).

    When enabled, the loader joins a lease-based ``MembershipBoard`` under
    ``coord_dir`` and replaces static batch sharding with claim-based
    scheduling over an ``EpochShardBoard``: the epoch's batches are split
    into shards of ``shard_batches`` that live hosts claim under TTL
    leases, so hosts may join, leave, or crash mid-epoch and the *union*
    of delivered batches still covers the epoch exactly (a dead host's
    in-flight shard is resumed by a survivor at its last confirmed batch —
    at-least-once for the unconfirmed tail, never lost).  The sub-config
    is truthy iff enabled, so ``if cfg.elastic:`` reads naturally."""

    enabled: bool = False
    coord_dir: str = ""  # shared directory (required when enabled)
    lease_ttl_s: float = 10.0  # membership + shard-claim lease TTL
    heartbeat_interval_s: float = 2.0  # max staleness of our own lease
    shard_batches: int = 8  # claim granularity (batches per shard)
    claim_poll_s: float = 0.05  # wait between claim attempts when starved

    def __bool__(self) -> bool:
        return bool(self.enabled)



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
    # elastic fleet membership + claim-based batch scheduling (see
    # ElasticConfig).  Off by default: static host_id/num_hosts sharding.
    elastic: ElasticConfig = ElasticConfig()

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
