"""Dataset layer (paper Fig. 1 bottom lane): maps an index to one training
item fetched from an ObjectStore, then decodes + augments it (images) or
decodes a packed token sequence (LM).

``sim_decode_s_per_mb`` models the libjpeg decode cost (GIL-releasing C
work) with a byte-proportional sleep; the paper's ~6 ms/115 kB ImageNet JPEG
decode is ~52 ms/MB.  Default 0 (off).

Items and batches are numpy: tensors begin at the device prefetch ring
(:mod:`repro_torch.core.prefetch`).  This package imports no ``torch``: the
staged pipeline's spawned CPU workers unpickle a dataset and must not pay
for torch, or touch CUDA.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.tracing import GET_ITEM, NULL_TRACER, Tracer
from repro_torch.data import codec
from repro_torch.data.augment import imagenet_transform, imagenet_transform_raw
from repro_torch.data.imagenet_synth import item_key
from repro_torch.data.store import ObjectStore

Item = Dict[str, np.ndarray]


class MapDataset:
    """Minimal map-style dataset protocol.

    Datasets that can separate their storage read from their CPU work
    additionally expose the *split* path (``supports_split() -> True``)::

        raw     = get_raw(i)            # IO only: bytes off the store
        decoded = decode_raw(raw, i)    # CPU: codec work
        item    = augment_item(decoded, i)  # CPU: augmentation / normalize

    ``__getitem__`` must equal ``augment_item(decode_raw(get_raw(i), i), i)``
    bit-for-bit: the staged pipeline (:mod:`repro_torch.core.pipeline`) runs
    the three stages on different executors and relies on that for its
    ``reorder="strict"`` guarantee.  Datasets that cannot split keep
    ``supports_split() -> False`` and the pipeline runs the monolithic
    ``__getitem__`` on its IO executor.

    **Picklability** (``PipelineConfig.cpu_executor="process"``): the process
    CPU stage ships one pickled copy of the dataset to each spawned worker,
    where only ``decode_raw`` / ``augment_item`` run.  Members those stages
    never touch (the store, the tracer) may be dropped on pickle, which is
    what :class:`ImageDataset` and :class:`TokenDataset` do.
    """

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Item:
        raise NotImplementedError

    async def aget_item(self, index: int) -> Item:
        """Async variant; default falls back to the sync path."""
        return self[index]

    def set_epoch(self, epoch: int) -> None:
        """Hook for per-epoch augmentation determinism."""

    # -- split (staged-pipeline) path ---------------------------------------
    def supports_split(self) -> bool:
        """Whether the get_raw/decode_raw/augment_item stages are available."""
        return False

    def get_raw(self, index: int) -> bytes:
        """Storage read only — no decode, no augmentation."""
        raise NotImplementedError

    async def aget_raw(self, index: int) -> bytes:
        """Async variant of :meth:`get_raw`; default wraps the sync path."""
        return self.get_raw(index)

    def decode_raw(self, raw: bytes, index: int):
        """Codec stage: bytes -> decoded intermediate (dataset-defined)."""
        raise NotImplementedError

    def augment_item(self, decoded, index: int) -> Item:
        """Augment stage: decoded intermediate -> final Item.  Identity by
        default for datasets whose decode already yields the Item."""
        return decoded


def _aug_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    h = hashlib.blake2b(f"aug:{seed}:{epoch}:{index}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


class _StripStoreOnPickle:
    """Mixin for the process CPU stage's picklability: a pickled copy drops
    the store (locks, sockets; ``get_raw`` runs in the parent) and the
    tracer (holds a lock; the stage ships worker-side spans home itself)."""

    def __getstate__(self) -> Dict:
        state = dict(self.__dict__)
        state["store"] = None
        state["tracer"] = None
        return state

    def __setstate__(self, state: Dict) -> None:
        self.__dict__.update(state)
        if self.__dict__.get("tracer") is None:
            self.tracer = NULL_TRACER


class ImageDataset(_StripStoreOnPickle, MapDataset):
    """ImageNet-style dataset over an ObjectStore (paper's setup).

    ``epilogue`` picks where the transform's cast/normalize/layout tail runs:
    ``"host"`` (default) emits normalized f32 CHW images, the paper's plain
    transform; ``"device"`` stops after crop+flip and emits uint8 HWC — the
    training loop then runs the ``ingest_norm`` kernel after H2D
    (:func:`repro_torch.kernels.ingest_norm.ops.make_ingest_fn`), so the
    host copies and PCIe move 4x fewer bytes.  RNG consumption is identical,
    so the two paths see the same crops/flips.
    """

    def __init__(
        self,
        store: ObjectStore,
        num_items: int,
        prefix: str = "imagenet/train/",
        out_size: int = 224,
        augment: bool = True,
        seed: int = 0,
        tracer: Tracer = NULL_TRACER,
        sim_decode_s_per_mb: float = 0.0,
        epilogue: str = "host",
    ) -> None:
        if epilogue not in ("host", "device"):
            raise ValueError(f"epilogue must be 'host' or 'device', got {epilogue!r}")
        self.store = store
        self.num_items = num_items
        self.prefix = prefix
        self.out_size = out_size
        self.augment = augment
        self.seed = seed
        self.tracer = tracer
        self.sim_decode_s_per_mb = sim_decode_s_per_mb
        self.epilogue = epilogue
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return self.num_items

    # -- split path (one stage per pipeline executor) ------------------------
    def supports_split(self) -> bool:
        return True

    def get_raw(self, index: int) -> bytes:
        return self.store.get(item_key(index, self.prefix))

    async def aget_raw(self, index: int) -> bytes:
        return await self.store.aget(item_key(index, self.prefix))

    def decode_raw(self, raw: bytes, index: int) -> Tuple[codec.ImageRecord, int]:
        if self.sim_decode_s_per_mb:
            # emulated C-decoder cost: sleeps release the GIL like libjpeg
            time.sleep(self.sim_decode_s_per_mb * len(raw) / 1e6)
        return codec.decode_image(raw), len(raw)

    def augment_item(self, decoded: Tuple[codec.ImageRecord, int], index: int) -> Item:
        rec, nbytes = decoded
        device_tail = self.epilogue == "device"
        if self.augment:
            rng = _aug_rng(self.seed, self._epoch, index)
            if device_tail:
                img = imagenet_transform_raw(rec.pixels, rng, self.out_size)
            else:
                img = imagenet_transform(rec.pixels, rng, self.out_size)
        else:
            side = self.out_size
            px = rec.pixels[:side, :side]
            pad_h, pad_w = side - px.shape[0], side - px.shape[1]
            if pad_h > 0 or pad_w > 0:
                px = np.pad(px, ((0, max(pad_h, 0)), (0, max(pad_w, 0)), (0, 0)))
            if device_tail:
                img = np.ascontiguousarray(px)
            else:
                img = np.ascontiguousarray(px.transpose(2, 0, 1)).astype(np.float32) / 255.0
        return {
            "image": img,
            "label": np.int32(rec.label),
            "nbytes": np.int64(nbytes),
        }

    def _decode(self, raw: bytes, index: int) -> Item:
        return self.augment_item(self.decode_raw(raw, index), index)

    def __getitem__(self, index: int) -> Item:
        with self.tracer.span(GET_ITEM, index=index):
            return self._decode(self.get_raw(index), index)

    async def aget_item(self, index: int) -> Item:
        with self.tracer.span(GET_ITEM, index=index):
            return self._decode(await self.aget_raw(index), index)


class TokenDataset(_StripStoreOnPickle, MapDataset):
    """Packed-sequence LM dataset: one object = one packed token sequence of
    at least ``seq_len + 1`` int32 tokens; an item is its first ``seq_len``
    tokens and the same shifted by one as targets."""

    def __init__(
        self,
        store: ObjectStore,
        num_items: int,
        seq_len: int,
        prefix: str = "tokens/train/",
        tracer: Tracer = NULL_TRACER,
    ) -> None:
        self.store = store
        self.num_items = num_items
        self.seq_len = seq_len
        self.prefix = prefix
        self.tracer = tracer

    def key(self, index: int) -> str:
        return f"{self.prefix}{index:08d}.rtok"

    def __len__(self) -> int:
        return self.num_items

    def _decode(self, raw: bytes) -> Item:
        toks = codec.decode_tokens(raw)
        if toks.shape[0] < self.seq_len + 1:
            raise ValueError(f"sequence of {toks.shape[0]} tokens is shorter than "
                             f"seq_len + 1 = {self.seq_len + 1}")
        return {
            "tokens": toks[: self.seq_len].astype(np.int32),
            "targets": toks[1: self.seq_len + 1].astype(np.int32),
            "nbytes": np.int64(len(raw)),
        }

    # -- split path (the augment stage is the identity: tokens have none) ----
    def supports_split(self) -> bool:
        return True

    def get_raw(self, index: int) -> bytes:
        return self.store.get(self.key(index))

    async def aget_raw(self, index: int) -> bytes:
        return await self.store.aget(self.key(index))

    def decode_raw(self, raw: bytes, index: int) -> Item:
        return self._decode(raw)

    def __getitem__(self, index: int) -> Item:
        with self.tracer.span(GET_ITEM, index=index):
            return self._decode(self.get_raw(index))

    async def aget_item(self, index: int) -> Item:
        with self.tracer.span(GET_ITEM, index=index):
            return self._decode(await self.aget_raw(index))


class SyntheticTokenDataset(MapDataset):
    """Deterministic on-the-fly token sequences (no store; for model tests)."""

    def __init__(self, num_items: int, seq_len: int, vocab_size: int, seed: int = 0) -> None:
        self.num_items = num_items
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self.num_items

    def __getitem__(self, index: int) -> Item:
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        toks = rng.integers(0, self.vocab_size, size=self.seq_len + 1, dtype=np.int32)
        return {"tokens": toks[:-1], "targets": toks[1:], "nbytes": np.int64(toks.nbytes)}


class SpinDataset(MapDataset):
    """Split-path dataset whose decode stage holds the GIL.

    Its decode is a pure-Python byte-crunch loop: deterministic output (so
    strict-reorder bit-identity holds across executors), about 0.17 ms per
    2048-byte round, and no escape from the interpreter: the regime where
    the process CPU stage is the only way past one core.  ``io_s`` adds a
    GIL-releasing sleep in ``get_raw`` to stand in for storage latency.
    Fully picklable (no store, no locks).
    """

    def __init__(
        self,
        num_items: int,
        item_bytes: int = 2048,
        spin_rounds: int = 8,
        io_s: float = 0.0,
        seed: int = 0,
    ) -> None:
        self.num_items = num_items
        self.item_bytes = item_bytes
        self.spin_rounds = spin_rounds
        self.io_s = io_s
        self.seed = seed

    def __len__(self) -> int:
        return self.num_items

    # -- split path -----------------------------------------------------------
    def supports_split(self) -> bool:
        return True

    def get_raw(self, index: int) -> bytes:
        if self.io_s:
            time.sleep(self.io_s)  # releases the GIL, like a socket read
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        return rng.bytes(self.item_bytes)

    def decode_raw(self, raw: bytes, index: int) -> Tuple[int, int]:
        acc = index & 0xFFFFFFFF
        for _ in range(self.spin_rounds):
            for b in raw:  # pure Python: holds the GIL for the whole decode
                acc = (acc * 1103515245 + b) & 0xFFFFFFFF
        return acc, len(raw)

    def augment_item(self, decoded: Tuple[int, int], index: int) -> Item:
        acc, nbytes = decoded
        return {
            "x": np.int64(acc),
            "label": np.int32(index),
            "nbytes": np.int64(nbytes),
        }

    def __getitem__(self, index: int) -> Item:
        return self.augment_item(self.decode_raw(self.get_raw(index), index), index)


def build_token_store(
    store: ObjectStore,
    num_items: int,
    seq_len: int,
    vocab_size: int,
    prefix: str = "tokens/train/",
    seed: int = 0,
) -> None:
    """Materialize packed token sequences (``seq_len + 1`` tokens each) into
    a store."""
    for i in range(num_items):
        rng = np.random.default_rng(seed * 1_000_003 + i)
        toks = rng.integers(0, vocab_size, size=seq_len + 1, dtype=np.int32)
        store.put(f"{prefix}{i:08d}.rtok", codec.encode_tokens(toks))


def collate(items: Sequence[Item]) -> Item:
    """Stack a list of items into a numpy batch (H2D happens in the ring)."""
    if not items:
        raise ValueError("empty batch")
    out: Item = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if np.ndim(vals[0]) else np.asarray(vals)
    return out
