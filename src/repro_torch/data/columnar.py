"""Columnar shard tier: per-field chunks, chunk statistics, predicate pushdown.

Every earlier tier (cache, pipeline, shm, serve) moves *whole* items even
when a transform needs one field or a filtered epoch needs a quarter of the
rows.  On high-latency storage the dominant cost is bytes moved per sample
(the paper's central measurement), so this module stores shards column-wise
and lets the read path skip bytes instead of discarding them:

* **Format** — a shard is ``MAGIC | chunk payloads | footer | trailer``.
  Each chunk holds one *field* over a contiguous row range, with per-row
  offsets and per-chunk statistics (min/max, value histogram, payload
  lengths).  The JSON footer indexes every chunk; the fixed trailer
  (``footer_len | crc32 | RCOLFTR1``) makes truncated writes detectable:
  a crash mid-write can never yield a readable-but-wrong shard.
* **Projection** — :class:`ColumnarImageDataset` fetches only the fields its
  transform declares; small scalar columns (label, shape, lengths) live in
  the footer, so predicate evaluation never touches payload chunks.
* **Pushdown** — a callable-free predicate DSL (``("label", "in", (...))``,
  ``("length", "<", n)``) is evaluated against footer metadata and chunk
  statistics *before* any payload GET: pruned chunks are never requested
  from the store, which is what makes a 25%-selectivity epoch cost ~25% of
  the bytes instead of 100%.
* **Cache granularity** — :class:`ColumnarStore` stores each chunk as its
  own object key, so the tiered cache and the simulated S3 account (and
  cache) field-chunks, not whole items.

The predicate DSL is deliberately tuple-only (no callables) so it is
picklable, serializable into configs/checkpoints, and evaluable both
row-wise (exact) and chunk-wise (conservative, via statistics).

The reference's module and byte format: a shard packed by either package
unpacks in the other, and both pack the same rows and metadata to the same
bytes.  It imports no ``torch``: the process CPU stage's spawned workers
unpickle :class:`ColumnarImageDataset`.
"""
from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.tracing import NULL_TRACER, Tracer
from repro_torch.data import codec
from repro_torch.data.dataset import ImageDataset
from repro_torch.data.store import ObjectStore

MAGIC = b"RCOL1\n"
_FOOTER_MAGIC = b"RCOLFTR1"
_TRAILER = struct.Struct("<QI")  # footer_len, crc32(footer_json)
_TRAILER_LEN = _TRAILER.size + len(_FOOTER_MAGIC)  # 20 bytes
_HIST_MAX = 256  # keep a value histogram only while a chunk stays this diverse
_RIMG_HEADER = 21  # magic(4) + struct "<IIIIB"

OPS = ("==", "!=", "<", "<=", ">", ">=", "in", "not_in")

Clause = Tuple[str, str, object]


class ColumnarError(ValueError):
    """Malformed columnar shard or predicate."""


class TruncatedShard(ColumnarError):
    """Shard blob fails integrity checks (crash-truncated or corrupt)."""


# ---------------------------------------------------------------------------
# predicate DSL
# ---------------------------------------------------------------------------

def validate_clauses(clauses: Sequence[Clause]) -> Tuple[Clause, ...]:
    """Normalize and validate DSL clauses (tuple-only, no callables)."""
    out: List[Clause] = []
    for cl in clauses:
        if not (isinstance(cl, (tuple, list)) and len(cl) == 3):
            raise ColumnarError(f"clause must be (field, op, value), got {cl!r}")
        field, op, value = cl
        if not isinstance(field, str) or not field:
            raise ColumnarError(f"clause field must be a string, got {field!r}")
        if op not in OPS:
            raise ColumnarError(f"clause op must be one of {OPS}, got {op!r}")
        if op in ("in", "not_in"):
            if isinstance(value, (str, bytes)) or not isinstance(value, Iterable):
                raise ColumnarError(f"{op!r} needs an iterable of values, got {value!r}")
            value = tuple(int(v) for v in value)
        else:
            value = int(value)
        out.append((field, op, value))
    return tuple(out)


def predicate_mask(
    columns: Dict[str, np.ndarray], clauses: Sequence[Clause]
) -> np.ndarray:
    """Vectorized row mask: AND of all clauses over metadata columns."""
    clauses = validate_clauses(clauses)
    n = len(next(iter(columns.values()))) if columns else 0
    mask = np.ones(n, dtype=bool)
    for field, op, value in clauses:
        if field not in columns:
            raise ColumnarError(f"unknown predicate field {field!r}; "
                                f"have {sorted(columns)}")
        col = np.asarray(columns[field])
        if op == "in":
            m = np.isin(col, np.asarray(value, dtype=col.dtype))
        elif op == "not_in":
            m = ~np.isin(col, np.asarray(value, dtype=col.dtype))
        elif op == "==":
            m = col == value
        elif op == "!=":
            m = col != value
        elif op == "<":
            m = col < value
        elif op == "<=":
            m = col <= value
        elif op == ">":
            m = col > value
        else:  # ">="
            m = col >= value
        mask &= m
    return mask


def row_matches(meta: Dict[str, Sequence[int]], row: int,
                clauses: Sequence[Clause]) -> bool:
    """Exact scalar evaluation of the clause list for one row."""
    cols = {f: np.asarray(meta[f]) for f, _, _ in validate_clauses(clauses)}
    return bool(predicate_mask(cols, clauses)[row]) if cols else True


def chunk_matches(stats: Dict[str, Dict], clauses: Sequence[Clause]) -> bool:
    """Conservative chunk test: False only when NO row in the chunk can
    satisfy the clause list — the soundness contract pushdown relies on
    (a pruned chunk provably contains no matching row)."""
    for field, op, value in validate_clauses(clauses):
        s = stats.get(field)
        if s is None:
            continue  # no statistics for this column: cannot prune
        lo, hi, hist = s.get("min"), s.get("max"), s.get("hist")
        if op == "in":
            if hist is not None:
                if not any(str(v) in hist for v in value):
                    return False
            elif not any(lo <= v <= hi for v in value):
                return False
        elif op == "not_in":
            if hist is not None:
                if all(int(k) in value for k in hist):
                    return False
            elif lo == hi and lo in value:
                return False
        elif op == "==":
            if hist is not None:
                if str(value) not in hist:
                    return False
            elif not (lo <= value <= hi):
                return False
        elif op == "!=":
            if lo == hi == value:
                return False
        elif op == "<":
            if not (lo < value):
                return False
        elif op == "<=":
            if not (lo <= value):
                return False
        elif op == ">":
            if not (hi > value):
                return False
        else:  # ">="
            if not (hi >= value):
                return False
    return True


def clause_fields(clauses: Sequence[Clause]) -> Tuple[str, ...]:
    return tuple(dict.fromkeys(f for f, _, _ in validate_clauses(clauses)))


# ---------------------------------------------------------------------------
# shard codec (single-blob form; the store explodes it into per-chunk keys)
# ---------------------------------------------------------------------------

def _column_stats(values: Sequence[int]) -> Dict:
    vals = [int(v) for v in values]
    stats: Dict = {"min": min(vals), "max": max(vals)}
    if len(set(vals)) <= _HIST_MAX:
        hist: Dict[str, int] = {}
        for v in vals:
            hist[str(v)] = hist.get(str(v), 0) + 1
        stats["hist"] = hist
    return stats


def _build_chunks(
    rows: Sequence[Dict[str, bytes]],
    meta: Dict[str, Sequence[int]],
    fields: Sequence[str],
    rows_per_chunk: int,
) -> Tuple[List[bytes], List[Dict]]:
    """Split rows into per-field chunk payloads + footer index entries."""
    payloads: List[bytes] = []
    index: List[Dict] = []
    n = len(rows)
    for field in fields:
        for lo in range(0, n, rows_per_chunk):
            hi = min(lo + rows_per_chunk, n)
            blobs = [bytes(rows[r][field]) for r in range(lo, hi)]
            row_offsets = [0]
            for b in blobs:
                row_offsets.append(row_offsets[-1] + len(b))
            payload = b"".join(blobs)
            stats = {col: _column_stats(vals[lo:hi]) for col, vals in meta.items()}
            stats["length"] = _column_stats([len(b) for b in blobs])
            payloads.append(payload)
            index.append({
                "field": field, "row_lo": lo, "row_hi": hi,
                "size": len(payload), "row_offsets": row_offsets,
                "stats": stats,
            })
    return payloads, index


def _footer_bytes(footer: Dict) -> bytes:
    fjson = json.dumps(footer, separators=(",", ":"), sort_keys=True).encode()
    return fjson + _TRAILER.pack(len(fjson), zlib.crc32(fjson)) + _FOOTER_MAGIC


def read_footer(data: bytes) -> Dict:
    """Parse + integrity-check the footer at the end of ``data``.

    Raises :class:`TruncatedShard` on any truncation or corruption — the
    trailer magic, the footer length, and the footer crc32 must all agree,
    so a crash-truncated write is detected rather than misread.
    """
    if len(data) < _TRAILER_LEN:
        raise TruncatedShard("blob shorter than the footer trailer")
    if data[-len(_FOOTER_MAGIC):] != _FOOTER_MAGIC:
        raise TruncatedShard("footer magic missing (truncated write?)")
    flen, crc = _TRAILER.unpack(data[-_TRAILER_LEN:-len(_FOOTER_MAGIC)])
    if flen + _TRAILER_LEN > len(data):
        raise TruncatedShard("footer length exceeds blob size")
    fjson = data[len(data) - _TRAILER_LEN - flen : len(data) - _TRAILER_LEN]
    if zlib.crc32(fjson) != crc:
        raise TruncatedShard("footer checksum mismatch")
    try:
        footer = json.loads(fjson)
    except ValueError as e:  # pragma: no cover - crc makes this unreachable
        raise TruncatedShard(f"footer is not valid JSON: {e}") from e
    if footer.get("version") != 1:
        raise ColumnarError(f"unsupported columnar version {footer.get('version')!r}")
    return footer


def pack_shard(
    rows: Sequence[Dict[str, bytes]],
    meta: Optional[Dict[str, Sequence[int]]] = None,
    *,
    rows_per_chunk: int = 8,
) -> bytes:
    """Pack rows (dict field -> ragged bytes) + scalar metadata columns into
    one self-describing shard blob."""
    if not rows:
        raise ColumnarError("cannot pack an empty shard")
    if rows_per_chunk < 1:
        raise ColumnarError("rows_per_chunk must be >= 1")
    fields = sorted(rows[0])
    if not fields:
        raise ColumnarError("rows must have at least one field")
    for r, row in enumerate(rows):
        if sorted(row) != fields:
            raise ColumnarError(f"row {r} fields {sorted(row)} != {fields}")
    meta = {k: [int(v) for v in vals] for k, vals in (meta or {}).items()}
    for col, vals in meta.items():
        if len(vals) != len(rows):
            raise ColumnarError(f"meta column {col!r} has {len(vals)} values "
                                f"for {len(rows)} rows")
    payloads, index = _build_chunks(rows, meta, fields, rows_per_chunk)
    offset = len(MAGIC)
    for payload, entry in zip(payloads, index):
        entry["offset"] = offset
        offset += len(payload)
    footer = {
        "version": 1, "num_rows": len(rows), "fields": fields,
        "rows_per_chunk": rows_per_chunk, "meta": meta, "chunks": index,
    }
    return MAGIC + b"".join(payloads) + _footer_bytes(footer)


def unpack_shard(blob: bytes) -> Tuple[List[Dict[str, bytes]], Dict[str, List[int]]]:
    """Inverse of :func:`pack_shard` (round-trip; used by tests/converter)."""
    if blob[: len(MAGIC)] != MAGIC:
        raise TruncatedShard("not a columnar shard (bad magic)")
    footer = read_footer(blob)
    body_end = None  # chunks must fit before the footer
    rows: List[Dict[str, bytes]] = [dict() for _ in range(footer["num_rows"])]
    for ch in footer["chunks"]:
        lo, hi = ch["offset"], ch["offset"] + ch["size"]
        if body_end is None or hi > body_end:
            body_end = hi
        if hi > len(blob) - _TRAILER_LEN:
            raise TruncatedShard("chunk extends past the footer")
        payload = blob[lo:hi]
        offs = ch["row_offsets"]
        for i, row in enumerate(range(ch["row_lo"], ch["row_hi"])):
            rows[row][ch["field"]] = payload[offs[i] : offs[i + 1]]
    return rows, {k: list(v) for k, v in footer["meta"].items()}


# ---------------------------------------------------------------------------
# store: one object key per field-chunk (cache- and billing-granular)
# ---------------------------------------------------------------------------

class ColumnarStore:
    """Chunk-granular columnar shards over any :class:`ObjectStore`.

    Each field-chunk is its own object key, so a tiered cache wrapped around
    ``base`` caches chunks (not whole items) and the simulated S3 bills only
    the chunks actually requested — pruned chunks cost zero backend bytes.
    """

    def __init__(self, base: ObjectStore, prefix: str = "columnar/train/",
                 *, cache_chunks: int = 4) -> None:
        self.base = base
        self.prefix = prefix
        self._footers: Dict[int, Dict] = {}
        self._chunk_cache: "OrderedDict[Tuple[int, str, int], bytes]" = OrderedDict()
        self._cache_cap = cache_chunks
        self._lock = threading.Lock()

    # -- keys -----------------------------------------------------------------
    def footer_key(self, shard: int) -> str:
        return f"{self.prefix}{shard:06d}/footer.rcf"

    def chunk_key(self, shard: int, field: str, ci: int) -> str:
        return f"{self.prefix}{shard:06d}/{field}/{ci:05d}.bin"

    # -- write ----------------------------------------------------------------
    def put_shard(
        self,
        shard: int,
        rows: Sequence[Dict[str, bytes]],
        meta: Optional[Dict[str, Sequence[int]]] = None,
        *,
        rows_per_chunk: int = 1,
    ) -> None:
        """Write one shard as exploded per-chunk objects + a footer object."""
        self.put_shard_blob(shard, pack_shard(rows, meta, rows_per_chunk=rows_per_chunk))

    def put_shard_blob(self, shard: int, blob: bytes) -> None:
        """Explode a packed single-file shard (e.g. a ``.rcol`` produced by
        ``python -m repro_torch.tools.convert_to_columnar``) into chunk-granular
        objects."""
        footer = read_footer(blob)
        per_field: Dict[str, int] = {}
        for ch in footer["chunks"]:
            ci = per_field.get(ch["field"], 0)
            per_field[ch["field"]] = ci + 1
            self.base.put(self.chunk_key(shard, ch["field"], ci),
                          blob[ch["offset"] : ch["offset"] + ch["size"]])
            ch["chunk_id"] = ci
        self.base.put(self.footer_key(shard), _footer_bytes(footer))
        with self._lock:
            self._footers[shard] = footer

    # -- read -----------------------------------------------------------------
    def list_shards(self) -> List[int]:
        suffix = "/footer.rcf"
        out = []
        for k in self.base.list_keys(self.prefix):
            if k.endswith(suffix):
                out.append(int(k[len(self.prefix) : -len(suffix)]))
        return sorted(out)

    def footer(self, shard: int) -> Dict:
        with self._lock:
            cached = self._footers.get(shard)
        if cached is not None:
            return cached
        footer = read_footer(self.base.get(self.footer_key(shard)))
        with self._lock:
            self._footers[shard] = footer
        return footer

    def _chunk_for_row(self, shard: int, field: str, row: int) -> Dict:
        for ch in self.footer(shard)["chunks"]:
            if ch["field"] == field and ch["row_lo"] <= row < ch["row_hi"]:
                return ch
        raise ColumnarError(f"no {field!r} chunk covers row {row} of shard {shard}")

    def _cache_get(self, key: Tuple[int, str, int]) -> Optional[bytes]:
        with self._lock:
            data = self._chunk_cache.get(key)
            if data is not None:
                self._chunk_cache.move_to_end(key)
            return data

    def _cache_put(self, key: Tuple[int, str, int], data: bytes) -> None:
        with self._lock:
            self._chunk_cache[key] = data
            while len(self._chunk_cache) > self._cache_cap:
                self._chunk_cache.popitem(last=False)

    def chunk_bytes(self, shard: int, field: str, ci: int) -> bytes:
        key = (shard, field, ci)
        data = self._cache_get(key)
        if data is None:
            data = self.base.get(self.chunk_key(shard, field, ci))
            self._cache_put(key, data)
        return data

    async def achunk_bytes(self, shard: int, field: str, ci: int) -> bytes:
        key = (shard, field, ci)
        data = self._cache_get(key)
        if data is None:
            data = await self.base.aget(self.chunk_key(shard, field, ci))
            self._cache_put(key, data)
        return data

    @staticmethod
    def _slice_row(ch: Dict, data: bytes, row: int) -> bytes:
        i = row - ch["row_lo"]
        offs = ch["row_offsets"]
        return data[offs[i] : offs[i + 1]]

    def row_bytes(self, shard: int, field: str, row: int) -> bytes:
        ch = self._chunk_for_row(shard, field, row)
        return self._slice_row(ch, self.chunk_bytes(shard, field, ch["chunk_id"]), row)

    async def arow_bytes(self, shard: int, field: str, row: int) -> bytes:
        ch = self._chunk_for_row(shard, field, row)
        data = await self.achunk_bytes(shard, field, ch["chunk_id"])
        return self._slice_row(ch, data, row)

    # -- pushdown scan ---------------------------------------------------------
    def matching_rows(self, shard: int, clauses: Sequence[Clause]) -> List[int]:
        """Rows of one shard satisfying the clause list.  Chunk statistics
        prune whole chunks first (their payloads are never requested); only
        surviving chunks get exact row-level evaluation on footer metadata."""
        footer = self.footer(shard)
        meta = footer["meta"]
        primary = footer["fields"][0]
        rows: List[int] = []
        for ch in footer["chunks"]:
            if ch["field"] != primary:
                continue
            if not chunk_matches(ch["stats"], clauses):
                continue  # pruned: zero bytes requested for this chunk
            cols = {f: np.asarray(meta[f])[ch["row_lo"] : ch["row_hi"]]
                    for f in clause_fields(clauses) if f in meta}
            if "length" in clause_fields(clauses) and "length" not in cols:
                offs = ch["row_offsets"]
                cols["length"] = np.diff(np.asarray(offs))
            mask = predicate_mask(cols, clauses) if cols else None
            for i, row in enumerate(range(ch["row_lo"], ch["row_hi"])):
                if mask is None or mask[i]:
                    rows.append(row)
        return rows


# ---------------------------------------------------------------------------
# dataset: ImageDataset semantics over columnar shards
# ---------------------------------------------------------------------------

class _RawRow(NamedTuple):
    payloads: Dict[str, bytes]  # only the projected fields
    h: int
    w: int
    c: int
    label: int
    compressed: int
    nbytes: int  # original whole-record length (decode-cost + item parity)


class ColumnarImageDataset(ImageDataset):
    """ImageNet-style dataset reading columnar shards with field projection.

    Bit-compatible with :class:`ImageDataset` over the source records: the
    pixels field holds the exact RIMG payload bytes, scalar columns (label,
    shape, original record length) live in the shard footers, and the
    inherited augment stage consumes the identical decoded record — so a
    strict-mode epoch equals the row-store epoch bit-for-bit while fetching
    only the projected payload chunks.

    ``fields`` declares what the transform needs from payload chunks
    (projection); everything predicate evaluation needs is footer-resident,
    exposed via :meth:`metadata_column` / :meth:`predicate_mask` for the
    sampler's pushdown path.
    """

    def __init__(
        self,
        store: ColumnarStore,
        num_items: int,
        *,
        out_size: int = 224,
        augment: bool = True,
        seed: int = 0,
        tracer: Tracer = NULL_TRACER,
        sim_decode_s_per_mb: float = 0.0,
        epilogue: str = "host",
        fields: Sequence[str] = ("pixels",),
    ) -> None:
        super().__init__(
            store, num_items, prefix=store.prefix, out_size=out_size,
            augment=augment, seed=seed, tracer=tracer,
            sim_decode_s_per_mb=sim_decode_s_per_mb, epilogue=epilogue,
        )
        if "pixels" not in fields:
            raise ColumnarError("the image transform requires the 'pixels' field")
        self.fields = tuple(fields)
        self._index_lock = threading.Lock()
        self._loc: Optional[np.ndarray] = None  # (num_items, 2): shard, row
        self._meta_cols: Dict[str, np.ndarray] = {}

    # -- picklability (process CPU stage): locks can't cross, the store is
    # already dropped by _StripStoreOnPickle, decode/augment never fetch -----
    def __getstate__(self) -> Dict:
        state = super().__getstate__()
        state["_index_lock"] = None
        return state

    def __setstate__(self, state: Dict) -> None:
        super().__setstate__(state)
        self._index_lock = threading.Lock()

    # -- footer index (one-time; footers are the only non-projected bytes) ----
    def _ensure_index(self) -> None:
        if self._loc is not None:
            return
        with self._index_lock:
            if self._loc is not None:
                return
            loc = np.full((self.num_items, 2), -1, dtype=np.int64)
            cols: Dict[str, List[int]] = {}
            logical_all: List[int] = []
            for shard in self.store.list_shards():
                footer = self.store.footer(shard)
                meta = footer["meta"]
                n = footer["num_rows"]
                logical = meta.get("logical", list(range(len(logical_all),
                                                         len(logical_all) + n)))
                for row, li in enumerate(logical):
                    if 0 <= li < self.num_items:
                        loc[li] = (shard, row)
                for col, vals in meta.items():
                    if col == "logical":
                        continue
                    cols.setdefault(col, []).extend(
                        (li, v) for li, v in zip(logical, vals))
                logical_all.extend(logical)
            if np.any(loc[:, 0] < 0):
                missing = int(np.sum(loc[:, 0] < 0))
                raise ColumnarError(
                    f"{missing} of {self.num_items} logical rows missing from "
                    f"columnar shards under {self.store.prefix!r}")
            meta_cols: Dict[str, np.ndarray] = {}
            for col, pairs in cols.items():
                arr = np.zeros(self.num_items, dtype=np.int64)
                for li, v in pairs:
                    if 0 <= li < self.num_items:
                        arr[li] = v
                meta_cols[col] = arr
            self._meta_cols = meta_cols
            self._loc = loc

    def metadata_column(self, name: str) -> np.ndarray:
        self._ensure_index()
        if name not in self._meta_cols:
            raise ColumnarError(f"no metadata column {name!r}; "
                                f"have {sorted(self._meta_cols)}")
        return self._meta_cols[name]

    def predicate_mask(self, clauses: Sequence[Clause]) -> np.ndarray:
        """Row mask for the sampler's predicate pushdown (footer-only: no
        payload chunk is ever fetched to evaluate a predicate)."""
        clauses = validate_clauses(clauses)
        cols = {f: self.metadata_column(f) for f in clause_fields(clauses)}
        return predicate_mask(cols, clauses)

    # -- split path ------------------------------------------------------------
    def _locate(self, index: int) -> Tuple[int, int]:
        self._ensure_index()
        shard, row = self._loc[index]
        return int(shard), int(row)

    def _raw_from_payloads(self, payloads: Dict[str, bytes], index: int) -> _RawRow:
        m = self._meta_cols
        return _RawRow(
            payloads=payloads,
            h=int(m["h"][index]), w=int(m["w"][index]), c=int(m["c"][index]),
            label=int(m["label"][index]),
            compressed=int(m["compressed"][index]),
            nbytes=int(m["nbytes"][index]),
        )

    def get_raw(self, index: int) -> _RawRow:
        shard, row = self._locate(index)
        payloads = {f: self.store.row_bytes(shard, f, row) for f in self.fields}
        return self._raw_from_payloads(payloads, index)

    async def aget_raw(self, index: int) -> _RawRow:
        shard, row = self._locate(index)
        payloads = {f: await self.store.arow_bytes(shard, f, row)
                    for f in self.fields}
        return self._raw_from_payloads(payloads, index)

    def decode_raw(self, raw: _RawRow, index: int) -> Tuple[codec.ImageRecord, int]:
        if self.sim_decode_s_per_mb:
            # same emulated decode cost as the row store charges for this
            # image (proportional to the original record, not the projection)
            time.sleep(self.sim_decode_s_per_mb * raw.nbytes / 1e6)
        payload = raw.payloads["pixels"]
        if raw.compressed:
            payload = zlib.decompress(payload)
        px = np.frombuffer(payload, dtype=np.uint8).reshape(raw.h, raw.w, raw.c)
        return codec.ImageRecord(px, raw.label), raw.nbytes


# ---------------------------------------------------------------------------
# conversion from the row-store RIMG format
# ---------------------------------------------------------------------------

def split_rimg(record: bytes) -> Tuple[Dict[str, bytes], Dict[str, int]]:
    """Split one RIMG record into its payload field + scalar metadata."""
    if record[:4] != b"RIMG":
        raise ColumnarError("not an RIMG record")
    h, w, c, label, compressed = struct.unpack("<IIIIB", record[4:_RIMG_HEADER])
    return {"pixels": record[_RIMG_HEADER:]}, {
        "h": h, "w": w, "c": c, "label": label,
        "compressed": compressed, "nbytes": len(record),
    }


def convert_image_records(
    records: Iterable[Tuple[int, bytes]],
    *,
    rows_per_shard: int = 256,
    rows_per_chunk: int = 1,
    cluster_by: Optional[str] = "label",
) -> Iterable[bytes]:
    """Convert (logical_index, RIMG bytes) records into packed shard blobs.

    ``cluster_by`` stably sorts rows by a metadata column before sharding —
    the classic columnar trick that makes chunk statistics selective (a
    label-range predicate then prunes most chunks outright).  The logical
    order is preserved in the ``logical`` metadata column, so datasets and
    samplers keep row-store index semantics regardless of physical layout.
    """
    parsed = []
    for logical, rec in records:
        fields, meta = split_rimg(rec)
        parsed.append((logical, fields, meta))
    if cluster_by is not None:
        parsed.sort(key=lambda t: (t[2][cluster_by], t[0]))
    for lo in range(0, len(parsed), rows_per_shard):
        group = parsed[lo : lo + rows_per_shard]
        rows = [fields for _, fields, _ in group]
        meta: Dict[str, List[int]] = {"logical": [g[0] for g in group]}
        for col in group[0][2]:
            meta[col] = [g[2][col] for g in group]
        yield pack_shard(rows, meta, rows_per_chunk=rows_per_chunk)


def convert_store(
    src: ObjectStore,
    num_items: int,
    dst: ColumnarStore,
    *,
    prefix: str = "imagenet/train/",
    rows_per_shard: int = 256,
    rows_per_chunk: int = 1,
    cluster_by: Optional[str] = "label",
) -> int:
    """Convert a row store of RIMG objects into columnar shards.  Returns the
    number of shards written."""
    from repro_torch.data.imagenet_synth import item_key

    records = ((i, src.get(item_key(i, prefix))) for i in range(num_items))
    n = 0
    for n, blob in enumerate(
        convert_image_records(records, rows_per_shard=rows_per_shard,
                              rows_per_chunk=rows_per_chunk,
                              cluster_by=cluster_by), start=1):
        dst.put_shard_blob(n - 1, blob)
    return n
