"""Twins of ``tests/test_columnar.py`` on the port (``repro_torch.data.columnar``,
predicate pushdown through ``LoaderConfig.sampler``, the shuffle meter and
the entropy floor, asyncio hedging), then the two packages against each
other: the same rows and metadata pack to the same shard bytes, a shard
packed by either package unpacks in the other, ``predicate_mask`` agrees, a
filtered strict epoch gives the same stream, and the converter's ``--demo``
writes the reference script's blobs.  Byte streams and formats are held
equal exactly; images are compared bit for bit.

``test_truncation_property``'s twin compares the unpacked metadata with the
metadata it packed.  The reference's test compares it with metadata drawn
from a fresh generator, which is not what it packed, and fails at
``cut == 0``.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.config import LoaderConfig as JaxLoaderConfig  # noqa: E402
from repro.config import SamplerPredicate as JaxSamplerPredicate  # noqa: E402
from repro.core.loader import ConcurrentDataLoader as JaxLoader  # noqa: E402
from repro.data import columnar as jcol  # noqa: E402
from repro.data.imagenet_synth import build_synthetic_imagenet as jax_build  # noqa: E402
from repro.data.store import InMemoryStore as JaxInMemoryStore  # noqa: E402
from repro_torch.config import (  # noqa: E402
    AutotuneConfig,
    LoaderConfig,
    PipelineConfig,
    SamplerPredicate,
)
from repro_torch.core.autotune import AutotuneController, build_reorder_knob  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.pipeline import _ShuffleMeter  # noqa: E402
from repro_torch.core.sampler import ShardedBatchSampler  # noqa: E402
from repro_torch.core.tracing import NULL_TRACER  # noqa: E402
from repro_torch.data.columnar import (  # noqa: E402
    ColumnarError,
    ColumnarImageDataset,
    ColumnarStore,
    TruncatedShard,
    chunk_matches,
    convert_store,
    pack_shard,
    predicate_mask,
    read_footer,
    row_matches,
    split_rimg,
    unpack_shard,
    validate_clauses,
)
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import build_synthetic_imagenet, item_key  # noqa: E402
from repro_torch.data.store import InMemoryStore, ObjectStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS = 96


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def ragged_rows(rng, n, fields=("a", "b")):
    return [
        {f: bytes(rng.integers(0, 256, size=int(rng.integers(0, 40)),
                               dtype=np.uint8)) for f in fields}
        for _ in range(n)
    ]


def random_meta(rng, n):
    return {
        "label": [int(v) for v in rng.integers(0, 8, size=n)],
        "nbytes": [int(v) for v in rng.integers(100, 5000, size=n)],
    }


class CountingStore(ObjectStore):
    """Records every key requested (projection/pruning byte accounting)."""

    def __init__(self, base):
        self.base = base
        self.keys = []

    def get(self, key):
        self.keys.append(key)
        return self.base.get(key)

    def put(self, key, data):
        self.base.put(key, data)

    def list_keys(self, prefix=""):
        return self.base.list_keys(prefix)

    def size(self, key):
        return self.base.size(key)


@pytest.fixture(scope="module")
def row_store():
    return build_synthetic_imagenet(InMemoryStore(), N_ITEMS, avg_kb=2.0)


@pytest.fixture(scope="module")
def col_base(row_store):
    base = InMemoryStore()
    convert_store(row_store, N_ITEMS, ColumnarStore(base),
                  rows_per_shard=32, rows_per_chunk=4)
    return base


def digest(batches):
    return [(b["label"].tolist(), float(b["image"].sum())) for b in batches]


# ---------------------------------------------------------------------------
# codec round-trip
# ---------------------------------------------------------------------------


def test_roundtrip_deterministic():
    rng = np.random.default_rng(0)
    for rows_per_chunk in (1, 3, 8, 100):
        rows = ragged_rows(rng, 17)
        meta = random_meta(rng, 17)
        blob = pack_shard(rows, meta, rows_per_chunk=rows_per_chunk)
        out_rows, out_meta = unpack_shard(blob)
        assert out_rows == rows
        assert out_meta == meta


def test_roundtrip_empty_payloads_and_single_row():
    rows = [{"x": b""}]
    blob = pack_shard(rows, {"label": [3]}, rows_per_chunk=1)
    out_rows, out_meta = unpack_shard(blob)
    assert out_rows == rows and out_meta == {"label": [3]}


def test_pack_rejects_malformed():
    with pytest.raises(ColumnarError):
        pack_shard([])
    with pytest.raises(ColumnarError):
        pack_shard([{"a": b"x"}, {"b": b"y"}])
    with pytest.raises(ColumnarError):
        pack_shard([{"a": b"x"}], {"label": [1, 2]})
    with pytest.raises(ColumnarError):
        pack_shard([{"a": b"x"}], rows_per_chunk=0)


@given(st.lists(st.lists(st.binary(max_size=64), min_size=1, max_size=4),
                min_size=1, max_size=12),
       st.integers(min_value=1, max_value=5))
@settings(max_examples=30, deadline=None)
def test_roundtrip_property(payload_rows, rows_per_chunk):
    nf = min(len(r) for r in payload_rows)
    rows = [{f"f{i}": r[i] for i in range(nf)} for r in payload_rows]
    meta = {"label": list(range(len(rows)))}
    blob = pack_shard(rows, meta, rows_per_chunk=rows_per_chunk)
    out_rows, out_meta = unpack_shard(blob)
    assert out_rows == rows
    assert out_meta == meta


# ---------------------------------------------------------------------------
# crash recovery: truncated / corrupted writes must be detected, not misread
# ---------------------------------------------------------------------------


def test_truncated_write_detected():
    rng = np.random.default_rng(1)
    blob = pack_shard(ragged_rows(rng, 9), random_meta(rng, 9), rows_per_chunk=2)
    for cut in (1, 2, 7, len(blob) // 2, len(blob) - 1):
        with pytest.raises(TruncatedShard):
            read_footer(blob[:cut])
        with pytest.raises(TruncatedShard):
            unpack_shard(blob[:cut])


def test_corrupted_footer_detected():
    rng = np.random.default_rng(2)
    blob = pack_shard(ragged_rows(rng, 5), random_meta(rng, 5))
    # flip one byte inside the footer json (crc must catch it)
    corrupt = bytearray(blob)
    corrupt[-30] ^= 0xFF
    with pytest.raises(TruncatedShard):
        read_footer(bytes(corrupt))


@given(st.integers(min_value=0, max_value=10_000), st.integers(0, 2**32 - 1))
@settings(max_examples=40, deadline=None)
def test_truncation_property(cut, seed):
    rng = np.random.default_rng(seed)
    rows, meta = ragged_rows(rng, 6), random_meta(rng, 6)
    blob = pack_shard(rows, meta, rows_per_chunk=2)
    cut = min(cut, len(blob))
    if cut == 0:
        out_rows, out_meta = unpack_shard(blob)
        assert out_rows == rows and out_meta == meta
    else:
        # any strict prefix must be rejected, never silently misread
        with pytest.raises(TruncatedShard):
            unpack_shard(blob[:-cut])


# ---------------------------------------------------------------------------
# predicate DSL + pruning soundness
# ---------------------------------------------------------------------------


def test_validate_clauses_rejects():
    with pytest.raises(ColumnarError):
        validate_clauses([("label", "~", 3)])
    with pytest.raises(ColumnarError):
        validate_clauses([("label",)])
    with pytest.raises(ColumnarError):
        validate_clauses([(3, "==", 3)])


PREDICATE_CASES = [
    (("label", "==", 4),),
    (("label", "!=", 4),),
    (("label", "<", 5), ("nbytes", ">=", 300)),
    (("label", "in", (1, 2, 9)),),
    (("label", "not_in", (0, 3)), ("nbytes", "<=", 700)),
    (("nbytes", ">", 999),),
]


def test_predicate_mask_brute_force():
    rng = np.random.default_rng(3)
    cols = {"label": rng.integers(0, 10, size=50),
            "nbytes": rng.integers(0, 1000, size=50)}
    ops = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
           "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
           ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
           "in": lambda a, b: a in b, "not_in": lambda a, b: a not in b}
    for clauses in PREDICATE_CASES:
        mask = predicate_mask(cols, clauses)
        for r in range(50):
            want = all(ops[op](int(cols[f][r]), v) for f, op, v in clauses)
            assert bool(mask[r]) == want, (clauses, r)


def _soundness_check(seed):
    """chunk_matches == False must imply no row in the chunk matches."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 30))
    rows = ragged_rows(rng, n, fields=("a",))
    meta = random_meta(rng, n)
    blob = pack_shard(rows, meta, rows_per_chunk=int(rng.integers(1, 6)))
    footer = read_footer(blob)
    cases = [
        (("label", "==", int(rng.integers(0, 8))),),
        (("label", "in", tuple(int(v) for v in rng.integers(0, 8, size=2))),),
        (("label", "<", int(rng.integers(0, 9))),),
        (("nbytes", ">", int(rng.integers(0, 6000))),),
        (("label", ">=", 4), ("nbytes", "<", 2000)),
        (("label", "not_in", tuple(range(8))),),
        (("length", "<", 10),),  # synthetic per-chunk payload-length column
    ]
    for clauses in cases:
        pruned = [ch for ch in footer["chunks"] if not chunk_matches(ch["stats"], clauses)]
        for ch in pruned:
            for r in range(ch["row_lo"], ch["row_hi"]):
                if any(f == "length" for f, _, _ in clauses):
                    continue  # length is per-chunk-payload, not a meta column
                assert not row_matches(footer["meta"], r, clauses), (
                    f"pruned chunk {ch['field']}[{ch['row_lo']}:{ch['row_hi']}] "
                    f"contains matching row {r} for {clauses}")


def test_pruning_soundness_deterministic():
    for seed in range(25):
        _soundness_check(seed)


@given(st.integers(0, 2**32 - 1))
@settings(max_examples=50, deadline=None)
def test_pruning_soundness_property(seed):
    _soundness_check(seed)


# ---------------------------------------------------------------------------
# store: chunk-granular keys, pruning never fetches payloads
# ---------------------------------------------------------------------------


def test_store_roundtrip(col_base):
    col = ColumnarStore(col_base)
    shards = col.list_shards()
    assert shards == [0, 1, 2]
    footer = col.footer(0)
    assert footer["num_rows"] == 32
    ch = footer["chunks"][0]
    data = col.chunk_bytes(0, ch["field"], 0)
    assert len(data) == ch["size"]


def test_matching_rows_reads_only_footers(col_base):
    counting = CountingStore(col_base)
    col = ColumnarStore(counting)
    for shard in col.list_shards():
        rows = col.matching_rows(shard, (("label", "<", 100),))
        for r in rows:
            assert row_matches(col.footer(shard)["meta"], r, (("label", "<", 100),))
    payload_fetches = [k for k in counting.keys if k.endswith(".bin")]
    assert payload_fetches == []  # pruning is footer-resident: no chunk GETs


def test_projection_fetches_only_requested_rows(col_base):
    counting = CountingStore(col_base)
    ds = ColumnarImageDataset(ColumnarStore(counting), N_ITEMS, out_size=32)
    ds.get_raw(5)
    ds.get_raw(77)
    payload_keys = [k for k in counting.keys if k.endswith(".bin")]
    # 2 rows at rows_per_chunk=4 -> at most 2 pixel-chunk fetches
    assert 1 <= len(payload_keys) <= 2
    assert all("/pixels/" in k for k in payload_keys)


def test_split_rimg_matches_dataset(row_store):
    rec = row_store.get(item_key(3))
    fields, meta = split_rimg(rec)
    assert meta["nbytes"] == len(rec)
    assert set(fields) == {"pixels"}
    with pytest.raises(ColumnarError):
        split_rimg(b"JUNK" + rec[4:])


# ---------------------------------------------------------------------------
# dataset equivalence + sampler pushdown
# ---------------------------------------------------------------------------


def test_columnar_dataset_bit_identical(row_store, col_base):
    cds = ColumnarImageDataset(ColumnarStore(col_base), N_ITEMS, out_size=32, seed=0)
    rds = ImageDataset(row_store, N_ITEMS, out_size=32, seed=0)
    for i in (0, 13, 64, N_ITEMS - 1):
        a, b = cds[i], rds[i]
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (i, k)


def test_predicate_mask_dataset(col_base):
    cds = ColumnarImageDataset(ColumnarStore(col_base), N_ITEMS, out_size=32)
    labels = cds.metadata_column("label")
    mask = cds.predicate_mask((("label", "<", 500),))
    assert mask.shape == (N_ITEMS,)
    assert np.array_equal(mask, labels < 500)


def _loader(ds, **over):
    kw = dict(impl="threaded", batch_size=8, num_workers=2, num_fetch_workers=4,
              shuffle=True, seed=11)
    kw.update(over)
    return ConcurrentDataLoader(ds, LoaderConfig(**kw))


def test_pushdown_epoch_equals_post_filter(row_store, col_base):
    pred = SamplerPredicate(clauses=(("label", "<", 500),))
    cds = ColumnarImageDataset(ColumnarStore(col_base), N_ITEMS, out_size=32, seed=0)
    rds = ImageDataset(row_store, N_ITEMS, out_size=32, seed=0)

    pushdown = [dict(b) for b in _loader(cds, sampler=pred)]
    full = [dict(b) for b in _loader(rds)]

    img, lab, nb = [], [], []
    for b in full:
        m = b["label"] < 500
        img.append(b["image"][m]); lab.append(b["label"][m]); nb.append(b["nbytes"][m])
    img, lab, nb = np.concatenate(img), np.concatenate(lab), np.concatenate(nb)
    assert len(pushdown) == len(lab) // 8
    for i, b in enumerate(pushdown):
        sl = slice(i * 8, (i + 1) * 8)
        assert np.array_equal(b["image"], img[sl])
        assert np.array_equal(b["label"], lab[sl])
        assert np.array_equal(b["nbytes"], nb[sl])


def test_pushdown_fetches_fewer_bytes(col_base):
    pred = SamplerPredicate(clauses=(("label", "<", 250),))
    base = InMemoryStore()
    for k in col_base.list_keys(""):
        base.put(k, col_base.get(k))
    counting = CountingStore(base)
    cds = ColumnarImageDataset(ColumnarStore(counting), N_ITEMS, out_size=32)
    for _ in _loader(cds, sampler=pred):
        pass
    filtered_payload = sum(len(base.get(k)) for k in set(counting.keys)
                           if k.endswith(".bin"))
    total_payload = sum(len(base.get(k)) for k in base.list_keys("")
                        if k.endswith(".bin"))
    # ~25% selectivity: rejected rows' chunks were never requested
    assert filtered_payload < 0.6 * total_payload


def test_sampler_requires_predicate_dataset(row_store):
    rds = ImageDataset(row_store, N_ITEMS, out_size=32)
    with pytest.raises(ValueError, match="predicate"):
        _loader(rds, sampler=SamplerPredicate(clauses=(("label", "<", 10),)))


def test_curriculum_schedule_per_epoch(col_base):
    pred = SamplerPredicate(
        clauses=(("label", "<", 300),),
        schedule=((1, (("label", "<", 700),)), (2, ())),
    )
    assert pred.clauses_for_epoch(0) == (("label", "<", 300),)
    assert pred.clauses_for_epoch(1) == (("label", "<", 700),)
    assert pred.clauses_for_epoch(5) == ()
    cds = ColumnarImageDataset(ColumnarStore(col_base), N_ITEMS, out_size=32)
    loader = _loader(cds, sampler=pred, batch_size=4)
    bounds = [300, 700, 1001]
    for epoch in range(3):
        labels = np.concatenate([b["label"] for b in loader])
        assert labels.size and (labels < bounds[epoch]).all(), epoch


def test_filtered_resume_cursor(col_base):
    """(epoch, next_batch) resume replays the identical filtered stream."""
    cds = ColumnarImageDataset(ColumnarStore(col_base), N_ITEMS, out_size=32)
    mask = cds.predicate_mask((("label", "<", 500),))

    def mk():
        s = ShardedBatchSampler(N_ITEMS, 8, shuffle=True, seed=4)
        s.set_filter(lambda epoch: mask)
        return s

    full = list(mk())
    it = iter(mk_s := mk())
    head = [next(it), next(it)]
    state = mk_s.state_dict()
    resumed = mk()
    resumed.load_state_dict(state)
    tail = list(resumed)
    assert [b.indices for b in head + tail[: len(full) - 2]] == \
        [b.indices for b in full]


# ---------------------------------------------------------------------------
# shuffle entropy metering + the autotune floor
# ---------------------------------------------------------------------------


def test_shuffle_meter_sequential_vs_shuffled():
    n, bs = 256, 16
    seq = _ShuffleMeter(n, NULL_TRACER)
    for k in range(n // bs):
        seq.note_batch(tuple(range(k * bs, (k + 1) * bs)))
    s = seq.snapshot()
    # each sequential batch sits inside one stratum: zero within-batch
    # entropy, and each stratum concentrates in one batch: zero across
    assert s["within_batch"] == 0.0
    assert s["across_batch"] == 0.0

    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    shuf = _ShuffleMeter(n, NULL_TRACER)
    for k in range(n // bs):
        shuf.note_batch(tuple(int(v) for v in perm[k * bs:(k + 1) * bs]))
    t = shuf.snapshot()
    assert t["within_batch"] > 0.7
    assert t["across_batch"] > 0.7


def test_shuffle_meter_empty():
    m = _ShuffleMeter(64, NULL_TRACER)
    assert m.snapshot() == {"within_batch": None, "across_batch": None,
                            "batches": 0}


def _drive(ctrl, steps):
    now = 0.0
    for _ in range(steps):
        now += 0.01
        ctrl.on_batch(1, now=now)


def test_entropy_floor_gates_reorder_up_probe():
    cfg = AutotuneConfig(enabled=True, interval_batches=2, min_window_s=0.0,
                         warmup_windows=0, min_shuffle_entropy=0.9,
                         min_reorder_window=2, max_reorder_window=32)
    vals = {"reorder_window": 2}

    def mk_ctrl(entropy):
        knob = build_reorder_knob(
            cfg, get_reorder=lambda: vals["reorder_window"],
            set_reorder=lambda n: vals.__setitem__(
                "reorder_window", n) or vals["reorder_window"])
        return AutotuneController(cfg, [knob], entropy_fn=lambda: entropy)

    # entropy below the floor: every up-probe is gated, the knob never moves
    vals["reorder_window"] = 2
    ctrl = mk_ctrl(0.5)
    _drive(ctrl, 40)
    assert vals["reorder_window"] == 2
    assert any(e.action == "entropy" for e in ctrl.events)
    assert not any(e.action == "probe" and e.knob == "reorder_window"
                   for e in ctrl.events)

    # entropy above the floor: the same controller probes upward freely
    vals["reorder_window"] = 2
    ctrl = mk_ctrl(0.95)
    _drive(ctrl, 40)
    assert any(e.action == "probe" and e.knob == "reorder_window"
               and e.value > 2 for e in ctrl.events)


def test_reorder_window_live_knob_strict_noop(row_store, col_base):
    """The reorder knob only exists for window mode; strict keeps 1."""
    cds = ColumnarImageDataset(ColumnarStore(col_base), N_ITEMS, out_size=32)
    loader = _loader(
        cds, pipeline=PipelineConfig(enabled=True, reorder="window",
                                     reorder_window=4))
    batches = [dict(b) for b in loader]
    stats = loader.stage_stats()
    assert stats and "shuffle" in stats
    assert stats["shuffle"]["batches"] == len(batches)
    assert 0.0 <= stats["shuffle"]["within_batch"] <= 1.0


# ---------------------------------------------------------------------------
# asyncio IO-stage hedging (first-wins arbitration)
# ---------------------------------------------------------------------------


class StallingStore(ObjectStore):
    """First GET of selected keys stalls; the duplicate returns instantly."""

    def __init__(self, base, stall_s=0.15, every=24):
        self.base = base
        self.stall_s = stall_s
        self.every = every
        self._seen = set()
        import threading
        self._lock = threading.Lock()

    def get(self, key):
        idx = int(key.rsplit("/", 1)[1].split(".")[0])
        with self._lock:
            first = key not in self._seen
            self._seen.add(key)
        if first and idx % self.every == 0 and idx >= 16:
            time.sleep(self.stall_s)
        return self.base.get(key)

    def put(self, key, data):
        self.base.put(key, data)

    def list_keys(self, prefix=""):
        return self.base.list_keys(prefix)

    def size(self, key):
        return self.base.size(key)


def test_asyncio_pipeline_hedging(row_store):
    ds_plain = ImageDataset(row_store, N_ITEMS, out_size=32, seed=0)
    want = digest(_loader(ds_plain, shuffle=False))

    stalling = StallingStore(row_store)
    ds = ImageDataset(stalling, N_ITEMS, out_size=32, seed=0)
    loader = _loader(
        ds, impl="asyncio", shuffle=False,
        pipeline=PipelineConfig(enabled=True, reorder="strict"),
        hedge_requests=True, hedge_factor=1.5, hedge_min_s=0.01)
    got = digest(loader)
    assert got == want  # first-wins arbitration never corrupts the stream
    assert loader.hedge is not None
    assert loader.hedge.hedges_issued > 0


# ---------------------------------------------------------------------------
# across packages: format, predicate, filtered epoch, converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_pack_shard_bytes_equal_the_references_both_ways(seed):
    """The same rows and metadata pack to the same bytes in both packages,
    and each package unpacks the other's shard to those rows and meta."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 20))
    rows, meta = ragged_rows(rng, n, fields=("a", "b", "pixels")), random_meta(rng, n)
    per_chunk = int(rng.integers(1, 6))
    port = pack_shard(rows, meta, rows_per_chunk=per_chunk)
    ref = jcol.pack_shard(rows, meta, rows_per_chunk=per_chunk)
    assert port == ref
    assert jcol.unpack_shard(port) == (rows, meta)
    assert unpack_shard(ref) == (rows, meta)
    assert read_footer(ref) == jcol.read_footer(port)
    cut = int(rng.integers(1, len(port)))
    for unpack, exc in ((unpack_shard, TruncatedShard), (jcol.unpack_shard, jcol.TruncatedShard)):
        with pytest.raises(exc):
            unpack(port[:-cut])


def test_predicate_mask_and_chunk_pruning_equal_the_references():
    rng = np.random.default_rng(7)
    cols = {"label": rng.integers(0, 10, size=200),
            "nbytes": rng.integers(0, 1000, size=200)}
    for clauses in PREDICATE_CASES:
        assert np.array_equal(predicate_mask(cols, clauses),
                              jcol.predicate_mask(cols, clauses))
    footer = read_footer(pack_shard(ragged_rows(rng, 40, fields=("a",)),
                                    random_meta(rng, 40), rows_per_chunk=3))
    for clauses in [(("label", "==", 3),), (("label", "in", (1, 5)),),
                    (("nbytes", "<", 900),), (("label", "not_in", (0, 1, 2, 3)),)]:
        assert [chunk_matches(ch["stats"], clauses) for ch in footer["chunks"]] == \
            [jcol.chunk_matches(ch["stats"], clauses) for ch in footer["chunks"]]


def test_filtered_strict_epoch_equals_the_references():
    """Both packages convert the same row store (built in each) with the
    default clustering and train-load a 25 %-selectivity epoch through
    ``LoaderConfig.sampler``: the same shard bytes, mask and stream."""
    n = 64
    port_rows = build_synthetic_imagenet(InMemoryStore(), n, avg_kb=2.0)
    ref_rows = jax_build(JaxInMemoryStore(), n, avg_kb=2.0)
    port_base, ref_base = InMemoryStore(), JaxInMemoryStore()
    convert_store(port_rows, n, ColumnarStore(port_base), rows_per_shard=16,
                  rows_per_chunk=2)
    jcol.convert_store(ref_rows, n, jcol.ColumnarStore(ref_base), rows_per_shard=16,
                       rows_per_chunk=2)
    keys = sorted(port_base.list_keys(""))
    assert keys == sorted(ref_base.list_keys(""))
    assert all(port_base.get(k) == ref_base.get(k) for k in keys)

    clauses = (("label", "<", 250),)
    cds = ColumnarImageDataset(ColumnarStore(port_base), n, out_size=32, epilogue="device")
    jds = jcol.ColumnarImageDataset(jcol.ColumnarStore(ref_base), n, out_size=32,
                                    epilogue="device")
    assert np.array_equal(cds.predicate_mask(clauses), jds.predicate_mask(clauses))
    kw = dict(impl="threaded", batch_size=4, num_workers=2, num_fetch_workers=4, seed=5)
    got = list(ConcurrentDataLoader(cds, LoaderConfig(
        **kw, sampler=SamplerPredicate(clauses=clauses),
        pipeline=PipelineConfig(enabled=True))))
    want = list(JaxLoader(jds, JaxLoaderConfig(**kw, sampler=JaxSamplerPredicate(clauses=clauses))))
    assert len(got) == len(want) == int(cds.predicate_mask(clauses).sum()) // 4 > 0
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def test_converter_demo_writes_the_reference_scripts_blobs(tmp_path):
    """``python -m repro_torch.tools.convert_to_columnar --demo N`` and the
    reference's ``scripts/convert_to_columnar.py --demo N`` with the same
    flags write the same objects, byte for byte, and print the same report;
    the port's output reads back as a columnar dataset."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    flags = ["--demo", "40", "--rows-per-shard", "16", "--rows-per-chunk", "4"]
    outs = {}
    for name, cmd in (("port", [sys.executable, "-m", "repro_torch.tools.convert_to_columnar"]),
                      ("ref", [sys.executable, str(ROOT / "scripts" / "convert_to_columnar.py")])):
        dst = tmp_path / name
        run = subprocess.run(cmd + flags + ["--dst", str(dst)], capture_output=True, text=True,
                             env=env, cwd=ROOT, timeout=120, check=False)
        assert run.returncode == 0, run.stderr
        outs[name] = (run.stdout.replace(str(dst), "DST"), _files(dst))
    assert outs["port"] == outs["ref"]
    assert len(outs["port"][1]) > 3

    from repro_torch.data.store import LocalFSStore

    ds = ColumnarImageDataset(ColumnarStore(LocalFSStore(str(tmp_path / "port"))), 40,
                              out_size=16)
    assert ds[0]["image"].shape == (3, 16, 16)
