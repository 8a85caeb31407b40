"""Tar shard streaming (``repro_torch.data.shards``) held to the reference's
``repro.data.shards`` on the same store.  No reference test covers the
module, so these compare the two packages directly: ``write_shards`` gives
the same shard keys and the same tar bytes (member names and member bytes
equal each item object), ``ShardedIterableDataset`` gives the same items
(images bit for bit, labels, byte counts) with and without a shuffle buffer
and across epochs, each shard costs one GET with the next one fetched in
the background, and the columnar converter reads the port's tar shards."""
import io
import os
import subprocess
import sys
import tarfile
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import shards as jshards  # noqa: E402
from repro.data.store import InMemoryStore as JaxInMemoryStore  # noqa: E402
from repro_torch.data import codec  # noqa: E402
from repro_torch.data.columnar import ColumnarImageDataset, ColumnarStore  # noqa: E402
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import build_synthetic_imagenet, item_key  # noqa: E402
from repro_torch.data.shards import ShardedIterableDataset, shard_key, write_shards  # noqa: E402
from repro_torch.data.store import InMemoryStore, LocalFSStore, ObjectStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS, PER_SHARD = 40, 8


class CountingStore(ObjectStore):
    """Counts GETs by key, and the threads that issued them."""

    def __init__(self, base):
        self.base = base
        self.keys = []
        self.threads = set()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            self.keys.append(key)
            self.threads.add(threading.current_thread().name)
        return self.base.get(key)

    def put(self, key, data):
        self.base.put(key, data)

    def list_keys(self, prefix=""):
        return self.base.list_keys(prefix)

    def size(self, key):
        return self.base.size(key)


@pytest.fixture(scope="module")
def src():
    return build_synthetic_imagenet(InMemoryStore(), N_ITEMS, avg_kb=3.0)


@pytest.fixture(scope="module")
def written(src):
    keys = [item_key(i) for i in range(N_ITEMS)]
    port, ref = InMemoryStore(), JaxInMemoryStore()
    port_keys = write_shards(src, port, keys, items_per_shard=PER_SHARD)
    ref_keys = jshards.write_shards(src, ref, keys, items_per_shard=PER_SHARD)
    return keys, port, ref, port_keys, ref_keys


def _members(blob):
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r") as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]


def test_write_shards_gives_the_references_keys_and_bytes(src, written):
    keys, port, ref, port_keys, ref_keys = written
    assert port_keys == ref_keys == [shard_key(s) for s in range(N_ITEMS // PER_SHARD)]
    assert shard_key(3, "x/") == jshards.shard_key(3, "x/") == "x/000003.tar"
    for sk in port_keys:
        assert port.get(sk) == ref.get(sk)
    members = [m for sk in port_keys for m in _members(port.get(sk))]
    # member names are the item keys with "/" replaced, in order, and each
    # member's bytes are its item object's
    assert [name for name, _ in members] == [k.replace("/", "__") for k in keys]
    assert all(data == src.get(k) for (_, data), k in zip(members, keys, strict=True))


def test_a_ragged_last_shard_matches_the_reference(src):
    keys = [item_key(i) for i in range(13)]
    port, ref = InMemoryStore(), JaxInMemoryStore()
    got = write_shards(src, port, keys, items_per_shard=5, prefix="p/")
    want = jshards.write_shards(src, ref, keys, items_per_shard=5, prefix="p/")
    assert got == want == ["p/000000.tar", "p/000001.tar", "p/000002.tar"]
    assert [len(_members(port.get(k))) for k in got] == [5, 5, 3]
    assert all(port.get(k) == ref.get(k) for k in got)


def _items(ds, epochs):
    out = []
    for e in range(epochs):
        ds.set_epoch(e)
        out.append(list(ds))
    return out


@pytest.mark.parametrize("shuffle_buffer", [0, 16])
@pytest.mark.parametrize("augment", [True, False])
def test_iterable_dataset_items_equal_the_references(written, shuffle_buffer, augment):
    _, port, ref, port_keys, _ = written
    kw = dict(out_size=24, augment=augment, seed=3, shuffle_buffer=shuffle_buffer)
    got = _items(ShardedIterableDataset(port, port_keys, **kw), 2)
    want = _items(jshards.ShardedIterableDataset(ref, port_keys, **kw), 2)
    for ge, we in zip(got, want, strict=True):
        assert len(ge) == len(we) == N_ITEMS
        for g, w in zip(ge, we, strict=True):
            assert set(g) == set(w) == {"image", "label", "nbytes"}
            for k in g:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    if shuffle_buffer:
        # a buffer reorders the stream, and differently each epoch
        assert [int(x["label"]) for x in got[0]] != [int(x["label"]) for x in got[1]]


def test_stream_covers_every_item_once_with_one_get_a_shard(src, written):
    keys, port, _, port_keys, _ = written
    labels = sorted(codec.decode_image(src.get(k)).label for k in keys)
    counting = CountingStore(port)
    ds = ShardedIterableDataset(counting, port_keys, out_size=24, shuffle_buffer=16)
    for e in range(2):
        ds.set_epoch(e)
        counting.keys.clear()
        items = list(ds)
        assert sorted(int(x["label"]) for x in items) == labels
        assert counting.keys == port_keys  # one GET a shard, in order
    # the next shard is fetched on the background thread
    assert counting.threads and all(t.startswith("shard-prefetch") for t in counting.threads)


def test_augment_rng_is_keyed_by_the_stream_index(src, written):
    """Without a shuffle buffer the stream holds the items in key order, and
    item i is the row-store ``ImageDataset``'s item i of the same epoch (the
    augment rng of both is keyed by (seed, epoch, index))."""
    keys, port, _, port_keys, _ = written
    rows = ImageDataset(src, N_ITEMS, out_size=24, seed=3)
    ds = ShardedIterableDataset(port, port_keys, out_size=24, seed=3)
    for e in (0, 1):
        ds.set_epoch(e)
        rows.set_epoch(e)
        for i, item in enumerate(ds):
            want = rows[i]
            assert np.array_equal(item["image"], want["image"])
            assert int(item["label"]) == int(want["label"])


def test_converter_reads_the_ports_tar_shards(src, tmp_path):
    """``convert_to_columnar --from tar`` over tar shards written by the
    port: a columnar dataset over its output gives the row store's items."""
    keys = [item_key(i) for i in range(N_ITEMS)]
    shards_dir = tmp_path / "shards"
    write_shards(src, LocalFSStore(str(shards_dir)), keys, items_per_shard=PER_SHARD)
    dst = tmp_path / "col"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.convert_to_columnar", "--from", "tar",
         "--src", str(shards_dir), "--dst", str(dst), "--rows-per-shard", "16"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120, check=False)
    assert run.returncode == 0, run.stderr
    assert f"converted {N_ITEMS} rows -> 3 columnar shards" in run.stdout
    cds = ColumnarImageDataset(ColumnarStore(LocalFSStore(str(dst))), N_ITEMS, out_size=24)
    rows = ImageDataset(src, N_ITEMS, out_size=24)
    for i in (0, 7, N_ITEMS - 1):
        a, b = cds[i], rows[i]
        assert all(np.array_equal(a[k], b[k]) for k in b)
