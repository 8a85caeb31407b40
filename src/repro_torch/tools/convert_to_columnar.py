"""Convert existing RIMG datasets (per-item objects or tar shards) into the
columnar shard tier (``repro_torch.data.columnar``).

The columnar layout splits every record into per-field chunks with a footer
index + per-chunk statistics, which is what enables field projection (fetch
only the fields a transform declares) and predicate pushdown (skip chunks
whose stats prove no row matches).  This CLI migrates the two on-store
layouts the repo already produces:

* ``--from items`` — per-item RIMG objects as written by
  ``repro_torch.data.imagenet_synth.build_synthetic_imagenet`` (keys
  ``{prefix}{i:08d}.rimg``).
* ``--from tar``   — tar shards as written by
  ``repro_torch.data.shards.write_shards``
  (keys ``{prefix}{s:06d}.tar``; member names are the original item keys with
  ``/`` replaced by ``__``, so the logical index is recovered from the name).

Examples:

    # migrate a local row store, clustering rows by label for selectivity
    PYTHONPATH=src python -m repro_torch.tools.convert_to_columnar \
        --from items --src /data/rowstore --dst /data/colstore

    # migrate tar shards, keeping the original record order
    PYTHONPATH=src python -m repro_torch.tools.convert_to_columnar \
        --from tar --src /data/shards --dst /data/colstore --cluster-by none

    # no data handy: synthesize a small dataset and convert it in one go
    PYTHONPATH=src python -m repro_torch.tools.convert_to_columnar --demo 512 --dst /tmp/col

Rows are clustered by ``--cluster-by`` (stable sort; default ``label``) before
sharding so chunk statistics become selective — a label predicate then prunes
most chunks outright.  Logical (row-store) indices are preserved in the
``logical`` metadata column, so samplers and resume cursors keep row-store
semantics regardless of physical order.

The reference's converter, flag for flag, over the port's data modules: the
same input gives the same shard blobs.  It imports no ``torch``.
"""
from __future__ import annotations

import argparse
import io
import re
import sys
import tarfile
from typing import Iterator, Tuple

from repro_torch.data.columnar import ColumnarStore, convert_image_records
from repro_torch.data.store import LocalFSStore, ObjectStore

_RIMG_NAME = re.compile(r"(\d+)\.rimg$")


def _logical_from_name(name: str) -> int:
    m = _RIMG_NAME.search(name)
    if m is None:
        raise SystemExit(f"cannot recover a logical index from member {name!r} "
                         "(expected a ...<digits>.rimg name)")
    return int(m.group(1))


def iter_item_records(src: ObjectStore, prefix: str) -> Iterator[Tuple[int, bytes]]:
    keys = [k for k in src.list_keys(prefix) if k.endswith(".rimg")]
    if not keys:
        raise SystemExit(f"no .rimg objects under prefix {prefix!r}")
    for k in keys:
        yield _logical_from_name(k), src.get(k)


def iter_tar_records(src: ObjectStore, prefix: str) -> Iterator[Tuple[int, bytes]]:
    keys = [k for k in src.list_keys(prefix) if k.endswith(".tar")]
    if not keys:
        raise SystemExit(f"no .tar shards under prefix {prefix!r}")
    for sk in keys:
        blob = src.get(sk)
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r") as tar:
            for member in tar.getmembers():
                f = tar.extractfile(member)
                if f is None:
                    continue
                yield _logical_from_name(member.name), f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--from", dest="src_kind", choices=("items", "tar"),
                    default="items", help="source layout (default: items)")
    ap.add_argument("--src", help="source store directory (LocalFSStore root)")
    ap.add_argument("--dst", required=True,
                    help="destination store directory (LocalFSStore root)")
    ap.add_argument("--src-prefix", default=None,
                    help="source key prefix (default: imagenet/train/ for "
                         "items, shards/train/ for tar)")
    ap.add_argument("--dst-prefix", default="columnar/train/",
                    help="columnar shard key prefix in the destination")
    ap.add_argument("--rows-per-shard", type=int, default=256)
    ap.add_argument("--rows-per-chunk", type=int, default=8,
                    help="rows per field chunk (fetch granularity; 1 = "
                         "per-row chunks, larger amortizes request latency)")
    ap.add_argument("--cluster-by", default="label",
                    help="metadata column to cluster rows by before sharding "
                         "(stable sort; 'none' keeps logical order)")
    ap.add_argument("--demo", type=int, default=0, metavar="N",
                    help="synthesize an N-item dataset in memory and convert "
                         "it (no --src needed)")
    args = ap.parse_args(argv)

    if args.demo:
        from repro_torch.data.imagenet_synth import build_synthetic_imagenet
        from repro_torch.data.store import InMemoryStore

        src: ObjectStore = InMemoryStore()
        build_synthetic_imagenet(src, args.demo, avg_kb=4.0)
        src_prefix = "imagenet/train/"
        records = iter_item_records(src, src_prefix)
    else:
        if not args.src:
            ap.error("--src is required (or use --demo N)")
        src = LocalFSStore(args.src)
        src_prefix = args.src_prefix or (
            "imagenet/train/" if args.src_kind == "items" else "shards/train/")
        records = (iter_item_records if args.src_kind == "items"
                   else iter_tar_records)(src, src_prefix)

    cluster = None if args.cluster_by in ("none", "") else args.cluster_by
    dst = ColumnarStore(LocalFSStore(args.dst), prefix=args.dst_prefix)
    rows = 0
    in_bytes = 0
    out_bytes = 0

    def counted() -> Iterator[Tuple[int, bytes]]:
        nonlocal rows, in_bytes
        for logical, rec in records:
            rows += 1
            in_bytes += len(rec)
            yield logical, rec

    shards = 0
    for shards, blob in enumerate(
            convert_image_records(counted(),
                                  rows_per_shard=args.rows_per_shard,
                                  rows_per_chunk=args.rows_per_chunk,
                                  cluster_by=cluster), start=1):
        out_bytes += len(blob)
        dst.put_shard_blob(shards - 1, blob)

    overhead = (out_bytes - in_bytes) / in_bytes if in_bytes else 0.0
    print(f"converted {rows} rows -> {shards} columnar shards "
          f"under {args.dst}:{args.dst_prefix}")
    print(f"  bytes in {in_bytes}, bytes out {out_bytes} "
          f"(footer/index overhead {overhead:+.2%})")
    print(f"  rows_per_shard={args.rows_per_shard} "
          f"rows_per_chunk={args.rows_per_chunk} cluster_by={cluster}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
