"""Device-sharded delivery in the port (``repro_torch.core.delivery``, the
loader's lane cursors, ``DeliverySpec``, ``make_loader``'s mesh) against the
JAX reference: twins of ``tests/test_delivery.py``, of
``tests/test_config_api.py``'s ``TestDeliverySpec`` and sharded-validation
tests, and of ``tests/test_shm_transport.py``'s sharded-delivery test.

The reference's 4-device runs need ``XLA_FLAGS`` set before jax starts, so
they run in ONE subprocess (``reference_runs``) that returns every
reference result at once; the port runs the same loaders over a mesh of
``["cpu"] * 4``, four lanes composing one tensor on the CPU.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import (  # noqa: E402
    AutotuneConfig,
    DeliverySpec,
    ElasticConfig,
    LoaderConfig,
    MeshConfig,
    ModelConfig,
    PipelineConfig,
    RunConfig,
)
from repro_torch.core import make_loader  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.prefetch import DevicePrefetchRing  # noqa: E402
from repro_torch.core.tracing import BATCH_TO_DEVICE, LANE_H2D, Tracer  # noqa: E402
from repro_torch.data.dataset import ImageDataset  # noqa: E402
from repro_torch.data.imagenet_synth import SyntheticImageStore  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_world as worlds  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# LanePlan over a fake mesh (no device requirements)
# --------------------------------------------------------------------------


def _fake_mesh(axis_sizes, axis_names, process_of=lambda i: 0):
    """Duck-typed mesh: LanePlan.build touches axis_names, shape, devices,
    and each device's process_index."""
    n = int(np.prod(axis_sizes))
    devs = np.array(
        [types.SimpleNamespace(id=i, process_index=process_of(i)) for i in range(n)],
        dtype=object,
    ).reshape(axis_sizes)
    return types.SimpleNamespace(
        axis_names=tuple(axis_names),
        shape=dict(zip(axis_names, axis_sizes)),
        devices=devs,
    )


class TestLanePlan:
    def test_requires_mesh(self):
        from repro_torch.core.delivery import LanePlan

        with pytest.raises(ValueError, match="needs a mesh"):
            LanePlan.build(DeliverySpec(kind="sharded"), 8)

    def test_axis_must_exist(self):
        from repro_torch.core.delivery import LanePlan

        mesh = _fake_mesh((4,), ("data",))
        spec = DeliverySpec.sharded(mesh, axis="model")
        with pytest.raises(ValueError, match="not a mesh axis"):
            LanePlan.build(spec, 8, process_index=0)

    def test_one_lane_per_data_slice_replicated_over_model(self):
        from repro_torch.core.delivery import LanePlan

        mesh = _fake_mesh((4, 2), ("data", "model"))
        plan = LanePlan.build(DeliverySpec.sharded(mesh), 8, process_index=0)
        assert plan.num_lanes == 4
        # each lane holds both model-axis devices of its data slice
        assert [len(lane) for lane in plan.lanes] == [2] * 4
        assert plan.global_mult == 1
        assert plan.global_rows(8) == 8

    def test_multi_host_slice_scales_global_rows(self):
        from repro_torch.core.delivery import LanePlan

        # 8-wide data axis split over 2 processes -> 4 local lanes, and the
        # composed global array spans both hosts' rows
        mesh = _fake_mesh((8,), ("data",), process_of=lambda i: i // 4)
        plan = LanePlan.build(DeliverySpec.sharded(mesh), 8, process_index=1)
        assert plan.num_lanes == 4
        assert plan.global_mult == 2
        assert plan.global_rows(8) == 16
        assert [d.id for lane in plan.lanes for d in lane] == [4, 5, 6, 7]

    def test_no_addressable_devices_rejected(self):
        from repro_torch.core.delivery import LanePlan

        mesh = _fake_mesh((4,), ("data",))
        with pytest.raises(ValueError, match="no devices addressable"):
            LanePlan.build(DeliverySpec.sharded(mesh), 8, process_index=9)

    def test_indivisible_host_batch_rejected(self):
        from repro_torch.core.delivery import LanePlan

        mesh = _fake_mesh((4,), ("data",))
        with pytest.raises(ValueError, match="does not divide evenly"):
            LanePlan.build(DeliverySpec.sharded(mesh), 6, process_index=0)


SPAN_WORLD = r"""
import json, sys, types
import numpy as np
from repro_torch.config import DeliverySpec, LoaderConfig, PipelineConfig
from repro_torch.core.delivery import LanePlan
from repro_torch.core.loader import ConcurrentDataLoader
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_mesh

dist.init_process_group("gloo", sys.argv[1], "cpu", timeout_s=120)
r = dist.rank()


def fake(n):
    devs = np.array([types.SimpleNamespace(id=i, process_index=i) for i in range(n)],
                    dtype=object)
    return types.SimpleNamespace(axis_names=("data",), shape={"data": n}, devices=devs)


rec = {"fake_device": LanePlan.build(DeliverySpec.sharded(fake(2)), 4).compose_device().id}
try:
    LanePlan.build(DeliverySpec.sharded(fake(4)), 2).compose_device()
except ValueError as e:
    rec["four_in_two"] = str(e)
loader = ConcurrentDataLoader(list(range(16)), LoaderConfig(
    batch_size=8, pipeline=PipelineConfig(enabled=True),
    delivery=DeliverySpec.sharded(make_mesh((2,), ("data",)))))
plan = loader.delivery_plan
rec.update(lanes=plan.num_lanes, global_mult=plan.global_mult, host_rows=plan.host_rows,
           host=[loader.host_id, loader.num_hosts], device=str(plan.compose_device()))
print(json.dumps(rec))
dist.destroy_process_group()
"""


def test_lanes_on_distinct_devices_are_refused(tmp_path):
    """One process composes one tensor on one device: a plan whose lanes lie
    on distinct devices of one process is refused at the loader's
    construction.  A plan whose global batch spans processes is refused
    without a process group, and accepted in a gloo world of that size, where
    each rank composes its own rows (one lane, half the batch) on its own
    device; a world of another size still refuses it."""
    from repro_torch.core.delivery import LanePlan

    distinct = _fake_mesh((4,), ("data",))
    plan = LanePlan.build(DeliverySpec.sharded(distinct), 8)
    with pytest.raises(ValueError, match="span 4 devices of one process"):
        plan.compose_device()
    spanning = LanePlan.build(DeliverySpec.sharded(
        _fake_mesh((2,), ("data",), process_of=lambda i: i)), 4, process_index=0)
    assert spanning.num_lanes == 1 and spanning.global_mult == 2
    with pytest.raises(ValueError, match="spans 2 processes.*1 rank"):
        spanning.compose_device()
    with pytest.raises(ValueError, match="devices of one process"):
        ConcurrentDataLoader(list(range(16)), LoaderConfig(
            batch_size=8, pipeline=PipelineConfig(enabled=True),
            delivery=DeliverySpec.sharded(distinct)))
    shared = LanePlan.build(DeliverySpec.sharded(make_mesh((4,), ("data",), ["cpu"] * 4)), 8)
    assert shared.compose_device() == torch.device("cpu")

    ranks = worlds.run_world(["-c", SPAN_WORLD, worlds.init_url(tmp_path)], 2, timeout_s=180)
    for r, (rc, out, err) in enumerate(ranks):
        assert rc == 0, err[-3000:]
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["fake_device"] == r
        assert "spans 4 processes" in rec["four_in_two"] and "2 rank(s)" in rec["four_in_two"]
        assert (rec["lanes"], rec["global_mult"], rec["host_rows"]) == (1, 2, 4)
        assert rec["host"] == [r, 2] and rec["device"] == "cpu"


# --------------------------------------------------------------------------
# fleet cursor board
# --------------------------------------------------------------------------


class TestShardCursorBoard:
    def test_aligned_none_until_all_hosts_publish(self, tmp_path):
        from repro_torch.core.delivery import ShardCursorBoard

        board = ShardCursorBoard(str(tmp_path), num_hosts=2)
        assert board.aligned() is None
        board.publish(0, 0, 7)
        assert board.aligned() is None
        board.publish(1, 0, 5)
        assert board.aligned() == (0, 5)

    def test_aligned_is_fleet_minimum_ordered_by_epoch(self, tmp_path):
        from repro_torch.core.delivery import ShardCursorBoard

        board = ShardCursorBoard(str(tmp_path), num_hosts=2)
        board.publish(0, 1, 2)  # ahead by an epoch
        board.publish(1, 0, 9)
        assert board.aligned() == (0, 9)

    def test_republish_overwrites(self, tmp_path):
        from repro_torch.core.delivery import ShardCursorBoard

        board = ShardCursorBoard(str(tmp_path), num_hosts=1)
        board.publish(0, 0, 3)
        board.publish(0, 0, 8)
        assert board.aligned() == (0, 8)

    def test_two_boards_share_one_document(self, tmp_path):
        from repro_torch.core.delivery import ShardCursorBoard

        a = ShardCursorBoard(str(tmp_path), num_hosts=2)
        b = ShardCursorBoard(str(tmp_path), num_hosts=2)
        a.publish(0, 0, 4)
        b.publish(1, 0, 6)
        assert a.aligned() == b.aligned() == (0, 4)


def test_board_written_by_the_reference_is_read_by_the_port(tmp_path):
    """The two packages' boards share one append log: a fleet of a
    reference host and a port host aligns to its minimum."""
    from repro.core.delivery import ShardCursorBoard as JaxBoard
    from repro_torch.core.delivery import ShardCursorBoard

    JaxBoard(str(tmp_path), num_hosts=2).publish(0, 1, 3)
    port = ShardCursorBoard(str(tmp_path), num_hosts=2)
    port.publish(1, 1, 2)
    assert port.aligned() == JaxBoard(str(tmp_path), num_hosts=2).aligned() == (1, 2)


# --------------------------------------------------------------------------
# checkpoint validation (host side, no mesh needed)
# --------------------------------------------------------------------------


def test_host_loader_rejects_sharded_checkpoint():
    loader = ConcurrentDataLoader([0] * 8, LoaderConfig(batch_size=4))
    with pytest.raises(ValueError, match="host batches"):
        loader.load_state_dict({
            "epoch": 0, "next_batch": 2,
            "delivery": {"kind": "sharded", "axis": "data", "num_lanes": 4, "lanes": []},
        })


# --------------------------------------------------------------------------
# DeliverySpec and the loader's validation (twins of test_config_api.py)
# --------------------------------------------------------------------------


class TestDeliverySpec:
    def test_default_is_host(self):
        cfg = LoaderConfig()
        assert cfg.delivery.kind == "host"
        assert DeliverySpec.host() == DeliverySpec()

    def test_sharded_factory(self):
        mesh = object()  # opaque at the config layer
        spec = DeliverySpec.sharded(mesh, axis="pod", coord_dir="/tmp/x")
        assert spec.kind == "sharded"
        assert spec.mesh is mesh
        assert spec.axis == "pod"
        assert spec.coord_dir == "/tmp/x"

    def test_config_module_does_not_import_torch(self):
        """The reference's twin checks jax; the port's config and core stay
        torch-free (spawned CPU workers import them)."""
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
             "import repro_torch.config; import repro_torch.core; "
             "import repro_torch.core.delivery; print('torch' in sys.modules)"],
            capture_output=True, text=True, env=env, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "False"


class TestLoaderValidation:
    def test_unknown_delivery_kind_rejected(self):
        with pytest.raises(ValueError, match="delivery"):
            ConcurrentDataLoader(
                [0] * 8, LoaderConfig(batch_size=4, delivery=DeliverySpec(kind="bogus")))

    def test_sharded_requires_pipeline(self):
        with pytest.raises(ValueError, match="pipeline"):
            ConcurrentDataLoader(
                [0] * 8, LoaderConfig(batch_size=4, delivery=DeliverySpec(kind="sharded")))

    def test_sharded_requires_strict_reorder(self):
        with pytest.raises(ValueError, match="strict"):
            ConcurrentDataLoader(
                [0] * 8,
                LoaderConfig(batch_size=4,
                             pipeline=PipelineConfig(enabled=True, reorder="window"),
                             delivery=DeliverySpec(kind="sharded")))


def test_elastic_mode_refuses_sharded_delivery(tmp_path):
    """Elastic membership and sharded delivery never meet: sharded delivery
    needs the staged pipeline and the elastic loader the legacy path, so
    one of those guards refuses first, as in the reference; behind them
    stands the reference's own elastic guard
    (``src/repro/core/loader.py:223-227``: lane cursors assume a static
    host-to-shard mapping)."""
    mesh = make_mesh((1,), ("data",), ["cpu"])
    for pipe, match in ((PipelineConfig(enabled=True), "elastic mode"),
                        (PipelineConfig(), "requires the staged pipeline")):
        with pytest.raises(ValueError, match=match):
            ConcurrentDataLoader(list(range(16)), LoaderConfig(
                batch_size=8, pipeline=pipe, delivery=DeliverySpec.sharded(mesh),
                elastic=ElasticConfig(enabled=True, coord_dir=str(tmp_path))))


# --------------------------------------------------------------------------
# end to end on 4 lanes (reference in one 4-device subprocess)
# --------------------------------------------------------------------------

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import numpy as np
import jax
from repro.config import DeliverySpec, LoaderConfig, PipelineConfig
from repro.core import make_loader
from repro.data.dataset import ImageDataset
from repro.data.imagenet_synth import SyntheticImageStore
from repro.launch.mesh import make_mesh

out_dir = sys.argv[1]
mesh = make_mesh((4,), ("data",))


def loader(delivery, items=96, **pipe):
    return make_loader(
        LoaderConfig(batch_size=16, seed=3,
                     pipeline=PipelineConfig(enabled=True, io_workers=8, **pipe),
                     delivery=delivery),
        ImageDataset(SyntheticImageStore(items, seed=0, avg_kb=4), items, out_size=32,
                     augment=False),
    )


def host_arrays(batches):
    return [{k: np.asarray(jax.device_get(v)) for k, v in b.items()} for b in batches]


def save(name, batches):
    np.savez(os.path.join(out_dir, name + ".npz"),
             **{f"{i}/{k}": v for i, b in enumerate(host_arrays(batches)) for k, v in b.items()})


rec = {}
host = list(loader(DeliverySpec.host()))
sharded_loader = loader(DeliverySpec.sharded(mesh))
sharded = list(sharded_loader)
save("host", host)
save("sharded", sharded)
stats = sharded_loader.stage_stats()["delivery"]
rec["num_lanes"] = stats["num_lanes"]
rec["per_lane_composed"] = [l["composed"] for l in stats["lanes"]]
rec["lane_skew"] = stats["lane_skew"]

first = loader(DeliverySpec.sharded(mesh))
it = iter(first)
for _ in range(2):
    next(it)
state = first.state_dict()
it.shutdown()
rec["state"] = state
resumed = loader(DeliverySpec.sharded(mesh))
resumed.load_state_dict(state)
save("resumed", list(resumed))
state2 = dict(state)
state2["delivery"] = dict(state["delivery"], num_lanes=2)
try:
    loader(DeliverySpec.sharded(mesh)).load_state_dict(state2)
    rec["lane_mismatch_raises"] = False
except ValueError:
    rec["lane_mismatch_raises"] = True

shm_kw = dict(cpu_workers=2, cpu_executor="process", transport="shm", slab_slots=8,
              staging_buffers=2)
shm_loader = loader(DeliverySpec.sharded(mesh), items=48, **shm_kw)
save("shm_sharded", list(shm_loader))
st = shm_loader.stage_stats()
rec["shm"] = {"kind": st["transport"]["kind"], "shm_samples": st["transport"]["shm_samples"],
              "lane_staging": [p["leases"] for p in st["delivery"]["staging"]]}
print(json.dumps(rec))
'''


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference_delivery")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(out_dir)], capture_output=True,
                         text=True, env=env, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])

    def load(name):
        with np.load(out_dir / f"{name}.npz") as z:
            flat = {k: z[k] for k in z.files}
        n = 1 + max(int(k.split("/")[0]) for k in flat)
        return [{k.split("/", 1)[1]: v for k, v in flat.items() if k.split("/")[0] == str(i)}
                for i in range(n)]

    rec["batches"] = {name: load(name) for name in ("host", "sharded", "resumed", "shm_sharded")}
    return rec


MESH4 = ["cpu"] * 4


def _loader(delivery, items=96, **pipe):
    return make_loader(
        LoaderConfig(batch_size=16, seed=3,
                     pipeline=PipelineConfig(enabled=True, io_workers=8, **pipe),
                     delivery=delivery),
        ImageDataset(SyntheticImageStore(items, seed=0, avg_kb=4), items, out_size=32,
                     augment=False),
    )


def _as_numpy(b):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in b.items()}


def _equal(got, want):
    return len(got) == len(want) and all(
        set(g) == set(w) and all(np.array_equal(_as_numpy(g)[k], w[k]) for k in w)
        for g, w in zip(got, want))


def test_sharded_delivery_end_to_end_4dev(reference_runs):
    """Four lanes over ``["cpu"] * 4``: the composed batches equal the host
    path's and the reference's sharded batches bit for bit, in stream order;
    the lanes compose in lockstep; the lane cursors after two batches are
    the reference's state; a resumed loader yields the reference's resumed
    stream; a checkpoint of another lane count is refused."""
    ref = reference_runs
    mesh = make_mesh((4,), ("data",), MESH4)
    host = list(_loader(DeliverySpec.host()))
    sharded_loader = _loader(DeliverySpec.sharded(mesh))
    assert sharded_loader.delivers_device_batches
    sharded = list(sharded_loader)
    assert _equal(host, ref["batches"]["host"])
    assert _equal(sharded, ref["batches"]["sharded"])
    assert all(isinstance(v, torch.Tensor) for b in sharded for v in b.values())
    stats = sharded_loader.stage_stats()["delivery"]
    assert stats["num_lanes"] == ref["num_lanes"] == 4
    per_lane = [ln["composed"] for ln in stats["lanes"]]
    assert per_lane == ref["per_lane_composed"] and len(set(per_lane)) == 1
    assert stats["lane_skew"] == ref["lane_skew"] == 0

    first = _loader(DeliverySpec.sharded(mesh))
    it = iter(first)
    for _ in range(2):
        next(it)
    state = first.state_dict()
    it.shutdown()
    assert [ln["next_batch"] for ln in state["delivery"]["lanes"]] == [2, 2, 2, 2]


    def no_devices(st):  # the stand-in's four lanes share one device, id 0
        return dict(st, delivery=dict(st["delivery"], lanes=[
            {k: v for k, v in ln.items() if k != "devices"} for ln in st["delivery"]["lanes"]]))

    assert no_devices(state) == no_devices(ref["state"])
    assert [ln["devices"] for ln in state["delivery"]["lanes"]] == [[0]] * 4
    resumed = _loader(DeliverySpec.sharded(mesh))
    resumed.load_state_dict(state)
    assert _equal(list(resumed), ref["batches"]["resumed"])

    assert ref["lane_mismatch_raises"]
    state2 = dict(state, delivery=dict(state["delivery"], num_lanes=2))
    with pytest.raises(ValueError, match="delivery lanes"):
        _loader(DeliverySpec.sharded(mesh)).load_state_dict(state2)


def test_shm_transport_with_sharded_delivery_4dev(reference_runs):
    """Twin of ``test_shm_transport.py``'s sharded test: the process CPU
    stage's shm transport under four lanes, each with its own staging pool:
    the reference's batches, samples through the slab, every lane leasing
    staging sets."""
    ref = reference_runs
    mesh = make_mesh((4,), ("data",), MESH4)
    loader = _loader(DeliverySpec.sharded(mesh), items=48, cpu_workers=2,
                     cpu_executor="process", transport="shm", slab_slots=8,
                     staging_buffers=2)
    try:
        got = list(loader)
        stats = loader.stage_stats()
    finally:
        loader.close()
    assert _equal(got, ref["batches"]["shm_sharded"])
    host48 = list(_loader(DeliverySpec.host(), items=48))
    assert _equal(got, [_as_numpy(b) for b in host48])
    assert stats["transport"]["kind"] == ref["shm"]["kind"] == "shm"
    assert stats["transport"]["shm_samples"] > 0 and ref["shm"]["shm_samples"] > 0
    leases = [p["leases"] for p in stats["delivery"]["staging"]]
    assert all(n > 0 for n in leases) and all(n > 0 for n in ref["shm"]["lane_staging"])


def test_torn_lane_cursors_resume_from_the_minimum():
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    loader = _loader(DeliverySpec.sharded(mesh))
    loader.load_state_dict({
        "epoch": 0, "next_batch": 4,
        "delivery": {"kind": "sharded", "axis": "data", "num_lanes": 2,
                     "lanes": [{"lane": 0, "next_batch": 4}, {"lane": 1, "next_batch": 3}]},
    })
    assert loader.state_dict()["next_batch"] == 3
    unbroken = list(_loader(DeliverySpec.sharded(mesh)))
    assert _equal(list(loader), [_as_numpy(b) for b in unbroken[3:]])


def test_state_dict_pins_the_fleet_minimum(tmp_path):
    """With a coord dir the loader publishes its cursor and resumes from the
    newest boundary every host delivered (the reference's
    ``src/repro/core/loader.py:384-465``)."""
    from repro_torch.core.delivery import ShardCursorBoard

    mesh = make_mesh((1,), ("data",), ["cpu"])
    loader = ConcurrentDataLoader(list(range(32)), LoaderConfig(
        batch_size=8, pipeline=PipelineConfig(enabled=True),
        delivery=DeliverySpec.sharded(mesh, coord_dir=str(tmp_path))), num_hosts=1)
    ShardCursorBoard(str(tmp_path), num_hosts=1)  # same log
    assert loader.cursor_state(0, 3)["next_batch"] == 3
    # a two-host fleet whose other host is behind
    fleet = ConcurrentDataLoader(list(range(32)), LoaderConfig(
        batch_size=8, pipeline=PipelineConfig(enabled=True),
        delivery=DeliverySpec.sharded(mesh, coord_dir=str(tmp_path / "f"))),
        host_id=0, num_hosts=2)
    ShardCursorBoard(str(tmp_path / "f"), num_hosts=2).publish(1, 0, 1)
    st = fleet.cursor_state(0, 3)
    assert (st["epoch"], st["next_batch"]) == (0, 1)
    assert [ln["next_batch"] for ln in st["delivery"]["lanes"]] == [1]


def test_make_loader_takes_a_run_config():
    """``make_loader(RunConfig)``: host delivery needs no mesh; sharded
    delivery takes an explicit ``mesh=``, or builds one from
    ``RunConfig.mesh`` over the visible CUDA devices (so it raises on a host
    without a card); with no mesh at all a ``LoaderConfig`` is refused."""
    data = list(range(32))
    host = RunConfig(model=ModelConfig(), loader=LoaderConfig(batch_size=8))
    assert make_loader(host, data).delivery_plan is None
    sharded_cfg = LoaderConfig(batch_size=8, pipeline=PipelineConfig(enabled=True),
                               delivery=DeliverySpec(kind="sharded"))
    run = RunConfig(model=ModelConfig(), loader=sharded_cfg,
                    mesh=MeshConfig((2,), ("data",)))
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    loader = make_loader(run, data, mesh=mesh)
    assert loader.delivery_plan.num_lanes == 2 and loader.cfg.delivery.mesh is mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_loader(run, data)
    with pytest.raises(ValueError, match="has no mesh"):
        make_loader(sharded_cfg, data)
    with pytest.raises(TypeError, match="RunConfig or LoaderConfig"):
        make_loader(object(), data)


def test_ring_copies_nothing_under_sharded_delivery():
    """The ring over a sharded loader (``transfer=False``) records no
    ``batch_to_device`` span and moves 0 bytes, while the lanes record one
    ``lane_h2d`` span a batch; ``ingest_fn`` still runs on every batch; a
    host batch handed to such a ring raises instead of being copied."""
    mesh = make_mesh((1,), ("data",), ["cpu"])
    tracer = Tracer()
    loader = make_loader(
        LoaderConfig(batch_size=16, seed=3, pipeline=PipelineConfig(enabled=True, io_workers=8),
                     delivery=DeliverySpec.sharded(mesh)),
        ImageDataset(SyntheticImageStore(64, seed=0, avg_kb=4), 64, out_size=32,
                     augment=False), tracer=tracer)
    seen = []

    def ingest(b):
        seen.append(b["image"].dtype)
        return {**b, "image": b["image"].float() / 255}

    ring = DevicePrefetchRing(iter(loader), transfer=False, tracer=tracer, ingest_fn=ingest,
                              device="cpu")
    out = list(ring)
    ring.close()
    assert len(out) == 4 and all(b["image"].dtype == torch.float32 for b in out)
    assert len(seen) == 4
    assert ring.bytes_transferred == 0 and tracer.spans(BATCH_TO_DEVICE) == []
    assert len(tracer.spans(LANE_H2D)) == 4
    host_ring = DevicePrefetchRing(iter([{"image": np.zeros((2, 2), np.uint8)}]),
                                   transfer=False, device="cpu")
    with pytest.raises(ValueError, match="copies nothing"):
        list(host_ring)


def test_skew_gate_is_wired_only_under_sharded_delivery():
    mesh = make_mesh((1,), ("data",), ["cpu"])
    at = AutotuneConfig(enabled=True, skew_gate=2)
    pipe = PipelineConfig(enabled=True)
    sharded = ConcurrentDataLoader(list(range(32)), LoaderConfig(
        batch_size=8, pipeline=pipe, autotune=at, delivery=DeliverySpec.sharded(mesh)))
    host = ConcurrentDataLoader(list(range(32)), LoaderConfig(
        batch_size=8, pipeline=pipe, autotune=at))
    assert sharded.autotuner.skew_fn is not None and host.autotuner.skew_fn is None
    assert sharded.autotuner.skew_fn() is None  # no epoch yet: no signal
    run = _loader(DeliverySpec.sharded(mesh))
    list(run)
    assert run.stage_stats()["delivery"]["lane_skew"] == 0  # one lane never diverges


def test_sharded_trainer_run_equals_host_delivery():
    """The trainer over a one-lane sharded loader: its ring copies nothing
    and the device batches equal host delivery's, so the losses do too."""
    from repro_torch.launch import train as launch

    args = ["--arch", "granite-8b", "--device", "cpu", "--items", "16", "--batch-size", "4",
            "--seq-len", "32", "--steps", "6", "--latency", "0.001", "--workers", "2",
            "--fetchers", "2", "--log-every", "100", "--pipeline"]
    host = launch.run(args)
    sharded = launch.run(args + ["--delivery", "sharded"])
    assert [h["loss"] for h in sharded.result.history] == [h["loss"] for h in host.result.history]
    assert sharded.batches_transferred == 0 and host.batches_transferred >= 6
    assert sharded.loader.delivers_device_batches
    assert len(sharded.tracer.spans(LANE_H2D)) >= 6
    assert sharded.stages[-1]["delivery"]["num_lanes"] == 1


def test_checkpoint_callback_carries_the_lane_block(tmp_path):
    """Under sharded delivery the checkpoint callback saves the loader's
    lane-cursor block at the TRAINER's position (the ring runs ahead of the
    step), so a restart checks the mesh slicing; the reference's callback
    keeps only ``epoch`` and ``next_batch``, which is what host delivery
    saves here too."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import CheckpointCallback, Trainer

    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    metas = {}
    for label, delivery in (("sharded", DeliverySpec.sharded(mesh)),
                            ("host", DeliverySpec.host())):
        loader = _loader(delivery)
        mgr = CheckpointManager(str(tmp_path / label))
        trainer = Trainer(lambda state, batch: (state, {"loss": 0.0}), {"w": torch.zeros(1)},
                          callbacks=[CheckpointCallback(mgr, 4, loader=loader, blocking=True)],
                          device="cpu")
        trainer.fit(loader, epochs=3, max_steps=8)
        _, metas[label] = mgr.restore({"w": torch.zeros(1)})
    n = 96 // 16  # batches an epoch
    cursor = {"epoch": 8 // n, "next_batch": 8 % n}
    assert metas["host"]["extra"]["loader"] == cursor
    sharded = metas["sharded"]["extra"]["loader"]
    assert {k: sharded[k] for k in cursor} == cursor
    assert [ln["next_batch"] for ln in sharded["delivery"]["lanes"]] == [cursor["next_batch"]] * 2
    resumed = _loader(DeliverySpec.sharded(mesh))
    resumed.load_state_dict(sharded)
    with pytest.raises(ValueError, match="host batches"):
        _loader(DeliverySpec.host()).load_state_dict(sharded)
