"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or anything of the ``repro`` package, and no entry point falls
back to the CPU when a card is asked for."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (defines only; main() runs under __main__)
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
print(len(names), leaked)
"""


def test_every_module_imports_without_jax_or_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, env=env, timeout=120, check=False,
    )
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.strip().split(" ", 1)
    assert int(n) >= 25  # config, core, data, kernels, models, train, launch ...
    assert leaked == "[]"


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
))
def test_sources_never_import_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), path


CHECKPOINT_AND_DELIVERY = ["train/checkpoint.py", "train/fault_tolerance.py", "launch/mesh.py",
                           "models/sharding.py", "core/delivery.py", "examples/train_lm.py",
                           "examples/elastic_restart.py"]


DRY_RUN = ["launch/roofline.py", "launch/op_cost.py", "launch/specs.py", "launch/dryrun.py",
           "kernels/cost.py"]


def test_the_source_scan_covers_the_dry_run():
    """The modules of the dry run (the roofline, the op-level cost counter,
    the specs, the sweep) and the kernels' registered costs are scanned
    too, and import neither jax nor repro."""
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert set(DRY_RUN) <= scanned
    for rel in DRY_RUN:
        assert not _FORBIDDEN.findall((PORT / rel).read_text()), rel


DATA_PARALLEL = ["launch/dist.py", "launch/mesh.py", "core/delivery.py", "core/loader.py",
                 "models/resnet.py", "models/moe.py", "train/steps.py", "train/trainer.py",
                 "launch/train.py"]


def test_the_source_scan_covers_data_parallelism():
    """The process group (``launch/dist.py``) and the modules data
    parallelism runs through are scanned too, and import neither jax nor
    repro; ``dist`` imports no torch either (the loader layer asks it for
    the rank)."""
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert set(DATA_PARALLEL) <= scanned
    for rel in DATA_PARALLEL:
        assert not _FORBIDDEN.findall((PORT / rel).read_text()), rel
    assert not re.search(r"^(import|from)\s+torch", (PORT / "launch/dist.py").read_text(), re.M)


def test_the_source_scan_covers_checkpointing_and_delivery():
    """The scan above walks every source of the package; the modules of
    checkpointing, fault tolerance and sharded delivery, and the example
    twins, are among them and import neither jax nor repro."""
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert set(CHECKPOINT_AND_DELIVERY) <= scanned
    for rel in CHECKPOINT_AND_DELIVERY:
        assert not _FORBIDDEN.findall((PORT / rel).read_text()), rel


_IMPORT_ONE = r"""
import importlib, sys
sys.modules["jax"] = None  # any import of jax now raises
sys.path.insert(0, sys.argv[1])
importlib.import_module(sys.argv[2])
print(sorted(k for k in sys.modules if k == "repro" or k.startswith("repro.")))
"""


@pytest.mark.parametrize("module", ["repro_torch.models.rwkv6",
                                    "repro_torch.kernels.rwkv6_wkv.ops",
                                    "repro_torch.kernels.rmsnorm.ops",
                                    "repro_torch.core.autotune",
                                    "repro_torch.serve", "repro_torch.serve.steps",
                                    "repro_torch.serve.engine", "repro_torch.launch.serve",
                                    "repro_torch.configs.granite_3_8b",
                                    "repro_torch.configs.nemotron_4_340b",
                                    "repro_torch.models.moe",
                                    "repro_torch.configs.minicpm3_4b",
                                    "repro_torch.configs.granite_moe_3b_a800m",
                                    "repro_torch.configs.qwen2_moe_a2_7b",
                                    "repro_torch.models.ssm",
                                    "repro_torch.configs.jamba_v0_1_52b",
                                    "repro_torch.models.encdec",
                                    "repro_torch.models.counting",
                                    "repro_torch.configs.whisper_large_v3",
                                    "repro_torch.configs.internvl2_26b",
                                    "repro_torch.tools.budget_split_probe",
                                    "repro_torch.train.checkpoint",
                                    "repro_torch.train.fault_tolerance",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.models.sharding",
                                    "repro_torch.core.delivery",
                                    "repro_torch.examples.train_lm",
                                    "repro_torch.examples.elastic_restart",
                                    "repro_torch.launch.roofline",
                                    "repro_torch.launch.op_cost",
                                    "repro_torch.launch.specs",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.kernels.cost",
                                    "repro_torch.launch.dist"])
def test_slice_module_imports_alone_without_jax_or_repro(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONE, str(ROOT / "src"), module],
                         capture_output=True, text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_IMPORT_NO_TORCH = r"""
import importlib, sys
sys.path.insert(0, sys.argv[1])
importlib.import_module(sys.argv[2])
print("torch" in sys.modules)
"""


@pytest.mark.parametrize("module", ["repro_torch.core.pipeline", "repro_torch.core.staging",
                                    "repro_torch.core.loader", "repro_torch.core.factory",
                                    "repro_torch.core.autotune", "repro_torch.core.shm",
                                    "repro_torch.core.coord", "repro_torch.core.elastic",
                                    "repro_torch.data.cache", "repro_torch.data.store",
                                    "repro_torch.data.dataset",
                                    "repro_torch.data.imagenet_synth",
                                    "repro_torch.data.columnar", "repro_torch.data.shards",
                                    "repro_torch.core.delivery",
                                    "repro_torch.models.sharding",
                                    "repro_torch.train.fault_tolerance",
                                    "repro_torch.launch.dist"])
def test_loader_module_imports_without_torch(module):
    """A spawned CPU worker of the staged pipeline imports these modules
    (and unpickles the dataset), and a spawned elastic member or cache
    writer imports the coordination layer; none of them may pull in torch,
    which would cost each process torch's import and risk a CUDA
    context."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_NO_TORCH, str(ROOT / "src"), module],
                         capture_output=True, text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


_REPLACES = re.compile(r"Replaces the Pallas TPU kernel (src/repro/kernels/\S+\.py)")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.cu")))
def test_cuda_sources_name_the_tpu_kernel_they_replace(path):
    """Each kernel source says which TPU kernel it replaces (a file that
    exists) and what bounds it, exports a C entry point, and is the
    ``SOURCE`` its package's ``ops.py`` builds."""
    text = (ROOT / path).read_text()
    found = _REPLACES.search(text)
    assert found and (ROOT / found.group(1)).is_file(), path
    assert "Bound:" in text and 'extern "C"' in text, path
    ops_text = (ROOT / path).parent.parent.joinpath("ops.py").read_text()
    assert f'"csrc" / "{Path(path).name}"' in ops_text, path


def test_cuda_requested_without_a_card_raises(monkeypatch):
    from repro_torch.core.prefetch import DevicePrefetchRing
    from repro_torch.device import resolve_device
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        DevicePrefetchRing(iter([]))  # default device is cuda
    with pytest.raises(RuntimeError, match="is_available"):
        train.run(["--items", "4", "--steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kernel_wrapper_never_takes_the_plain_version_off_the_cpu():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ingest_norm import ops

    img = torch.empty((2, 4, 4, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ops.ingest_norm(img, [0.5] * 3, [0.2] * 3)
    with pytest.raises(ValueError, match="uint8"):
        ops.ingest_norm(torch.zeros((2, 4, 4, 3)), [0.5] * 3, [0.2] * 3)
    with pytest.raises(ValueError, match="out_dtype"):
        ops.ingest_norm(torch.zeros((2, 4, 4, 3), dtype=torch.uint8), [0.5] * 3, [0.2] * 3,
                        torch.float16)
    q = torch.empty((1, 4, 64, 32), device="meta")
    k = torch.empty((1, 2, 64, 32), device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        flash.flash_attention(q, k, k)
    assert flash.flash_attention.launches == 0


def _meta_wkv():
    from repro_torch.kernels.rwkv6_wkv import ops

    r = torch.empty((1, 8, 2, 16), device="meta")
    return ops.wkv, (r, r, r, r, torch.empty((2, 16), device="meta"),
                     torch.empty((1, 2, 16, 16), device="meta"))


def _meta_rmsnorm():
    from repro_torch.kernels.rmsnorm import ops

    return ops.rmsnorm, (torch.empty((4, 32), device="meta"), torch.empty((32,), device="meta"))


@pytest.mark.parametrize("make", [_meta_wkv, _meta_rmsnorm], ids=["rwkv6_wkv", "rmsnorm"])
def test_new_kernel_wrappers_never_take_the_plain_version_off_the_cpu(make):
    fn, args = make()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        fn(*args)
    assert fn.launches == 0
