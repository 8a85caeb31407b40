"""The partition rules and the device mesh of the port
(``repro_torch.models.sharding``, ``repro_torch.launch.mesh``) against the
JAX reference: every arch's parameter specs on a (2, 4) mesh, and
``apply_moe``'s rounding of its group count up to the data-parallel extent.

The reference needs 8 devices, which ``XLA_FLAGS`` gives only before jax
starts, so its side runs in ONE subprocess (``reference``) that returns
every result at once; the port's mesh is ``["cpu"] * 8``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, get_arch  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import moe, sharding  # noqa: E402
from repro_torch.models.counting import _param_shapes  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(ASSIGNED + ["resnet18-imagenet"])
MOE_TOL = 2e-5  # test_torch_moe.py's

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax
import jax.numpy as jnp
from repro.config import AttentionConfig, ModelConfig, MoEConfig, get_arch
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.models.sharding import dp_extent, param_specs, use_activation_mesh
from repro.train.steps import init_params_for

out_dir, archs = sys.argv[1], json.loads(sys.argv[2])
mesh = make_mesh((2, 4), ("data", "model"))


def path_of(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def entry(e):
    return list(e) if isinstance(e, tuple) else e


specs = {}
for name in archs:
    cfg = get_arch(name)
    shapes = jax.eval_shape(lambda k: init_params_for(cfg, k), jax.random.PRNGKey(0))
    flat = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, s: flat.__setitem__(path_of(kp), list(s.shape)), shapes)
    sp = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, s: sp.__setitem__(path_of(kp), [entry(e) for e in s]),
        param_specs(shapes, mesh), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    specs[name] = {p: [flat[p], sp[p]] for p in flat}

cfg = ModelConfig(name="moe-test", family="decoder", num_layers=2, d_model=64, d_ff=32,
                  vocab_size=128, dtype="float32",
                  attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                            head_dim=16),
                  moe=MoEConfig(num_experts=6, top_k=2, expert_d_ff=32, group_size=16))
params = moe.init_moe(jax.random.PRNGKey(0), cfg)
x = np.ones((1, 37, 64), np.float32) + 0.05 * np.random.default_rng(6).standard_normal(
    (1, 37, 64)).astype(np.float32)
arrays = {"x": x}
for extent, m in ((2, mesh), (1, None)):
    with use_activation_mesh(m):
        assert dp_extent() == extent
        y, aux = jax.jit(lambda p, x: moe.apply_moe(p, x, cfg))(params, jnp.asarray(x))
    arrays[f"y{extent}"], arrays[f"aux{extent}"] = np.asarray(y), np.asarray(aux)
np.savez(os.path.join(out_dir, "moe.npz"), **arrays,
         **{"p/" + path_of(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(params)[0]})
print(json.dumps({"specs": specs}))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference_sharding")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(out_dir), json.dumps(ARCHS)],
                         capture_output=True, text=True, env=env, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    with np.load(out_dir / "moe.npz") as z:
        rec["moe"] = {k: z[k] for k in z.files}
    return rec


def _lists(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _hwio(shape):
    return [shape[2], shape[3], shape[1], shape[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(reference, arch):
    """Every parameter path of the full config, the same in both packages,
    gets the reference's spec on a (2, 4) ("data", "model") mesh.  The
    ResNet's conv weights are OIHW in the port and their rule is stated for
    HWIO (the reference's and the checkpoint files' layout), so they are
    matched in that layout."""
    cfg = get_arch(arch)
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    want = reference["specs"][arch]
    shapes = {p: list(t.shape) for p, t in flatten(_param_shapes(cfg)).items()}
    assert set(shapes) == set(want)
    if cfg.family == "resnet":
        shapes = {p: _hwio(s) if len(s) == 4 else s for p, s in shapes.items()}
    sharded = 0
    for path, shape in shapes.items():
        ref_shape, ref_spec = want[path]
        assert shape == ref_shape, path
        got = sharding.spec_for_path(path, len(shape), shape, mesh)
        assert _lists(got) == ref_spec, path
        sharded += any(e is not None for e in got)
    assert sharded > 0


def test_apply_moe_rounds_groups_up_to_the_dp_extent(reference, monkeypatch):
    """37 tokens in groups of 16 make 3 groups; under an activation mesh of
    data-parallel extent 2 the reference rounds them up to 4 (of 10 tokens
    each), and so does the port, with the reference's output and aux loss at
    either extent."""
    ref = reference["moe"]
    cfg = ModelConfig(name="moe-test", family="decoder", num_layers=2, d_model=64, d_ff=32,
                      vocab_size=128, dtype="float32",
                      attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                                head_dim=16),
                      moe=MoEConfig(num_experts=6, top_k=2, expert_d_ff=32, group_size=16))
    p = from_jax({k[2:]: v for k, v in ref.items() if k.startswith("p/")}, "cpu")
    groups = []
    route = moe._route_einsum
    monkeypatch.setattr(moe, "_route_einsum", lambda p_, xg, *a: (groups.append(xg.shape),
                                                                  route(p_, xg, *a))[1])
    x = torch.from_numpy(ref["x"])
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    for extent, m in ((2, mesh), (1, None)):
        with sharding.use_activation_mesh(m):
            assert sharding.dp_extent() == extent
            y, aux = moe.apply_moe(p, x, cfg)
        np.testing.assert_allclose(y.numpy(), ref[f"y{extent}"], atol=MOE_TOL, rtol=MOE_TOL)
        np.testing.assert_allclose(float(aux), float(ref[f"aux{extent}"]), rtol=1e-6)
    assert groups == [(4, 10, 64), (3, 13, 64)]
    assert not np.allclose(ref["y2"], ref["y1"])  # the rounding changes the groups' capacity


def test_activation_constraints_are_identities_on_one_card():
    x = torch.randn(4, 8, 16)
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    assert sharding.dp_extent() == 1 and not sharding.seq_parallel_enabled()
    assert sharding.tp_divides(3)
    with sharding.use_activation_mesh(mesh, seq_parallel=True):
        assert sharding.constrain(x, "dp", "tp", None) is x
        assert sharding.seq_parallel_enabled() and sharding.dp_extent() == 2
        assert sharding.tp_divides(8) and not sharding.tp_divides(6)
    assert sharding.dp_extent() == 1


def test_batch_sharding_and_partition_params():
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    assert sharding.batch_sharding(mesh, (16, 224)).spec == ("data", None)
    assert sharding.batch_sharding(mesh, (3, 224)).spec == (None, None)
    pod = make_mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    assert sharding.dp_axes(pod) == ("pod", "data")
    assert sharding.batch_sharding(pod, (8,)).spec == (("pod", "data"),)
    tree = {"embed": {"w": torch.empty(128, 64)}, "blocks": [{"wq": torch.empty(64, 4, 16)}]}
    parts = sharding.partition_params(tree, mesh)
    assert parts["embed"]["w"] == sharding.NamedSharding(mesh, ("model", "data"))
    assert sharding.param_specs(tree, mesh)["blocks"][0]["wq"] == ("data", "model", None)


def test_make_mesh_counts_devices_and_production_meshes_need_their_cards():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 2, "model": 2}
    assert mesh.axis_names == ("data", "model") and mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh((1,), ("data",))
        with pytest.raises(RuntimeError, match="is_available"):
            make_production_mesh()
    elif torch.cuda.device_count() < 256:
        with pytest.raises(ValueError, match="needs 256 devices"):
            make_production_mesh()
