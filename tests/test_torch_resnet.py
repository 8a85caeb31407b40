"""ResNet in the port against the JAX reference on the smoke config, from the
converted JAX init: logits, new BatchNorm state, loss, accuracy, gradients."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import resnet_state_from_jax, resnet_to_jax  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference, jitted (eager JAX dispatches every op separately)
jloss_and_grad = jax.jit(
    jax.value_and_grad(lambda p, s, b, cfg: jres.resnet_loss(p, s, b, cfg), has_aux=True),
    static_argnums=3)
japply = jax.jit(jres.apply_resnet, static_argnums=(3, 4))


def _assert_trees_close(got, want):
    got, want = flatten(got), flatten(want)
    assert list(got) == list(want)  # same paths, same leaf order
    for path in want:
        np.testing.assert_allclose(got[path], np.asarray(want[path]), err_msg=path, **TOL)


@pytest.fixture(scope="module")
def init():
    cfg = jax_get_arch("resnet18-imagenet", smoke=True)
    params, bn = jax.jit(jres.init_resnet, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return cfg, jax.device_get(params), jax.device_get(bn)


@pytest.mark.parametrize("n,k,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)),
    (33, 7, 2, (3, 3)), (17, 3, 2, (1, 1)),
])
def test_same_padding_matches_xla(n, k, stride, pads):
    assert resnet._same_pads(n, k, stride) == pads
    x = jnp.zeros((1, 1, n, n))
    w = jnp.zeros((k, k, 1, 1))
    out = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                       dimension_numbers=("NCHW", "HWIO", "NCHW"))
    assert out.shape[2] == (n + sum(pads) - k) // stride + 1


def test_converted_init_round_trips(init):
    _, params, bn = init
    p, s = resnet_state_from_jax(params, bn, "cpu")
    assert p["stem"]["conv/w"].shape == (8, 3, 7, 7)  # OIHW
    assert p["fc"]["w"].shape == (16, 10)  # (cin, classes) as in JAX
    assert all(t.requires_grad for t in leaves(p))
    _assert_trees_close(resnet_to_jax(p), params)
    _assert_trees_close(resnet_to_jax(s), bn)


@pytest.mark.parametrize("size", [32, 37])
def test_forward_and_grads_match_jax(init, size):
    jcfg, params, bn = init
    cfg = get_arch("resnet18-imagenet", smoke=True)
    rng = np.random.default_rng(size)
    image = rng.standard_normal((4, 3, size, size), dtype=np.float32)
    label = rng.integers(0, cfg.num_classes, 4).astype(np.int32)
    jbatch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}

    (jl, (jbn, jacc)), jgrads = jloss_and_grad(params, bn, jbatch, jcfg)
    jlogits, _ = japply(params, bn, jbatch["image"], jcfg, True)
    jeval, _ = japply(params, jbn, jbatch["image"], jcfg, False)

    p, s = resnet_state_from_jax(params, bn, "cpu")
    batch = {"image": torch.from_numpy(image), "label": torch.from_numpy(label)}
    loss, (new_bn, acc) = resnet.resnet_loss(p, s, batch, cfg, train=True)
    grads = torch.autograd.grad(loss, leaves(p))
    logits, _ = resnet.apply_resnet(p, s, batch["image"], cfg, train=True)
    evals, _ = resnet.apply_resnet(p, new_bn, batch["image"], cfg, train=False)

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(evals.detach().numpy(), np.asarray(jeval), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(acc.item(), float(jacc), **TOL)
    _assert_trees_close(resnet_to_jax(new_bn), jax.device_get(jbn))
    grad_tree = dict(zip(flatten(p), grads))
    _assert_trees_close(
        {k: resnet_to_jax({"g": g})["g"] for k, g in grad_tree.items()},
        flatten(jax.device_get(jgrads)),
    )


def test_out_of_range_label_reads_as_nan_like_the_reference(init):
    """The smoke config has 10 classes while synthetic ImageNet labels run to
    999: both packages give a NaN loss and the same (finite) gradients."""
    jcfg, params, bn = init
    cfg = get_arch("resnet18-imagenet", smoke=True)
    rng = np.random.default_rng(7)
    image = rng.standard_normal((2, 3, 32, 32), dtype=np.float32)
    label = np.array([3, 284], dtype=np.int32)
    (jl, _), jgrads = jloss_and_grad(
        params, bn, {"image": jnp.asarray(image), "label": jnp.asarray(label)}, jcfg)
    p, s = resnet_state_from_jax(params, bn, "cpu")
    loss, _ = resnet.resnet_loss(p, s, {"image": torch.from_numpy(image),
                                        "label": torch.from_numpy(label)}, cfg)
    grads = torch.autograd.grad(loss, leaves(p))
    assert np.isnan(float(jl)) and np.isnan(loss.item())
    want = flatten(jax.device_get(jgrads))
    for (path, g) in zip(flatten(p), grads):
        got = resnet_to_jax({"g": g})["g"]
        assert np.isfinite(got).all(), path
        np.testing.assert_allclose(got, want[path], err_msg=path, **TOL)
