"""Smoke train-step cells counted in both packages, for
``test_torch_roofline.py`` and ``test_torch_dryrun.py``: the port's
``OpCounter`` on fake tensors and the reference's ``analyze_hlo`` on its
compiled step (one device, as its ``test_flops_match_6nd_closed_form``)."""
import jax
import torch

from repro.config import ShapeConfig as JShapeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.launch import specs as JS
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models.sharding import use_activation_mesh as jax_activation_mesh
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.config import TrainConfig, get_arch
from repro_torch.launch import op_cost
from repro_torch.train.steps import init_params_for, lm_train_state, make_train_step
from repro_torch.tree import leaves


def lm_train_cost(arch, B=8, S=128, microbatches=2):
    """The port's smoke train step of ``arch`` counted on fake tensors."""
    cfg, tcfg = get_arch(arch, smoke=True), TrainConfig(microbatches=microbatches)
    with op_cost.fake_mode():
        params = init_params_for(cfg, torch.Generator(), "cpu")
        for p in leaves(params):
            p.requires_grad_(True)
        state = lm_train_state(params, tcfg)
        batch = {k: torch.zeros((B, S), dtype=torch.int32) for k in ("tokens", "targets")}
        return op_cost.count(make_train_step(cfg, tcfg), state, batch)[1]


def jax_train_flops(arch, B=8, S=128, microbatches=2):
    """The reference's ``analyze_hlo`` FLOPs of the same cell, on one device
    (the reference's ``test_flops_match_6nd_closed_form`` setup)."""
    cfg, tcfg = jax_get_arch(arch, smoke=True), JTrainConfig(microbatches=microbatches)
    shape, mesh = JShapeConfig("t", S, B, "train"), jax_make_mesh((1, 1), ("data", "model"))
    with jax_activation_mesh(mesh):
        fn = jax.jit(jax_make_train_step(cfg, tcfg), donate_argnums=(0,))
        compiled = fn.lower(JS.state_specs(cfg, tcfg, mesh), JS.input_specs(cfg, shape, mesh)
                            ).compile()
    return analyze_hlo(compiled.as_text()).flops
