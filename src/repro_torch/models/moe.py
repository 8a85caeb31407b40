"""Token-choice top-k mixture of experts with grouped, capacity-bounded
dispatch (the reference's ``repro/models/moe.py``).

Tokens are routed in groups of ``group_size``; within a group each token's
top-k experts take it in token-major order until an expert's ``capacity``
is full, and later assignments are dropped (they add nothing to the
output).  Two dispatch routes give the same result: ``"einsum"`` (dense
one-hot (G, g, E, C) dispatch and combine tensors) and ``"gather"``
(tokens scattered into the (G, Ep, C, d) expert buffer and gathered back).
Expert weights are stacked (Ep, d, f), padded to ``pad_experts_to``;
padded experts are never chosen.  Shared experts (qwen2-moe) run densely on
every token.  The aux loss is Switch-Transformer's load-balancing loss.

As in the reference, a token's output depends on the other tokens of its
group, through capacity: a pooled decode or a chunked prefill can drop
an assignment that a batch-1 decode or a single pass keeps.

The reference's sharding constraints are the identity here (one card);
its rounding of the group count up to a multiple of the data-parallel
extent is kept: :func:`repro_torch.models.sharding.dp_extent` reads the
activation mesh (1 without one, where nothing is rounded).
Where the reference leaves out-of-range indices to JAX (``one_hot`` of a
slot past capacity is a zero row; the gather route scatters dropped
assignments out of bounds with ``mode="drop"`` and gathers them with
``mode="fill"``), the port compares against the slot index and routes
dropped assignments to one sentinel row that it slices away.  Top-k takes
the lowest expert index first among equal probabilities, as
``jax.lax.top_k`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models.layers import Params, dense_init, pdtype
from repro_torch.models.sharding import dp_extent

DEFAULT_GROUP_SIZE = 4_096
CAPACITY_FACTOR = 1.25


def phys_experts(m: MoEConfig) -> int:
    """Stacked expert count, padding included."""
    return max(m.num_experts, m.pad_experts_to or 0)


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Router, stacked experts and shared experts, in the reference's order.
    Each expert stack (Ep, d, f) is drawn in one piece, N(0, 1/in_dim)."""
    m = cfg.moe
    d, dt, dev = cfg.d_model, pdtype(cfg), generator.device
    E, f = phys_experts(m), m.expert_d_ff

    def stack(in_dim: int, out_dim: int) -> torch.Tensor:
        w = torch.randn((E, in_dim, out_dim), generator=generator, device=dev)
        return w.mul_(1.0 / math.sqrt(in_dim)).to(dt)

    p: Params = {
        "router": dense_init(generator, d, (m.num_experts,), dt),
        "w_gate": stack(d, f),  # (Ep, d, f)
        "w_up": stack(d, f),
        "w_down": stack(f, d),
    }
    if m.num_shared_experts:
        sf = m.shared_d_ff or f * m.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(generator, d, (sf,), dt),
            "w_up": dense_init(generator, d, (sf,), dt),
            "w_down": dense_init(generator, sf, (d,), dt),
        }
    return p


def _router_assignments(p: Params, xg: torch.Tensor, m: MoEConfig, capacity: int):
    """Routing over groups, xg (G, g, d).  Returns (top_w, top_e, within,
    keep, onehot, probs), each with leading G: each assignment's slot in its
    expert's queue is the count of earlier assignments to that expert
    (token-major, k within a token)."""
    G, g, _ = xg.shape
    E, K = m.num_experts, m.top_k
    logits = xg @ p["router"].to(xg.dtype)
    probs = torch.softmax(logits.float(), dim=-1)  # (G, g, E)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]  # (G, g, K), ties: lowest index first
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(top_e, E).float()  # (G, g, K, E)
    flat = onehot.reshape(G, g * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, K, E)
    within = (pos * onehot).sum(-1)  # (G, g, K)
    keep = within < capacity
    return top_w, top_e, within, keep, onehot, probs


def _aux_loss(onehot: torch.Tensor, probs: torch.Tensor, E: int) -> torch.Tensor:
    """Switch aux loss: top-1 fraction routed times mean router probability,
    summed over experts, times E, averaged over groups."""
    frac = onehot[:, :, 0].mean(1)  # (G, E)
    mean_prob = probs.mean(1)  # (G, E)
    return ((frac * mean_prob).sum(-1) * E).mean()


def _expert_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (G, Ep, C, d) -> (G, Ep, C, d) through each expert's SwiGLU."""
    g = torch.einsum("Gecd,edf->Gecf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("Gecd,edf->Gecf", x, p["w_up"].to(x.dtype))
    return torch.einsum("Gecf,efd->Gecd", F.silu(g) * u, p["w_down"].to(x.dtype))


def _route_einsum(p: Params, xg: torch.Tensor, m: MoEConfig,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot dispatch (GShard / Switch): (G, g, Ep, C) dispatch and
    combine tensors, two einsums around the experts."""
    top_w, top_e, within, keep, onehot, probs = _router_assignments(p, xg, m, capacity)
    # The aux loss comes before the experts: a checkpointed block's
    # recompute stops after the last tensor the backward saved, so an aux
    # loss computed last would rerun the combine in every backward.
    aux = _aux_loss(onehot, probs, m.num_experts)
    oh = F.one_hot(top_e, phys_experts(m)).float()  # (G, g, K, Ep)
    # a slot past capacity is a zero row, as jax.nn.one_hot gives
    slot_oh = (within.long()[..., None]
               == torch.arange(capacity, device=xg.device)).float()  # (G, g, K, C)
    dispatch = torch.einsum("Ggke,Ggkc->Ggec", oh * keep[..., None], slot_oh)
    combine = torch.einsum("Ggke,Ggkc->Ggec", oh * (top_w * keep)[..., None], slot_oh)
    xin = torch.einsum("Ggec,Ggd->Gecd", dispatch.to(xg.dtype), xg)
    yg = torch.einsum("Ggec,Gecd->Ggd", combine.to(xg.dtype), _expert_ffn(p, xin))
    return yg, aux


def _route_gather(p: Params, xg: torch.Tensor, m: MoEConfig,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter/gather dispatch: every kept assignment has its own slot in the
    flat (G * Ep * C) expert buffer; dropped ones go to a sentinel row past
    its end, which receives tokens and gives back zeros."""
    G, g, d = xg.shape
    K, Ep, C = m.top_k, phys_experts(m), capacity
    top_w, top_e, within, keep, onehot, probs = _router_assignments(p, xg, m, capacity)
    aux = _aux_loss(onehot, probs, m.num_experts)  # first, as in _route_einsum
    goff = (torch.arange(G, device=xg.device) * (Ep * C))[:, None, None]
    dst = torch.where(keep, goff + top_e * C + within.long(),
                      torch.full_like(top_e, G * Ep * C)).reshape(-1)  # (G*g*K,)
    xin = xg.new_zeros((G * Ep * C + 1, d))
    xin[dst] = xg.reshape(G * g, 1, d).expand(G * g, K, d).reshape(-1, d)
    xout = _expert_ffn(p, xin[:-1].reshape(G, Ep, C, d)).reshape(G * Ep * C, d)
    picked = torch.cat([xout, xout.new_zeros((1, d))])[dst].reshape(G, g, K, d)
    w = (top_w * keep).to(xg.dtype)
    yg = torch.einsum("Ggkd,Ggk->Ggd", picked, w)
    return yg, aux


def group_layout(n_tokens: int, group_size: int, dp: int = 1) -> Tuple[int, int]:
    """(G, g): the routing groups :func:`apply_moe` cuts ``n_tokens`` into,
    G of g tokens (zero rows pad the last when G * g > n_tokens)."""
    gsz = min(group_size, n_tokens)
    G = -(-n_tokens // gsz)
    if G > 1 and dp > 1:
        G = -(-G // dp) * dp  # round G up to a multiple of the DP extent
    return G, -(-n_tokens // G)


def check_rank_groups(cfg: ModelConfig, rows: int, seq_len: int, world: int) -> None:
    """Data parallelism over ``world`` ranks, each routing ``rows`` sequences
    of ``seq_len`` tokens a forward: the reference forms its routing groups
    over the global batch's flattened tokens, so rank-local groups equal
    them only when every global group is a whole group of one rank.  Raises
    ``ValueError``, naming the shape, where a group would straddle ranks
    (or pad), since the step would silently differ."""
    m = cfg.moe
    group_size = m.group_size or DEFAULT_GROUP_SIZE
    n_local = rows * seq_len
    G, gsz = group_layout(n_local * world, group_size, dp_extent())
    G_local, gsz_local = group_layout(n_local, group_size, dp_extent())
    if G * gsz != n_local * world or (G_local * world, gsz_local) != (G, gsz):
        raise ValueError(
            f"MoE routing groups straddle ranks: {world} ranks of {rows} x {seq_len} tokens "
            f"({n_local} a rank) against the global batch's {G} groups of {gsz} tokens "
            f"(group_size {group_size}); a rank's groups would be {G_local} of {gsz_local}.  "
            "Pick a group_size that divides each rank's tokens a microbatch")


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              group_size: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  The B*S tokens are cut into G equal
    groups of at most ``group_size`` (zero rows pad the last; they are
    routed and counted in the aux loss, but come last in token order, so
    they never take a real token's slot)."""
    m = cfg.moe
    if group_size is None:
        group_size = m.group_size or DEFAULT_GROUP_SIZE
    B, S, d = x.shape
    N = B * S
    flat = x.reshape(N, d)
    G, gsz = group_layout(N, group_size, dp_extent())
    if G * gsz != N:
        flat = torch.cat([flat, flat.new_zeros((G * gsz - N, d))])
    capacity = max(int(gsz * m.top_k / m.num_experts * CAPACITY_FACTOR), m.top_k)
    route = _route_gather if m.dispatch == "gather" else _route_einsum
    ys, aux = route(p, flat.reshape(G, gsz, d), m, capacity)
    y = ys.reshape(-1, d)[:N].reshape(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        h = F.silu(x @ sp["w_gate"].to(x.dtype)) * (x @ sp["w_up"].to(x.dtype))
        y = y + h @ sp["w_down"].to(x.dtype)
    return y, aux * m.load_balance_coef
