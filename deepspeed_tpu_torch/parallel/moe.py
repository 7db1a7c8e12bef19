"""Mixture-of-Experts at one rank (counterpart of
`deepspeed_tpu/parallel/moe.py`).

Reference: `deepspeed/moe/` — the `MoE` layer (`moe/layer.py:16`), `MOELayer`
with `top1gating` / `top2gating`: capacity, jitter, the load-balancing aux
loss (`moe/sharded_moe.py:184,282,425`).

GShard formulation with static shapes, as in the JAX package: gating gives
dispatch [N, E, C] and combine [N, E, C] tensors, capacity overflow drops a
token by masking it, and dispatch and combine are einsums. Two of the JAX
package's three routes exist here:

  * **einsum** — `MoELayer` and `models/moe_gpt.py`'s training MLP;
  * **dropless** (`dropless_moe`) — capacity-free top-1: the token-sort
    kernel (`ops/token_sort.py`) ranks each token within its expert's queue
    and tokens scatter into an [E, N, D] buffer (memory E·N·D).

The third, expert dispatch across ranks through the comm facade's
all_to_all (`expert_parallel_moe`), needs the multi-rank comm layer: it
raises `NotImplementedError`, and `can_use_expert_shard_map` is False with
no process group of more than one rank.

Random numbers: where JAX takes a `jax.random` key (`rng`), the port takes
a `torch.Generator`; `None` means no noise in both.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.token_sort import token_sort


def _capacity(num_tokens, num_experts, capacity_factor, min_capacity):
    cap = int(np.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _one_hot(x, n, dtype=torch.float32):
    """jax.nn.one_hot: an id outside [0, n) gives a zero row."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def _gelu(x):
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _gumbel(like, generator):
    """Standard Gumbel noise shaped like `like`, from `generator` (the
    counterpart of jax.random.gumbel: -log(-log(u)), u in (tiny, 1))."""
    u = torch.rand(like.shape, generator=generator, device=like.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(like.dtype)


def _aux_loss(gates, mask1):
    """The reference's me·ce load-balancing loss."""
    E = gates.shape[-1]
    return torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * E


def top1_gating(logits, capacity_factor=1.0, min_capacity=4,
                noisy_gate_policy=None, rng=None, used_token_mask=None):
    """Top-1 gating (reference `top1gating`, `moe/sharded_moe.py:184`).

    logits: [N, E]. Returns (l_aux, dispatch [N, E, C] bool, combine
    [N, E, C] float, exp_counts [E]). `noisy_gate_policy="RSample"` with a
    generator `rng` adds Gumbel noise (x 1e-2) to the logits first."""
    N, E = logits.shape
    C = _capacity(N, E, capacity_factor, min_capacity)
    if noisy_gate_policy == "RSample" and rng is not None:
        logits = logits + _gumbel(logits, rng) * 1e-2
    gates = torch.softmax(logits, dim=-1)                        # [N, E]
    expert_idx = torch.argmax(gates, dim=-1)                     # first max
    mask1 = _one_hot(expert_idx, E)
    if used_token_mask is not None:
        mask1 = mask1 * used_token_mask[:, None]
    l_aux = _aux_loss(gates, mask1)

    pos_in_expert = torch.cumsum(mask1, dim=0) * mask1           # 1-based
    keep = (pos_in_expert <= C) & (mask1 > 0)
    pos = (pos_in_expert - 1.0) * mask1                          # 0-based
    exp_counts = mask1.sum(dim=0)

    gate_val = (gates * mask1).sum(dim=-1, keepdim=True)         # [N, 1]
    slot = pos.sum(dim=-1).to(torch.int64)                       # [N]
    dispatch = keep[..., None] * _one_hot(slot, C)[:, None, :]   # [N, E, C]
    combine = dispatch * gate_val[..., None]
    return l_aux, dispatch.to(torch.bool), combine, exp_counts


def top2_gating(logits, capacity_factor=1.0, min_capacity=4, rng=None):
    """Top-2 gating (reference `top2gating`, `moe/sharded_moe.py:282`).

    A generator `rng` jitters only the selection of the second expert
    (Gumbel x 1e-2); `None` means no jitter. The two combine weights are
    renormalized after the capacity drop, over the experts that kept the
    token."""
    N, E = logits.shape
    C = _capacity(N, E, 2 * capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx1, E)
    gates_wo1 = gates * (1 - mask1)
    if rng is not None:
        noisy = gates_wo1 + _gumbel(gates_wo1, rng) * 1e-2
        idx2 = torch.argmax(noisy.masked_fill(mask1 > 0, float("-inf")),
                            dim=-1)
    else:
        idx2 = torch.argmax(gates_wo1, dim=-1)
    mask2 = _one_hot(idx2, E)
    l_aux = _aux_loss(gates, mask1)

    pos1 = torch.cumsum(mask1, dim=0) * mask1
    pos2 = (torch.cumsum(mask2, dim=0) + mask1.sum(dim=0, keepdim=True)) \
        * mask2
    keep1 = (pos1 <= C) & (mask1 > 0)
    keep2 = (pos2 <= C) & (mask2 > 0)
    g1 = (gates * mask1).sum(dim=-1) * keep1.any(dim=-1)
    g2 = (gates * mask2).sum(dim=-1) * keep2.any(dim=-1)
    denom = (g1 + g2).clamp_min(1e-9)
    g1, g2 = g1 / denom, g2 / denom

    def build(keep, mask, pos, g):
        slot = ((pos - 1.0) * mask).sum(dim=-1).to(torch.int64)
        d = keep[..., None] * _one_hot(slot, C)[:, None, :]
        return d, d * g[:, None, None]

    d1, c1 = build(keep1, mask1, pos1, g1)
    d2, c2 = build(keep2, mask2, pos2, g2)
    return l_aux, (d1 + d2) > 0, c1 + c2, (mask1 + mask2).sum(dim=0)


def gating_drop_stats(dispatch, exp_counts):
    """Capacity-overflow accounting from a gating result: f32 scalars
    {routed, kept, overflow_tokens, dropped_frac} — the router's token →
    expert assignments, those that fit under capacity, the rest. They feed
    the `moe/*` metrics."""
    routed = exp_counts.sum().float()
    kept = dispatch.float().sum()
    overflow = routed - kept
    return {"routed": routed, "kept": kept, "overflow_tokens": overflow,
            "dropped_frac": overflow / routed.clamp_min(1.0)}


# ----------------------------------------------------------------------
# expert dispatch across ranks — not at one rank
# ----------------------------------------------------------------------


def can_use_expert_shard_map(mesh, num_experts, num_tokens):
    """Whether the cross-rank expert dispatch would take this problem. At
    one rank it never does: False unless `mesh` is given and a process
    group of more than one rank exists (and that path then raises)."""
    if mesh is None or not torch.distributed.is_available() \
            or not torch.distributed.is_initialized():
        return False
    return torch.distributed.get_world_size() > 1


def expert_parallel_moe(*args, **kwargs):
    """Expert dispatch through the comm facade's all_to_all across ranks
    (JAX: `shard_map` over the `expert` mesh axis)."""
    raise NotImplementedError(
        "expert_parallel_moe (expert dispatch across ranks through "
        "all_to_all) is not ported to deepspeed_tpu_torch yet: it needs the "
        "multi-rank comm layer (ROADMAP queue 1 item 8)")


# ----------------------------------------------------------------------
# dropless variant (token sort kernel)
# ----------------------------------------------------------------------


def dropless_moe(flat, gate_w, ffn_fn, num_experts):
    """Capacity-free top-1 MoE: no token is ever dropped.

    The token sort ranks each token within its expert's queue; tokens
    scatter into an [E, N, D] buffer (N is the only capacity that can never
    overflow), `ffn_fn` maps it to [E, N, D], and each token gathers its own
    slot back, weighted by its gate probability. The scatter is an
    out-of-place `index_put` into a fresh zero buffer, so autograd carries
    the gradient back to `flat`.

    Returns (out [N, D], l_aux, exp_counts [E])."""
    N, D = flat.shape
    E = num_experts
    logits = flat.float() @ gate_w.float()
    gates = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(gates, dim=-1)
    gate_val = gates.gather(-1, expert_idx[:, None])[:, 0].to(flat.dtype)

    mask1 = _one_hot(expert_idx, E)
    l_aux = _aux_loss(gates, mask1)
    exp_counts = mask1.sum(dim=0)

    pos, _counts = token_sort(expert_idx, E)
    slots = (expert_idx, pos.to(torch.int64))
    xe = torch.zeros((E, N, D), dtype=flat.dtype,
                     device=flat.device).index_put(slots, flat)
    ye = ffn_fn(xe)
    out = ye[slots] * gate_val[:, None]
    return out, l_aux, exp_counts


@dataclasses.dataclass
class MoELayer:
    """Functional expert FFN layer.

    Params (stacked over experts): {"gate_w": [D, E], "wi": [E, D, F],
    "wi_b": [E, F], "wo": [E, F, D], "wo_b": [E, D]} (+ "res_wi", "res_wo",
    "res_coef" with `use_residual`).

    Call: (params, x [B, S, D], rng) -> (y [B, S, D], l_aux, exp_counts).
    The einsum path by default; ``dropless=True`` takes the token-sort path.
    """
    num_experts: int
    k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    activation: Callable = _gelu
    use_residual: bool = False     # residual MoE (DS-MoE paper)
    dropless: bool = False         # token-sort scatter, no capacity drops

    def init_params(self, d_model, d_ff, seed=0, dtype=torch.float32):
        """Drawn from `np.random.default_rng(seed)` in the JAX package's
        order, so one seed gives both packages the same weights."""
        rng = np.random.default_rng(seed)
        E, D, F_ = self.num_experts, d_model, d_ff

        def normal(shape, dt=dtype):
            return torch.from_numpy(np.asarray(rng.normal(0, 0.02, shape),
                                               np.float32)).to(dt)

        p = {"gate_w": normal((D, E), torch.float32),
             "wi": normal((E, D, F_)),
             "wi_b": torch.zeros((E, F_), dtype=dtype),
             "wo": normal((E, F_, D)),
             "wo_b": torch.zeros((E, D), dtype=dtype)}
        if self.use_residual:
            p["res_wi"] = normal((D, F_))
            p["res_wo"] = normal((F_, D))
            p["res_coef"] = normal((D, 2), torch.float32)
        return p

    def _ffn(self, xe, p):
        h = self.activation(xe @ p["wi"] + p["wi_b"][:, None, :])
        return h @ p["wo"] + p["wo_b"][:, None, :]

    def __call__(self, params, x, rng=None, training=True, mesh=None):
        B, S, D = x.shape
        E = self.num_experts
        N = B * S
        flat = x.reshape(N, D)
        cf = self.capacity_factor if training else self.eval_capacity_factor
        eparams = {k: params[k] for k in ("wi", "wi_b", "wo", "wo_b")}

        if self.dropless:
            y, l_aux, exp_counts = dropless_moe(
                flat, params["gate_w"], lambda xe: self._ffn(xe, eparams), E)
        elif can_use_expert_shard_map(mesh, E, N):
            y, l_aux, exp_counts, _stats = expert_parallel_moe()
        else:
            logits = flat.float() @ params["gate_w"].float()
            if self.k == 1:
                l_aux, dispatch, combine, exp_counts = top1_gating(
                    logits, cf, self.min_capacity, self.noisy_gate_policy,
                    rng)
            else:
                l_aux, dispatch, combine, exp_counts = top2_gating(
                    logits, cf, self.min_capacity, rng)
            exp_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), flat)
            out = self._ffn(exp_in, eparams)
            y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), out)

        y = y.reshape(B, S, D)
        if self.use_residual:
            mlp = self.activation(x @ params["res_wi"]) @ params["res_wo"]
            coef = torch.softmax(x.float() @ params["res_coef"].float(),
                                 dim=-1)
            y = y * coef[..., 0:1].to(x.dtype) \
                + mlp * coef[..., 1:2].to(x.dtype)
        return y, l_aux, exp_counts


class MoE:
    """API-parity wrapper (reference `moe/layer.py:16` signature).
    `drop_tokens=False` selects the dropless (token-sort) path."""

    def __init__(self, hidden_size, expert=None, num_experts=1, ep_size=1, k=1,
                 capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=4,
                 use_residual=False, noisy_gate_policy=None, drop_tokens=True,
                 use_rts=True, use_tutel=False,
                 enable_expert_tensor_parallelism=False):
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.layer = MoELayer(num_experts=num_experts, k=k,
                              capacity_factor=capacity_factor,
                              eval_capacity_factor=eval_capacity_factor,
                              min_capacity=min_capacity,
                              noisy_gate_policy=noisy_gate_policy,
                              use_residual=use_residual,
                              dropless=not drop_tokens)

    def init_params(self, d_ff, seed=0, dtype=torch.float32):
        return self.layer.init_params(self.hidden_size, d_ff, seed=seed,
                                      dtype=dtype)

    def __call__(self, params, hidden_states, rng=None, used_token=None,
                 mesh=None):
        return self.layer(params, hidden_states, rng, mesh=mesh)
