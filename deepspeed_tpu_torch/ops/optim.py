"""Optimizer registry and config-driven construction (counterpart of
`deepspeed_tpu/ops/optim.py`).

Each optimizer is a pair of functions over parameter trees, in the form of
an optax `GradientTransformation`: `init(params) -> state`, and
`update(grads, state, params, apply=None)`, which steps `params` and
`state` in place with `torch._foreach_*` ops over their leaf lists. The
math is optax's (`optax.adamw` decays the old parameter; `optax.lamb`
scales each leaf by its own trust ratio; the learning-rate schedule reads
the update count before it is incremented), computed in fp32: a leaf
stored in another dtype is widened for the step and rounded back once, as
optax's `apply_updates` rounds `p + u`. `apply` is the loss scaler's
skip-step, a 0-d bool tensor: where it is false every stored leaf keeps
its value (`runtime/precision.py::masked_update`). `leaf_norms`, where
the optimizer reads per-leaf norms (LAMB), computes them over whole leaves
when the leaves stepped are shards; `leaf_sums` does the same for any
per-leaf partial sums (the 1-bit optimizers' sign scale and trust ratio,
`runtime/compressed_grads.py`). The update has no
Pallas kernel in the JAX package, so it is plain torch here too.
"""

import dataclasses
from typing import Any, Callable, Dict

import torch

from deepspeed_tpu_torch.runtime.precision import masked_update
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable
    update: Callable
    # the update reads per-leaf norms (LAMB's trust ratio): a caller whose
    # leaves are shards passes `leaf_norms`, the whole leaves' norms
    leaf_norms: bool = False
    # the update reads per-leaf sums (the 1-bit sign scale): a caller whose
    # leaves are shards passes `leaf_sums`, which sums a list of per-leaf
    # 1-d partials over the ranks holding each leaf's shards
    leaf_sums: bool = False
    # the engine keeps the state in pinned host memory (ZeRO-Offload's
    # streamed tier; the DeepSpeedCPU* frontends of ops/{adam,lion,adagrad})
    offload_to_host: bool = False


def _lr_at(lr, count):
    return lr(count) if callable(lr) else lr


def _zeros(params, fill=0.0):
    return tree_unflatten(params, [torch.full_like(p, fill)
                                   for p in tree_leaves(params)])


def _fp32(leaves, copy):
    """The fp32 leaves a step works on: a widened copy of a leaf stored in
    another dtype; an fp32 leaf itself (stepped in place) unless `copy`,
    which the masked skip-step needs to keep the old value."""
    return [x.clone() if copy and x.dtype == torch.float32 else x.float()
            for x in leaves]


def _transform(lr, moments, step, leaf_norms=False):
    """An optimizer from `moments` {state name: initial fill} and
    `step(g, p, moments, count) -> direction` over fp32 leaf lists, which
    steps the moments in place and returns new direction tensors; the
    update is -lr(count) * direction. `count` (int32, on the params'
    device) is shared by the moment bias corrections and the schedule, as
    optax's two counters always agree."""

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else "cpu"
        state = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        state.update({name: _zeros(params, fill)
                      for name, fill in moments.items()})
        return state

    def update(grads, state, params, apply=None, leaf_norms=None):
        count = state["count"]
        copy = apply is not None
        stored = {name: tree_leaves(state[name]) for name in moments}
        work = {name: _fp32(leaves, copy) for name, leaves in stored.items()}
        p_stored = tree_leaves(params)
        p = _fp32(p_stored, copy)
        kw = {"norms": leaf_norms} if leaf_norms is not None else {}
        direction = step([g.float() for g in tree_leaves(grads)], p, work,
                         count, **kw)
        torch._foreach_mul_(direction, -_lr_at(lr, count))
        torch._foreach_add_(p, direction)
        masked_update(p_stored, p, apply)
        for name in moments:
            masked_update(stored[name], work[name], apply)
        state["count"] = count + (1 if apply is None
                                  else apply.to(torch.int32))

    return GradientTransformation(init, update, leaf_norms)


def _adam_direction(g, m, count, b1, b2, eps):
    mu, nu = m["mu"], m["nu"]
    torch._foreach_lerp_(mu, g, 1 - b1)              # (1 - b1) g + b1 mu
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1 - b2)  # (1 - b2) g^2 + b2 nu
    t = (count + 1).float()
    denom = torch._foreach_div(nu, 1 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    direction = torch._foreach_div(mu, 1 - b1 ** t)
    torch._foreach_div_(direction, denom)
    return direction


def _adam(lr, params: Dict[str, Any]):
    b1, b2 = params.get("betas", (0.9, 0.999))
    eps = params.get("eps", 1e-8)
    return _transform(lr, {"mu": 0.0, "nu": 0.0},
                      lambda g, p, m, c: _adam_direction(g, m, c, b1, b2, eps))


def _adamw(lr, params: Dict[str, Any]):
    b1, b2 = params.get("betas", (0.9, 0.999))
    eps, wd = params.get("eps", 1e-8), params.get("weight_decay", 0.01)

    def step(g, p, m, c):
        u = _adam_direction(g, m, c, b1, b2, eps)
        torch._foreach_add_(u, p, alpha=wd)
        return u

    return _transform(lr, {"mu": 0.0, "nu": 0.0}, step)


def _lamb(lr, params: Dict[str, Any]):
    b1, b2 = params.get("betas", (0.9, 0.999))
    eps, wd = params.get("eps", 1e-6), params.get("weight_decay", 0.0)

    def step(g, p, m, c, norms=torch._foreach_norm):
        u = _adam_direction(g, m, c, b1, b2, eps)
        torch._foreach_add_(u, p, alpha=wd)
        for x, p_norm, u_norm in zip(u, norms(p), norms(u)):
            x.mul_(torch.where((p_norm == 0) | (u_norm == 0),
                               torch.ones_like(p_norm), p_norm / u_norm))
        return u

    return _transform(lr, {"mu": 0.0, "nu": 0.0}, step, leaf_norms=True)


def _lion(lr, params: Dict[str, Any]):
    b1, b2 = params.get("betas", (0.9, 0.99))
    wd = params.get("weight_decay", 0.0)

    def step(g, p, m, c):
        u = torch._foreach_mul(m["mu"], b1)
        torch._foreach_add_(u, g, alpha=1.0 - b1)
        torch._foreach_sign_(u)
        torch._foreach_lerp_(m["mu"], g, 1 - b2)
        torch._foreach_add_(u, p, alpha=wd)
        return u

    return _transform(lr, {"mu": 0.0}, step)


def _sgd(lr, params: Dict[str, Any]):
    momentum = params.get("momentum", 0.0)
    nesterov = params.get("nesterov", False)

    def step(g, p, m, c):
        trace = m["trace"]
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, g)                # g + momentum trace
        if nesterov:
            return torch._foreach_add(g, trace, alpha=momentum)
        return [t.clone() for t in trace]

    return _transform(lr, {"trace": 0.0}, step)


def _adagrad(lr, params: Dict[str, Any]):
    eps = params.get("eps", 1e-10)

    def step(g, p, m, c):
        ss = m["sum_of_squares"]
        torch._foreach_addcmul_(ss, g, g)
        return [torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * x
                for s, x in zip(ss, g)]

    # optax.adagrad's initial_accumulator_value
    return _transform(lr, {"sum_of_squares": 0.1}, step)


def _onebit_adam(lr, params: Dict[str, Any]):
    # the compressed-communication family: the exact base optimizer in
    # warmup, then frozen variance and a sign-compressed momentum with
    # error feedback (runtime/compressed_grads.py)
    from deepspeed_tpu_torch.runtime.compressed_grads import onebit_adam
    return onebit_adam(lr, params)


def _onebit_lamb(lr, params: Dict[str, Any]):
    from deepspeed_tpu_torch.runtime.compressed_grads import onebit_lamb
    return onebit_lamb(lr, params)


def _zero_one_adam(lr, params: Dict[str, Any]):
    from deepspeed_tpu_torch.runtime.compressed_grads import zero_one_adam
    return zero_one_adam(lr, params)


OPTIMIZER_REGISTRY = {
    ADAM_OPTIMIZER: _adam,
    ADAMW_OPTIMIZER: _adamw,
    LAMB_OPTIMIZER: _lamb,
    LION_OPTIMIZER: _lion,
    SGD_OPTIMIZER: _sgd,
    ADAGRAD_OPTIMIZER: _adagrad,
    ONEBIT_ADAM_OPTIMIZER: _onebit_adam,
    ZERO_ONE_ADAM_OPTIMIZER: _zero_one_adam,
    ONEBIT_LAMB_OPTIMIZER: _onebit_lamb,
}

# reference config type strings naming implementation variants of the same
# optimizer (fused CUDA kernels, AVX host steps): one implementation each
OPTIMIZER_ALIASES = {
    "fusedadam": ADAM_OPTIMIZER,
    "fusedadamw": ADAMW_OPTIMIZER,
    "fusedlamb": LAMB_OPTIMIZER,
    "fusedlion": LION_OPTIMIZER,
    "deepspeedcpuadam": ADAM_OPTIMIZER,
    "deepspeedcpulion": LION_OPTIMIZER,
    "deepspeedcpuadagrad": ADAGRAD_OPTIMIZER,
    "onebitadam": ONEBIT_ADAM_OPTIMIZER,
    "zerooneadam": ZERO_ONE_ADAM_OPTIMIZER,
    "onebitlamb": ONEBIT_LAMB_OPTIMIZER,
}


def build_optimizer(opt_config, lr_schedule=None):
    """An optimizer from an OptimizerConfig block; `lr_schedule` (from the
    scheduler block) overrides the static `lr` param."""
    name = opt_config.type.lower()
    name = OPTIMIZER_ALIASES.get(name, name)
    if name not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer '{opt_config.type}'. "
                         f"Known: {sorted(OPTIMIZER_REGISTRY)}")
    params = dict(opt_config.params)
    lr = lr_schedule if lr_schedule is not None else params.get("lr", 1e-3)
    logger.info(f"Building optimizer: {name} "
                f"(lr={'<schedule>' if callable(lr) else lr})")
    return OPTIMIZER_REGISTRY[name](lr, params)

