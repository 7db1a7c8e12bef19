"""The 1-bit (compressed-communication) optimizer family (counterpart of
`deepspeed_tpu/runtime/compressed_grads.py`).

OnebitAdam, OnebitLamb and ZeroOneAdam share one structure: a warmup
phase running the exact base optimizer, then a compressed phase where the
second moment is frozen and the momentum is replaced by its 1-bit sign
times one scale (mean |m + e|), with the quantization residual `e`
carried to the next step (error feedback). The quantization goes through
the comm facade's `onebit_encode` / `onebit_decode` (`comm/collectives.py`),
the same rule the engine's compressed all-reduce sends, so it lives in
one place; sign(0) packs as +1.

Each optimizer is the port's `GradientTransformation` (`ops/optim.py`):
`init(params)` and an in-place `update(grads, state, params, apply=None,
leaf_sums=None)` over fp32 leaf lists, with the loss scaler's skip-step
mask `apply` holding every stored leaf where it is false. The state trees
keep optax's field names: `{"count", "mu", "nu", "error"}`
(`OnebitAdamState`), `{"base", "scaling"}` (`OnebitLambState`) and
`{"error", "inner", "step"}` (`ErrorFeedbackState`), so a checkpoint
crosses packages by name. The phase switch and the variance mask are
device tensors selected with `torch.where`, so a step never waits for
the card. Where the leaves stepped are a rank's shards (ZeRO 1-3 across
ranks), the engine passes `leaf_sums`, which sums per-leaf partials over
the ranks holding a leaf's shards: the sign scale and LAMB's norms are
then read over the whole leaf, as JAX reads them over the global array.

The JAX package computes all of this in jnp, outside any Pallas kernel,
so the port's is plain torch.
"""

import torch

from deepspeed_tpu_torch.comm.collectives import onebit_decode, onebit_encode
from deepspeed_tpu_torch.ops.optim import GradientTransformation
from deepspeed_tpu_torch.runtime.precision import masked_update
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _sign_compress(x, scale=None):
    """sign(x) * mean|x| through the facade's 1-bit wire (an encode /
    decode round trip), fp32, shaped as `x`; `scale` (0-d), where given,
    is the whole leaf's mean |.| of which `x` is a shard."""
    flat = x.float().reshape(-1)
    packed, s = onebit_encode(flat, scale)
    return onebit_decode(packed, s, flat.shape[0]).reshape(x.shape)


def _whole_scales(xs, leaf_sums):
    """Per-leaf mean |x| over the whole leaves, summed in fp64 as
    `onebit_encode` sums it (None without `leaf_sums`: each leaf's own
    mean, inside `onebit_encode`)."""
    if leaf_sums is None:
        return [None] * len(xs)
    parts = [torch.stack([x.abs().sum(dtype=torch.float64),
                          torch.tensor(float(x.numel()), dtype=torch.float64,
                                       device=x.device)]) for x in xs]
    return [s[0] / s[1] for s in leaf_sums(parts)]


def _zeros(params):
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                   for p in tree_leaves(params)])


def _count0(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr_at(lr, count):
    return lr(count) if callable(lr) else lr


def _bump(count, apply):
    return count + (1 if apply is None else apply.to(torch.int32))


def _work(leaves, apply):
    """The fp32 params the step writes: a widened copy of a leaf in
    another dtype, the leaf itself unless the skip-step needs its old
    value."""
    copy = apply is not None
    return [x.clone() if copy and x.dtype == torch.float32 else x.float()
            for x in leaves]


def error_feedback_compress(warmup_steps=100):
    """A gradient transform in front of any base optimizer: after
    `warmup_steps`, each grad leaf becomes sign(g + e) * scale and the
    residual is carried. `update(grads, state)` returns the new grads'
    tree and steps `state` in place."""

    def init(params):
        return {"error": _zeros(params), "inner": {},
                "step": _count0(params)}

    def update(grads, state, params=None, apply=None, leaf_sums=None):
        in_warmup = state["step"] < warmup_steps
        g = tree_leaves(grads)
        err = tree_leaves(state["error"])
        corrected = [x.float() + e for x, e in zip(g, err)]
        scales = _whole_scales(corrected, leaf_sums)
        q = [_sign_compress(c, s) for c, s in zip(corrected, scales)]
        out = [torch.where(in_warmup, x, qx.to(x.dtype))
               for x, qx in zip(g, q)]
        masked_update(err, [torch.where(in_warmup, e, c - qx) for e, c, qx
                            in zip(err, corrected, q)], apply)
        state["step"] = _bump(state["step"], apply)
        return tree_unflatten(grads, out)

    return GradientTransformation(init, update, leaf_sums=True)


def _onebit_core(freeze_step, b1, b2, nu_update_mask_fn=None,
                 compress_from=None):
    """(init, moments) of Adam with a compressed momentum.
    `nu_update_mask_fn(count)` (a 0-d bool tensor) says whether nu moves
    this step (default: count < freeze_step); compression starts at
    `compress_from` (default: freeze_step; ZeroOneAdam: 0)."""
    if compress_from is None:
        compress_from = freeze_step
    if nu_update_mask_fn is None:
        def nu_update_mask_fn(count):
            return count < freeze_step

    def init(params):
        return {"count": _count0(params), "mu": _zeros(params),
                "nu": _zeros(params), "error": _zeros(params)}

    def moments(g, state, leaf_sums=None):
        """fp32 leaf lists (mu_eff, nu, error) and the 0-d `in_warmup`;
        the compressed momentum replaces the stored one."""
        count = state["count"]
        in_warmup = count < compress_from
        update_nu = nu_update_mask_fn(count)
        mu = tree_leaves(state["mu"])
        nu = tree_leaves(state["nu"])
        err = tree_leaves(state["error"])
        new_mu = [m * b1 + x * (1 - b1) for m, x in zip(mu, g)]
        new_nu = [torch.where(update_nu, v * b2 + (x * x) * (1 - b2), v)
                  for v, x in zip(nu, g)]
        corrected = [m + e for m, e in zip(new_mu, err)]
        scales = _whole_scales(corrected, leaf_sums)
        q = [_sign_compress(c, s) for c, s in zip(corrected, scales)]
        mu_eff = [torch.where(in_warmup, m, qx) for m, qx in zip(new_mu, q)]
        new_err = [torch.where(in_warmup, e, c - qx)
                   for e, c, qx in zip(err, corrected, q)]
        return mu_eff, new_nu, new_err, in_warmup

    return init, moments


def _adam_steps(mu_eff, nu, params, count, b1, b2, eps, weight_decay):
    """(m / bc1) / (sqrt(v / bc2) + eps) (+ wd * p), the bias corrections
    at the incremented count."""
    t = (count + 1).float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    steps = [(m / bc1) / (torch.sqrt(v / bc2) + eps)
             for m, v in zip(mu_eff, nu)]
    if weight_decay:
        steps = [s + weight_decay * p for s, p in zip(steps, params)]
    return steps


def _store(state, mu_eff, nu, err, apply):
    masked_update(tree_leaves(state["mu"]), mu_eff, apply)
    masked_update(tree_leaves(state["nu"]), nu, apply)
    masked_update(tree_leaves(state["error"]), err, apply)
    state["count"] = _bump(state["count"], apply)


def _apply_params(p_stored, p, steps, coef, apply):
    for x, s, c in zip(p, steps, coef):
        x.add_(s * c)
    masked_update(p_stored, p, apply)


def _adam_like(lr, b1, b2, eps, weight_decay, init, moments):
    def update(grads, state, params, apply=None, leaf_sums=None):
        g = [x.float() for x in tree_leaves(grads)]
        p_stored = tree_leaves(params)
        p = _work(p_stored, apply)
        mu_eff, nu, err, _ = moments(g, state, leaf_sums)
        count = state["count"]
        steps = _adam_steps(mu_eff, nu, p, count, b1, b2, eps, weight_decay)
        coef = -_lr_at(lr, count)
        _apply_params(p_stored, p, steps, [coef] * len(steps), apply)
        _store(state, mu_eff, nu, err, apply)

    return GradientTransformation(init, update, leaf_sums=True)


def onebit_adam_tx(lr, freeze_step=100, b1=0.9, b2=0.999, eps=1e-8,
                   weight_decay=0.0):
    """OnebitAdam: Adam in warmup; from `freeze_step` the variance freezes
    and the momentum is sign-compressed with error feedback."""
    init, moments = _onebit_core(freeze_step, b1, b2)
    return _adam_like(lr, b1, b2, eps, weight_decay, init, moments)


def onebit_lamb_tx(lr, freeze_step=100, b1=0.9, b2=0.999, eps=1e-6,
                   weight_decay=0.0, max_coeff=10.0, min_coeff=0.01):
    """OnebitLamb: LAMB in warmup (each leaf's trust ratio clipped to
    [min_coeff, max_coeff]); the ratios freeze at the freeze boundary and
    scale the compressed phase's steps."""
    init_core, moments = _onebit_core(freeze_step, b1, b2)

    def init(params):
        leaves = tree_leaves(params)
        return {"base": init_core(params),
                "scaling": tree_unflatten(params, [
                    torch.ones((), dtype=torch.float32, device=p.device)
                    for p in leaves])}

    def norms(xs, leaf_sums):
        parts = [x.square().sum().reshape(1) for x in xs]
        if leaf_sums is not None:
            parts = leaf_sums(parts)
        return [torch.sqrt(s[0]) for s in parts]

    def update(grads, state, params, apply=None, leaf_sums=None):
        base = state["base"]
        g = [x.float() for x in tree_leaves(grads)]
        p_stored = tree_leaves(params)
        p = _work(p_stored, apply)
        mu_eff, nu, err, in_warmup = moments(g, base, leaf_sums)
        count = base["count"]
        steps = _adam_steps(mu_eff, nu, p, count, b1, b2, eps, weight_decay)
        frozen = tree_leaves(state["scaling"])
        scaling = []
        for w, s, f in zip(norms(p, leaf_sums), norms(steps, leaf_sums),
                           frozen):
            ratio = torch.where(s > 0, w / (s + 1e-12), 1.0)
            ratio = torch.clamp(ratio, min_coeff, max_coeff)
            scaling.append(torch.where(in_warmup, ratio, f))
        lr_t = -_lr_at(lr, count)
        _apply_params(p_stored, p, steps, [lr_t * c for c in scaling], apply)
        masked_update(frozen, scaling, apply)
        _store(base, mu_eff, nu, err, apply)

    return GradientTransformation(init, update, leaf_sums=True)


def zero_one_adam_tx(lr, var_freeze_step=100, var_update_scaler=16,
                     local_step_clipper=16, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0):
    """ZeroOneAdam (0/1 Adam): the momentum is compressed from step 0;
    the variance moves only at exponentially spaced steps before
    `var_freeze_step` (the interval doubles every `var_update_scaler`
    updates, at most `local_step_clipper` times) and is frozen after."""

    def nu_mask(count):
        doublings = torch.clamp(torch.div(count, var_update_scaler,
                                          rounding_mode="floor"),
                                max=local_step_clipper)
        interval = torch.clamp(torch.pow(2, doublings), min=1)
        return (count < var_freeze_step) & (count % interval == 0)

    init, moments = _onebit_core(var_freeze_step, b1, b2,
                                 nu_update_mask_fn=nu_mask, compress_from=0)
    return _adam_like(lr, b1, b2, eps, weight_decay, init, moments)


# ---- config-facing constructors (ops/optim.py registry) -----------------

def onebit_adam(lr, params_dict):
    betas = params_dict.get("betas", (0.9, 0.999))
    freeze = params_dict.get("freeze_step",
                             params_dict.get("warmup_steps", 100))
    return onebit_adam_tx(lr, freeze_step=freeze, b1=betas[0], b2=betas[1],
                          eps=params_dict.get("eps", 1e-8),
                          weight_decay=params_dict.get("weight_decay", 0.0))


def onebit_lamb(lr, params_dict):
    betas = params_dict.get("betas", (0.9, 0.999))
    return onebit_lamb_tx(lr, freeze_step=params_dict.get("freeze_step", 100),
                          b1=betas[0], b2=betas[1],
                          eps=params_dict.get("eps", 1e-6),
                          weight_decay=params_dict.get("weight_decay", 0.0),
                          max_coeff=params_dict.get("max_coeff", 10.0),
                          min_coeff=params_dict.get("min_coeff", 0.01))


def zero_one_adam(lr, params_dict):
    """`local_step_scaler` is accepted and inert, as in JAX: every step is
    synchronized, so there is no local-step skipping to schedule."""
    betas = params_dict.get("betas", (0.9, 0.999))
    return zero_one_adam_tx(
        lr, var_freeze_step=params_dict.get("var_freeze_step", 100),
        var_update_scaler=params_dict.get("var_update_scaler", 16),
        local_step_clipper=params_dict.get("local_step_clipper", 16),
        b1=betas[0], b2=betas[1], eps=params_dict.get("eps", 1e-8),
        weight_decay=params_dict.get("weight_decay", 0.0))
