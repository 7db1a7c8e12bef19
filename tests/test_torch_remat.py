"""Selective remat in the PyTorch port held to the JAX package's: every
accepted `remat_policy` gives the loss and gradients of `nothing_saveable`
and of `jax.grad` under the same JAX policy, keeps what it says (counted
by a TorchDispatchMode over the backward's recompute), and an unknown or
factory name raises. fp32 on the CPU, 2 layers, numpy-seeded weights.

Tolerances: against `nothing_saveable` atol 1e-6 (the same ops in the same
order: kept outputs are the recomputed ones, bit for bit); against JAX
atol 1e-5 on the loss and every gradient (XLA and PyTorch's CPU kernels sum
in other orders).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.utils.checkpoint_names import (checkpoint_name,
                                                        current_name)
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten

POLICIES = sorted(tgpt.REMAT_POLICIES)
FACTORIES = ["save_only_these_names", "save_any_names_but_these",
             "save_anything_except_these_names", "save_from_both_policies",
             "offload_dot_with_no_batch_dims",
             "save_and_offload_only_these_names"]
L = 2
aten = torch.ops.aten


def _jax_cfg(**flags):
    return jgpt.GPTConfig(n_layer=L, n_head=4, d_model=64, max_seq_len=64,
                          vocab_size=256, dtype=jnp.float32, **flags)


def _port_cfg(**flags):
    return tgpt.GPTConfig(n_layer=L, n_head=4, d_model=64, max_seq_len=64,
                          vocab_size=256, dtype="float32", **flags)


def _np_params(seed=1):
    return jax.tree_util.tree_map(
        np.asarray, jgpt.init_gpt_params(_jax_cfg(), seed=seed))


TOKENS = np.random.default_rng(2).integers(0, 256, (3, 33)).astype(np.int32)


class _Ops(TorchDispatchMode):
    """Counts of the aten ops dispatched, by op name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _port_loss_grads(cfg, np_params):
    """(loss, grads, op counts of the backward)."""
    params = tgpt.params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = tgpt.gpt_loss(tree_unflatten(params, leaves),
                         {"tokens": torch.from_numpy(TOKENS)}, cfg=cfg)
    ops = _Ops()
    with ops:
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, ops.counts


_JAX = {}


def _jax_loss_grads(policy, np_params):
    if policy not in _JAX:
        mesh_mod.clear_mesh()
        mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1,
                                      expert=1, pipe=1))
        cfg = _jax_cfg(remat=True, remat_policy=policy)
        loss, grads = jax.value_and_grad(
            lambda p: jgpt.gpt_loss(p, {"tokens": jnp.asarray(TOKENS)},
                                    None, cfg))(
            jax.tree_util.tree_map(jnp.asarray, np_params))
        _JAX[policy] = (float(loss), [np.asarray(g) for g in
                                      jax.tree_util.tree_leaves(grads)])
    return _JAX[policy]


@pytest.mark.parametrize("use_flash", [None, True],
                         ids=["plain-attention", "flash-wrappers"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_nothing_saveable_and_jax(policy, use_flash):
    """Loss and every gradient under `policy` against `nothing_saveable`
    (atol 1e-6) and against `jax.grad` under the same JAX policy (atol
    1e-5), through the plain attention and through the flash wrappers'
    autograd function (its plain versions on the CPU)."""
    np_params = _np_params()
    loss, grads, _ = _port_loss_grads(
        _port_cfg(remat_policy=policy, use_flash_attention=use_flash),
        np_params)
    ref_loss, ref_grads, _ = _port_loss_grads(
        _port_cfg(remat_policy="nothing_saveable",
                  use_flash_attention=use_flash), np_params)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    for g, r in zip(grads, ref_grads, strict=True):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6)
    jloss, jgrads = _jax_loss_grads(policy, np_params)
    np.testing.assert_allclose(float(loss), jloss, atol=1e-5)
    for g, w in zip(grads, jgrads, strict=True):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


# recomputed GEMMs a backward at 2 layers, over the backward without remat:
# (mm + addmm, bmm). Under nothing_saveable the replay of a block runs
# 3 of its 4 projections: the down projection's output is needed by no
# backward formula, and non-reentrant checkpoint stops its replay once
# every saved tensor is back. The plain attention's two batched products
# a block are dots with batch dims: only dots_saveable (and
# everything_saveable) keep them.
RECOMPUTED = {
    "nothing_saveable": (3 * L, 2 * L),
    "dots_with_no_batch_dims_saveable": (0, 2 * L),
    "checkpoint_dots_with_no_batch_dims": (0, 2 * L),
    "dots_saveable": (0, 0),
    "checkpoint_dots": (0, 0),
    "everything_saveable": (0, 0),
    "save_matmuls": (0, 2 * L),
    "save_matmuls_probs": (0, 2 * L),
}


@pytest.mark.parametrize("policy", POLICIES)
def test_recomputed_gemms_show_what_the_policy_keeps(policy):
    np_params = _np_params()
    _, _, ops = _port_loss_grads(_port_cfg(remat_policy=policy), np_params)
    _, _, base = _port_loss_grads(_port_cfg(remat=False), np_params)

    def extra(*names):
        return sum(ops.get(n, 0) - base.get(n, 0) for n in names)
    assert (extra("mm", "addmm"), extra("bmm", "baddbmm")) == \
        RECOMPUTED[policy]
    # 4 projections a block in the forward; the headline policy's saving
    # over nothing_saveable is the recomputed 3 x L of them
    if policy == "save_matmuls_probs":
        assert extra("_softmax") == 0       # the probs are kept
    if policy == "everything_saveable":
        assert extra("gelu", "_softmax", "mean") == 0


@pytest.mark.parametrize("name", FACTORIES + ["no_such_policy", ""])
def test_unknown_and_factory_names_raise(name):
    """JAX resolves these to None or to a factory and runs nothing-saveable
    (a deliberate divergence: the port raises, naming what it takes)."""
    assert getattr(jax.checkpoint_policies, name, None) is None or \
        name in FACTORIES
    with pytest.raises(ValueError, match="dots_with_no_batch_dims_saveable"):
        tgpt.resolve_remat_policy(name)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _port_cfg(remat_policy=name)
    _port_cfg(remat=False, remat_policy=name)   # unused when remat is off


def test_accepted_names_are_jaxs_argument_free_policies_and_two_more():
    def argument_free(fn):
        """A policy itself — `(prim, *_, **__)` or `(*_, **__)` — not a
        factory such as `save_only_these_names(*names)`."""
        kinds = {p.name if p.name == "prim" else p.kind
                 for p in inspect.signature(fn).parameters.values()}
        P = inspect.Parameter
        return "prim" in kinds or kinds == {P.VAR_POSITIONAL, P.VAR_KEYWORD}
    jax_names = {n for n in dir(jax.checkpoint_policies)
                 if not n.startswith("_")
                 and argument_free(getattr(jax.checkpoint_policies, n))}
    assert set(POLICIES) == jax_names | {"save_matmuls",
                                         "save_matmuls_probs"}
    assert not set(FACTORIES) & set(POLICIES)


def test_op_rules_keep_no_allocation_view_or_mutation():
    """The kernels write their outputs into `torch.empty` buffers through
    ctypes: a kept allocation would be written again by the recomputed
    kernel, so no policy keeps one."""
    a = torch.ones(4, 4)
    save, recompute = CheckpointPolicy.MUST_SAVE, \
        CheckpointPolicy.PREFER_RECOMPUTE
    every = tgpt.REMAT_POLICIES["everything_saveable"]
    assert every(None, aten.mm.default, a, a) == save
    assert every(None, aten.empty.memory_format, [4, 4]) == recompute
    assert every(None, aten.empty_like.default, a) == recompute
    assert every(None, aten.view.default, a, [16]) == recompute
    assert every(None, aten.add_.Tensor, a, a) == recompute
    dots = tgpt.REMAT_POLICIES["dots_with_no_batch_dims_saveable"]
    assert dots(None, aten.mm.default, a, a) == save
    assert dots(None, aten.addmm.default, a, a, a) == save
    assert dots(None, aten.bmm.default, a[None], a[None]) == recompute
    assert tgpt.REMAT_POLICIES["dots_saveable"](
        None, aten.bmm.default, a[None], a[None]) == save
    names = tgpt.REMAT_POLICIES["save_matmuls"]
    assert names(None, aten.mm.default, a, a) == recompute
    with checkpoint_name("mlp_up"):
        assert names(None, aten.mm.default, a, a) == save
        assert names(None, aten.empty.memory_format, [4]) == recompute
    with checkpoint_name("attn_probs"):
        assert names(None, aten._softmax.default, a, -1, False) == recompute
        assert tgpt.REMAT_POLICIES["save_matmuls_probs"](
            None, aten._softmax.default, a, -1, False) == save


def test_checkpoint_names_are_regions_with_gradients_only():
    assert current_name() is None
    with checkpoint_name("qkv_proj"):
        assert current_name() == "qkv_proj"
        with checkpoint_name("attn_probs"):
            assert current_name() == "attn_probs"
        assert current_name() == "qkv_proj"
    assert current_name() is None
    with torch.no_grad():
        with checkpoint_name("mlp_up"):
            assert current_name() is None


def test_engine_trajectory_identical_under_the_headline_policy():
    """Two engine steps at gas 2 with a bf16 accumulator: the headline
    lane's policy and `nothing_saveable` give the same losses and
    parameters, bit for bit."""
    out = {}
    for policy in ("nothing_saveable", "dots_with_no_batch_dims_saveable"):
        engine, *_ = initialize(
            model=tgpt.make_gpt_model(_port_cfg(remat_policy=policy),
                                      name="tiny",
                                      params=tgpt.params_from_jax(
                                          _np_params())),
            config={"train_micro_batch_size_per_gpu": 2,
                    "gradient_accumulation_steps": 2,
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                    "data_types": {"grad_accum_dtype": "bf16"},
                    "gradient_clipping": 1.0, "steps_per_print": 10**9},
            device="cpu")
        rng = np.random.default_rng(5)
        losses = [float(engine.train_batch(
            {"tokens": rng.integers(0, 256, (4, 33))})) for _ in range(2)]
        out[policy] = (losses, engine.state_to_numpy()["params"])
    (la, pa), (lb, pb) = out.values()
    assert la == lb
    for a, b in zip(tree_leaves(pa), tree_leaves(pb), strict=True):
        np.testing.assert_array_equal(a, b)
