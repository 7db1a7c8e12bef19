"""The PyTorch port's training slice held to the JAX package: the GPT loss
and its gradients, the six optimizers, the five lr schedules, the loss
scaler, the batch triad, and the engine's trajectory. Inputs and weights
come from numpy seeds (weights moved leaf by leaf with `params_from_jax`);
everything is fp32 on the CPU, where the port runs its kernels' plain
versions.

Tolerances (fp32 on both sides; XLA and PyTorch's CPU kernels sum in other
orders): loss atol 1e-5; gradients rtol 1e-4 / atol 1e-5; one optimizer
update rtol 1e-5 / atol 1e-7; schedules rtol 1e-6; the 5-step engine
trajectory rtol 1e-4 on the losses and atol 2e-5 on the final parameters
and Adam moments (five updates compound the gradients' differences).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig, OptimizerConfig as JOpt
from deepspeed_tpu.config.core import SchedulerConfig as JSched
from deepspeed_tpu.config.core import TpuTrainConfig as JTrainConfig
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops import optim as joptim
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime.precision import LossScaler as JLossScaler
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.config.core import OptimizerConfig, SchedulerConfig
from deepspeed_tpu_torch.config.core import TpuTrainConfig
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import optim as toptim
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime.precision import LossScaler
from deepspeed_tpu_torch.utils.tree import tree_leaves

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_cfg(**flags):
    return jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=64,
                          vocab_size=256, dtype=jnp.float32, **flags)


def _port_cfg(jcfg, **over):
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    kw = {n: getattr(jcfg, n) for n in names}
    kw.update(dtype="float32", **over)
    return tgpt.GPTConfig(**kw)


def _one_device_mesh():
    mesh_mod.clear_mesh()
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _tokens(seed, B, T):
    return np.random.default_rng(seed).integers(0, 256, (B, T)) \
        .astype(np.int32)


def _jax_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt.init_gpt_params(jcfg, seed=seed))


# ----------------------------------------------------------------------
# (b) the loss and every parameter's gradient
# ----------------------------------------------------------------------


@pytest.mark.parametrize("use_flash", [None, True],
                         ids=["plain-attention", "flash-wrappers"])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("labels", [False, True],
                         ids=["tokens", "input_ids+labels"])
def test_gpt_loss_and_grads_match_jax(remat, use_flash, labels):
    """`gpt_loss` under `torch.autograd.grad` against
    `jax.value_and_grad(gpt_loss)`: both batch forms (labels carry ignored
    -100 entries), remat on and off, and on the CPU both the plain
    attention program and the kernel wrappers' autograd function."""
    _one_device_mesh()
    jcfg = _jax_cfg(remat=remat)
    pcfg = _port_cfg(jcfg, use_flash_attention=use_flash)
    np_params = _jax_params(jcfg, seed=1)
    toks = _tokens(2, 3, 33)
    if labels:
        lab = toks[:, 1:].copy()
        lab[0, :5] = -100
        lab[2, -3:] = -100
        batch = {"input_ids": toks[:, :-1], "labels": lab}
    else:
        batch = {"tokens": toks}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(p, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, None, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = {k: v for k, v in tgpt.params_from_jax(np_params).items()}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    op_builder.LAUNCHES.clear()
    loss = tgpt.gpt_loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg=pcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert sum(op_builder.LAUNCHES.values()) == 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_gpt_forward_matches_jax_logits():
    _one_device_mesh()
    jcfg = _jax_cfg(remat=False)
    np_params = _jax_params(jcfg, seed=3)
    toks = _tokens(4, 2, 16)
    want = jgpt.gpt_forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                            jnp.asarray(toks), jcfg)
    got = tgpt.gpt_forward(tgpt.params_from_jax(np_params),
                           torch.from_numpy(toks), _port_cfg(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ----------------------------------------------------------------------
# (c) one update of each optimizer against optax
# ----------------------------------------------------------------------

_OPTIMIZERS = [
    ("Adam", {"lr": 1e-2, "betas": (0.8, 0.99)}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.1}),
    ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("Lion", {"lr": 1e-3, "weight_decay": 0.1}),
    ("SGD", {"lr": 1e-1, "momentum": 0.9, "nesterov": True}),
    ("Adagrad", {"lr": 1e-1}),
]
# the optax state holding each port state entry
_OPTAX_STATE = {"mu": "mu", "nu": "nu", "trace": "trace",
                "sum_of_squares": "sum_of_squares"}


@pytest.mark.parametrize("name,params", _OPTIMIZERS,
                         ids=[o[0] for o in _OPTIMIZERS])
def test_optimizer_updates_match_optax(name, params):
    """Two updates (the second sees the moments and the bias correction
    of the first) on a tree with a zero leaf, which Lamb's trust ratio
    treats specially. The port steps params and state in place: after
    each update the params against optax's `apply_updates`, and at the
    end every state leaf against optax's."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": np.zeros(3, np.float32),
            "blocks": {"s": rng.standard_normal((2, 5)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        for _ in range(2)]
    jtx = joptim.build_optimizer(JOpt(type=name, params=dict(params)))
    ttx = toptim.build_optimizer(OptimizerConfig(type=name,
                                                 params=dict(params)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), tree)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                jstate, jp)
        ttx.update(jax.tree_util.tree_map(torch.from_numpy, g), tstate, tp)
        jp = optax.apply_updates(jp, ju)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    inner = jstate[0]
    for key in tstate:
        if key == "count":
            if "count" in getattr(inner, "_fields", ()):
                assert int(tstate["count"]) == int(inner.count)
            continue
        want = jax.tree_util.tree_leaves(getattr(inner, _OPTAX_STATE[key]))
        for a, b in zip(tree_leaves(tstate[key]), want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("name", ["OneBitAdam", "ZeroOneAdam", "OneBitLamb"])
def test_compressed_optimizers_refuse(name):
    """The 1-bit optimizers, which refused until item 7 closed, now build
    through the registry as JAX's do: their state carries optax's field
    names (`runtime/compressed_grads.py`; the parity tests are in
    `tests/test_torch_compressed_grads.py`)."""
    tx = toptim.build_optimizer(OptimizerConfig(type=name))
    assert tx.leaf_sums
    state = tx.init({"w": torch.zeros(3, 2)})
    ref = joptim.build_optimizer(JOpt(type=name)).init(
        {"w": jnp.zeros((3, 2))})
    assert tuple(state) == type(ref)._fields


_FRONTENDS = [
    ("adam", "FusedAdam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adam", "FusedAdam", {"lr": 1e-2, "adam_w_mode": False,
                           "weight_decay": 0.1}),
    ("adam", "DeepSpeedCPUAdam", {"lr": 1e-2, "weight_decay": 0.01}),
    ("lamb", "FusedLamb", {"lr": 1e-2, "max_grad_norm": 1.0}),
    ("lion", "FusedLion", {"lr": 1e-3, "weight_decay": 0.1}),
    ("lion", "DeepSpeedCPULion", {"lr": 1e-3}),
    ("adagrad", "DeepSpeedCPUAdagrad", {"lr": 1e-1, "weight_decay": 0.1}),
]


@pytest.mark.parametrize("module,name,kw", _FRONTENDS,
                         ids=[f"{n}-{i}" for i, (_, n, _) in
                              enumerate(_FRONTENDS)])
def test_optimizer_frontends_match_jax(module, name, kw):
    """`deepspeed_tpu_torch.ops`' reference-named frontends step as JAX's
    `deepspeed_tpu.ops` ones (two updates, the params at rtol 1e-5); the
    DeepSpeedCPU* ones are tagged for the host-resident state, as JAX tags
    them."""
    import importlib
    import deepspeed_tpu_torch.ops as tops
    jfn = getattr(importlib.import_module(f"deepspeed_tpu.ops.{module}"),
                  name)
    ttx, jtx = getattr(tops, name)(**kw), jfn(**kw)
    assert ttx.offload_to_host == name.startswith("DeepSpeedCPU") == \
        bool(getattr(jtx, "offload_to_host", False))
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), tree)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda x: (3 * rng.standard_normal(x.shape)).astype(np.float32),
            tree)
        ju, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                jstate, jp)
        ttx.update(jax.tree_util.tree_map(torch.from_numpy, g), tstate, tp)
        jp = optax.apply_updates(jp, ju)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


def test_runtime_utils_match_jax():
    """`get_global_norm` and the functional `clip_grad_norm_` of
    `runtime/utils.py`, as JAX's."""
    from deepspeed_tpu.runtime import utils as jutils
    from deepspeed_tpu_torch.runtime import utils as tutils
    rng = np.random.default_rng(2)
    tree = {"a": (4 * rng.standard_normal((5, 3))).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    assert tutils.get_global_norm([3.0, 4.0]) == \
        jutils.get_global_norm([3.0, 4.0])
    np.testing.assert_allclose(tutils.get_global_norm(parameters=ttree),
                               jutils.get_global_norm(parameters=jtree),
                               rtol=1e-6)
    for max_norm in (1.0, 1e3):
        got, gn = tutils.clip_grad_norm_(grads=ttree, max_norm=max_norm)
        want, wn = jutils.clip_grad_norm_(grads=jtree, max_norm=max_norm)
        np.testing.assert_allclose(gn, wn, rtol=1e-6)
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert tutils.__all__ == jutils.__all__


# ----------------------------------------------------------------------
# (d) the five lr schedules
# ----------------------------------------------------------------------

_SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-2,
                  "warmup_num_steps": 7}),
    ("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 7,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_num_steps": 5,
                       "warmup_max_lr": 3e-3}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 4,
                        "warmup_min_ratio": 0.1, "warmup_max_lr": 2e-3}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 5, "cycle_second_step_size": 6,
                  "decay_step_size": 3, "decay_lr_rate": 0.5}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 4,
                     "lr_range_test_step_rate": 2.0,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("name,params", _SCHEDULES,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(_SCHEDULES)])
def test_lr_schedules_match_jax(name, params):
    jfn = jsched.build_schedule(JSched(type=name, params=dict(params)))
    tfn = tsched.build_schedule(SchedulerConfig(type=name,
                                                params=dict(params)))
    for step in range(30):
        np.testing.assert_allclose(float(tfn(step)), float(jfn(step)),
                                   rtol=1e-6, err_msg=f"step {step}")


# ----------------------------------------------------------------------
# (e) the loss scaler over an injected-overflow trace
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(hysteresis=2, loss_scale_window=3),
    dict(hysteresis=3, loss_scale_window=2, consecutive_hysteresis=True),
    dict(static_scale=128.0),
], ids=["dynamic", "consecutive-hysteresis", "static"])
def test_loss_scale_state_sequence_matches_jax(kw):
    trace = [True, True, False, True, False, False, False, True, True, True,
             True, False, True, True, True, True]
    common = dict(initial_scale_power=8, min_loss_scale=4.0, **kw)
    js, ts = JLossScaler(**common), LossScaler(**common)
    jstate, tstate = js.init(), ts.init()
    for i, finite in enumerate(trace):
        jstate = js.update(jstate, jnp.asarray(finite))
        tstate = ts.update(tstate, torch.tensor(finite))
        for field in jstate._fields:
            assert float(getattr(tstate, field)) == \
                float(getattr(jstate, field)), (i, field)


# ----------------------------------------------------------------------
# (f) the batch triad
# ----------------------------------------------------------------------


@pytest.mark.parametrize("triad", [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 8},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3},
    {"train_batch_size": 12},
    {"train_micro_batch_size_per_gpu": 6},
    {"train_batch_size": "auto", "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": "auto"},
    {},
], ids=lambda t: ",".join(f"{k[6:12]}={v}" for k, v in t.items()) or "none")
def test_batch_triad_resolves_like_jax(triad):
    want = JTrainConfig.load(dict(triad)).resolve_batch_sizes(1)
    assert TpuTrainConfig.load(dict(triad)).resolve_batch_sizes(1) == want


@pytest.mark.parametrize("triad", [
    {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 8},
    {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 4},
], ids=["inconsistent", "zero-gas"])
def test_batch_triad_refuses_what_jax_refuses(triad):
    with pytest.raises(AssertionError):
        JTrainConfig.load(dict(triad)).resolve_batch_sizes(1)
    with pytest.raises(ValueError, match="batch size"):
        TpuTrainConfig.load(dict(triad)).resolve_batch_sizes(1)


# ----------------------------------------------------------------------
# (g) the engine's trajectory against the JAX engine
# ----------------------------------------------------------------------


def _engine_config(mbs):
    return {"train_micro_batch_size_per_gpu": mbs,
            "gradient_accumulation_steps": 2, "gradient_clipping": 0.5,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 1e-4,
                                     "warmup_max_lr": 3e-3,
                                     "warmup_num_steps": 3}},
            "zero_optimization": {"stage": 1}}


def test_engine_trajectory_matches_jax_engine():
    """Five train_batch steps from the same params and batches, gas 2,
    clipping, AdamW with a warmup schedule. The JAX engine spans conftest's
    8 virtual CPU devices (micro-batch 1 per device); the port, at one
    rank, takes micro-batch 8 — the same global micro-batches."""
    mesh_mod.clear_mesh()
    jcfg = _jax_cfg()
    jspec = jgpt.make_gpt_model(cfg=jcfg, name="tiny", seed=7)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jspec, config={**_engine_config(1), "mesh": {"data": 8}})
    teng, *_ = initialize(
        model=tgpt.make_gpt_model(_port_cfg(jcfg), name="tiny",
                                  params=tgpt.params_from_jax(np_params)),
        config=_engine_config(8), device="cpu")
    assert teng.train_batch_size() == jeng.train_batch_size() == 16
    batches = [{"tokens": _tokens(10 + i, 16, 33)} for i in range(5)]
    jl = [float(jeng.train_batch(b)) for b in batches]
    tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    st = teng.state_to_numpy()
    assert int(st["step"]) == int(jeng.state.step) == 5
    for a, b in zip(tree_leaves(st["params"]),
                    jax.tree_util.tree_leaves(jeng.state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)
    adam = jeng.state.opt_state[0]
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(st["opt_state"][key]),
                        jax.tree_util.tree_leaves(getattr(adam, key))):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    mesh_mod.clear_mesh()


def test_forward_backward_step_matches_train_batch():
    """The forward/backward/step triplet over the gas micro-batches gives
    train_batch's step; eval_batch gives the loss of the current params."""
    cfg = _port_cfg(_jax_cfg())
    params = tgpt.init_gpt_params(cfg, seed=9)
    config = _engine_config(2)
    ea, *_ = initialize(model=tgpt.make_gpt_model(cfg, params=params),
                        config=config, device="cpu")
    eb, *_ = initialize(model=tgpt.make_gpt_model(cfg, params=params),
                        config=config, device="cpu")
    for i in range(2):
        toks = _tokens(20 + i, 4, 17)
        la = ea.train_batch({"tokens": toks})
        for half in (toks[:2], toks[2:]):
            eb.backward(eb.forward({"tokens": half}))
        metrics = eb.step()
        np.testing.assert_allclose(float(metrics["loss"]), float(la),
                                   rtol=1e-6)
    for a, b in zip(tree_leaves(ea.params), tree_leaves(eb.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    toks = _tokens(30, 2, 17)
    assert float(ea.eval_batch({"tokens": toks})) == pytest.approx(
        float(tgpt.gpt_loss(ea.params, {"tokens": torch.from_numpy(toks)},
                            cfg=cfg)))
    assert ea.global_steps == eb.global_steps == 2


def test_fp16_overflow_skips_the_step_and_cuts_the_scale():
    """An inf loss under fp16: the masked update keeps params and moments,
    the step counter stays, the scale halves (hysteresis 1)."""
    params = {"w": torch.ones(4, 3)}
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
              "fp16": {"enabled": True, "hysteresis": 1}}
    eng, *_ = initialize(model=lambda p, b: (p["w"].sum() * float("inf")),
                         model_parameters=params, config=config, device="cpu")
    scale0 = eng.cur_scale
    before = eng.state_to_numpy()
    eng.train_batch({"x": np.zeros((2, 1), np.float32)})
    after = eng.state_to_numpy()
    assert eng.cur_scale == scale0 / 2 and eng.skipped_steps == 1
    assert eng.global_step == 0 and eng.global_steps == 1
    np.testing.assert_array_equal(after["params"]["w"], before["params"]["w"])
    np.testing.assert_array_equal(after["opt_state"]["mu"]["w"],
                                  before["opt_state"]["mu"]["w"])
