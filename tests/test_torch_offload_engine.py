"""ZeRO-Offload on the port's ordinary engine (`runtime/engine.py`,
`zero_optimization.offload_optimizer`) held to the JAX engine with the same
config: the streamed `cpu` tier (the state in host memory, moved through
the device for each update: the engine's own optimizer math), the `cpu`
tier forced onto the C++ host step by `zero_force_ds_cpu_optimizer`, and
`nvme` (the host step with the moments on disk). Tiny GPT, fp32 on the
CPU. The JAX engine spans conftest's 8 virtual CPU devices (micro-batch 1
a device: its single-device in-jit host placement has no CPU
implementation); the port, at one rank, takes micro-batch 8, the same
global micro-batches.

Tolerances (fp32; XLA and PyTorch's CPU kernels sum in other orders):
3-step losses atol 1e-5, parameters atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.utils.tree import tree_leaves

LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4
JCFG = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=64,
                      vocab_size=256, dtype=jnp.float32)
TCFG = tgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=64,
                      vocab_size=256, dtype="float32")


def _config(tmp_path, arm, side, mbs):
    off = {"device": "nvme" if arm == "nvme" else "cpu"}
    if arm == "nvme":
        off["nvme_path"] = str(tmp_path / side)
    config = {"train_micro_batch_size_per_gpu": mbs,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "zero_optimization": {"stage": 3, "offload_optimizer": off}}
    if arm == "forced":
        config["zero_force_ds_cpu_optimizer"] = True
    return config


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 256, (16, 17)) \
        .astype(np.int32)


@pytest.mark.parametrize("arm", ["streamed", "forced", "nvme"])
def test_three_step_trajectory_matches_the_jax_engine(arm, tmp_path):
    mesh_mod.clear_mesh()
    jspec = jgpt.make_gpt_model(cfg=JCFG, name="tiny", seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jspec, config={**_config(tmp_path, arm, "j", 1),
                             "mesh": {"data": 8}})
    teng, *_ = initialize(
        model=tgpt.make_gpt_model(TCFG, name="tiny",
                                  params=tgpt.params_from_jax(np_params)),
        config=_config(tmp_path, arm, "t", 8), device="cpu")
    host = arm != "streamed"
    assert (jeng.host_optimizer is not None) == host
    assert (teng.host_optimizer is not None) == host == teng.host_step
    assert teng.offload_optimizer_states == (not host)
    if arm == "nvme":
        assert teng.host_optimizer.nvme is not None
        assert list((tmp_path / "t").glob("*.swp"))
    for i in range(3):
        b = {"tokens": _tokens(40 + i)}
        np.testing.assert_allclose(float(teng.train_batch(b)),
                                   float(jeng.train_batch(b)),
                                   atol=LOSS_ATOL, rtol=0)
    st = teng.state_to_numpy()
    assert int(st["step"]) == int(jeng.state.step) == 3
    for a, b in zip(tree_leaves(st["params"]),
                    jax.tree_util.tree_leaves(jeng.state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=PARAM_ATOL,
                                   rtol=0)
    if host:
        for a, b in zip(tree_leaves(st["master"]),
                        jax.tree_util.tree_leaves(jeng.host_optimizer.master)):
            np.testing.assert_allclose(a, np.asarray(b), atol=PARAM_ATOL,
                                       rtol=0)
    mesh_mod.clear_mesh()


def test_deepspeed_cpu_optimizer_takes_the_host_step(tmp_path):
    config = _config(tmp_path, "streamed", "t", 8)
    config["optimizer"] = {"type": "DeepSpeedCPUAdam",
                           "params": {"lr": 1e-3}}
    teng, *_ = initialize(model=tgpt.make_gpt_model(TCFG, name="tiny"),
                          config=config, device="cpu")
    assert teng.host_step and teng.host_optimizer.optimizer == "adam"
    losses = [float(teng.train_batch({"tokens": _tokens(50)}))
              for _ in range(3)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name,kind", [
    ("Adam", ("adam", False)), ("AdamW", ("adam", True)),
    ("DeepSpeedCPUAdam", ("adam", False)), ("Lion", ("lion", True)),
    ("DeepSpeedCPULion", ("lion", True)), ("Adagrad", ("adagrad", True)),
    ("DeepSpeedCPUAdagrad", ("adagrad", True)), ("Lamb", None),
    ("SGD", None), ("FusedAdam", None)])
def test_one_rule_names_the_host_step_on_both_tiers(name, kind, tmp_path):
    """`cpu_optimizer.host_optimizer_kind` maps a config optimizer to the
    C++ step for the ordinary engine's host step and for the Infinity
    tier alike: the same (kind, adamw_mode), or the same refusal where the
    library has no such step (the JAX engine's host step runs Adam for
    any other name). DeepSpeedCPUAdam decays coupled on both, as the
    port's device Adam does for that name."""
    config = {**_config(tmp_path, "forced", "t", 8),
              "optimizer": {"type": name, "params": {"lr": 1e-3}}}
    layered = {**config, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}}
    builds = [
        (lambda: initialize(model=tgpt.make_gpt_model(TCFG, name="tiny"),
                            config=config, device="cpu")[0],
         lambda e: e.host_optimizer),
        (lambda: initialize(model=tgpt.make_gpt_layered_model(TCFG),
                            config=layered, device="cpu")[0],
         lambda e: e.layer_opts[0])]
    for build, host_opt in builds:
        if kind is None:
            with pytest.raises(ValueError, match=f"not {name.lower()}"):
                build()
        else:
            opt = host_opt(build())
            assert (opt.optimizer, opt.adamw_mode) == kind


def _cycle_tensors(step):
    """Tensors that only Python's cyclic collector would free after one
    call of `step` (gc.DEBUG_SAVEALL keeps what it finds)."""
    import gc
    import torch
    step()
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step()
        gc.collect()
        found = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    return found


@pytest.mark.parametrize("arm", ["resident", "streamed", "forced", "nvme",
                                 "infinity"])
def test_a_train_step_leaves_no_tensor_in_a_reference_cycle(arm, tmp_path):
    """A step's tensors go when their last reference does: a tensor held
    by a reference cycle (a recursive closure in `tree_unflatten` held
    every leaf of every tree it built) stays on the card until the
    cyclic collector runs, and counts in the step's peak."""
    import torch
    from deepspeed_tpu_torch.utils.tree import tree_unflatten
    leaves = [torch.ones(3), torch.zeros(2)]
    tree = tree_unflatten({"a": 0, "b": [0]}, leaves)
    assert tree["a"] is leaves[0] and tree["b"][0] is leaves[1]
    if arm == "infinity":
        config = {**_config(tmp_path, "streamed", "t", 8),
                  "zero_optimization": {"stage": 3, "offload_param": {
                      "device": "cpu"}}}
        model = tgpt.make_gpt_layered_model(TCFG)
    else:
        config = _config(tmp_path, arm, "t", 8)
        if arm == "resident":
            del config["zero_optimization"]["offload_optimizer"]
        model = tgpt.make_gpt_model(TCFG, name="tiny")
    eng, *_ = initialize(model=model, config=config, device="cpu")
    assert _cycle_tensors(
        lambda: eng.train_batch({"tokens": _tokens(60)})) == []
