"""The port's 1-bit optimizers (`runtime/compressed_grads.py`) held to the
JAX package's (`deepspeed_tpu/runtime/compressed_grads.py`).

Each transform is stepped beside JAX's; every step is fed the same grads
and the same state, copied JAX -> numpy -> port, so that no step inherits
an earlier sign flip. Warmup steps match at rtol 1e-6. Compressed steps:
the momentum's sign bits are equal wherever |m + e| > 1e-6 * scale (the
count of the others is 0 on these seeded inputs), the scale (mean |m + e|,
summed in another order) at rtol 1e-6, nu and LAMB's trust ratios at rtol
1e-6, the residual within 1e-6 of the scale (it is m + e less +-scale),
the stepped params within 1e-6 of their leaf's largest magnitude.
ZeroOneAdam's variance mask equals JAX's over 64 steps, across the
interval's doublings and the clipper. Each optimizer trains through the
config on JAX's quadratic (`tests/test_onebit.py:147`) with losses within
rtol 1e-4 of the JAX engine's over 8 steps; a JAX numpy-engine checkpoint
of a 1-bit optimizer resumes in the port, and the port's crosses back
through JAX's `convert_checkpoint_to_universal`. Everything is fp32 on the
CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import universal as juni
from deepspeed_tpu.comm import mesh as jmesh
from deepspeed_tpu.runtime import compressed_grads as jcg
from deepspeed_tpu_torch.runtime import compressed_grads as tcg
from deepspeed_tpu_torch.runtime.engine import ModelSpec, initialize
from deepspeed_tpu_torch.utils.tree import tree_leaves

RTOL = 1e-6
SHAPES = {"a": (33, 7), "b": (257,), "c": (8, 8)}
FREEZE = 3
STEPS = 7


def _txs(kind):
    """(JAX transform, port transform) with the same hyperparameters."""
    if kind == "adam":
        kw = dict(freeze_step=FREEZE, weight_decay=0.01)
        return jcg.onebit_adam_tx(1e-2, **kw), tcg.onebit_adam_tx(1e-2, **kw)
    if kind == "lamb":
        kw = dict(freeze_step=FREEZE, weight_decay=0.01)
        return jcg.onebit_lamb_tx(1e-2, **kw), tcg.onebit_lamb_tx(1e-2, **kw)
    kw = dict(var_freeze_step=5, var_update_scaler=2, local_step_clipper=2)
    return jcg.zero_one_adam_tx(1e-2, **kw), \
        tcg.zero_one_adam_tx(1e-2, **kw)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _port_state(jstate):
    """A JAX optimizer state (NamedTuples of arrays) as the port's dicts."""
    if hasattr(jstate, "_fields"):
        return {f: _port_state(getattr(jstate, f)) for f in jstate._fields}
    if isinstance(jstate, dict):
        return {k: _port_state(v) for k, v in jstate.items()}
    return torch.from_numpy(np.array(jstate))


def _base(state):
    return state["base"] if "base" in state else state


@pytest.mark.parametrize("kind", ["adam", "lamb", "zeroone"])
def test_each_step_matches_jax_on_the_same_inputs(kind):
    jtx, ttx = _txs(kind)
    rng = np.random.default_rng({"adam": 1, "lamb": 2, "zeroone": 3}[kind])
    params = _tree(rng)
    jstate = jtx.init(jax.tree_util.tree_map(jnp.asarray, params))
    compress_from = 0 if kind == "zeroone" else FREEZE
    others = 0
    for step in range(STEPS):
        grads = _tree(rng, 0.5)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jbase = jstate.base if kind == "lamb" else jstate
        count = int(jbase.count)
        b1 = 0.9
        corrected = {k: b1 * np.asarray(jbase.mu[k]) + (1 - b1) * grads[k]
                     + np.asarray(jbase.error[k]) for k in SHAPES}
        tstate = _port_state(jstate)
        tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ttx.update({k: torch.from_numpy(v) for k, v in grads.items()},
                   tstate, tparams)
        updates, jstate = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        want_p = optax.apply_updates(jp, updates)
        jbase = jstate.base if kind == "lamb" else jstate
        tbase = _base(tstate)
        assert int(tbase["count"]) == int(jbase.count) == count + 1
        for k in SHAPES:
            mu_t, mu_j = tbase["mu"][k].numpy(), np.asarray(jbase.mu[k])
            np.testing.assert_allclose(tbase["nu"][k].numpy(),
                                       np.asarray(jbase.nu[k]), rtol=RTOL)
            if count < compress_from:
                np.testing.assert_allclose(mu_t, mu_j, rtol=RTOL)
                np.testing.assert_allclose(tbase["error"][k].numpy(),
                                           np.asarray(jbase.error[k]),
                                           rtol=RTOL)
            else:
                scale_t, scale_j = np.abs(mu_t).max(), np.abs(mu_j).max()
                assert np.ptp(np.abs(mu_t)) == 0 and np.ptp(np.abs(mu_j)) == 0
                np.testing.assert_allclose(scale_t, scale_j, rtol=RTOL)
                clear = np.abs(corrected[k]) > 1e-6 * scale_j
                others += int((~clear).sum())
                np.testing.assert_array_equal(np.signbit(mu_t)[clear],
                                              np.signbit(mu_j)[clear])
                np.testing.assert_allclose(tbase["error"][k].numpy(),
                                           np.asarray(jbase.error[k]),
                                           rtol=0, atol=RTOL * scale_j)
            want = np.asarray(want_p[k])
            np.testing.assert_allclose(tparams[k].numpy(), want, rtol=0,
                                       atol=RTOL * np.abs(want).max())
        if kind == "lamb":
            for k in SHAPES:
                np.testing.assert_allclose(
                    tstate["scaling"][k].numpy(),
                    np.asarray(jstate.scaling[k]), rtol=RTOL)
        params = {k: np.asarray(v) for k, v in want_p.items()}
    assert others == 0


def test_lamb_trust_ratio_freezes_at_the_boundary():
    """The ratios move in warmup, clipped to [min_coeff, max_coeff], and
    hold from the freeze step on, in both packages."""
    jtx, ttx = _txs("lamb")
    rng = np.random.default_rng(4)
    tparams = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    state = ttx.init(tparams)
    seen = []
    for _ in range(6):
        ttx.update({k: torch.from_numpy(v) for k, v in
                    _tree(rng, 0.5).items()}, state, tparams)
        seen.append({k: float(v) for k, v in state["scaling"].items()})
    for k in SHAPES:
        assert seen[FREEZE - 1][k] == seen[FREEZE][k] == seen[-1][k]
        assert len({round(s[k], 8) for s in seen[:FREEZE]}) > 1
        assert all(0.01 <= s[k] <= 10.0 for s in seen)


def test_zero_one_adam_variance_mask_equals_jax_over_64_steps():
    """nu moves exactly where JAX's does: at counts divisible by an
    interval that doubles every 4 updates (1, 2, 4, then 8, held there by
    the clipper's 3 doublings), and never from count 60 on."""
    kw = dict(var_freeze_step=60, var_update_scaler=4, local_step_clipper=3)
    jtx, ttx = jcg.zero_one_adam_tx(1e-3, **kw), \
        tcg.zero_one_adam_tx(1e-3, **kw)
    p = {"w": np.zeros(3, np.float32)}
    jstate = jtx.init(jax.tree_util.tree_map(jnp.asarray, p))
    tstate = ttx.init({"w": torch.zeros(3)})
    tp = {"w": torch.zeros(3)}
    moved_j, moved_t = [], []
    for step in range(64):
        g = np.full(3, 1.0 + step, np.float32)
        nu_j = np.asarray(jstate.nu["w"]).copy()
        nu_t = tstate["nu"]["w"].clone()
        _, jstate = jtx.update({"w": jnp.asarray(g)}, jstate,
                               jax.tree_util.tree_map(jnp.asarray, p))
        ttx.update({"w": torch.from_numpy(g)}, tstate, tp)
        moved_j.append(not np.array_equal(np.asarray(jstate.nu["w"]), nu_j))
        moved_t.append(not torch.equal(tstate["nu"]["w"], nu_t))
    assert moved_t == moved_j
    assert [i for i, m in enumerate(moved_j) if m][:8] == \
        [0, 1, 2, 3, 4, 6, 8, 16]
    assert not any(moved_j[60:]) and moved_j[56]


def test_sign_compress_zero_maps_to_plus_scale():
    """sign(0) packs as +1, as `test_sign_compress_zero_maps_to_plus_scale`
    pins JAX's; the scale is the whole tensor's mean |x|, or the one given
    for a shard of a larger leaf."""
    x = torch.tensor([0.0, -2.0, 2.0, 0.0])
    out = tcg._sign_compress(x)
    want = np.asarray(jcg._sign_compress(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(out.numpy(), [1.0, -1.0, 1.0, 1.0])
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        tcg._sign_compress(x, torch.tensor(3.0)).numpy(),
        [3.0, -3.0, 3.0, 3.0])


def test_error_feedback_compress_matches_jax():
    """The standalone transform: the grads pass through in warmup, then
    become sign(g + e) * scale with the residual carried."""
    jtx, ttx = jcg.error_feedback_compress(2), tcg.error_feedback_compress(2)
    rng = np.random.default_rng(6)
    tree = _tree(rng)
    jstate = jtx.init(jax.tree_util.tree_map(jnp.asarray, tree))
    tstate = ttx.init({k: torch.from_numpy(v) for k, v in tree.items()})
    assert list(tstate) == list(jstate._fields)
    for _ in range(4):
        g = _tree(rng)
        out_j, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   jstate)
        out_t = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                           tstate)
        for k in SHAPES:
            scale = float(np.abs(np.asarray(out_j[k])).max())
            np.testing.assert_allclose(out_t[k].numpy(),
                                       np.asarray(out_j[k]), rtol=RTOL)
            np.testing.assert_allclose(tstate["error"][k].numpy(),
                                       np.asarray(jstate.error[k]), rtol=0,
                                       atol=RTOL * scale)
        assert int(tstate["step"]) == int(jstate.step)


# ----------------------------------------------------------------------
# the engine: JAX's quadratic and checkpoints across packages
# ----------------------------------------------------------------------

QUAD = {"train_micro_batch_size_per_gpu": 16, "mesh": {"data": 1},
        "zero_optimization": {"stage": 1}, "steps_per_print": 10**9}


def _quad_batch():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(0, 1, (16, 16)).astype(np.float32),
            "y": rng.normal(0, 1, (16, 16)).astype(np.float32)}


def _jax_quad(opt, **over):
    jmesh.clear_mesh()
    eng, *_ = deepspeed_tpu.initialize(
        model=lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
        model_parameters={"w": jnp.zeros((16, 16), jnp.float32)},
        config={**QUAD, "optimizer": opt, **over})
    return eng


def _port_quad(opt, **over):
    eng, *_ = initialize(
        model=ModelSpec(loss_fn=lambda p, b: ((b["x"] @ p["w"] - b["y"])
                                              ** 2).mean(),
                        params={"w": torch.zeros(16, 16)}),
        config={**QUAD, "optimizer": opt, **over}, device="cpu")
    return eng


@pytest.mark.parametrize("name", ["OneBitAdam", "OneBitLamb", "ZeroOneAdam"])
def test_trains_through_the_config_as_the_jax_engine(name):
    opt = {"type": name, "params": {"lr": 1e-2, "freeze_step": 3,
                                    "var_freeze_step": 3}}
    b = _quad_batch()
    jeng = _jax_quad(opt)
    want = [float(jeng.train_batch(b)) for _ in range(8)]
    jmesh.clear_mesh()
    teng = _port_quad(opt)
    got = [float(teng.train_batch(b)) for _ in range(8)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_checkpoints_cross_packages(tmp_path):
    """A JAX numpy-engine checkpoint of OneBitAdam after 3 steps (one of
    them compressed) resumes in the port: step 4's loss and every leaf
    within 1e-5 of JAX's step 4 (`rng` dropped). The port's own checkpoint
    of that state goes through JAX's `convert_checkpoint_to_universal`
    into a JAX engine, whose next loss is the port's."""
    opt = {"type": "OneBitAdam", "params": {"lr": 1e-2, "freeze_step": 2}}
    ck = {"checkpoint": {"engine": "numpy"}}
    b = _quad_batch()
    jeng = _jax_quad(opt, **ck)
    for _ in range(3):
        jeng.train_batch(b)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    want4 = float(jeng.train_batch(b))
    want_mu = np.asarray(jeng.state.opt_state.mu["w"])
    jmesh.clear_mesh()
    teng = _port_quad(opt, **ck)
    path, client = teng.load_checkpoint(str(tmp_path / "jax"))
    assert path is not None and client["global_steps"] == 3
    assert int(teng.state.opt_state["count"]) == 3
    got4 = float(teng.train_batch(b))
    assert abs(got4 - want4) <= 1e-5
    np.testing.assert_allclose(teng.state.opt_state["mu"]["w"].numpy(),
                               want_mu, rtol=0, atol=1e-5)
    teng.save_checkpoint(str(tmp_path / "port"))
    got5 = float(teng.train_batch(b))
    juni.convert_checkpoint_to_universal(str(tmp_path / "port"),
                                         str(tmp_path / "uni"))
    jeng2 = _jax_quad(opt)
    juni.load_universal_checkpoint(jeng2, str(tmp_path / "uni"))
    assert int(jeng2.state.step) == 4
    assert abs(float(jeng2.train_batch(b)) - got5) <= 1e-5
    jmesh.clear_mesh()
    names = [n for n, _ in teng.checkpoint_leaves()]
    assert {"opt_state/count", "opt_state/mu/w", "opt_state/nu/w",
            "opt_state/error/w"} <= set(names)
    assert len(tree_leaves(teng.state.opt_state)) == 4
