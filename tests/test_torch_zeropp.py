"""ZeRO++ (qwZ, qgZ, hpZ), MiCS and the explicit compressed grad-reduce of
the port held to the JAX package's.

- Each quantized collective (`runtime/quantized_collectives.py`) on 2 gloo
  ranks against JAX's inside `shard_map` on a 2-device mesh, on the same
  per-rank inputs: the int8 payloads and scales each rank sends are
  bit-equal, the fp32 results agree at rtol 1e-6 and `CommStats` records
  JAX's bytes.
- The engine on 2 ranks at stage 1 qgZ, stage 3 qwZ, stage 3 qwZ + qgZ,
  `explicit_grad_reduce` with the fp32 and int8 wires and
  `onebit_gradients` (stage 2), against the JAX engine with the same knobs
  on `mesh: {"data": 2}`: fp32, SGD, gas 2, 2 steps. The tolerance comes
  from the wire. Every param element agrees within 1e-5 of its leaf's
  largest magnitude, except where a rounding flipped between the two
  packages' sum orders. A flip moves an element by at most the learning
  rate times two quanta of each compressed reduce of its leaf: the int8
  wire's quantum is max|x| / 127 of a group, the 1-bit wire's 2 x scale.
  The flips are counted and stay under 1 % of the elements. The 1-bit
  wire's residuals are held per rank the same way. The losses agree at
  rtol 1e-5, and each run stays within JAX's rtol 0.08
  (`tests/test_zeropp.py:187`) of the port's unquantized run.
- MiCS and hpZ on 4 ranks (data 2 x zero 2) against JAX's 4-device mesh:
  the factoring, every leaf's param and state specs equal to the JAX
  engine's (the shard axes `tests/test_zeropp.py:118-153` expects: params
  on `zero` alone, MiCS's state too, hpZ's state over the whole domain),
  losses and leaves within PR 22's 1e-5; hpZ's weight gathers ride the
  inner axis only (`tests/test_comm_volume.py:126`).
- The facade's bytes a step equal the stated analytic count of each path.
- At one rank (no process group) each knob trains bit-equal to the plain
  stage: every wire is disabled.
- The 1-bit optimizers on state sharded over 2 ranks (stages 1-3) against
  the JAX engine on the 2-device mesh at rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.comm import collectives as jcoll
from deepspeed_tpu.comm import mesh as jmesh
from deepspeed_tpu.config.core import MeshConfig as JMeshConfig
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime import quantized_collectives as jqc
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.comm import collectives as tcoll
from deepspeed_tpu_torch.testing.dist import RankPool
from deepspeed_tpu_torch.utils.tree import tree_leaves

W = 2
JCFG = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=256,
                      max_seq_len=64, vocab_size=512, dtype=jnp.float32,
                      remat=True)
SEQ, GAS, LR = 17, 2, 0.1
TIGHT = 1e-5
# name: (stage, zero_optimization knobs, the engine's path)
CASES = {
    "s1_qgz": (1, {"zero_quantized_gradients": True}, "quantized"),
    "s3_qwz": (3, {"zero_quantized_weights": True}, "quantized"),
    "s3_qwz_qgz": (3, {"zero_quantized_weights": True,
                       "zero_quantized_gradients": True}, "quantized"),
    "explicit_fp32": (2, {"explicit_grad_reduce": True}, "explicit"),
    "explicit_int8": (2, {"explicit_grad_reduce": True,
                          "zero_quantized_gradients": True}, "explicit"),
    "onebit": (2, {"onebit_gradients": True}, "explicit"),
}
FOUR = {"mics": {"mics_shard_size": 2}, "hpz": {"zero_hpz_partition_size": 2}}
_PARAMS = jax.tree_util.tree_map(
    np.asarray, jgpt.init_gpt_params(JCFG, seed=3))
TRAIN = "deepspeed_tpu_torch.testing.dist:zero_train"


def _port_kwargs():
    from deepspeed_tpu_torch.models import gpt as tgpt
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    return {**{n: getattr(JCFG, n) for n in names}, "dtype": "float32"}


def _config(stage, knobs=None, world=W):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "SGD", "params": {"lr": LR}},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": 0,
                                  **(knobs or {})},
            "mesh": {"data": world}, "steps_per_print": 10**9}


def _batches(world=W):
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, 512, (2 * GAS * world, SEQ))
             .astype(np.int32)} for _ in range(2)]


def _jax_run(config, world=W):
    jmesh.clear_mesh()
    spec = jgpt.make_gpt_model(cfg=dataclasses.replace(JCFG, remat=False),
                               name="tiny", seed=3)
    eng, *_ = deepspeed_tpu.initialize(model=spec, config=config)
    losses = [float(eng.train_batch(b)) for b in _batches(world)]
    out = {"losses": losses,
           "params": [np.asarray(x, np.float32) for x in
                      jax.tree_util.tree_leaves(eng.state.params)],
           "spec": eng.spec,
           "pspecs": [tuple(s.spec) for s in
                      jax.tree_util.tree_leaves(eng.param_shardings)],
           "sspecs": None if eng.master_shardings is None else
           [tuple(s.spec) for s in
            jax.tree_util.tree_leaves(eng.master_shardings)],
           "residuals": None if eng._comm_err is None else
           [np.asarray(x) for x in jax.tree_util.tree_leaves(eng._comm_err)]}
    jmesh.clear_mesh()
    return out


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(W, tmp_path_factory.mktemp("zeropp")) as p:
        yield p


@pytest.fixture(scope="module")
def runs(pool):
    """(port runs, JAX runs) by case, and the port's unquantized runs by
    stage ("plain<stage>"): the port's start on the ranks first and run
    while the JAX references compile here."""
    pending = {name: pool.submit(TRAIN, _config(stage, knobs), _PARAMS,
                                 _port_kwargs(), _batches())
               for name, (stage, knobs, _) in CASES.items()}
    for stage in (1, 2, 3):
        pending[f"plain{stage}"] = pool.submit(
            TRAIN, _config(stage), _PARAMS, _port_kwargs(), _batches())
    jax_out = {name: _jax_run(_config(stage, knobs))
               for name, (stage, knobs, _) in CASES.items()}
    return {k: result() for k, result in pending.items()}, jax_out


# ----------------------------------------------------------------------
# the quantized collectives
# ----------------------------------------------------------------------


def _per_rank():
    rng = np.random.default_rng(11)
    return [{"ag": rng.normal(0, 1, (64, 32)).astype(np.float32),
             "rs": rng.normal(0, 1, (W * 64, 16)).astype(np.float32),
             "ar": rng.normal(0, 1, (33, 7)).astype(np.float32)}
            for _ in range(W)]


_JAX_CALLS = {
    "quantized_all_gather": ("ag", lambda v: jqc.quantized_all_gather(
        v, "data")),
    "quantized_reduce_scatter": ("rs", lambda v: jqc.quantized_reduce_scatter(
        v, "data")),
    "quantized_psum_scatter_mean": ("rs", lambda v:
                                    jqc.quantized_psum_scatter_mean(v, "data")),
    "qgz_allreduce": ("ar", lambda v: jqc.qgz_allreduce(v, "data")),
    "quantized_all_gather_dim": ("ag", lambda v: jqc.quantized_all_gather_dim(
        v, "data", 1)),
}


def test_quantized_collectives_match_jax(pool):
    per_rank = _per_rank()
    port = pool.run("deepspeed_tpu_torch.testing.dist:zeropp_collectives",
                    per_rank)
    jmesh.clear_mesh()
    mesh = jmesh.init_mesh(JMeshConfig(data=W, zero=1, tensor=1, sequence=1,
                                       expert=1, pipe=1))
    for name, (key, fn) in _JAX_CALLS.items():
        stacked = jnp.stack([jnp.asarray(r[key]) for r in per_rank])
        jcoll.stats.reset()
        out = shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                        in_specs=P("data"), out_specs=P("data"),
                        check_vma=False)(stacked)
        snap = jcoll.stats.snapshot()
        for r in range(W):
            np.testing.assert_allclose(port[r]["out"][name],
                                       np.asarray(out[r]), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            assert port[r]["stats"][name] == snap, name
    jmesh.clear_mesh()
    # what each rank hands to the wire: the int8 payload and its scales
    for r in range(W):
        x = per_rank[r]
        ar = x["ar"].reshape(-1)
        ar = np.concatenate([ar, np.zeros(-ar.size % W, np.float32)])
        for flat in (x["ag"].reshape(-1), x["rs"].reshape(W, -1),
                     ar.reshape(W, -1)):
            tq, ts = tcoll.group_quant_int8(torch.from_numpy(flat.copy()))
            jq, js = jcoll.group_quant_int8(jnp.asarray(flat))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ----------------------------------------------------------------------
# the engine's ZeRO++ paths against the JAX engine
# ----------------------------------------------------------------------


def _flip_bounds(run, nleaves):
    """Each leaf's bound on a flipped element: LR x the sum over its
    compressed reduces (on any rank) of two quanta."""
    bound = np.zeros(nleaves)
    for rank in run:
        per = np.zeros(nleaves)
        for step in rank["wires"]:
            for j, call in enumerate(step):
                q = 2 * call["mean"] if call["transform"] == "onebit" \
                    else call["amax"] / 127
                per[j % nleaves] += LR * 2 * q
        bound = np.maximum(bound, per)
    return bound


def _held(got, want, bound):
    """(flipped elements, elements) of `got` against `want`: beyond TIGHT
    of the leaf's largest magnitude only within the leaf's flip bound."""
    flips = total = 0
    for a, b, q in zip(got, want, bound):
        tight = TIGHT * max(float(np.abs(b).max()), 1e-30)
        d = np.abs(a - b)
        assert d.max() <= tight + q, (d.max(), tight, q)
        flips += int((d > tight).sum())
        total += d.size
    return flips, total


@pytest.mark.parametrize("name", list(CASES))
def test_engine_knobs_match_jax_on_a_2_device_mesh(runs, name):
    port, jax_out = runs
    out, ref = port[name], jax_out[name]
    stage, _, path = CASES[name]
    plain = port[f"plain{stage}"][0]["losses"]
    for r in range(W):
        assert out[r]["path"] == path and out[r]["dp"] == (W, r)
        np.testing.assert_allclose(out[r]["losses"], ref["losses"],
                                   rtol=TIGHT)
        np.testing.assert_allclose(out[r]["losses"], plain, rtol=0.08)
        leaves = tree_leaves(out[r]["state"]["params"])
        assert [a.shape for a in leaves] == [b.shape for b in ref["params"]]
        bound = _flip_bounds(out, len(leaves))
        flips, total = _held(leaves, ref["params"], bound)
        assert flips <= 0.01 * total, (name, flips, total)
        if name == "onebit":
            res = out[r]["residuals"]
            want = [x[r] for x in ref["residuals"]]
            flips, total = _held(res, want, bound / LR)
            assert flips <= 0.01 * total, (name, flips, total)
        else:
            assert out[r]["residuals"] is None
    for a, b in zip(tree_leaves(out[0]["state"]),
                    tree_leaves(out[1]["state"])):
        np.testing.assert_array_equal(a, b)


# the 1-bit optimizers on state sharded across the ranks (stages 1-3):
# the linear model of `testing/dist.zero_branches`, whose gradients have no
# element that is roundoff alone (a GPT's key bias has: the 1-bit sign of
# its momentum is then the sum order's, in either package)
SHARDED_1BIT = {
    "OneBitAdam-stage2": (2, {"type": "OneBitAdam", "params": {
        "lr": 1e-2, "freeze_step": 1}}),
    "OneBitLamb-stage3": (3, {"type": "OneBitLamb", "params": {
        "lr": 1e-2, "freeze_step": 1}}),
    "ZeroOneAdam-stage1": (1, {"type": "ZeroOneAdam", "params": {
        "lr": 1e-2, "var_freeze_step": 2, "var_update_scaler": 1}}),
}


def _jax_linear(config, steps):
    """JAX's engine on `zero_branches`' model, params and batches."""
    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.normal(0, 0.5, (8, 4)).astype(np.float32)),
              "b": jnp.zeros(4, jnp.float32)}
    jmesh.clear_mesh()
    eng, *_ = deepspeed_tpu.initialize(
        model=lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"]) ** 2),
        model_parameters=params, config=config)
    mb, gas = eng.micro_batch_size, eng.gradient_accumulation_steps()
    out = []
    for _ in range(steps):
        x = rng.normal(0, 1, (gas, mb * W, 8)).astype(np.float32)
        loss = float(eng.train_batch({"x": x.reshape(-1, 8)}))
        out.append((loss, [np.asarray(t) for t in
                           jax.tree_util.tree_leaves(eng.state.params)]))
    jmesh.clear_mesh()
    return out


@pytest.mark.parametrize("name", list(SHARDED_1BIT))
def test_onebit_optimizers_on_sharded_state_match_jax(pool, name):
    """Each 1-bit optimizer with its state sharded over 2 ranks (the sign
    scale and LAMB's norms summed over the whole leaves) against the JAX
    engine on the 2-device mesh, 3 steps (compressed from the second; 0/1
    Adam from the first): losses and params at rtol 1e-5."""
    stage, opt = SHARDED_1BIT[name]
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "optimizer": opt,
              "zero_optimization": {"stage": stage},
              "mesh": {"data": W}, "steps_per_print": 10**9}
    out = pool.run("deepspeed_tpu_torch.testing.dist:zero_branches", config,
                   [1.0] * W, 3)
    ref = _jax_linear(config, 3)
    for rank in out:
        for step, (loss, params) in zip(rank, ref):
            np.testing.assert_allclose(step["loss"], loss, rtol=TIGHT)
            for a, b in zip(step["params"], params):
                np.testing.assert_allclose(a, b, rtol=TIGHT, atol=1e-7)


ONE_RANK_KNOBS = {
    "stage3_qwz_qgz": (3, {"zero_quantized_weights": True,
                           "zero_quantized_gradients": True}),
    "stage2_explicit_int8": (2, {"explicit_grad_reduce": True,
                                 "zero_quantized_gradients": True}),
    "stage2_onebit": (2, {"onebit_gradients": True}),
    "stage3_hpz_mics": (3, {"zero_hpz_partition_size": 1,
                            "mics_shard_size": 1}),
}


def _one_rank(stage, knobs=None):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import gpt as tgpt
    eng, *_ = initialize(model=tgpt.make_gpt_model(
        tgpt.GPTConfig(**_port_kwargs()), name="tiny",
        params=tgpt.params_from_jax(_PARAMS)),
        config=_config(stage, knobs, world=1), device="cpu")
    losses = [float(eng.train_batch(b)) for b in _batches(1)]
    return eng, losses, tree_leaves(eng.state_to_numpy()["params"])


@pytest.mark.parametrize("name", list(ONE_RANK_KNOBS))
def test_every_wire_is_disabled_at_one_rank(name):
    """With no process group each ZeRO++ knob takes the plain path, as JAX
    disables its wire on a one-device data domain (the port disables the
    quantized micro-batch path there too, where JAX's runs on an axis of
    1): losses and params bit-equal to the plain stage's."""
    stage, knobs = ONE_RANK_KNOBS[name]
    eng, losses, params = _one_rank(stage, knobs)
    assert eng._zeropp is None and eng._comm_err is None
    _, want_losses, want = _one_rank(stage)
    assert losses == want_losses
    for a, b in zip(params, want):
        np.testing.assert_array_equal(a, b)


def _pad_d(numel, n=W):
    """(chunk length, its int8 group count) of a flat payload padded to a
    multiple of n (`compressed_all_reduce`)."""
    d = -(-numel // n)
    return d, _groups(d)


def _groups(numel):
    return numel // 256 if numel % 256 == 0 else 1


def _analytic(name, plan, n=W, gas=GAS):
    """{op: (calls, bytes)} a step of each path (fp32, SGD).
    Quantized path, a micro-batch: stage 3 gathers every sharded param
    whole at entry (qwZ: its int8 payload and its scales, two all-gathers;
    else one fp32 all-gather); each leaf's grads cross the qgZ wire (int8
    all-to-all of the payload and the scales, then an int8 all-gather of
    the reduced chunk and its scales) or a plain fp32 all-reduce; the loss
    one all-reduce. Explicit path, a step: each leaf's grads once over the
    fp32 wire (a reduce-scatter and an all-gather), the int8 wire (as
    qgZ), or the 1-bit wire (an all-gather of the packed signs and one of
    the scale); the loss one all-reduce. Every path: one post-update
    all-gather of the updated state shards of the params held whole."""
    stage, knobs, path = CASES[name]
    numel = [int(np.prod(p["shape"])) for p in plan]
    ops = {}

    def add(op, b, calls=1):
        c, total = ops.get(op, (0, 0))
        ops[op] = (c + calls, total + b)

    qw = knobs.get("zero_quantized_weights") and stage == 3
    qg = knobs.get("zero_quantized_gradients")
    wire = "onebit" if knobs.get("onebit_gradients") else \
        ("int8" if qg else "none")
    rounds = gas if path == "quantized" else 1
    for _ in range(rounds):
        for p, k in zip(plan, numel):
            if stage == 3 and p["pdim"] is not None:
                shard = k // n
                if qw:
                    add("all_gather", shard)
                    add("all_gather", 4 * _groups(shard))
                else:
                    add("all_gather", 4 * shard)
        for k in numel:
            d, g = _pad_d(k, n)
            if (path == "quantized" and qg) or \
                    (path == "explicit" and wire == "int8"):
                add("all_to_all", n * d)
                add("all_to_all", 4 * n * g)
                add("all_gather", d)
                add("all_gather", 4 * g)
            elif path == "quantized":
                add("all_reduce", 4 * k)
            elif wire == "none":
                add("reduce_scatter", 4 * n * d)
                add("all_gather", 4 * d)
            else:
                add("all_gather", -(-k // 8))
                add("all_gather", 4)
        add("all_reduce", 4)
    held = [k // n for p, k in zip(plan, numel)
            if p["pdim"] is None and p["sdim"] is not None]
    if held:
        add("all_gather", 4 * sum(held))
    return ops


@pytest.mark.parametrize("name", list(CASES))
def test_zeropp_comm_bytes_per_step_equal_the_stated_counts(runs, name):
    out = runs[0][name]
    want = _analytic(name, out[0]["leaves"])
    for r in range(W):
        for snap in out[r]["stats"]:
            got = {op: (v["calls"], v["bytes"]) for op, v in snap.items()}
            assert got == want, (name, r)


# ----------------------------------------------------------------------
# MiCS and hpZ on 4 ranks: data 2 x zero 2
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("zeropp4")) as p4:
        pending = {name: p4.submit(TRAIN, _config(3, knobs, 4), _PARAMS,
                                   _port_kwargs(), _batches(4))
                   for name, knobs in FOUR.items()}
        pending["plain3"] = p4.submit(TRAIN, _config(3, None, 4), _PARAMS,
                                      _port_kwargs(), _batches(4))
        jax_out = {name: _jax_run(_config(3, knobs, 4), 4)
                   for name, knobs in FOUR.items()}
        yield {k: result() for k, result in pending.items()}, jax_out


def _axes_of(spec):
    used = set()
    for entry in spec:
        if entry is not None:
            used.update(entry if isinstance(entry, tuple) else (entry,))
    return used


def _padded(spec, rank):
    return tuple(spec) + (None,) * (rank - len(spec))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(FOUR))
def test_mics_and_hpz_match_jax_on_data_2_x_zero_2(runs4, name):
    port, jax_out = runs4
    out, ref = port[name], jax_out[name]
    assert (ref["spec"].data, ref["spec"].zero) == (2, 2)
    for r in range(4):
        assert (out[r]["spec"]["data"], out[r]["spec"]["zero"]) == (2, 2)
        np.testing.assert_allclose(out[r]["losses"], ref["losses"],
                                   rtol=TIGHT)
        for a, b in zip(tree_leaves(out[r]["state"]["params"]),
                        ref["params"]):
            assert a.shape == b.shape and _rel(a, b) <= TIGHT
    # every leaf's shard axes: params on the inner axis alone; MiCS keeps
    # the state there too, hpZ spreads it over the whole domain
    pdomain, sdomain = out[0]["domains"]
    assert pdomain == ("zero",)
    assert sdomain == (("zero",) if name == "mics" else
                       ("data", "zero", "sequence"))
    for leaf, jp, js in zip(out[0]["leaves"], ref["pspecs"],
                            ref["sspecs"] or ref["pspecs"]):
        rank = len(leaf["shape"])
        assert _padded(leaf["pspec"], rank) == _padded(jp, rank)
        assert _padded(leaf["sspec"], rank) == _padded(js, rank)
    assert all("data" not in _axes_of(leaf["pspec"])
               for leaf in out[0]["leaves"])
    assert any("zero" in _axes_of(leaf["pspec"]) for leaf in out[0]["leaves"])
    assert any("data" in _axes_of(leaf["sspec"])
               for leaf in out[0]["leaves"]) == (name == "hpz")


def test_hpz_weight_gathers_ride_the_inner_axis(runs4):
    """hpZ: every all-gather of a step rides the `zero` sub-group but one,
    the post-update regather of the updated state shards over the whole
    domain; plain stage 3 gathers every weight over the whole domain."""
    port = runs4[0]
    whole = ("data", "zero", "sequence")
    for r in range(4):
        for step in port["hpz"][r]["gathers"]:
            axes = [a for a, _ in step]
            assert axes.count(whole) == 1 and axes[-1] == whole
            assert set(axes) == {("zero",), whole}
        for step in port["plain3"][r]["gathers"]:
            assert {a for a, _ in step} == {whole}
        for step in port["mics"][r]["gathers"]:
            assert {a for a, _ in step} == {("zero",)}
    np.testing.assert_allclose(port["hpz"][0]["losses"],
                               port["plain3"][0]["losses"], rtol=TIGHT)
