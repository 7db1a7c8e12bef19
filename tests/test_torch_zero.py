"""The port's data-parallel ZeRO held to the JAX package's: the shard
dimension of every GPT and BERT leaf (`shard_leaf_spec`, pure Python);
the engine at stages 0-3 on 2 gloo ranks against the JAX engine on a
2-device `mesh: {"data": 2}` (fp32, gas 2, 2 steps: losses and every
leaf's ‖Δ‖/‖ref‖ within 1e-5; one bf16 stage-3 case against the JAX
engine's bf16 stage 3 at the train tolerances); `CommStats` bytes per
step equal to each stage's analytic count; the cross-rank branches (clip,
fp16 overflow skip, the sentinel) alike on both ranks when one rank's rows
alone are large or non-finite; checkpoints (a 2-rank stage-2 save resumes
bit-equal, loads into one rank, and `zero_to_fp32` gives the gathered
master; a save gathers one leaf at a time, and a failed write on rank 0
raises on every rank); and the memscope plan at data degree 2 equal to
the JAX planner's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as jmesh
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime import zero as jzero
from deepspeed_tpu.telemetry import memscope as jmemscope
from deepspeed_tpu_torch.runtime import zero as tzero
from deepspeed_tpu_torch.testing.dist import RankPool
from deepspeed_tpu_torch.utils.tree import tree_leaves

W = 2
JCFG = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=256,
                      max_seq_len=64, vocab_size=512, dtype=jnp.float32,
                      remat=True)
SEQ = 17


def _port_kwargs(jcfg, dtype="float32"):
    from deepspeed_tpu_torch.models import gpt as tgpt
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    return {**{n: getattr(jcfg, n) for n in names}, "dtype": dtype}


def _config(stage, dtype="fp32"):
    # LAMB: its per-leaf trust ratio reads the whole leaves' norms (summed
    # across ranks where the state is sharded). Adam's elementwise
    # normalization turns the fp32 roundoff of near-zero gradients (the
    # key bias's is zero in exact arithmetic) into leaf differences above
    # 1e-5 in either package's order of sums. The bf16 case runs SGD,
    # whose update is the gradient's, so each leaf's change meets the
    # grads' train tolerance (Adam's turns the bf16 noise of a
    # zero-initialized bias into a sign)
    opt = {"type": "SGD", "params": {"lr": 1e-1}} if dtype == "bf16" \
        else {"type": "Lamb", "params": {"lr": 1e-2, "eps": 1e-6}}
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": opt,
           "gradient_clipping": 1.0,
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 0},
           "mesh": {"data": W}, "steps_per_print": 10**9}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def _batches():
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, 512, (2 * 2 * W, SEQ))
             .astype(np.int32)} for _ in range(2)]


_PARAMS = jax.tree_util.tree_map(
    np.asarray, jgpt.init_gpt_params(JCFG, seed=3))


def _jax_run(stage, dtype="fp32", jcfg=JCFG):
    # remat changes no value: the JAX reference compiles without it (a
    # third less time), the port keeps it to run stage 3's re-gathers
    jmesh.clear_mesh()
    spec = jgpt.make_gpt_model(cfg=dataclasses.replace(jcfg, remat=False),
                               name="tiny", seed=3)
    eng, *_ = deepspeed_tpu.initialize(model=spec,
                                       config=_config(stage, dtype))
    losses = [float(eng.train_batch(b)) for b in _batches()]
    out = {"losses": losses,
           "params": [np.asarray(x, np.float32) for x in
                      jax.tree_util.tree_leaves(eng.state.params)],
           "master": None if eng.state.master is None else
           [np.asarray(x, np.float32) for x in
            jax.tree_util.tree_leaves(eng.state.master)],
           "plan": jmemscope.plan_training_from_engine(eng)}
    jmesh.clear_mesh()
    return out


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(W, tmp_path_factory.mktemp("zero")) as p:
        yield p


@pytest.fixture(scope="module")
def runs(pool):
    """(port runs, JAX runs) by stage, and "bf16" (stage 3): the port's
    start on the ranks first and run while the JAX references compile
    here."""
    train = "deepspeed_tpu_torch.testing.dist:zero_train"
    pending = {stage: pool.submit(train, _config(stage), _PARAMS,
                                  _port_kwargs(JCFG), _batches())
               for stage in (0, 1, 2, 3)}
    pending["bf16"] = pool.submit(train, _config(3, "bf16"), _PARAMS,
                                  _port_kwargs(JCFG, "bfloat16"), _batches())
    jax_out = {stage: _jax_run(stage) for stage in (0, 1, 2, 3)}
    jax_out["bf16"] = _jax_run(3, "bf16")
    return {k: result() for k, result in pending.items()}, jax_out


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[0]


# ----------------------------------------------------------------------
# shard_leaf_spec: JAX's dimension for every leaf
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _trees():
    g = jgpt.GPTConfig(n_layer=3, n_head=4, d_model=96, d_ff=384,
                       max_seq_len=80, vocab_size=1000, dtype=jnp.float32,
                       tie_embeddings=False)
    b = jbert.BertConfig(n_layer=2, n_head=4, d_model=64, d_ff=256,
                         vocab_size=1000, max_seq_len=128,
                         dtype=jnp.float32)
    shapes = {}
    for name, tree in (("gpt", jax.eval_shape(
            lambda: jgpt.init_gpt_params(g, seed=0))),
                       ("bert", jax.eval_shape(
                           lambda: jbert.init_bert_params(b, seed=0)))):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            shapes[f"{name}{jax.tree_util.keystr(path)}"] = \
                tuple(leaf.shape)
    return shapes


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("min_size", [0, 10**4])
def test_shard_leaf_spec_dimension_equals_jax(size, min_size):
    shapes = _trees()
    assert len(shapes) > 20
    axes = ("data", "zero", "sequence")
    for name, shape in shapes.items():
        ref = tuple(jzero.shard_leaf_spec(shape, None, axes, size,
                                          min_size=min_size))
        ref = ref + (None,) * (len(shape) - len(ref))
        got = tzero.shard_leaf_spec(shape, None, axes, size,
                                    min_size=min_size)
        assert got == ref, name
        want = next((d for d, e in enumerate(ref) if e is not None), None)
        assert tzero.shard_dim(shape, size, min_size) == want, name
    # a base spec keeps its axes, and a used axis blocks a second one
    assert tzero.shard_leaf_spec((8, 6), ("tensor",), axes, 2) == \
        tuple(jzero.shard_leaf_spec((8, 6), jax.sharding.PartitionSpec(
            "tensor"), axes, 2))


# ----------------------------------------------------------------------
# the engine at stages 0-3 against the JAX engine on data = 2
# ----------------------------------------------------------------------


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_engine_stages_match_jax_on_a_2_device_mesh(port_runs, jax_runs,
                                                    stage):
    ref = jax_runs[stage]
    out = port_runs[stage]
    for r in range(W):
        np.testing.assert_allclose(out[r]["losses"], ref["losses"],
                                   rtol=1e-5)
        leaves = tree_leaves(out[r]["state"]["params"])
        assert len(leaves) == len(ref["params"])
        for a, b in zip(leaves, ref["params"]):
            assert a.shape == b.shape
            assert _rel(a, b) <= 1e-5
        assert out[r]["dp"] == (W, r)
        assert int(out[r]["state"]["step"]) == 2
    # both ranks hold the same whole state
    for a, b in zip(tree_leaves(out[0]["state"]), tree_leaves(
            out[1]["state"])):
        np.testing.assert_array_equal(a, b)
    # what a rank holds: param shards at stage 3, state shards from 1
    plan = out[0]["leaves"]
    shard = [tuple(s // W if d == p["pdim"] else s
                   for d, s in enumerate(p["shape"])) for p in plan]
    if stage == 3:
        assert out[0]["shard_shapes"] == shard
        assert any(p["pdim"] is not None for p in plan)
    else:
        assert out[0]["shard_shapes"] == [p["shape"] for p in plan]
        assert all(p["pdim"] is None for p in plan)
    assert any(p["sdim"] is not None for p in plan) == (stage > 0)


def test_bf16_stage3_meets_the_train_tolerances(port_runs, jax_runs):
    """bf16 stage 3 on 2 ranks against the JAX engine's bf16 stage 3 on
    the 2-device mesh (the same weights, batches and SGD step): the losses
    within 1e-2 and each leaf's change in the fp32 master within 5e-2 of
    JAX's, the bf16 card-vs-CPU train tolerances of chip_smoke
    (`TRAIN_LOSS_TOL`, `TRAIN_GRAD_REL_TOL`)."""
    out, ref = port_runs["bf16"], jax_runs["bf16"]
    assert ref["master"] is not None
    # both masters start from the bf16-rounded params
    init16 = [torch.from_numpy(np.array(x, np.float32)).bfloat16().float()
              .numpy() for x in jax.tree_util.tree_leaves(_PARAMS)]
    for r in range(W):
        np.testing.assert_allclose(out[r]["losses"], ref["losses"],
                                   atol=1e-2)
        leaves = tree_leaves(out[r]["state"]["master"])
        assert len(leaves) == len(ref["master"])
        for a, b, a16 in zip(leaves, ref["master"], init16):
            assert _rel(a - a16, b - a16) <= 5e-2
        # the fp32 master is sharded like the state
        assert out[r]["master_shapes"] is not None


# ----------------------------------------------------------------------
# CommStats bytes per step: the analytic count of each stage
# ----------------------------------------------------------------------


def _analytic(stage, plan, gas=2, n=W, acc=4, tied=True, lamb=True):
    """{op: (calls, bytes)} a step, from the leaves' shapes and dims.
    Stages 0-1: one all-reduce of the whole grads (fp32 accumulator at
    gas 2) and one of the loss; stage 1 one post-update all-gather of the
    compute-dtype state shards (JAX gathers the fp32 master there,
    test_comm_volume.py:114; at fp32 the two are the same bytes). Stage 2:
    a reduce-scatter of the sharded grads a micro-batch, one all-reduce of
    the shard leaves' squared norms, the loss's, and the post-update
    gather. LAMB adds two all-reduces of the state shards' squared leaf
    norms (the params' and the update's). Stage 3 (remat): a micro-batch
    gathers each top-level leaf
    where it is read (the tied wte twice: embedding and head) and each
    layer twice (forward and rematerialized forward; a leaf sharded on its
    layer dimension whole each time), and reduce-scatters the whole
    gradient of every forward gather once."""
    numel = [int(np.prod(p["shape"])) for p in plan]
    item = plan[0]["itemsize"]
    out = {}
    whole = [i for i, p in enumerate(plan) if p["gdim"] is None]
    ar_calls, ar_bytes = 1, 4                          # the loss
    if whole:
        ar_calls += 1
        ar_bytes += sum(numel[i] for i in whole) * acc
    sharded = [i for i, p in enumerate(plan) if p["gdim"] is not None]
    if sharded:
        ar_calls += 1
        ar_bytes += 4 * len(sharded)                   # squared norms
    state = [i for i, p in enumerate(plan) if p["sdim"] is not None]
    if lamb and state:
        # LAMB's trust ratio: the params' and the updates' leaf norms
        ar_calls += 2
        ar_bytes += 2 * 4 * len(state)
    out["all_reduce"] = (ar_calls, ar_bytes)
    gathered = [i for i, p in enumerate(plan)
                if p["pdim"] is None and p["sdim"] is not None]
    if stage == 2:
        out["reduce_scatter"] = (gas, gas * sum(numel[i] for i in sharded)
                                 * acc)
    if stage in (1, 2) or (stage == 3 and gathered):
        out["all_gather"] = (1, sum(numel[i] for i in gathered) // n * item)
    if stage == 3:
        # leaf order: blocks (sorted) first in the tree, then the top level
        names = sorted(_PARAMS)
        blocks = sorted(_PARAMS["blocks"])
        order = [("blocks", k) for k in blocks] + \
            [(None, k) for k in names if k != "blocks"]
        calls = bytes_ = rs_calls = rs_bytes = 0
        # a stacked leaf sharded on its layer dimension (JAX's choice where
        # the model's tensor-parallel spec names the others) is gathered
        # whole for each layer
        layer_bytes = sum((numel[i] if plan[i]["pdim"] == 0
                           else numel[i] // JCFG.n_layer) // n * item
                          for i, (grp, _) in enumerate(order)
                          if grp == "blocks" and plan[i]["pdim"] is not None)
        calls += 2 * JCFG.n_layer
        bytes_ += 2 * JCFG.n_layer * layer_bytes
        rs_calls += JCFG.n_layer
        rs_bytes += JCFG.n_layer * layer_bytes * n
        for i, (grp, k) in enumerate(order):
            if grp is None and plan[i]["pdim"] is not None:
                reads = 2 if (k == "wte" and tied) else 1
                calls += reads
                bytes_ += reads * numel[i] // n * item
                rs_calls += reads
                rs_bytes += reads * numel[i] * item
        ag_c, ag_b = out.get("all_gather", (0, 0))
        out["all_gather"] = (ag_c + gas * calls, ag_b + gas * bytes_)
        out["reduce_scatter"] = (gas * rs_calls, gas * rs_bytes)
    return out


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_comm_bytes_per_step_equal_the_stated_counts(port_runs, stage):
    out = port_runs[stage]
    plan = out[0]["leaves"]
    want = _analytic(stage, plan, tied=JCFG.tie_embeddings)
    for r in range(W):
        for snap in out[r]["stats"]:
            got = {op: (v["calls"], v["bytes"]) for op, v in snap.items()}
            assert got == want, (stage, r)
    P = sum(int(np.prod(p["shape"])) for p in plan)
    if stage == 3:
        # per micro-batch, the gathered (output) bytes within JAX's band
        # (test_comm_volume.py:96: [1.7, 2.2] x 2 P)
        gathered = want["all_gather"][1] / 2 * W
        assert 1.7 * P * 4 <= gathered <= 2.2 * P * 4
    if stage == 1:
        assert want["all_gather"][0] == 1        # one post-update gather
        assert 0.8 * 4 * P <= want["all_gather"][1] * W <= 1.1 * 4 * P


def test_memscope_plan_at_data_degree_2_equals_jax(port_runs, jax_runs):
    for stage in (0, 1, 2, 3):
        ref = jax_runs[stage]["plan"]
        for r in range(W):
            got = port_runs[stage][r]["plan"]
            assert got["device"] == dict(ref.device_bytes), stage
            assert got["host"] == dict(ref.host_bytes), stage


# ----------------------------------------------------------------------
# the branches every rank must take alike
# ----------------------------------------------------------------------


def _branch_config(stage, **over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 0},
           "mesh": {"data": W}, "steps_per_print": 10**9}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("stage", [2, 3])
def test_clip_and_fp16_skip_take_one_branch_on_every_rank(pool, stage):
    out = pool.run("deepspeed_tpu_torch.testing.dist:zero_branches",
                   _branch_config(stage, gradient_clipping=1.0),
                   [1.0, 1e3], 2)
    a, b = out
    for sa, sb in zip(a, b):
        assert sa["grad_norm"] == sb["grad_norm"] > 1.0     # clipped alike
        for x, y in zip(sa["params"], sb["params"]):
            np.testing.assert_array_equal(x, y)
    out = pool.run("deepspeed_tpu_torch.testing.dist:zero_branches",
                   _branch_config(stage, fp16={"enabled": True,
                                               "initial_scale_power": 8}),
                   [1.0, np.inf], 2)
    for ranks in zip(*out):
        assert all(s["overflow"] for s in ranks)            # skipped alike
        assert len({s["loss_scale"] for s in ranks}) == 1
        assert all(s["skipped"] == s["step"] + 1 for s in ranks)
    first = [s["params"] for s in out[0]]
    assert all(np.array_equal(x, y) for x, y in zip(first[0], first[1]))


def test_sentinel_raises_on_the_same_step_on_every_rank(pool):
    out = pool.run("deepspeed_tpu_torch.testing.dist:zero_branches",
                   _branch_config(2, fault_tolerance={
                       "enabled": True, "nonfinite_budget": 2}),
                   [1.0, 1.0], 4, nan_rank=1)
    ends = [o[-1] for o in out]
    assert ends[0] == ends[1]
    assert ends[0]["error"] == "BadStateError"
    assert ends[0]["step"] == 1


# ----------------------------------------------------------------------
# checkpoints across world sizes
# ----------------------------------------------------------------------


def test_checkpoint_resumes_bit_equal_and_crosses_world_sizes(pool,
                                                             tmp_path):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import zero_to_fp32
    from deepspeed_tpu_torch.models import gpt as tgpt
    batches = _batches() + _batches()[:1]
    save = str(tmp_path / "ckpt")
    full = pool.run("deepspeed_tpu_torch.testing.dist:zero_train",
                    _config(2), _PARAMS, _port_kwargs(JCFG), batches,
                    save_dir=save, save_after=1)
    resumed = pool.run("deepspeed_tpu_torch.testing.dist:zero_train",
                       _config(2), _PARAMS, _port_kwargs(JCFG),
                       batches[1:], load_dir=save)
    for r in range(W):
        assert resumed[r]["losses"] == full[r]["losses"][1:]
        for a, b in zip(tree_leaves(resumed[r]["state"]),
                        tree_leaves(full[r]["state"])):
            np.testing.assert_array_equal(a, b)
    # one rank (no process group here) loads the 2-rank checkpoint
    one = _config(2)
    one.update(mesh={"data": 1}, train_micro_batch_size_per_gpu=4)
    eng, *_ = initialize(model=tgpt.make_gpt_model(
        tgpt.GPTConfig(**_port_kwargs(JCFG)), name="tiny",
        params=tgpt.params_from_jax(_PARAMS)), config=one, device="cpu")
    path, client = eng.load_checkpoint(save)
    assert path is not None and client["global_steps"] == 1
    st = eng.state_to_numpy()
    saved = pool.run("deepspeed_tpu_torch.testing.dist:zero_train",
                     _config(2), _PARAMS, _port_kwargs(JCFG), [],
                     load_dir=save)[0]["state"]
    for a, b in zip(tree_leaves(st), tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)
    # zero_to_fp32 reads the rank-0 write as a one-rank checkpoint: the
    # gathered fp32 weights (the params: an fp32 engine keeps no master)
    fp32 = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(save)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[".".join(prefix + (k,))] = v
    walk(st["params"], ())
    assert sorted(fp32) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(fp32[k], v)


def test_save_gathers_leaf_by_leaf_and_a_failed_write_raises_everywhere(
        pool, port_runs, tmp_path):
    """A stage-3 save across ranks issues one all-gather a sharded leaf
    (params, then LAMB's two moments; an fp32 engine keeps no master), so
    the device holds one leaf's gather at a time. When rank 0's commit
    fails, every rank raises and none takes the directory for the
    rollback target; the next save commits on every rank."""
    save = str(tmp_path / "ckpt")
    out = pool.run("deepspeed_tpu_torch.testing.dist:zero_save_fault",
                   _config(3), _PARAMS, _port_kwargs(JCFG), _batches()[0],
                   save)
    plan = port_runs[3][0]["leaves"]
    want = sorted([int(np.prod(p["shape"])) // W for p in plan
                   if p["pdim"] is not None] +
                  [int(np.prod(p["shape"])) // W for p in plan
                   if p["sdim"] is not None] * 2)     # params, mu, nu
    failed, clean = zip(*out)
    assert failed[0]["error"].startswith("OSError: no space left")
    assert failed[1]["error"].startswith(
        "RuntimeError: checkpoint t: rank 0's save failed (OSError")
    for r in range(W):
        assert failed[r]["last_ckpt_dir"] is None
        assert sorted(failed[r]["gathers"]) == want
        assert clean[r]["error"] is None
        assert clean[r]["last_ckpt_dir"] == save
        assert sorted(clean[r]["gathers"]) == want
    from deepspeed_tpu_torch.checkpoint.saver import get_latest_tag
    assert get_latest_tag(save) == "t"
