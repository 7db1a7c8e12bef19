"""The port's training engine on a `sequence` mesh held to the JAX engine:
2 and 4 gloo ranks against the JAX engine on a 2- and a 4-device mesh
(fp32, remat on, ZeRO stage 1, gas 2, 2 steps; losses and every leaf's
‖Δ‖/‖ref‖ within 1e-5). `{"sequence": 2}` through the `ring` backend with
labels < 0 in one sequence shard only (the loss is the global mean, not a
mean of shard means) and through an external `DistributedAttention`
(rotary, GQA); `{"data": 2, "sequence": 2}` through `ring_ulysses` with
`loss_chunks` 2; progressive layer drop with the seqlen curriculum. The
batch-triad repair: `train_batch_size()` and each rank's rows and token
range equal the JAX engine's placement. Port stages 0, 2 and 3 at
`{"sequence": 2}` against the JAX stage-1 run (on the CPU mesh the JAX
reference stays at stage <= 1, and in fp32 the stage changes no number).
A `{"sequence": 2}` checkpoint resumes bit-equal and loads at one rank;
the memscope plan equals JAX's planner's. What stays refused raises: the
ZeRO++ wires, random-LTD, a model whose loss takes no sequence shards."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as jmesh
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel.ulysses import DistributedAttention as JDA
from deepspeed_tpu.telemetry import memscope as jmemscope
from deepspeed_tpu_torch.testing.dist import RankPool
from deepspeed_tpu_torch.utils.tree import tree_leaves

TRAIN = "deepspeed_tpu_torch.testing.dist:sequence_train"
SEQ = 17
BASE = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=256,
                      max_seq_len=64, vocab_size=512, dtype=jnp.float32,
                      remat=True)
RING = dataclasses.replace(BASE, attention_backend="ring")
ROTARY_GQA = dataclasses.replace(BASE, use_rotary=True, n_kv_head=2)
RING_ULYSSES = dataclasses.replace(BASE, attention_backend="ring_ulysses",
                                   loss_chunks=2)
PLD = {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                  "gamma": 1.0},
       "data_efficiency": {"enabled": True, "data_sampling": {
           "curriculum_learning": {
               "enabled": True, "curriculum_type": "fixed_linear",
               "min_difficulty": 8, "max_difficulty": 16,
               "schedule_config": {"total_curriculum_step": 2,
                                   "difficulty_step": 8}}}}}


def _port_kwargs(jcfg):
    from deepspeed_tpu_torch.models import gpt as tgpt
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    return {**{n: getattr(jcfg, n) for n in names}, "dtype": "float32"}


def _params(jcfg):
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt.init_gpt_params(jcfg, seed=3))


def _config(mesh, stage=1, **over):
    # SGD: its update is the gradient's, so each leaf's change holds the
    # grads to the reference. An adaptive update divides near-zero
    # gradients by their own roundoff: LAMB puts lnf_bias 2.5e-5 from
    # JAX's after two steps on these batches at one rank already
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "SGD", "params": {"lr": 1e-1}},
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": 0},
            "mesh": {"data": 1, **mesh}, "steps_per_print": 10**9, **over}


def _batches(dp, ignore=False, n=2):
    """`n` global batches of 4 x dp rows: the `tokens` [B, T+1] form, or
    with `ignore` the input_ids / labels form whose labels < 0 lie in the
    first sequence shard only (most of its positions, every row)."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 512, (4 * dp, SEQ)).astype(np.int32)
        if not ignore:
            out.append({"tokens": toks})
            continue
        labels = toks[:, 1:].copy()
        labels[:, :6] = -100
        out.append({"input_ids": toks[:, :-1].copy(), "labels": labels})
    return out


def _jax_attn(q, k, v):
    """Plain causal attention over global [B, T, H, hd] arrays: the local
    attention of the JAX DistributedAttention reference."""
    T = q.shape[1]
    s = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(q.shape[-1])
    s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -1e30)
    return jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(s, axis=-1), v)


def _jax_run(jcfg, config, batches, attn_fn=None):
    jmesh.clear_mesh()
    spec = jgpt.make_gpt_model(cfg=dataclasses.replace(jcfg, remat=False),
                               name="tiny", seed=3, attn_fn=attn_fn)
    eng, *_ = deepspeed_tpu.initialize(model=spec, config=config)
    out = {"triad": (eng.train_batch_size(),
                     eng.train_micro_batch_size_per_gpu(),
                     eng.gradient_accumulation_steps()),
           "placement": _jax_placement(eng, batches[0]),
           "losses": [float(eng.train_batch(b)) for b in batches],
           "params": [np.asarray(x, np.float32) for x in
                      jax.tree_util.tree_leaves(eng.state.params)],
           "plan": jmemscope.plan_training_from_engine(eng)}
    jmesh.clear_mesh()
    return out


def _jax_placement(eng, batch):
    """Each JAX device's (rows, tokens) of every micro-batch's inputs: the
    engine's batch sharding for the rows, the model's (batch, sequence)
    activation sharding for the token range (`gpt_hidden`'s constraint)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    placed = eng._maybe_split_gas(batch)
    key = "tokens" if "tokens" in placed else "input_ids"
    arr = placed[key]
    T = arr.shape[-1] - (1 if key == "tokens" else 0)
    rows = {d: idx[1] for d, idx in
            arr.sharding.devices_indices_map(arr.shape).items()}
    tok = NamedSharding(eng.mesh, P(jmesh.BATCH_AXES, jmesh.SEQ_AXIS))
    toks = {d: idx[1] for d, idx in
            tok.devices_indices_map((arr.shape[1], T)).items()}
    devices = list(eng.mesh.devices.flat)
    return [(rows[d], toks[d]) for d in devices]


@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    with RankPool(2, tmp_path_factory.mktemp("seq2")) as p:
        yield p


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("seq4")) as p:
        yield p


@pytest.fixture(scope="module")
def runs(pool2, pool4):
    """(port runs, JAX runs) by case: the port's start on the ranks first
    and run while the JAX references compile here."""
    seq2, dseq = {"sequence": 2}, {"data": 2, "sequence": 2}
    ign = _batches(1, ignore=True)
    cases = {
        "ring": (pool2, RING, _config(seq2), ign, None),
        "ulysses": (pool2, ROTARY_GQA, _config(seq2), _batches(1),
                    "ulysses"),
        "ring_ulysses": (pool4, RING_ULYSSES, _config(dseq), _batches(2),
                         None),
        "pld": (pool2, RING, _config(seq2, **PLD), _batches(1), None)}
    pending = {name: pool.submit(TRAIN, config, _params(jcfg),
                                 _port_kwargs(jcfg), batches, attn=attn)
               for name, (pool, jcfg, config, batches, attn)
               in cases.items()}
    for stage in (0, 2, 3):
        pending[f"stage{stage}"] = pool2.submit(
            TRAIN, _config(seq2, stage=stage), _params(RING),
            _port_kwargs(RING), ign)
    jax_out = {name: _jax_run(jcfg, config, batches,
                              JDA(_jax_attn) if attn else None)
               for name, (_, jcfg, config, batches, attn) in cases.items()}
    return {k: result() for k, result in pending.items()}, jax_out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_matches(out, ref, init):
    """Losses, and each leaf and each leaf's change from `init` within
    1e-5 of JAX's (relative, in norm)."""
    for r, rank in enumerate(out):
        np.testing.assert_allclose(rank["losses"], ref["losses"],
                                   rtol=1e-5, err_msg=f"rank {r}")
        leaves = tree_leaves(rank["state"]["params"])
        assert len(leaves) == len(ref["params"])
        for a, b, a0 in zip(leaves, ref["params"],
                            jax.tree_util.tree_leaves(init)):
            assert a.shape == b.shape
            assert _rel(a, b) <= 1e-5, r
            assert _rel(a - a0, b - a0) <= 1e-5, r
        assert int(rank["state"]["step"]) == len(ref["losses"])


@pytest.mark.parametrize("case", ["ring", "ulysses", "ring_ulysses", "pld"])
def test_engine_on_a_sequence_mesh_matches_jax(runs, case):
    """ring (labels < 0 in one shard), DistributedAttention (rotary, GQA),
    ring_ulysses on data 2 x sequence 2 (loss_chunks 2), PLD with the
    seqlen curriculum: losses and every leaf within 1e-5 of JAX's."""
    port, ref = runs
    jcfg = {"ulysses": ROTARY_GQA, "ring_ulysses": RING_ULYSSES}.get(case,
                                                                    RING)
    _assert_matches(port[case], ref[case], _params(jcfg))
    if case != "ring_ulysses":
        assert port[case][0]["spec"]["sequence"] == 2


def test_ignored_labels_in_one_shard_take_the_global_mean(runs):
    """The first shard's labels are mostly < 0: a mean of the two shards'
    means is another number than the global mean, which both engines
    report."""
    port, ref = runs
    b = _batches(1, ignore=True)[0]
    labels = b["labels"][:2]
    assert (labels[:, :8] < 0).sum() > 0 and (labels[:, 8:] < 0).sum() == 0
    np.testing.assert_allclose(port["ring"][0]["losses"][0],
                               ref["ring"]["losses"][0], rtol=1e-6)


@pytest.mark.parametrize("stage", [0, 2, 3])
def test_port_stages_match_the_jax_stage1_run(runs, stage):
    port, ref = runs
    _assert_matches(port[f"stage{stage}"], ref["ring"], _params(RING))


def test_batch_triad_and_placement_equal_jax_at_data2_sequence2(runs):
    """The repair: the triad resolves over data x zero (not x sequence),
    and rank r (JAX's device r) trains the rows of its data index and the
    token range of its sequence index of every micro-batch, the
    [B, T+1] tokens shifted into inputs and labels first."""
    port, ref = runs
    out, jref = port["ring_ulysses"], ref["ring_ulysses"]
    b = _batches(2)[0]["tokens"]
    gas = jref["triad"][2]
    micro = b.reshape(gas, -1, SEQ)
    for r, rank in enumerate(out):
        share = rank["shares"]
        assert tuple(share["triad"]) == jref["triad"] == (8, 2, 2)
        rows, toks = jref["placement"][r]
        assert len(share["micros"]) == gas
        for i, m in enumerate(share["micros"]):
            np.testing.assert_array_equal(m["input_ids"],
                                          micro[i][rows, :-1][:, toks])
            np.testing.assert_array_equal(m["labels"],
                                          micro[i][rows, 1:][:, toks])
        assert rank["dp"][0] == 2


def test_memscope_plan_equals_jax_at_sequence_degree_2(runs):
    port, ref = runs
    for case in ("ring", "ring_ulysses"):
        want = ref[case]["plan"]
        for rank in port[case]:
            assert rank["plan"]["device"] == dict(want.device_bytes), case
            assert rank["plan"]["host"] == dict(want.host_bytes), case


def test_sequence_checkpoint_resumes_bit_equal_and_loads_at_one_rank(
        pool2, tmp_path):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import gpt as tgpt
    batches = _batches(1, n=3)
    save = str(tmp_path / "ckpt")
    args = (_config({"sequence": 2}, stage=2), _params(RING),
            _port_kwargs(RING))
    full = pool2.run(TRAIN, *args, batches, save_dir=save, save_after=1)
    resumed = pool2.run(TRAIN, *args, batches[1:], load_dir=save)
    for r in range(2):
        assert resumed[r]["losses"] == full[r]["losses"][1:]
        for a, b in zip(tree_leaves(resumed[r]["state"]),
                        tree_leaves(full[r]["state"])):
            np.testing.assert_array_equal(a, b)
    # one rank (no process group here) loads it: the saved state, whole
    saved = pool2.run(TRAIN, *args, [], load_dir=save)[0]["state"]
    one = _config({}, stage=2)
    eng, *_ = initialize(model=tgpt.make_gpt_model(
        tgpt.GPTConfig(**_port_kwargs(BASE)), name="tiny",
        params=tgpt.params_from_jax(_params(BASE))), config=one,
        device="cpu")
    path, client = eng.load_checkpoint(save)
    assert path is not None and client["global_steps"] == 1
    for a, b in zip(tree_leaves(eng.state_to_numpy()), tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)


REFUSED = {
    "explicit_grad_reduce": ({"zero_optimization": {
        "stage": 2, "explicit_grad_reduce": True}}, "data-domain-only"),
    "qgZ": ({"zero_optimization": {
        "stage": 2, "zero_quantized_gradients": True}}, "pure data"),
    "random_ltd": ({"data_efficiency": {"enabled": True, "data_routing": {
        "random_ltd": {"enabled": True, "total_layer_num": 2,
                       "random_ltd_layer_id": [1],
                       "random_ltd_schedule": {
                           "min_value": 8, "max_value": 16,
                           "schedule_config": {"require_steps": 4,
                                               "seq_per_step": 8}}}}}},
                   "item 8"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_what_jax_refuses_on_a_sequence_mesh_raises(pool2, what):
    """The ZeRO++ wires raise as JAX's engine does (`engine.py:843`,
    `:921`); random-LTD names item 8 (its token subsets span the whole
    sequence)."""
    over, match = REFUSED[what]
    cfg = _config({"sequence": 2})
    cfg.update(over)
    if "zero_optimization" in over:
        cfg["zero_optimization"] = {**over["zero_optimization"],
                                    "stage3_param_persistence_threshold": 0}
    with pytest.raises(RuntimeError, match=match):
        pool2.run(TRAIN, cfg, _params(RING), _port_kwargs(RING),
                  _batches(1, n=1))


def test_a_model_without_sequence_shards_is_refused(pool2):
    with pytest.raises(RuntimeError, match="sequence_parallel"):
        pool2.run("deepspeed_tpu_torch.testing.dist:zero_branches",
                  {"train_micro_batch_size_per_gpu": 2,
                   "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
                   "mesh": {"data": 1, "sequence": 2}}, [1.0, 1.0], 1)
