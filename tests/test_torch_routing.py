"""The port's GPT training remainder held to the JAX package: the
parallel residual on the training, contiguous-decode and paged-decode
paths, dropout (accepted, never applied, in both packages), the schedules
of progressive layer drop, random-LTD and the seqlen curriculum, the
engine's routing directives (byte-equal leaves from one seed), the model
under those directives, and 3-step engine trajectories under each of them
and under `loss_chunks`.

fp32 on the CPU; inputs and weights from numpy seeds (weights moved with
`params_from_jax`). Tolerances: logits 1e-4 (as tests/test_torch_gpt.py);
losses and gradients 1e-5; trajectories 1e-5 on the losses. The JAX engine
spans conftest's 8 virtual CPU devices (micro-batch 1 each); the port, at
one rank, takes micro-batch 8: the same global micro-batches, and the same
directives, which both engines draw over the whole batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime.data_pipeline import curriculum as jcur
from deepspeed_tpu.runtime.data_pipeline import random_ltd as jltd
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum as tcur
from deepspeed_tpu_torch.runtime.data_pipeline import random_ltd as tltd
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.utils.tree import tree_leaves

ATOL = 1e-4


def _mesh():
    mesh_mod.clear_mesh()
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _jcfg(**flags):
    flags.setdefault("remat", False)
    return jgpt.GPTConfig(n_layer=4, n_head=4, d_model=64, max_seq_len=64,
                          vocab_size=256, dtype=jnp.float32, **flags)


def _pcfg(jcfg, **over):
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    kw = {n: getattr(jcfg, n) for n in names}
    kw.update(dtype="float32", **over)
    return tgpt.GPTConfig(**kw)


def _np_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt.init_gpt_params(jcfg, seed=seed))


def _tokens(seed, B, T):
    return np.random.default_rng(seed).integers(0, 256, (B, T)) \
        .astype(np.int32)


# ----------------------------------------------------------------------
# the parallel residual and dropout
# ----------------------------------------------------------------------


PARALLEL = {"neox": dict(parallel_residual=True, use_rotary=True,
                         rotary_pct=0.25),
            "gptj_untied": dict(parallel_residual=True, use_rotary=True,
                                tie_embeddings=False),
            "gpt2": dict(parallel_residual=True)}


@pytest.mark.parametrize("arch", sorted(PARALLEL))
def test_parallel_residual_training_logits_match_jax(arch):
    _mesh()
    jcfg = _jcfg(**PARALLEL[arch])
    np_params = _np_params(jcfg, seed=1)
    toks = _tokens(2, 2, 24)
    jlog = jgpt.gpt_forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                            jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tlog = tgpt.gpt_forward(tgpt.params_from_jax(np_params),
                                torch.from_numpy(toks), _pcfg(jcfg))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    # the flag changes the model: the sequential residual differs
    with torch.no_grad():
        seq = tgpt.gpt_forward(tgpt.params_from_jax(np_params),
                               torch.from_numpy(toks),
                               _pcfg(jcfg, parallel_residual=False))
    assert np.abs(seq.numpy() - np.asarray(jlog)).max() > 100 * ATOL
    mesh_mod.clear_mesh()


@pytest.mark.parametrize("arch", sorted(PARALLEL))
def test_parallel_residual_decode_logits_match_jax(arch):
    """Prefill and three greedy decode steps over the contiguous cache,
    then two prefill chunks and two decode steps over the paged pool
    (shuffled table, a trash-only inactive row)."""
    _mesh()
    jcfg = _jcfg(**PARALLEL[arch])
    jspec = jgpt.make_gpt_decode_model(cfg=jcfg, name="tiny", seed=0)
    tspec = tgpt.make_gpt_decode_model(
        cfg=_pcfg(jcfg), name="tiny", params=tgpt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jspec.params)))
    toks = _tokens(3, 2, 13)
    jcache = jspec.init_cache(2, 32, jnp.float32)
    tcache = tspec.init_cache(2, 32, torch.float32)
    jl, jcache = jspec.prefill_fn(jspec.params, jnp.asarray(toks), jcache,
                                  None)
    with torch.inference_mode():
        tl, tcache = tspec.prefill_fn(tspec.params, torch.from_numpy(toks),
                                      tcache, None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    pos = np.full((2,), 13, np.int32)
    for _ in range(3):
        jl, jcache = jspec.decode_fn(jspec.params, jnp.asarray(tok),
                                     jnp.asarray(pos), jcache)
        with torch.inference_mode():
            tl, tcache = tspec.decode_fn(tspec.params, torch.from_numpy(tok),
                                         torch.from_numpy(pos).long(),
                                         tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok, pos = np.array(jnp.argmax(jl, -1), np.int32), pos + 1

    bs, C = 8, 8
    prompt = toks[0]
    tables = np.asarray([[4, 7, 2], [0, 0, 0]], np.int32)
    jpool = jspec.init_paged_pool(10, bs, jnp.float32)
    tpool = tspec.init_paged_pool(10, bs, torch.float32)
    for start in (0, C):
        chunk = np.zeros((1, C), np.int32)
        seg = prompt[start:start + C]
        chunk[0, :len(seg)] = seg
        last = np.asarray([min(len(prompt) - 1 - start, C - 1)], np.int32)
        jl, jpool = jspec.prefill_paged_fn(
            jspec.params, jnp.asarray(chunk), jnp.asarray([start]),
            jnp.asarray(last), jpool, jnp.asarray(tables[:1]))
        with torch.inference_mode():
            tl, tpool = tspec.prefill_paged_fn(
                tspec.params, torch.from_numpy(chunk).long(),
                torch.tensor([start]), torch.from_numpy(last).long(), tpool,
                torch.from_numpy(tables[:1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    tok = np.asarray([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)
    pos = np.asarray([len(prompt), 0], np.int32)
    for _ in range(2):
        jl, jpool = jspec.decode_paged_fn(jspec.params, jnp.asarray(tok),
                                          jnp.asarray(pos), jpool,
                                          jnp.asarray(tables))
        with torch.inference_mode():
            tl, tpool = tspec.decode_paged_fn(
                tspec.params, torch.from_numpy(tok),
                torch.from_numpy(pos).long(), tpool,
                torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=ATOL, rtol=0)
        tok = np.asarray([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)
        pos = pos + np.asarray([1, 0], np.int32)
    mesh_mod.clear_mesh()


def test_dropout_is_accepted_and_never_applied_in_both_packages():
    """The JAX GPTConfig carries `dropout` and no block reads it: a config
    with 0.1 gives the same loss as one with 0.0, there and in the port."""
    _mesh()
    toks = _tokens(4, 2, 17)
    losses = {}
    for p in (0.0, 0.1):
        jcfg = _jcfg(dropout=p)
        np_params = _np_params(jcfg, seed=2)
        losses["jax", p] = float(jgpt.gpt_loss(
            jax.tree_util.tree_map(jnp.asarray, np_params),
            {"tokens": jnp.asarray(toks)}, jax.random.PRNGKey(p > 0), jcfg))
        with torch.no_grad():
            losses["port", p] = float(tgpt.gpt_loss(
                tgpt.params_from_jax(np_params),
                {"tokens": torch.from_numpy(toks)}, cfg=_pcfg(jcfg)))
    assert losses["jax", 0.1] == losses["jax", 0.0]
    assert losses["port", 0.1] == losses["port", 0.0]
    assert losses["port", 0.1] == pytest.approx(losses["jax", 0.1], abs=1e-5)
    mesh_mod.clear_mesh()


# ----------------------------------------------------------------------
# the schedules
# ----------------------------------------------------------------------


@pytest.mark.parametrize("theta,gamma", [(0.5, 0.001), (0.5, 1.0),
                                         (0.2, 0.05)])
def test_progressive_layer_drop_theta_matches_jax(theta, gamma):
    a, b = tpld.ProgressiveLayerDrop(theta, gamma), \
        jpld.ProgressiveLayerDrop(theta, gamma)
    assert a.get_theta() == b.get_theta() == 1.0
    for step in (0, 1, 2, 7, 100, 10**5):
        a.update_state(step)
        b.update_state(step)
        assert a.get_theta() == b.get_theta()
        assert a.get_state() == b.get_state()


@pytest.mark.parametrize("kw", [
    dict(total_layers=24, start_ratio=0.5, end_ratio=1.0, total_steps=10),
    dict(total_layers=4, start_ratio=128, end_ratio=512, total_steps=3,
         bucket=64),
    dict(total_layers=6, start_ratio=0.3, end_ratio=0.9, total_steps=1,
         ltd_start_layer=2, ltd_end_layer=3, bucket=8),
], ids=["ratio", "absolute", "bucket-8"])
def test_random_ltd_keep_count_matches_jax(kw):
    a, b = tltd.RandomLTDScheduler(**kw), jltd.RandomLTDScheduler(**kw)
    assert (a.start_layer, a.end_layer) == (b.start_layer, b.end_layer)
    for step in (0, 1, 2, 3, 5, 10, 50):
        assert a.keep_ratio(step) == b.keep_ratio(step)
        for T in (32, 100, 512, 4096):
            assert a.keep_count(step, T) == b.keep_count(step, T)


@pytest.mark.parametrize("config", [
    dict(curriculum_type="fixed_linear", min_difficulty=128,
         max_difficulty=512, schedule_config=dict(total_curriculum_step=2,
                                                  difficulty_step=8)),
    dict(curriculum_type="fixed_root", min_difficulty=8, max_difficulty=1024,
         schedule_config=dict(total_curriculum_step=7, difficulty_step=16,
                              root_degree=3)),
    dict(curriculum_type="fixed_discrete", min_difficulty=16,
         schedule_config=dict(difficulty=[32, 64], max_step=[2, 4])),
    dict(schedule_type="fixed_linear", total_step=5),
], ids=["linear", "root", "discrete", "legacy-keys"])
def test_curriculum_difficulty_matches_jax(config):
    a, b = tcur.CurriculumScheduler(config), jcur.CurriculumScheduler(config)
    for step in range(10):
        assert a.update_difficulty(step) == b.update_difficulty(step)
        assert a.get_difficulty() == b.get_difficulty()


@pytest.mark.parametrize("difficulty", [4, 16, 32, 33, 40])
@pytest.mark.parametrize("form", ["tokens", "input_ids+labels",
                                  "bucketized"])
def test_apply_seqlen_curriculum_matches_jax(form, difficulty):
    toks = _tokens(5, 3, 33)
    if form == "input_ids+labels":
        batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    else:
        batch = {"tokens": toks}
    kw = dict(bucketize=(8, 16, 24)) if form == "bucketized" else {}
    a = tcur.apply_seqlen_curriculum(dict(batch), difficulty, **kw)
    b = jcur.apply_seqlen_curriculum(dict(batch), difficulty, **kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_the_curriculum_cut_keeps_tensors_on_their_device():
    toks = torch.from_numpy(_tokens(6, 2, 33))
    out = tcur.apply_seqlen_curriculum({"tokens": toks}, 16,
                                       bucketize=(16,))
    assert isinstance(out["tokens"], torch.Tensor)
    assert torch.equal(out["tokens"], toks[:, :16])


# ----------------------------------------------------------------------
# the model under the directives
# ----------------------------------------------------------------------


def _directive_batch(seed, B, T, n_layer, keep, ltd_start, ltd_k):
    rng = np.random.default_rng(seed)
    batch = {"tokens": _tokens(seed, B, T + 1)}
    if keep is not None:
        batch["pld_keep_idx"] = np.broadcast_to(
            np.asarray(keep, np.int32)[None], (B, len(keep))).copy()
        batch["pld_theta"] = np.full((B,), 0.625, np.float32)
    if ltd_k is not None:
        n_ltd = n_layer - 1 - ltd_start
        r = rng.random((B, n_ltd, T))
        batch["ltd_keep_idx"] = np.sort(
            np.argpartition(r, ltd_k - 1, axis=-1)[..., :ltd_k],
            axis=-1).astype(np.int32)
        batch["ltd_start"] = np.zeros((B, ltd_start), np.int8)
    return batch


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("directive", ["pld", "ltd", "ltd-from-0"])
def test_gpt_loss_under_directives_matches_jax(directive, remat):
    """`gpt_loss` with the engine's leaves in the batch: PLD keeps layers
    0, 2 and 3 at theta 0.625; random-LTD runs 8 of 16 positions a row
    in layers [1, 3) (or [0, 3)); rotary, so the subset's true positions
    matter. Loss and every gradient against JAX's, within 1e-5."""
    _mesh()
    jcfg = _jcfg(remat=remat, use_rotary=True)
    np_params = _np_params(jcfg, seed=3)
    batch = _directive_batch(
        7, 3, 16, 4, keep=[0, 2, 3] if directive == "pld" else None,
        ltd_start=0 if directive == "ltd-from-0" else 1,
        ltd_k=8 if directive != "pld" else None)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, None,
                                jcfg))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = tgpt.params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = tgpt.gpt_loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg=_pcfg(jcfg))
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    mesh_mod.clear_mesh()


def test_directives_refuse_what_jax_asserts():
    cfg = _pcfg(_jcfg())
    params = tgpt.init_gpt_params(cfg, seed=0)
    tokens = torch.zeros((2, 16), dtype=torch.int64)
    keep = torch.arange(8).expand(2, 1, 8)
    with pytest.raises(ValueError, match="random-LTD"):
        tgpt.gpt_hidden(params, tokens, cfg, pld=([0, 1], 0.5),
                        ltd=(1, keep))
    with pytest.raises(ValueError, match="attn_fn"):
        tgpt.gpt_hidden(params, tokens, cfg, ltd=(1, keep),
                        attn_fn=lambda q, k, v: q)


def test_random_ltd_scatter_is_out_of_place_under_remat():
    """The kept rows go back by an out-of-place scatter: the embedding the
    checkpoint saved is never written, and the dropped rows pass a routed
    layer unchanged."""
    cfg = _pcfg(_jcfg(remat=True))
    params = tgpt.init_gpt_params(cfg, seed=1)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.from_numpy(_tokens(8, 2, 16)).long()
    keep = torch.arange(0, 16, 2).expand(2, 3, 8).contiguous()
    seen = []
    block = tgpt._block

    def spy(x, p, cfg_, positions, attn_fn=None):
        seen.append((x.shape[1], positions[0].tolist()))
        return block(x, p, cfg_, positions, attn_fn)
    tgpt._block = spy
    try:
        x = tgpt.gpt_hidden(params, tokens, cfg, ltd=(1, keep))
        x.sum().backward()
    finally:
        tgpt._block = block
    # forward: layer 0 at T 16, layers 1-3 at K 8 on the even positions;
    # the backward replays each block (remat) the same way
    want = [(16, list(range(16)))] + [(8, list(range(0, 16, 2)))] * 3
    assert seen[:4] == want
    assert sorted(seen[4:]) == sorted(want)


# ----------------------------------------------------------------------
# the engine: directives and trajectories against the JAX engine
# ----------------------------------------------------------------------

PLD = {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                  "gamma": 1.0}}
LTD = {"data_efficiency": {"enabled": True, "data_routing": {"random_ltd": {
    "enabled": True, "total_layer_num": 4, "random_ltd_layer_id": [1, 2],
    "random_ltd_schedule": {"min_value": 0.5, "max_value": 1.0,
                            "schedule_config": {"require_steps": 4,
                                                "seq_per_step": 8}}}}}}
CURRICULUM = {"data_efficiency": {"enabled": True, "data_sampling": {
    "curriculum_learning": {"enabled": True, "curriculum_type":
                            "fixed_linear", "min_difficulty": 8,
                            "max_difficulty": 32,
                            "schedule_config": {"total_curriculum_step": 2,
                                                "difficulty_step": 8}}}}}


CURRICULUM_LTD = {"data_efficiency": {**CURRICULUM["data_efficiency"],
                                     **LTD["data_efficiency"]}}


def _engine_config(mbs, extra):
    return {"train_micro_batch_size_per_gpu": mbs,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "zero_optimization": {"stage": 1}, "seed": 1234, **extra}


def _engines(extra, **flags):
    mesh_mod.clear_mesh()
    jcfg = _jcfg(remat=True, **flags)
    jspec = jgpt.make_gpt_model(cfg=jcfg, name="tiny", seed=9)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jspec, config={**_engine_config(1, extra),
                             "mesh": {"data": 8}})
    teng, *_ = initialize(
        model=tgpt.make_gpt_model(_pcfg(jcfg), name="tiny",
                                  params=tgpt.params_from_jax(np_params)),
        config=_engine_config(8, extra), device="cpu")
    return jeng, teng


def test_routing_directives_are_byte_equal_to_the_jax_engines():
    """Both engines with PLD and random-LTD on, three steps from one seed:
    every leaf the port adds equals JAX's in dtype, shape and bytes."""
    jeng, teng = _engines({**PLD, **LTD})
    for step in range(3):
        batch = {"tokens": _tokens(30 + step, 16, 33)}
        a = teng._inject_routing_directives(dict(batch))
        b = jeng._inject_routing_directives(dict(batch))
        assert a.keys() == b.keys() == {"tokens", "pld_keep_idx",
                                        "pld_theta", "ltd_keep_idx",
                                        "ltd_start"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
        teng.global_steps += 1
        jeng.global_steps += 1
    mesh_mod.clear_mesh()


def test_curriculum_then_random_ltd_batches_are_byte_equal_to_jax():
    """The curriculum with random-LTD on, three steps from one seed: the
    port's step batch (`_data_efficiency`) equals the JAX engine's
    (`apply_seqlen_curriculum` at its difficulty, then its directives)
    leaf for leaf: the labels masked past the difficulty and the keep
    counts and positions drawn over the whole width, as JAX draws them."""
    from deepspeed_tpu.runtime.data_pipeline.curriculum import \
        apply_seqlen_curriculum
    jeng, teng = _engines(CURRICULUM_LTD)
    for step in range(3):
        batch = {"tokens": _tokens(30 + step, 16, 33)}
        a = teng._data_efficiency(dict(batch))
        b = jeng._inject_routing_directives(apply_seqlen_curriculum(
            dict(batch), jeng.curriculum_scheduler.update_difficulty(
                jeng.global_steps)))
        assert a.keys() == b.keys() == {"tokens", "labels", "ltd_keep_idx",
                                        "ltd_start"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
        assert a["labels"].shape[1] == 32
        teng.global_steps += 1
        jeng.global_steps += 1
    mesh_mod.clear_mesh()


@pytest.mark.parametrize("name,extra,flags", [
    ("pld", PLD, {}), ("random_ltd", LTD, dict(use_rotary=True)),
    ("curriculum", CURRICULUM, {}), ("loss_chunks", {}, dict(loss_chunks=3)),
    ("curriculum_random_ltd", CURRICULUM_LTD, {}),
], ids=["pld", "random_ltd", "curriculum", "loss_chunks",
        "curriculum_random_ltd"])
def test_three_step_trajectory_matches_the_jax_engine(name, extra, flags):
    """Three train_batch steps from the same params and batches (gas 2,
    clipping, AdamW): the losses within 1e-5 of the JAX engine's, the
    parameters within 1e-4 (Adam's update is normalised: an element whose
    gradient is near 0 turns the fp32 sum-order differences of the two
    backends into a move of up to lr a step). PLD
    drops layers from the second step on (theta 0.68, 0.57); random-LTD
    keeps 16, then 16, then 24 of 32 positions in layers 1-2; the
    curriculum runs difficulties 8, 16 and 32 (alone, the port cuts the
    batch where JAX masks its labels; with random-LTD both mask)."""
    jeng, teng = _engines(extra, **flags)
    batches = [{"tokens": _tokens(40 + i, 16, 33)} for i in range(3)]
    jl = [float(jeng.train_batch(b)) for b in batches]
    tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    if name == "pld":
        assert teng.progressive_layer_drop.get_theta() == \
            jeng.progressive_layer_drop.get_theta() < 1.0
    if name == "curriculum":
        assert teng.curriculum_scheduler.current_difficulty == \
            jeng.curriculum_scheduler.current_difficulty == 32
    st = teng.state_to_numpy()
    for a, b in zip(tree_leaves(st["params"]),
                    jax.tree_util.tree_leaves(jeng.state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    mesh_mod.clear_mesh()


@pytest.mark.parametrize("extra,match", [
    ({"data_efficiency": {"enabled": True, "data_routing": {"random_ltd": {
        "enabled": True}}}}, "total_layer_num"),
    ({"data_efficiency": {"enabled": True, "data_routing": {"random_ltd": {
        "enabled": True, "total_layer_num": 4,
        "random_ltd_layer_id": [1, 3]}}}}, "contiguous"),
    ({"data_efficiency": {"enabled": True, "data_routing": {"random_ltd": {
        "enabled": True, "total_layer_num": 6}}}}, "n_layer"),
], ids=["no-layer-count", "gapped-layers", "wrong-depth"])
def test_random_ltd_config_refuses_what_the_jax_engine_asserts(extra, match):
    cfg = _pcfg(_jcfg())
    with pytest.raises(ValueError, match=match):
        initialize(model=tgpt.make_gpt_model(cfg, name="tiny"),
                   config=_engine_config(2, extra), device="cpu")


def test_routing_needs_a_model_that_reads_the_directives():
    with pytest.raises(ValueError, match="arch_cfg"):
        initialize(model=lambda p, b: (p["w"] ** 2).sum(),
                   model_parameters={"w": torch.ones(3)},
                   config=_engine_config(2, PLD), device="cpu")
