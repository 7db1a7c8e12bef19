"""The PyTorch port's Mixture-of-Experts slice and its norm ops held to the
JAX package on the CPU, with the same numpy-seeded inputs and weights:

  * the token sort's plain version against `token_sort_oracle` and the
    Pallas kernel in interpret mode — bit-equal (int32 throughout);
  * top-1 / top-2 gating (dispatch, combine, l_aux, exp_counts) at
    capacities that do and do not overflow, and `gating_drop_stats`;
  * `dropless_moe`, `MoELayer` / `MoE` (einsum, dropless, residual):
    outputs and input / parameter gradients against `jax.grad`;
  * MoE-GPT: logits, the loss with its `moe/*` aux, every parameter
    gradient, a 3-step engine trajectory with the step metrics, and
    generate / ServingEngine tokens — identical;
  * `fused_layer_norm` / `fused_rms_norm`: plain versions against the
    Pallas kernels in interpret mode and their jnp math.

Everything is fp32 unless a case says bf16. Tolerances: fp32 outputs and
losses atol 1e-5, gradients rtol 1e-4 / atol 1e-5 (XLA and PyTorch's CPU
kernels sum in other orders); the engine trajectory as in
tests/test_torch_training.py (losses rtol 1e-4, parameters atol 2e-5).
Routing is an argmax: fp32 on both sides keeps every route identical on
these inputs, which the tests check first.

The JAX MoE code picks up a global mesh lazily; an earlier test file in the
same worker may leave an expert mesh behind, so every test starts with it
cleared and the comparison is with the one-rank einsum path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models import moe_gpt as jmoe_gpt
from deepspeed_tpu.ops.pallas import norms as jnorms
from deepspeed_tpu.ops.pallas import token_sort as jts
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu_torch import initialize, init_inference
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.models import moe_gpt as tmoe_gpt
from deepspeed_tpu_torch.models.gpt import params_from_jax
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.ops import norms as tnorms
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import token_sort as tts
from deepspeed_tpu_torch.parallel import moe as tmoe
from deepspeed_tpu_torch.utils.tree import tree_leaves

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_global_mesh():
    mesh_mod.clear_mesh()
    yield
    mesh_mod.clear_mesh()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tree_close(port_tree, jax_tree, **tol):
    want = jax.tree_util.tree_leaves(jax_tree)
    got = tree_leaves(port_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w),
                                   **tol)


# ----------------------------------------------------------------------
# token sort (K10)
# ----------------------------------------------------------------------


def _ids(case):
    rng = np.random.default_rng(3)
    if case == "all_equal":
        return np.full(40, 3, np.int32), 8
    if case == "out_of_range":
        ids = rng.integers(-3, 9, 77).astype(np.int32)  # E = 6: -3..8
        return ids, 6
    if case == "int64":
        return rng.integers(0, 8, 70).astype(np.int64), 8
    n, e = case
    return rng.integers(0, e, n).astype(np.int32), e


@pytest.mark.parametrize("case", [(64, 4), (256, 8), (128, 16), (96, 5),
                                  (65, 8), "all_equal", "out_of_range",
                                  "int64"], ids=str)
def test_token_sort_bit_equal_to_oracle_and_pallas(case):
    """The (n, e) pairs of tests/test_moe.py, an odd N, every id equal, ids
    out of range and negative, int64 ids: the port's plain version equals
    the jnp oracle and the Pallas kernel in interpret mode bit for bit."""
    ids, E = _ids(case)
    jids = jnp.asarray(ids.astype(np.int32))
    want_pos, want_counts = jts.token_sort_oracle(jids, E)
    pallas_pos, pallas_counts = jts.token_sort(jids, E, interpret=True)
    op_builder.LAUNCHES.clear()
    pos, counts = tts.token_sort(_t(ids), E)
    assert sum(op_builder.LAUNCHES.values()) == 0
    assert pos.dtype == counts.dtype == torch.int32
    for got, want in ((pos, want_pos), (pos, pallas_pos),
                      (counts, want_counts), (counts, pallas_counts)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    valid = (ids >= 0) & (ids < E)
    assert int(counts.sum()) == int(valid.sum())
    assert (pos.numpy()[~valid] == 0).all()
    pairs = set(zip(ids[valid].tolist(), pos.numpy()[valid].tolist()))
    assert len(pairs) == int(valid.sum())


# ----------------------------------------------------------------------
# gating
# ----------------------------------------------------------------------


@pytest.mark.parametrize("k,used_mask", [(1, False), (1, True), (2, False)],
                         ids=["top1", "top1_used_token_mask", "top2"])
@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["overflow", "fits"])
def test_gating_matches_jax(k, cf, used_mask):
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(64, 4)).astype(np.float32)
    mask = (rng.random(64) > 0.25).astype(np.float32)
    if k == 1:
        kw = dict(used_token_mask=mask) if used_mask else {}
        want = jmoe.top1_gating(jnp.asarray(logits), cf, 4, **{
            n: jnp.asarray(v) for n, v in kw.items()})
        got = tmoe.top1_gating(_t(logits), cf, 4, **{
            n: _t(v) for n, v in kw.items()})
    else:
        want = jmoe.top2_gating(jnp.asarray(logits), cf, 4)
        got = tmoe.top2_gating(_t(logits), cf, 4)
    l_aux, dispatch, combine, counts = got
    assert dispatch.dtype == torch.bool
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(combine.numpy(), np.asarray(want[2]),
                               atol=1e-6)
    np.testing.assert_allclose(float(l_aux), float(want[0]), atol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[3]))
    stats = tmoe.gating_drop_stats(dispatch, counts)
    jstats = jmoe.gating_drop_stats(want[1], want[3])
    for key in ("routed", "kept", "overflow_tokens", "dropped_frac"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]),
                                   atol=1e-6)
    assert (float(stats["overflow_tokens"]) > 0) == (cf < 1)
    assert tmoe._capacity(64, 4, cf * k, 4) == dispatch.shape[-1]


@pytest.mark.parametrize("k", [1, 2])
def test_gating_noise_comes_from_the_generator(k):
    """RSample (top-1) and the second-expert jitter (top-2) draw from an
    explicit torch.Generator: the same seed routes alike, and every token
    still takes at most one slot per chosen expert."""
    logits = _t(np.random.default_rng(2).normal(size=(48, 4)).astype(
        np.float32) * 1e-3)       # near ties, so the noise decides routes

    def gate(seed):
        g = torch.Generator().manual_seed(seed)
        if k == 1:
            return tmoe.top1_gating(logits, 4.0, 4, "RSample", g)
        return tmoe.top2_gating(logits, 4.0, 4, g)

    a, b, c = gate(0), gate(0), gate(1)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    slots_per_token = a[1].sum(dim=(1, 2))
    assert int(slots_per_token.max()) == k
    if k == 2:   # the jittered second choice is never the first
        assert int(a[1].any(dim=-1).sum(dim=-1).min()) == 2


# ----------------------------------------------------------------------
# dropless MoE and the MoE layer
# ----------------------------------------------------------------------


def test_dropless_moe_matches_jax_with_grads():
    rng = np.random.default_rng(4)
    N, D, F_, E = 64, 16, 32, 4
    arrays = {"flat": rng.normal(size=(N, D)), "gate_w": rng.normal(size=(D, E)),
              "wi": rng.normal(0, 0.1, (E, D, F_)),
              "wo": rng.normal(0, 0.1, (E, F_, D))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    cot = rng.normal(size=(N, D)).astype(np.float32)

    def jloss(a):
        def ffn(xe):
            h = jax.nn.gelu(jnp.einsum("end,edf->enf", xe, a["wi"]))
            return jnp.einsum("enf,efd->end", h, a["wo"])
        out, l_aux, counts = jmoe.dropless_moe(a["flat"], a["gate_w"], ffn, E)
        return jnp.sum(out * cot) + 0.1 * l_aux, (out, l_aux, counts)

    (jl, (jout, jaux, jcounts)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(_jnp(arrays))
    t = {k: _t(v).requires_grad_(True) for k, v in arrays.items()}
    op_builder.LAUNCHES.clear()
    out, l_aux, counts = tmoe.dropless_moe(
        t["flat"], t["gate_w"],
        lambda xe: tmoe._gelu(xe @ t["wi"]) @ t["wo"], E)
    loss = (out * _t(cot)).sum() + 0.1 * l_aux
    grads = torch.autograd.grad(loss, list(t.values()))
    assert sum(op_builder.LAUNCHES.values()) == 0
    assert int(counts.sum()) == N
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(float(l_aux), float(jaux), atol=1e-6)
    for g, name in zip(grads, t):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                   **GRAD_TOL)


_LAYERS = {
    "einsum_top1": dict(k=1, capacity_factor=1.0),
    "einsum_top2": dict(k=2, capacity_factor=1.0),
    "einsum_top1_residual": dict(k=1, capacity_factor=1.0, use_residual=True),
    "dropless": dict(dropless=True),
    "dropless_residual": dict(dropless=True, use_residual=True),
}


@pytest.mark.parametrize("name", list(_LAYERS))
def test_moe_layer_matches_jax_with_grads(name):
    """Outputs, l_aux, exp_counts and the gradients of a scalar of the
    output with respect to x and every parameter. The layer's init draws
    the JAX package's numbers from the same seed."""
    kw = _LAYERS[name]
    jlayer = jmoe.MoELayer(num_experts=4, **kw)
    tlayer = tmoe.MoELayer(num_experts=4, **kw)
    jparams = _np(jlayer.init_params(16, 32, seed=5))
    tparams = tlayer.init_params(16, 32, seed=5)
    _assert_tree_close(tparams, jparams, rtol=0, atol=0)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, l_aux, counts = jlayer(p, x)
        return jnp.sum(y * cot) + 0.01 * l_aux, (y, l_aux, counts)

    (_, (jy, jaux, jcounts)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(_jnp(jparams), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    tx = _t(x).requires_grad_(True)
    y, l_aux, counts = tlayer(tp, tx)
    loss = (y * _t(cot)).sum() + 0.01 * l_aux
    grads = torch.autograd.grad(loss, [tx] + tree_leaves(tp))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(l_aux), float(jaux), atol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrads[1]),
                               **GRAD_TOL)
    for g, w in zip(grads[1:], jax.tree_util.tree_leaves(jgrads[0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("drop_tokens", [True, False])
def test_moe_api_wrapper_matches_jax(drop_tokens):
    """The reference-signature `MoE` (deepspeed.moe.layer.MoE)."""
    kw = dict(hidden_size=16, num_experts=4, k=1, capacity_factor=1.0,
              drop_tokens=drop_tokens)
    jm, tm = jmoe.MoE(**kw), MoE(**kw)
    assert tm.layer.dropless == (not drop_tokens)
    jp = _np(jm.init_params(d_ff=32, seed=1))
    tp = tm.init_params(d_ff=32, seed=1)
    x = np.random.default_rng(2).normal(size=(2, 12, 16)).astype(np.float32)
    jy, jaux, jc = jm(_jnp(jp), jnp.asarray(x))
    y, l_aux, c = tm(tp, _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(l_aux), float(jaux), atol=1e-6)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


# ----------------------------------------------------------------------
# MoE-GPT
# ----------------------------------------------------------------------


def _jax_cfg(**over):
    kw = dict(n_layer=2, n_head=4, d_model=64, d_ff=128, max_seq_len=64,
              vocab_size=256, dtype=jnp.float32, remat=False, num_experts=4,
              moe_freq=2)
    kw.update(over)
    return jmoe_gpt.MoEGPTConfig(**kw)


def _port_cfg(jcfg):
    names = [f.name for f in dataclasses.fields(tmoe_gpt.MoEGPTConfig)
             if f.name != "dtype"]
    return tmoe_gpt.MoEGPTConfig(
        **{n: getattr(jcfg, n) for n in names}, dtype="float32")


def _tokens(seed, B, T, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)) \
        .astype(np.int32)


def test_init_and_params_from_jax_carry_the_moe_tree():
    """`init_moe_gpt_params` draws the JAX package's numbers from the same
    seed, and `params_from_jax` carries the `moe` subtree leaf for leaf."""
    jcfg = _jax_cfg(n_layer=4)
    jparams = _np(jmoe_gpt.init_moe_gpt_params(jcfg, seed=3))
    moved = params_from_jax(jparams)
    drawn = tmoe_gpt.init_moe_gpt_params(_port_cfg(jcfg), seed=3)
    assert sorted(moved["moe"]) == sorted(drawn["moe"]) == ["1", "3"]
    assert sorted(moved["moe"]["1"]) == ["b_down", "b_up", "gate_w",
                                         "w_down", "w_up"]
    assert tuple(moved["moe"]["3"]["w_up"].shape) == (4, 64, 128)
    _assert_tree_close(moved, jparams, rtol=0, atol=0)
    _assert_tree_close(drawn, jparams, rtol=0, atol=0)


@pytest.mark.parametrize("cf", [1.0, 4.0], ids=["overflow", "fits"])
def test_moe_gpt_loss_aux_and_grads_match_jax(cf):
    """`moe_gpt_loss` under `torch.autograd.grad` against
    `jax.value_and_grad(moe_gpt_loss, has_aux=True)`: the loss, every aux
    entry and every parameter's gradient (the unused dense MLP leaves of
    the MoE block get zeros on both sides)."""
    jcfg = _jax_cfg(capacity_factor=cf)
    np_params = _np(jmoe_gpt.init_moe_gpt_params(jcfg, seed=1))
    toks = _tokens(2, 4, 33)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jmoe_gpt.moe_gpt_loss(p, {"tokens": jnp.asarray(toks)},
                                        None, jcfg), has_aux=True)(
        _jnp(np_params))
    params = params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = tmoe_gpt.moe_gpt_loss(params, {"tokens": _t(toks)},
                                      cfg=_port_cfg(jcfg))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    assert sorted(aux) == sorted(jaux)
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   atol=1e-5)
    assert (float(aux["moe/overflow_tokens"]) > 0) == (cf < 2)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    unused = grads[[i for i, leaf in enumerate(leaves)
                    if leaf is params["blocks"]["mlp_up_w"]][0]]
    assert float(unused[1].abs().max()) == 0 < float(unused[0].abs().max())


@pytest.mark.parametrize("training", [True, False])
def test_moe_gpt_forward_matches_jax_logits(training):
    """Training routing (capacity) and inference routing (capacity-free)."""
    jcfg = _jax_cfg()
    np_params = _np(jmoe_gpt.init_moe_gpt_params(jcfg, seed=3))
    toks = _tokens(4, 2, 24)
    jlogits, jaux = jmoe_gpt.moe_gpt_forward(_jnp(np_params),
                                             jnp.asarray(toks), jcfg,
                                             training=training)
    logits, l_aux = tmoe_gpt.moe_gpt_forward(params_from_jax(np_params),
                                             _t(toks), _port_cfg(jcfg),
                                             training=training)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4)
    np.testing.assert_allclose(float(l_aux), float(jaux), atol=1e-5)


def _engine_config(mbs):
    return {"train_micro_batch_size_per_gpu": mbs,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": 1},
            "steps_per_print": 10**9}


def test_engine_trajectory_and_moe_metrics_match_jax_engine():
    """Three train_batch steps at gas 2 from the same params and batches.
    The JAX engine spans conftest's 8 virtual CPU devices on a data-only
    mesh (no expert axis: the one-rank einsum routing over the global
    micro-batch); the port takes micro-batch 8 — the same micro-batches. The
    `moe/*` step metrics (the micro-batches' mean) match too."""
    jcfg = _jax_cfg()
    jspec = jmoe_gpt.make_moe_gpt_model(jcfg, name="moe-tiny", seed=7)
    np_params = _np(jspec.params)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jspec, config={**_engine_config(1), "mesh": {"data": 8}})
    teng, *_ = initialize(
        model=tmoe_gpt.make_moe_gpt_model(_port_cfg(jcfg), name="moe-tiny",
                                          params=params_from_jax(np_params)),
        config=_engine_config(8), device="cpu")
    assert teng.train_batch_size() == jeng.train_batch_size() == 16
    keys = ("moe/aux_loss", "moe/overflow_tokens", "moe/dropped_frac")
    jl, tl = [], []
    for i in range(3):
        batch = {"tokens": _tokens(10 + i, 16, 33)}
        jl.append(float(jeng.train_batch(batch)))
        tl.append(float(teng.train_batch(batch)))
        for key in keys:
            np.testing.assert_allclose(float(teng._last_metrics[key]),
                                       float(jeng._last_metrics[key]),
                                       rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert float(teng._last_metrics["moe/aux_loss"]) > 0
    assert 0 <= float(teng._last_metrics["moe/dropped_frac"]) <= 1
    st = teng.state_to_numpy()
    assert int(st["step"]) == int(jeng.state.step) == 3
    for a, b in zip(tree_leaves(st["params"]),
                    jax.tree_util.tree_leaves(jeng.state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

SERVE_CFG = jmoe_gpt.MoEGPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=128,
                                  max_seq_len=256, vocab_size=256,
                                  dtype=jnp.float32, remat=False,
                                  num_experts=4, moe_freq=2,
                                  eval_capacity_factor=2.0)
CONF = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
        "kv_block_size": 16, "max_out_tokens": 64}


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_generate_and_serving_tokens_identical_to_jax(tied):
    """tests/test_moe.py's SERVE_CFG (a tied head), and the same config
    with an untied head, whose greedy rollouts wander: the port's
    generate() and ServingEngine against the JAX package's, token for
    token, over a ragged trace with chunked prefill."""
    jcfg = dataclasses.replace(SERVE_CFG, tie_embeddings=tied)
    jspec = jmoe_gpt.make_moe_gpt_decode_model(cfg=jcfg, name="moe-tiny")
    je = jax_init(model=jspec, config=dict(CONF))
    te = init_inference(tmoe_gpt.make_moe_gpt_decode_model(
        _port_cfg(jcfg), params=params_from_jax(_np(jspec.params)),
        name="moe-tiny"), config=dict(CONF), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 11, 3, 17, 8)]
    np.testing.assert_array_equal(
        te.generate(prompts[:4], max_new_tokens=8, stop_on_eos=False),
        je.generate(prompts[:4], max_new_tokens=8, stop_on_eos=False))
    kw = dict(max_slots=3, max_context=64, prefill_chunk=16)
    budget = lambda i: 3 + i % 4
    jres = je.serving(**kw).run([JaxRequest(uid=i, tokens=p,
                                            max_new_tokens=budget(i),
                                            stop_on_eos=False)
                                 for i, p in enumerate(prompts)])
    serving = te.serving(**kw)
    tres = serving.run([Request(uid=i, tokens=p, max_new_tokens=budget(i),
                                stop_on_eos=False)
                        for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(tres[i].tokens, jres[i].tokens)
        ref = te.generate(p[None], max_new_tokens=budget(i),
                          stop_on_eos=False)
        np.testing.assert_array_equal(tres[i].tokens, ref[0])
    assert serving.allocator.num_free == serving.allocator.capacity
    if not tied:
        assert len(set(tres[3].tokens.tolist())) > 2, "rollout should wander"


# ----------------------------------------------------------------------
# norms (K9)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["no_residual", "residual"])
@pytest.mark.parametrize("op", ["layer", "rms"])
def test_norms_plain_versions_match_pallas_and_jnp(op, residual, dtype):
    """Each op's plain version against the Pallas kernel in interpret mode
    and against its jnp math (residual added first in x's dtype, fp32
    statistics). fp32: atol 1e-5. bf16: one bf16 step at the output's
    largest magnitude (2^-7 x max|ref|), since the fp32 statistics differ
    only in summation order and the output is rounded to bf16 once."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 24, 96)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32) if residual else None
    scale = (1 + 0.1 * rng.normal(size=96)).astype(np.float32)
    bias = (0.1 * rng.normal(size=96)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jarr(a):
        return None if a is None else jnp.asarray(a, jdt)

    def tarr(a):
        return None if a is None else _t(a).to(tdt)

    jr = jarr(r)
    if op == "layer":
        pallas = jnorms.fused_layer_norm(jarr(x), jnp.asarray(scale),
                                         jnp.asarray(bias), 1e-5, jr,
                                         interpret=True)
        s = jarr(x) if r is None else jarr(x) + jr
        sf = s.astype(jnp.float32)
        mu = sf.mean(-1, keepdims=True)
        var = jnp.square(sf - mu).mean(-1, keepdims=True)
        math = ((sf - mu) * jax.lax.rsqrt(var + 1e-5) * scale + bias)
        op_builder.LAUNCHES.clear()
        got = tnorms.fused_layer_norm(tarr(x), _t(scale), _t(bias), 1e-5,
                                      tarr(r))
    else:
        pallas = jnorms.fused_rms_norm(jarr(x), jnp.asarray(scale), 1e-5, jr,
                                       interpret=True)
        s = jarr(x) if r is None else jarr(x) + jr
        sf = s.astype(jnp.float32)
        math = sf * jax.lax.rsqrt(jnp.mean(jnp.square(sf), -1,
                                           keepdims=True) + 1e-5) * scale
        op_builder.LAUNCHES.clear()
        got = tnorms.fused_rms_norm(tarr(x), _t(scale), 1e-5, tarr(r))
    assert sum(op_builder.LAUNCHES.values()) == 0
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    got = got.float().numpy()
    for want in (np.asarray(pallas.astype(jnp.float32)),
                 np.asarray(math.astype(jdt).astype(jnp.float32))):
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
