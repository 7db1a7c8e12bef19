"""The PyTorch port's BERT encoder, its DeepSpeedTransformerLayer frontend
and the dispatch's encoder site, held to the JAX package's `models/bert.py`
and `ops/transformer.py`: the same numpy-seeded weights and inputs (moved
leaf by leaf with `params_from_jax`), fp32 on the CPU.

Tolerances (fp32 on both sides; XLA and PyTorch's CPU kernels sum in other
orders): sequence outputs and logits atol 1e-5; the loss atol 1e-5; every
gradient rtol 1e-4 / atol 1e-5; the 3-step engine trajectory rtol 1e-4 on
the losses and atol 2e-5 on the final parameters. Weights drawn from one
seed are equal bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops import transformer as jtr
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.gpt import params_from_jax
from deepspeed_tpu_torch.ops import attention_dispatch as ad
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import transformer as ttr
from deepspeed_tpu_torch.utils.tree import tree_leaves

ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(n_layer=2, n_head=4, d_model=64, d_ff=128, max_seq_len=64,
            vocab_size=512)


def _one_device_mesh():
    mesh_mod.clear_mesh()
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _cfgs(pre_layer_norm=False, remat=False, use_flash=None):
    jcfg = jbert.BertConfig(**TINY, dtype=jnp.float32, remat=remat,
                            pre_layer_norm=pre_layer_norm)
    tcfg = tbert.BertConfig(**TINY, dtype="float32", remat=remat,
                            pre_layer_norm=pre_layer_norm,
                            use_flash_attention=use_flash)
    return jcfg, tcfg


def _np_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jbert.init_bert_params(jcfg, seed=seed))


def _batch(seed, B=3, T=16, masked=True, vocab=512):
    """ids, token types, a ragged 0/1 mask (rows of 16, 10 and 3 keys) and
    MLM labels (-100 = unmasked)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    batch = {"input_ids": ids,
             "token_type_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
             "labels": np.where(rng.random((B, T)) < 0.3, ids, -100)
             .astype(np.int32)}
    batch["labels"][:, 0] = ids[:, 0]            # at least one label a row
    if masked:
        am = np.ones((B, T), np.int32)
        for row, n in enumerate((T, 10, 3)[:B]):
            am[row, n:] = 0
        batch["attention_mask"] = am
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _Spy:
    """Counts the calls of the two kernel wrappers the encoder site routes
    to (their CPU plain versions launch nothing to count)."""

    def __init__(self, monkeypatch):
        self.calls = {"flash": 0, "block_sparse": 0}
        for name, attr in (("flash", "flash_attention"),
                           ("block_sparse", "key_padded_attention")):
            fn = getattr(tbert, attr)
            monkeypatch.setattr(tbert, attr, self._wrap(name, fn))

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return call


def test_init_bert_params_matches_jax_leaf_by_leaf():
    jcfg, tcfg = _cfgs()
    jp, tp = _np_params(jcfg, seed=5), tbert.init_bert_params(tcfg, seed=5)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = tree_leaves(tp)
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert tuple(b.shape) == a.shape, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))


@pytest.mark.parametrize("use_flash", [None, True],
                         ids=["dense", "kernel-wrappers"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "ragged"])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["post-ln", "pre-ln"])
def test_bert_encode_matches_jax(pre_ln, masked, use_flash, monkeypatch):
    """bert_encode with token types, with and without a ragged key-padding
    mask, pre- and post-LN; on the CPU through the dense program and
    through the kernels' wrappers (flash without a mask, block-sparse with
    one), which run their plain versions."""
    _one_device_mesh()
    jcfg, tcfg = _cfgs(pre_ln, use_flash=use_flash)
    np_params = _np_params(jcfg, seed=1)
    batch = _batch(2, masked=masked)
    spy = _Spy(monkeypatch)
    want = jbert.bert_encode(jax.tree_util.tree_map(jnp.asarray, np_params),
                             jnp.asarray(batch["input_ids"]), jcfg,
                             token_type_ids=jnp.asarray(
                                 batch["token_type_ids"]),
                             attention_mask=jnp.asarray(
                                 batch["attention_mask"]) if masked else None)
    tb = _torch(batch)
    got = tbert.bert_encode(params_from_jax(np_params), tb["input_ids"], tcfg,
                            token_type_ids=tb["token_type_ids"],
                            attention_mask=tb.get("attention_mask"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    routed = {"flash": 0, "block_sparse": 0}
    if use_flash:
        routed["block_sparse" if masked else "flash"] = TINY["n_layer"]
    assert spy.calls == routed


@pytest.mark.parametrize("use_flash", [None, True],
                         ids=["dense", "kernel-wrappers"])
@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "ragged"])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["post-ln", "pre-ln"])
def test_bert_mlm_loss_and_grads_match_jax(pre_ln, masked, remat, use_flash):
    """bert_mlm_loss (logits tied to word_emb plus mlm_bias, -100 ignored)
    and every parameter's gradient against jax.value_and_grad."""
    _one_device_mesh()
    jcfg, tcfg = _cfgs(pre_ln, remat=remat, use_flash=use_flash)
    np_params = _np_params(jcfg, seed=3)
    batch = _batch(4, masked=masked)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbert.bert_mlm_loss(p, _jax(batch), None, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    op_builder.LAUNCHES.clear()
    loss = tbert.bert_mlm_loss(params, _torch(batch), cfg=tcfg)
    # the pooler takes no part in the MLM loss: its gradients are zeros
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert sum(op_builder.LAUNCHES.values()) == 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_bert_mlm_logits_and_pooled_match_jax():
    _one_device_mesh()
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, seed=6)
    batch = _batch(7)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jseq = jbert.bert_encode(jp, jnp.asarray(batch["input_ids"]), jcfg,
                             attention_mask=jnp.asarray(
                                 batch["attention_mask"]))
    tp = params_from_jax(np_params)
    tseq = tbert.bert_encode(tp, torch.from_numpy(batch["input_ids"]), tcfg,
                             attention_mask=torch.from_numpy(
                                 batch["attention_mask"]))
    np.testing.assert_allclose(
        tbert.bert_mlm_logits(tp, tseq, tcfg).numpy(),
        np.asarray(jbert.bert_mlm_logits(jp, jseq, jcfg)), atol=ATOL)
    np.testing.assert_allclose(tbert.bert_pooled(tp, tseq).numpy(),
                               np.asarray(jbert.bert_pooled(jp, jseq)),
                               atol=ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "ragged"])
def test_bert_cls_loss_and_grads_match_jax(masked):
    """make_bert_model(task="cls"): the head drawn from seed + 1 as in
    JAX, the loss and every gradient."""
    _one_device_mesh()
    jcfg, tcfg = _cfgs()
    jspec = jbert.make_bert_model(cfg=jcfg, name="tiny", seed=2, task="cls",
                                  num_classes=3)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    tspec = tbert.make_bert_model(cfg=tcfg, name="tiny", seed=2, task="cls",
                                  num_classes=3)
    for a, b in zip(jax.tree_util.tree_leaves(np_params),
                    tree_leaves(tspec.params)):
        np.testing.assert_array_equal(b.numpy(), a)
    batch = _batch(8, masked=masked)
    batch["labels"] = np.array([0, 2, 1], np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jspec.loss_fn(p, _jax(batch), None))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = tspec.loss_fn(params, _torch(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_bert_engine_trajectory_matches_jax_engine():
    """Three train_batch steps of make_bert_model's MLM spec (remat on),
    AdamW, gas 2, a ragged mask: the JAX engine over conftest's 8 virtual
    CPU devices at micro-batch 1 each, the port at one rank with
    micro-batch 8 — the same global micro-batches."""
    mesh_mod.clear_mesh()
    jcfg, tcfg = _cfgs(remat=True)
    jspec = jbert.make_bert_model(cfg=jcfg, name="tiny", seed=9)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    config = {"gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 3e-3, "weight_decay": 0.1}},
              "steps_per_print": 10**9}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jspec, config={**config, "train_micro_batch_size_per_gpu": 1,
                             "mesh": {"data": 8}})
    teng, *_ = initialize(
        model=tbert.make_bert_model(cfg=tcfg, name="tiny",
                                    params=params_from_jax(np_params)),
        config={**config, "train_micro_batch_size_per_gpu": 8},
        device="cpu")
    assert teng.train_batch_size() == jeng.train_batch_size() == 16
    batches = []
    for i in range(3):
        b = _batch(20 + i, B=16, masked=False)
        lens = np.random.default_rng(i).integers(4, 17, 16)
        b["attention_mask"] = (np.arange(16)[None] < lens[:, None]) \
            .astype(np.int32)
        batches.append(b)
    jl = [float(jeng.train_batch(b)) for b in batches]
    tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    st = teng.state_to_numpy()
    for a, b in zip(tree_leaves(st["params"]),
                    jax.tree_util.tree_leaves(jeng.state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)
    mesh_mod.clear_mesh()


def test_all_padded_row_takes_the_mean_of_v_in_both_packages():
    """A query row whose keys are all padded (an all-zero mask row) sees
    equal scores everywhere in JAX (NEG_INF is finite) and takes the mean
    of V over all T keys; the port's dense program and the block-sparse
    kernel's plain version (an all-ones layout, T 64 = one 64 x 64 tile,
    so every key is visited) give the same. A deliberate divergence past
    this point is recorded in ROADMAP.md queue 3."""
    _one_device_mesh()
    jcfg, _ = _cfgs()
    np_params = _np_params(jcfg, seed=4)
    ids = np.random.default_rng(1).integers(0, 512, (2, 64)).astype(np.int32)
    am = np.ones((2, 64), np.int32)
    am[1] = 0
    want = np.asarray(jbert.bert_encode(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(ids),
        jcfg, attention_mask=jnp.asarray(am)))
    for use_flash in (None, True):
        _, tcfg = _cfgs(use_flash=use_flash)
        got = tbert.bert_encode(params_from_jax(np_params),
                                torch.from_numpy(ids), tcfg,
                                attention_mask=torch.from_numpy(am))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # one block's attention on its own: the padded row is V's mean
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    bias = torch.full((1, 1, 1, 64), tbert.NEG_INF)
    for use_flash in (None, True):
        _, tcfg = _cfgs(use_flash=use_flash)
        out = tbert._attention(q, k, v, bias, tcfg)
        np.testing.assert_allclose(
            out.numpy(), v.mean(1, keepdim=True).expand_as(out).numpy(),
            atol=1e-6)


# ----------------------------------------------------------------------
# DeepSpeedTransformerLayer
# ----------------------------------------------------------------------


def _layer_cfgs(pre=True, **kw):
    base = dict(hidden_size=64, heads=4, intermediate_size=256,
                num_hidden_layers=2, bf16=False, pre_layer_norm=pre, seed=3,
                **kw)
    return (jtr.DeepSpeedTransformerConfig(**base),
            ttr.DeepSpeedTransformerConfig(**base))


@pytest.mark.parametrize("layer_id", [0, 5])
@pytest.mark.parametrize("adjust", [True, False])
def test_transformer_layer_init_matches_jax(layer_id, adjust):
    """The seeded init (seed + layer_id, the sqrt(2L) output adjustment)
    gives the JAX layer's weights; the module's parameters carry the JAX
    leaf names."""
    jc, tc = _layer_cfgs(adjust_init_range=adjust)
    jl = jtr.DeepSpeedTransformerLayer(jc, layer_id=layer_id)
    tl = ttr.DeepSpeedTransformerLayer(tc, layer_id=layer_id)
    assert list(tl.params) == list(jl.params)
    assert [n for n, _ in tl.named_parameters()] == list(jl.params)
    for name, a in jl.params.items():
        np.testing.assert_array_equal(tl.params[name].detach().numpy(),
                                      np.asarray(a), err_msg=name)


def test_transformer_layer_counter_is_process_global():
    """layer_id None takes the class counter; an explicit id moves it past
    itself, so a later default layer never repeats an explicit one."""
    ttr.DeepSpeedTransformerLayer._layer_id = 0
    # the config records the id of the layer built last, as in JAX
    ids = []
    for explicit in (None, None, 7, None):
        _, tc = _layer_cfgs()
        ttr.DeepSpeedTransformerLayer(tc, layer_id=explicit)
        ids.append(tc.layer_id)
    assert ids == [0, 1, 7, 8]


def _eight_entry_weights(D=64, F=256):
    rng = np.random.default_rng(1)
    ws = [rng.normal(0, 0.02, s).astype(np.float32) for s in
          [(D, D)] * 4 + [(D,)] + [(F, D), (D, F)] + [(D,)]]
    bs = [np.zeros(D, np.float32)] * 3 + [
        rng.normal(0, 0.02, s).astype(np.float32)
        for s in [(D,), (D,), (F,), (D,), (D,)]]
    return ws, bs


@pytest.mark.parametrize("pre", [True, False], ids=["pre-ln", "post-ln"])
def test_transformer_layer_eight_entry_weights_match_jax(pre):
    """The reference's 8-entry initial_weights / initial_biases land where
    the JAX layer puts them, for either residual placement; torch tensors
    are taken as numpy arrays are."""
    jc, tc = _layer_cfgs(pre)
    ws, bs = _eight_entry_weights()
    jl = jtr.DeepSpeedTransformerLayer(jc, initial_weights=ws,
                                       initial_biases=bs, layer_id=0)
    tl = ttr.DeepSpeedTransformerLayer(
        tc, initial_weights=[torch.from_numpy(w) for w in ws],
        initial_biases=bs, layer_id=0)
    for name, a in jl.params.items():
        np.testing.assert_array_equal(tl.params[name].detach().numpy(),
                                      np.asarray(a), err_msg=name)
    with pytest.raises(ValueError, match="8-entry"):
        ttr.DeepSpeedTransformerLayer(tc, initial_weights=ws[:7],
                                      initial_biases=bs)


@pytest.mark.parametrize("mask_form", ["none", "2d", "4d"])
@pytest.mark.parametrize("pre", [True, False], ids=["pre-ln", "post-ln"])
def test_transformer_layer_forward_and_grads_match_jax(pre, mask_form):
    """forward with no mask, a [B, T] 0/1 mask or its additive [B, 1, 1,
    T] form, against the JAX layer; the gradients of the parameters and
    of the input against jax.grad."""
    jc, tc = _layer_cfgs(pre)
    jl = jtr.DeepSpeedTransformerLayer(jc, layer_id=2)
    tl = ttr.DeepSpeedTransformerLayer(tc, layer_id=2)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 16, 64)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    m = {"none": None, "2d": mask,
         "4d": np.where(mask[:, None, None, :] != 0, 0.0, -1e30)
         .astype(np.float32)}[mask_form]
    g = rng.normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, xx):
        out = jl(xx, None if m is None else jnp.asarray(m), params=p)
        return jnp.sum(out * g)

    (jgp, jgx) = jax.grad(jloss, argnums=(0, 1))(jl.params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tl(xt, None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jl(x, None if m is None
                                             else jnp.asarray(m))),
                               atol=ATOL)
    names = list(tl.params)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [tl.params[n] for n in names] + [xt])
    for name, gr in zip(names, grads):
        np.testing.assert_allclose(gr.numpy(), np.asarray(jgp[name]),
                                   err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **GRAD_TOL)


def test_transformer_layer_return_tuple_params_and_config():
    """return_tuple wraps the output; `params=` replaces the layer's own;
    from_dict re-derives intermediate_size; dropout is accepted and never
    applied."""
    _, tc = _layer_cfgs(return_tuple=True)
    layer = ttr.DeepSpeedTransformerLayer(tc, layer_id=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 8, 64)).astype(np.float32))
    out = layer(x)
    assert isinstance(out, tuple) and len(out) == 1
    other = ttr.DeepSpeedTransformerLayer(tc, layer_id=1)
    torch.testing.assert_close(layer(x, params=other.params)[0], other(x)[0])
    c2 = ttr.DeepSpeedTransformerConfig.from_dict({"hidden_size": 128})
    assert c2.intermediate_size == 512
    drop = ttr.DeepSpeedTransformerConfig(
        hidden_size=64, heads=4, intermediate_size=256, bf16=False,
        attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1)
    a = ttr.DeepSpeedTransformerLayer(drop, layer_id=0)
    torch.testing.assert_close(a(x), a(x))
    assert ttr.DeepSpeedTransformerLayer(drop, layer_id=0).params[
        "attn_qkv_w"].dtype == torch.float32


# ----------------------------------------------------------------------
# the encoder site on CUDA
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,head_dim,masked,T,want", [
    ("bfloat16", 64, False, 128, "flash"),
    ("float16", 128, False, 512, "flash"),
    ("bfloat16", 64, False, 100, "flash"),
    ("bfloat16", 64, True, 128, "block_sparse"),
    ("float16", 128, True, 512, "block_sparse"),
    ("bfloat16", 64, True, 112, "block_sparse"),
    ("float32", 64, False, 128, None),
    ("float32", 64, True, 128, None),
    ("bfloat16", 32, False, 128, None),
    ("bfloat16", 32, True, 128, None),
    ("bfloat16", 64, True, 100, "block_sparse"),
], ids=lambda x: str(x))
def test_encoder_dispatch_on_cuda_takes_the_kernels_or_raises(
        dtype, head_dim, masked, T, want):
    """A CUDA encoder site: no mask -> flash (rows 1-3, causal=False); a
    key-padding mask -> block_sparse (rows 15-17); fp32 or hd 32 raise —
    never the dense program. A masked T that is not a multiple of 16 names
    block_sparse, whose plan refuses it (`dense_plan`, held below)."""
    site = ad.AttnSite(phase="encoder", q_len=T, kv_len=T, head_dim=head_dim,
                       kv_dtype=dtype, on_cuda=True, key_padding=masked)
    if want is None:
        with pytest.raises(NotImplementedError, match="no plain attention"):
            ad.select(site)
    else:
        assert ad.select(site) == want


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_dispatch_cpu_and_forbidden_kernels(masked):
    """CPU operands take the dense program; use_flash_attention=True routes
    them through the kernels' wrappers; use_flash_attention=False on CUDA
    raises; a masked T the block-sparse kernels cannot tile raises from
    their plan, before any device is touched (so on CUDA as on the CPU),
    and through a forced bert_encode; the train phase never sees a mask."""
    site = lambda **kw: ad.AttnSite(**{**dict(
        phase="encoder", q_len=64, kv_len=64, head_dim=64,
        kv_dtype="float32", key_padding=masked), **kw})
    assert ad.select(site()) == "dense"
    assert ad.select(site(force_flash=True)) == (
        "block_sparse" if masked else "flash")
    with pytest.raises(NotImplementedError, match="no plain attention"):
        ad.select(site(on_cuda=True, kv_dtype="bfloat16", force_flash=False))
    if masked:
        from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
        q = torch.zeros(1, 2, 40, 64)
        with pytest.raises(NotImplementedError, match="multiple of 16"):
            bsa.key_padded_attention(q, q, q, torch.zeros(1, 40))
        _, tcfg = _cfgs(use_flash=True)
        batch = _batch(0, T=40)
        params = tbert.init_bert_params(tcfg, seed=0)
        with pytest.raises(NotImplementedError, match="multiple of 16"):
            tbert.bert_encode(params, torch.from_numpy(batch["input_ids"]),
                              tcfg, attention_mask=torch.from_numpy(
                                  batch["attention_mask"]))
    assert [p.name for p in ad.registered_programs("encoder")] == \
        ["block_sparse", "flash", "dense"]
    assert "block_sparse" not in [p.name
                                  for p in ad.registered_programs("train")]


def test_bert_configs_match_jax():
    for name, jc in jbert.BERT_CONFIGS.items():
        tc = tbert.BERT_CONFIGS[name]
        for field in ("vocab_size", "n_layer", "n_head", "d_model", "d_ff",
                      "max_seq_len", "type_vocab_size", "norm_eps",
                      "pre_layer_norm", "remat"):
            assert getattr(tc, field) == getattr(jc, field), (name, field)
        assert tc.dtype == torch.bfloat16 and tc.head_dim == jc.head_dim
