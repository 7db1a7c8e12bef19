"""The PyTorch port's HF / Megatron adapters (`inference/adapters.py`) held
to the JAX package's: the same tiny randomly initialised HF model (built
from a config object, no download) through both adapters gives the same
config fields and the same parameter tree, leaf for leaf and bit for bit
(fp32); the port's forward on that tree matches HF's own torch forward
within the JAX adapter tests' tolerance (atol 2e-3, rtol 1e-3).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from deepspeed_tpu.inference import adapters as jad  # noqa: E402
from deepspeed_tpu_torch import init_inference  # noqa: E402
from deepspeed_tpu_torch.inference import adapters as tad  # noqa: E402
from deepspeed_tpu_torch.models import bert as tbert  # noqa: E402
from deepspeed_tpu_torch.models import gpt as tgpt  # noqa: E402
from deepspeed_tpu_torch.models.moe_gpt import moe_gpt_forward  # noqa: E402
from deepspeed_tpu_torch.utils.tree import tree_leaves  # noqa: E402

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)


def _same_tree(port, ref):
    """Same keys, shapes and values, leaf by leaf."""
    assert isinstance(port, dict) == isinstance(ref, dict)
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _same_tree(port[k], ref[k])
        return
    a = np.asarray(ref)
    assert tuple(port.shape) == a.shape
    np.testing.assert_array_equal(port.float().numpy(), a.astype(np.float32))


def _same_config(tcfg, jcfg):
    names = {f.name for f in dataclasses.fields(tcfg)} & \
        {f.name for f in dataclasses.fields(jcfg)}
    names -= {"dtype", "softmax_dtype"}
    assert {n: getattr(tcfg, n) for n in names} == \
        {n: getattr(jcfg, n) for n in names}


def _llama_cfg(**over):
    return transformers.LlamaConfig(**{**dict(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False), **over})


def _hf(kind, seed=0):
    """(HF model in eval mode, its forward's logits on the tokens, tokens)."""
    torch.manual_seed(seed)
    if kind == "gpt2":
        hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4))
    elif kind == "llama":
        hf = transformers.LlamaForCausalLM(_llama_cfg())
    elif kind == "internlm":
        hf = transformers.LlamaForCausalLM(_llama_cfg(
            num_key_value_heads=4, attention_bias=True))
        with torch.no_grad():           # biases start at zero: randomize
            for layer in hf.model.layers:
                a = layer.self_attn
                for proj in (a.q_proj, a.k_proj, a.v_proj, a.o_proj):
                    proj.bias.normal_(0, 0.05)
    elif kind == "mistral":
        hf = transformers.MistralForCausalLM(transformers.MistralConfig(
            vocab_size=128, hidden_size=64, intermediate_size=112,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            sliding_window=None, tie_word_embeddings=False))
    elif kind == "opt":
        hf = transformers.OPTForCausalLM(transformers.OPTConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, ffn_dim=128, max_position_embeddings=64,
            word_embed_proj_dim=64))
    elif kind == "gpt_neox":
        hf = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, rotary_pct=0.5))
    elif kind == "gptj":
        hf = transformers.GPTJForCausalLM(transformers.GPTJConfig(
            vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
            rotary_dim=8))
    else:
        raise AssertionError(kind)
    hf.eval()
    toks = np.random.default_rng(seed + 1).integers(0, 128, (2, 16))
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.float().numpy()
    return hf, ref, toks


@pytest.mark.parametrize("kind", ["gpt2", "llama", "internlm", "mistral",
                                  "opt", "gpt_neox", "gptj"])
def test_causal_lm_adapter_equals_jax_and_matches_hf_logits(kind):
    """adapt_hf_model dispatches on model_type to the family's adapter
    (internlm through from_hf_internlm): the config and the tree equal the
    JAX adapter's; gpt_forward on the tree matches HF's logits."""
    hf, ref, toks = _hf(kind)
    if kind == "internlm":
        tcfg, tp = tad.from_hf_internlm(hf)
        jcfg, jp = jad.from_hf_internlm(hf)
    else:
        tcfg, tp = tad.adapt_hf_model(hf)
        jcfg, jp = jad.adapt_hf_model(hf)
    _same_config(tcfg, jcfg)
    _same_tree(tp, jp)
    got = tgpt.gpt_forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)


@pytest.mark.parametrize("kind", ["bert", "distilbert"])
def test_encoder_adapter_equals_jax_and_matches_hf_logits(kind):
    """from_hf_bert / from_hf_distilbert: config and tree equal the JAX
    adapter's; bert_encode + bert_mlm_logits match HF's MLM logits over
    the unpadded positions of a ragged mask."""
    torch.manual_seed(3)
    if kind == "bert":
        hf = transformers.BertForMaskedLM(transformers.BertConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64))
    else:
        hf = transformers.DistilBertForMaskedLM(transformers.DistilBertConfig(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
            max_position_embeddings=64))
    hf.eval()
    tcfg, tp = tad.adapt_hf_model(hf)
    jcfg, jp = jad.adapt_hf_model(hf)
    _same_config(tcfg, jcfg)
    _same_tree(tp, jp)
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    am = np.ones((2, 16), np.int64)
    am[:, 12:] = 0
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(am)).logits.float().numpy()
    seq = tbert.bert_encode(tp, torch.from_numpy(ids), tcfg,
                            attention_mask=torch.from_numpy(am))
    got = tbert.bert_mlm_logits(tp, seq, tcfg).detach().numpy()
    # padded positions attend freely: compare the unpadded region
    np.testing.assert_allclose(got[:, :12], ref[:, :12], **LOGIT_TOL)


def test_llama_adapter_takes_a_numpy_state_dict_and_a_plain_config():
    """No transformers object needed: an HF-named numpy state dict and a
    SimpleNamespace config adapt as the model does (the card's path)."""
    hf, ref, toks = _hf("llama", seed=4)
    c = hf.config
    ns = types.SimpleNamespace(
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_key_value_heads, hidden_size=c.hidden_size,
        vocab_size=c.vocab_size, num_hidden_layers=c.num_hidden_layers,
        intermediate_size=c.intermediate_size,
        max_position_embeddings=c.max_position_embeddings,
        rope_theta=c.rope_theta, rms_norm_eps=c.rms_norm_eps,
        tie_word_embeddings=False)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    cfg, params = tad.from_hf_llama(sd, ns, dtype=torch.float32)
    _same_tree(params, tad.from_hf_llama(hf)[1])
    np.testing.assert_allclose(
        tgpt.gpt_forward(params, torch.from_numpy(toks), cfg).numpy(), ref,
        **LOGIT_TOL)
    bf = tad.from_hf_llama(sd, ns, dtype=torch.bfloat16)[1]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bf))


def test_rope_row_permutation_helpers_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4 * 16, 8)).astype(np.float32)
    for rd in (None, 8):
        np.testing.assert_array_equal(tad._unpermute_rope_rows(w, 4, 16, rd),
                                      jad._unpermute_rope_rows(w, 4, 16, rd))
    fused = rng.standard_normal((3 * 64, 8)).astype(np.float32)
    for a, b in zip(tad._split_fused_qkv_per_head(fused, 4, 16),
                    jad._split_fused_qkv_per_head(fused, 4, 16)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tad._split_fused_qkv_per_head(fused[:, 0], 4, 16),
                    jad._split_fused_qkv_per_head(fused[:, 0], 4, 16)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# the families whose flags the port does not run yet
# ----------------------------------------------------------------------


def test_bloom_adapter_maps_the_weights_and_raises_naming_use_alibi():
    torch.manual_seed(0)
    hf = transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=128, hidden_size=64, n_layer=2, n_head=4))
    with pytest.raises(NotImplementedError, match="use_alibi"):
        tad.adapt_hf_model(hf)
    jcfg, jp = jad.from_hf_bloom(hf)
    H = hf.config.n_head
    _same_tree(tad._bloom_params(tad._state_dict(hf), jcfg.n_layer, H,
                                 64 // H, torch.float32), jp)


def test_gpt_neo_adapter_maps_the_weights_and_raises_naming_the_flags():
    torch.manual_seed(0)
    hf = transformers.GPTNeoForCausalLM(transformers.GPTNeoConfig(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
        max_position_embeddings=64, window_size=8,
        attention_types=[[["global", "local"], 1]]))
    with pytest.raises(NotImplementedError,
                       match="sliding_window.*attn_layer_types"):
        tad.adapt_hf_model(hf)
    jcfg, jp = jad.from_hf_gpt_neo(hf)
    _same_tree(tad._gpt_neo_params(tad._state_dict(hf), jcfg.n_layer,
                                   torch.float32), jp)


def test_windowed_mistral_raises_naming_sliding_window():
    torch.manual_seed(0)
    hf = transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, sliding_window=16))
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tad.adapt_hf_model(hf)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tad.hf_decode_model(hf)


# ----------------------------------------------------------------------
# dispatch, decode and train specs
# ----------------------------------------------------------------------


def test_adapter_registry_equals_jax():
    assert sorted(tad._ADAPTERS) == sorted(jad._ADAPTERS)
    hf = types.SimpleNamespace(config=types.SimpleNamespace(
        model_type="t5"))
    with pytest.raises(NotImplementedError, match="no adapter"):
        tad.adapt_hf_model(hf)


def test_hf_decode_model_generates_as_hf():
    """GPT-2 with a wide init (well-separated logits): the port's greedy
    generate() equals HF's generate; the BERT family is refused."""
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        initializer_range=0.2))
    hf.eval()
    spec = tad.hf_decode_model(hf)
    assert spec.eos_token_id == hf.config.eos_token_id
    engine = init_inference(spec, config={"dtype": "float32",
                                          "kv_cache_dtype": "float32",
                                          "greedy": True}, device="cpu")
    toks = np.random.default_rng(0).integers(0, 128, (2, 8))
    out = engine.generate(toks.astype(np.int32), max_new_tokens=6)
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(toks), max_new_tokens=6,
                          do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(np.asarray(out), ref[:, 8:].numpy())
    torch.manual_seed(0)
    bert = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64))
    with pytest.raises(ValueError, match="encoders"):
        tad.hf_decode_model(bert)


def test_hf_train_model_specs():
    """BERT -> the MLM ModelSpec (remat, bf16, arch_cfg set), its loss the
    JAX-equal tree's; a causal LM -> make_gpt_model over the adapted tree."""
    torch.manual_seed(1)
    hf = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32))
    spec = tad.hf_train_model(hf)
    assert spec.arch_cfg.remat and spec.arch_cfg.dtype == torch.bfloat16
    assert spec.name == "bert"
    f32 = dataclasses.replace(spec.arch_cfg, dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 8)))
    batch = {"input_ids": ids, "labels": ids}
    want = tbert.bert_mlm_loss(tad.from_hf_bert(hf)[1], batch, cfg=f32)
    got = spec.loss_fn.func(spec.params, batch, cfg=f32)
    torch.testing.assert_close(got, want)
    hf2, _, _ = _hf("llama", seed=2)
    spec2 = tad.hf_train_model(hf2)
    assert spec2.arch_cfg.use_swiglu and spec2.arch_cfg.remat
    _same_tree(spec2.params, tad.from_hf_llama(hf2)[1])


# ----------------------------------------------------------------------
# Megatron-LM
# ----------------------------------------------------------------------


def _toy_megatron_sd(version, seed=0, L=2, D=32, H=4, V=64, T=16):
    """Random Megatron GPT state dict with the version's fused qkv order."""
    rng = np.random.default_rng(seed)
    hd = D // H
    r = lambda *s: rng.normal(0, 0.02, s).astype(np.float32)
    sd = {"word_embeddings.weight": r(V, D),
          "position_embeddings.weight": r(T, D),
          "transformer.final_layernorm.weight": 1 + r(D),
          "transformer.final_layernorm.bias": r(D)}

    def order(t3):                      # [3, D, ...] -> the version's rows
        t3 = np.stack(t3)
        per_head = t3.reshape(3, H, hd, *t3.shape[2:])
        if version == 0:
            return t3.reshape(3 * D, *t3.shape[2:])
        if version == 1.0:
            return np.moveaxis(per_head, 0, 2).reshape(3 * D, *t3.shape[2:])
        return np.moveaxis(per_head, 0, 1).reshape(3 * D, *t3.shape[2:])

    for i in range(L):
        b = f"transformer.layers.{i}."
        sd[b + "attention.query_key_value.weight"] = order(
            [r(D, D), r(D, D), r(D, D)])
        sd[b + "attention.query_key_value.bias"] = order([r(D), r(D), r(D)])
        sd[b + "attention.dense.weight"] = r(D, D)
        sd[b + "attention.dense.bias"] = r(D)
        sd[b + "input_layernorm.weight"] = 1 + r(D)
        sd[b + "input_layernorm.bias"] = r(D)
        sd[b + "post_attention_layernorm.weight"] = 1 + r(D)
        sd[b + "post_attention_layernorm.bias"] = r(D)
        sd[b + "mlp.dense_h_to_4h.weight"] = r(4 * D, D)
        sd[b + "mlp.dense_h_to_4h.bias"] = r(4 * D)
        sd[b + "mlp.dense_4h_to_h.weight"] = r(D, 4 * D)
        sd[b + "mlp.dense_4h_to_h.bias"] = r(D)
    return sd


@pytest.mark.parametrize("version", [0, 1.0, 2.0])
def test_megatron_adapter_orderings_equal_jax(version):
    """Each qkv row ordering: the tree equals the JAX adapter's and the
    version-0 tree of the same logical weights (the same seed draws the
    same q, k, v)."""
    sd = _toy_megatron_sd(version)
    tcfg, tp = tad.from_megatron_gpt(sd, num_heads=4, version=version)
    jcfg, jp = jad.from_megatron_gpt(sd, num_heads=4, version=version)
    _same_config(tcfg, jcfg)
    _same_tree(tp, jp)
    assert tcfg.tie_embeddings and tcfg.n_layer == 2
    _, t0 = tad.from_megatron_gpt(_toy_megatron_sd(0), num_heads=4,
                                  version=0)
    _same_tree(tp, {k: (v.numpy() if k != "blocks" else
                        {n: x.numpy() for n, x in v.items()})
                    for k, v in t0.items()})
    with pytest.raises(ValueError, match="version"):
        tad._megatron_qkv_to_packed(np.zeros((96, 32), np.float32), 4, 8, 3.0)


def test_megatron_adapter_checkpoint_envelope():
    """A 'model' envelope with 'checkpoint_version' and a 'language_model'
    level adapt as the bare dict at that version; num_heads may come from
    a config object; without it the adapter refuses."""
    sd = _toy_megatron_sd(2.0)
    _, bare = tad.from_megatron_gpt(sd, num_heads=4, version=2.0)
    for wrapped in ({"model": sd, "checkpoint_version": 2.0},
                    {"module": {"language_model": sd},
                     "checkpoint_version": 2.0}):
        _, p = tad.from_megatron_gpt(
            wrapped, types.SimpleNamespace(num_attention_heads=4))
        torch.testing.assert_close(p["blocks"]["attn_qkv_w"],
                                   bare["blocks"]["attn_qkv_w"])
    with pytest.raises(ValueError, match="num_heads"):
        tad.from_megatron_gpt(sd)


def test_megatron_moe_adapter_equals_jax_and_routes():
    """The Megatron + DeepSpeed-MoE dict (experts in every odd layer): the
    MoEGPTConfig and tree equal the JAX adapter's; the port's MoE forward
    runs on it with live routing."""
    sd = _toy_megatron_sd(0, L=4)
    rng = np.random.default_rng(11)
    r = lambda *s: rng.normal(0, 0.02, s).astype(np.float32)
    for lid in (1, 3):
        b = f"transformer.layers.{lid}."
        for key in ("weight", "bias"):
            del sd[b + f"mlp.dense_h_to_4h.{key}"]
            del sd[b + f"mlp.dense_4h_to_h.{key}"]
        m = b + "mlp.deepspeed_moe."
        sd[m + "gate.wg.weight"] = r(2, 32)
        for e in range(2):
            eb = f"{m}experts.deepspeed_experts.{e}."
            sd[eb + "dense_h_to_4h.weight"] = r(128, 32)
            sd[eb + "dense_h_to_4h.bias"] = r(128)
            sd[eb + "dense_4h_to_h.weight"] = r(32, 128)
            sd[eb + "dense_4h_to_h.bias"] = r(32)
    tcfg, tp = tad.from_megatron_gpt_moe(sd, num_heads=4, version=0)
    jcfg, jp = jad.from_megatron_gpt_moe(sd, num_heads=4, version=0)
    _same_config(tcfg, jcfg)
    assert tcfg.num_experts == 2 and tcfg.moe_freq == 2
    _same_tree(tp, jp)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 12)))
    logits, l_aux = moe_gpt_forward(tp, toks, tcfg, training=False)[:2]
    assert torch.isfinite(logits).all() and float(l_aux) > 0.0
    with pytest.raises(ValueError, match="deepspeed_moe"):
        tad.from_megatron_gpt_moe(_toy_megatron_sd(0), num_heads=4)


def test_jax_adapter_trees_are_jax_arrays():
    """The comparison above reads the JAX trees as numpy: guard that the
    JAX adapters really return jax arrays (so the two sides are distinct
    code paths)."""
    _, jp = jad.from_megatron_gpt(_toy_megatron_sd(0), num_heads=4, version=0)
    assert isinstance(jp["wte"], jax.Array)
    assert jp["wte"].dtype == jnp.float32
