"""Guards of the PyTorch port: what it may import and call, where it runs,
what it refuses, and how it builds its kernels."""

import ast
import dataclasses
import stat
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.config import TpuInferenceConfig
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.models.gpt import GPTConfig, make_gpt_decode_model
from deepspeed_tpu_torch.ops import attention_dispatch as ad
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import quant as tqo

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py"))
TINY = GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=64,
                 vocab_size=128, dtype="float32")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_transformers(path):
    """The HF adapters take a model or a state dict and its config object;
    the card's machine has no transformers, so nothing of the port may
    need it."""
    bad = [m for m in _imports(path) if m.split(".")[0] == "transformers"]
    assert not bad, f"{path.name} imports {bad}"


def test_port_never_names_library_attention_or_compile():
    """No SDPA, cuDNN attention or torch.compile anywhere in the package:
    the three attention kernels are the hand-written ones (chip_smoke.py
    times SDPA beside them as a yardstick only)."""
    for path in PORT_FILES:
        tree = ast.parse(path.read_text())
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        for banned in ("scaled_dot_product_attention", "compile",
                       "cudnn"):
            assert banned not in names, f"{path.name} names {banned}"


def test_entry_points_refuse_to_run_on_the_cpu_quietly():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default device is valid")
    spec = make_gpt_decode_model(TINY, name="tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_inference(spec, config={"dtype": "float32",
                                     "kv_cache_dtype": "float32"})
    engine = init_inference(spec, config={"dtype": "float32",
                                          "kv_cache_dtype": "float32"},
                            device="cpu")
    assert engine.device.type == "cpu"


def test_fabric_engines_refuse_to_run_on_the_cpu_quietly():
    """The fabric's tiny engine, and a replica-server child built from it,
    run on the card unless the kwargs ask for the CPU: with no GPU they
    raise through `resolve_device`, before any port is bound."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default device is valid")
    from deepspeed_tpu_torch.serving import replica_server
    from deepspeed_tpu_torch.testing.fabric import tiny_serving_engine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiny_serving_engine()
    factory = "deepspeed_tpu_torch.testing.fabric:tiny_serving_engine"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica_server.main(["--factory", factory, "--kwargs", "{}"])
    serving = tiny_serving_engine(device="cpu")
    assert serving.engine.device.type == "cpu"


@pytest.mark.parametrize("name", ["Autoscaler", "AutoscalerConfig"])
def test_unported_autoscaler_names_refuse(name):
    """The autoscaler is ported: its names resolve to the ported classes
    (they refused before the port had them)."""
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.serving import autoscaler
    assert getattr(serving, name) is getattr(autoscaler, name)
    assert name in serving.__all__


def test_cuda_wrappers_take_the_plain_version_for_cpu_tensors():
    """Handed CPU tensors, each kernel wrapper runs its plain version and
    leaves the launch counter at 0 — nothing is built or launched."""
    rng = np.random.default_rng(12)
    normal = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    op_builder.LAUNCHES.clear()
    q, kc = normal(2, 4, 64), normal(2, 4, 32, 64)
    pos = torch.tensor([3, 31], dtype=torch.int32)
    assert torch.equal(tda.decode_attention(q, kc, kc, pos),
                       tda.decode_attention_reference(q, kc, kc, pos))
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    pool = normal(3, 4, 32, 64)
    assert torch.equal(
        tda.paged_decode_attention(q, pool, pool, tables, pos),
        tda.paged_decode_attention_reference(q, pool, pool, tables, pos))
    x = normal(1, 40, 4, 64)
    assert torch.equal(tfa.flash_attention(x, x, x),
                       tfa.flash_attention_reference(x, x, x)[0])
    for bits, quantize, dequantize in (
            (8, tqo.quantize_int8, tqo.dequantize_int8),
            (4, tqo.quantize_int4, tqo.dequantize_int4)):
        q8, s8 = quantize(pool, 32)
        ref_q, ref_s = tqo.quantize_reference(pool, 32, bits)
        assert torch.equal(q8, ref_q) and torch.equal(s8, ref_s)
        assert torch.equal(dequantize(q8, s8, torch.float32, 32),
                           tqo.dequantize_reference(q8, s8, torch.float32, 32,
                                                    bits))
    kq, ks = tqo.quantize_int8(pool, 64)
    int8_pool = {"k": kq, "v": kq, "k_scale": ks, "v_scale": ks}
    assert torch.equal(
        tda.paged_decode_attention_quant(q, kq, kq, ks, ks, tables, pos),
        tda.paged_decode_attention_quant_reference(q, int8_pool, tables, pos))
    assert sum(op_builder.LAUNCHES.values()) == 0


@pytest.mark.parametrize("override", [
    {"serving": {"degradation": {"enabled": True, "headroom_low": 0.1}}},
    {"telemetry": {"enabled": True, "tracing": True}},
    {"telemetry": {"flight_recorder": True}},
    {"tensor_parallel": {"tp_size": 2}},
    {"mp_size": 2},
], ids=lambda o: str(o))
def test_unported_features_refuse_at_config_time(override):
    """Features the port lacks refuse when the config is built. The
    telemetry block's request tracer and flight recorder are ported now:
    their cases build, and turn the matching object on; so does the
    ladder's memory-headroom signal (it reads the memscope ledger)."""
    if "serving" in override:
        cfg = TpuInferenceConfig.from_dict(override)
        assert cfg.serving.degradation.headroom_low == 0.1
        return
    tel = override.get("telemetry", {})
    if tel.get("tracing") or tel.get("flight_recorder"):
        cfg = TpuInferenceConfig.from_dict(override)
        assert cfg.telemetry.tracing == bool(tel.get("tracing"))
        assert cfg.telemetry.flight_recorder == \
            bool(tel.get("flight_recorder"))
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        TpuInferenceConfig.from_dict(override)


@pytest.mark.parametrize("override", [
    {"zero": {"offload_param": {"device": "cpu"}}},
    {"zero": {"offload_param": {"device": "nvme", "nvme_path": "swap",
                                "lookahead": 2}}},
], ids=lambda o: str(o))
def test_zero_inference_configs_build(override):
    """ZeRO-Inference's weight spill is ported: the block builds and
    init_inference routes a LayeredModelSpec to ZeroInferenceEngine."""
    cfg = TpuInferenceConfig.from_dict(override)
    assert cfg.zero["offload_param"]["device"] in ("cpu", "nvme")


@pytest.mark.parametrize("override", [
    {"quant": {"enabled": True}},
    {"serving": {"quantization": {"kv_cache_dtype": "int8"}}},
    {"serving": {"quantization": {"weights": "int4"}}},
], ids=lambda o: str(o))
def test_quantized_serving_configs_build(override):
    """Weight-only quantization and the int8 KV pool are ported: the dicts
    that refused before build a config now."""
    cfg = TpuInferenceConfig.from_dict(override)
    assert cfg.quant.enabled or cfg.serving.quantization.kv_cache_dtype \
        or cfg.serving.quantization.weights == "int4"


@pytest.mark.parametrize("override", [
    {"serving": {"spec_decode": {"drafter": "ngram"}}},
    {"serving": {"spec_decode": {"drafter": "model", "draft_k": 2}}},
    {"serving": {"enable_prefix_caching": True}},
    {"serving": {"degradation": {"enabled": True}}},
    {"serving": {"audit_interval": 4}},
], ids=lambda o: str(o))
def test_serving_feature_configs_build(override):
    """Prefix caching, spec decode, the auditor and the degradation ladder
    are ported: the dicts that refused before build a config now."""
    serving = TpuInferenceConfig.from_dict(override).serving
    assert serving.enable_prefix_caching or serving.audit_interval \
        or serving.degradation.enabled \
        or serving.spec_decode.drafter in ("ngram", "model")


def test_serving_overrides_are_validated_too():
    engine = init_inference(make_gpt_decode_model(TINY, name="tiny"),
                            config={"dtype": "float32",
                                    "kv_cache_dtype": "float32",
                                    "kv_block_size": 16,
                                    "max_out_tokens": 64}, device="cpu")
    with pytest.raises(ValueError, match="needs a draft DecodeModelSpec"):
        engine.serving(spec_decode={"drafter": "model"})
    # the headroom signal builds; as in the JAX package it is left out
    # while memscope is off, and read from the ledger when it is on
    off = engine.serving(degradation={"enabled": True, "headroom_low": 0.5})
    assert off.memscope is None
    assert "headroom_frac" not in off.pressure._signals()
    on = init_inference(make_gpt_decode_model(TINY, name="tiny"),
                        config={"dtype": "float32",
                                "kv_cache_dtype": "float32",
                                "kv_block_size": 16, "max_out_tokens": 64,
                                "telemetry": {
                                    "enabled": True, "prometheus": False,
                                    "jsonl": False, "memscope": True,
                                    "memscope_capacity_bytes": 1 << 30}},
                        device="cpu").serving(
        degradation={"enabled": True, "headroom_low": 0.5})
    want = on.memscope.headroom_frac()
    assert 0 < want < 1 and on.pressure._signals()["headroom_frac"] == want
    with pytest.raises(NotImplementedError, match="kv_cache_dtype"):
        init_inference(make_gpt_decode_model(TINY, name="tiny"),
                       config={"dtype": "float32"}, device="cpu")


def test_dispatch_engages_kernels_where_their_contract_holds():
    site = lambda **kw: ad.AttnSite(**{**dict(phase="train", q_len=600,
                                              kv_len=600, head_dim=64,
                                              kv_dtype="bfloat16",
                                              on_cuda=True), **kw})
    assert ad.select(site()) == "flash"
    assert ad.select(site(q_len=37, kv_len=37)) == "flash"     # any T
    assert ad.select(site(head_dim=128, kv_dtype="float16")) == "flash"
    assert ad.select(site(on_cuda=False)) == "dense"
    assert ad.select(site(on_cuda=False, force_flash=False)) == "dense"
    assert ad.select(site(on_cuda=False, force_flash=True)) == "flash"
    assert ad.select(site(on_cuda=False, has_window=True,
                          force_flash=True)) == "dense"
    assert ad.select(site(phase="decode", q_len=1, kv_dtype="float32")) \
        == "decode_kernel"
    assert ad.select(site(phase="decode", q_len=1, on_cuda=False)) \
        == "decode_dense"
    assert ad.select(site(phase="paged_decode", q_len=1)) == "paged_kernel"
    assert ad.select(site(phase="paged_decode", q_len=1, on_cuda=False)) \
        == "paged_gather"
    # the int8 pool: its kernel on CUDA, its dequantizing gather elsewhere
    int8 = dict(q_len=1, kv_dtype="int8")
    assert ad.select(site(phase="paged_decode", **int8)) \
        == "paged_kernel_quant"
    assert ad.select(site(phase="paged_decode", head_dim=128, **int8)) \
        == "paged_kernel_quant"
    assert ad.select(site(phase="paged_decode", on_cuda=False, **int8)) \
        == "paged_gather_quant"
    assert ad.select(site(phase="paged_decode", on_cuda=False,
                          force_flash=True, **int8)) == "paged_kernel_quant"
    assert ad.select(site(phase="prefill_chunk", q_len=16,
                          kv_dtype="int8")) == "paged_gather_quant"
    # chunked prefill is a gather + dense attend on every device, as in the
    # JAX package
    assert ad.select(site(phase="prefill_chunk", q_len=16)) == "paged_gather"
    assert ad.select(site(phase="prefill_chunk", q_len=16, on_cuda=False)) \
        == "paged_gather"


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="float32"),                        # flash takes bf16/fp16
    dict(head_dim=32),                               # gpt2-tiny's width
    dict(head_dim=96),
    dict(force_flash=False),
    dict(has_window=True),
    dict(q_len=37),                                  # not square
    dict(phase="decode", q_len=1, head_dim=32),
    dict(phase="decode", q_len=1, has_bias=True),
    dict(phase="decode", q_len=1, force_flash=False),
    dict(phase="paged_decode", q_len=1, kv_dtype="float64"),
    dict(phase="paged_decode", q_len=1, head_dim=32),
    dict(phase="paged_decode", q_len=1, force_flash=False),
    dict(phase="paged_decode", q_len=1, kv_dtype="int8", head_dim=32),
    dict(phase="paged_decode", q_len=1, kv_dtype="int8", force_flash=False),
    dict(phase="paged_decode", q_len=1, kv_dtype="int8", has_window=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_dispatch_runs_no_plain_attention_on_cuda(kw):
    """A CUDA site the kernel does not take raises; it never falls to the
    plain attention programs on the card."""
    site = ad.AttnSite(**{**dict(phase="train", q_len=600, kv_len=600,
                                 head_dim=64, kv_dtype="bfloat16",
                                 on_cuda=True), **kw})
    with pytest.raises(NotImplementedError, match="no plain attention"):
        ad.select(site)


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


def test_kernel_builder_rebuilds_on_source_change_and_raises_on_failure(
        tmp_path, monkeypatch):
    """One nvcc per source into the build dir, named by the source hash: an
    unchanged source reuses its library, an edited one rebuilds, a failed
    compile raises with the compiler's output."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(op_builder, "CSRC", csrc)
    monkeypatch.setattr(op_builder, "BUILD_DIR", build)
    # the fake compiler writes its input's text to the -o path
    home = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'cat "$3" > "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    libs = op_builder.build_all()
    assert sorted(libs) == ["a", "b"]
    assert libs["a"].read_text() == "// a\n" and libs["a"].parent == build
    assert op_builder.build_all(["a"])["a"] == libs["a"]
    (csrc / "a.cu").write_text("// a, edited\n")
    rebuilt = op_builder.build_all(["a"])["a"]
    assert rebuilt != libs["a"] and rebuilt.read_text() == "// a, edited\n"
    failing = _fake_nvcc(tmp_path / "bad", "echo 'error: no' ; exit 3\n")
    monkeypatch.setenv("CUDA_HOME", str(failing))
    (csrc / "b.cu").write_text("// b, edited\n")
    with pytest.raises(RuntimeError, match="error: no"):
        op_builder.build_all(["b"])
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no nvcc"):
        op_builder.build_all(["b"])


def test_initialize_refuses_to_train_on_the_cpu_quietly():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default device is valid")
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import make_gpt_model
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW"}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize(model=make_gpt_model(TINY, name="tiny"), config=config)
    engine, *_ = initialize(model=make_gpt_model(TINY, name="tiny"),
                            config=config, device="cpu")
    assert engine.device.type == "cpu"
    assert engine.state.params["wte"].device.type == "cpu"


@pytest.mark.parametrize("override", [
    {"zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
    {"pipeline": {"stages": 2}},
    {"moe": {"enabled": True}},
    {"optimizer": {"type": "OneBitAdam"}},
    {"optimizer": {"type": "ZeroOneAdam"}},
    {"optimizer": {"type": "OneBitLamb"}},
    {"telemetry": {"enabled": True, "memscope": True}},
    {"checkpoint": {"async_save": True}},
    {"fault_tolerance": {"enabled": True}},
    {"data_efficiency": {"enabled": True, "data_sampling": {
        "curriculum_learning": {"enabled": True,
                                "curriculum_metrics": {"seqlen": {}}}}}},
    {"compression_training": {"weight_quantization": {}}},
    {"mesh": {"data": 2}},
    {"mesh": {"tensor": 2}},
    {"activation_checkpointing": {"cpu_checkpointing": True}},
], ids=lambda o: str(o))
def test_unported_train_features_refuse_at_config_time(override):
    """Train features the port lacks refuse when the config is built.
    The memscope ledger, the `checkpoint` block and `fault_tolerance` are
    ported, and since item 7 closed so are qgZ and the 1-bit optimizers:
    their cases build, with the JAX package's fields."""
    from deepspeed_tpu.config.core import TpuTrainConfig as JCfg
    from deepspeed_tpu_torch.config.core import TpuTrainConfig
    base = {"train_micro_batch_size_per_gpu": 2}
    if "optimizer" in override or \
            "zero_quantized_gradients" in override.get("zero_optimization",
                                                       {}):
        cfg, ref = TpuTrainConfig.load({**base, **override}), \
            JCfg.load({**base, **override})
        assert dataclasses.asdict(cfg.zero_optimization).keys() >= {
            "zero_quantized_gradients", "explicit_grad_reduce"}
        for k in ("stage", "zero_quantized_gradients",
                  "zero_quantized_weights", "explicit_grad_reduce",
                  "onebit_gradients", "compressed_comm_axis"):
            assert getattr(cfg.zero_optimization, k) == \
                getattr(ref.zero_optimization, k), k
        if "optimizer" in override:
            assert cfg.optimizer.type == ref.optimizer.type
            assert cfg.optimizer.params == ref.optimizer.params
        return
    if override.get("mesh", {}).get("data") == 2:
        # data-parallel ZeRO across ranks is ported: the config builds
        # (the engine then needs a process group of 2 ranks)
        cfg = TpuTrainConfig.load({**base, **override})
        assert cfg.mesh.data == 2
        assert cfg.resolve_batch_sizes(2)[0] == 4
        return
    if "checkpoint" in override or "fault_tolerance" in override or \
            override.get("telemetry", {}).get("memscope"):
        cfg = TpuTrainConfig.load({**base, **override})
        assert cfg.checkpoint.engine == "torch"
        assert cfg.checkpoint.async_save == ("checkpoint" in override)
        assert cfg.fault_tolerance.enabled == ("fault_tolerance" in override)
        assert cfg.fault_tolerance.nonfinite_budget == 3
        assert cfg.telemetry.memscope == ("telemetry" in override)
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        TpuTrainConfig.load({**base, **override})


@pytest.mark.parametrize("override,item", [
    ({"mesh": {"zero": 2}}, 7),
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True}}, 7),
    ({"zero_optimization": {"stage": 2, "explicit_grad_reduce": True}}, 7),
    ({"zero_optimization": {"stage": 2, "onebit_gradients": True}}, 7),
    ({"zero_optimization": {"stage": 3, "mics_shard_size": 2}}, 7),
    ({"optimizer": {"type": "OneBitAdam"}}, 7),
    ({"gradient_compression": {"enabled": True}}, 7),
    ({"mesh": {"tensor": 2}}, 8),
    ({"mesh": {"sequence": 2}}, 8),
    ({"mesh": {"pipe": 2}}, 8),
    ({"mesh": {"expert": 2}}, 8),
    ({"pipeline": {"stages": 2}}, 8),
], ids=lambda o: str(o))
def test_still_refused_keys_name_their_item(override, item):
    """What stays refused raises when the config is built, naming the
    ROADMAP item it waits on. Item 7's keys (`mesh.zero`, ZeRO++, MiCS,
    the 1-bit optimizers, `gradient_compression`) are ported: their cases
    build with the JAX package's fields and defaults, and none names item
    7. `mesh.sequence` (context parallelism) is ported from item 8: it
    builds as JAX's does, while the rest of item 8 stays refused."""
    from deepspeed_tpu.config.core import TpuTrainConfig as JCfg
    from deepspeed_tpu_torch.config.core import TpuTrainConfig
    d = {"train_micro_batch_size_per_gpu": 2, **override}
    if override == {"mesh": {"sequence": 2}}:
        cfg, ref = TpuTrainConfig.load(d), JCfg.load(d)
        assert (cfg.mesh.data, cfg.mesh.sequence) == \
            (ref.mesh.data, ref.mesh.sequence) == (-1, 2)
        return
    if item == 7:
        cfg, ref = TpuTrainConfig.load(d), JCfg.load(d)
        for block in ("zero_optimization", "gradient_compression"):
            got = dataclasses.asdict(getattr(cfg, block))
            want = dataclasses.asdict(getattr(ref, block))
            assert {k: got[k] for k in want if k in got} == \
                {k: want[k] for k in want if k in got}, block
        assert dataclasses.asdict(cfg.gradient_compression) == \
            dataclasses.asdict(ref.gradient_compression)
        assert (cfg.mesh.data, cfg.mesh.zero) == (ref.mesh.data,
                                                 ref.mesh.zero)
        if cfg.optimizer is not None:
            assert cfg.optimizer.type == ref.optimizer.type
        return
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        TpuTrainConfig.load(d)


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_onebit_gradients_with_offload_optimizer_raises_jax_message(device,
                                                                   tmp_path):
    """`onebit_gradients` refuses `offload_optimizer` when the engine is
    built, with the JAX engine's message (the residuals cannot be threaded
    through the host step)."""
    import deepspeed_tpu
    import jax.numpy as jnp
    from deepspeed_tpu.comm import mesh as jmesh
    from deepspeed_tpu_torch.runtime.engine import ModelSpec, initialize
    config = {"train_micro_batch_size_per_gpu": 1,
              "optimizer": {"type": "Adam"},
              "zero_optimization": {"stage": 1, "onebit_gradients": True,
                                    "offload_optimizer": {
                                        "device": device,
                                        "nvme_path": str(tmp_path)}}}
    jmesh.clear_mesh()
    with pytest.raises(ValueError) as want:
        deepspeed_tpu.initialize(
            model=lambda p, b: jnp.sum(p["w"] * b["x"]),
            model_parameters={"w": jnp.ones(4)},
            config={**config, "mesh": {"data": 1}})
    jmesh.clear_mesh()
    with pytest.raises(ValueError) as got:
        initialize(model=ModelSpec(loss_fn=lambda p, b: (p["w"] * b["x"])
                                   .sum(), params={"w": torch.ones(4)}),
                   config=config, device="cpu")
    assert str(got.value) == str(want.value)
    assert "onebit_gradients is incompatible with offload_optimizer" in \
        str(got.value)


def test_comm_keys_are_accepted_as_in_jax():
    """`comms_logger`, `prescale_gradients` and `gradient_predivide_factor`
    build, with the JAX package's fields and defaults."""
    from deepspeed_tpu.config.core import TpuTrainConfig as JCfg
    from deepspeed_tpu_torch.config.core import TpuTrainConfig
    d = {"train_micro_batch_size_per_gpu": 2, "prescale_gradients": True,
         "gradient_predivide_factor": 2.0,
         "comms_logger": {"enabled": True, "verbose": False}}
    cfg, ref = TpuTrainConfig.load(d), JCfg.load(d)
    assert cfg.prescale_gradients is ref.prescale_gradients is True
    assert cfg.gradient_predivide_factor == ref.gradient_predivide_factor
    import dataclasses
    assert dataclasses.asdict(cfg.comms_logger) == \
        dataclasses.asdict(ref.comms_logger)


def test_mesh_larger_than_the_world_raises_at_engine_build():
    """Without a process group a rank never trains alone for a larger
    mesh: the engine refuses `mesh.data = 2`."""
    from deepspeed_tpu_torch.runtime.engine import ModelSpec, initialize
    model = ModelSpec(loss_fn=lambda p, b: (p["w"] * b["x"]).sum(),
                      params={"w": torch.ones(4)})
    with pytest.raises(ValueError, match="process group"):
        initialize(model=model, device="cpu", config={
            "train_micro_batch_size_per_gpu": 1, "mesh": {"data": 2},
            "optimizer": {"type": "adam"}})


@pytest.mark.parametrize("override", [
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {
        "device": "nvme", "nvme_path": "swap", "lookahead": 0}}},
    {"zero_optimization": {"offload_optimizer": {"device": "nvme",
                                                 "nvme_path": "swap"}}},
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"zero_force_ds_cpu_optimizer": True},
], ids=lambda o: str(o))
def test_offload_train_configs_build(override):
    """The offload tier is ported: its blocks build as typed configs."""
    from deepspeed_tpu_torch.config.core import (OffloadOptimizerConfig,
                                                 OffloadParamConfig,
                                                 TpuTrainConfig)
    cfg = TpuTrainConfig.load({"train_micro_batch_size_per_gpu": 2,
                               **override})
    zero = cfg.zero_optimization
    for block, cls in ((zero.offload_param, OffloadParamConfig),
                       (zero.offload_optimizer, OffloadOptimizerConfig)):
        assert block is None or isinstance(block, cls)
    assert cfg.zero_force_ds_cpu_optimizer == \
        override.get("zero_force_ds_cpu_optimizer", False)


def test_offload_device_names_are_checked():
    from deepspeed_tpu_torch.config.core import TpuTrainConfig
    with pytest.raises(ValueError, match="offload_param.device"):
        TpuTrainConfig.load({"zero_optimization": {
            "offload_param": {"device": "disk"}}})


def test_a_layered_spec_without_offload_param_raises_jaxs_message():
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import make_gpt_layered_model
    with pytest.raises(ValueError, match="trains via the Infinity tier: set "
                       "zero_optimization.offload_param.device"):
        initialize(model=make_gpt_layered_model(TINY, name="tiny"),
                   config={"train_micro_batch_size_per_gpu": 2,
                           "optimizer": {"type": "AdamW"}}, device="cpu")


@pytest.mark.parametrize("override", [
    {"curriculum_learning": {"enabled": True}},
    {"data_efficiency": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": True}},
    {"data_efficiency": {"enabled": True, "data_routing": {"random_ltd": {
        "enabled": True, "total_layer_num": 2}}}},
    {"data_efficiency": {"enabled": True, "data_sampling": {
        "curriculum_learning": {"enabled": True, "min_difficulty": 8}}}},
], ids=lambda o: str(o))
def test_data_efficiency_train_configs_build(override):
    """Progressive layer drop, random-LTD and the legacy seqlen curriculum
    are ported: the dicts that refused before build a config now (a
    top-level `curriculum_learning` block is an unknown key to the JAX
    config too, and is ignored with a warning)."""
    from deepspeed_tpu_torch.config.core import TpuTrainConfig
    cfg = TpuTrainConfig.load({"train_micro_batch_size_per_gpu": 2,
                               **override})
    assert cfg.progressive_layer_drop.enabled == bool(
        override.get("progressive_layer_drop"))
    assert cfg.data_efficiency.enabled == bool(
        override.get("data_efficiency"))


@pytest.mark.parametrize("flags", [dict(dropout=0.1), dict(loss_chunks=4),
                                   dict(chunked_attn_min_seq=1024)],
                         ids=lambda f: str(f))
def test_model_training_flags_build(flags):
    """Dropout (accepted and never applied, as in the JAX package), the
    chunked-vocab CE and the chunked attention build a config now."""
    cfg = GPTConfig(n_layer=2, n_head=4, d_model=64, **flags)
    assert all(getattr(cfg, k) == v for k, v in flags.items())


def test_plain_attention_refuses_a_narrow_softmax_and_layer_drop():
    """A narrow softmax on the plain path raises; layer drop combined with
    random-LTD raises JAX's assertion as a ValueError."""
    import dataclasses
    from deepspeed_tpu_torch.models import gpt
    cfg = dataclasses.replace(TINY, softmax_dtype="bfloat16")
    tokens = torch.zeros((1, 9), dtype=torch.int64)
    params = gpt.init_gpt_params(TINY, seed=0)
    with pytest.raises(NotImplementedError, match="softmax_dtype"):
        gpt.gpt_loss(params, {"tokens": tokens}, cfg=cfg)
    with pytest.raises(ValueError, match="random-LTD"):
        gpt.gpt_hidden(params, tokens, TINY, pld=([0], 0.5),
                       ltd=(1, torch.zeros((1, 1, 8), dtype=torch.int64)))


@pytest.mark.parametrize("dtype,head_dim,want", [
    ("bfloat16", 64, "flash"), ("bfloat16", 128, "flash"),
    ("float16", 128, "flash"), ("float32", 128, None), ("bfloat16", 32, None),
], ids=lambda x: str(x))
def test_train_dispatch_on_cuda_takes_the_kernels_or_raises(dtype, head_dim,
                                                            want):
    """The training forward's site (square, causal; its operands require
    grad, which the flash program differentiates through the backward
    kernels): bf16/fp16 at hd 64/128 selects flash; fp32 or hd 32 raises —
    never the plain attention on the card."""
    site = ad.AttnSite(phase="train", q_len=512, kv_len=512,
                       head_dim=head_dim, kv_dtype=dtype, on_cuda=True)
    if want is None:
        with pytest.raises(NotImplementedError, match="no plain attention"):
            ad.select(site)
    else:
        assert ad.select(site) == want


def test_the_import_scan_covers_the_training_modules():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("runtime/engine.py", "runtime/precision.py",
                   "runtime/lr_schedules.py", "runtime/dataloader.py",
                   "ops/optim.py", "utils/timer.py", "config/core.py"):
        assert f"deepspeed_tpu_torch/{module}" in names


def test_the_import_scan_covers_the_quantization_modules():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("ops/quant.py", "inference/quantization.py",
                   "ops/decode_attention.py", "inference/kv_cache.py"):
        assert f"deepspeed_tpu_torch/{module}" in names


def test_the_import_scan_covers_the_moe_modules():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("parallel/__init__.py", "parallel/moe.py",
                   "moe/__init__.py", "moe/layer.py", "models/moe_gpt.py",
                   "ops/token_sort.py", "ops/norms.py"):
        assert f"deepspeed_tpu_torch/{module}" in names


def test_token_sort_and_norm_wrappers_take_the_plain_version_on_the_cpu():
    from deepspeed_tpu_torch.ops import norms as tno
    from deepspeed_tpu_torch.ops import token_sort as tts
    rng = np.random.default_rng(13)
    op_builder.LAUNCHES.clear()
    idx = torch.from_numpy(rng.integers(-1, 9, 50))
    for got, want in zip(tts.token_sort(idx, 8),
                         tts.token_sort_reference(idx, 8)):
        assert torch.equal(got, want)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    s, b = torch.ones(64), torch.zeros(64)
    assert torch.equal(tno.fused_layer_norm(x, s, b, residual=x),
                       tno.layer_norm_reference(x, s, b, residual=x))
    assert torch.equal(tno.fused_rms_norm(x, s), tno.rms_norm_reference(x, s))
    assert sum(op_builder.LAUNCHES.values()) == 0


class _CudaLike:
    """Stands in for a CUDA tensor on a box without one: the attributes the
    wrappers read before they reach their kernel."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device, self.is_cuda = torch.device("cuda", 0), True

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()


@pytest.mark.parametrize("op", ["token_sort", "fused_layer_norm",
                                "fused_rms_norm"])
def test_token_sort_and_norm_wrappers_never_take_the_plain_version_on_cuda(
        op, monkeypatch):
    """Handed a CUDA tensor, each wrapper goes for its kernel (here the
    library load, which raises) and never to its plain version."""
    from deepspeed_tpu_torch.ops import norms as tno
    from deepspeed_tpu_torch.ops import token_sort as tts

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    def load(name):
        raise RuntimeError(f"kernel library {name} requested")

    for mod, name in ((tts, "token_sort_reference"),
                      (tno, "layer_norm_reference"),
                      (tno, "rms_norm_reference")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(op_builder, "load", load)
    monkeypatch.setattr(tts, "_MAX_EXPERTS", {})
    x = _CudaLike((4, 64), torch.bfloat16)
    s = _CudaLike((64,), torch.float32)
    calls = {"token_sort": lambda: tts.token_sort(
                 _CudaLike((32,), torch.int64), 8),
             "fused_layer_norm": lambda: tno.fused_layer_norm(x, s, s),
             "fused_rms_norm": lambda: tno.fused_rms_norm(x, s)}
    with pytest.raises(RuntimeError, match="kernel library"):
        calls[op]()


class _CudaBuffer(_CudaLike):
    """A `_CudaLike` the norm wrappers can take all the way to their launch:
    contiguous, with an address; a cast is recorded in `casts`."""

    casts = []

    def contiguous(self):
        return self

    def data_ptr(self):
        return id(self)

    def numel(self):
        return int(np.prod(self.shape))

    def new_empty(self, shape, dtype):
        return _CudaBuffer(shape, dtype)

    def float(self):
        _CudaBuffer.casts.append(self.dtype)
        return _CudaBuffer(self.shape, torch.float32)


class _FakeNormEntry:
    """Stands in for the library's `dstt_norm`: records each call's
    arguments and returns 0 (no error)."""
    argtypes = restype = None

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("x_dtype, res_dtype, scale_dtype, bias_dtype", [
    ("bfloat16", None, "bfloat16", "bfloat16"),
    ("bfloat16", "float32", "bfloat16", "bfloat16"),
    ("float16", "bfloat16", "float16", "float16"),
    ("float32", "float16", "bfloat16", "bfloat16"),
    ("bfloat16", None, "float32", "float32"),
    ("bfloat16", None, "bfloat16", "float32"),
])
@pytest.mark.parametrize("D", [100, 768, 12288, 32768])
def test_norm_wrappers_launch_once_on_the_parameters_as_they_are(
        x_dtype, res_dtype, scale_dtype, bias_dtype, D, monkeypatch):
    """On CUDA tensors each norm wrapper launches its kernel once, for any
    last dim up to MAX_DIM, a residual of any of the three dtypes (the
    output in the promoted dtype) and scale / bias in their own dtype: it
    hands the kernel the parameters it was given, with their dtype code,
    and casts nothing, but for a scale and a bias of two dtypes (both
    widened to fp32, exactly)."""
    from deepspeed_tpu_torch.ops import norms as tno
    entry = _FakeNormEntry()
    monkeypatch.setattr(op_builder, "load",
                        lambda name: type("Lib", (), {"dstt_norm": entry}))
    monkeypatch.setattr(op_builder, "stream_ptr", lambda device: None)
    monkeypatch.setattr(tno, "layer_norm_reference", None)
    monkeypatch.setattr(tno, "rms_norm_reference", None)
    _CudaBuffer.casts = []
    op_builder.LAUNCHES.clear()
    dt = lambda name: getattr(torch, name)
    x = _CudaBuffer((2, 3, D), dt(x_dtype))
    res = _CudaBuffer((2, 3, D), dt(res_dtype)) if res_dtype else None
    scale = _CudaBuffer((D,), dt(scale_dtype))
    bias = _CudaBuffer((D,), dt(bias_dtype))
    out_ln = tno.fused_layer_norm(x, scale, bias, 1e-5, residual=res)
    out_rms = tno.fused_rms_norm(x, scale, 1e-5, residual=res)
    want_out = dt(x_dtype) if res is None else \
        torch.promote_types(dt(x_dtype), dt(res_dtype))
    assert out_ln.dtype == out_rms.dtype == want_out
    assert dict(op_builder.LAUNCHES) == {"fused_layer_norm": 1,
                                         "fused_rms_norm": 1}
    code = op_builder.dtype_code
    mixed = scale_dtype != bias_dtype
    for args, rms in zip(entry.calls, (0, 1)):
        (xp, rp, sp, bp, _, rows, d, _, is_rms, x_code, r_code, p_code,
         _) = args
        assert (xp, rows, d, is_rms, x_code) == (id(x), 6, D, rms,
                                                 code(dt(x_dtype)))
        assert rp == (None if res is None else id(res))
        assert r_code == (0 if res is None else code(dt(res_dtype)))
        if rms or not mixed:
            assert sp == id(scale) and p_code == code(dt(scale_dtype))
        else:
            assert sp != id(scale) and bp != id(bias) and p_code == 0
        if not rms and not mixed:
            assert bp == id(bias)
    assert _CudaBuffer.casts == ([dt(scale_dtype), dt(bias_dtype)]
                                 if mixed else [])


@pytest.mark.parametrize("case", ["wider_than_max", "fp64", "residual_shape",
                                  "scale_shape"])
def test_norm_wrappers_refuse_what_the_kernel_does_not_take(case,
                                                            monkeypatch):
    """The wrappers raise before any launch on what the kernel does not
    take: a last dim above MAX_DIM, a dtype outside the three, a residual of
    another shape, a scale that is not [D]."""
    from deepspeed_tpu_torch.ops import norms as tno

    def load(name):
        raise AssertionError(f"kernel library {name} requested")
    monkeypatch.setattr(op_builder, "load", load)
    D = tno.MAX_DIM + 1 if case == "wider_than_max" else 64
    x = _CudaBuffer((4, D), torch.float64 if case == "fp64"
                    else torch.bfloat16)
    res = _CudaBuffer((4, 2 * D) if case == "residual_shape" else (4, D),
                      torch.bfloat16)
    scale = _CudaBuffer((D + 1,) if case == "scale_shape" else (D,),
                        torch.float32)
    with pytest.raises(ValueError):
        tno.fused_layer_norm(x, scale, scale, residual=res)


def _dequant_leaf(shape, g, bits=8, dtype=torch.bfloat16):
    """A `dequantize_many` leaf of CUDA-like buffers: payload [..., D] (int4:
    [..., D/2]) and scales [..., D/g] for a dense shape."""
    D = shape[-1]
    q = _CudaBuffer(shape[:-1] + (D // 2 if bits == 4 else D,), torch.int8)
    s = _CudaBuffer(shape[:-1] + (D // g,), torch.float32)
    return (q, s, dtype, g, bits)


def test_grouped_dequantize_never_takes_the_plain_version_on_cuda(
        monkeypatch):
    """Handed CUDA tensors, `dequantize_many` (and `dequantize`, its
    one-leaf case) goes for the kernel (here the library load, which
    raises) and never to a plain version."""
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    def load(name):
        raise RuntimeError(f"kernel library {name} requested")

    for name in ("dequantize_reference", "dequantize_many_reference"):
        monkeypatch.setattr(tqo, name, refuse)
    monkeypatch.setattr(op_builder, "load", load)
    leaves = [_dequant_leaf((4, 64), 32), _dequant_leaf((2, 3, 128), 64)]
    with pytest.raises(RuntimeError, match="kernel library"):
        tqo.dequantize_many(leaves)
    with pytest.raises(RuntimeError, match="kernel library"):
        tqo.dequantize(*leaves[0])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_grouped_dequantize_is_one_launch_with_each_leafs_operands(
        bits, dtype, monkeypatch):
    """On CUDA tensors one `dequantize_many` call of up to MAX_LEAVES leaves
    is one launch of `dstt_dequantize_many`, handed each leaf's payload,
    scales and output pointers, its element count and its group size, the
    bit width and the output dtype's code; the outputs are [..., D] in that
    dtype. 40 leaves take two launches."""
    entry = _FakeNormEntry()
    monkeypatch.setattr(op_builder, "load", lambda name: type(
        "Lib", (), {"dstt_dequantize_many": entry}))
    monkeypatch.setattr(op_builder, "stream_ptr", lambda device: None)
    monkeypatch.setattr(tqo, "dequantize_reference", None)
    op_builder.LAUNCHES.clear()
    dt = getattr(torch, dtype)
    shapes = [((768, 2304), 64), ((2304,), 64), ((3, 14), 7), ((5, 96), 32)]
    leaves = [_dequant_leaf(shape, g, bits, dt) for shape, g in shapes]
    outs = tqo.dequantize_many(leaves)
    assert dict(op_builder.LAUNCHES) == {f"dequantize_int{bits}": 1}
    (args,) = entry.calls
    k, qp, sp, op, n, g, b, code, _ = args
    assert (k, b, code) == (4, bits, op_builder.dtype_code(dt))
    assert list(qp) == [id(leaf[0]) for leaf in leaves]
    assert list(sp) == [id(leaf[1]) for leaf in leaves]
    assert list(op) == [id(out) for out in outs]
    assert list(n) == [int(np.prod(shape)) for shape, _ in shapes]
    assert list(g) == [g_ for _, g_ in shapes]
    for out, (shape, _) in zip(outs, shapes):
        assert tuple(out.shape) == shape and out.dtype == dt
    tqo.dequantize_many([_dequant_leaf((3, 64), 32, bits, dt)
                         for _ in range(40)])
    assert op_builder.LAUNCHES[f"dequantize_int{bits}"] == 3
    assert [c[0] for c in entry.calls[1:]] == [tqo.MAX_LEAVES,
                                              40 - tqo.MAX_LEAVES]


@pytest.mark.parametrize("case", ["mixed_bits", "mixed_dtypes"])
def test_grouped_dequantize_refuses_mixed_bits_or_dtypes(case, monkeypatch):
    """One launch takes one bit width and one output dtype: a mix raises
    before any library is loaded, on the CPU as on CUDA."""
    def load(name):
        raise AssertionError(f"kernel library {name} requested")
    monkeypatch.setattr(op_builder, "load", load)
    a = _dequant_leaf((4, 64), 32)
    b = _dequant_leaf((4, 64), 32, bits=4) if case == "mixed_bits" else \
        _dequant_leaf((4, 64), 32, dtype=torch.float16)
    with pytest.raises(ValueError, match="one bit width and one output"):
        tqo.dequantize_many([a, b])
    q = torch.zeros(4, 64, dtype=torch.int8)
    s = torch.ones(4, 2)
    cpu = [(q, s, torch.float32, 32, 8),
           (q, s, torch.float32, 32, 4) if case == "mixed_bits"
           else (q, s, torch.bfloat16, 32, 8)]
    with pytest.raises(ValueError, match="one bit width and one output"):
        tqo.dequantize_many(cpu)


def test_flash_and_block_sparse_checks_take_any_batch_times_heads():
    """B * H above 65 535 is taken (the kernels walk B * H * n_t items);
    the other limits still hold (meta tensors: no data, no kernel)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    for B, H in ((4100, 16), (1, 70000)):
        t = torch.empty((B, H, 32, 64), dtype=torch.bfloat16, device="meta")
        tfa.check_kernel_operands(t, t, t)
        tfa.check_kernel_operands(*(x.transpose(1, 2) for x in (t, t, t)),
                                  layout="BTHD")
        tbsa.check_kernel_operands(t, t, t)
    odd = torch.empty((4100, 16, 40, 64), dtype=torch.bfloat16,
                      device="meta")
    with pytest.raises(ValueError, match="not a multiple of 16"):
        tbsa.check_kernel_operands(odd, odd, odd)
    empty = torch.empty((4100, 16, 0, 64), dtype=torch.bfloat16,
                        device="meta")
    with pytest.raises(ValueError, match="out of range"):
        tfa.check_kernel_operands(empty, empty, empty)


def test_cross_rank_expert_dispatch_refuses():
    from deepspeed_tpu_torch.parallel import moe as tmoe
    assert not tmoe.can_use_expert_shard_map(None, 8, 64)
    assert not tmoe.can_use_expert_shard_map(object(), 8, 64)  # one rank
    with pytest.raises(NotImplementedError, match="not ported"):
        tmoe.expert_parallel_moe()


def test_weight_quant_of_an_moe_tree_refuses_when_the_engine_is_built():
    from deepspeed_tpu_torch.models.moe_gpt import (MoEGPTConfig,
                                                    make_moe_gpt_decode_model)
    cfg = MoEGPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=64,
                       vocab_size=128, dtype="float32", num_experts=4)
    conf = {"dtype": "float32", "kv_cache_dtype": "float32",
            "kv_block_size": 16, "max_out_tokens": 64}
    spec = make_moe_gpt_decode_model(cfg, name="moe-tiny")
    with pytest.raises(NotImplementedError, match="MoE tree"):
        init_inference(spec, config={**conf, "quant": {"enabled": True}},
                       device="cpu")
    engine = init_inference(spec, config=conf, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE tree"):
        engine.serving(quantization={"weights": "int8"})


def test_the_import_scan_covers_the_zoo_modules():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("models/bert.py", "models/llama.py", "models/__init__.py",
                   "ops/transformer.py", "inference/adapters.py"):
        assert f"deepspeed_tpu_torch/{module}" in names


def test_the_import_scan_covers_the_offload_modules():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("runtime/swap_tensor.py", "runtime/param_swap.py",
                   "runtime/cpu_optimizer.py", "runtime/offload_staging.py",
                   "runtime/infinity.py", "inference/zero_inference.py",
                   "ops/op_builder.py"):
        assert f"deepspeed_tpu_torch/{module}" in names


def test_the_import_scan_covers_the_sparse_and_evoformer_modules():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for module in ("ops/sparse_attention.py", "ops/block_sparse_attention.py",
                   "ops/evoformer_attn.py"):
        assert f"deepspeed_tpu_torch/{module}" in names


def test_external_attention_program_wins_over_flash():
    """A caller's attn_fn (sparse_attn_fn) takes the training site on every
    device and dtype, above flash, as the JAX package's "external"
    pseudo-program does; it never reaches the flash kernel's refusals."""
    site = lambda **kw: ad.AttnSite(**{**dict(
        phase="train", q_len=512, kv_len=512, head_dim=64,
        kv_dtype="bfloat16", on_cuda=True, external_fn=True), **kw})
    assert ad.registered_programs("train")[0].name == "external"
    assert ad.select(site()) == "external"
    assert ad.select(site(kv_dtype="float32", head_dim=32)) == "external"
    assert ad.select(site(on_cuda=False)) == "external"
    assert ad.select(site(external_fn=False)) == "flash"
    assert ad.select(site(phase="decode", q_len=1)) == "decode_kernel"


@pytest.mark.parametrize("case", ["sparse_fp32", "sparse_hd32",
                                  "self_attention_rpe_shape",
                                  "evoformer_hd16", "evoformer_fp64"])
def test_sparse_and_evoformer_sites_the_kernels_refuse_raise_on_cuda(
        case, monkeypatch):
    """Handed CUDA operands the kernels do not take (fp32 or head dim 32
    for block-sparse; an rpe of no supported shape; head dim 16 or fp64 for
    evoformer), the ops raise; no plain version runs and no kernel library
    is loaded."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    from deepspeed_tpu_torch.ops import evoformer_attn as tevo
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    def load(name):
        raise AssertionError(f"kernel library {name} requested")

    for mod, name in ((tbsa, "_reference_fwd"), (tbsa, "_reference_bwd"),
                      (tevo, "_reference_fwd"), (tsa.SparseSelfAttention,
                                                 "_dense")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(op_builder, "load", load)
    layout = np.tril(np.ones((4, 8, 8), bool))
    if case.startswith("sparse"):
        dtype, hd = (torch.float32, 64) if case == "sparse_fp32" \
            else (torch.bfloat16, 32)
        q = _CudaLike((1, 4, 128, hd), dtype)
        with pytest.raises(ValueError, match="the kernels take"):
            tbsa.block_sparse_attention(q, q, q, layout, causal=True)
    elif case == "self_attention_rpe_shape":
        q = _CudaLike((2, 4, 128, 64), torch.bfloat16)
        attn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(num_heads=4))
        with pytest.raises(NotImplementedError, match="no dense attention"):
            attn(q, q, q, rpe=torch.zeros(2, 4, 128, 128))
    else:
        dtype, hd = (torch.bfloat16, 16) if case == "evoformer_hd16" \
            else (torch.float64, 32)
        q = _CudaLike((1, 2, 40, 4, hd), dtype)
        with pytest.raises(ValueError, match="the kernel takes"):
            tevo.evoformer_attention(q, q, q)


def test_curriculum_data_loader_refuses_with_the_sampler_named():
    """The metric-driven curriculum loader needs the data sampler, which
    is not ported; the legacy seqlen curriculum is the engine's."""
    from deepspeed_tpu_torch.runtime.dataloader import CurriculumDataLoader
    with pytest.raises(NotImplementedError, match="curriculum_metrics"):
        CurriculumDataLoader([], 2, sampler=None)


def test_top_level_names_the_port_has_resolve_as_in_jax():
    """Every name of the JAX package's `__all__` that the port has ported
    resolves at the port's top level (the aliases to the same objects),
    with `ServingRouter` beside them; the rest are listed and absent."""
    import deepspeed_tpu
    import deepspeed_tpu_torch as port
    unported = {"default_inference_config", "add_config_arguments",
                "add_tuning_arguments", "HybridEngine",
                "DeepSpeedHybridEngine", "checkpointing", "OnDevice", "zero",
                "get_accelerator", "__version__"}
    for name in deepspeed_tpu.__all__:
        if name in unported:
            assert name not in port.__all__
            continue
        assert name in port.__all__, name
        assert getattr(port, name) is not None, name
    assert port.DeepSpeedEngine is port.Engine
    assert port.DeepSpeedConfig is port.TpuTrainConfig
    assert port.DeepSpeedInferenceConfig is port.TpuInferenceConfig
    from deepspeed_tpu_torch.serving.router import ServingRouter
    assert port.ServingRouter is ServingRouter
    assert port.comm.init_distributed is port.init_distributed
    assert len(port.__all__) == 18
