"""The port's checkpoints (`deepspeed_tpu_torch/checkpoint/`) held to the
JAX package's: the same on-disk names as JAX's numpy engine, a JAX
checkpoint resuming in the port, universal checkpoints crossing both ways,
`zero_to_fp32` (also as the standalone copy next to `latest`), the
Megatron state-dict loader, and the port's own round trips, bit for bit.

A 2-layer GPT of d_model 64, fp32 on the CPU, from one numpy draw; the JAX
engine runs on a one-device mesh. Tolerance across packages: 1e-5 on the
next step's loss and on every state leaf (fp32 on both sides; XLA and
PyTorch's CPU kernels sum in other orders). Within the port: bit-equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import state_dict_factory as jsdf
from deepspeed_tpu.checkpoint import universal as juni
from deepspeed_tpu.checkpoint import zero_to_fp32 as jz2f
from deepspeed_tpu.checkpoint.saver import _key_path_str
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import manifest as tmanifest
from deepspeed_tpu_torch.checkpoint import saver as tsaver
from deepspeed_tpu_torch.checkpoint import state_dict_factory as tsdf
from deepspeed_tpu_torch.checkpoint import universal as tuni
from deepspeed_tpu_torch.checkpoint import zero_to_fp32 as tz2f
from deepspeed_tpu_torch.models import gpt as tgpt

JCFG = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=128,
                      max_seq_len=64, vocab_size=128, dtype=jnp.float32,
                      remat=False)
TOL = 1e-5
CONFIG = {"train_micro_batch_size_per_gpu": 4,
          "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 3e-3, "weight_decay": 0.1}},
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_min_lr": 1e-4,
                                   "warmup_max_lr": 3e-3,
                                   "warmup_num_steps": 3}}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A 2-layer d_model-64 step is faster on one CPU thread than on a
    contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg, dtype="float32"):
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name not in ("dtype", "softmax_dtype", "remat",
                               "remat_policy", "use_flash_attention")]
    return tgpt.GPTConfig(**{n: getattr(jcfg, n) for n in names
                             if hasattr(jcfg, n)}, dtype=dtype)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 128, (8, 17)).astype(np.int32)}
            for _ in range(n)]


BATCHES = _batches(3, seed=11)


def _reset_mesh():
    mesh_mod.clear_mesh()
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _jax_engine(np_params, **over):
    _reset_mesh()
    spec = jgpt.make_gpt_model(cfg=JCFG, name="tiny")
    spec = dataclasses.replace(spec, params=jax.tree_util.tree_map(
        jnp.asarray, np_params))
    eng, *_ = deepspeed_tpu.initialize(
        model=spec, config={**CONFIG, "mesh": {"data": 1}, **over})
    return eng


def _port_engine(np_params, dtype="float32", **over):
    cfg = _port_cfg(JCFG, dtype)
    eng, *_ = initialize(
        model=tgpt.make_gpt_model(cfg, name="tiny",
                                  params=tgpt.params_from_jax(np_params)),
        config={**CONFIG, **over}, device="cpu")
    return eng


def _jax_named(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {_key_path_str(p): np.asarray(jax.device_get(x)) for p, x in flat}


def _port_named(eng):
    return {n: (v.detach().float().numpy() if v.is_floating_point()
                else v.numpy()).copy() for n, v in eng.checkpoint_leaves()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine: 2 steps, a numpy-engine save and a universal save,
    then step 3 (its loss and state are what the port must reach)."""
    root = tmp_path_factory.mktemp("jax_run")
    spec = jgpt.make_gpt_model(cfg=JCFG, name="tiny", seed=5)
    np_params = jax.tree_util.tree_map(np.asarray, spec.params)
    jeng = _jax_engine(np_params, checkpoint={"engine": "numpy"})
    for b in BATCHES[:2]:
        jeng.train_batch(b)
    jeng.save_checkpoint(str(root / "ckpt"))
    juni.save_universal_checkpoint(jeng, str(root / "uni"))
    loss3 = float(jeng.train_batch(BATCHES[2]))
    yield dict(root=root, params=np_params, loss3=loss3,
               state3=_jax_named(jeng.state))
    mesh_mod.clear_mesh()


def _assert_step3(teng, jax_run):
    loss = float(teng.train_batch(BATCHES[2]))
    assert abs(loss - jax_run["loss3"]) <= TOL
    want = jax_run["state3"]
    got = _port_named(teng)
    assert set(got) == set(want) - {"rng"}
    for name, value in got.items():
        np.testing.assert_allclose(value, want[name], atol=TOL, rtol=0,
                                   err_msg=name)


def test_jax_numpy_checkpoint_resumes_in_the_port(jax_run):
    """JAX numpy engine, 2 steps -> the port loads it (its `rng` leaf
    dropped) and takes step 3: loss and every leaf within 1e-5 of JAX's
    step 3; the counters come back through client.json."""
    teng = _port_engine(jax_run["params"], checkpoint={"engine": "numpy"})
    path, client = teng.load_checkpoint(str(jax_run["root"] / "ckpt"))
    assert path.endswith("global_step2")
    assert client["global_steps"] == teng.global_steps == 2
    assert teng.lr_scheduler.last_step == 2
    _assert_step3(teng, jax_run)


def test_jax_universal_checkpoint_loads_into_the_port(jax_run):
    teng = _port_engine(jax_run["params"])
    meta = tuni.load_universal_checkpoint(teng,
                                          str(jax_run["root"] / "uni"))
    assert meta["has_optimizer_state"] and teng.global_steps == 2
    _assert_step3(teng, jax_run)


def test_port_checkpoint_crosses_to_jax_through_universal(jax_run, tmp_path):
    """The port's numpy engine -> JAX's offline converter -> JAX's
    universal loader: JAX's next step has the port's next loss. The port's
    converter writes the same artifact as JAX's on that dir."""
    teng = _port_engine(jax_run["params"], checkpoint={"engine": "numpy"})
    for b in BATCHES[:2]:
        teng.train_batch(b)
    teng.save_checkpoint(str(tmp_path / "ckpt"))
    port_loss3 = float(teng.train_batch(BATCHES[2]))
    juni.convert_checkpoint_to_universal(str(tmp_path / "ckpt"),
                                         str(tmp_path / "j"))
    tuni.convert_checkpoint_to_universal(str(tmp_path / "ckpt"),
                                         str(tmp_path / "t"))
    files = [tuni.UNIVERSAL_FILE, tuni.META_FILE]
    j, t = (tmp_path / "j" / "universal", tmp_path / "t" / "universal")
    with np.load(j / files[0]) as a, np.load(t / files[0]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert json.loads((j / files[1]).read_text()) == \
        json.loads((t / files[1]).read_text())
    jeng = _jax_engine(jax_run["params"])
    juni.load_universal_checkpoint(jeng, str(tmp_path / "j"))
    assert jeng.global_steps == 0 and int(jeng.state.step) == 2
    assert abs(float(jeng.train_batch(BATCHES[2])) - port_loss3) <= TOL


def test_universal_save_matches_jax_names_and_meta(jax_run, tmp_path):
    """The port's `save_universal_checkpoint` of the state JAX saved: the
    same flat names, values and meta fields as JAX's artifact."""
    teng = _port_engine(jax_run["params"], checkpoint={"engine": "numpy"})
    teng.load_checkpoint(str(jax_run["root"] / "ckpt"))
    tuni.save_universal_checkpoint(teng, str(tmp_path))
    mine = tuni.get_fp32_state_dict_from_universal(str(tmp_path))
    theirs = juni.get_fp32_state_dict_from_universal(
        str(jax_run["root"] / "uni"))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    m = json.loads((tmp_path / "universal" / tuni.META_FILE).read_text())
    j = json.loads((jax_run["root"] / "uni" / "universal" /
                    juni.META_FILE).read_text())
    assert m == j


def test_zero_to_fp32_matches_jax_and_runs_standalone(jax_run, tmp_path):
    """The port's torch-engine dir of the state JAX saved gives JAX's fp32
    dict exactly; the copy shipped next to `latest` runs as a subprocess
    (numpy and torch only, outside the repo)."""
    teng = _port_engine(jax_run["params"], checkpoint={"engine": "numpy"})
    teng.load_checkpoint(str(jax_run["root"] / "ckpt"))
    teng.config.checkpoint.engine = "torch"
    teng._ckpt_engine = None
    teng.save_checkpoint(str(tmp_path / "ckpt"))
    mine = tz2f.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "ckpt"))
    theirs = jz2f.get_fp32_state_dict_from_zero_checkpoint(
        str(jax_run["root"] / "ckpt"))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    # the port's reader also takes JAX's numpy dir
    same = tz2f.get_fp32_state_dict_from_zero_checkpoint(
        str(jax_run["root"] / "ckpt"))
    assert all(np.array_equal(same[k], theirs[k]) for k in theirs)
    script = tmp_path / "ckpt" / "zero_to_fp32.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "ckpt"),
                          str(tmp_path / "fp32.npz")], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["num_params"] == \
        len(theirs)
    with np.load(tmp_path / "fp32.npz") as z:
        for k in theirs:
            np.testing.assert_array_equal(z[k], theirs[k])


def test_orbax_state_dir_raises_naming_the_engine(tmp_path):
    state = tmp_path / "t" / "state"
    state.mkdir(parents=True)
    (tmp_path / "t" / "manifest.json").write_text(
        json.dumps({"engine": "OrbaxCheckpointEngine"}))
    with pytest.raises(ValueError, match="OrbaxCheckpointEngine"):
        tz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path), tag="t")


_LAYOUTS = [
    ("AdamW", {}, True, "float32"), ("AdamW", {}, True, "bfloat16"),
    ("Adam", {}, False, "float32"), ("Lion", {}, True, "float32"),
    ("Lamb", {}, True, "float32"), ("SGD", {}, True, "float32"),
    ("SGD", {"momentum": 0.9}, False, "float32"),
    ("Adagrad", {}, False, "float32")]


@pytest.mark.parametrize("opt,params,schedule,dtype", _LAYOUTS,
                         ids=[f"{o}-{'m' if p else ''}"
                              f"{'sched' if s else 'const'}-{d}"
                              for o, p, s, d in _LAYOUTS])
def test_numpy_engine_writes_jax_names(opt, params, schedule, dtype,
                                       tmp_path):
    """keys.json and the manifest's tree of the port's numpy engine are
    JAX's for the same model and optimizer (but JAX's `rng` leaf): optax's
    chain indices, the schedule's count, master only under bf16."""
    spec = jgpt.make_gpt_model(cfg=JCFG, name="tiny", seed=1)
    np_params = jax.tree_util.tree_map(np.asarray, spec.params)
    over = {"optimizer": {"type": opt, "params": {"lr": 1e-3, **params}},
            "checkpoint": {"engine": "numpy"}}
    if not schedule:
        over["scheduler"] = None
    if dtype == "bfloat16":
        over["bf16"] = {"enabled": True}
    cfg = {**CONFIG, **over}
    if cfg["scheduler"] is None:
        del cfg["scheduler"]
    _reset_mesh()
    jspec = dataclasses.replace(spec, params=jax.tree_util.tree_map(
        jnp.asarray, np_params))
    jeng, *_ = deepspeed_tpu.initialize(model=jspec,
                                        config={**cfg, "mesh": {"data": 1}})
    jeng.save_checkpoint(str(tmp_path / "j"), tag="t")
    teng, *_ = initialize(
        model=tgpt.make_gpt_model(_port_cfg(JCFG, dtype), name="tiny",
                                  params=tgpt.params_from_jax(np_params)),
        config=cfg, device="cpu")
    teng.save_checkpoint(str(tmp_path / "p"), tag="t")
    keys = [json.loads((tmp_path / s / "t" / "state" / "keys.json")
                       .read_text()) for s in ("j", "p")]
    assert keys[1] == [k for k in keys[0] if k != "rng"]
    trees = [tmanifest.read_manifest(tmp_path / s / "t")["tree"]
             for s in ("j", "p")]
    assert trees[1] == [e for e in trees[0] if e["key"] != "rng"]
    mesh_mod.clear_mesh()


def _round_trip(tmp_path, engine_kind, **over):
    rng = np.random.default_rng(2)
    np_params = jax.tree_util.tree_map(
        np.asarray, jgpt.init_gpt_params(JCFG, seed=2))
    dtype = "bfloat16" if over.get("bf16") else "float32"
    eng = _port_engine(np_params, dtype=dtype,
                       checkpoint={"engine": engine_kind}, **over)
    batches = [{"tokens": rng.integers(0, 128, (8, 9)).astype(np.int32)}
               for _ in range(3)]
    eng.train_batch(batches[0])
    eng.save_checkpoint(str(tmp_path))
    saved = _port_named(eng)
    ref = [float(eng.train_batch(b)) for b in batches[1:]]
    ref_state = _port_named(eng)
    homes = {n: v.data_ptr() for n, v in eng.checkpoint_leaves()}
    path, client = eng.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and eng.global_steps == 1
    # the load copies each leaf into the engine's own tensor (the device
    # tier's state is never built a second time where it lives); the host
    # step's lists are its C++ optimizer's, which copies them in
    moved = {n for n, v in eng.checkpoint_leaves() if v.data_ptr() != homes[n]}
    assert moved <= ({n for n in homes if n.startswith(("master/",
                                                        "opt_state/"))}
                     if eng.host_step else set()), sorted(moved)[:4]
    restored = _port_named(eng)
    for name in saved:
        np.testing.assert_array_equal(restored[name], saved[name],
                                      err_msg=name)
    assert [float(eng.train_batch(b)) for b in batches[1:]] == ref
    after = _port_named(eng)
    assert all(np.array_equal(after[n], ref_state[n]) for n in ref_state)
    return eng


_TIERS = {"fp32": {}, "bf16_master": {"bf16": {"enabled": True}},
          "host_step": {"bf16": {"enabled": True},
                        "zero_optimization": {"offload_optimizer": {
                            "device": "cpu"}},
                        "zero_force_ds_cpu_optimizer": True}}


@pytest.mark.parametrize("engine_kind,tier", [
    ("torch", "fp32"), ("torch", "bf16_master"), ("torch", "host_step"),
    ("numpy", "bf16_master"), ("numpy", "host_step")])
def test_round_trip_is_bit_exact(engine_kind, tier, tmp_path):
    """Save after 1 step, take 2 more, load, take the same 2 again: every
    restored leaf equals the saved one bit for bit, and the resumed losses
    and state equal the uninterrupted run's — the host step's C++ masters
    and moments included."""
    eng = _round_trip(tmp_path, engine_kind, **_TIERS[tier])
    if tier == "host_step":
        assert eng.host_step and eng.state.master is None


def test_partial_loads(tmp_path):
    """load_module_only restores params and master only;
    load_optimizer_states=False adds step and scaler, not the moments."""
    rng = np.random.default_rng(4)
    np_params = jax.tree_util.tree_map(
        np.asarray, jgpt.init_gpt_params(JCFG, seed=4))
    eng = _port_engine(np_params, dtype="bfloat16", bf16={"enabled": True})
    batch = {"tokens": rng.integers(0, 128, (8, 17)).astype(np.int32)}
    eng.train_batch(batch)
    eng.save_checkpoint(str(tmp_path))
    saved = _port_named(eng)
    eng.train_batch(batch)
    moved = _port_named(eng)
    for kw, kept in (({"load_module_only": True}, ("params/", "master/")),
                     ({"load_optimizer_states": False},
                      ("params/", "master/", "step", "scaler/"))):
        eng.train_batch(batch)
        before = _port_named(eng)
        eng.load_checkpoint(str(tmp_path), **kw)
        now = _port_named(eng)
        for name in saved:
            want = saved[name] if name.startswith(kept) else before[name]
            np.testing.assert_array_equal(now[name], want, err_msg=name)
    assert not np.array_equal(moved["opt_state/0/mu/wte"],
                              saved["opt_state/0/mu/wte"])


def test_async_save_and_orbax_refusal(tmp_path):
    np_params = jax.tree_util.tree_map(
        np.asarray, jgpt.init_gpt_params(JCFG, seed=6))
    eng = _port_engine(np_params, checkpoint={"engine": "torch",
                                              "async_save": True})
    eng.train_batch(BATCHES[0])
    eng.save_checkpoint(str(tmp_path), tag="a1")
    assert isinstance(eng._ckpt_engine, tsaver.AsyncCheckpointEngine)
    saved = _port_named(eng)
    eng.train_batch(BATCHES[1])          # steps while the write runs
    tsaver.wait_pending_save(eng)
    assert tmanifest.is_committed(tmp_path / "a1")
    assert (tmp_path / "latest").read_text().strip() == "a1"
    eng.load_checkpoint(str(tmp_path))
    now = _port_named(eng)
    assert all(np.array_equal(now[n], saved[n]) for n in saved)
    eng = _port_engine(np_params, checkpoint={"engine": "orbax"})
    with pytest.raises(NotImplementedError, match="'torch'.*'numpy'"):
        eng.save_checkpoint(str(tmp_path / "o"))


def _shards(rng, names, n=2):
    full = {name: rng.standard_normal(shape).astype(np.float32)
            for name, shape in names.items()}
    return full, [jsdf.SDLoaderBase().split_state_dict(full, n, r)
                  for r in range(n)]


@pytest.mark.parametrize("kind", ["generic", "megatron-v0", "megatron-v2"])
def test_state_dict_factory_is_jax_byte_for_byte(kind):
    """merge, split and reshard 2 -> 4 of packed / interleaved qkv give
    JAX's arrays byte for byte."""
    rng = np.random.default_rng(7)
    if kind == "generic":
        names = {"h.0.attn.qkv.kernel": (16, 48), "h.0.attn.qkv.bias": (48,),
                 "h.0.attn.out.kernel": (16, 16), "h.0.mlp.fc_in.kernel":
                 (16, 64), "h.0.mlp.fc_out.kernel": (64, 16),
                 "embed.weight": (32, 16), "ln_f.scale": (16,)}
        make = (lambda m: m.SDLoaderFactory.get_sd_loader("generic"))
    else:
        names = {"layers.0.self_attention.query_key_value.weight": (48, 16),
                 "layers.0.self_attention.query_key_value.bias": (48,),
                 "layers.0.self_attention.dense.weight": (16, 16),
                 "layers.0.mlp.dense_h_to_4h.weight": (64, 16),
                 "layers.0.mlp.dense_4h_to_h.weight": (16, 64),
                 "word_embeddings.weight": (32, 16)}
        version = 0 if kind.endswith("v0") else 2.0
        make = (lambda m: m.SDLoaderFactory.get_sd_loader(
            "megatron", num_heads=4, version=version))
    _, shards = _shards(rng, names)
    j, t = make(jsdf), make(tsdf)
    outs = [(j.merge_state_dicts(shards), t.merge_state_dicts(shards)),
            (j.split_state_dict(shards[0], 4, 1),
             t.split_state_dict(shards[0], 4, 1))]
    outs += list(zip(j.reshard(shards, 4), t.reshard(shards, 4)))
    for a, b in outs:
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
