"""The PyTorch port's ZeRO-Infinity trainer (`runtime/infinity.py`) held to
the JAX package's `InfinityEngine`: the same numpy-seeded weights and
batches, fp32 on the CPU, on both weight tiers (host RAM and NVMe through
the AIO library, with the moments on NVMe too).

Tolerances (fp32 on both sides; XLA and PyTorch's CPU kernels sum in other
orders; the host step is the same C++): losses atol 1e-5, the fp32 masters
atol 1e-4 after 3 steps. Across look-ahead depths the port's losses and
masters are bit-identical (the streaming changes when weights move, not
what is computed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime.infinity import InfinityEngine as JInfinity
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.runtime.infinity import InfinityEngine

JCFG = jgpt.GPTConfig(n_layer=3, n_head=4, d_model=64, d_ff=128,
                      max_seq_len=64, vocab_size=128, dtype=jnp.float32,
                      remat=False)
TCFG = tgpt.GPTConfig(n_layer=3, n_head=4, d_model=64, d_ff=128,
                      max_seq_len=64, vocab_size=128, dtype="float32",
                      remat=False)
LOSS_ATOL = 1e-5
MASTER_ATOL = 1e-4


def _params(seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt.init_gpt_params(JCFG, seed=seed))


def _batches(n, B=4, T=17, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 128, (B, T)).astype(np.int32)}
            for _ in range(n)]


def _pair(params, tmp_path, tier, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if tier == "nvme":
        for side, d in ((jkw, "j"), (tkw, "t")):
            side.update(offload_device="nvme",
                        nvme_path=str(tmp_path / d / "w"),
                        optimizer_nvme_path=str(tmp_path / d / "opt"))
    jeng = JInfinity(jgpt.make_gpt_layered_model(cfg=JCFG, params=params),
                     dtype=jnp.float32, **jkw)
    teng = InfinityEngine(
        tgpt.make_gpt_layered_model(TCFG, params=tgpt.params_from_jax(params)),
        dtype=torch.float32, device="cpu", **tkw)
    return jeng, teng


def _masters(eng):
    out = [np.asarray(m) for o in eng.layer_opts for m in o.master]
    return out + [np.asarray(m) for m in eng.resident_opt.master]


def _assert_same_trajectory(jeng, teng, batches):
    for b in batches:
        np.testing.assert_allclose(teng.train_batch(b), jeng.train_batch(b),
                                   atol=LOSS_ATOL, rtol=0)
    for a, b in zip(_masters(teng), _masters(jeng)):
        np.testing.assert_allclose(a, b, atol=MASTER_ATOL, rtol=0)


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_three_step_trajectory_matches_jax(tier, tmp_path):
    jeng, teng = _pair(_params(), tmp_path, tier, lr=1e-3,
                       weight_decay=0.01)
    _assert_same_trajectory(jeng, teng, _batches(3))
    assert teng.offload_stats()["write_flushes"] == \
        jeng.offload_stats()["write_flushes"]
    jeng.release()
    teng.release()


def _port_run(params, lookahead, landing_depth=None, **kw):
    eng = InfinityEngine(
        tgpt.make_gpt_layered_model(TCFG, params=tgpt.params_from_jax(params)),
        dtype=torch.float32, device="cpu", lr=1e-2, lookahead=lookahead,
        landing_depth=landing_depth, **kw)
    losses = [eng.train_batch(b) for b in _batches(3)]
    return losses, _masters(eng), eng


def test_lookahead_depths_are_bit_identical():
    params = _params(1)
    base_losses, base_masters, eng = _port_run(params, 0, 1)
    assert eng.streamer.peak_live_layers == 1
    for la in (1, 2):
        losses, masters, eng = _port_run(params, la)
        assert losses == base_losses
        assert all(np.array_equal(a, b)
                   for a, b in zip(masters, base_masters))
        assert eng.streamer.peak_live_layers <= la + 1


def test_gas_matches_one_big_batch():
    """gas 2 over a batch of 8 rows takes the mean gradient of its two
    micro-batches: the step equals gas 1 on the same 8 rows, up to the
    order of the sums (Adam's first step divides a gradient by its own
    magnitude, so an element with |g| near eps moves by up to lr x its
    relative error: atol 1e-5 at lr 1e-3)."""
    params = _params(2)
    batch = _batches(1, B=8)[0]
    masters = []
    for gas in (1, 2):
        eng = InfinityEngine(
            tgpt.make_gpt_layered_model(TCFG,
                                        params=tgpt.params_from_jax(params)),
            dtype=torch.float32, device="cpu", lr=1e-3,
            gradient_accumulation_steps=gas)
        eng.train_batch(batch)
        masters.append(_masters(eng))
    for a, b in zip(*masters):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_gradient_clipping_matches_jax(tmp_path):
    jeng, teng = _pair(_params(3), tmp_path, "cpu", lr=1e-3,
                       gradient_clipping=0.05)
    _assert_same_trajectory(jeng, teng, _batches(3))
    np.testing.assert_allclose(teng.last_grad_norm, jeng.last_grad_norm,
                               rtol=1e-5)
    assert teng.last_grad_norm > 0.05        # the clip engaged


def test_fp16_loss_scaling_matches_jax(tmp_path):
    """fp16 dynamic scaling: an injected huge scale overflows, the step is
    skipped and the scale halves (hysteresis 1), in both packages."""
    kw = dict(lr=1e-3, fp16=True, hysteresis=1, initial_scale_power=8)
    jeng, teng = _pair(_params(4), tmp_path, "cpu", **kw)
    # fp32 compute keeps the flats finite; force the overflow path with a
    # scale fp32 cannot carry through the head's seed
    for eng in (jeng, teng):
        eng.cur_scale = 2.0 ** 127
    for b in _batches(3):
        np.testing.assert_allclose(teng.train_batch(b), jeng.train_batch(b),
                                   atol=LOSS_ATOL, rtol=0)
        assert teng.cur_scale == jeng.cur_scale
        assert teng.skipped_steps == jeng.skipped_steps
    assert teng.skipped_steps >= 1
    for a, b in zip(_masters(teng), _masters(jeng)):
        np.testing.assert_allclose(a, b, atol=MASTER_ATOL, rtol=0)


def _config(tmp_path, **zero):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
            "zero_optimization": {"stage": 3, **zero}}


def test_initialize_routes_a_layered_spec_and_feeds_the_dataloader(tmp_path):
    params = _params(5)
    spec = tgpt.make_gpt_layered_model(TCFG,
                                       params=tgpt.params_from_jax(params))
    data = [{"tokens": t} for t in _batches(1, B=16)[0]["tokens"]]
    eng, opt, loader, sched = initialize(
        model=spec, training_data=data, device="cpu",
        config=_config(tmp_path, offload_param={
            "device": "nvme", "nvme_path": str(tmp_path / "w"),
            "lookahead": 2}, offload_optimizer={
            "device": "nvme", "nvme_path": str(tmp_path / "o")}))
    assert isinstance(eng, InfinityEngine) and opt is None and sched is None
    assert eng.gas == 2 and eng.micro_batch_size == 2
    assert eng.streamer.lookahead == 2
    assert eng.layer_opts[0].nvme is not None
    assert eng.store.device == "nvme"
    losses = [eng.train_batch() for _ in range(4)]
    assert np.isfinite(losses).all()
    assert len(loader) == 4 and eng.step_count == 4


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_initialize_hands_the_checkpoint_block_to_the_tier(engine, tmp_path):
    """The `checkpoint` block reaches a layered spec's engine, as the JAX
    package's `initialize` passes it: its engine writes the state, and
    `keep_last_n: 1` retention leaves only the newest tag."""
    spec = tgpt.make_gpt_layered_model(
        TCFG, params=tgpt.params_from_jax(_params(9)))
    config = _config(tmp_path, offload_param={"device": "cpu"})
    config["checkpoint"] = {"engine": engine, "keep_last_n": 1}
    eng, *_ = initialize(model=spec, config=config, device="cpu")
    save_dir = tmp_path / "ckpt"
    for b in _batches(2, seed=9):
        eng.train_batch(b)
        eng.save_checkpoint(str(save_dir))
    tags = sorted(p.name for p in save_dir.iterdir() if p.is_dir())
    assert tags == ["global_step2"]
    state_file = {"torch": "state.pt", "numpy": "state.npz"}[engine]
    assert (save_dir / "global_step2" / "state" / state_file).exists()
    path, client = eng.load_checkpoint(str(save_dir))
    assert path.endswith("global_step2") and client["global_steps"] == 2
    eng.release()


@pytest.mark.parametrize("case", ["no_offload", "optimizer", "params",
                                  "scheduler", "lamb"])
def test_initialize_refuses_what_jax_asserts(case, tmp_path):
    spec = tgpt.make_gpt_layered_model(
        TCFG, params=tgpt.params_from_jax(_params()))
    config = _config(tmp_path, offload_param={"device": "cpu"})
    kw = {}
    if case == "no_offload":
        config = _config(tmp_path)
        match = "trains via the Infinity tier"
    elif case == "optimizer":
        kw["optimizer"] = object()
        match = "builds its host optimizers"
    elif case == "params":
        kw["model_parameters"] = {}
        match = "model_parameters is not"
    elif case == "scheduler":
        kw["lr_scheduler"] = object()
        match = "builds its host optimizers"
    else:
        config["optimizer"] = {"type": "Lamb"}
        match = "not lamb"
    with pytest.raises(ValueError, match=match):
        initialize(model=spec, config=config, device="cpu", **kw)


def test_streamed_weights_stay_within_lookahead_plus_one_layers():
    """The weight-byte bound: whatever the depth, the device never holds
    more than lookahead + 1 layers of streamed weights."""
    cfg6 = tgpt.GPTConfig(n_layer=6, n_head=4, d_model=64, d_ff=128,
                          max_seq_len=64, vocab_size=128, dtype="float32")
    for la in (0, 1, 2):
        eng = InfinityEngine(tgpt.make_gpt_layered_model(cfg6),
                             dtype=torch.float32, device="cpu",
                             lookahead=la)
        eng.train_batch(_batches(1)[0])
        assert eng.streamer.peak_live_layers <= la + 1
        assert eng.peak_param_hbm_bytes <= (la + 1) * eng.store.layer_bytes
        assert eng.peak_param_hbm_bytes * 2 <= eng.store.host_bytes


def test_checkpoints_and_memory_plan_name_their_items(tmp_path):
    """Checkpoints (ROADMAP item 6) and the memory plan (item 10) of this
    tier are ported: save -> train on -> load -> the same step again is
    bit-identical, and `memory_plan()` is JAX's `plan_training_from_infinity`
    field for field on the same tier."""
    jeng, eng = _pair(_params(8), tmp_path, "cpu", lr=1e-3)
    batches = _batches(3, seed=8)
    eng.train_batch(batches[0])
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    ref = [eng.train_batch(b) for b in batches[1:]]
    ref_masters = _masters(eng)
    path, client = eng.load_checkpoint(str(tmp_path / "ckpt"))
    assert path.endswith("global_step1") and client["global_steps"] == 1
    assert eng.step_count == 1
    assert [eng.train_batch(b) for b in batches[1:]] == ref
    assert all(np.array_equal(a, b)
               for a, b in zip(_masters(eng), ref_masters))
    want = jeng.memory_plan(capacity_bytes=1 << 30).to_dict()
    assert eng.memory_plan(capacity_bytes=1 << 30).to_dict() == want
    jeng.release()
    eng.release()


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_state_moves_the_trained_tier_to_another_engine(tier, tmp_path):
    """`state` (the masters, moments and the loss-scale bookkeeping) set on
    a fresh engine rebuilds its store from the masters: the next step is
    the trained engine's, bit for bit."""
    params = _params(6)
    kw = {}
    engines = []
    for side in ("a", "b"):
        if tier == "nvme":
            kw = dict(offload_device="nvme",
                      nvme_path=str(tmp_path / side / "w"),
                      optimizer_nvme_path=str(tmp_path / side / "o"))
        engines.append(InfinityEngine(
            tgpt.make_gpt_layered_model(TCFG,
                                        params=tgpt.params_from_jax(params)),
            dtype=torch.float32, device="cpu", lr=1e-3, **kw))
    a, b = engines
    batches = _batches(3, seed=6)
    for batch in batches[:2]:
        a.train_batch(batch)
    b.state = a.state
    assert b.step_count == 2
    assert b.train_batch(batches[2]) == a.train_batch(batches[2])
    assert all(np.array_equal(x, y) for x, y in zip(_masters(a),
                                                    _masters(b)))


@pytest.mark.parametrize("loss_chunks", [0, 4])
def test_the_layered_loss_is_gpt_loss(loss_chunks):
    """The layered spec's embed, per-layer and loss functions compose to
    `gpt_loss` of the same weights and batch, `loss_chunks` honoured
    (both take `_causal_lm_nll`), with the same head and layer gradients
    (fp32, 1e-6)."""
    import dataclasses
    cfg = dataclasses.replace(TCFG, loss_chunks=loss_chunks)
    params = tgpt.params_from_jax(_params(9))
    spec = tgpt.make_gpt_layered_model(cfg, params=params)
    tokens = torch.from_numpy(_batches(1, seed=9)[0]["tokens"]).long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    B, T = inputs.shape
    positions = torch.arange(T).expand(B, T)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()
              if k != "blocks"}
    blocks = {k: v.clone().requires_grad_()
              for k, v in params["blocks"].items()}
    x = spec.embed_fn(leaves, inputs, positions)
    for i in range(cfg.n_layer):
        x = spec.layer_train_fn({k: v[i] for k, v in blocks.items()}, x,
                                positions)
    layered = spec.train_loss_fn(leaves, x, labels)
    ref_params = {k: v.clone().requires_grad_()
                  for k, v in params.items() if k != "blocks"}
    ref_blocks = {k: v.clone().requires_grad_()
                  for k, v in params["blocks"].items()}
    ref = tgpt.gpt_loss({**ref_params, "blocks": ref_blocks},
                        {"tokens": tokens}, cfg=cfg)
    torch.testing.assert_close(layered, ref, atol=1e-6, rtol=0)
    layered.backward()
    ref.backward()
    for got, want in ((leaves["wte"], ref_params["wte"]),
                      (blocks["mlp_up_w"], ref_blocks["mlp_up_w"])):
        torch.testing.assert_close(got.grad, want.grad, atol=1e-6, rtol=0)
