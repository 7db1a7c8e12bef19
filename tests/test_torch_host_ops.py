"""The port's host libraries (`ops/op_builder.py`'s host half over the
repo's `csrc/aio` and `csrc/cpu_optim`), its AIO swapper
(`runtime/swap_tensor.py`) and its host optimizer
(`runtime/cpu_optimizer.py`), held to the JAX package's. Both packages
call the same C++ on the same fp32 inputs, so the masters are bit-equal.
"""

import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.cpu_optimizer import \
    HostOffloadOptimizer as JHostOptimizer
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.runtime import engine as tengine
from deepspeed_tpu_torch.runtime.cpu_optimizer import HostOffloadOptimizer
from deepspeed_tpu_torch.runtime.swap_tensor import (AsyncTensorSwapper,
                                                     aligned_empty)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host libraries build with g++")


def test_builder_builds_both_libraries_into_the_port_build_dir():
    for name in ("dstpu_aio", "dstpu_cpu_optim"):
        path = op_builder.build_host(name)
        assert path.parent == op_builder.HOST_BUILD_DIR
        assert path.parent.as_posix().endswith("build/deepspeed_tpu_torch/host")
        assert path.name.startswith(f"lib{name}_") and path.exists()
    assert op_builder.omp_threads() >= 1


def test_concurrent_builds_publish_one_library(tmp_path, monkeypatch):
    """Builds racing into an empty directory (threads here; the tier-1
    workers are processes) each compile to their own temp file and rename
    it into place: one library, no temp file left."""
    monkeypatch.setattr(op_builder, "HOST_BUILD_DIR", tmp_path)
    start = threading.Barrier(4)

    def build(_):
        start.wait()
        return op_builder.build_host("dstpu_cpu_optim")

    with ThreadPoolExecutor(4) as pool:
        paths = set(pool.map(build, range(4)))
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths.pop().name]


def test_missing_compiler_and_failed_build_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(op_builder, "HOST_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(op_builder.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        op_builder.build_host("dstpu_aio")
    monkeypatch.undo()
    src = tmp_path / "aio"
    src.mkdir()
    (src / "dstpu_aio.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(op_builder, "HOST_CSRC", tmp_path)
    monkeypatch.setattr(op_builder, "HOST_BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        op_builder.build_host("dstpu_aio")
    assert not list((tmp_path / "out").glob("*"))


@pytest.mark.parametrize("shape,dtype", [((1024, 128), torch.float32),
                                         ((257,), torch.float32),
                                         ((3, 333), torch.bfloat16),
                                         ((5,), torch.int64)],
                         ids=["aligned", "unaligned", "bf16", "int64"])
def test_aio_round_trip(shape, dtype, tmp_path):
    sw = AsyncTensorSwapper(str(tmp_path), num_threads=2)
    src = torch.from_numpy(np.random.default_rng(0).normal(0, 1, shape)
                           .astype(np.float32)).to(dtype)
    sw.swap_out("nested/t", src)
    sw.wait()
    got = sw.swap_in("nested/t", shape, dtype)
    assert got.data_ptr() % 4096 == 0
    sw.wait()
    assert torch.equal(got, src)
    # into a caller's buffer, reused
    buf = aligned_empty(shape, dtype)
    assert sw.swap_in("nested/t", shape, dtype, out=buf) is buf
    sw.wait()
    assert torch.equal(buf, src)
    sw.release()


def _tree(rng):
    return {"w": rng.normal(0, 1, (64, 32)).astype(np.float32),
            "b": rng.normal(0, 1, (33,)).astype(np.float32)}


@pytest.mark.parametrize("nvme", [False, True], ids=["host", "nvme"])
@pytest.mark.parametrize("kind", ["adam", "adamw", "lion", "adagrad"])
def test_host_optimizer_masters_are_bit_equal_to_jax(kind, nvme, tmp_path):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01,
              optimizer="adam" if kind == "adamw" else kind,
              adamw_mode=kind != "adam")
    jopt = JHostOptimizer({k: jnp.asarray(v) for k, v in params.items()},
                          nvme_folder=str(tmp_path / "j") if nvme else None,
                          **kw)
    topt = HostOffloadOptimizer({k: torch.from_numpy(v)
                                 for k, v in params.items()},
                                nvme_folder=str(tmp_path / "t")
                                if nvme else None, **kw)
    for _ in range(3):
        grads = _tree(rng)
        jm = jopt.step({k: jnp.asarray(v) for k, v in grads.items()})
        tm = topt.step({k: torch.from_numpy(v) for k, v in grads.items()})
        for k in params:
            assert np.array_equal(tm[k].numpy(), np.asarray(jm[k])), k
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    for key in ("exp_avg", "exp_avg_sq"):
        assert (key in jsd) == (key in tsd)
        for a, b in zip(tsd.get(key, []), jsd.get(key, [])):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_host_optimizer_follows_the_schedule_and_pushes_the_params():
    params = {"w": torch.ones(4, 4)}
    opt = HostOffloadOptimizer(params, lr_schedule=lambda n: 0.1 * n)
    opt.step({"w": torch.ones(4, 4)})
    assert opt._current_lr() == pytest.approx(0.1)
    dst = [torch.zeros(4, 4, dtype=torch.bfloat16)]
    opt.push(dst)
    assert torch.equal(dst[0], opt.master[0].to(torch.bfloat16))


def _big_model(rng):
    return dict(model=lambda p, b: ((b["x"] @ p["w"]) ** 2).mean(),
                model_parameters={"w": torch.from_numpy(
                    rng.normal(0, 0.1, (512, 512)).astype(np.float32))})


def test_cpu_rule_takes_the_host_step_when_the_state_exceeds_the_card(
        monkeypatch):
    """offload_optimizer cpu: the streamed tier while 14 bytes a parameter
    fit in 0.6 of the card's memory, the host (C++) step beyond it
    (tests/test_native.py's rule with a patched memory figure)."""
    rng = np.random.default_rng(0)
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
              "zero_optimization": {"stage": 2,
                                    "offload_optimizer": {"device": "cpu"}}}
    monkeypatch.setattr(tengine, "device_memory_bytes",
                        lambda device: 4 * 2**20)
    eng, *_ = initialize(config=config, device="cpu", **_big_model(rng))
    assert eng.host_step and eng.host_optimizer is not None
    b = {"x": torch.from_numpy(rng.normal(0, 1, (2, 512))
                               .astype(np.float32))}
    losses = [float(eng.train_batch(b)) for _ in range(3)]
    assert losses[-1] < losses[0]
    monkeypatch.setattr(tengine, "device_memory_bytes",
                        lambda device: 80 * 2**30)
    eng2, *_ = initialize(config=config, device="cpu", **_big_model(rng))
    assert not eng2.host_step and eng2.offload_optimizer_states
