"""The port's crash-safe checkpoint protocol, bad-state sentinel and
rollback (`checkpoint/saver.py`, `checkpoint/manifest.py`,
`checkpoint/doctor.py`, `testing/faults.py`, `runtime/sentinel.py`) held
to the JAX package's: each fault scenario runs the same operations on a
small regression model in both packages, and the tag each resolves, its
committed tags, its uncommitted dirs and where a load lands must be the
same. The manifests, the doctor's JSON report and the sentinel's causes
are compared as documents; the NaN rollback lands on the same step with
the same next loss (fp32, 1e-5).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import doctor as jdoctor
from deepspeed_tpu.checkpoint import manifest as jmanifest
from deepspeed_tpu.checkpoint import saver as jsaver
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.runtime import sentinel as jsentinel
from deepspeed_tpu.testing import faults as jfaults
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import doctor as tdoctor
from deepspeed_tpu_torch.checkpoint import manifest as tmanifest
from deepspeed_tpu_torch.checkpoint import saver as tsaver
from deepspeed_tpu_torch.runtime import sentinel as tsentinel
from deepspeed_tpu_torch.testing import faults as tfaults

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _package(jax_side):
    if jax_side:
        return types.SimpleNamespace(
            jax=True, initialize=deepspeed_tpu.initialize, faults=jfaults,
            manifest=jmanifest, saver=jsaver, sentinel=jsentinel,
            doctor=jdoctor)
    return types.SimpleNamespace(
        jax=False, initialize=deepspeed_tpu_torch.initialize,
        faults=tfaults, manifest=tmanifest, saver=tsaver,
        sentinel=tsentinel, doctor=tdoctor)


JAX, PORT = _package(True), _package(False)


def _engine(pkg, engine_kind, dtype="bf16", fault_tolerance=None,
            checkpoint=None, seed=0):
    """The JAX package's fault-tolerance test model: y = x @ w + b, Adam."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (32, 32)).astype(np.float32)
    b = np.zeros((32,), np.float32)
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": 2},
           "steps_per_print": 10**9,
           "checkpoint": dict({"engine": engine_kind}, **(checkpoint or {}))}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    if fault_tolerance is not None:
        cfg["fault_tolerance"] = fault_tolerance
    if pkg.jax:
        mesh_mod.clear_mesh()
        mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1,
                                      expert=1, pipe=1))
        params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}

        def loss_fn(p, batch):
            return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

        eng, *_ = pkg.initialize(model=loss_fn, model_parameters=params,
                                 config={**cfg, "mesh": {"data": 1}})
    else:
        def loss_fn(p, batch):   # jnp promotes f32 @ bf16; torch asks
            x, y = (batch[k].to(p["w"].dtype) for k in ("x", "y"))
            return ((x @ p["w"] + p["b"] - y) ** 2).mean()

        eng, *_ = pkg.initialize(model=loss_fn,
                                 model_parameters={"w": w, "b": b},
                                 config=cfg, device="cpu")
    return eng


def _batch(rng, rows=4):
    return {"x": rng.normal(0, 1, (rows, 32)).astype(np.float32),
            "y": rng.normal(0, 1, (rows, 32)).astype(np.float32)}


def _w(pkg, eng):
    w = eng.state.params["w"]
    if pkg.jax:
        return np.asarray(jax.device_get(w)).astype(np.float32)
    return w.detach().float().numpy().copy()


@pytest.fixture(scope="module")
def engines():
    """One engine per package (numpy checkpoint engine, bf16): each
    scenario takes its steps from the same counter state."""
    out = {"jax": _engine(JAX, "numpy"), "port": _engine(PORT, "numpy")}
    yield out
    mesh_mod.clear_mesh()


def _state(pkg, root):
    return {"resolved": pkg.saver.get_latest_tag(str(root)),
            "committed": pkg.manifest.committed_tags(root),
            "uncommitted": pkg.manifest.uncommitted_dirs(root)}


def _crash_scenario(pkg, eng, root, point):
    """Save "good", step, crash a save of "doomed" at `point`, step again,
    load, then save "next" (which GCs the orphan)."""
    eng.global_steps = 0
    rng = np.random.default_rng(0)
    eng.train_batch(_batch(rng))
    eng.save_checkpoint(str(root), tag="good")
    w_good = _w(pkg, eng)
    eng.train_batch(_batch(rng))
    with pkg.faults.crash_save(point):
        with pytest.raises(pkg.faults.FaultInjected):
            eng.save_checkpoint(str(root), tag="doomed")
    out = {"after_crash": _state(pkg, root),
           "latest_file": (root / "latest").read_text().strip()}
    eng.train_batch(_batch(rng))
    path, _ = eng.load_checkpoint(str(root))
    out["loaded"] = path.rsplit("/", 1)[-1]
    out["steps"] = eng.global_steps
    out["weights_back"] = bool(np.array_equal(_w(pkg, eng), w_good)) \
        if out["loaded"] == "good" else None
    eng.save_checkpoint(str(root), tag="next")
    out["after_next"] = _state(pkg, root)
    return out


@pytest.mark.parametrize("point", jfaults.SAVE_CRASH_POINTS)
def test_midsave_crash_is_resolved_as_jax_resolves_it(engines, point,
                                                      tmp_path):
    assert tfaults.SAVE_CRASH_POINTS == jfaults.SAVE_CRASH_POINTS
    j = _crash_scenario(JAX, engines["jax"], tmp_path / "j", point)
    t = _crash_scenario(PORT, engines["port"], tmp_path / "t", point)
    assert t == j
    if point != "after_commit":
        assert t["after_crash"]["resolved"] == "good"
        assert t["weights_back"] is True


def _corruption_scenario(pkg, eng, root, target, mode):
    eng.global_steps = 0
    rng = np.random.default_rng(1)
    eng.train_batch(_batch(rng))
    eng.save_checkpoint(str(root), tag="t1")
    w1 = _w(pkg, eng)
    eng.train_batch(_batch(rng))
    eng.save_checkpoint(str(root), tag="t2")
    victim = pkg.faults.corrupt_checkpoint(root, tag="t2", target=target,
                                           mode=mode)
    out = {"victim": victim.rsplit("/", 2)[-2:], "state": _state(pkg, root)}
    path, _ = eng.load_checkpoint(str(root))
    out["loaded"] = path.rsplit("/", 1)[-1]
    out["steps"] = eng.global_steps
    out["weights_back"] = bool(np.array_equal(_w(pkg, eng), w1))
    return out


@pytest.mark.parametrize("mode", ["flip", "truncate", "delete"])
@pytest.mark.parametrize("target", ["state", "manifest", "client"])
def test_corruption_walks_back_as_jax_does(engines, target, mode, tmp_path):
    j = _corruption_scenario(JAX, engines["jax"], tmp_path / "j", target,
                             mode)
    t = _corruption_scenario(PORT, engines["port"], tmp_path / "t", target,
                             mode)
    j["victim"] = [v.replace("state.npz", "<state>") for v in j["victim"]]
    t["victim"] = [v.replace("state.npz", "<state>") for v in t["victim"]]
    assert t == j
    assert t["loaded"] == "t1" and t["weights_back"]


def _resave_scenario(pkg, eng, root):
    eng.global_steps = 0
    rng = np.random.default_rng(2)
    eng.train_batch(_batch(rng))
    eng.save_checkpoint(str(root), tag="best")
    w_old = _w(pkg, eng)
    eng.train_batch(_batch(rng))
    with pkg.faults.crash_save("before_commit"):
        with pytest.raises(pkg.faults.FaultInjected):
            eng.save_checkpoint(str(root), tag="best")
    ok, errors = pkg.manifest.verify_manifest(root / "best", deep=True)
    out = {"old_ok": ok, "errors": errors, "state": _state(pkg, root)}
    path, _ = eng.load_checkpoint(str(root), tag="best")
    out["weights_back"] = bool(np.array_equal(_w(pkg, eng), w_old))
    eng.train_batch(_batch(rng))
    eng.save_checkpoint(str(root), tag="best")
    out["residue"] = sorted(p.name for p in root.glob("*.tmp"))
    out["step"] = pkg.manifest.read_manifest(root / "best")["step"]
    out["final"] = _state(pkg, root)
    return out


def test_resave_of_an_existing_tag_is_crash_safe_as_in_jax(engines,
                                                          tmp_path):
    j = _resave_scenario(JAX, engines["jax"], tmp_path / "j")
    t = _resave_scenario(PORT, engines["port"], tmp_path / "t")
    assert t == j
    assert t["old_ok"] and t["weights_back"] and t["step"] == 2


def _retention_scenario(pkg, root):
    eng = _engine(pkg, "numpy", checkpoint={"keep_last_n": 1})
    legacy = root / "legacy_tag"
    (legacy / "state").mkdir(parents=True)
    (legacy / "client.json").write_text("{}")
    orphan = root / ("inflight" + pkg.manifest.TMP_SUFFIX)
    orphan.mkdir()
    rng = np.random.default_rng(3)
    seen = []
    for _ in range(3):
        eng.train_batch(_batch(rng))
        eng.save_checkpoint(str(root))
        seen.append(_state(pkg, root))
    return {"seen": seen, "legacy_kept": legacy.exists()}


def test_retention_never_deletes_an_uncommitted_dir(tmp_path):
    j = _retention_scenario(JAX, tmp_path / "j")
    t = _retention_scenario(PORT, tmp_path / "t")
    assert t == j
    assert t["legacy_kept"]
    assert t["seen"][-1]["uncommitted"] == ["legacy_tag"]
    assert [c for c, _ in t["seen"][-1]["committed"]] == ["global_step3"]
    mesh_mod.clear_mesh()


def test_manifest_is_jax_field_for_field(tmp_path):
    """write_manifest over the same files gives JAX's document (but the
    creation time), and each package verifies the other's saves."""
    for side in ("j", "t"):
        d = tmp_path / side
        (d / "state").mkdir(parents=True)
        (d / "state" / "state.npz").write_bytes(bytes(range(256)) * 33)
        (d / "client.json").write_text('{"global_steps": 7}')
    args = dict(tag="t", step=7, tree=[{"key": "params/w", "shape": [3],
                                        "dtype": "float32"}],
                world={"process_count": 1}, engine="NumpyCheckpointEngine",
                extra={"framework_version": "x"})
    mj = jmanifest.write_manifest(tmp_path / "j", **args)
    mt = tmanifest.write_manifest(tmp_path / "t", **args)
    mj.pop("created_unix")
    mt.pop("created_unix")
    assert mt == mj
    assert tmanifest.file_crc32(tmp_path / "t" / "client.json") == \
        jmanifest.file_crc32(tmp_path / "j" / "client.json")
    assert tmanifest.verify_manifest(tmp_path / "j") == (True, [])
    assert jmanifest.verify_manifest(tmp_path / "t") == (True, [])
    jfaults.corrupt_file(tmp_path / "t" / "state" / "state.npz")
    tfaults.corrupt_file(tmp_path / "j" / "state" / "state.npz")
    assert tmanifest.verify_manifest(tmp_path / "j") == \
        jmanifest.verify_manifest(tmp_path / "t")


def test_port_saves_verify_under_jax_and_doctor_reports_match(engines,
                                                              tmp_path,
                                                              capsys):
    """A root the port saved, then damaged: JAX's verify_manifest accepts
    its good tag, and the two doctors' JSON reports (whole root, one tag,
    after --gc) are the same document."""
    eng = engines["port"]
    eng.global_steps = 0
    rng = np.random.default_rng(4)
    for tag in ("t1", "t2"):
        eng.train_batch(_batch(rng))
        eng.save_checkpoint(str(tmp_path), tag=tag)
    assert jmanifest.verify_manifest(tmp_path / "t1")[0]
    tfaults.corrupt_checkpoint(tmp_path, tag="t2", target="state")
    (tmp_path / ("dead" + tmanifest.TMP_SUFFIX)).mkdir()
    for argv in ([str(tmp_path), "--json"],
                 [str(tmp_path), "--tag", "t2", "--json"],
                 [str(tmp_path), "--tag", "t1", "--json", "--fast"]):
        rc_t = tdoctor.main(argv)
        out_t = capsys.readouterr().out
        rc_j = jdoctor.main(argv)
        out_j = capsys.readouterr().out
        assert (rc_t, json.loads(out_t)) == (rc_j, json.loads(out_j))
    assert tdoctor.diagnose(tmp_path) == jdoctor.diagnose(tmp_path)
    assert tdoctor.main([str(tmp_path), "--gc", "--fix-latest"]) == 0
    assert (tmp_path / "latest").read_text().strip() == "t1"
    assert tdoctor.diagnose(tmp_path) == jdoctor.diagnose(tmp_path)


_SEQUENCES = {
    "nonfinite": ([1.0, float("nan"), float("nan"), 0.5, float("nan")],
                  [False] * 5, {"nonfinite_budget": 2}),
    "streak_reset": ([float("nan"), 0.5, float("nan"), float("inf")],
                     [False] * 4, {"nonfinite_budget": 2}),
    "overflow": ([float("inf")] * 4, [True] * 4, {"overflow_budget": 3}),
    "spike": ([1.0, 1.1, 0.9, 1.0, 50.0, 50.0, 1.0],
              [False] * 7, {"loss_spike_window": 4,
                            "loss_spike_patience": 2}),
    "spike_recovers": ([1.0, 1.0, 1.0, 20.0, 1.0, 20.0, 20.0, 20.0],
                       [False] * 8, {"loss_spike_window": 3,
                                     "loss_spike_patience": 3}),
}


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_sentinel_causes_and_budgets_match_jax(name):
    losses, overflows, cfg = _SEQUENCES[name]
    cfg = types.SimpleNamespace(enabled=True, **cfg)
    got = []
    for mod in (jsentinel, tsentinel):
        s = mod.BadStateSentinel(cfg)
        causes = [s.observe(v, overflow=o) for v, o in zip(losses, overflows)]
        got.append((causes, {c: s.describe(c) for c in causes if c}))
    assert got[1] == got[0]
    assert any(got[1][0])
    assert (tsentinel.CAUSE_NONFINITE, tsentinel.CAUSE_OVERFLOW,
            tsentinel.CAUSE_LOSS_SPIKE) == (
        jsentinel.CAUSE_NONFINITE, jsentinel.CAUSE_OVERFLOW,
        jsentinel.CAUSE_LOSS_SPIKE)


def _rollback_run(pkg, root):
    eng = _engine(pkg, "numpy", dtype="fp32",
                  fault_tolerance={"enabled": True, "nonfinite_budget": 2,
                                   "auto_rollback": True, "max_rollbacks": 1})
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(6)]
    for b in batches[:2]:
        eng.train_batch(b)
    eng.save_checkpoint(str(root))
    w_good = _w(pkg, eng)
    eng.train_batch(pkg.faults.poison_batch(batches[2]))
    poisoned = bool(np.isfinite(_w(pkg, eng)).all())
    eng.train_batch(batches[3])       # the second non-finite step: rollback
    out = {"rollbacks": eng.rollbacks, "steps": eng.global_steps,
           "poisoned_finite": poisoned,
           "back": bool(np.array_equal(_w(pkg, eng), w_good)),
           "next": [float(eng.train_batch(b)) for b in batches[4:]]}
    eng.train_batch(pkg.faults.poison_batch(batches[4]))
    with pytest.raises(pkg.sentinel.BadStateError) as ei:
        eng.train_batch(pkg.faults.poison_batch(batches[5]))
    out["exhausted_cause"] = ei.value.cause
    return out


def test_nan_rollback_lands_where_jax_lands(tmp_path):
    """A poisoned batch NaNs the fp32 params; the second non-finite step
    rolls back to the save: the same step, the same weights, the same next
    losses as JAX's rollback run (1e-5); the rollback budget then runs out
    with the same cause."""
    j = _rollback_run(JAX, tmp_path / "j")
    t = _rollback_run(PORT, tmp_path / "t")
    np.testing.assert_allclose(t.pop("next"), j.pop("next"), atol=TOL,
                               rtol=0)
    assert t == j
    assert t["rollbacks"] == 1 and t["steps"] == 2 and t["back"]
    assert not t["poisoned_finite"]
    mesh_mod.clear_mesh()


def test_no_checkpoint_raises_bad_state():
    eng = _engine(PORT, "torch", fault_tolerance={"enabled": True,
                                                  "nonfinite_budget": 1})
    rng = np.random.default_rng(0)
    with pytest.raises(tsentinel.BadStateError) as ei:
        eng.train_batch(tfaults.poison_batch(_batch(rng)))
    assert ei.value.cause == tsentinel.CAUSE_NONFINITE


def test_poison_batch_plants_in_tensors_and_nan_at_step():
    b = {"x": torch.zeros(3), "ids": torch.zeros(3, dtype=torch.int32)}
    p = tfaults.poison_batch(b)
    assert torch.isnan(p["x"][0]) and not torch.isnan(b["x"]).any()
    source = tfaults.NaNAtStep(lambda: {"x": np.zeros(2, np.float32)}, [1])
    assert [bool(np.isnan(source()["x"]).any()) for _ in range(3)] == \
        [False, True, False]


def test_recovery_events_reach_csv_monitor(tmp_path):
    """Checkpoint/* rows at every save and Recovery/* rows at a rollback
    land in the CSV monitor, under the JAX package's file names."""
    eng = _engine(PORT, "torch", dtype="fp32",
                  fault_tolerance={"enabled": True, "nonfinite_budget": 1})
    eng.config.csv_monitor.enabled = True
    eng.config.csv_monitor.output_path = str(tmp_path / "mon")
    from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
    eng.monitor = MonitorMaster(eng.config)
    rng = np.random.default_rng(0)
    eng.train_batch(_batch(rng))
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    eng.train_batch(tfaults.poison_batch(_batch(rng)))
    assert eng.rollbacks == 1
    mon_dir = tmp_path / "mon" / eng.config.csv_monitor.job_name
    names = {p.name for p in mon_dir.glob("*.csv")}
    assert {"Checkpoint_save_ms.csv", "Checkpoint_bytes.csv",
            "Checkpoint_last_good_step.csv", "Recovery_rollbacks_total.csv",
            "Recovery_last_good_step.csv"} <= names
