"""The port's comm layer held to the JAX package's: each facade op and
primitive on 2 gloo ranks equals the JAX op on a 2-device mesh for the same
numpy inputs (rank r's tensor is device r's shard), the int8 and 1-bit
wires exactly (the 1-bit scale within a few ulp), the sums at fp32 1e-6;
`CommStats` records (calls and bytes) equal JAX's for the same call
sequence, the comms logger mirrors into them and an axis of size 1
records nothing; the mesh spec, the groups' vocabulary and the refusals
(eager point-to-point, a backend that does not drive the device, mesh
axes other than `data`, each naming its ROADMAP item)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.comm import collectives as jcoll
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.comm import mesh as jmesh
from deepspeed_tpu.config.core import MeshConfig as JMeshConfig
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.comm import collectives as tcoll
from deepspeed_tpu_torch.comm import comm as tcomm
from deepspeed_tpu_torch.testing.dist import RankPool

W = 2


def _inputs():
    rng = np.random.default_rng(0)
    per = []
    for r in range(W):
        per.append({
            "a": rng.normal(0, 1, (4, 6)).astype(np.float32),
            "b": rng.normal(0, 1, (3,)).astype(np.float32),
            "u": rng.normal(0, 1, (4, 2)).astype(np.float32),
            "s": rng.normal(0, 1, (W, 3)).astype(np.float32),
            "w": rng.normal(0, 2, (W, 512)).astype(np.float32),
            "o": rng.normal(0, 1, (37,)).astype(np.float32)})
    return per


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    with RankPool(W, tmp_path_factory.mktemp("comm")) as pool:
        yield pool.run("deepspeed_tpu_torch.testing.dist:comm_facade_ops",
                       _inputs())


@pytest.fixture()
def jax_mesh():
    jmesh.clear_mesh()
    return jmesh.init_mesh(JMeshConfig(data=W))


def _per_rank(mesh, body, *per_rank_arrays):
    """Run `body` on each device's shard (device r holds rank r's array)
    inside shard_map over `data`; returns ([rank results], stats snapshot
    of the trace)."""
    glob = [jnp.asarray(np.stack(a)) for a in per_rank_arrays]
    fn = jax.jit(shard_map(lambda *xs: jax.tree_util.tree_map(
        lambda y: y[None], body(*[x[0] for x in xs])), mesh=mesh,
        in_specs=tuple(P("data") for _ in glob), out_specs=P("data"),
        check_vma=False))
    jcoll.stats.reset()
    lowered = fn.lower(*glob)
    snap = jcoll.stats.snapshot()
    out = lowered.compile()(*glob)
    res = jax.tree_util.tree_map(np.asarray, out)
    if isinstance(res, tuple):
        return [tuple(x[r] for x in res) for r in range(W)], snap
    return [res[r] for r in range(W)], snap


def _col(per, key):
    return [p[key] for p in per]


def _exact(port, name, ref):
    for r in range(W):
        got = port[r]["out"][name]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref[r]),
                                      err_msg=f"{name} rank {r}")


def _close(port, name, ref, rtol=1e-6):
    for r in range(W):
        np.testing.assert_allclose(np.asarray(port[r]["out"][name]),
                                   np.asarray(ref[r]), rtol=rtol, atol=1e-7,
                                   err_msg=f"{name} rank {r}")


def test_reductions_equal_jax(port, jax_mesh):
    per = _inputs()
    a = _col(per, "a")
    # one JAX program for each body; the port's ops that share it
    for names, body in (
            (("all_reduce_sum", "run_all_reduce"),
             lambda x: jcoll.psum(x, "data")),
            (("all_reduce_avg", "pmean"), lambda x: jcoll.pmean(x, "data")),
            (("psum",), lambda x: jcoll.psum(x, "data", repeats=3))):
        ref, snap = _per_rank(jax_mesh, body, a)
        assert snap["all_reduce"]["bytes"] > 0
        for name in names:
            _close(port, name, ref)
            assert port[0]["stats"][name] == snap, name
    for name, fn in (("all_reduce_max", jax.lax.pmax),
                     ("all_reduce_min", jax.lax.pmin)):
        ref, _ = _per_rank(jax_mesh, lambda x: fn(x, "data"), a)
        _exact(port, name, ref)


def test_gathers_scatters_and_all_to_all_equal_jax(port, jax_mesh):
    per = _inputs()
    a, s = _col(per, "a"), _col(per, "s")
    cases = (
        ("all_gather_tiled", lambda x: jcoll.all_gather(x, "data", axis=0,
                                                        tiled=True), a),
        ("all_gather_stacked", lambda x: jcoll.all_gather(x, "data"), a),
        ("lax_all_gather", lambda x: jcoll.all_gather(x, "data", axis=1,
                                                      tiled=True), a),
        ("reduce_scatter", lambda x: jcoll.reduce_scatter(x, "data"), a),
        ("lax_reduce_scatter", lambda x: jcoll.reduce_scatter(
            x, "data", scatter_dimension=1), a),
        ("all_to_all", lambda x: jcoll.all_to_all(
            x, "data", split_axis=0, concat_axis=0, tiled=True), a),
        ("lax_all_to_all", lambda x: jcoll.all_to_all(
            x, "data", split_axis=1, concat_axis=0, tiled=True), a),
        ("lax_all_to_all_stacked", lambda x: jcoll.all_to_all(
            x, "data", split_axis=0, concat_axis=1), s),
        ("ppermute", lambda x: jcoll.ppermute(x, "data", [(0, 1)]), a),
        ("p2p_shift", lambda x: jcomm.p2p_shift(x, "data"), a))
    for name, body, xs in cases:
        ref, snap = _per_rank(jax_mesh, body, xs)
        _close(port, name, ref)
        assert port[0]["stats"][name] == snap, name
    # the facade's reduce_scatter(AVG): the sum's chunk over the axis
    ref, _ = _per_rank(jax_mesh, lambda x: jcoll.reduce_scatter(x, "data")
                       / W, a)
    _close(port, "reduce_scatter_avg", ref)
    # broadcast / scatter: rank 0's data on every rank / chunk r on rank r
    for r in range(W):
        np.testing.assert_array_equal(port[r]["out"]["broadcast"], a[0])
        np.testing.assert_array_equal(port[r]["out"]["scatter"],
                                      np.split(a[0], W)[r])


def test_coalesced_pair_and_uneven_all_to_all_equal_jax(port, jax_mesh):
    per = _inputs()
    a, b, u = _col(per, "a"), _col(per, "b"), _col(per, "u")
    ref, _ = _per_rank(jax_mesh, lambda x, y: (jcoll.psum(x, "data"),
                                               jcoll.psum(y, "data")), a, b)
    for r in range(W):
        for got, want in zip(port[r]["out"]["all_reduce_coalesced"],
                             ref[r]):
            np.testing.assert_allclose(got, want, rtol=1e-6)
    ref, _ = _per_rank(jax_mesh, lambda x, y: (
        jcoll.all_gather(x, "data", tiled=True),
        jcoll.all_gather(y, "data", tiled=True)), a, b)
    for r in range(W):
        for got, want in zip(port[r]["out"]["all_gather_coalesced"],
                             ref[r]):
            np.testing.assert_array_equal(got, want)
    # the coalesced pair records only through the comms logger, in both
    assert port[0]["stats"]["all_reduce_coalesced"] == {}
    # uneven symmetric splits [1, 3]: JAX's global view of the exchange
    jout = np.asarray(jcomm.all_to_all_single(
        input=jnp.asarray(np.concatenate(u)), input_split_sizes=[1, 3]))
    got = np.concatenate([port[r]["out"]["all_to_all_single_uneven"]
                          for r in range(W)])
    np.testing.assert_array_equal(got, jout)


def test_wires_equal_jax(port, jax_mesh):
    per = _inputs()
    w, o = _col(per, "w"), _col(per, "o")
    flat = [x.reshape(-1) for x in w]
    # the decoded payloads exactly; the sums of decoded payloads at fp32
    # 1e-6 (XLA may fuse the dequantize's multiply into the sum's add)
    for name, body, xs, check in (
            ("rs_none", lambda x: jcoll.transform_reduce_scatter(
                x, "data", "none"), flat, _close),
            ("rs_int8", lambda x: jcoll.transform_reduce_scatter(
                x, "data", "int8"), flat, _close),
            ("ag_int8", lambda x: jcoll.transform_all_gather(
                x[0], "data", "int8"), w, _exact),
            ("car_none", lambda x: jcoll.compressed_all_reduce(
                x, "data", "none"), o, _close),
            ("car_int8", lambda x: jcoll.compressed_all_reduce(
                x, "data", "int8"), o, _close),
            ("a2a_int8", lambda x: jcoll.transform_all_to_all(
                x, "data", split_axis=0, concat_axis=0, transform="int8"),
             w, _exact)):
        ref, snap = _per_rank(jax_mesh, body, xs)
        check(port, name, ref)
        assert port[0]["stats"][name] == snap, name
    # 1-bit: the scale is a mean whose sum order differs by a few ulp
    ref, snap = _per_rank(jax_mesh, lambda x, e: jcoll.compressed_all_reduce(
        x, "data", "onebit", err=e), o, [np.zeros_like(x) for x in o])
    for r in range(W):
        for got, want in zip(port[r]["out"]["car_onebit"], ref[r]):
            np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-7)
    assert port[0]["stats"]["car_onebit"] == snap


def test_codecs_match_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3, (4, 512)).astype(np.float32)
    x[0, :7] = 0.0
    x[1, 3] = 127.5 / 127 * np.abs(x[1, :256]).max()    # a rounding tie
    for gs in (256, 64):
        tq, ts = tcoll.group_quant_int8(torch.from_numpy(x), gs)
        jq, js = jcoll.group_quant_int8(jnp.asarray(x), gs)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tcoll.group_dequant_int8(tq, ts, torch.float32).numpy(),
            np.asarray(jcoll.group_dequant_int8(jq, js, jnp.float32)))
    for n in (6, 33 * 7, 4096):
        v = rng.normal(0, 1, (n,)).astype(np.float32)
        v[::5] = 0.0
        tp, tsc = tcoll.onebit_encode(torch.from_numpy(v))
        jp, jsc = jcoll.onebit_encode(jnp.asarray(v))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=4e-7)
        np.testing.assert_array_equal(
            tcoll.onebit_decode(tp, torch.from_numpy(np.array(jsc)),
                                n).numpy(),
            np.asarray(jcoll.onebit_decode(jp, jsc, n)))
    err = tcoll.onebit_error_init({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert err["a"].dtype == torch.float32 and not err["a"].any()


def test_stats_logger_mirror_and_registry_match_jax():
    class Tel:
        def __init__(self):
            self.counters, self.obs = {}, {}

        def inc(self, name, n=1.0):
            self.counters[name] = self.counters.get(name, 0) + n

        def observe(self, name, v):
            self.obs.setdefault(name, []).append(v)

    def walk(coll, comm):
        s, t = coll.CommStats(), Tel()
        s.bind_telemetry(t)
        s.record("all_reduce", 1000)
        s.record("all_reduce", 500, seconds=0.002, calls=2)
        s.record("ppermute", 64)
        coll.stats.reset()
        t2 = Tel()
        coll.stats.bind_telemetry(t2)
        try:
            comm.comms_logger.append("all_gather", 4096, 0.003)
        finally:
            coll.stats.bind_telemetry(None)
        comm.comms_logger.reset()
        return (s.snapshot(), s.total_bytes(), s.calls_of("all_reduce"),
                t.counters, t.obs, coll.stats.snapshot(), t2.counters,
                t2.obs)

    assert walk(tcoll, tcomm) == walk(jcoll, jcomm)
    assert set(jcoll.OP_NAMES) <= set(tcoll.op_names())
    assert tcoll.OP_NAMES == jcoll.OP_NAMES
    assert tcoll.TRANSFORM_NAMES == jcoll.TRANSFORM_NAMES
    assert tcoll.transform_names() == jcoll.transform_names()
    with pytest.raises(ValueError, match="registered ops"):
        tcoll.get_op("broadcast")
    with pytest.raises(ValueError, match="no eager implementation"):
        tcoll.run("ppermute", torch.zeros(4), "data", [(0, 1)])
    with pytest.raises(ValueError, match="registered transforms"):
        tcoll.get_transform("fp4")
    with pytest.raises(ValueError, match="supports transforms"):
        tcoll.compressed_all_reduce(torch.zeros(4), "data", "fp4")
    with pytest.raises(ValueError, match="needs `err`"):
        tcoll.compressed_all_reduce(torch.zeros(4), "data", "onebit")
    with pytest.raises(ValueError, match="supports transforms"):
        tcoll.transform_reduce_scatter(torch.zeros(8), "data", "onebit")
    with pytest.raises(ValueError, match="onebit"):
        tcoll.transform_all_to_all(torch.zeros(2, 4), "data", split_axis=0,
                                   concat_axis=0, transform="onebit")


def test_axis_size_one_records_nothing_in_either_package():
    """One rank (no process group here): every op is the identity and
    records no bytes, as JAX's wrappers record none on an axis of 1."""
    from deepspeed_tpu_torch.comm import mesh as tmesh
    tmesh.clear_mesh()
    x = torch.arange(8.0).reshape(2, 4)
    tcoll.stats.reset()
    assert torch.equal(tcoll.psum(x, "data"), x)
    assert torch.equal(tcomm.all_reduce(x), x)
    assert torch.equal(tcomm.all_gather(x), x)
    assert torch.equal(tcoll.compressed_all_reduce(x, "data", "int8"), x)
    assert tcoll.stats.snapshot() == {}
    jmesh.clear_mesh()
    mesh = jmesh.init_mesh(JMeshConfig(data=1))
    fn = jax.jit(shard_map(lambda v: jcoll.psum(v, "data"), mesh=mesh,
                           in_specs=P("data"), out_specs=P(),
                           check_vma=False))
    jcoll.stats.reset()
    fn.lower(jnp.ones((1, 8), jnp.float32))
    assert jcoll.stats.snapshot() == {}
    jmesh.clear_mesh()
    tmesh.clear_mesh()


def test_mesh_groups_and_refusals(port):
    for r in range(W):
        info = port[r]["info"]
        assert info["world"] == W and info["rank"] == r
        assert info["dp_world"] == W and info["dp_rank"] == r
        assert info["tp_world"] == 1 and info["global_rank_data_1"] == 1
        assert info["spec"]["data"] == W
        ref = port[r]["refusals"]
        assert set(ref) == {"send", "recv", "isend", "irecv", "backend"}
        assert "p2p_shift" in ref["send"]
        assert "nccl" in ref["backend"] and "gloo" in ref["backend"]
    # every op reached torch.distributed, also where it records no bytes
    launches = port[0]["launches"]
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "broadcast", "scatter", "ppermute"):
        assert launches.get(op, 0) >= 1, op


@pytest.mark.parametrize("axes,item", [
    ({"zero": 2}, "item 7"), ({"tensor": 2}, "item 8"),
    ({"sequence": 2}, "item 8"), ({"pipe": 2}, "item 8"),
    ({"expert": 2}, "item 8")])
def test_mesh_axes_other_than_data_refuse_naming_their_item(axes, item):
    from deepspeed_tpu_torch.comm.mesh import MeshSpec
    from deepspeed_tpu_torch.config.core import MeshConfig
    with pytest.raises(NotImplementedError, match=item):
        MeshConfig(**axes)
    spec = MeshSpec.resolve(MeshConfig(data=-1), n_devices=4)
    assert spec.data == 4 and spec.world_size == 4
    with pytest.raises(ValueError, match="every rank"):
        MeshSpec.resolve(MeshConfig(data=2), n_devices=4)
    with pytest.raises(ValueError, match="process group"):
        from deepspeed_tpu_torch.comm.mesh import build_mesh
        build_mesh(MeshSpec(data=2))
