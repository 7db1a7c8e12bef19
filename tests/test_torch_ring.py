"""The port's context-parallel attention functions alone, held to
`deepspeed_tpu.parallel.ring` / `ulysses`: 4 gloo ranks on a `{"sequence":
4}` mesh (4-way rings) and on `{"data": 2, "sequence": 2}` (2-way rings),
against the JAX functions on the same 4-device meshes, on the same seeded
numpy inputs. Outputs and the q / k / v gradients of sum(out * do) in
fp32 within 2e-5 of max|ref|: the flash ring (the port's plain flash op a
step; JAX's CPU path, its blockwise oracle), causal and not; the
blockwise oracle; ring∘Ulysses at ulysses_degree 1, 2 and 4 and the auto
choice; `ulysses_shard_map_attention` and `DistributedAttention`. JAX's
ValueErrors on the same inputs; the dispatch's choices; the causal ring's
skipped future steps; the facade's bytes a ring step; the in-process
virtual ring (the card check's transport) against plain attention."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import mesh as jmesh
from deepspeed_tpu.config.core import MeshConfig as JMeshConfig
from deepspeed_tpu.parallel import ring as jring
from deepspeed_tpu.parallel import ulysses as julysses
from deepspeed_tpu_torch.ops import attention_dispatch as dispatch
from deepspeed_tpu_torch.ops.flash_attention import flash_attention_reference
from deepspeed_tpu_torch.parallel import ring as tring
from deepspeed_tpu_torch.testing.dist import RankPool

W = 4
TASK = "deepspeed_tpu_torch.testing.dist:sequence_attention"
MESHES = {"sp4": {"sequence": 4}, "sp2": {"data": 2, "sequence": 2}}
TOL = 2e-5


def _inputs(H=4, B=2, T=16, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(0, 1, (B, T, H, hd)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


INPUTS = _inputs()
ODD_HEADS = _inputs(H=3, seed=1)
SIX_HEADS = _inputs(H=6, seed=2)
GQA = {**INPUTS, "k": INPUTS["k"][:, :, :2], "v": INPUTS["v"][:, :, :2]}


def _cases(sp):
    """(label, port function, kwargs, own inputs, JAX function, kwargs)."""
    out = [("ring_causal", "ring", {"causal": True}, None,
            jring.ring_attention, {"causal": True}),
           ("ring_full", "ring", {"causal": False}, None,
            jring.ring_attention, {"causal": False}),
           ("ring_flash", "ring_flash", {"causal": True}, None,
            jring.ring_attention, {"causal": True}),
           ("blockwise_causal", "blockwise", {"causal": True}, None,
            jring.ring_attention_blockwise, {"causal": True}),
           ("blockwise_full", "blockwise", {"causal": False}, None,
            jring.ring_attention_blockwise, {"causal": False}),
           ("ring_ulysses_auto", "ring_ulysses", {}, None,
            jring.ring_ulysses_attention, {})]
    out += [(f"ring_ulysses_{u}", "ring_ulysses", {"ulysses_degree": u},
             None, jring.ring_ulysses_attention, {"ulysses_degree": u})
            for u in (1, 2, 4) if sp % u == 0]
    out += [("ring_ulysses_full", "ring_ulysses",
             {"causal": False, "ulysses_degree": 1}, None,
             jring.ring_ulysses_attention,
             {"causal": False, "ulysses_degree": 1}),
            ("ulysses_shard_map", "ulysses_shard_map", {}, None,
             "ulysses_shard_map", {}),
            ("distributed_attention", "distributed_attention", {}, None,
             "distributed_attention", {}),
            # JAX's ValueErrors on the same inputs
            ("err_heads", "ulysses_shard_map", {}, ODD_HEADS,
             "ulysses_shard_map", {}),
            ("err_degree_heads", "ring_ulysses", {"ulysses_degree": 3},
             None, jring.ring_ulysses_attention, {"ulysses_degree": 3}),
            ("err_kv_heads", "ring_ulysses", {}, GQA,
             jring.ring_ulysses_attention, {}),
            ("err_degree_axis", "ring_ulysses", {"ulysses_degree": 3},
             SIX_HEADS, jring.ring_ulysses_attention,
             {"ulysses_degree": 3})]
    return out


def _local_attention(q, k, v):
    T = q.shape[1]
    s = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(q.shape[-1])
    s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -1e30)
    return jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(s, axis=-1), v)


def _jax_case(fn, kwargs, inputs, mesh):
    if fn == "ulysses_shard_map":
        call = julysses.ulysses_shard_map_attention(_local_attention,
                                                    mesh=mesh)
    elif fn == "distributed_attention":
        call = julysses.DistributedAttention(_local_attention)
    else:
        call = lambda q, k, v: fn(q, k, v, mesh=mesh, **kwargs)
    def both(q, k, v, do):
        out, vjp = jax.vjp(call, q, k, v)
        return out, vjp(do)
    try:
        out, grads = jax.jit(both)(*(jnp.asarray(inputs[n])
                                     for n in ("q", "k", "v", "do")))
    except ValueError as e:
        return {"error": str(e)}
    return {"out": np.asarray(out), "grads": [np.asarray(g) for g in grads]}


def _jax_mesh(axes):
    jmesh.clear_mesh()
    return jmesh.init_mesh(JMeshConfig(**{"data": 1, **axes}))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(W, tmp_path_factory.mktemp("ring")) as p:
        yield p


@pytest.fixture(scope="module")
def runs(pool):
    """{mesh: (port results by rank, JAX results, the JAX split error)}:
    the port's run on the ranks while JAX computes here."""
    pending = {}
    for name, axes in MESHES.items():
        sp = axes["sequence"]
        cases = [(label, fn, kw, own)
                 for label, fn, kw, own, _, _ in _cases(sp)]
        pending[name] = pool.submit(TASK, axes, INPUTS, cases,
                                    split_T=2 * sp + 1)
    ref = {}
    for name, axes in MESHES.items():
        sp = axes["sequence"]
        mesh = _jax_mesh(axes)
        ref[name], seen = {}, {}
        for label, _, _, own, jfn, jkw in _cases(sp):
            key = (jfn, tuple(sorted(jkw.items())), id(own))
            if key not in seen:
                seen[key] = _jax_case(jfn, jkw, own or INPUTS, mesh)
            ref[name][label] = seen[key]
        odd = _inputs(T=2 * sp + 1)
        ref[name]["split"] = _jax_case(jring.ring_attention, {}, odd, mesh)
        jmesh.clear_mesh()
    return {name: (result(), ref[name]) for name, result in pending.items()}


def _seq_index(r, axes):
    return r % axes["sequence"]


@pytest.mark.parametrize("mesh,label", [
    (mesh, c[0]) for mesh in sorted(MESHES)
    for c in _cases(MESHES[mesh]["sequence"])])
def test_outputs_and_grads_or_errors_match_jax(runs, mesh, label):
    port, ref = runs[mesh]
    want = ref[label]
    axes = MESHES[mesh]
    sp = axes["sequence"]
    for r in range(W):
        got = port[r][label]
        if "error" in want:
            assert got.get("error") == want["error"], (r, got)
            continue
        assert "error" not in got, got["error"]
        s = _seq_index(r, axes)
        tl = want["out"].shape[1] // sp
        rows = slice(s * tl, (s + 1) * tl)
        for a, b in zip([got["out"]] + list(got["grads"]),
                        [want["out"]] + want["grads"]):
            b = b[:, rows]
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= TOL * np.abs(b).max(), (r, label)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_uneven_split_raises_jax_error(runs, mesh):
    port, ref = runs[mesh]
    assert "does not divide" in ref["split"]["error"]
    for r in range(W):
        assert port[r]["split"]["error"] == ref["split"]["error"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_causal_ring_skips_the_future_steps(runs, mesh):
    """No kernel (here: no plain step) runs for a future shard: of sp²
    steps a pass, sp(sp-1)/2 are skipped, forward and backward; the
    non-causal ring runs all sp²."""
    port, _ = runs[mesh]
    sp = MESHES[mesh]["sequence"]
    ring_ranks = [r for r in range(W) if r // sp == 0]     # one ring
    total = lambda label, key: sum(port[r][label]["steps"].get(key, 0)
                                   for r in ring_ranks)
    for p in ("fwd", "bwd"):
        assert total("ring_causal", f"{p}_skipped") == sp * (sp - 1) // 2
        assert total("ring_causal", f"{p}_diagonal") == sp
        assert total("ring_causal", f"{p}_past") == sp * (sp - 1) // 2
        assert total("ring_full", f"{p}_full") == sp * sp
        assert total("ring_full", f"{p}_skipped") == 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_facade_bytes_a_ring_step(runs, mesh):
    """Each forward step's shift hands the K/V shard to the wire; each
    backward step the K/V shard and its fp32 dK/dV accumulators: sp - 1
    shifts a pass and ppermute the only op."""
    port, _ = runs[mesh]
    sp = MESHES[mesh]["sequence"]
    B, T, H, hd = INPUTS["q"].shape
    shard = B * (T // sp) * H * hd * 4                  # fp32 bytes
    for r in range(W):
        for label in ("ring_causal", "ring_full"):
            st = port[r][label]["stats"]
            assert set(st) == {"ppermute"}
            assert st["ppermute"]["calls"] == 3 * (sp - 1)
            assert st["ppermute"]["bytes"] == (sp - 1) * (2 + 2 + 2) * shard


def test_dispatch_selects_the_ring_programs():
    def site(**kw):
        return dispatch.AttnSite(**{"phase": "train", "q_len": 64,
                                    "kv_len": 64, "kv_dtype": "float32",
                                    **kw})
    seq = ("sequence",)
    assert dispatch.select(site(backend="ring", mesh_axes=seq)) == "ring"
    assert dispatch.select(site(backend="ring_ulysses",
                                mesh_axes=seq)) == "ring_ulysses"
    # no sequence axis: the request falls through to the auto choice
    assert dispatch.select(site(backend="ring")) == dispatch.select(site())
    assert dispatch.select(site(backend="ring", mesh_axes=("data",))) \
        == "dense"
    with pytest.raises(ValueError, match="unknown attention_backend"):
        dispatch.select(site(backend="ring-ulysses", mesh_axes=seq))
    # a ring request at a site outside the ring's contract (non-square)
    with pytest.raises(ValueError, match="ineligible"):
        dispatch.select(site(backend="ring", mesh_axes=seq, kv_len=128))
    # a live sequence axis without a ring request or an attn_fn
    with pytest.raises(NotImplementedError, match="item 8"):
        dispatch.select(site(mesh_axes=seq))
    assert dispatch.select(site(mesh_axes=seq, external_fn=True)) == \
        "external"
    # on CUDA a shard outside the kernel contract raises, in the dispatch
    # and in the ring's own entry
    for bad in ({"kv_dtype": "float32"}, {"kv_dtype": "bfloat16",
                                          "head_dim": 32},
                {"kv_dtype": "bfloat16", "force_flash": False}):
        with pytest.raises(NotImplementedError, match="no plain"):
            dispatch.select(site(backend="ring", mesh_axes=seq,
                                 on_cuda=True, **bad))
    assert dispatch.select(site(backend="ring", mesh_axes=seq, on_cuda=True,
                                kv_dtype="bfloat16", head_dim=128)) == "ring"
    fake = types.SimpleNamespace(is_cuda=True, shape=(1, 64, 2, 32),
                                 dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no plain"):
        tring._kernel_contract(fake, fake, "ring")
    # the blockwise einsum oracle is plain attention: CPU only
    with pytest.raises(NotImplementedError, match="no plain"):
        tring._blockwise(tring.LocalExchange(1), [fake], [fake], [fake],
                         True, 1.0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("u", [1, 2, 4])
def test_virtual_ring_matches_plain_attention(causal, u):
    """The in-process exchange (sp = 4 virtual ranks, the card check's
    transport) against plain attention over the whole T: output and
    q / k / v gradients."""
    sp = 4
    x = {n: torch.from_numpy(v) for n, v in INPUTS.items()}
    q, k, v = (x[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    ref = flash_attention_reference(q, k, v, causal)[0]
    want = [ref.detach()] + list(torch.autograd.grad(ref, (q, k, v),
                                                     x["do"]))
    shards = [[t.chunk(sp, dim=1)[i].detach().clone().requires_grad_(True)
               for i in range(sp)] for t in (x["q"], x["k"], x["v"])]
    tring.STEPS.clear()
    outs = tring.virtual_ring_attention(*shards, causal=causal,
                                        ulysses_degree=u)
    grads = torch.autograd.grad(outs, [t for s in shards for t in s],
                                list(x["do"].chunk(sp, dim=1)))
    got = [torch.cat(outs, 1)] + [torch.cat(grads[i * sp:(i + 1) * sp], 1)
                                  for i in range(3)]
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= TOL * b.abs().max()
    ring = sp // u
    if ring > 1:
        kinds = ("diagonal", "past") if causal else ("full",)
        calls = sum(tring.STEPS[f"fwd_{k_}"] for k_ in kinds)
        assert calls == u * (ring * (ring + 1) // 2 if causal
                             else ring * ring)
