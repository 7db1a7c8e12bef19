"""The PyTorch port's block-sparse attention held to the JAX package: the
sparsity configs' layouts, the host build (visit lists), the block-sparse
op with its bias, key-padding and causal masks and their gradients,
`SparseSelfAttention` (kernel path and dense fallback), `sparse_attn_fn`,
and GPT training / evaluation through the `attn_fn` slot.

Inputs and weights come from numpy seeds. The JAX op runs its Pallas
kernels in interpret mode on the CPU, as its own tests run them; the port
runs the plain versions of its kernels (`csrc/block_sparse.cu`), the
numerics chip_smoke.py holds the kernels to on the card. Everything is fp32:
outputs and gradients at atol 2e-5 (the JAX tests' own tolerance; the two
sum in other orders), the GPT logits, loss and gradients at 1e-4, the
4-step engine trajectory at rtol 1e-4.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=2e-5, atol=2e-5)
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
B, H, T, D = 2, 4, 256, 32


def _cfg(pkg, name, **over):
    """One sparsity config of each family, built by `pkg` (the JAX or the
    port module) from the same arguments."""
    kw = {
        "dense": ("DenseSparsityConfig", dict(num_heads=H, block=16)),
        "fixed": ("FixedSparsityConfig", dict(
            num_heads=H, block=16, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional")),
        "fixed_bi": ("FixedSparsityConfig", dict(
            num_heads=H, block=32, num_local_blocks=2, num_global_blocks=1,
            horizontal_global_attention=True)),
        "bigbird": ("BigBirdSparsityConfig", dict(
            num_heads=H, block=16, num_random_blocks=2,
            num_sliding_window_blocks=3, num_global_blocks=1)),
        "bigbird_heads": ("BigBirdSparsityConfig", dict(
            num_heads=H, block=16, num_random_blocks=2, seed=3,
            different_layout_per_head=True, attention="unidirectional")),
        "bslongformer": ("BSLongformerSparsityConfig", dict(
            num_heads=H, block=16, num_sliding_window_blocks=5,
            global_block_indices=(0, 7))),
        "bslongformer_ranges": ("BSLongformerSparsityConfig", dict(
            num_heads=H, block=16, global_block_indices=(0, 5),
            global_block_end_indices=(2, 7))),
        "variable": ("VariableSparsityConfig", dict(
            num_heads=H, block=16, num_random_blocks=1,
            local_window_blocks=(2, 4, 8), global_block_indices=(0,),
            different_layout_per_head=True)),
        "variable_shared": ("VariableSparsityConfig", dict(
            num_heads=H, block=8, num_random_blocks=2, seed=5,
            local_window_blocks=(4,), attention="unidirectional")),
    }[name]
    return getattr(pkg, kw[0])(**{**kw[1], **over})


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _qkv(seed, shape=(B, H, T, D)):
    rng = np.random.default_rng(seed)
    return tuple(_normal(rng, *shape) for _ in range(3))


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


FAMILIES = ["dense", "fixed", "fixed_bi", "bigbird", "bigbird_heads",
            "bslongformer", "bslongformer_ranges", "variable",
            "variable_shared"]


@pytest.mark.parametrize("name", FAMILIES)
def test_layouts_are_bit_equal_to_jax(name):
    """Each family's layout, random blocks and per-head layouts included."""
    want = _cfg(jsa, name).make_layout(T)
    got = _cfg(tsa, name).make_layout(T)
    assert got.dtype == want.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,block_q", [("fixed", 128), ("bigbird", 128),
                                          ("variable", 256),
                                          ("variable_shared", 128)])
def test_build_at_the_jax_granularity_is_array_equal(name, block_q, causal):
    """`_build` with the JAX tiles (block_q x 128) returns the JAX `_build`'s
    arrays: visit lists (and their transposes) and the fine masks."""
    cfg = _cfg(tsa, name)
    layout = cfg.make_layout(T)
    want = jbsa._build(layout, T, cfg.block, block_q, causal)
    got = tbsa._build(layout, T, cfg.block, block_q, jbsa.BLOCK_K, causal)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_build_at_the_kernel_tiles_covers_every_live_cell():
    """At the kernel's 64 x 64 tiles (and a T that is no multiple of 64) the
    visited tiles cover every live fine cell, and the transposed lists
    visit exactly the same tiles."""
    Tr = 208
    layout = _cfg(tsa, "bigbird").make_layout(Tr)
    counts, idx, fine, countsT, idxT, _, nbq, nbk = tbsa._build(
        layout, Tr, 16)
    assert (nbq, nbk) == (4, 4)
    visited = np.zeros((H, nbq, nbk), bool)
    visitedT = np.zeros((H, nbk, nbq), bool)
    for h in range(H):
        for i in range(nbq):
            visited[h, i, idx[h, i, :counts[h, i]]] = True
            visitedT[h, i, idxT[h, i, :countsT[h, i]]] = True
    np.testing.assert_array_equal(visitedT.transpose(0, 2, 1), visited)
    live = np.argwhere(fine > 0)
    assert visited[live[:, 0], live[:, 1] // 4, live[:, 2] // 4].all()
    assert visited.sum() == counts.sum() < H * nbq * nbk


@pytest.mark.parametrize("causal", [False, True])
def test_live_cells_count_the_token_mask(causal):
    """The work count chip_smoke.py's bounds use: live cells of the fine
    layout (and causal) equal the token-level mask's, and every live cell
    lies in a visited tile."""
    layout = _cfg(tsa, "variable_shared").make_layout(T)
    plan = tbsa._plan(layout, T, 8, causal)
    live, visited = plan.token_masks(causal, "cpu")
    assert plan.live_cells(causal) == int(live.sum())
    assert not (live & ~visited).any()


def test_jax_computes_before_the_first_op_parity_test():
    """The file's first JAX computation (backend start, first compile):
    a small matmul against numpy. It runs just before the first test that
    calls the JAX op, so that a fault of the process's start fails here and
    one of the op's parity fails there."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(a) @ a.T), a @ a.T)


def test_head_broadcast_layout_matches_jax():
    """A one-head layout serves every head, as in JAX."""
    layout = _cfg(tsa, "bigbird").make_layout(T)[:1]
    q, k, v = _qkv(7)
    want = jbsa.block_sparse_attention(*map(jnp.asarray, (q, k, v)), layout,
                                       block=16)
    got = tbsa.block_sparse_attention(*_torch(q, k, v), layout, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dead_query_row_rejected():
    """The JAX case: a q tile with no live k block has an empty visit set;
    both builds refuse it (the port with a ValueError, JAX asserts)."""
    layout = np.zeros((1, T // 16, T // 16), bool)
    layout[:, :, 0] = True
    layout[0, 8:16, :] = False
    q, k, v = _torch(*(x[:, :1] for x in _qkv(3)))
    with pytest.raises(AssertionError, match="fully-masked"):
        jbsa._build(layout, T, 16, 128)
    with pytest.raises(ValueError, match="fully-masked"):
        tbsa.block_sparse_attention(q, k, v, layout, block=16)


def test_causal_dead_row_rejected():
    """The JAX case: rows whose only visited blocks lie in the future die
    after the causal intersection; legal without causal, refused with it."""
    n = T // 16
    layout = np.zeros((1, n, n), bool)
    layout[:, :, -1] = True
    layout[0, -1, 0] = True
    q, k, v = _torch(*(x[:, :1] for x in _qkv(4)))
    tbsa.block_sparse_attention(q, k, v, layout, block=16)
    with pytest.raises(AssertionError, match="causal"):
        jbsa._build(layout, T, 16, 128, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tbsa.block_sparse_attention(q, k, v, layout, block=16, causal=True)


@pytest.mark.parametrize("name,causal", [("fixed", True), ("fixed", False),
                                         ("bigbird", False),
                                         ("bslongformer", False),
                                         ("variable", False),
                                         ("variable_shared", True)])
def test_block_sparse_forward_matches_jax(name, causal):
    cfg = _cfg(tsa, name)
    layout = cfg.make_layout(T)
    q, k, v = _qkv(10 + FAMILIES.index(name))
    want = jbsa.block_sparse_attention(*map(jnp.asarray, (q, k, v)), layout,
                                       block=cfg.block, causal=causal)
    op_builder.LAUNCHES.clear()
    got = tbsa.block_sparse_attention(*_torch(q, k, v), layout,
                                      block=cfg.block, causal=causal)
    assert sum(op_builder.LAUNCHES.values()) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (bias slabs, bias_needs_grad, key padding, causal) -> JAX value and grads,
# computed once for the module
GRAD_CASES = {
    "bias1": (1, None, False, True),
    "biasH": (H, None, True, False),
    "biasH_frozen": (H, False, False, True),
    "padded": (0, None, True, True),
}


def _grad_case(name):
    slabs, needs, padded, causal = GRAD_CASES[name]
    rng = np.random.default_rng(20 + list(GRAD_CASES).index(name))
    q, k, v, do = (_normal(rng, B, H, T, D) for _ in range(4))
    bias = _normal(rng, slabs, T, T, scale=0.5) if slabs else None
    kpm = None
    if padded:
        kpm = np.ones((B, T), bool)
        kpm[0, -37:] = False
        kpm[1, 100:130] = False
    return q, k, v, do, bias, kpm, needs, causal


@pytest.fixture(scope="module")
def jax_grads():
    layout = _cfg(tsa, "fixed").make_layout(T)
    results = {}
    for name in GRAD_CASES:
        q, k, v, do, bias, kpm, needs, causal = _grad_case(name)

        def f(q, k, v, b):
            out = jbsa.block_sparse_attention(
                q, k, v, layout, block=16, causal=causal, bias=b,
                key_padding_mask=None if kpm is None else jnp.asarray(kpm),
                bias_needs_grad=needs)
            return jnp.sum(out * do), out
        args = [jnp.asarray(x) for x in (q, k, v)] + \
            [None if bias is None else jnp.asarray(bias)]
        argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
        (_, out), grads = jax.value_and_grad(f, argnums=argnums,
                                             has_aux=True)(*args)
        results[name] = (np.asarray(out), [np.asarray(g) for g in grads])
    return layout, results


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_block_sparse_gradients_match_jax(name, jax_grads):
    """out, dq, dk, dv and (learned bias) dbias against jax.grad of the
    Pallas op: a bias of one head slab (the head-summed dbias) and of H
    slabs, a frozen bias (bias_needs_grad=False: no dbias, zero from JAX),
    key-padding masks."""
    layout, results = jax_grads
    want_out, want = results[name]
    q, k, v, do, bias, kpm, needs, causal = _grad_case(name)
    tq, tk, tv = _torch(q, k, v, grad=True)
    ins = [tq, tk, tv]
    tb = None
    if bias is not None:
        tb = torch.from_numpy(bias).requires_grad_(True)
        ins.append(tb)
    out = tbsa.block_sparse_attention(
        tq, tk, tv, layout, block=16, causal=causal, bias=tb,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        bias_needs_grad=needs)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do),
                                allow_unused=True)
    for i, (g, w) in enumerate(zip(grads, want)):
        if i == 3 and needs is False:
            assert g is None and not w.any()
            continue
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"grad {i}", **TOL)


@pytest.fixture(scope="module")
def all_padded_case():
    """Batch row 1 pads every key, on a layout given at block 128 whose
    visited keys per query row are the same at the JAX tiles (128 x 128)
    and the port's (64 x 64): the keys of block row r are blocks 0..r."""
    layout = np.tril(np.ones((H, 2, 2), bool))
    rng = np.random.default_rng(31)
    q, k, v, do = (_normal(rng, B, H, T, D) for _ in range(4))
    kpm = np.ones((B, T), bool)
    kpm[1] = False

    def f(q, k, v):
        out = jbsa.block_sparse_attention(q, k, v, layout, block=128,
                                          key_padding_mask=jnp.asarray(kpm))
        return jnp.sum(out * do), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    return layout, (q, k, v, do, kpm), np.asarray(out), \
        [np.asarray(g) for g in grads]


def test_all_padded_row_matches_jax(all_padded_case):
    """A query row whose visited keys are all padded: every score is
    -1e30, so p = 1 and the output is the mean of the visited V (not 0,
    not NaN); its lse rounds to -1e30, and the backward sees p = 1 too.
    Pinned against the Pallas kernels where both tilings visit the same
    keys."""
    layout, (q, k, v, do, kpm), want_out, want = all_padded_case
    tq, tk, tv = _torch(q, k, v, grad=True)
    out = tbsa.block_sparse_attention(tq, tk, tv, layout, block=128,
                                      key_padding_mask=torch.from_numpy(kpm))
    got = out.detach().numpy()
    np.testing.assert_allclose(got, want_out, **TOL)
    np.testing.assert_allclose(got[1, :, :128], np.broadcast_to(
        v[1, :, :128].mean(1, keepdims=True), (H, 128, D)), **TOL)
    np.testing.assert_allclose(got[1, :, 128:], np.broadcast_to(
        v[1].mean(1, keepdims=True), (H, 128, D)), **TOL)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_all_padded_row_takes_the_mean_over_the_kernel_tiles():
    """On a layout whose visited keys depend on the tiling (the causal
    Fixed layout), an all-padded row takes the mean of V over the keys of
    its visited 64 x 64 tiles — the port's own tiles — including cells the
    fine or causal mask removes."""
    layout = _cfg(tsa, "fixed").make_layout(T)
    q, k, v = _qkv(32)
    kpm = np.ones((B, T), bool)
    kpm[0] = False
    out = tbsa.block_sparse_attention(*_torch(q, k, v), layout, block=16,
                                      causal=True,
                                      key_padding_mask=torch.from_numpy(kpm))
    plan = tbsa._plan(layout, T, 16, True)
    _, visited = plan.token_masks(True, "cpu")
    vis = visited.numpy().astype(np.float32)                  # [H, T, T]
    want = np.einsum("hts,hsd->htd", vis, v[0]) / vis.sum(-1)[..., None]
    np.testing.assert_allclose(out[0].numpy(), want, **TOL)
    assert np.isfinite(out.numpy()).all()


def _masked_case(seed, Tm=256, Hm=2, Bm=2):
    """The JAX tests' masked case at a small T: Fixed layout, rpe, a keep
    mask with the diagonal kept, key padding of the tail (global columns
    stay live)."""
    cfg = dict(num_heads=Hm, block=16, num_local_blocks=8,
               num_global_blocks=1)
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, Bm, Hm, Tm, D) for _ in range(3))
    rpe = _normal(rng, Tm, Tm, scale=0.5)
    keep = rng.random((Tm, Tm)) > 0.1
    np.fill_diagonal(keep, True)
    kpm = np.ones((Bm, Tm), bool)
    kpm[:, -20:] = False
    return cfg, q, k, v, rpe, keep.astype(np.float32), kpm


SSA_CASES = {
    "rpe_mul_padding": dict(rpe=True, mask="mul", kpm=True),
    "rpe_heads": dict(rpe="heads"),
    "add_mask": dict(mask="add", mode="add"),
    "lead1_mask": dict(mask="lead1"),
    "dense_fallback_odd_T": dict(Tm=208, rpe=True, kpm=True),
    "dense_fallback_batched": dict(mask="batched", kpm=True),
}


def _ssa_inputs(case):
    spec = SSA_CASES[case]
    cfg, q, k, v, rpe, keep, kpm = _masked_case(
        40 + list(SSA_CASES).index(case), Tm=spec.get("Tm", 256))
    Tm, Hm = q.shape[2], q.shape[1]
    kw = {}
    if spec.get("rpe") is True:
        kw["rpe"] = rpe
    elif spec.get("rpe") == "heads":
        kw["rpe"] = np.stack([rpe, rpe.T])
    mask = spec.get("mask")
    if mask in ("mul", "add"):
        kw["attn_mask"] = keep if mask == "mul" else (keep - 1.0) * 0.3
    elif mask == "lead1":
        kw["attn_mask"] = keep[None, None]
    elif mask == "batched":
        kw["attn_mask"] = np.stack([keep, keep[::-1]])
    if spec.get("kpm"):
        kw["key_padding_mask"] = kpm
    return cfg, spec.get("mode", "mul"), (q, k, v), kw, (Tm, Hm)


def _jax_ssa(jattn, q, k, v, kw):
    """JAX's SparseSelfAttention; a batched [B, T, T] mask is applied one
    batch row at a time (JAX's dense fallback broadcasts it as [1, B, T,
    T], over the heads)."""
    if np.ndim(kw.get("attn_mask")) == 3 and kw["attn_mask"].shape[0] > 1:
        return np.concatenate([_jax_ssa(jattn, q[b:b + 1], k[b:b + 1],
                                        v[b:b + 1], {
            **kw, "attn_mask": kw["attn_mask"][b],
            "key_padding_mask": kw["key_padding_mask"][b:b + 1]})
            for b in range(q.shape[0])])
    return np.asarray(jattn(*map(jnp.asarray, (q, k, v)),
                            **{n: jnp.asarray(a) for n, a in kw.items()}))


@pytest.mark.parametrize("case", list(SSA_CASES))
def test_sparse_self_attention_matches_jax(case):
    """SparseSelfAttention with rpe (one slab and per head), mul- and
    add-mode masks, a leading-1 mask and key padding; T 208 and a batched
    mask take the dense fallback on the CPU, where JAX does, with its
    warning (the batched mask indexed by batch row, as the port's kernel
    reads it)."""
    cfg, mode, (q, k, v), kw, (Tm, Hm) = _ssa_inputs(case)
    jattn = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**cfg),
                                    attn_mask_mode=mode)
    want = _jax_ssa(jattn, q, k, v, kw)
    tattn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(**cfg),
                                    attn_mask_mode=mode)
    messages = []
    handler = type("H", (__import__("logging").Handler,), {
        "emit": lambda self, r: messages.append(r.getMessage())})()
    tsa.logger.addHandler(handler)
    try:
        got = tattn(*_torch(q, k, v),
                    **{n: torch.from_numpy(np.ascontiguousarray(a))
                       for n, a in kw.items()})
    finally:
        tsa.logger.removeHandler(handler)
    valid = kw["key_padding_mask"][:, None, :, None] \
        if "key_padding_mask" in kw else 1.0
    np.testing.assert_allclose(got.numpy() * valid, want * valid, **TOL)
    assert any("dense" in m for m in messages) == case.startswith("dense")


@pytest.mark.parametrize("mode", ["learned_rpe", "add_mask"])
def test_sparse_self_attention_bias_gradients_match_jax(mode):
    """The dense [T, T] gradient of a learned rpe, and of an add-mode mask,
    with dq/dk/dv, against jax.grad through the Pallas op."""
    cfg, q, k, v, rpe, keep, kpm = _masked_case(50 + (mode == "add_mask"))
    am = mode == "add_mask"
    bias = (keep - 1.0) * 0.3 if am else rpe
    jattn = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**cfg),
                                    attn_mask_mode="add" if am else "mul")
    tattn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(**cfg),
                                    attn_mask_mode="add" if am else "mul")
    key = "attn_mask" if am else "rpe"

    def f(q, b):
        return jnp.sum(jattn(q, jnp.asarray(k), jnp.asarray(v),
                             key_padding_mask=jnp.asarray(kpm),
                             **{key: b}) ** 2)
    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(bias))
    tq, tb = _torch(q, bias, grad=True)
    out = tattn(tq, torch.from_numpy(k), torch.from_numpy(v),
                key_padding_mask=torch.from_numpy(kpm), **{key: tb})
    got = torch.autograd.grad((out ** 2).sum(), (tq, tb))
    assert float(np.abs(np.asarray(want[1])).max()) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


class _CausalDense:
    """A unidirectional dense config (the JAX leak probe's): tril at block
    granularity only, so block 0 leaks tokens 1..15 without token-causal
    masking."""

    def __init__(self, pkg, num_heads, block=16):
        self.inner = pkg.DenseSparsityConfig(num_heads=num_heads, block=block)
        self.block, self.attention = block, "unidirectional"

    def make_layout(self, seq_len):
        lay = self.inner.make_layout(seq_len)
        return lay & np.tril(np.ones(lay.shape[1:], bool))[None]


def test_sparse_attn_fn_is_token_causal_and_matches_jax():
    """Perturbing token 5's key and value leaves every earlier output
    byte-identical (position 5 is inside the first 16-token block), and
    the adapter's output equals JAX's."""
    fn = tsa.sparse_attn_fn(_CausalDense(tsa, 4))
    jfn = jsa.sparse_attn_fn(_CausalDense(jsa, 4))
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, 2, 128, 4, 16) for _ in range(3))  # [B, T, H, hd]
    out = fn(*_torch(q, k, v)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, 5] += 100.0
    v2[:, 5] -= 100.0
    out2 = fn(*_torch(q, k2, v2)).numpy()
    np.testing.assert_array_equal(out[:, :5], out2[:, :5])
    assert np.abs(out[:, 5:] - out2[:, 5:]).max() > 1e-3
    np.testing.assert_allclose(out, np.asarray(jfn(*map(jnp.asarray,
                                                        (q, k, v)))), **TOL)
    ref = tgpt.flash_attention_reference(*_torch(q, k, v), causal=True)[0]
    np.testing.assert_allclose(out, ref.numpy(), **TOL)


def test_sparse_attn_fn_and_the_op_build_their_plan_once(monkeypatch):
    """sparse_attn_fn and SparseSelfAttention keep the kernel's plan per
    (heads, length): repeated calls neither rebuild nor rehash the
    layout."""
    builds = []
    real = tbsa._plan
    monkeypatch.setattr(tbsa, "_plan",
                        lambda *a: builds.append(a[1:]) or real(*a))
    fn = tsa.sparse_attn_fn(_cfg(tsa, "fixed"))
    attn = tsa.SparseSelfAttention(_cfg(tsa, "bigbird"))
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, B, T, H, D) for _ in range(3))   # [B, T, H, hd]
    qh, kh, vh = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in (q, k, v))
    for _ in range(3):
        fn(*_torch(q, k, v))
        attn(*_torch(qh, kh, vh))
    assert builds == [(T, 16, True), (T, 16, False)]


def test_a_plan_for_another_shape_is_refused():
    plan = tbsa._layout_plan(_cfg(tsa, "fixed").make_layout(T), H, T, 16,
                             True)
    q, k, v = _torch(*_qkv(0, (B, H, T // 2, D)))
    with pytest.raises(ValueError, match="a plan for T=256"):
        tbsa._attend(q, k, v, plan, causal=True)


@pytest.mark.parametrize("name, causal", [
    ("fixed", False), ("fixed", True), ("bigbird_heads", False),
    ("bslongformer", False), ("variable", False)])
def test_row_order_walks_every_row_longest_first(name, causal):
    """The forward kernel's walk over (head, q tile) rows: a permutation of
    h * n_qtiles + i whose visit counts never rise, ties in index order;
    the plan hands it to the device beside the visit lists."""
    plan = tbsa._layout_plan(_cfg(tsa, name).make_layout(T), H, T, 16,
                             causal)
    order = plan.row_order()
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(H * plan.nbq))
    counts = plan.counts.reshape(-1)[order]
    assert (np.diff(counts) <= 0).all()
    for c in np.unique(counts):              # stable among equal counts
        rows = order[counts == c]
        assert (np.diff(rows) > 0).all()
    assert counts[0] == plan.counts.max()
    on = plan.on("cpu")
    assert len(on) == 7
    np.testing.assert_array_equal(on[5].numpy(), order)


def test_row_order_follows_a_plan_whose_lists_change():
    """A copy of a plan with other visit lists (chip_smoke.py's planted
    dropped tile) walks its own counts, not the original's."""
    import copy
    plan = tbsa._layout_plan(_cfg(tsa, "fixed").make_layout(T), H, T, 16,
                             True)
    coarse = tbsa._coarse(plan.fine, T, tbsa.TILE, tbsa.TILE)
    i = int(np.argmax(plan.counts[0]))
    coarse[0, i, int(plan.idx[0, i, 0])] = False
    bad = copy.copy(plan)
    bad.counts, bad.idx = tbsa._visit_lists(coarse)
    bad._device = {}
    counts = bad.counts.reshape(-1)[bad.row_order()]
    assert (np.diff(counts) <= 0).all()
    np.testing.assert_array_equal(bad.on("cpu")[5].numpy(),
                                  bad.row_order())


@pytest.mark.parametrize("name, causal", [
    ("fixed", False), ("fixed", True), ("bigbird_heads", False),
    ("bslongformer", False), ("variable", False)])
def test_col_order_walks_every_column_longest_first(name, causal):
    """The dk/dv kernel's walk over (head, k tile) columns: a permutation
    of h * n_ktiles + j whose transposed visit counts never rise, ties in
    index order; the plan hands it to the device after the row order."""
    plan = tbsa._layout_plan(_cfg(tsa, name).make_layout(T), H, T, 16,
                             causal)
    order = plan.col_order()
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(H * plan.nbk))
    counts = plan.countsT.reshape(-1)[order]
    assert (np.diff(counts) <= 0).all()
    for c in np.unique(counts):              # stable among equal counts
        cols = order[counts == c]
        assert (np.diff(cols) > 0).all()
    assert counts[0] == plan.countsT.max()
    # every live cell's k tile is walked: the transposed counts sum to the
    # row counts
    assert counts.sum() == plan.counts.sum()
    on = plan.on("cpu")
    np.testing.assert_array_equal(on[6].numpy(), order)


def test_col_order_follows_a_plan_whose_lists_change():
    """A copy of a plan with other transposed lists (chip_smoke.py's planted
    dropped tile) walks its own counts, not the original's."""
    import copy
    plan = tbsa._layout_plan(_cfg(tsa, "fixed").make_layout(T), H, T, 16,
                             True)
    coarse = tbsa._coarse(plan.fine, T, tbsa.TILE, tbsa.TILE)
    j = int(np.argmax(plan.countsT[0]))
    coarse[0, int(plan.idxT[0, j, 0]), j] = False
    bad = copy.copy(plan)
    bad.counts, bad.idx = tbsa._visit_lists(coarse)
    bad.countsT, bad.idxT = tbsa._visit_lists(coarse.transpose(0, 2, 1))
    bad._device = {}
    assert bad.countsT[0, j] == plan.countsT[0, j] - 1
    counts = bad.countsT.reshape(-1)[bad.col_order()]
    assert (np.diff(counts) <= 0).all()
    np.testing.assert_array_equal(bad.on("cpu")[6].numpy(),
                                  bad.col_order())


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "const int*": ctypes.c_void_p, "const uint8_t*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong,
            "const long long*": ctypes.POINTER(ctypes.c_longlong)}


@pytest.mark.parametrize("symbol", ["dstt_bsa_fwd", "dstt_bsa_bwd_dq",
                                    "dstt_bsa_bwd_dkv"])
def test_argtypes_match_the_c_signatures(symbol):
    """`_ARGTYPES` declares each parameter of block_sparse.cu's extern "C"
    entry points with the ctypes type its C type needs (a pointer never as
    a 32-bit int), in order: the backward passes take their walk's order
    after the fine mask."""
    text = (Path(tbsa.__file__).parent / "csrc" / "block_sparse.cu") \
        .read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"{symbol} not found in block_sparse.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    ctypes_of = [_C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
                 for p in params]
    assert tbsa._ARGTYPES[symbol] == ctypes_of


def _strided(case):
    """[B, H, T, D] bf16 views of the kinds the kernels' TMA maps take
    ("fused", "unit_dims") and refuse (the rest)."""
    D = 64                                   # a head width the kernels take
    base = torch.zeros(B, T, 3 * H * D + 8, dtype=torch.bfloat16)
    fused = base[..., :3 * H * D].reshape(B, T, 3, H, D)[:, :, 0] \
        .transpose(1, 2)
    if case == "fused":
        return fused
    if case == "unit_dims":                  # extent-1 dims: any stride
        return torch.zeros(T, D, dtype=torch.bfloat16)[None, None] \
            .as_strided((1, 1, T, D), (3, 5, D, 1))
    if case == "expanded_heads":             # stride 0 over H > 1
        return torch.zeros(B, 1, T, D, dtype=torch.bfloat16) \
            .expand(B, H, T, D)
    if case == "row_stride_not_16_bytes":
        odd = torch.zeros(B, H, T, D + 4, dtype=torch.bfloat16)
        return odd[..., :D]
    if case == "base_not_16_bytes":
        return base[..., 4:4 + H * D].reshape(B, T, H, D).transpose(1, 2)
    if case == "last_dim_strided":
        return torch.zeros(B, H, T, 2 * D, dtype=torch.bfloat16)[..., ::2]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["fused", "unit_dims"])
def test_kernel_operands_tma_describes_pass(case):
    q = _strided(case)
    assert tbsa._layout_ok(q)


@pytest.mark.parametrize("case", ["expanded_heads", "row_stride_not_16_bytes",
                                  "base_not_16_bytes", "last_dim_strided"])
def test_views_tma_cannot_describe_are_refused_before_a_launch(
        case, monkeypatch):
    """Handed (as on the card) a view the forward's TMA maps cannot
    describe, the op raises ValueError before any kernel library is
    loaded, and runs no plain version."""
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    def load(name):
        raise AssertionError(f"kernel library {name} requested")

    monkeypatch.setattr(tbsa, "_on_cuda", lambda q: True)
    monkeypatch.setattr(tbsa, "_reference_fwd", refuse)
    monkeypatch.setattr(op_builder, "load", load)
    good = _strided("fused")
    bad = _strided(case)
    assert not tbsa._layout_ok(bad)
    layout = _cfg(tsa, "fixed").make_layout(T)
    with pytest.raises(ValueError, match="positive strides"):
        tbsa.block_sparse_attention(good, bad, good, layout, causal=True)


# ----------------------------------------------------------------------
# GPT through the attn_fn slot
# ----------------------------------------------------------------------

GPT_KW = dict(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
              vocab_size=256, remat=False)
SPARSE_KW = dict(num_heads=4, block=16, num_local_blocks=4,
                 num_global_blocks=1, attention="unidirectional")


def _gpt_batch(seed=0, Bg=2, Tg=128):
    toks = np.random.default_rng(seed).integers(0, 256, (Bg, Tg)) \
        .astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def test_gpt_loss_logits_and_grads_with_sparse_attention_match_jax():
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **GPT_KW)
    jfn = jsa.sparse_attn_fn(jsa.FixedSparsityConfig(**SPARSE_KW))
    np_params = jax.tree_util.tree_map(
        np.asarray, jgpt.init_gpt_params(jcfg, seed=1))
    batch = _gpt_batch(2)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(p, {n: jnp.asarray(a) for n, a in
                                    batch.items()}, None, jcfg,
                                attn_fn=jfn))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    jlogits = jgpt.gpt_forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                               jnp.asarray(batch["tokens"]), jcfg,
                               attn_fn=jfn)
    pcfg = tgpt.GPTConfig(dtype="float32", **GPT_KW)
    fn = tsa.sparse_attn_fn(tsa.FixedSparsityConfig(**SPARSE_KW))
    params = tgpt.params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    tb = {n: torch.from_numpy(a) for n, a in batch.items()}
    loss = tgpt.gpt_loss(params, tb, cfg=pcfg, attn_fn=fn)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **GPT_TOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GPT_TOL)
    with torch.no_grad():
        logits = tgpt.gpt_forward(params, tb["tokens"], pcfg, attn_fn=fn)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **GPT_TOL)


def test_params_from_jax_carries_the_sparse_model_tree():
    """Sparse attention adds no parameter: the JAX sparse model's tree moves
    leaf for leaf onto the port's tree of the same config."""
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **GPT_KW)
    jspec = jgpt.make_gpt_model(cfg=jcfg, name="sparse-gpt", seed=4,
                                attn_fn=jsa.sparse_attn_fn(
                                    jsa.FixedSparsityConfig(**SPARSE_KW)))
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    moved = tgpt.params_from_jax(np_params)
    own = tgpt.init_gpt_params(tgpt.GPTConfig(dtype="float32", **GPT_KW),
                               seed=4)
    assert jax.tree_util.tree_structure(moved) == \
        jax.tree_util.tree_structure(own)
    for a, b in zip(tree_leaves(moved), tree_leaves(own)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_gpt_trains_with_sparse_attention_like_the_jax_engine():
    """The JAX test's run: 4 train_batch steps (Adam, lr 1e-3) from the same
    weights and batch, through sparse_attn_fn in both packages; the spec's
    apply_fn carries the same attn_fn and gives JAX's logits."""
    mesh_mod.clear_mesh()
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **GPT_KW)
    jfn = jsa.sparse_attn_fn(jsa.FixedSparsityConfig(**SPARSE_KW))
    jspec = jgpt.make_gpt_model(cfg=jcfg, name="sparse-gpt", attn_fn=jfn)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "steps_per_print": 10**9}
    jeng, *_ = deepspeed_tpu.initialize(model=jspec, config={
        **config, "mesh": {"data": 1}})
    fn = tsa.sparse_attn_fn(tsa.FixedSparsityConfig(**SPARSE_KW))
    spec = tgpt.make_gpt_model(tgpt.GPTConfig(dtype="float32", **GPT_KW),
                               name="sparse-gpt",
                               params=tgpt.params_from_jax(np_params),
                               attn_fn=fn)
    assert spec.apply_fn.keywords["attn_fn"] is fn
    assert spec.loss_fn.keywords["attn_fn"] is fn
    teng, *_ = initialize(model=spec, config=config, device="cpu")
    batch = _gpt_batch(0)
    jl = [float(jeng.train_batch(batch)) for _ in range(4)]
    tl = [float(teng.train_batch(batch)) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    toks = batch["tokens"]
    want = jspec.apply_fn(jeng.state.params, jnp.asarray(toks))
    with torch.no_grad():
        got = spec.apply_fn(teng.state.params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    mesh_mod.clear_mesh()
