"""Ring attention — context parallelism over the `sequence` mesh axis
(counterpart of `deepspeed_tpu/parallel/ring.py`).

Each rank of the `sequence` axis holds its token shard [B, Tl, H, hd]
(Tl = T / sp, rank r the tokens [r·Tl, (r+1)·Tl)). The K/V shards travel
around the ring while every rank merges partials of its own queries. The
schedule is JAX's `_ring_attention_local`: in step i rank r holds the K/V
shard of src = (r - i) mod sp; under a causal mask the diagonal step
(src == r) runs the causal kernel, past steps (src < r) the unmasked one,
and future steps (src > r) are skipped — no launch, the partial
(o = 0, lse = -inf) — so a causal ring computes sp·(sp+1)/2 of the sp²
steps; a non-causal ring runs the unmasked kernel every step. Partials
merge by (o, lse) in fp32: out = Σ oᵢ·exp(lseᵢ − lse_total).

The whole ring is one `torch.autograd.Function` (`_RingAttention`). Its
backward runs the reverse ring and recomputes nothing the forward saved:
each rank starts from the last K/V shard the forward received, calls the
dq and dk/dv kernels (rows 2-3) with the merged lse and with delta =
rowsum(dO·O) of the merged output (the lse cotangent JAX's autodiff
threads through the merge weights, folded into delta), and sends the
shard back to the previous rank with its dK/dV accumulators, which end on
their owner after sp − 1 shifts — what JAX's autodiff through `ppermute`
does. The next shard's send and receive are posted before the kernels on
the current one (the facade's `ppermute_start`), so on NCCL the transfer
runs beside them; the dK/dV hand-off follows each step's kernels.

The transport is one small exchange object: `DistExchange` (a process
group's ring, one local slot, what the engine uses) or `LocalExchange`
(sp virtual ranks in one process, their blocks in a list that a shift
rotates: the card check drives the ring that way on one GPU). Both drive
the same per-step code. On CUDA tensors every step launches the flash
kernels (`ops/csrc/flash_fwd.cu`, `flash_bwd.cu`) or raises; on CPU
tensors it runs their plain versions (`ops/flash_attention.py`), so the
CPU tests run the card's schedule, merge and backward.

`ring_attention_blockwise` is JAX's einsum oracle (`_block_attn_partial`,
running (m, l, acc) merge) on the same schedule, a plain version in its
own right for the CPU: on CUDA it raises, and the dispatch never selects
it. `ring_ulysses_attention` composes DeepSpeed-Ulysses' head all-to-all
with the ring over the factored `sequence` axis (sp = ulysses × ring,
`seq_ulysses` the inner factor: `comm/mesh.factor_sequence_axis`).

The functions take and return this rank's shards (JAX's take the global
arrays and shard them in `shard_map`), so the T-divisibility check lives
where the tokens are split: `sequence_shard` (which the engine's batch
split calls) raises JAX's ValueError. The Pallas kernel's 128-multiple
shard rule does not apply (the CUDA kernels take any T).
"""

import collections
import math

import torch
from torch.autograd.function import once_differentiable

from deepspeed_tpu_torch.comm import collectives as coll
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.comm.mesh import (RING_SUBAXIS, SEQ_AXIS,
                                           TENSOR_AXIS, ULYSSES_SUBAXIS)
from deepspeed_tpu_torch.ops import attention_dispatch as attn_dispatch
from deepspeed_tpu_torch.ops import flash_attention as fa

NEG_INF = -1e30

__all__ = ["ring_attention", "ring_flash_attention",
           "ring_attention_blockwise", "factored_sequence_mesh",
           "ring_ulysses_attention", "virtual_ring_attention",
           "sequence_shard", "DistExchange", "LocalExchange", "STEPS",
           "RING_SUBAXIS", "ULYSSES_SUBAXIS"]

# ring steps run, by pass and kind ("fwd_diagonal", "fwd_past",
# "fwd_full", "fwd_skipped", "bwd_..."): one a slot and step. On CUDA the
# non-skipped ones are the kernel launches `ops.op_builder.LAUNCHES` counts
STEPS = collections.Counter()


# ----------------------------------------------------------------------
# the exchange: a process group's ring, or virtual ranks in one process
# ----------------------------------------------------------------------


class DistExchange:
    """The ring over a mesh axis (a name or a `mesh.SubAxis`): one slot,
    this rank, at its index along the axis. A shift posts the slot's
    tensors to ring rank r + direction and its receive from r − direction
    (the facade's non-blocking ppermute) and returns at once: calling what
    it returns waits and gives each slot's received tensors."""

    def __init__(self, axis=SEQ_AXIS):
        self.axis = axis
        self.n = mesh_mod.axis_size(axis)
        self.slots = [mesh_mod.axis_rank(axis)]

    def shift(self, blocks, direction, tag=0):
        perm = [(j, (j + direction) % self.n) for j in range(self.n)]
        pending = coll.ppermute_start(blocks[0], self.axis, perm, tag=tag)
        return lambda: [pending.wait()]

    def permute(self, blocks, direction):
        """The differentiable shift of each slot's tuple (the blockwise
        oracle's): one autograd node a shift."""
        perm = [(j, (j + direction) % self.n) for j in range(self.n)]
        return [_PPermute.apply(self.axis, tuple(perm), *blocks[0])]


class LocalExchange:
    """`n` ring ranks held as virtual ranks by one process. With `stride`
    s there are s independent rings: slot v (virtual sequence rank v) is
    ring rank v // s of ring v % s — the ring∘Ulysses factoring, whose
    ring peers lie s apart. A shift rotates the slots' blocks."""

    def __init__(self, n, stride=1):
        self.n, self.stride = n, stride
        self.slots = [v // stride for v in range(n * stride)]

    def shift(self, blocks, direction, tag=0):
        out = self.permute(blocks, direction)
        return lambda: out

    def permute(self, xs, direction):
        m = len(xs)
        return [xs[(v - direction * self.stride) % m] for v in range(m)]


class _PPermute(torch.autograd.Function):
    """ppermute of a tuple whose backward sends the cotangents back (JAX's
    transpose of `ppermute`). Every rank must run every backward, so the
    oracle ties each received block into its graph (`_tie`)."""

    @staticmethod
    def forward(ctx, axis, perm, *xs):
        ctx.axis, ctx.perm = axis, perm
        return coll.ppermute_start(xs, axis, list(perm)).wait()

    @staticmethod
    def backward(ctx, *gs):
        inv = [(d, s) for s, d in ctx.perm]
        gs = tuple(g.contiguous() for g in gs)
        return (None, None, *coll.ppermute_start(gs, ctx.axis, inv).wait())


def _tie(x, *deps):
    """x, with a zero-weighted dependency on `deps`: a block a rank skips
    still reaches its graph, so the shifts' backwards run on every rank
    in one order."""
    return x + 0.0 * sum(d.sum() for d in deps)


class _LocalUlysses:
    """Ulysses' all-to-all among virtual ranks: groups of `u` adjacent
    slots (the inner factor) trade chunks of `split` for `concat`."""

    def __init__(self, u):
        self.u = u

    def all_to_all(self, xs, split, concat):
        u, out = self.u, []
        for v in range(len(xs)):
            g, j = divmod(v, u)
            out.append(torch.cat([xs[g * u + i].chunk(u, dim=split)[j]
                                  for i in range(u)], dim=concat))
        return out


class _DistUlysses:
    def __init__(self, axis):
        self.axis = axis

    def all_to_all(self, xs, split, concat):
        from deepspeed_tpu_torch.parallel.ulysses import seq_all_to_all
        return [seq_all_to_all(xs[0], split, concat, self.axis)]


# ----------------------------------------------------------------------
# the per-step code (kernels on CUDA, their plain versions on the CPU)
# ----------------------------------------------------------------------


def _step_kind(src, r, causal):
    if not causal:
        return "full"
    if src == r:
        return "diagonal"
    return "past" if src < r else "skipped"


def _step_fwd(q, k, v, causal, sm_scale):
    """(o in q's dtype [B, Tl, H, hd], lse fp32 [B, H, Tl]) of one step."""
    if q.is_cuda:
        return fa._launch_fwd(q, k, v, sm_scale, causal, layout="BTHD")
    return fa.flash_attention_reference(q, k, v, causal, sm_scale,
                                        layout="BTHD")


def _step_bwd(q, k, v, out, dout, lse, delta, causal, sm_scale):
    """(dq, dk, dv) of one step in the inputs' layout [B, Tl, H, hd], from
    the merged output's lse and delta."""
    if q.is_cuda:
        qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, dout))
        dq, dk, dv = fa._launch_bwd(qh, kh, vh, doh, lse, delta, sm_scale,
                                    causal, True, True)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    return fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, None,
                                            causal, sm_scale, layout="BTHD")


def _merge(acc, lse_run, o, lse):
    """JAX's (o, lse) merge in fp32: acc [B, Tl, H, hd], lse [B, H, Tl]."""
    lse_new = torch.logaddexp(lse_run, lse)
    safe = torch.where(torch.isfinite(lse_new), lse_new,
                       torch.zeros_like(lse_new))
    alpha = torch.where(torch.isfinite(lse_run), torch.exp(lse_run - safe),
                        torch.zeros_like(lse_run))
    beta = torch.where(torch.isfinite(lse), torch.exp(lse - safe),
                       torch.zeros_like(lse))
    w = lambda x: x.transpose(1, 2)[..., None]
    return acc * w(alpha) + o.float() * w(beta), lse_new


def _ring_fwd(ex, qs, ks, vs, causal, sm_scale):
    """The forward ring over the exchange's slots: (outs, merged lses, the
    last K/V shards each slot received)."""
    n, slots = ex.n, ex.slots
    accs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in qs]
    lses = [torch.full((q.shape[0], q.shape[2], q.shape[1]), float("-inf"),
                       dtype=torch.float32, device=q.device) for q in qs]
    held = list(zip(ks, vs))
    for i in range(n):
        pending = ex.shift(held, +1, tag=0) if i < n - 1 else None
        for j, r in enumerate(slots):
            kind = _step_kind((r - i) % n, r, causal)
            STEPS["fwd_" + kind] += 1
            if kind == "skipped":
                continue
            k, v = held[j]
            o, lse = _step_fwd(qs[j], k, v, kind == "diagonal", sm_scale)
            accs[j], lses[j] = _merge(accs[j], lses[j], o, lse)
        if pending is not None:
            held = pending()
    outs = [a.to(q.dtype) for a, q in zip(accs, qs)]
    return outs, [x.contiguous() for x in lses], held


def _ring_bwd(ex, qs, last, outs, lses, douts, causal, sm_scale):
    """The reverse ring: (dqs, dks, dvs) of every slot's own shards."""
    n, slots = ex.n, ex.slots
    deltas = [(d.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
              for d, o in zip(douts, outs)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    held = list(last)
    acc = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device))
           for k, v in held]
    for i in reversed(range(n)):
        pending = ex.shift(held, -1, tag=1) if i > 0 else None
        for j, r in enumerate(slots):
            kind = _step_kind((r - i) % n, r, causal)
            STEPS["bwd_" + kind] += 1
            if kind == "skipped":
                continue
            k, v = held[j]
            dq, dk, dv = _step_bwd(qs[j], k, v, outs[j], douts[j], lses[j],
                                   deltas[j], kind == "diagonal", sm_scale)
            dqs[j] += dq.float()
            acc[j] = (acc[j][0] + dk.float(), acc[j][1] + dv.float())
        if pending is not None:
            moved = ex.shift(acc, -1, tag=2)
            held, acc = pending(), moved()
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)],
            [a[0].to(k.dtype) for a, (k, _) in zip(acc, held)],
            [a[1].to(v.dtype) for a, (_, v) in zip(acc, held)])


class _RingAttention(torch.autograd.Function):
    """outs = ring(qs, ks, vs) over an exchange's slots (flattened
    argument lists: qs, then ks, then vs)."""

    @staticmethod
    def forward(ctx, ex, causal, sm_scale, *qkv):
        m = len(qkv) // 3
        qs, ks, vs = qkv[:m], qkv[m:2 * m], qkv[2 * m:]
        outs, lses, last = _ring_fwd(ex, qs, ks, vs, causal, sm_scale)
        ctx.ex, ctx.causal, ctx.sm_scale, ctx.m = ex, causal, sm_scale, m
        ctx.save_for_backward(*qs, *outs, *lses,
                              *(t for kv in last for t in kv))
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *douts):
        m, saved = ctx.m, ctx.saved_tensors
        qs, outs, lses = saved[:m], saved[m:2 * m], saved[2 * m:3 * m]
        last = list(zip(saved[3 * m::2], saved[3 * m + 1::2]))
        douts = [torch.zeros_like(o) if d is None else d.contiguous()
                 for d, o in zip(douts, outs)]
        dqs, dks, dvs = _ring_bwd(ctx.ex, qs, last, outs, lses, douts,
                                  ctx.causal, ctx.sm_scale)
        return (None, None, None, *dqs, *dks, *dvs)


# ----------------------------------------------------------------------
# the blockwise einsum oracle (JAX's `_block_attn_partial` path)
# ----------------------------------------------------------------------


def _block_attn_partial(q, k, v, q_offset, k_offset, causal, sm_scale):
    """Unnormalized block attention with running-max bookkeeping. q:
    [B, Tq, H, hd]; k, v: [B, Tk, H, hd] -> (scores max [B, H, Tq],
    exp-sum [B, H, Tq], weighted values [B, Tq, H, hd])."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * sm_scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(Tk, device=q.device)[None, :]
        s = torch.where((q_pos >= k_pos)[None, None], s,
                        torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(torch.isfinite(m)[..., None], p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v.float())
    return m, l, o


def _blockwise(ex, qs, ks, vs, causal, sm_scale):
    """The oracle's ring: the same schedule, future steps skipped, merged
    by (m, l, acc); differentiable through autograd and `permute`."""
    for q in qs:
        if q.is_cuda:
            raise NotImplementedError(
                "ring_attention_blockwise is the plain einsum oracle: the "
                "port runs no plain attention on the card (use the flash "
                "ring, ring_attention / ring_flash_attention)")
    n, slots = ex.n, ex.slots
    B, Tl, H, hd = qs[0].shape
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32,
                                   device=qs[0].device)
    accs = [zeros(B, Tl, H, hd) for _ in qs]
    ms = [torch.full((B, H, Tl), NEG_INF, dtype=torch.float32,
                     device=qs[0].device) for _ in qs]
    ls = [zeros(B, H, Tl) for _ in qs]
    held = list(zip(ks, vs))
    for i in range(n):
        for j, r in enumerate(slots):
            src = (r - i) % n
            if causal and src > r:
                m_blk, l_blk, o_blk = (torch.full_like(ms[j], NEG_INF),
                                       _tie(zeros(B, H, Tl), *held[j]),
                                       zeros(B, Tl, H, hd))
            else:
                m_blk, l_blk, o_blk = _block_attn_partial(
                    qs[j], held[j][0], held[j][1], r * Tl, src * Tl, causal,
                    sm_scale)
            m_new = torch.maximum(ms[j], m_blk)
            safe = torch.where(torch.isfinite(m_new), m_new,
                               torch.zeros_like(m_new))
            alpha = torch.where(torch.isfinite(ms[j]),
                                torch.exp(ms[j] - safe),
                                torch.zeros_like(safe))
            beta = torch.where(torch.isfinite(m_blk), torch.exp(m_blk - safe),
                               torch.zeros_like(safe))
            ls[j] = ls[j] * alpha + l_blk * beta
            w = lambda x: x.transpose(1, 2)[..., None]
            accs[j] = accs[j] * w(alpha) + o_blk * w(beta)
            ms[j] = m_new
        if i < n - 1:
            held = ex.permute(held, +1)
    return [(a / ls_.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)
            for a, ls_, q in zip(accs, ls, qs)]


# ----------------------------------------------------------------------
# public entry points (this rank's shards in, this rank's output out)
# ----------------------------------------------------------------------


def _kernel_contract(q, k, what):
    """On CUDA the ring runs the flash kernels or raises, as the attention
    dispatch does for a site the kernels do not take."""
    if not q.is_cuda:
        return
    site = attn_dispatch.AttnSite(
        phase="train", q_len=q.shape[1], kv_len=k.shape[1],
        head_dim=q.shape[-1], kv_dtype=str(q.dtype).replace("torch.", ""),
        on_cuda=True)
    why = attn_dispatch.kernel_refusal(site, attn_dispatch.FLASH_DTYPES)
    if why:
        raise NotImplementedError(
            f"{what} on CUDA: the flash kernels do not take {why}, and the "
            f"port runs no plain attention on the card")


def _ring(ex, qs, ks, vs, causal, sm_scale, use_flash, what="ring"):
    """Outs of the ring over `ex`'s slots: the flash ring (`use_flash`
    True or None), else the blockwise oracle; a one-rank ring is one flash
    call (or one oracle block) a slot."""
    if use_flash is False:
        if ex.n == 1:
            return _blockwise(LocalExchange(1, len(qs)), qs, ks, vs, causal,
                              sm_scale)
        return _blockwise(ex, qs, ks, vs, causal, sm_scale)
    _kernel_contract(qs[0], ks[0], what)
    if ex.n == 1:
        return [fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
                for q, k, v in zip(qs, ks, vs)]
    return list(_RingAttention.apply(ex, bool(causal), float(sm_scale),
                                     *qs, *ks, *vs))


def sequence_shard(x, dim=1, axis_name=SEQ_AXIS, what="ring attention"):
    """This rank's token range of `x` along `dim`: chunk r of sp (r its
    index on the axis); JAX's ValueError when T does not divide."""
    sp = mesh_mod.axis_size(axis_name) if mesh_mod.has_mesh() else 1
    T = x.shape[dim]
    if T % sp != 0:
        raise ValueError(f"{what}: T = {T} does not divide over the {sp}-way "
                         f"`{getattr(axis_name, 'name', axis_name)}` mesh "
                         f"axis")
    if sp == 1:
        return x
    r = mesh_mod.axis_rank(axis_name)
    return x.narrow(dim, r * (T // sp), T // sp)


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def ring_attention(q, k, v, causal=True, sm_scale=None, axis_name=SEQ_AXIS,
                   mesh=None, use_flash=None):
    """This rank's shards q, k, v [B, Tl, H, hd] of the `axis_name` ring ->
    its output shard [B, Tl, H, hd]. `use_flash` None or True: each step
    runs the flash kernels (on the CPU their plain versions); False: the
    blockwise einsum oracle (CPU only). At sp == 1 one flash call (True
    and auto) or one oracle block (False). `mesh` is accepted for JAX's
    signature; the installed mesh is the one used."""
    del mesh
    sm_scale = _scale(q, sm_scale)
    ex = DistExchange(axis_name) if mesh_mod.has_mesh() \
        else LocalExchange(1)
    return _ring(ex, [q], [k], [v], causal, sm_scale, use_flash)[0]


def ring_flash_attention(q, k, v, causal=True, sm_scale=None,
                         axis_name=SEQ_AXIS, mesh=None):
    """The flash ring (`ring_attention(use_flash=True)`)."""
    return ring_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                          axis_name=axis_name, mesh=mesh, use_flash=True)


def ring_attention_blockwise(q, k, v, causal=True, sm_scale=None,
                             axis_name=SEQ_AXIS, mesh=None):
    """The blockwise einsum oracle on the ring's schedule (CPU only)."""
    return ring_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                          axis_name=axis_name, mesh=mesh, use_flash=False)


def factored_sequence_mesh(mesh, ulysses_degree):
    """((seq_ring, seq_ulysses) sub-axes, ring degree) of the installed
    mesh's `sequence` axis (`comm/mesh.factor_sequence_axis`): JAX's
    factoring, `seq_ulysses` the inner factor; ValueError when the degree
    does not divide sp. `mesh` is accepted for JAX's signature."""
    del mesh
    axes = mesh_mod.factor_sequence_axis(ulysses_degree)
    return axes, axes[0].size


def _auto_ulysses(sp, local_h):
    for d in range(min(sp, local_h), 0, -1):
        if sp % d == 0 and local_h % d == 0:
            return d
    return 1


def _check_ring_ulysses(q, k, v, sp, tp, ulysses_degree):
    """JAX's checks (`ring.py:337-365`) on this rank's shards; returns the
    Ulysses degree (the auto rule when None: the largest divisor of sp
    that divides the per-tensor-shard head count)."""
    H = q.shape[2]
    if H % tp != 0:
        raise ValueError(f"ring∘Ulysses: {H} heads do not divide over the "
                         f"{tp}-way `tensor` axis")
    local_h = H // tp
    if ulysses_degree is None:
        ulysses_degree = _auto_ulysses(sp, local_h)
    if local_h % ulysses_degree != 0:
        raise ValueError(
            f"ring∘Ulysses: ulysses_degree {ulysses_degree} does not divide "
            f"the per-tensor-shard head count {local_h} (H={H}, tp={tp}) — "
            f"the head-scatter all-to-all needs whole heads per rank. "
            f"Lower ulysses_degree (its factor of sp moves to the ring)")
    if k.shape[2] != H or v.shape[2] != H:
        raise ValueError(
            f"ring∘Ulysses: k/v head count {k.shape[2]} != q head count {H} "
            f"— repeat GQA K/V heads before the all-to-all (the zoo's "
            f"dispatch layer does this for external programs)")
    return ulysses_degree


def _ring_ulysses(qs, ks, vs, ring_ex, uly, causal, sm_scale, use_flash):
    """All-to-all over the Ulysses factor, the ring over the ring factor,
    all-to-all back — the per-rank code of both transports."""
    if uly is not None:
        qs, ks, vs = (uly.all_to_all(xs, 2, 1) for xs in (qs, ks, vs))
    outs = _ring(ring_ex, qs, ks, vs, causal, sm_scale, use_flash,
                 what="ring∘Ulysses")
    return outs if uly is None else uly.all_to_all(outs, 1, 2)


def ring_ulysses_attention(q, k, v, causal=True, sm_scale=None,
                           ulysses_degree=None, mesh=None, use_flash=None):
    """Context parallelism composed with Ulysses head parallelism over one
    `sequence` axis: sp = ulysses_degree × ring_degree. q, k, v: this
    rank's shards [B, Tl, H, hd] with matched head counts. The rank trades
    its token shard for an H/ulysses head shard over `seq_ulysses` (tokens
    gather contiguously in ring order), runs the ring over `seq_ring`, and
    trades back. `ulysses_degree=None` picks the largest divisor of sp
    that divides the head count; ulysses_degree == sp is pure Ulysses, 1
    pure ring."""
    del mesh
    sm_scale = _scale(q, sm_scale)
    has = mesh_mod.has_mesh()
    sp = mesh_mod.axis_size(SEQ_AXIS) if has else 1
    if sp == 1:
        return ring_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                              use_flash=use_flash)
    tp = mesh_mod.axis_size(TENSOR_AXIS)
    ulysses_degree = _check_ring_ulysses(q, k, v, sp, tp, ulysses_degree)
    (ring_ax, uly_ax), _ = factored_sequence_mesh(None, ulysses_degree)
    uly = _DistUlysses(uly_ax) if ulysses_degree > 1 else None
    return _ring_ulysses([q], [k], [v], DistExchange(ring_ax), uly, causal,
                         sm_scale, use_flash)[0]


def virtual_ring_attention(qs, ks, vs, causal=True, sm_scale=None,
                           ulysses_degree=1, use_flash=None):
    """The per-rank code of `ring_ulysses_attention` (of `ring_attention`
    at ulysses_degree 1) for sp = len(qs) virtual ranks in one process:
    qs[v] is virtual rank v's shard, the exchange a `LocalExchange`.
    Differentiable; returns each virtual rank's output shard. The card
    check drives the multi-rank ring this way on one GPU."""
    sp = len(qs)
    sm_scale = _scale(qs[0], sm_scale)
    ulysses_degree = _check_ring_ulysses(qs[0], ks[0], vs[0], sp, 1,
                                         ulysses_degree)
    if sp % ulysses_degree:
        raise ValueError(f"ring∘Ulysses: ulysses_degree {ulysses_degree} "
                         f"does not divide the `sequence` axis size {sp}")
    uly = _LocalUlysses(ulysses_degree) if ulysses_degree > 1 else None
    ring_ex = LocalExchange(sp // ulysses_degree, stride=ulysses_degree)
    return _ring_ulysses(list(qs), list(ks), list(vs), ring_ex, uly, causal,
                         sm_scale, use_flash)
