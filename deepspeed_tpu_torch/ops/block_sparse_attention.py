"""Block-sparse flash attention, forward and backward (counterpart of
`deepspeed_tpu/ops/pallas/block_sparse_attention.py`).

The [H, T/block, T/block] block layout of a sparsity config
(`ops/sparse_attention.py`) is re-expressed at 16-token granularity (the
fine mask) and coarsened to the kernel's 64 x 64 tiles; for every (head, q
tile) a visit list names the k tiles that hold a live fine cell, and the
transposed lists name, for every k tile, the q tiles that visit it. Compute
and device-memory traffic scale with the layout's density, not T^2. The
kernels walk their (b, h, tile) items longest list first: the forward and
the dq pass in the plan's `row_order`, the dk/dv pass in its `col_order`.

`block_sparse_attention(q, k, v, layout, ...)` is differentiable through
one `torch.autograd.Function`. On a CUDA tensor each pass launches its
hand-written kernel (`csrc/block_sparse.cu`: forward, dq, dk/dv; bf16/fp16,
head_dim 64/128, any T that is a multiple of 16) or raises; on a CPU tensor
it runs the plain versions beside them. Both follow the Pallas kernels'
numerics:

  * q is scaled in fp32 and rounded to the input dtype before the kernel,
    and dk is contracted against that rounded q with no further scale; dq
    leaves the kernel rounded to the input dtype, then is scaled in fp32
    and rounded again;
  * the fine mask, the token-causal mask, the additive bias ([Bb, Hb, T,
    T] fp32, Bb in {1, B}, Hb in {1, H}) and the key-padding row (-1e30
    added on padded keys) enter the scores as in JAX: masked cells get the
    finite NEG_INF = -1e30, not -inf. A query row whose visited keys are all
    padded therefore sees equal scores everywhere and takes the mean of V
    over the keys of its visited tiles, and its lse rounds to -1e30;
  * p narrows to the input dtype before p.V (and ds before its products);
    the softmax statistics and every sum stay fp32.

The tiles are the kernel's own (64 x 64, not the TPU's block_q x 128), so
the "visited keys" of an all-padded row are those of its 64 x 64 tiles:
where the two tilings visit different keys for such a row, the port and JAX
give different means (a deliberate divergence; ROADMAP.md queue 3).
The Pallas-only parts do not carry over: no one-hot selection or expansion
matmuls (the kernels read the fine mask by index and copy each visited
tile's bias box and padding row beside K and V), no bias copy blocked per
tile, no VMEM budget, no automatic block_q.
"""

import ctypes
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.attention_dispatch import (FLASH_DTYPES,
                                                        KERNEL_HEAD_DIMS)

NEG_INF = -1e30
FINE = 16          # the fine mask's granularity
TILE = 64          # the kernel's q and k tile (csrc/block_sparse.cu BT)


# ----------------------------------------------------------------------
# host build: fine mask and visit lists
# ----------------------------------------------------------------------


def _visit_lists(coarse):
    """coarse: [H, nq, nk] bool -> (counts [H, nq], idx [H, nq, max_visits]);
    idx rows are the visited k tiles, padded with 0 (never read past
    counts)."""
    H, nq, nk = coarse.shape
    counts = coarse.sum(-1).astype(np.int32)
    maxv = max(1, int(counts.max()))
    idx = np.zeros((H, nq, maxv), np.int32)
    for h in range(H):
        for i in range(nq):
            cols = np.nonzero(coarse[h, i])[0]
            idx[h, i, :len(cols)] = cols
    return counts, idx


def _normalize_16(layout, block):
    """Re-express a [H, T/block, T/block] layout at the 16 granularity
    (expand coarse blocks; group finer ones by any())."""
    layout = np.asarray(layout, bool)
    if block == FINE:
        return layout
    H, n, _ = layout.shape
    if block > FINE:
        if block % FINE:
            raise ValueError(f"layout block {block} must be a multiple of "
                             f"{FINE}")
        r = block // FINE
        return np.kron(layout, np.ones((r, r), bool))
    r = FINE // block
    if r * block != FINE or n % r:
        raise ValueError(f"layout block {block} must divide {FINE}, and "
                         f"{n} blocks must fill whole 16-token cells")
    n16 = n // r
    return layout.reshape(H, n16, r, n16, r).any((2, 4))


def _coarse(fine, T, tile_q, tile_k):
    """[H, ceil(T/tile_q), ceil(T/tile_k)] bool: tiles holding a live fine
    cell (the last tile of a T that is no multiple of the tile is padded
    with dead cells)."""
    H, n16, _ = fine.shape
    fq, fk = tile_q // FINE, tile_k // FINE
    nbq, nbk = -(-T // tile_q), -(-T // tile_k)
    padded = np.zeros((H, nbq * fq, nbk * fk), bool)
    padded[:, :n16, :n16] = fine
    return padded.reshape(H, nbq, fq, nbk, fk).any((2, 4))


def _build(layout, T, block, tile_q=TILE, tile_k=TILE, causal=False):
    """Host-side static prep (numpy): the 16-granular fine masks (f32, both
    orientations) and the visit lists at (tile_q x tile_k) granularity, as
    the JAX `_build` returns them at its (block_q x 128) one. Refuses
    (ValueError, where JAX asserts) a q tile with no visited k tile, and
    (causal) a fine query row whose visited cells all lie in the future."""
    fine = _normalize_16(layout, block)                # [H, n16, n16]
    H, n16, _ = fine.shape
    if n16 * FINE != T or fine.shape[2] != n16:
        raise ValueError(f"layout {np.shape(layout)} at block {block} does "
                         f"not cover T={T}")
    coarse = _coarse(fine, T, tile_q, tile_k)
    if not coarse.any(-1).all():
        raise ValueError("sparsity layout has a fully-masked query row "
                         "(undefined softmax)")
    if causal and not (np.tril(np.ones((n16, n16), bool))[None] & fine) \
            .any(-1).all():
        raise ValueError("causal=True: some query row's visited blocks are "
                         "entirely in the future (fully masked after the "
                         "causal intersection)")
    counts, idx = _visit_lists(coarse)
    countsT, idxT = _visit_lists(coarse.transpose(0, 2, 1))
    return (counts, idx, fine.astype(np.float32), countsT, idxT,
            fine.transpose(0, 2, 1).astype(np.float32), coarse.shape[1],
            coarse.shape[2])


class _Plan:
    """One layout's build at the kernel's tiles: host numpy, plus one copy
    of the kernel's operands per device (int32 visit lists, uint8 fine
    mask)."""

    def __init__(self, layout, T, block, causal):
        (self.counts, self.idx, fine, self.countsT, self.idxT, _,
         self.nbq, self.nbk) = _build(layout, T, block, causal=causal)
        self.fine = fine.astype(bool)
        self.T = T
        self._device = {}

    def row_order(self):
        """The forward's and the dq pass's walk over their (head, q tile)
        rows, longest visit list first: int32 [H * nbq], a permutation of
        h * nbq + i with non-increasing counts (ties in index order), so
        the rows with the most tiles do not start last."""
        return np.argsort(-self.counts.reshape(-1), kind="stable") \
            .astype(np.int32)

    def col_order(self):
        """The dk/dv pass's walk over its (head, k tile) columns, the
        transposed twin of `row_order`: int32 [H * nbk], a permutation of
        h * nbk + j with non-increasing transposed counts (ties in index
        order), so the k tiles that nearly every q tile visits (the global
        blocks) do not start last."""
        return np.argsort(-self.countsT.reshape(-1), kind="stable") \
            .astype(np.int32)

    def on(self, device):
        """(counts, idx, fine, countsT, idxT, row order, col order) tensors
        on `device`."""
        key = str(device)
        if key not in self._device:
            self._device[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.counts, self.idx, self.fine.astype(np.uint8),
                          self.countsT, self.idxT, self.row_order(),
                          self.col_order()))
        return self._device[key]

    def live_cells(self, causal):
        """Number of (q, k) cells live in the fine layout (and causal), per
        head summed over heads: the work the kernels must do."""
        n16 = self.fine.shape[-1]
        full = int(self.fine.sum()) * FINE * FINE
        if not causal:
            return full
        upper = np.triu(np.ones((n16, n16), bool), 1)
        diag = int(np.einsum("hii->", self.fine.astype(np.int64)))
        # strictly-future fine cells hold no causal pair; a diagonal cell
        # holds FINE * (FINE + 1) / 2
        return full - int((self.fine & upper).sum()) * FINE * FINE \
            - diag * (FINE * FINE - FINE * (FINE + 1) // 2)

    def token_masks(self, causal, device):
        """(live, visited) [H, T, T] bool: cells live in the fine layout
        (and causal), and cells of the kernel's visited tiles."""
        T = self.T
        fine = torch.from_numpy(self.fine).to(device)
        live = fine.repeat_interleave(FINE, 1).repeat_interleave(FINE, 2)
        if causal:
            live &= torch.ones(T, T, dtype=torch.bool, device=device).tril()
        coarse = _coarse(self.fine, T, TILE, TILE)
        visited = torch.from_numpy(coarse).to(device) \
            .repeat_interleave(TILE, 1).repeat_interleave(TILE, 2)[:, :T, :T]
        return live, visited


_BUILD_CACHE = {}


def _plan(layout, T, block, causal):
    """Memoized `_Plan`: keyed on the layout's bytes (a hash collision
    between two same-shape layouts would serve the wrong pattern)."""
    key = (layout.tobytes(), layout.shape, T, block, causal)
    if key not in _BUILD_CACHE:
        _BUILD_CACHE[key] = _Plan(layout, T, block, causal)
        if len(_BUILD_CACHE) > 32:           # bound resident mask tables
            _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
    return _BUILD_CACHE[key]


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------


def _scores(qs, k, plan, bias, kvb, causal):
    """fp32 [B, H, T, T] masked scores: fine-masked and future cells at
    NEG_INF, cells outside the visited tiles at -inf."""
    s = torch.einsum("bhtd,bhsd->bhts", qs.float(), k.float())
    if bias is not None:
        s = s + bias
    if kvb is not None:
        s = s + kvb[:, None, None, :]
    live, visited = plan.token_masks(causal, s.device)
    s = torch.where(live, s, NEG_INF)
    return torch.where(visited, s, -math.inf)


def _reference_fwd(qs, k, v, plan, bias, kvb, causal):
    s = _scores(qs, k, plan, bias, kvb, causal)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1).clamp_min(1e-30)
    out = torch.einsum("bhts,bhsd->bhtd", e.to(qs.dtype).float(), v.float())
    return (out / l[..., None]).to(qs.dtype), m[..., 0] + torch.log(l)


def _reference_bwd(qs, k, v, out, lse, do, plan, bias, kvb, causal,
                   sm_scale, dbias_shape):
    """(dq, dk, dv, dbias or None) from the saved (out, lse), as the
    kernels compute them: p = exp(s - lse), delta = rowsum(do * o)."""
    dt = qs.dtype
    p = torch.exp(_scores(qs, k, plan, bias, kvb, causal) - lse[..., None])
    dof = do.float()
    delta = (dof * out.float()).sum(-1)
    dv = torch.einsum("bhts,bhtd->bhsd", p.to(dt).float(), dof)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, v.float())
    ds = p * (dp - delta[..., None])
    ds16 = ds.to(dt).float()
    dq = torch.einsum("bhts,bhsd->bhtd", ds16, k.float()).to(dt)
    dq = (dq.float() * sm_scale).to(dt)
    dk = torch.einsum("bhts,bhtd->bhsd", ds16, qs.float())
    dbias = None
    if dbias_shape is not None:
        Bb, Hb = dbias_shape[:2]
        dbias = ds.sum(1, keepdim=True) if Hb == 1 else ds
        dbias = dbias.sum(0, keepdim=True) if Bb == 1 else dbias
    return dq, dk.to(dt), dv.to(dt), dbias


def block_sparse_attention_reference(q, k, v, layout, block=16,
                                     sm_scale=None, causal=False, bias=None,
                                     key_padding_mask=None):
    """Plain version of the forward, with `block_sparse_attention`'s
    arguments: materialized fp32 masked scores at [B, H, T, T] (3.2 GB a
    tensor at B 1, H 12, T 8192). Returns (out in q's dtype, lse [B, H, T]
    fp32). `_reference_bwd` is the backward's plain version."""
    plan = _layout_plan(layout, q.shape[1], q.shape[2], block, causal)
    bias, kvb, sm_scale = _operands(q, plan, sm_scale, bias,
                                    key_padding_mask)
    qs = (q.float() * sm_scale).to(q.dtype)
    return _reference_fwd(qs, k, v, plan, bias, kvb, causal)


# ----------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_ARGTYPES = {
    # q k v o lse bias kvb counts idx fine order | B H T D maxv | strides
    # | bias_sb bias_sh | causal dtype stream
    "dstt_bsa_fwd": [_P] * 11 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    # q k v do lse delta dq dbias bias kvb counts idx fine order | B H T D
    # maxv | strides | bias_sb bias_sh | dbias_heads scale causal dtype
    # stream
    "dstt_bsa_bwd_dq": [_P] * 14 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, _P],
    # q k v do lse delta dk dv bias kvb countsT idxT fine orderT | B H T D
    # maxvT | strides | bias_sb bias_sh | causal dtype stream
    "dstt_bsa_bwd_dkv": [_P] * 14 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
}


def _kernel(symbol):
    fn = getattr(op_builder.load("block_sparse"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _strides(*tensors):
    """(batch, head, time) element strides of [B, H, T, D] views, padded to
    the 18 entries the kernels read."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * 18)(*(flat + [0] * (18 - len(flat))))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _layout_ok(t):
    """What the kernels' loads take (the forward's TMA maps): a contiguous
    last dim, the other strides positive multiples of 8 elements (16
    bytes) where the dim has more than one entry, a 16-byte aligned
    base."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (s > 0 and s % 8 == 0)
        for s, n in zip(t.stride()[:3], t.shape[:3]))


def check_kernel_operands(q, k, v, extra=()):
    """Raise ValueError for what the kernels do not take: q, k, v and the
    `extra` (name, tensor) pairs are [B, H, T, D] views of one dtype."""
    B, H, T, D = q.shape
    for name, t in [("k", k), ("v", v), *extra]:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"block_sparse_attention: {name} is {t.dtype} "
                             f"on {t.device}, q is {q.dtype} on {q.device}")
        if tuple(t.shape) != (B, H, T, D):
            raise ValueError(f"block_sparse_attention: {name} shape "
                             f"{tuple(t.shape)}, expected {(B, H, T, D)}")
    if str(q.dtype).replace("torch.", "") not in FLASH_DTYPES:
        raise ValueError(f"block_sparse_attention: the kernels take "
                         f"{FLASH_DTYPES}, got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"block_sparse_attention: head_dim {D}; the kernels "
                         f"take {KERNEL_HEAD_DIMS}")
    if T % FINE:
        raise ValueError(f"block_sparse_attention: T={T} is not a multiple "
                         f"of {FINE}")
    for name, t in [("q", q), ("k", k), ("v", v), *extra]:
        if not _layout_ok(t):
            raise ValueError(f"block_sparse_attention: {name} needs a "
                             f"contiguous last dim, positive strides in "
                             f"multiples of 8 and a 16-byte aligned base")


def _bias_strides(bias):
    """Element strides (batch, head) of a contiguous [Bb, Hb, T, T] bias, 0
    where it broadcasts."""
    if bias is None:
        return 0, 0
    Bb, Hb, T, _ = bias.shape
    return (Hb * T * T if Bb > 1 else 0), (T * T if Hb > 1 else 0)


def _launch_fwd(qs, k, v, plan, bias, kvb, causal):
    """out [B, H, T, D] view of a [B, T, H, D] tensor, lse [B, H, T]; the
    operands checked by the caller (`check_kernel_operands`)."""
    B, H, T, D = qs.shape
    counts, idx, fine, _, _, order, _ = plan.on(qs.device)
    out = torch.empty((B, T, H, D), dtype=qs.dtype,
                      device=qs.device).transpose(1, 2)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qs.device)
    rc = _kernel("dstt_bsa_fwd")(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(bias), _ptr(kvb), counts.data_ptr(),
        idx.data_ptr(), fine.data_ptr(), order.data_ptr(), B, H, T, D,
        idx.shape[-1],
        _strides(qs, k, v, out), *_bias_strides(bias), int(causal),
        op_builder.dtype_code(qs.dtype), op_builder.stream_ptr(qs.device))
    op_builder.check(rc, "block_sparse_attention")
    op_builder.LAUNCHES["block_sparse_attention"] += 1
    return out, lse


def _launch_bwd(qs, k, v, do, lse, delta, plan, bias, kvb, causal,
                sm_scale, want_dbias, need_dq=True, need_dkv=True):
    """(dq, dk, dv, dbias) with the gradients as [B, H, T, D] views of [B,
    T, H, D] tensors (None where not needed); dbias [B, Hb, T, T] fp32
    (summed over the batch by the caller where the bias broadcasts)."""
    if not _layout_ok(do):
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
    check_kernel_operands(qs, k, v, extra=[("do", do)])
    B, H, T, D = qs.shape
    counts, idx, fine, countsT, idxT, order, orderT = plan.on(qs.device)
    tail = (int(causal), op_builder.dtype_code(qs.dtype),
            op_builder.stream_ptr(qs.device))
    new = lambda: torch.empty((B, T, H, D), dtype=qs.dtype,
                              device=qs.device).transpose(1, 2)
    dq = dk = dv = dbias = None
    if need_dq or want_dbias:
        dq = new()
        if want_dbias:
            # unvisited tiles are never written: their gradient is 0
            dbias = torch.zeros((B, bias.shape[1], T, T), dtype=torch.float32,
                                device=qs.device)
        rc = _kernel("dstt_bsa_bwd_dq")(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(dbias),
            _ptr(bias), _ptr(kvb), counts.data_ptr(), idx.data_ptr(),
            fine.data_ptr(), order.data_ptr(), B, H, T, D, idx.shape[-1],
            _strides(qs, k, v, do, dq), *_bias_strides(bias),
            bias.shape[1] if want_dbias else 0, float(sm_scale), *tail)
        op_builder.check(rc, "block_sparse_attention backward (dq)")
        op_builder.LAUNCHES["block_sparse_attention_bwd_dq"] += 1
    if need_dkv:
        dk, dv = new(), new()
        rc = _kernel("dstt_bsa_bwd_dkv")(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(bias), _ptr(kvb), countsT.data_ptr(), idxT.data_ptr(),
            fine.data_ptr(), orderT.data_ptr(), B, H, T, D, idxT.shape[-1],
            _strides(qs, k, v, do, dk, dv), *_bias_strides(bias), *tail)
        op_builder.check(rc, "block_sparse_attention backward (dk/dv)")
        op_builder.LAUNCHES["block_sparse_attention_bwd_dkv"] += 1
    return dq, dk, dv, dbias


def _on_cuda(q):
    if q.device.type == "cpu":
        return False
    if not q.is_cuda:
        raise ValueError(f"block_sparse_attention: unsupported device "
                         f"{q.device}")
    return True


class _BlockSparse(torch.autograd.Function):
    """out = block_sparse(q, k, v, bias); q, k, v [B, H, T, D] views, bias
    [Bb, Hb, T, T] fp32 or None."""

    @staticmethod
    def forward(ctx, q, k, v, bias, plan, kvb, sm_scale, causal, want_dbias):
        on_cuda = _on_cuda(q)
        if on_cuda:
            check_kernel_operands(q, k, v)
        qs = (q.float() * sm_scale).to(q.dtype)
        if on_cuda:
            out, lse = _launch_fwd(qs, k, v, plan, bias, kvb, causal)
        else:
            out, lse = _reference_fwd(qs, k, v, plan, bias, kvb, causal)
        ctx.save_for_backward(qs, k, v, out, lse, bias, kvb)
        ctx.plan, ctx.sm_scale, ctx.causal = plan, sm_scale, causal
        ctx.want_dbias = want_dbias
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        qs, k, v, out, lse, bias, kvb = ctx.saved_tensors
        want_dbias = ctx.want_dbias and ctx.needs_input_grad[3]
        if not _on_cuda(qs):
            dq, dk, dv, dbias = _reference_bwd(
                qs, k, v, out, lse, do, ctx.plan, bias, kvb, ctx.causal,
                ctx.sm_scale, tuple(bias.shape) if want_dbias else None)
            return dq, dk, dv, dbias, None, None, None, None, None
        # delta = rowsum(do * o) in fp32 from the saved o, as the JAX
        # backward computes it around the Pallas kernels (:548)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        need = ctx.needs_input_grad
        dq, dk, dv, dbias = _launch_bwd(
            qs, k, v, do, lse, delta, ctx.plan, bias, kvb, ctx.causal,
            ctx.sm_scale, want_dbias, need[0], need[1] or need[2])
        if dbias is not None and bias.shape[0] == 1:
            dbias = dbias.sum(0, keepdim=True)
        return dq, dk, dv, dbias, None, None, None, None, None


def _layout_plan(layout, H, T, block, causal):
    """The memoized `_Plan` of a [H or 1, T/block, T/block] layout for H
    heads (a one-head layout broadcasts, as the configs allow)."""
    layout = np.asarray(layout, bool)
    if layout.shape[0] == 1 and H > 1:
        layout = np.broadcast_to(layout, (H,) + layout.shape[1:])
    if layout.ndim != 3 or layout.shape[0] != H:
        raise ValueError(f"block_sparse_attention: layout {layout.shape} "
                         f"for {H} heads")
    return _plan(np.ascontiguousarray(layout), T, block, bool(causal))


def _operands(q, plan, sm_scale, bias, key_padding_mask):
    """(bias [Bb, Hb, T, T] fp32 contiguous or None, additive padding row
    [B, T] fp32 or None, sm_scale), with the argument checks."""
    B, H, T, D = q.shape
    if plan.T != T or plan.fine.shape[0] != H:
        raise ValueError(f"block_sparse_attention: a plan for T={plan.T}, "
                         f"{plan.fine.shape[0]} heads; q is {tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if bias is not None:
        bias = torch.as_tensor(bias, device=q.device).float()
        while bias.dim() < 4:
            bias = bias[None]
        if bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H) \
                or tuple(bias.shape[2:]) != (T, T):
            raise ValueError(f"block_sparse_attention: bias shape "
                             f"{tuple(bias.shape)}; it takes [T, T], [Hb, T, "
                             f"T] or [Bb, Hb, T, T] with Hb in (1, {H}) and "
                             f"Bb in (1, {B})")
        bias = bias.contiguous()
    kvb = None
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=q.device)
        if tuple(kpm.shape) != (B, T):
            raise ValueError(f"block_sparse_attention: key_padding_mask "
                             f"shape {tuple(kpm.shape)}, expected {(B, T)}")
        kvb = torch.where(kpm.bool(), 0.0, NEG_INF).float().contiguous()
    return bias, kvb, float(sm_scale)


def _attend(q, k, v, plan, sm_scale=None, causal=False, bias=None,
            key_padding_mask=None, bias_needs_grad=None):
    """`block_sparse_attention` on a built plan: the entry of callers that
    keep their plan per length (`sparse_attn_fn`, `SparseSelfAttention`),
    so that no call hashes the layout again."""
    bias, kvb, sm_scale = _operands(q, plan, sm_scale, bias,
                                    key_padding_mask)
    if bias_needs_grad is None:
        bias_needs_grad = bias is not None
    return _BlockSparse.apply(q, k, v, bias, plan, kvb, sm_scale,
                              bool(causal),
                              bool(bias is not None and bias_needs_grad))


def block_sparse_attention(q, k, v, layout, block=16, sm_scale=None,
                           causal=False, bias=None, key_padding_mask=None,
                           bias_needs_grad=None):
    """q, k, v: [B, H, T, D]; layout: [H or 1, T/block, T/block] bool
    (numpy, static). Differentiable; compute scales with layout density.

    `causal=True` adds token-granular q >= k masking inside the visited
    tiles (the unidirectional layouts' tril is block-granular only).
    `bias`: additive fp32 score bias [T, T], [Hb, T, T] or [Bb, Hb, T, T]
    (Hb in {1, H}, Bb in {1, B}: a batched mask is one more stride), the
    rpe / additive attention mask; differentiable, with the dense [B, Hb,
    T, T] gradient accumulated over the visited tiles only when
    `bias_needs_grad` (default: a bias is given). `key_padding_mask`: [B,
    T] bool, True = attend; padded keys get -1e30 added to their scores."""
    plan = _layout_plan(layout, q.shape[1], q.shape[2], block, causal)
    return _attend(q, k, v, plan, sm_scale, causal, bias, key_padding_mask,
                   bias_needs_grad)
