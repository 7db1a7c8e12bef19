"""Chunked-vocab softmax cross entropy (counterpart of
`deepspeed_tpu/ops/chunked_ce.py`).

`chunked_softmax_xent(x, w, labels, n_chunks)` returns each token's
negative log-likelihood without holding the [N, V] logits: the forward
streams the head product one vocabulary chunk at a time through an online
log-sum-exp (the m / s recurrence of flash attention) and picks the gold
logit in its chunk; the backward recomputes each chunk's logits to form
(softmax - onehot) locally. Live memory is one [N, per] fp32 chunk and its
temporaries, for one more head product in the backward.

The chunks are the JAX package's: per = ceil(V / n_chunks) rounded up to
128 columns, so V 50304 at 8 chunks is 8 x 6400 and the last chunk holds
6144 real columns. JAX pads `w` with zero rows and masks the padded
columns (-inf in the forward, p = 0 in the backward); here each chunk is a
slice of `w` that stops at V, which leaves the same sums.

The JAX package computes this in plain XLA (no Pallas kernel), and so does
the port: the chunk products are `torch.mm`, the rest elementwise torch.
Each chunk's logits are fp32 from operands in their own dtype, as JAX's
`preferred_element_type=jnp.float32`: `mm_f32` takes a bf16 / fp16 product
with an fp32 output (`torch.mm(..., out_dtype=torch.float32)`) on CUDA, and
on the CPU, whose torch has no kernel for that overload, the product of the
operands widened to fp32 (products of 16-bit values are exact in fp32, so
the two differ only in the order of fp32 sums).
"""

import torch


def chunk_width(vocab, n_chunks):
    """Columns a chunk: ceil(V / n) rounded up to 128 (JAX's `_pad_rows`)."""
    per = -(-vocab // n_chunks)
    return -(-per // 128) * 128


def mm_f32(a, b):
    """a @ b as fp32 from operands in their own dtype: 2-D (mm) or 3-D
    (bmm). Two 16-bit operands of one dtype on CUDA take an fp32-output
    product; anything else the product of the operands widened to fp32."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.is_cuda and a.dtype == b.dtype and a.dtype != torch.float32:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


def _chunks(vocab, n_chunks):
    """(first column, one past the last real column) of each chunk that
    holds a real column."""
    per = chunk_width(vocab, n_chunks)
    return [(lo, min(lo + per, vocab)) for lo in range(0, vocab, per)]


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, labels, n_chunks):
        N = x.shape[0]
        safe = labels.clamp_min(0).long()
        m = torch.full((N,), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros(N, dtype=torch.float32, device=x.device)
        gold = torch.zeros(N, dtype=torch.float32, device=x.device)
        for lo, hi in _chunks(w.shape[0], n_chunks):
            logits = mm_f32(x, w[lo:hi].t())                  # [N, hi - lo]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            idx = (safe - lo).clamp(0, hi - lo - 1)
            picked = logits.gather(1, idx[:, None])[:, 0]
            gold = torch.where((safe >= lo) & (safe < hi), picked, gold)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.n_chunks = n_chunks
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        safe = labels.clamp_min(0).long()
        g = g.float()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
            if need_dx else None
        dw = torch.empty_like(w) if need_dw else None
        for lo, hi in _chunks(w.shape[0], ctx.n_chunks):
            w_c = w[lo:hi]
            p = torch.exp(mm_f32(x, w_c.t()) - lse[:, None])  # softmax chunk
            # p - onehot: subtract 1 at each row's label, where it is in
            # this chunk (0 elsewhere)
            hit = ((safe >= lo) & (safe < hi)).float()
            p.scatter_add_(1, (safe - lo).clamp(0, hi - lo - 1)[:, None],
                           -hit[:, None])
            dl = (p * g[:, None]).to(x.dtype)
            del p
            if need_dx:
                dx += mm_f32(dl, w_c)
            if need_dw and w.dtype == x.dtype:
                # one rounding of the fp32-accumulated product, as JAX's
                # fp32 product cast to w's dtype
                torch.mm(dl.t(), x, out=dw[lo:hi])
            elif need_dw:
                dw[lo:hi] = mm_f32(dl.t(), x)
        return (dx.to(x.dtype) if need_dx else None), dw, None, None


def chunked_softmax_xent(x, w, labels, n_chunks=12):
    """Per-token negative log-likelihood without the [N, V] logits.

    x: [N, D] activations (any float dtype); w: [V, D] head table; labels:
    [N] int, entries < 0 taken as label 0 (the caller masks the returned
    nll: a masked token's cotangent is 0, so its gradient vanishes).
    Returns nll [N] fp32. Differentiable in x and w; dx comes back in x's
    dtype (summed over the chunks in fp32), dw in w's."""
    return _ChunkedXent.apply(x, w, labels, int(n_chunks))
