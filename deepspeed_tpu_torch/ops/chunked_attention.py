"""Query-chunked causal attention (counterpart of
`deepspeed_tpu/ops/chunked_attention.py`).

An explicit memory escape hatch (`GPTConfig.chunked_attn_min_seq`): the
query axis is cut into blocks of `block_q` rows, and each block's [block_q,
T] score strip runs under `torch.utils.checkpoint`, so forward and backward
hold one strip at a time and the backward recomputes it instead of keeping
B·H·T² probabilities. Plain torch, as the JAX package's version is plain
XLA: the attention dispatch runs it on CUDA too, where the config asks for
it (`ops/attention_dispatch.py`). The flash kernels have no sequence cap and
are the fast path at every T.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.chunked_ce import mm_f32


def _strip(q_blk, k, v, q0, causal):
    """Attention of one query block. q_blk [B·H, bq, D] (pre-scaled), k / v
    [B·H, T, D]; the block's first row is query position q0. Scores and the
    softmax in fp32, P narrowed to the input dtype before P·V."""
    bq, T = q_blk.shape[1], k.shape[1]
    s = mm_f32(q_blk, k.transpose(1, 2))                       # [B·H, bq, T]
    if causal:
        q_pos = q0 + torch.arange(bq, device=s.device)[:, None]
        k_pos = torch.arange(T, device=s.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, -1e30)
    p = torch.softmax(s, dim=-1)
    return mm_f32(p.to(q_blk.dtype), v).to(q_blk.dtype)


def chunked_attention(q, k, v, causal=True, sm_scale=None, block_q=1024):
    """q, k, v: [B, H, T, D] -> [B, H, T, D]. Differentiable.

    The query axis is padded to whole blocks (k and v are not: padded rows
    attend the real keys, and their outputs are dropped at the end, so
    they carry no cotangent). q is scaled by `sm_scale` (default
    1/sqrt(D)) in fp32 and narrowed back to its dtype before the score
    product, as in the JAX package."""
    B, H, T, D = q.shape
    if k.shape[2] != T or v.shape[2] != T:
        raise ValueError(
            f"chunked_attention is self-attention: q/k/v must share T (got "
            f"q T={T}, k T={k.shape[2]}, v T={v.shape[2]})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    block_q = min(block_q, T)
    pad = -T % block_q
    qs = (q.float() * sm_scale).to(q.dtype)
    if pad:
        qs = F.pad(qs, (0, 0, 0, pad))
    qs = qs.reshape(B * H, T + pad, D)
    k = k.reshape(B * H, T, D)
    v = v.reshape(B * H, T, D)
    remat = torch.is_grad_enabled()
    strips = []
    for q0 in range(0, T + pad, block_q):
        q_blk = qs[:, q0:q0 + block_q]
        strips.append(
            checkpoint(_strip, q_blk, k, v, q0, causal, use_reentrant=False)
            if remat else _strip(q_blk, k, v, q0, causal))
    out = torch.cat(strips, dim=1).reshape(B, H, T + pad, D)
    return out[:, :, :T] if pad else out
