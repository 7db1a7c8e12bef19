"""Block-sparse attention (counterpart of `deepspeed_tpu/ops/sparse_attention.py`).

The sparsity configs build [H, T/block, T/block] bool block layouts with the
JAX package's layout math (numpy, the same `np.random.default_rng(seed)`
draws for BigBird's and Variable's random blocks), so one config gives both
packages the same layout bit for bit.

`SparseSelfAttention` / `sparse_attn_fn` run the block-sparse kernel
(`ops/block_sparse_attention.py`, `csrc/block_sparse.cu`): rpe and an
attention mask become its additive bias, a key-padding mask its padding
row. On a CUDA tensor every call takes the kernel or raises. The kernel
takes any T that is a multiple of 16 and reads the bias with a batch stride,
so a batched [B, T, T] mask takes it too. On a CPU tensor the call runs
where the JAX package runs: the kernel's plain version where JAX takes its
kernel (T % 128 == 0, batch-shared masks), else JAX's dense masked fp32
fallback with the same warning.
"""

import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.block_sparse_attention import (
    NEG_INF, _attend, _layout_plan)
from deepspeed_tpu_torch.utils.logging import logger


class SparsityConfig:
    """Base: builds a [num_heads, num_blocks, num_blocks] bool layout, True =
    attend."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len):
        if seq_len % self.block:
            raise ValueError(f"seq {seq_len} % block {self.block} != 0")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool), n

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows of `num_local_blocks` + global attention to the last
    `num_global_blocks` of each window."""

    def __init__(self, num_heads, block=16, num_local_blocks=4,
                 num_global_blocks=1, attention="bidirectional",
                 horizontal_global_attention=False,
                 num_different_global_patterns=1,
                 different_layout_per_head=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global = horizontal_global_attention

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        L, G = self.num_local_blocks, self.num_global_blocks
        for i in range(n):
            w = i // L
            start = w * L
            for j in range(start, min(start + L, n)):
                layout[:, i, j] = True
            for pw in range(w + 1):
                g0 = (pw + 1) * L - G
                for j in range(max(g0, 0), min((pw + 1) * L, n)):
                    layout[:, i, j] = True
                    if self.horizontal_global:
                        layout[:, j, i] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + global blocks."""

    def __init__(self, num_heads, block=16, num_random_blocks=1,
                 num_sliding_window_blocks=3, num_global_blocks=1,
                 attention="bidirectional", seed=0,
                 different_layout_per_head=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding = num_sliding_window_blocks
        self.num_global = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        rng = np.random.default_rng(self.seed)
        w = self.num_sliding // 2
        for i in range(n):
            for j in range(max(0, i - w), min(n, i + w + 1)):
                layout[:, i, j] = True
        layout[:, :, :self.num_global] = True
        layout[:, :self.num_global, :] = True
        for h in range(self.num_heads if self.different_layout_per_head
                       else 1):
            for i in range(n):
                for j in rng.choice(n, size=min(self.num_random_blocks, n),
                                    replace=False):
                    layout[h if self.different_layout_per_head
                           else slice(None), i, j] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + selected global block indices."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 global_block_indices=(0,), global_block_end_indices=None,
                 attention="bidirectional", different_layout_per_head=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding = num_sliding_window_blocks
        self.global_idx = list(global_block_indices)
        self.global_end = (list(global_block_end_indices)
                           if global_block_end_indices is not None else None)
        self.attention = attention

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        w = self.num_sliding // 2
        for i in range(n):
            for j in range(max(0, i - w), min(n, i + w + 1)):
                layout[:, i, j] = True
        _apply_globals(layout, n, self.global_idx, self.global_end,
                       horizontal=True)
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Local windows of varying sizes + globals (+ random blocks)."""

    def __init__(self, num_heads, block=16, num_random_blocks=0,
                 local_window_blocks=(4,), global_block_indices=(0,),
                 global_block_end_indices=None, attention="bidirectional",
                 horizontal_global_attention=False,
                 different_layout_per_head=False, seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_windows = list(local_window_blocks)
        self.global_idx = list(global_block_indices)
        self.global_end = (list(global_block_end_indices)
                           if global_block_end_indices is not None else None)
        self.attention = attention
        self.horizontal_global = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        start = 0
        wi = 0
        while start < n:
            size = self.local_windows[min(wi, len(self.local_windows) - 1)]
            end = min(start + size, n)
            layout[:, start:end, start:end] = True
            start = end
            wi += 1
        _apply_globals(layout, n, self.global_idx, self.global_end,
                       horizontal=self.horizontal_global)
        if self.num_random_blocks > 0:
            rng = np.random.default_rng(self.seed)
            heads = range(self.num_heads) if self.different_layout_per_head \
                else [slice(None)]
            for h in heads:
                for i in range(n):
                    for j in rng.choice(n, size=min(self.num_random_blocks, n),
                                        replace=False):
                        layout[h, i, j] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


def _apply_globals(layout, n, global_idx, global_end, horizontal):
    """Global attention blocks: single indices, or ranges when end indices
    are given."""
    if global_end is not None:
        cols = []
        for s, e in zip(global_idx, global_end):
            cols.extend(range(s, min(e, n)))
    else:
        cols = [g for g in global_idx if g < n]
    for g in cols:
        layout[:, :, g] = True
        if horizontal:
            layout[:, g, :] = True


class SparseSelfAttention:
    """`__call__(q, k, v, rpe=None, key_padding_mask=None, attn_mask=None)`
    with layout masking; q, k, v: [B, H, T, hd].

    rpe ([T, T] or [Hb, T, T], Hb in {1, H}) and an attention mask ("mul":
    nonzero = keep, masked cells get -1e30; "add": added to the scores)
    sum into the kernel's fp32 bias; the key-padding mask ([B, T], True /
    nonzero = attend) becomes its additive padding row. The dense [B, Hb,
    T, T] bias gradient is computed only where the JAX package computes it:
    a learned rpe (`rpe_requires_grad`) or an add-mode mask."""

    def __init__(self, sparsity_config=None, softmax_scale=None,
                 attn_mask_mode="mul", rpe_requires_grad=True):
        self.config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.softmax_scale = softmax_scale
        self.attn_mask_mode = attn_mask_mode
        self.rpe_requires_grad = rpe_requires_grad
        self._layouts = {}
        self._plans = {}
        self._warned = set()

    def _warn_once(self, key, msg):
        if key not in self._warned:
            self._warned.add(key)
            logger.warning(msg)

    def _layout(self, T):
        if T not in self._layouts:
            self._layouts[T] = self.config.make_layout(T)
        return self._layouts[T]

    def _plan(self, H, T):
        """The kernel's plan for (H, T), built once: a call then does no
        host work on the [H, T/16, T/16] layout."""
        if (H, T) not in self._plans:
            self._plans[H, T] = _layout_plan(self._layout(T), H, T,
                                             self.config.block, False)
        return self._plans[H, T]

    def _kernel_operands(self, query, rpe, attn_mask, key_padding_mask):
        """(bias [Bb, Hb, T, T] fp32 or None, padding mask [B, T] bool or
        None, batched): the kernel's operands, with `batched` True for a
        [B, T, T] attention mask (the JAX package's kernel refuses it).
        None where the kernel takes no such operands."""
        B, H, T, _ = query.shape
        bias, batched = None, False
        if rpe is not None:
            r = torch.as_tensor(rpe)
            if r.dim() == 2:
                r = r[None]
            if r.dim() != 3 or tuple(r.shape[-2:]) != (T, T) \
                    or r.shape[0] not in (1, H):
                return None
            bias = r.to(query.device).float()[None]
        if attn_mask is not None:
            m = torch.as_tensor(attn_mask)
            while m.dim() > 2 and m.shape[0] == 1:
                m = m[0]
            if m.dim() == 3 and m.shape[0] == B:
                batched, m = True, m[:, None]
            elif m.dim() == 2:
                m = m[None, None]
            else:
                return None
            if tuple(m.shape[-2:]) != (T, T):
                return None
            m = m.to(query.device)
            mb = torch.where(m != 0, 0.0, NEG_INF).float() \
                if self.attn_mask_mode == "mul" else m.float()
            bias = mb if bias is None else bias + mb
        kpm = None
        if key_padding_mask is not None:
            p = torch.as_tensor(key_padding_mask)
            if tuple(p.shape) != (B, T):
                return None
            kpm = (p if p.dtype == torch.bool else p != 0).to(query.device)
        return bias, kpm, batched

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        B, H, T, hd = query.shape
        scale = self.softmax_scale or 1.0 / math.sqrt(hd)
        ops = self._kernel_operands(query, rpe, attn_mask, key_padding_mask)
        if query.is_cuda and ops is None:
            raise NotImplementedError(
                "SparseSelfAttention on CUDA: the block-sparse kernel takes "
                "rpe [T, T] / [1 or H, T, T], an attention mask [T, T] / "
                "[1, T, T] / [B, T, T] and a key-padding mask [B, T]; the "
                "port runs no dense attention on the card")
        if query.is_cuda or (ops is not None and not ops[2]
                             and T % 128 == 0):
            bias, kpm, _ = ops
            return _attend(
                query, key, value, self._plan(H, T), sm_scale=scale,
                bias=bias, key_padding_mask=kpm,
                bias_needs_grad=((rpe is not None and self.rpe_requires_grad)
                                 or (attn_mask is not None
                                     and self.attn_mask_mode == "add")))
        self._warn_once(
            ("dense", T),
            f"SparseSelfAttention: dense O(T^2) fallback engaged (T={T}; "
            "kernel needs T % 128 == 0 and batch-shared masks) — at long "
            "sequences this defeats the sparse kernel's memory/compute "
            "savings")
        return self._dense(query, key, value, scale, rpe, attn_mask,
                           key_padding_mask)

    def _dense(self, query, key, value, scale, rpe, attn_mask,
               key_padding_mask):
        """The JAX package's dense masked fp32 fallback: the layout
        expanded at its own block (not normalized to 16), masks selected
        with -1e30. A batched [B, T, T] mask is indexed by batch row, as
        the kernel reads it (JAX broadcasts it as [1, B, T, T])."""
        T = query.shape[2]
        blk = self.config.block
        mask = torch.from_numpy(np.kron(self._layout(T), np.ones(
            (blk, blk), dtype=bool))).to(query.device)
        s = torch.einsum("bhtd,bhsd->bhts", query.float(),
                         key.float()) * scale
        if rpe is not None:
            s = s + torch.as_tensor(rpe, device=query.device)
        s = torch.where(mask[None], s, NEG_INF)
        if attn_mask is not None:
            m = torch.as_tensor(attn_mask, device=query.device)
            if m.dim() == 3 and m.shape[0] == query.shape[0]:
                m = m[:, None]          # [B, T, T]: one mask per batch row
            while m.dim() < 4:
                m = m[None]
            if self.attn_mask_mode == "mul":
                s = torch.where(m != 0, s, NEG_INF)
            else:
                s = s + m.float()
        if key_padding_mask is not None:
            kpm = torch.as_tensor(key_padding_mask, device=query.device)
            s = torch.where(kpm[:, None, None, :] != 0, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhts,bhsd->bhtd", p, value.float()) \
            .to(query.dtype)


class BertSparseSelfAttention(SparseSelfAttention):
    """Name-parity wrapper."""


def sparse_attn_fn(sparsity_config, softmax_scale=None, causal=None):
    """Adapter for the GPT model's `attn_fn` slot (q, k, v as [B, T, H,
    hd]): block-sparse attention in GPT training and evaluation.

    A config with attention="unidirectional" tril-masks its layout at BLOCK
    granularity only (a diagonal block is fully open), so `causal`
    defaults to that inference and adds token-granular causal masking in
    the kernel; pass it explicitly for encoder use.

        model = make_gpt_model(cfg, attn_fn=sparse_attn_fn(
            FixedSparsityConfig(num_heads=cfg.n_head,
                                attention="unidirectional")))
    """
    if causal is None:
        causal = getattr(sparsity_config, "attention", "") == "unidirectional"
    plans = {}      # (H, T) -> the kernel's plan, built once per length

    def fn(q, k, v):
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))    # [B, H, T, hd]
        H, T, hd = q.shape[1:]
        scale = softmax_scale or 1.0 / math.sqrt(hd)
        if (H, T) not in plans:
            plans[H, T] = _layout_plan(sparsity_config.make_layout(T), H, T,
                                       sparsity_config.block, causal)
        out = _attend(q, k, v, plans[H, T], sm_scale=scale, causal=causal)
        return out.transpose(1, 2)

    return fn
