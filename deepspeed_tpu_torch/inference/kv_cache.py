"""Paged KV-cache pool — the serving engine's memory system (counterpart of
`deepspeed_tpu/inference/kv_cache.py`).

The engine owns ONE pool of physical blocks allocated once at init —
``k/v: [L, num_blocks, Hkv, block, hd]`` — and each serving slot holds a
block TABLE mapping its logical blocks to physical ones. The paged decode
kernel resolves a row's positions through its table, so admission is a
free-list pop, a sequence's blocks free the step it finishes, and
fragmentation stays below one block per sequence.

Block 0 is RESERVED as the trash block: inactive slots point every table
entry at it, so the fixed-shape decode step runs over all slots — dead
slots' writes land there and their reads produce output nobody looks at.

The allocator is host-side plain Python. Prefix caching (and with it the
JAX allocator's reclaimable LRU list) is not ported yet; the reference
counts are, so a shared block frees only when its last reader lets go.
"""

from typing import List, Optional

import torch

TRASH_BLOCK = 0  # physical block 0: write sink for inactive slots


class BlockAllocator:
    """Ref-counted free list over the physical blocks of a paged pool.

    Block 0 (TRASH_BLOCK) is never handed out. alloc() is all-or-nothing:
    a request gets every block it needs or stays queued — partial
    allocation would deadlock two half-admitted requests. The free list
    pops low ids first; a shadow set makes the double-free guard O(1)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 1 usable block past the trash "
                             "block")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs = {}                     # block -> refcount

    @property
    def capacity(self) -> int:
        """Usable blocks (the trash block is not allocatable)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, b: int) -> int:
        return self._refs.get(b, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n blocks, or None (and no state change) if fewer are free."""
        if n > len(self._free):
            return None
        got = []
        for _ in range(n):
            b = self._free.pop()
            self._free_set.discard(b)
            self._refs[b] = 1
            got.append(b)
        return got

    def incref(self, b: int) -> int:
        """Add a reader to an allocated block."""
        if b == TRASH_BLOCK or b not in self._refs:
            raise ValueError(f"incref of unallocated block {b}")
        self._refs[b] += 1
        return self._refs[b]

    def free(self, blocks: List[int]):
        """Decref each block; at zero it returns to the free list."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("freeing the trash block")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            if self._refs.get(b, 0) <= 0:
                raise ValueError(f"free of unallocated block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                self._free_set.add(b)


def max_written_pos(prompt_len: int, padded_prompt: int, max_new: int,
                    window: int = 1) -> int:
    """Highest cache position a request ever WRITES — the one source of
    truth for pool sizing (blocks_needed) and admission validation.

    Chunked prefill writes the padded prompt's tail, and decode writes
    token i's k/v at prompt_len + i for i in [0, max_new-1) — the final
    token is emitted without a decode step. With a decode window > 1 the
    device runs whole windows blindly, so the decode writes round UP to a
    window multiple."""
    decode_writes = max_new - 1
    if window > 1 and decode_writes > 0:
        decode_writes = -(-decode_writes // window) * window
    return max(padded_prompt - 1, prompt_len - 1 + decode_writes)


def blocks_needed(prompt_len: int, padded_prompt: int, max_new: int,
                  block_size: int, window: int = 1) -> int:
    """Physical blocks a request occupies for its whole lifetime."""
    return max_written_pos(prompt_len, padded_prompt, max_new,
                           window) // block_size + 1


def gather_block_kv(pool_k_l, pool_v_l, block_tables):
    """Materialize each row's logical KV as contiguous [B, Hkv, nb*block, hd]
    — the plain paged-attention path (chunked prefill, the CPU) and the
    paged kernel's plain version. pool_[kv]_l: [N, Hkv, block, hd] (one
    layer's pool); block_tables: [B, nb]."""
    B, nb = block_tables.shape
    _, Hkv, bm, hd = pool_k_l.shape
    idx = block_tables.to(device=pool_k_l.device, dtype=torch.long)
    k = pool_k_l[idx].transpose(1, 2).reshape(B, Hkv, nb * bm, hd)
    v = pool_v_l[idx].transpose(1, 2).reshape(B, Hkv, nb * bm, hd)
    return k, v


def gather_block_kv_dequant(pool_l, block_tables, dtype):
    """The dequantizing gather over one layer of the INT8 pool — the
    chunked-prefill path's read (and single-token decode's on the CPU).
    pool_l: {"k", "v"} int8 [N, Hkv, block, hd] and {"k_scale", "v_scale"}
    f32 [N, Hkv, block, hd // g]. Gathers payload and scales through the
    table like `gather_block_kv`, then `dequantize_kv` (int8 x scale in
    fp32, narrowed to `dtype` last: the `dequantize_int8` kernel on CUDA)."""
    from deepspeed_tpu_torch.inference.quantization import dequantize_kv
    k, v = gather_block_kv(pool_l["k"], pool_l["v"], block_tables)
    ks, vs = gather_block_kv(pool_l["k_scale"], pool_l["v_scale"],
                             block_tables)
    return dequantize_kv(k, ks, dtype), dequantize_kv(v, vs, dtype)
