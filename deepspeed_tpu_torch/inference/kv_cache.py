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

The allocator is host-side plain Python. Prefix caching
(`inference/prefix_cache.py`) layers on its reference counts: a block
shared by several sequences frees only when its last reader retires, and a
refcount-0 block whose content is still registered parks on a reclaimable
LRU instead of the free list. `alloc()` counts reclaimable blocks as
available and evicts them (through the `on_evict` hook, which unregisters
the hash) only when the free list cannot serve a request, so caching never
reduces usable capacity.
"""

import collections
from typing import List, Optional

import torch

TRASH_BLOCK = 0  # physical block 0: write sink for inactive slots


class BlockAllocator:
    """Ref-counted free list over the physical blocks of a paged pool.

    Block 0 (TRASH_BLOCK) is never handed out. alloc() is all-or-nothing:
    a request gets every block it needs or stays queued — partial
    allocation would deadlock two half-admitted requests. The free list
    pops low ids first; a shadow set makes the double-free guard O(1).

    Every allocated block carries a refcount (1 at alloc); `incref` adds a
    reader, `free` is a decref. At zero a block that `is_cached` claims
    parks on the reclaimable LRU (policy "lru"); everything else, and
    every block under policy "none", returns to the free list, its cached
    content unregistered on the spot."""

    def __init__(self, num_blocks: int, policy: str = "lru"):
        if num_blocks < 2:
            raise ValueError("pool needs >= 1 usable block past the trash "
                             "block")
        if policy not in ("lru", "none"):
            raise ValueError(f"unknown reclaim policy {policy!r} (expected "
                             f"'lru' or 'none')")
        self.num_blocks = num_blocks
        self.policy = policy
        self._free = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs = {}                     # block -> refcount (0: parked)
        self._reclaimable = collections.OrderedDict()   # LRU, oldest first
        self.is_cached = None               # hook: block -> bool
        self.on_evict = None                # hook: block evicted
        self.evictions = 0

    @property
    def capacity(self) -> int:
        """Usable blocks (the trash block is not allocatable)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_reclaimable(self) -> int:
        return len(self._reclaimable)

    @property
    def available(self) -> int:
        """Blocks an alloc() can obtain: free + reclaimable. This, not
        num_free, is what admission backpressure reads."""
        return len(self._free) + len(self._reclaimable)

    def refcount(self, b: int) -> int:
        return self._refs.get(b, 0)

    def _push_free(self, b: int):
        self._free.append(b)
        self._free_set.add(b)

    def _evict_one(self):
        """Recycle the least-recently-parked reclaimable block: unregister
        its content (on_evict) and hand it to the free list."""
        b, _ = self._reclaimable.popitem(last=False)
        del self._refs[b]
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(b)
        self._push_free(b)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n blocks, or None (and no state change) if fewer are
        available. Reclaimable blocks are evicted oldest first, only as
        many as the free list is short."""
        if n > self.available:
            return None
        while len(self._free) < n:
            self._evict_one()
        got = []
        for _ in range(n):
            b = self._free.pop()
            self._free_set.discard(b)
            self._refs[b] = 1
            got.append(b)
        return got

    def incref(self, b: int) -> int:
        """Add a reader to an allocated or reclaimable block (a prefix-cache
        hit). A reclaimable block leaves the LRU: its content is live
        again without a copy."""
        if b == TRASH_BLOCK or b not in self._refs or b in self._free_set:
            raise ValueError(f"incref of unallocated block {b}")
        self._refs[b] += 1
        self._reclaimable.pop(b, None)
        return self._refs[b]

    def flush_reclaimable(self, keep: int = 0) -> int:
        """Evict parked blocks now, oldest first, down to `keep` survivors
        (the degradation ladder's cache-flush rung). Returns the number
        evicted."""
        n = 0
        while len(self._reclaimable) > max(0, int(keep)):
            self._evict_one()
            n += 1
        return n

    def free(self, blocks: List[int]):
        """Decref each block; at zero it parks (cached, policy "lru") or
        returns to the free list."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("freeing the trash block")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            if self._refs.get(b, 0) <= 0:
                raise ValueError(f"free of unallocated block {b}")
            self._refs[b] -= 1
            if self._refs[b] > 0:
                continue
            cached = self.is_cached is not None and self.is_cached(b)
            if cached and self.policy == "lru":
                self._reclaimable[b] = None     # most-recently-parked end
            else:
                # not an eviction: `evictions` counts demand-driven reclaim
                if cached and self.on_evict is not None:
                    self.on_evict(b)
                del self._refs[b]
                self._push_free(b)


def max_written_pos(prompt_len: int, padded_prompt: int, max_new: int,
                    window: int = 1, spec_k: int = 0) -> int:
    """Highest cache position a request ever WRITES — the one source of
    truth for pool sizing (blocks_needed) and admission validation.

    Chunked prefill writes the padded prompt's tail, and decode writes
    token i's k/v at prompt_len + i for i in [0, max_new-1) — the final
    token is emitted without a decode step. With a decode window > 1 the
    device runs whole windows blindly, so the decode writes round UP to a
    window multiple. Speculative decoding (`spec_k` drafts a verify)
    replaces the window: a verify writes its input token and all k drafts,
    and a slot still verifies while one token short of its budget, so the
    extent grows by the k-token overhang — only when there are decode
    writes at all (a max_new=1 request never verifies)."""
    decode_writes = max_new - 1
    if spec_k > 0 and decode_writes > 0:
        decode_writes += spec_k
    elif window > 1 and decode_writes > 0:
        decode_writes = -(-decode_writes // window) * window
    return max(padded_prompt - 1, prompt_len - 1 + decode_writes)


def blocks_needed(prompt_len: int, padded_prompt: int, max_new: int,
                  block_size: int, window: int = 1, spec_k: int = 0) -> int:
    """Physical blocks a request occupies for its whole lifetime."""
    return max_written_pos(prompt_len, padded_prompt, max_new, window,
                           spec_k) // block_size + 1


def transplant_blocks(src_pool, src_blocks, dst_pool, dst_blocks,
                      pad_to: Optional[int] = None):
    """Copy physical KV blocks across two pools — the prefill->decode
    handoff primitive (`serving/router.py`): a slot prefilled on one
    replica moves into another replica's pool by copying its blocks and
    rebuilding the block table there.

    Every pool leaf is ``[L, num_blocks, ...]`` (axis 1 is the
    physical-block axis, the `init_paged_kv_pool` contract), so the copy is
    one `index_copy_` a leaf along axis 1, IN PLACE on the destination:
    the int8 pool's `k_scale` / `v_scale` move block for block with their
    payload. `pad_to` is accepted for the reference's signature: pad
    entries copy trash to trash, whose content is garbage by contract.

    Returns `dst_pool` (updated in place). Both pools must share leaf
    names and dtypes; the trash block is never a source or destination of
    a real entry."""
    src_blocks, dst_blocks = list(src_blocks), list(dst_blocks)
    if len(src_blocks) != len(dst_blocks):
        raise ValueError(f"transplant width mismatch: {len(src_blocks)} vs "
                         f"{len(dst_blocks)}")
    if TRASH_BLOCK in src_blocks or TRASH_BLOCK in dst_blocks:
        raise ValueError("transplant of the trash block")
    if sorted(src_pool) != sorted(dst_pool):
        raise ValueError(f"pool leaf mismatch: {sorted(src_pool)} vs "
                         f"{sorted(dst_pool)}")
    for name in sorted(dst_pool):
        d, s = dst_pool[name], src_pool[name]
        if d.dtype != s.dtype:
            raise ValueError(f"pool dtype mismatch: {d.dtype} vs {s.dtype}")
    if not src_blocks:
        return dst_pool
    if pad_to is not None and pad_to > len(src_blocks):
        pad = pad_to - len(src_blocks)
        src_blocks += [TRASH_BLOCK] * pad
        dst_blocks += [TRASH_BLOCK] * pad
    for name in sorted(dst_pool):
        d, s = dst_pool[name], src_pool[name]
        si = torch.as_tensor(src_blocks, dtype=torch.long, device=s.device)
        di = torch.as_tensor(dst_blocks, dtype=torch.long, device=d.device)
        d.index_copy_(1, di, s.index_select(1, si).to(d.device))
    return dst_pool


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
