"""Automatic prefix caching: content-addressed KV-block reuse across
requests (counterpart of `deepspeed_tpu/inference/prefix_cache.py`; numpy
and hashlib only).

A FULL KV block's content is a pure function of the tokens in and before
it and of the model, so requests that share a prompt prefix can share its
physical blocks: the serving scheduler maps the same blocks into several
slots' tables.

  * every full prompt block gets a CHAINED content hash —
    ``h_i = sha256(h_{i-1} || tokens[i*bs:(i+1)*bs])`` seeded with the
    model's cache-identity fingerprint (`DecodeModelSpec.cache_fingerprint`)
    — so a hash names the whole prefix through that block. Given the same
    fingerprint and prompt the chain is byte-equal to the JAX package's;
  * a hash -> block map serves longest-prefix match at admission;
  * a block is registered only once the prefill cursor has passed it and
    only if it lies strictly below ``prompt_len``, so shared blocks are
    immutable by construction;
  * refcount-0 registered blocks park on the allocator's reclaimable LRU;
    eviction (via the allocator's `on_evict` hook) happens only when an
    allocation would otherwise fail.
"""

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.inference.kv_cache import BlockAllocator


class PrefixCache:
    """Hash-chain -> physical-block map over a `BlockAllocator`. It owns no
    blocks and moves no data: it installs itself as the allocator's
    `is_cached` / `on_evict` hooks, so eviction and unregistration cannot
    drift apart."""

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 fingerprint: Optional[str] = None):
        self.allocator = allocator
        self.block_size = int(block_size)
        # the chain root commits every hash to this model's cache identity
        self._root = hashlib.sha256(
            b"dstpu-prefix-cache:" + (fingerprint or "").encode()).digest()
        self._by_hash: Dict[bytes, int] = {}
        self._by_block: Dict[int, bytes] = {}
        allocator.is_cached = self._by_block.__contains__
        allocator.on_evict = self._unregister_block

    def hash_chain(self, prompt: Sequence[int]) -> List[bytes]:
        """Chained hashes of the prompt's full blocks, computed once per
        request at submit."""
        arr = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
        bs = self.block_size
        out, h = [], self._root
        for i in range(len(arr) // bs):
            h = hashlib.sha256(h + arr[i * bs:(i + 1) * bs].tobytes()).digest()
            out.append(h)
        return out

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Physical blocks of the leading run of registered hashes. Pure
        lookup: the caller increfs the winners."""
        blocks = []
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def match_len(self, hashes: Sequence[bytes]) -> int:
        """Length (in blocks) of the longest registered prefix; touches no
        refcount and no LRU entry (a router's affinity score)."""
        n = 0
        for h in hashes:
            if h not in self._by_hash:
                break
            n += 1
        return n

    def register(self, h: bytes, block: int) -> bool:
        """`block` now holds the fully written content named by `h`. First
        writer wins: a second block with the same hash stays uncached."""
        if h in self._by_hash or block in self._by_block:
            return False
        self._by_hash[h] = block
        self._by_block[block] = h
        return True

    def _unregister_block(self, block: int):
        h = self._by_block.pop(block, None)
        if h is not None:
            self._by_hash.pop(h, None)

    @property
    def num_cached(self) -> int:
        """Registered blocks (live shared + reclaimable)."""
        return len(self._by_block)

    def snapshot(self) -> Dict[str, int]:
        """The forward map (hash hex -> block), all JSON types: the audit
        state's `registered`."""
        return {h.hex(): int(b) for h, b in self._by_hash.items()}

    def reverse_snapshot(self) -> Dict[int, str]:
        """The reverse map (block -> hash hex); the auditor checks the two
        are inverse bijections."""
        return {int(b): h.hex() for b, h in self._by_block.items()}
