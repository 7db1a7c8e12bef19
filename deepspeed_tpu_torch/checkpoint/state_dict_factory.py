"""Legacy state-dict loaders with TP-degree resharding.

Reference: `runtime/state_dict_factory.py:21` (`SDLoaderFactory`) and `:190`
(`MegatronSDLoader`) — at inference load time, N saved tensor-parallel shard
files are merged (N→1), split (1→M), or resharded (N→M) to the serving TP
degree, with qkv tensors needing ordering-aware treatment because the three
projections are interleaved differently per model family.

Counterpart of `deepspeed_tpu/checkpoint/state_dict_factory.py`, byte for
byte: shards are flat ``{name: np.ndarray}`` dicts; resharding is pure
numpy on the host before the tensors move to the card. Merge/split axes
come from a rules table (name-pattern → axis / qkv mode), the same role as the
reference's per-architecture policy classes.
"""

import fnmatch
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ShardRule:
    """How one parameter reshards across TP ranks.

    axis: concat/split axis; None = replicated (must be identical across shards).
    qkv: None, 'megatron' ([q1 k1 v1 q2 k2 v2 ...] interleaved per head-group) or
         'packed' ([Q; K; V] stacked blocks).
    """
    pattern: str
    axis: Optional[int]
    qkv: Optional[str] = None


# Default rules matching our model families (gpt.py / llama.py / bert.py naming)
DEFAULT_RULES = [
    ShardRule("*attn*qkv*kernel", 1, qkv="packed"),
    ShardRule("*attn*qkv*bias", 0, qkv="packed"),
    ShardRule("*attn*out*kernel", 0),
    ShardRule("*mlp*fc_in*kernel", 1),
    ShardRule("*mlp*fc_in*bias", 0),
    ShardRule("*mlp*gate*kernel", 1),
    ShardRule("*mlp*up*kernel", 1),
    ShardRule("*mlp*fc_out*kernel", 0),
    ShardRule("*mlp*down*kernel", 0),
    ShardRule("*embed*", 0),
    ShardRule("*lm_head*kernel", 1),
]


def match_rule(name: str, rules: List[ShardRule]) -> Optional[ShardRule]:
    for rule in rules:
        if fnmatch.fnmatch(name, rule.pattern):
            return rule
    return None


def _merge_qkv_packed(parts: List[np.ndarray], axis: int) -> np.ndarray:
    """Each shard holds [Q_i; K_i; V_i] stacked on `axis`; the merged tensor must
    be [Q; K; V], i.e. concatenate per-projection then restack (reference
    `MegatronSDLoader.merge_query_key_value`)."""
    segs = [np.split(p, 3, axis=axis) for p in parts]   # [(q,k,v)] per shard
    merged = [np.concatenate([s[j] for s in segs], axis=axis) for j in range(3)]
    return np.concatenate(merged, axis=axis)


def _split_qkv_packed(full: np.ndarray, n: int, rank: int, axis: int) -> np.ndarray:
    q, k, v = np.split(full, 3, axis=axis)
    return np.concatenate([np.array_split(q, n, axis=axis)[rank],
                           np.array_split(k, n, axis=axis)[rank],
                           np.array_split(v, n, axis=axis)[rank]], axis=axis)


class SDLoaderBase:
    """Merge/split/reshard flat state-dict shards to a target TP degree."""

    def __init__(self, rules: Optional[List[ShardRule]] = None):
        self.rules = rules if rules is not None else DEFAULT_RULES

    def merge_state_dicts(self, shards: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """N TP shards → the full (TP=1) state dict."""
        if len(shards) == 1:
            return dict(shards[0])
        out = {}
        for name in shards[0]:
            parts = [sd[name] for sd in shards]
            rule = match_rule(name, self.rules)
            if rule is None or rule.axis is None:
                out[name] = parts[0]
            elif rule.qkv == "packed":
                out[name] = _merge_qkv_packed(parts, rule.axis)
            else:
                out[name] = np.concatenate(parts, axis=rule.axis)
        return out

    def split_state_dict(self, full: Dict[str, np.ndarray], num_shards: int,
                         rank: int) -> Dict[str, np.ndarray]:
        """Full state dict → shard `rank` of `num_shards`."""
        if num_shards == 1:
            return dict(full)
        out = {}
        for name, tensor in full.items():
            rule = match_rule(name, self.rules)
            if rule is None or rule.axis is None:
                out[name] = tensor
            elif rule.qkv == "packed":
                out[name] = _split_qkv_packed(tensor, num_shards, rank, rule.axis)
            else:
                out[name] = np.array_split(tensor, num_shards, axis=rule.axis)[rank]
        return out

    def reshard(self, shards: List[Dict[str, np.ndarray]],
                target_degree: int) -> List[Dict[str, np.ndarray]]:
        """N→M resharding (reference `SDLoader.get_merge_state_dicts` /
        `get_split_state_dict` dispatch in `check_ckpt_list`-driven load)."""
        full = self.merge_state_dicts(shards)
        return [self.split_state_dict(full, target_degree, r)
                for r in range(target_degree)]


# Megatron-LM state-dict naming (both the old `attention.` and the newer
# `self_attention.` module paths). Torch Linear stores [out, in]:
# column-parallel layers (qkv, dense_h_to_4h) shard axis 0, row-parallel
# layers (attention.dense, dense_4h_to_h) shard axis 1 — the axes in the
# reference's merge/split tables (`state_dict_factory.py:301-402`).
MEGATRON_RULES = [
    ShardRule("*query_key_value.weight", 0, qkv="megatron"),
    ShardRule("*query_key_value.bias", 0, qkv="megatron"),
    ShardRule("*attention.dense.weight", 1),
    ShardRule("*mlp.dense_h_to_4h.weight", 0),
    ShardRule("*mlp.dense_h_to_4h.bias", 0),
    ShardRule("*mlp.dense_4h_to_h.weight", 1),
    ShardRule("*word_embeddings.weight", 0),
    ShardRule("*lm_head.weight", 0),
]


class MegatronSDLoader(SDLoaderBase):
    """Checkpoint-version-aware qkv merge/split (reference
    `MegatronSDLoader.merge_query_key_value` / `split_query_key_value`,
    `state_dict_factory.py:220-299`). Three observed formats:

      version 0:   [(3*np*hn), h] — Q/K/V stacked blocks per shard; merging
                   must concat per projection, then restack ("packed").
      version 1.0: [(np*hn*3), h] — interleaved inside each head group;
      version 2.0: [(np*3*hn), h] — interleaved per head group.
                   For 1.0/2.0 whole head-groups travel with their rank, so
                   plain concat/split along axis 0 preserves ordering.
    """

    def __init__(self, num_heads: int = 0, rules=None, version: float = 0):
        super().__init__(rules if rules is not None else MEGATRON_RULES)
        self.num_heads = num_heads
        self.version = version

    def _qkv_packed(self):
        return self.version == 0

    def merge_state_dicts(self, shards):
        if len(shards) == 1:
            return dict(shards[0])
        out = {}
        for name in shards[0]:
            parts = [sd[name] for sd in shards]
            rule = match_rule(name, self.rules)
            if rule is None or rule.axis is None:
                out[name] = parts[0]
            elif rule.qkv == "megatron":
                out[name] = (_merge_qkv_packed(parts, rule.axis)
                             if self._qkv_packed()
                             else np.concatenate(parts, axis=rule.axis))
            elif rule.qkv == "packed":
                out[name] = _merge_qkv_packed(parts, rule.axis)
            else:
                out[name] = np.concatenate(parts, axis=rule.axis)
        return out

    def split_state_dict(self, full, num_shards, rank):
        if num_shards == 1:
            return dict(full)
        out = {}
        for name, tensor in full.items():
            rule = match_rule(name, self.rules)
            if rule is None or rule.axis is None:
                out[name] = tensor
            elif rule.qkv == "megatron":
                out[name] = (_split_qkv_packed(tensor, num_shards, rank, rule.axis)
                             if self._qkv_packed()
                             else np.array_split(tensor, num_shards,
                                                 axis=rule.axis)[rank])
            elif rule.qkv == "packed":
                out[name] = _split_qkv_packed(tensor, num_shards, rank, rule.axis)
            else:
                out[name] = np.array_split(tensor, num_shards, axis=rule.axis)[rank]
        return out


class SDLoaderFactory:
    """Reference `SDLoaderFactory.get_sd_loader` (`state_dict_factory.py:21`)."""

    @staticmethod
    def get_sd_loader(sd_type: str = "generic", **kwargs):
        sd_type = sd_type.lower()
        if sd_type in ("megatron",):
            return MegatronSDLoader(num_heads=kwargs.get("num_heads", 0),
                                    rules=kwargs.get("rules"),
                                    version=kwargs.get("version", 0))
        return SDLoaderBase(rules=kwargs.get("rules"))
