"""Weight-only quantization and the int8 KV-cache scheme (counterpart of
`deepspeed_tpu/inference/quantization.py`).

Weight-only quantization (WOQ): `quantize_param_tree` turns every large
float matrix leaf of a parameter tree into a `QuantizedTensor` (int8, or
int4 packed two a byte, plus fp32 scales per group of the last dim) once,
at engine build. The model functions (`models/gpt.py`) dequantize on use:
one layer's leaves at a time (`dequantize_tensors`: one launch a layer),
only the gathered rows of an embedding, the LM-head table where it is
multiplied — so device memory holds the quantized tree plus one dense
layer, never the whole dense tree. The JAX
package instead dequantizes the whole tree inside jit (`wrap_fn_dequant`)
and leaves the fusion to XLA; the numbers are the same, since groups lie
along the last dim and a row of the dense tensor depends only on the same
row of the payload and its scales.

The int8 KV pool: `quantize_kv` / `dequantize_kv` are its quantize and
read primitives, `quantize_kv_write` its cache write (one launch a layer
on CUDA; `init_paged_kv_pool(dtype=int8)` keeps `k_scale` / `v_scale`
beside the payload).

Every function here runs the `ops/quant.py` kernels on CUDA tensors and
their plain versions on CPU tensors.
"""

import dataclasses
from typing import Any

import torch

from deepspeed_tpu_torch.ops import quant as quant_ops
from deepspeed_tpu_torch.utils.logging import logger


@dataclasses.dataclass
class QuantizedTensor:
    """int8 / packed-int4 payload + groupwise scales standing in for a
    float parameter leaf of shape `shape` and dtype `dtype`."""
    q: torch.Tensor          # int8 [..., D] (8 bits) or [..., D//2] (4 bits)
    scale: torch.Tensor      # f32 [..., D//group_size]
    bits: int = 8
    group_size: int = 64
    shape: tuple = ()        # the dense tensor's shape
    dtype: Any = torch.bfloat16

    def dequantize(self):
        return dequantize_tensor(self)

    def __getitem__(self, idx):
        """Rows `idx` of the leading dims, still quantized: groups lie along
        the last dim, so selecting rows of the payload and its scales is
        selecting the same rows of the dense tensor."""
        q, scale = self.q[idx], self.scale[idx]
        return dataclasses.replace(
            self, q=q, scale=scale, shape=tuple(q.shape[:-1]) + self.shape[-1:])

    def to(self, device):
        return dataclasses.replace(self, q=self.q.to(device),
                                   scale=self.scale.to(device))

    @property
    def nbytes(self):
        return self.q.numel() + self.scale.numel() * 4


def quantize_tensor(x, bits=8, group_size=64):
    """x [..., D] float -> QuantizedTensor. Raises ValueError when D does not
    tile into whole groups, when bits is not 4 or 8, and for int4 when D is
    odd."""
    q, scale = quant_ops.quantize(x, group_size, bits)
    return QuantizedTensor(q=q, scale=scale, bits=bits, group_size=group_size,
                           shape=tuple(x.shape), dtype=x.dtype)


def dequantize_tensor(t: QuantizedTensor):
    return quant_ops.dequantize(t.q, t.scale, t.dtype, t.group_size, t.bits)


def dequantize_tensors(tensors):
    """Several QuantizedTensors dense, in order: one `dequantize_many` call
    (one launch on CUDA) for each (bits, dtype) among them."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.bits, t.dtype), []).append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        dense_leaves = quant_ops.dequantize_many(
            [(tensors[i].q, tensors[i].scale, tensors[i].dtype,
              tensors[i].group_size, tensors[i].bits) for i in idx])
        for i, d in zip(idx, dense_leaves):
            out[i] = d
    return out


def quantize_param_tree(params, bits=8, group_size=64, min_size=4096,
                        exclude_keys=("scale", "bias", "ln", "norm")):
    """Quantize every large float matrix leaf; small, 1-D and norm leaves
    stay dense. Returns (qtree, stats).

    The rule is the JAX package's, leaf for leaf: `exclude_keys` match as
    substrings of the lower-cased leaf PATH ("blocks/attn_out_b"), so the
    stacked [L, D] block biases — whose names contain none of them — are
    quantized once they reach `min_size` elements."""
    counts = {"quantized": 0, "dense": 0, "bytes_before": 0, "bytes_after": 0}

    def leaf(path, x):
        size = x.numel() * x.element_size()
        counts["bytes_before"] += size
        key = path.lower()
        if (x.is_floating_point() and x.dim() >= 2 and x.numel() >= min_size
                and x.shape[-1] % group_size == 0
                and (bits == 8 or x.shape[-1] % 2 == 0)
                and not any(e in key for e in exclude_keys)):
            t = quantize_tensor(x, bits=bits, group_size=group_size)
            counts["quantized"] += 1
            counts["bytes_after"] += t.nbytes
            return t
        counts["dense"] += 1
        counts["bytes_after"] += size
        return x

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        return leaf(path, node)

    qtree = walk(params, "")
    stats = {**counts,
             "ratio": counts["bytes_before"] / max(counts["bytes_after"], 1)}
    logger.info(f"WOQ int{bits}: {stats['quantized']} tensors quantized, "
                f"{stats['dense']} dense, {stats['ratio']:.2f}x weight-memory "
                f"saving")
    return qtree, stats


def dense(leaf):
    """A parameter leaf as a dense tensor: a QuantizedTensor dequantizes
    (to its own dtype), anything else passes through."""
    return leaf.dequantize() if isinstance(leaf, QuantizedTensor) else leaf


def dequantize_param_tree(qtree):
    """The whole tree dense (the JAX package's `wrap_fn_dequant` view)."""
    if isinstance(qtree, dict):
        return {k: dequantize_param_tree(v) for k, v in qtree.items()}
    if isinstance(qtree, (list, tuple)):
        return type(qtree)(dequantize_param_tree(v) for v in qtree)
    return dense(qtree)


def quantize_kv(x, group_size):
    """x [..., D] float -> (q int8 [..., D], scale f32 [..., D//group_size]):
    the int8 pool's cache write (`quantize_int8`'s numerics; a group that
    does not tile D raises ValueError)."""
    return quant_ops.quantize_int8(x, group_size)


def quantize_kv_write(pool_l, k, v, block_tables, positions):
    """The int8 pool's cache write for one layer, in place: the new tokens'
    k, v [B, C, Hkv, hd] quantized (`quantize_kv`'s numerics) into
    `pool_l` {"k", "v", "k_scale", "v_scale"} at each token's physical
    block (block_tables [B, nb] at positions [B, C] // block) and offset
    (positions % block): `ops/quant.quantize_kv_write`, one launch on
    CUDA."""
    quant_ops.quantize_kv_write(k, v, block_tables, positions, pool_l["k"],
                                pool_l["v"], pool_l["k_scale"],
                                pool_l["v_scale"])


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    """Inverse of `quantize_kv`: int8 payload x fp32 group scale, narrowed to
    `dtype` last — the order the paged int8 decode kernel applies in-tile."""
    return quant_ops.dequantize_int8(q, scale, dtype,
                                     q.shape[-1] // scale.shape[-1])
