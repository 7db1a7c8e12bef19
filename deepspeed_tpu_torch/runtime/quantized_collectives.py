"""Quantized collectives, ZeRO++'s qwZ and qgZ (counterpart of
`deepspeed_tpu/runtime/quantized_collectives.py`).

qwZ gathers stage-3 weights over an int8 wire; qgZ reduces gradients with
the 2-hop int8 scheme (int8 all-to-all, dequantize and reduce in fp32,
int8 all-gather). The quantization rule (groupwise symmetric int8, scale =
max|x| / 127 a group) has one definition, `comm/collectives.py`'s
`group_quant_int8`, and every hop goes through the facade's transform ops,
so `CommStats` records the int8 payloads and the f32 scales as JAX
records them. Each function takes this rank's tensor and an axis name (or
tuple of names) of the mesh, where JAX's runs inside `shard_map`.
"""

from deepspeed_tpu_torch.comm import collectives as coll


def quantized_all_gather(x, axis_name, group_size=coll.DEFAULT_GROUP_SIZE):
    """qwZ all-gather: this rank's shard [...] -> the shards concatenated
    along dim 0 in rank order, dequantized to x's dtype."""
    deq = coll.transform_all_gather(x.reshape(-1), axis_name, "int8",
                                    group_size)           # [n, numel]
    n = deq.shape[0]
    return deq.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def quantized_reduce_scatter(x, axis_name,
                             group_size=coll.DEFAULT_GROUP_SIZE):
    """qgZ reduce-scatter: this rank's full-size contribution [N, ...] (N
    a multiple of the axis size) -> its fp32 chunk of the sum along dim 0,
    [N / n, ...]. The int8 all-to-all moves each rank's chunk j to rank j,
    which dequantizes and reduces in fp32."""
    n = coll.axis_size(axis_name)
    N = x.shape[0]
    if N % n:
        raise ValueError(f"leading dim {N} not divisible by axis size {n}")
    total = coll.transform_reduce_scatter(x.reshape(-1), axis_name, "int8",
                                          group_size)
    return total.reshape((N // n,) + tuple(x.shape[1:]))


def quantized_psum_scatter_mean(x, axis_name,
                                group_size=coll.DEFAULT_GROUP_SIZE):
    """`quantized_reduce_scatter` / the axis size (the grads' mean)."""
    return quantized_reduce_scatter(x, axis_name, group_size) / \
        coll.axis_size(axis_name)


def qgz_allreduce(x, axis_name, group_size=coll.DEFAULT_GROUP_SIZE):
    """qgZ all-reduce: int8 reduce-scatter + int8 all-gather (two
    quantized hops). Any shape in; the fp32 sum over the axis, the same on
    every rank, out (the flat payload padded to a multiple of the axis
    size)."""
    return coll.compressed_all_reduce(x, axis_name, transform="int8",
                                      group_size=group_size)


def quantized_all_gather_dim(x, axis_name, dim,
                             group_size=coll.DEFAULT_GROUP_SIZE):
    """qwZ all-gather of a leaf sharded on dimension `dim`: the int8 wire,
    the whole leaf back in x's dtype."""
    shard_shape = tuple(x.shape)
    deq = coll.transform_all_gather(x.reshape(-1), axis_name, "int8",
                                    group_size)           # [n, numel]
    n = deq.shape[0]
    arr = deq.reshape((n,) + shard_shape).movedim(0, dim)  # [..., n, k, ...]
    return arr.reshape(shard_shape[:dim] + (n * shard_shape[dim],)
                       + shard_shape[dim + 1:])
