"""DeepSpeed-Ulysses sequence parallelism (counterpart of
`deepspeed_tpu/parallel/ulysses.py`; the reference's
`deepspeed/sequence/layer.py:15-85`).

Each rank of the `sequence` axis holds its token shard [B, T/sp, H, hd].
An all-to-all trades it for a head shard of the whole sequence
[B, T, H/sp, hd], any local attention runs on that, and a second
all-to-all trades the output back. The JAX package states the two
all-to-alls as sharding constraints (`ulysses_attention`) or writes them
inside a `shard_map` (`ulysses_shard_map_attention`); the port has no
GSPMD, so both forms are the same explicit sandwich over the comm facade's
`all_to_all`, whose backward is the inverse all-to-all
(`seq_all_to_all`). Ranks hold contiguous token ranges in rank order, so
the gathered tokens come back in sequence order.
"""

import torch

from deepspeed_tpu_torch.comm import collectives as coll
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.comm.mesh import SEQ_AXIS, TENSOR_AXIS


class _SeqAllToAll(torch.autograd.Function):
    """All-to-all over an axis (`_SeqAllToAll` of the reference): chunk j
    of `scatter_axis` goes to rank j, the received chunks concatenated
    along `gather_axis` in rank order; the backward is the inverse."""

    @staticmethod
    def forward(ctx, x, axis, scatter_axis, gather_axis):
        ctx.args = (axis, scatter_axis, gather_axis)
        return coll.all_to_all(x.contiguous(), axis, split_axis=scatter_axis,
                               concat_axis=gather_axis, tiled=True)

    @staticmethod
    def backward(ctx, g):
        axis, scatter_axis, gather_axis = ctx.args
        return coll.all_to_all(g.contiguous(), axis, split_axis=gather_axis,
                               concat_axis=scatter_axis, tiled=True), \
            None, None, None


def seq_all_to_all(x, scatter_axis, gather_axis, axis_name=SEQ_AXIS):
    """Scatter `scatter_axis` over the ranks of `axis_name` (a mesh axis
    or a `mesh.SubAxis`) and gather `gather_axis`; differentiable."""
    return _SeqAllToAll.apply(x, axis_name, scatter_axis, gather_axis)


def ulysses_attention(attn_fn):
    """Wrap a local attention fn ([B, T, H, hd] x 3 -> [B, T, H, hd]) with
    the Ulysses sequence <-> head re-sharding sandwich: q / k / v arrive as
    this rank's [B, T/sp, H, hd] shard and so does the output."""

    def wrapped(q, k, v, *args, **kwargs):
        q, k, v = (seq_all_to_all(x, 2, 1) for x in (q, k, v))
        return seq_all_to_all(attn_fn(q, k, v, *args, **kwargs), 1, 2)

    return wrapped


class DistributedAttention:
    """API-parity class (reference `sequence/layer.py:37`): construct with a
    local attention callable; call with this rank's q, k, v shards
    [B, T/sp, H, hd]. As in the JAX package, the all-to-alls ride the
    `sequence` axis over heads and tokens whatever `sequence_process_group`,
    `scatter_idx` and `gather_idx` say."""

    def __init__(self, local_attention, sequence_process_group=None,
                 scatter_idx=2, gather_idx=1):
        self.local_attn = local_attention
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx
        self._wrapped = ulysses_attention(local_attention)

    def __call__(self, query, key, value, *args, **kwargs):
        return self._wrapped(query, key, value, *args, **kwargs)


def ulysses_shard_map_attention(attn_fn, mesh=None):
    """The explicit form (JAX's shard_map variant): q, k, v are this rank's
    [B, T/sp, H, hd] shards; each trades its sequence shard for a head
    shard, runs `attn_fn` over the whole sequence and trades back. The
    head-scatter hands every rank whole heads, so the per-tensor-shard
    head count must divide by sp: checked on every call, with JAX's
    ValueError. `mesh` is accepted for the JAX signature; the installed
    mesh is the one used."""
    del mesh

    def validated(q, k, v):
        sp = mesh_mod.axis_size(SEQ_AXIS) if mesh_mod.has_mesh() else 1
        tp = mesh_mod.axis_size(TENSOR_AXIS) if mesh_mod.has_mesh() else 1
        for name, x in (("q", q), ("k", k), ("v", v)):
            h_local = x.shape[2] // tp if x.shape[2] % tp == 0 else None
            if h_local is None or h_local % sp != 0:
                raise ValueError(
                    f"ulysses_shard_map_attention: {name} has {x.shape[2]} "
                    f"heads — after the {tp}-way tensor split, the per-shard "
                    f"head count must divide by the {sp}-way `sequence` axis "
                    f"(the all-to-all scatters whole heads per rank). Use a "
                    f"head count divisible by tp*sp={tp * sp}, lower the "
                    f"sequence axis, or compose with ring context "
                    f"parallelism (parallel/ring.py ring_ulysses_attention: "
                    f"the non-dividing factor of sp moves to the K/V ring)")
        return ulysses_attention(attn_fn)(q, k, v)

    return validated
