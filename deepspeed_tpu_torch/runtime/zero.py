"""ZeRO's sharding decisions across ranks (counterpart of
`deepspeed_tpu/runtime/zero.py`).

The JAX package hands ZeRO to XLA as sharding annotations. The port takes
the same decisions and carries them out over the comm facade:

  stage 0 — params, grads and optimizer state whole on every rank; the
            grads are averaged across ranks once a step;
  stage 1 — the fp32 master and the moments sharded over the data domain;
            the grads averaged once a step; each rank updates its shard and
            the compute-dtype params are all-gathered after the update;
  stage 2 — as stage 1, but each micro-batch's grads are reduce-scattered
            into the rank's shard, so the accumulator is sharded;
  stage 3 — the params themselves sharded at rest; a model reading them
            through `ZeroParamView` all-gathers a leaf where it reads it
            (a GPT gathers each layer inside its block, again in the
            rematerialized forward), and the backward reduce-scatters the
            full gradient into the shard's.

`shard_leaf_spec` chooses JAX's dimension for each leaf (the largest one
divisible by the shard count, dim 0 on ties; leaves under
`stage3_param_persistence_threshold` elements keep their params whole at
stage 3). A rank holds chunk `rank` of that dimension, its index within
the leaf's partition domain; on a one-rank domain nothing is sharded, as
in JAX, and the step issues no collective.

The domains are JAX's: the state (master, moments, stage-2 grads)
partitions over data x zero x sequence, and stage-3 params over the same.
MiCS (`mics_shard_size`) confines every shard to the inner `zero` axis, so
each `data` replica holds a whole copy, sharded within its sub-group;
hpZ (`zero_hpz_partition_size`) at stage 3 shards the params over `zero`
only (the gathers ride the sub-group) while the state keeps the whole
domain. The flat helpers move many leaves in one collective over a
domain's axes: a rank's shards concatenated, or a send buffer whose row r
is every leaf's chunk r.
"""

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm import collectives as coll
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _spec_axes(spec):
    """The mesh axis names a spec (tuple of entries) already uses."""
    used = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return used


def shard_leaf_spec(shape, base_spec, shard_axes, shard_size: int,
                    min_size: int = 0):
    """Add `shard_axes` to one free dimension of a leaf (JAX's rule): the
    largest dimension divisible by `shard_size` that is not already
    sharded, dim 0 on ties; the base spec unchanged when none qualifies or
    the leaf has fewer than `min_size` elements. Specs are tuples of
    entries (None, an axis name or a tuple of names), one a dimension."""
    base = tuple(base_spec) if base_spec is not None else ()
    base = base + (None,) * (len(shape) - len(base))
    if shard_size <= 1:
        return base
    if int(np.prod(shape)) < max(min_size, 1) or len(shape) == 0:
        return base
    if any(a in _spec_axes(base) for a in shard_axes):
        return base
    best_dim, best_size = None, -1
    for d, n in enumerate(shape):
        if base[d] is not None:
            continue
        if n % shard_size == 0 and n > best_size:
            best_dim, best_size = d, n
    if best_dim is None:
        return base
    new = list(base)
    new[best_dim] = tuple(shard_axes) if len(shard_axes) > 1 \
        else shard_axes[0]
    return tuple(new)


def shard_dim(shape, shard_size: int, min_size: int = 0,
              shard_axes=mesh_mod.ZERO_AXES, base_spec=None) -> Optional[int]:
    """The dimension `shard_leaf_spec` shards (None: the leaf stays
    whole); a dimension the base spec already names is never it."""
    base = tuple(base_spec) if base_spec is not None else ()
    base = base + (None,) * (len(shape) - len(base))
    spec = shard_leaf_spec(shape, base, shard_axes, shard_size, min_size)
    for d, (entry, was) in enumerate(zip(spec, base)):
        if entry is not None and was is None:
            return d
    return None


def chunk_of(t, dim, n, rank):
    """Chunk `rank` of `n` along `dim`, as a contiguous tensor of its own."""
    s = t.shape[dim] // n
    return t.narrow(dim, rank * s, s).contiguous()


class ZeroShardingPolicy:
    """The partition and reduce domains of a ZeRO stage over the mesh, and
    each leaf's shard dimension for its params, state and grads. `rank` is
    this rank's index in the data domain (data x zero x sequence,
    flattened in mesh order); `rank` / `param_rank` are then its indices
    within the state and the param domains."""

    def __init__(self, zero_config, spec: mesh_mod.MeshSpec = None,
                 rank: int = 0):
        self.config = zero_config
        self.spec = spec or mesh_mod.MeshSpec()
        self.stage = int(zero_config.stage)
        self.mics = int(getattr(zero_config, "mics_shard_size", -1) or -1) > 0
        self.hpz = int(getattr(zero_config, "zero_hpz_partition_size", 1)
                       or 1)
        sizes = self.spec.axis_sizes()
        coord, rest = {}, int(rank)
        for a in reversed(mesh_mod.ZERO_AXES):
            coord[a], rest = rest % sizes[a], rest // sizes[a]
        self.domain = self.partition_domain()
        self.domain_size = int(np.prod([sizes[a] for a in self.domain]))
        self.rank = _flat_index(coord, sizes, self.domain)
        self.param_domain = self.param_partition_domain()
        self.param_domain_size = int(np.prod([sizes[a]
                                              for a in self.param_domain]))
        self.param_rank = _flat_index(coord, sizes, self.param_domain)
        self.persistence_threshold = (
            int(zero_config.stage3_param_persistence_threshold)
            if self.stage == 3 else 0)

    def partition_domain(self):
        """The mesh axes of the state partition domain: MiCS confines every
        shard to the inner `zero` axis (replicas across `data`)."""
        if self.mics:
            return (mesh_mod.ZERO_INNER_AXIS,)
        return mesh_mod.ZERO_AXES

    def param_partition_domain(self):
        """The axes stage-3 params shard over: hpZ's secondary partition
        rides the `zero` sub-group while the state keeps the whole
        domain."""
        if self.stage == 3 and self.hpz > 1 and not self.mics:
            return (mesh_mod.ZERO_INNER_AXIS,)
        return self.domain

    def grad_domain(self):
        """The axes a micro-batch's grads are reduce-scattered over: the
        param domain at stage 3 (the gathers' backward), the state domain
        at stage 2; () below (whole grads)."""
        if self.stage == 3:
            return self.param_domain
        if self.stage == 2:
            return self.domain
        return ()

    def replica_axes(self, axes):
        """The data-domain axes outside `axes` (over which shards along
        `axes` are replicas whose sums still add up)."""
        return tuple(a for a in mesh_mod.ZERO_AXES if a not in axes)

    def reduce_domain(self, compressed_comm_axis=None):
        """(fast axes, slow axis) of the explicit hierarchical grad reduce
        (JAX's split); slow is None when the data domain is one rank."""
        sizes = self.spec.axis_sizes()
        axes = [a for a in mesh_mod.ZERO_AXES if sizes[a] > 1]
        if not axes:
            return (), None
        slow = compressed_comm_axis or axes[0]
        if slow not in axes:
            raise ValueError(
                f"compressed_comm_axis {slow!r} is not a data-domain axis "
                f"with size > 1 on this mesh; candidates: {axes}")
        return tuple(a for a in axes if a != slow), slow

    # ---- specs (JAX's vocabulary) ----

    def param_spec(self, shape, base_spec=None):
        if self.stage < 3:
            return shard_leaf_spec(shape, base_spec, self.param_domain, 1)
        return shard_leaf_spec(shape, base_spec, self.param_domain,
                               self.param_domain_size,
                               min_size=self.persistence_threshold)

    def state_spec(self, shape, base_spec=None):
        if self.stage == 0:
            return shard_leaf_spec(shape, base_spec, self.domain, 1)
        return shard_leaf_spec(shape, base_spec, self.domain,
                               self.domain_size, min_size=0)

    # ---- shard dimensions ----

    def param_dim(self, leaf, base_spec=None) -> Optional[int]:
        """The dimension of a stage-3 param's chunk (None on a one-rank
        domain, where every leaf stays whole); `base_spec`, the model's
        tensor-parallel spec of the leaf, keeps its dimensions free."""
        if not leaf.is_floating_point() or self.stage < 3:
            return None
        return shard_dim(tuple(leaf.shape), self.param_domain_size,
                         self.persistence_threshold, self.param_domain,
                         base_spec)

    def state_dim(self, leaf, base_spec=None) -> Optional[int]:
        if not leaf.is_floating_point() or self.stage == 0:
            return None
        return shard_dim(tuple(leaf.shape), self.domain_size, 0,
                         self.domain, base_spec)

    def grad_dim(self, leaf, base_spec=None) -> Optional[int]:
        """Where a micro-batch's grads land: the param shard at stage 3,
        the state shard at stage 2, whole (averaged once a step) below."""
        if self.stage == 3:
            return self.param_dim(leaf, base_spec)
        if self.stage == 2:
            return self.state_dim(leaf, base_spec)
        return None

    def shard(self, t, dim):
        """This rank's chunk of a leaf along `dim` in the state domain (the
        leaf when None)."""
        if dim is None:
            return t
        return chunk_of(t, dim, self.domain_size, self.rank)

    def shard_param(self, t, dim):
        """This rank's chunk of a leaf along `dim` in the param domain."""
        if dim is None:
            return t
        return chunk_of(t, dim, self.param_domain_size, self.param_rank)

    def relayout(self, param_dim, state_dim):
        """A stage-3 param shard and its state shard are cut differently
        (hpZ: the param domain is the inner axis alone)."""
        return param_dim is not None and (
            param_dim != state_dim or self.param_domain != self.domain)


# ----------------------------------------------------------------------
# flat collectives over lists of leaves (one op for many leaves)
# ----------------------------------------------------------------------


def _one_dtype(tensors):
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError(f"a flat collective needs one dtype, got "
                         f"{sorted(str(t.dtype) for t in tensors)}")


def flat_all_reduce(tensors, axis=mesh_mod.ZERO_AXES):
    """Sum each tensor over the axis with one all-reduce (same dtype)."""
    if not tensors:
        return []
    _one_dtype(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    out = coll.psum(flat, axis)
    return [c.view(t.shape) for c, t in
            zip(out.split([t.numel() for t in tensors]), tensors)]


def _flat_index(coord, sizes, axes):
    """A rank's index within `axes` (its coordinates flattened in mesh
    order)."""
    index = 0
    for a in axes:
        index = index * sizes[a] + coord[a]
    return int(index)


def flat_all_gather(shards, dims, n, axis=mesh_mod.ZERO_AXES):
    """Every rank's shards (chunk r of each leaf along its dim) -> the
    whole leaves, with one all-gather of the rank's shards concatenated."""
    if not shards:
        return []
    _one_dtype(shards)
    flat = torch.cat([s.reshape(-1) for s in shards])
    rows = coll.all_gather(flat, axis)                  # [n, total]
    out, off = [], 0
    for s, d in zip(shards, dims):
        k = s.numel()
        pieces = [rows[r, off:off + k].view(s.shape) for r in range(n)]
        out.append(torch.cat(pieces, dim=d))
        off += k
    return out


def flat_reduce_scatter(fulls, dims, n, axis=mesh_mod.ZERO_AXES):
    """Each whole leaf summed over the axis, this rank's chunk along its
    dim, with one reduce-scatter of a [n, total] send buffer whose row r
    holds every leaf's chunk r."""
    if not fulls:
        return []
    _one_dtype(fulls)
    rows = torch.cat([torch.stack([c.reshape(-1) for c in f.chunk(n, dim=d)])
                      for f, d in zip(fulls, dims)], dim=1)
    mine = coll.reduce_scatter(rows, axis, tiled=False)  # [total]
    out, off = [], 0
    for f, d in zip(fulls, dims):
        shape = list(f.shape)
        shape[d] //= n
        k = int(np.prod(shape))
        out.append(mine[off:off + k].view(shape))
        off += k
    return out


def gather_to_host(shard, dim, n, keep=True, axis=mesh_mod.ZERO_AXES):
    """One leaf's shards (chunk r along `dim` on rank r) -> the whole leaf
    in host memory, with one all-gather: the device holds this leaf's
    gathered rows only until they are copied out, and the chunks are
    joined on the host. With `keep` false the rank takes part in the
    gather and keeps nothing (None)."""
    rows = coll.all_gather(shard.contiguous().reshape(-1), axis)  # [n, k]
    if not keep:
        return None
    host = rows.cpu()
    del rows
    return torch.cat([host[r].view(shard.shape) for r in range(n)], dim)


class _GatherLeaves(torch.autograd.Function):
    """shards -> whole leaves (one all-gather over `axis`); the backward
    reduce-scatters the whole leaves' grads into the shards' (one
    reduce-scatter over the same axes)."""

    @staticmethod
    def forward(ctx, dims, n, axis, *shards):
        ctx.dims, ctx.n, ctx.axis = dims, n, axis
        return tuple(flat_all_gather(list(shards), dims, n, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(flat_reduce_scatter(
            [g.contiguous() for g in grads], ctx.dims, ctx.n, ctx.axis))


def gather_leaves(shards, dims, n, axis=mesh_mod.ZERO_AXES):
    """Differentiable all-gather of sharded leaves (see `_GatherLeaves`)."""
    if not shards:
        return []
    return list(_GatherLeaves.apply(tuple(dims), n, axis, *shards))


class ZeroParamView(dict):
    """A stage-3 params tree as a model reads it: `view[k]` is leaf k whole
    (all-gathered where it is read, when the rank holds a shard) or a view
    of the subtree; `items()` / `values()` / `get()` read alike. A subtree
    of stacked layers also gives `layer(i)`: its i-th slice of every leaf,
    gathered with one collective — a GPT calls it inside each block, so
    the rematerialized forward gathers again.

    `dims` mirrors the tree: each leaf's shard dimension (None: held
    whole); `n` is the param domain's size and `axis` its axes."""

    def __init__(self, shards, dims, n, axis=mesh_mod.ZERO_AXES):
        super().__init__(shards)
        self._dims, self._n, self._axis = dims, n, axis
        self._slices = None

    def _read(self, k):
        v, d = dict.__getitem__(self, k), self._dims[k]
        if isinstance(v, dict):
            return ZeroParamView(v, d, self._n, self._axis)
        if d is None:
            return v
        return gather_leaves([v], [d], self._n, self._axis)[0]

    def __getitem__(self, k):
        return self._read(k)

    def get(self, k, default=None):
        return self._read(k) if k in self else default

    def items(self):
        return [(k, self._read(k)) for k in self.keys()]

    def values(self):
        return [self._read(k) for k in self.keys()]

    def layer(self, i):
        """{name: leaf[i] whole} over this subtree's stacked leaves."""
        if self._slices is None:
            # unbind once: its backward stacks the L slices' grads once
            self._slices = {k: dict.__getitem__(self, k).unbind(0)
                            if self._dims[k] not in (None, 0)
                            else dict.__getitem__(self, k)
                            for k in self.keys()}
        out, names, shards, dims = {}, [], [], []
        for k in self.keys():
            d = self._dims[k]
            if d is None:
                out[k] = self._slices[k][i]
            elif d == 0:
                # the layer dimension itself is sharded: gather the leaf
                names.append((k, True))
                shards.append(self._slices[k])
                dims.append(0)
            else:
                names.append((k, False))
                shards.append(self._slices[k][i])
                dims.append(d - 1)
        for (k, whole), full in zip(names, gather_leaves(
                shards, dims, self._n, self._axis)):
            out[k] = full[i] if whole else full
        return out


def tree_dims(tree, dim_fn):
    """A tree of `dim_fn(leaf)` shaped like `tree`."""
    return tree_unflatten(tree, [dim_fn(t) for t in tree_leaves(tree)])
