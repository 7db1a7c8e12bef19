"""Logical topology over `torch.distributed` (counterpart of
`deepspeed_tpu/comm/mesh.py`).

The JAX package lays its devices on one `jax.sharding.Mesh` with named axes
and addresses every collective by axis name. The port keeps the names and
the spec: a `torch.distributed.device_mesh.DeviceMesh` over the initialized
process group, with JAX's six axes outermost first ('pipe', 'data', 'zero',
'expert', 'sequence', 'tensor'), whose per-axis process groups the comm
facade (`comm/comm.py`) resolves `axis=` names to. ZeRO partitions over
`ZERO_AXES` (data x zero x sequence), batches over `BATCH_AXES`, as in JAX.

One process is one rank and one device: the world size is the process
group's (1 when none is initialized, and then the mesh holds no
`DeviceMesh`: every axis has size 1 and a collective is the identity). A
mesh whose size differs from the group's raises: a rank never trains alone
in a larger world. Only `data` and its inner factor `zero` (MiCS / hpZ
sub-groups) may exceed 1 in this port; the config's `MeshConfig` refuses
the model-parallel axes, naming the ROADMAP item they wait on. Ranks lie
on the mesh in JAX's device order (rank r is JAX's device r), so a `zero`
group holds the ranks that share a data index, a `data` group the ranks
that share a zero index, and the joint (data, zero) domain is the whole
world in rank order.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger

# Canonical axis names, outermost first.
PIPE_AXIS = "pipe"
DATA_AXIS = "data"
ZERO_INNER_AXIS = "zero"
EXPERT_AXIS = "expert"
SEQ_AXIS = "sequence"
TENSOR_AXIS = "tensor"

ALL_AXES: Tuple[str, ...] = (PIPE_AXIS, DATA_AXIS, ZERO_INNER_AXIS,
                             EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)
ZERO_AXES: Tuple[str, ...] = (DATA_AXIS, ZERO_INNER_AXIS, SEQ_AXIS)
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, ZERO_INNER_AXIS)

# the factors of the `sequence` axis for the ring∘Ulysses hybrid
RING_SUBAXIS = "seq_ring"
ULYSSES_SUBAXIS = "seq_ulysses"


def process_world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Resolved logical topology."""
    pipe: int = 1
    data: int = 1
    zero: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    @property
    def world_size(self):
        return (self.pipe * self.data * self.zero * self.expert
                * self.sequence * self.tensor)

    def axis_sizes(self):
        return {PIPE_AXIS: self.pipe, DATA_AXIS: self.data,
                ZERO_INNER_AXIS: self.zero, EXPERT_AXIS: self.expert,
                SEQ_AXIS: self.sequence, TENSOR_AXIS: self.tensor}

    @classmethod
    def resolve(cls, mesh_config, n_devices: Optional[int] = None):
        """Fill the -1 ("the remaining ranks") axis from the world size:
        `n_devices`, else the config's `devices`, else the process
        group's. The spec must span exactly that many ranks."""
        n = n_devices or getattr(mesh_config, "devices", None) \
            or process_world_size()
        sizes = {"pipe": mesh_config.pipe, "data": mesh_config.data,
                 "zero": getattr(mesh_config, "zero", 1),
                 "expert": mesh_config.expert,
                 "sequence": mesh_config.sequence,
                 "tensor": mesh_config.tensor}
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got "
                             f"{unknown}")
        fixed = int(np.prod([v for v in sizes.values() if v != -1]))
        if unknown:
            if n % fixed:
                raise ValueError(f"{n} ranks not divisible by the fixed "
                                 f"axes' product {fixed}")
            sizes[unknown[0]] = n // fixed
        spec = cls(**{k: int(v) for k, v in sizes.items()})
        from deepspeed_tpu_torch.config.core import refuse_unported_axes
        refuse_unported_axes(spec.axis_sizes())
        if spec.world_size != n:
            raise ValueError(
                f"mesh {spec} spans {spec.world_size} ranks but the process "
                f"group has {n}: every rank of the world must be on the mesh")
        return spec


def backend_device_type(backend=None) -> str:
    """The device type a process-group backend drives: nccl the card,
    gloo the CPU."""
    backend = str(backend or dist.get_backend()).lower()
    return "cuda" if "nccl" in backend else "cpu"


def build_mesh(spec: MeshSpec):
    """A DeviceMesh over the initialized process group with JAX's axis
    names (None without a group: every axis is size 1)."""
    if not (dist.is_available() and dist.is_initialized()):
        if spec.world_size != 1:
            raise ValueError(f"mesh {spec} needs an initialized process "
                             f"group of {spec.world_size} ranks")
        return None
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(spec.world_size).reshape(
        spec.pipe, spec.data, spec.zero, spec.expert, spec.sequence,
        spec.tensor)
    return DeviceMesh(backend_device_type(), ranks, mesh_dim_names=ALL_AXES)


def _world_group():
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


# -------------------- the installed mesh (the "cdb" analog) ---------------

_CURRENT_MESH = None
_CURRENT_SPEC: Optional[MeshSpec] = None
_CURRENT_GROUP = None        # the default group the mesh was built over


def set_mesh(mesh, spec: MeshSpec):
    global _CURRENT_MESH, _CURRENT_SPEC, _CURRENT_GROUP
    _CURRENT_MESH, _CURRENT_SPEC = mesh, spec
    _CURRENT_GROUP = _world_group() if spec is not None else None
    _FACTORED.clear()


def get_mesh():
    """The installed DeviceMesh (None on a one-rank world without a
    process group)."""
    if _CURRENT_SPEC is None:
        raise RuntimeError("no mesh initialized — call comm.init_distributed"
                           "() / init_mesh first")
    return _CURRENT_MESH


def get_spec() -> MeshSpec:
    if _CURRENT_SPEC is None:
        raise RuntimeError("no mesh initialized")
    return _CURRENT_SPEC


def has_mesh() -> bool:
    return _CURRENT_SPEC is not None


def clear_mesh():
    """Uninstall the mesh (engine teardown / test isolation)."""
    set_mesh(None, None)


def init_mesh(mesh_config=None, n_devices=None):
    """Build and install the mesh from a MeshConfig (default: every rank
    on `data`)."""
    from deepspeed_tpu_torch.config.core import MeshConfig
    spec = MeshSpec.resolve(mesh_config or MeshConfig(), n_devices=n_devices)
    mesh = build_mesh(spec)
    set_mesh(mesh, spec)
    logger.info(f"mesh initialized: {spec} over {spec.world_size} ranks")
    return mesh


def ensure_mesh(mesh_config=None) -> MeshSpec:
    """The spec of `mesh_config` over the current process group, with the
    mesh installed: the installed one when it is that spec over this same
    group, else a new one (its per-axis groups are made once a group)."""
    from deepspeed_tpu_torch.config.core import MeshConfig
    spec = MeshSpec.resolve(mesh_config or MeshConfig())
    if not (has_mesh() and get_spec() == spec
            and _CURRENT_GROUP is _world_group()):
        init_mesh(mesh_config)
    return get_spec()


# -------------------- group queries (utils/groups.py vocabulary) ----------


@dataclasses.dataclass(frozen=True)
class SubAxis:
    """One factor of the `sequence` axis (`factor_sequence_axis`): its
    name, size, this rank's index along it and its process group (None
    without a process group)."""
    name: str
    size: int
    rank: int
    group: object = None


_FACTORED = {}      # ulysses degree -> (seq_ring, seq_ulysses) SubAxes


def factor_sequence_axis(ulysses_degree: int):
    """(seq_ring, seq_ulysses) sub-axes of the installed mesh's `sequence`
    axis, of sizes (sp // ulysses_degree, ulysses_degree): `seq_ulysses`
    is the inner factor, so its all-to-all rides adjacent ranks and the
    ring spans the outer stride (JAX's `factored_sequence_mesh`). The
    groups are made once a mesh and degree; every rank of the world takes
    part in making them (`torch.distributed.new_group`), so every rank
    calls this with the same degree at the same point."""
    sp = get_spec().sequence
    if ulysses_degree < 1 or sp % ulysses_degree != 0:
        raise ValueError(
            f"ring∘Ulysses: ulysses_degree {ulysses_degree} does not divide "
            f"the `sequence` axis size {sp}")
    if ulysses_degree in _FACTORED:
        return _FACTORED[ulysses_degree]
    ring = sp // ulysses_degree
    ring_rank, uly_rank = divmod(axis_rank(SEQ_AXIS), ulysses_degree)
    groups = [None, None]
    if get_mesh() is not None:
        spec = get_spec()
        me = dist.get_rank()
        ranks = torch.arange(spec.world_size).reshape(
            spec.pipe, spec.data, spec.zero, spec.expert, ring,
            ulysses_degree, spec.tensor)
        for i, dim in enumerate((4, 5)):
            for row in ranks.movedim(dim, -1).reshape(
                    -1, ranks.shape[dim]).tolist():
                g = dist.new_group(row)
                if me in row:
                    groups[i] = g
    out = (SubAxis(RING_SUBAXIS, ring, ring_rank, groups[0]),
           SubAxis(ULYSSES_SUBAXIS, ulysses_degree, uly_rank, groups[1]))
    _FACTORED[ulysses_degree] = out
    return out


def _axes(axis):
    if axis is None:
        return ZERO_AXES
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def axis_size(axis) -> int:
    if isinstance(axis, SubAxis):
        return axis.size
    sizes = get_spec().axis_sizes()
    return int(np.prod([sizes[a] for a in _axes(axis)]))


def axis_group(axis=None):
    """The process group of a mesh axis or tuple of axes (None without a
    process group): a tuple's group is that of its one axis above 1 (the
    data axis's when none is), or, where several are, the world's when
    they span it in mesh order (the joint data x zero domain: the world's
    rank order is the flattened mesh's)."""
    if isinstance(axis, SubAxis):
        return axis.group
    mesh = get_mesh()
    if mesh is None:
        return None
    spec = get_spec()
    sizes = spec.axis_sizes()
    axes = _axes(axis)
    big = [a for a in axes if sizes[a] > 1]
    if len(big) > 1:
        in_order = big == [a for a in ALL_AXES if a in big]
        if not in_order or \
                int(np.prod([sizes[a] for a in big])) != spec.world_size:
            raise NotImplementedError(
                f"a collective over the mesh axes {big} (not the whole "
                f"world in mesh order) is not ported to deepspeed_tpu_torch "
                f"yet (ROADMAP queue 1 item 8)")
        return _CURRENT_GROUP
    name = big[0] if big else (DATA_AXIS if DATA_AXIS in axes else axes[0])
    return mesh.get_group(name)


def axis_rank(axis=None) -> int:
    """This rank's coordinate along a mesh axis (flattened in axis order
    for a tuple)."""
    if isinstance(axis, SubAxis):
        return axis.rank
    mesh = get_mesh()
    if mesh is None:
        return 0
    coord = dict(zip(ALL_AXES, mesh.get_coordinate()))
    sizes = get_spec().axis_sizes()
    rank = 0
    for a in _axes(axis):
        rank = rank * sizes[a] + int(coord[a])
    return rank


def get_world_size() -> int:
    return get_spec().world_size if has_mesh() else process_world_size()


def get_data_parallel_world_size() -> int:
    return axis_size(ZERO_AXES) if has_mesh() else process_world_size()


def get_model_parallel_world_size() -> int:
    return axis_size(TENSOR_AXIS) if has_mesh() else 1


def get_pipe_parallel_world_size() -> int:
    return axis_size(PIPE_AXIS) if has_mesh() else 1


def get_expert_parallel_world_size() -> int:
    return axis_size(EXPERT_AXIS) if has_mesh() else 1


def get_sequence_parallel_world_size() -> int:
    return axis_size(SEQ_AXIS) if has_mesh() else 1
