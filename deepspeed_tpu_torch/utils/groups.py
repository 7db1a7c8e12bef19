"""`deepspeed_tpu_torch.utils.groups` — the reference's process-group
bookkeeping (`deepspeed/utils/groups.py`) over the mesh (counterpart of
`deepspeed_tpu/utils/groups.py`).

A "group" handle is a tuple of mesh axis names, which every comm facade op
accepts as `group=` / `axis=` (`comm/mesh.axis_group` resolves it to the
`torch.distributed` group). Reference names keep their leading underscore,
with public aliases.
"""

from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.utils.logging import logger

_EP_SIZE = None


def _spec_sizes():
    if not mesh_mod.has_mesh():
        mesh_mod.ensure_mesh()
    return mesh_mod.get_spec().axis_sizes()


def initialize(ep_size=1, mpu=None):
    """Record the expert-parallel degree; the mesh (the config's `mesh`
    block) wins where they disagree."""
    global _EP_SIZE
    _EP_SIZE = int(ep_size)
    if mesh_mod.has_mesh():
        actual = mesh_mod.axis_size(mesh_mod.EXPERT_AXIS)
        if actual not in (1, _EP_SIZE):
            logger.warning(f"groups.initialize(ep_size={ep_size}) but the "
                           f"mesh expert axis is {actual}; the mesh wins")


def _get_data_parallel_group():
    return mesh_mod.ZERO_AXES


def _get_data_parallel_world_size():
    _spec_sizes()
    return mesh_mod.axis_size(mesh_mod.ZERO_AXES)


def _get_data_parallel_rank():
    """This rank's coordinate in the data-parallel domain (ZERO_AXES,
    flattened in axis order)."""
    _spec_sizes()
    return mesh_mod.axis_rank(mesh_mod.ZERO_AXES)


def _get_model_parallel_group():
    return (mesh_mod.TENSOR_AXIS,)


def _get_model_parallel_world_size():
    return _spec_sizes()[mesh_mod.TENSOR_AXIS]


def _get_expert_parallel_group(group_name=None):
    return (mesh_mod.EXPERT_AXIS,)


def _get_expert_parallel_world_size(group_name=None):
    return _spec_sizes()[mesh_mod.EXPERT_AXIS]


def _get_expert_data_parallel_group(group_name=None):
    """The replication domain of the expert weights: the ZeRO axes that do
    not carry experts."""
    return tuple(a for a in mesh_mod.ZERO_AXES if a != mesh_mod.EXPERT_AXIS)


def _get_expert_data_parallel_world_size(group_name=None):
    _spec_sizes()
    return mesh_mod.axis_size(_get_expert_data_parallel_group())


def _get_sequence_parallel_group():
    return (mesh_mod.SEQ_AXIS,)


def _get_sequence_parallel_world_size():
    return _spec_sizes()[mesh_mod.SEQ_AXIS]


def _get_world_group():
    return mesh_mod.ALL_AXES


# public aliases
get_data_parallel_group = _get_data_parallel_group
get_data_parallel_world_size = _get_data_parallel_world_size
get_data_parallel_rank = _get_data_parallel_rank
get_model_parallel_world_size = _get_model_parallel_world_size
get_expert_parallel_group = _get_expert_parallel_group
get_expert_parallel_world_size = _get_expert_parallel_world_size
get_sequence_parallel_world_size = _get_sequence_parallel_world_size
