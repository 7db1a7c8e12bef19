"""Communication facade (counterpart of `deepspeed_tpu/comm/comm.py`).

The reference's `deepspeed.comm` surface over `torch.distributed`:

  * `init_distributed()` — the process group from the launcher's variables
    (`RANK` / `WORLD_SIZE` / `MASTER_ADDR` / `MASTER_PORT`, as torchrun sets
    them) or the arguments, then the mesh (`comm/mesh.py`). The backend is
    NCCL for a `cuda` device and gloo for the CPU, chosen from the device
    and never switched: a backend that does not drive the device raises;
  * collectives on this rank's tensor, addressed by mesh axis (`axis=`, the
    ZeRO data domain by default) or by a process group (`group=`), each
    through the comms logger: payload bytes always, wall time (with a wait
    for the device) when `comms_logger` is enabled. An axis of size 1
    records nothing; with a process group the op still runs (a copy).

The JAX package's eager ops take global arrays; here each rank holds its
own tensor, so an op's result is this rank's: `all_reduce` the reduced
tensor, `all_gather` the rank-ordered concatenation (or stack), and
`reduce_scatter` this rank's chunk. `reduce`, `gather` and `scatter` keep
the JAX package's meaning (every rank gets the reduced / gathered value;
rank i gets chunk i). Eager point-to-point raises where the JAX package
raises; `p2p_shift` is the neighbour exchange.
"""

import os
import time
from enum import Enum

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.utils.logging import logger


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN}

_INITIALIZED = False


def is_initialized():
    return _INITIALIZED


def backend_for(device) -> str:
    """The process-group backend of a device: nccl for cuda, gloo for the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(device):
    """Raise unless the initialized process group's backend drives
    `device` (a gloo group under a cuda engine, or the reverse)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    want = backend_for(device)
    have = str(dist.get_backend()).lower()
    if want not in have:
        raise ValueError(
            f"the process group's backend is {have!r}, but the device "
            f"{torch.device(device)} needs {want!r}: the port never runs a "
            f"collective through another backend")


def init_distributed(dist_backend=None,
                     auto_mpi_discovery=True,
                     distributed_port=29500,
                     verbose=True,
                     timeout=None,
                     init_method=None,
                     dist_init_required=None,
                     config=None,
                     rank=-1,
                     world_size=-1,
                     mesh_config=None,
                     device=None):
    """Bring up the process group (when the world has more than one rank,
    or `init_method` names a rendezvous) and install the mesh.

    The reference's signature, plus `device` (default `cuda`): the backend
    follows it, and a `dist_backend` that does not drive it raises. A
    group initialized by the caller is kept, with the same check."""
    global _INITIALIZED
    if device is None:
        device = "cpu" if dist_backend is not None and \
            "gloo" in str(dist_backend).lower() else "cuda"
    backend = backend_for(device)
    if dist_backend is not None and backend not in str(dist_backend).lower():
        raise ValueError(f"dist_backend {dist_backend!r} does not drive "
                         f"device {device!r} (it needs {backend!r})")
    if dist.is_initialized():
        check_backend(device)
    else:
        n = world_size if world_size > 0 else \
            int(os.environ.get("WORLD_SIZE", "1"))
        r = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
        if n > 1 or init_method is not None:
            if init_method is None:
                addr = os.environ.get("MASTER_ADDR", "localhost")
                port = os.environ.get("MASTER_PORT", distributed_port)
                init_method = f"tcp://{addr}:{port}"
            if backend == "nccl":
                torch.cuda.set_device(int(os.environ.get(
                    "LOCAL_RANK", r % max(torch.cuda.device_count(), 1))))
            if verbose:
                logger.info(f"init_process_group(backend={backend}, "
                            f"init_method={init_method}, world_size={n}, "
                            f"rank={r})")
            kw = {} if timeout is None else {"timeout": timeout}
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=n, rank=r, **kw)
    _INITIALIZED = True
    mesh_mod.ensure_mesh(mesh_config)


def get_rank():
    return mesh_mod.process_rank()


def get_local_rank():
    """This process's device index on its host (torchrun's LOCAL_RANK):
    one process drives one device."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_world_size():
    return mesh_mod.get_world_size()


def barrier(group=None):
    if dist.is_available() and dist.is_initialized():
        collectives.LAUNCHES["barrier"] += 1
        dist.barrier(group=_process_group(None, group))


# ------------------------------------------------------------------
# Comms logging
# ------------------------------------------------------------------


class CommsLogger:
    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.records = {}  # op_name -> list of (bytes, seconds)

    def configure(self, enabled=False, verbose=False, **kw):
        self.enabled = enabled
        self.verbose = verbose

    def append(self, op_name, size_bytes, seconds):
        self.records.setdefault(op_name, []).append((size_bytes, seconds))
        # into the facade stats too (and, when a Telemetry is bound there,
        # comm/<op>_bytes + comm/<op>_ms)
        collectives.stats.record(op_name, size_bytes, seconds)
        if self.verbose:
            logger.info(f"comm op: {op_name} | bytes: {size_bytes} | "
                        f"time (ms): {seconds * 1e3:.3f}")

    def log_all(self):
        lines = [f"{'Op':<20}{'Count':>8}{'Total MB':>12}{'Avg ms':>10}"
                 f"{'Alg bw GB/s':>14}"]
        for op, recs in sorted(self.records.items()):
            n = len(recs)
            total_b = sum(r[0] for r in recs)
            total_t = sum(r[1] for r in recs)
            bw = (total_b / total_t / 1e9) if total_t > 0 else 0.0
            lines.append(f"{op:<20}{n:>8}{total_b / 1e6:>12.2f}"
                         f"{total_t / n * 1e3:>10.3f}{bw:>14.2f}")
        out = "\n".join(lines)
        logger.info("\n" + out)
        return out

    def reset(self):
        self.records.clear()


comms_logger = CommsLogger()


def log_summary():
    return comms_logger.log_all()


def _sync(x):
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _timed(op_name, n, nbytes, fn):
    """Run `fn`; record `nbytes` under `op_name` when the axis has more than
    one rank (with the wall time, waiting for the device, when the comms
    logger is on)."""
    if not comms_logger.enabled or n == 1:
        out = fn()
        if n > 1:
            collectives.stats.record(op_name, nbytes)
        return out
    t0 = time.perf_counter()
    out = fn()
    _sync(out if isinstance(out, torch.Tensor) else
          next((t for t in out if isinstance(t, torch.Tensor)), None))
    comms_logger.append(op_name, nbytes, time.perf_counter() - t0)
    return out


# ------------------------------------------------------------------
# Collectives on this rank's tensor
# ------------------------------------------------------------------


def _axis_tuple(axis):
    if axis is None:
        return mesh_mod.ZERO_AXES
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def _resolve(axis, group):
    """(process group or None, size) of an `axis=` name or a `group=`
    (a mesh axis name, a tuple of names, or a ProcessGroup)."""
    if not mesh_mod.has_mesh():
        mesh_mod.ensure_mesh()
    if isinstance(group, dist.ProcessGroup):
        return group, dist.get_world_size(group)
    axes = _axis_tuple(axis if axis is not None else group)
    return mesh_mod.axis_group(axes), mesh_mod.axis_size(axes)


def _process_group(axis, group):
    return _resolve(axis, group)[0]


def all_reduce(tensor, op=ReduceOp.SUM, axis=None, group=None):
    """The reduction of every rank's `tensor` (a new tensor; AVG is the
    sum divided by the group's size)."""
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}; supported: "
                         f"{sorted(o.name for o in _TORCH_OPS)}")
    pg, n = _resolve(axis, group)
    if pg is None:
        return tensor

    def fn():
        out = tensor.clone()
        collectives.LAUNCHES["all_reduce"] += 1
        dist.all_reduce(out, op=_TORCH_OPS[op], group=pg)
        return out / n if op == ReduceOp.AVG else out

    return _timed("all_reduce", n, collectives.payload_bytes(tensor), fn)


def all_gather(tensor, axis=None, tiled=True, group=None):
    """Every rank's `tensor` along dim 0 in rank order: concatenated
    (tiled) or stacked."""
    pg, n = _resolve(axis, group)
    x = tensor if tiled else tensor.unsqueeze(0)
    if pg is None:
        return x
    return _timed("all_gather", n, collectives.payload_bytes(tensor),
                  lambda: collectives._gather_dim0(x, pg, n))


def reduce_scatter(tensor, op=ReduceOp.SUM, axis=None, group=None):
    """This rank's chunk (dim 0) of the sum (or average) over the group."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter supports ops ('SUM', 'AVG'); got "
                         f"{op}")
    pg, n = _resolve(axis, group)
    if pg is None:
        return tensor
    if tensor.shape[0] % n:
        raise ValueError(f"reduce_scatter: leading dim {tensor.shape[0]} "
                         f"not divisible by the group's size {n}")

    def fn():
        out = torch.empty((tensor.shape[0] // n,) + tuple(tensor.shape[1:]),
                          dtype=tensor.dtype, device=tensor.device)
        collectives.LAUNCHES["reduce_scatter"] += 1
        dist.reduce_scatter_tensor(out, tensor.contiguous(),
                                   op=dist.ReduceOp.SUM, group=pg)
        return out / n if op == ReduceOp.AVG else out

    return _timed("reduce_scatter", n, collectives.payload_bytes(tensor), fn)


def all_to_all(tensor, axis=None, split_axis=0, concat_axis=0, group=None):
    """Chunk j of `split_axis` to rank j; the received chunks concatenated
    along `concat_axis` in rank order."""
    pg, n = _resolve(axis, group)
    if pg is None:
        return tensor
    if tensor.shape[split_axis] % n:
        raise ValueError(f"all_to_all: split_axis of size "
                         f"{tensor.shape[split_axis]} not divisible by {n}")

    def fn():
        send = torch.stack(tensor.chunk(n, dim=split_axis))
        recv = torch.empty_like(send)
        collectives.LAUNCHES["all_to_all"] += 1
        dist.all_to_all_single(recv, send, group=pg)
        return torch.cat(recv.unbind(0), dim=concat_axis)

    return _timed("all_to_all", n, collectives.payload_bytes(tensor), fn)


def broadcast(tensor, src=0, axis=None, group=None):
    """Rank `src`'s `tensor` on every rank (a new tensor)."""
    pg, n = _resolve(axis, group)
    if pg is None:
        return tensor

    def fn():
        out = tensor.clone()
        collectives.LAUNCHES["broadcast"] += 1
        dist.broadcast(out, src=dist.get_global_rank(pg, src), group=pg)
        return out

    return _timed("broadcast", n, collectives.payload_bytes(tensor), fn)


def reduce(tensor, dst=0, op=ReduceOp.SUM, axis=None, group=None):
    """The JAX package's `reduce`: every rank gets the reduced value (`dst`
    is accepted for the reference's signature)."""
    return all_reduce(tensor, op=op, axis=axis, group=group)


def gather(tensor, gather_list=None, dst=0, axis=None, group=None):
    """The JAX package's `gather`: every rank gets the concatenation."""
    return all_gather(tensor, axis=axis, group=group)


def scatter(tensor, scatter_list=None, src=0, axis=None, group=None):
    """Rank i gets chunk i (dim 0) of rank `src`'s data: the concatenation
    of `scatter_list` when given, else `tensor`."""
    data = torch.cat(list(scatter_list), dim=0) \
        if scatter_list is not None else tensor
    pg, n = _resolve(axis, group)
    if pg is None:
        return data
    if data.shape[0] % n:
        raise ValueError(f"scatter: leading dim {data.shape[0]} not "
                         f"divisible by the group's size {n}")

    def fn():
        chunks = [c.contiguous() for c in data.chunk(n, dim=0)]
        out = torch.empty_like(chunks[0])
        collectives.LAUNCHES["scatter"] += 1
        me = dist.get_rank(pg)
        dist.scatter(out, scatter_list=chunks if me == src else None,
                     src=dist.get_global_rank(pg, src), group=pg)
        return out

    return _timed("scatter", n, collectives.payload_bytes(data), fn)


def all_to_all_single(output=None, input=None, output_split_sizes=None,
                      input_split_sizes=None, axis=None, group=None):
    """The reference's `all_to_all_single` (dim 0), with the JAX package's
    rules: even splits without sizes; uneven splits must be one list shared
    by every rank (rank r receives `splits[r]` from each rank), given as
    `input_split_sizes` (and `output_split_sizes`, if given, equal)."""
    tensor = input if input is not None else output
    if output_split_sizes is None and input_split_sizes is None:
        return all_to_all(tensor, axis=axis, group=group)
    if input_split_sizes is None:
        raise NotImplementedError(
            "all_to_all_single: output_split_sizes without input_split_sizes "
            "(per-rank receive sizes) is not a shared split — pass "
            "symmetric input_split_sizes")
    splits = [int(s) for s in input_split_sizes]
    pg, n = _resolve(axis, group)
    if len(splits) != n:
        raise ValueError(f"all_to_all_single: {len(splits)} input splits for "
                         f"axis size {n} — need exactly one split per rank")
    if output_split_sizes is not None and \
            list(map(int, output_split_sizes)) != splits:
        raise ValueError(
            "all_to_all_single: the uneven exchange needs symmetric splits "
            f"(every rank shares one split list); got input {splits} vs "
            f"output {list(map(int, output_split_sizes))}")
    if tensor.shape[0] != sum(splits):
        raise ValueError(f"all_to_all_single: leading dim {tensor.shape[0]} "
                         f"!= sum(splits) {sum(splits)}")
    if pg is None:
        return tensor
    me = dist.get_rank(pg)

    def fn():
        out = torch.empty((n * splits[me],) + tuple(tensor.shape[1:]),
                          dtype=tensor.dtype, device=tensor.device)
        collectives.LAUNCHES["all_to_all"] += 1
        dist.all_to_all_single(out, tensor.contiguous(),
                               output_split_sizes=[splits[me]] * n,
                               input_split_sizes=splits, group=pg)
        return out

    return _timed("all_to_all", n, collectives.payload_bytes(tensor), fn)


def _into(out, result):
    if out is None:
        return result
    out.copy_(result)
    return out


def all_gather_into_tensor(output_tensor=None, input_tensor=None, axis=None,
                           group=None):
    """The reference's flat all-gather (into `output_tensor` when given)."""
    return _into(output_tensor, all_gather(input_tensor, axis=axis,
                                           group=group))


def reduce_scatter_tensor(output=None, input=None, op=ReduceOp.SUM,
                          axis=None, group=None):
    """The reference's flat reduce-scatter (into `output` when given)."""
    return _into(output, reduce_scatter(input, op=op, axis=axis,
                                        group=group))


def inference_all_reduce(tensor, op=ReduceOp.SUM, axis=None, group=None):
    """The TP-group all-reduce of the decode path (default: the tensor
    axis)."""
    axes = axis if axis is not None else \
        (group if group is not None else (mesh_mod.TENSOR_AXIS,))
    return all_reduce(tensor, op=op, axis=axes)


def _coalesced(op_name, tensors, op, axis, group):
    """Many tensors through one collective over one flat buffer. As in the
    JAX package, the stats hear of it only through the comms logger."""
    tensors = list(tensors)
    pg, n = _resolve(axis, group)
    if pg is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    t0 = time.perf_counter()
    if op is None:
        full = collectives._gather_dim0(flat, pg, n).reshape(n, -1)
        outs, off = [], 0
        for t in tensors:
            k = t.numel()
            outs.append(full[:, off:off + k].reshape(
                (n * t.shape[0],) + tuple(t.shape[1:]) if t.dim() else (n,)))
            off += k
    else:
        collectives.LAUNCHES["all_reduce"] += 1
        flat = flat.clone()
        dist.all_reduce(flat, op=_TORCH_OPS[op], group=pg)
        if op == ReduceOp.AVG:
            flat = flat / n
        outs = [c.reshape(t.shape) for c, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]
    if comms_logger.enabled and n > 1:
        _sync(flat)
        comms_logger.append(op_name, sum(collectives.payload_bytes(t)
                                         for t in tensors),
                            time.perf_counter() - t0)
    return outs


def all_reduce_coalesced(tensors, op=ReduceOp.SUM, axis=None, group=None):
    """The reference's `all_reduce_coalesced`: one collective for many
    tensors (they share a dtype)."""
    return _coalesced("all_reduce_coalesced", tensors, op, axis, group)


def all_gather_coalesced(tensors, axis=None, group=None):
    """The reference's `all_gather_coalesced`: one collective for many
    tensors (they share a dtype)."""
    return _coalesced("all_gather_coalesced", tensors, None, axis, group)


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False):
    """A plain barrier (a rank mismatch fails the collective itself)."""
    return barrier(group)


def _data_domain_is_world() -> bool:
    if not mesh_mod.has_mesh():
        return True
    return all(mesh_mod.axis_size(a) == 1
               for a in (mesh_mod.PIPE_AXIS, mesh_mod.EXPERT_AXIS,
                         mesh_mod.TENSOR_AXIS))


def get_global_rank(group=None, group_rank=0, coords=None):
    """Group-local rank -> global rank: the lexicographic position on the
    mesh, `coords` ({axis: coordinate}, default 0s) fixing the axes outside
    the group (the JAX package's rule)."""
    import numpy as np
    if isinstance(group, dist.ProcessGroup):
        return dist.get_global_rank(group, group_rank)
    if group is None or _axis_tuple(group) == tuple(mesh_mod.ALL_AXES):
        return group_rank
    if _axis_tuple(group) == tuple(mesh_mod.ZERO_AXES) and \
            _data_domain_is_world():
        return group_rank
    sizes = mesh_mod.get_spec().axis_sizes()
    names = list(mesh_mod.ALL_AXES)
    shape = [sizes[n] for n in names]
    gaxes = [n for n in names if n in _axis_tuple(group)]
    if not gaxes:
        raise ValueError(f"get_global_rank: unknown group axes {group}; mesh "
                         f"axes: {names}")
    gshape = [sizes[n] for n in gaxes]
    total = int(np.prod(gshape))
    if not 0 <= group_rank < total:
        raise ValueError(f"get_global_rank: group_rank {group_rank} out of "
                         f"range for group {gaxes} of size {total}")
    gcoords = dict(zip(gaxes, np.unravel_index(group_rank, gshape)))
    fixed = dict(coords or {})
    full = [int(gcoords.get(n, fixed.get(n, 0))) for n in names]
    return int(np.ravel_multi_index(full, shape))


def get_world_group():
    """Every mesh axis (the group handle of the whole world)."""
    return mesh_mod.ALL_AXES


def new_group(ranks=None):
    """Groups are mesh axes here (pass axis="data" / ... to a collective);
    returns the default data domain, as the JAX package does."""
    logger.warning("comm.new_group: groups are mesh axes; returning the "
                   "default data domain — configure the `mesh` block instead")
    return mesh_mod.ZERO_AXES


# --- point to point -------------------------------------------------------


def p2p_shift(x, axis_name, shift=1):
    """Neighbour exchange: rank i's tensor goes to rank (i + shift) % n of
    the axis (the pipeline's send/receive pair)."""
    n = collectives.axis_size(axis_name)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return collectives.ppermute(x, axis_name, perm)


def _no_eager_p2p(name):
    raise NotImplementedError(
        f"comm.{name}: eager point-to-point is refused, as in the JAX "
        f"package — express the exchange with comm.p2p_shift")


def send(tensor, dst, group=None, tag=0):
    _no_eager_p2p("send")


def recv(tensor, src, group=None, tag=0):
    _no_eager_p2p("recv")


def isend(tensor, dst, group=None, tag=0):
    _no_eager_p2p("isend")


def irecv(tensor, src, group=None, tag=0):
    _no_eager_p2p("irecv")


def is_available():
    return dist.is_available()


def destroy_process_group(group=None):
    """Tear down the mesh and the process group, so a fresh
    init_distributed can follow."""
    global _INITIALIZED
    mesh_mod.clear_mesh()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False


# the facade forms under the registry: collectives.run("all_reduce", ...)
for _name, _eager in (("all_reduce", all_reduce),
                      ("all_gather", all_gather),
                      ("reduce_scatter", reduce_scatter),
                      ("all_to_all", all_to_all)):
    collectives.register_op(_name, lax=collectives.get_op(_name).lax,
                            eager=_eager)
del _name, _eager
