"""Pluggable collective layer — the comm spine (counterpart of
`deepspeed_tpu/comm/collectives.py`).

One registry of the five collective primitives (all_reduce / all_gather /
reduce_scatter / all_to_all / ppermute). In the JAX package each has an
in-`shard_map` form (`jax.lax`'s signature) and an eager form over global
arrays. Here a process is one participant and holds its own tensor, so
both forms run `torch.distributed` on it; the registry keeps the
reference's two fields: `lax` is the primitive with `jax.lax`'s signature
(`psum(x, axis_name)`, `all_gather(x, axis_name, axis=, tiled=)`, ...) and
`eager` the `comm/comm.py` facade form, which `comm.py` registers at
import. An axis name (or tuple of names) resolves to that mesh axis's
process group (`comm/mesh.py`); without a process group every axis has size
1 and an op returns its input.

Byte convention (the JAX package's): recorded bytes = the payload bytes a
single participant hands to the underlying op, times ``repeats``; an axis
of size 1 records nothing (no wire). A collective over a one-rank group
still runs (a copy), and `LAUNCHES` counts every op issued to
`torch.distributed`, whatever the group's size. Per-op stats mirror into a
bound `Telemetry` (`comm/<op>_bytes` and `comm/<op>_calls` counters,
`comm/<op>_ms` histograms).

**Wire transforms** (`WireTransform`: encode/decode over f32 payloads):
``"none"`` (the fp32 wire), ``"int8"`` (ZeRO++ qwZ/qgZ groupwise symmetric
int8, scale = max|x|/127 a group) and ``"onebit"`` (1-bit sign + mean
magnitude, 8 signs a byte, with error feedback in
`compressed_all_reduce(..., transform="onebit", err=...)`). The codecs are
plain torch: the JAX package computes them in jnp, outside any Pallas
kernel.
"""

import collections
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.utils.tree import tree_map

OP_NAMES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
            "ppermute")

TRANSFORM_NAMES = ("none", "int8", "onebit")

DEFAULT_GROUP_SIZE = 256  # qwZ/qgZ quantization group (reference default)

# ops issued to torch.distributed, by name (chip_smoke reads it as it reads
# the kernels' launch counts)
LAUNCHES = collections.Counter()


# ------------------------------------------------------------------
# Per-op stats, mirrored into telemetry when bound
# ------------------------------------------------------------------


class CommStats:
    """Per-op {calls, bytes, seconds} accumulator. `record` is called by
    the primitives below (no seconds) and by the comms logger (measured
    seconds); a bound `Telemetry` gets the same records as `comm/<op>_bytes`
    / `comm/<op>_calls` counters and `comm/<op>_ms` histograms."""

    def __init__(self):
        self._records: Dict[str, Dict[str, float]] = {}
        self._telemetry = None

    def bind_telemetry(self, telemetry):
        """Mirror subsequent records into `telemetry`'s registry."""
        self._telemetry = telemetry

    def record(self, op_name, nbytes, seconds=None, calls=1):
        rec = self._records.setdefault(
            op_name, {"calls": 0, "bytes": 0, "seconds": 0.0})
        rec["calls"] += int(calls)
        rec["bytes"] += int(nbytes)
        if seconds is not None:
            rec["seconds"] += float(seconds)
        t = self._telemetry
        if t is not None:
            t.inc(f"comm/{op_name}_bytes", int(nbytes))
            t.inc(f"comm/{op_name}_calls", int(calls))
            if seconds is not None:
                t.observe(f"comm/{op_name}_ms", float(seconds) * 1e3)

    def bytes_of(self, op_name):
        return int(self._records.get(op_name, {}).get("bytes", 0))

    def calls_of(self, op_name):
        return int(self._records.get(op_name, {}).get("calls", 0))

    def total_bytes(self):
        return sum(int(r["bytes"]) for r in self._records.values())

    def snapshot(self):
        return {op: dict(rec) for op, rec in self._records.items()}

    def reset(self):
        self._records.clear()


stats = CommStats()


def payload_bytes(x):
    """Payload bytes of a tensor (or a tuple / list of tensors)."""
    if isinstance(x, (tuple, list)):
        return sum(payload_bytes(t) for t in x)
    return x.numel() * x.element_size()


def axis_size(axis_name) -> int:
    """Size of a mesh axis (or tuple of axes); installs the default mesh
    over the process group when none is."""
    if not mesh_mod.has_mesh():
        mesh_mod.ensure_mesh()
    return mesh_mod.axis_size(axis_name)


def _group(axis_name):
    """(process group or None, size) of a mesh axis; None without a process
    group, where every op is the identity."""
    n = axis_size(axis_name)
    return mesh_mod.axis_group(axis_name), n


def _note(op_name, x, n, repeats=1):
    if n > 1:
        stats.record(op_name, payload_bytes(x) * repeats, calls=repeats)


# ------------------------------------------------------------------
# Op registry: one name -> the primitive and the facade form
# ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    name: str
    lax: Callable                      # the primitive (jax.lax's signature)
    eager: Optional[Callable] = None   # the comm/comm.py facade form


_OPS: Dict[str, CollectiveOp] = {}


def register_op(name, *, lax, eager=None):
    """Register (or re-register) a collective under `name`; re-registration
    replaces the entry, so a wrapper plugs in under every consumer."""
    op = CollectiveOp(name=name, lax=lax, eager=eager)
    _OPS[name] = op
    return op


def get_op(name):
    if name not in _OPS:
        raise ValueError(f"unknown collective op {name!r}; registered ops: "
                         f"{sorted(_OPS)}")
    return _OPS[name]


def op_names():
    return tuple(sorted(_OPS))


def collective(name, *args, **kwargs):
    """Dispatch to the primitive form through the registry."""
    return get_op(name).lax(*args, **kwargs)


def run(name, *args, **kwargs):
    """Dispatch to the facade form through the registry."""
    op = get_op(name)
    if op.eager is None:
        raise ValueError(f"collective op {name!r} has no eager "
                         f"implementation; use it through collective()")
    return op.eager(*args, **kwargs)


# ------------------------------------------------------------------
# The primitives (a participant's tensor in, its result out)
# ------------------------------------------------------------------


def _all_reduce_sum(x, group):
    out = x.clone()
    LAUNCHES["all_reduce"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def psum(x, axis_name, *, repeats=1):
    group, n = _group(axis_name)
    _note("all_reduce", x, n, repeats)
    return x if group is None else _all_reduce_sum(x, group)


def pmean(x, axis_name, *, repeats=1):
    """The sum over the axis divided by its size (the sum, then one
    division: the same arithmetic on every backend)."""
    group, n = _group(axis_name)
    _note("all_reduce", x, n, repeats)
    return x if group is None else _all_reduce_sum(x, group) / n


def _gather_dim0(xs, group, n):
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    LAUNCHES["all_gather"] += 1
    dist.all_gather_into_tensor(out, xs.contiguous(), group=group)
    return out


def all_gather(x, axis_name, *, axis=0, tiled=False, repeats=1):
    """Tiled: the participants' tensors concatenated along `axis` in rank
    order; else stacked along a new axis at `axis`."""
    group, n = _group(axis_name)
    _note("all_gather", x, n, repeats)
    if not tiled:
        x = x.unsqueeze(axis)
    if group is None:
        return x
    return _gather_dim0(x.movedim(axis, 0), group, n).movedim(0, axis)


def reduce_scatter(x, axis_name, *, scatter_dimension=0, tiled=True,
                   repeats=1):
    """The sum over the axis, scattered along `scatter_dimension`: this
    participant's 1/n of it (tiled), or its row of a dimension of size n
    (not tiled, the dimension dropped)."""
    group, n = _group(axis_name)
    _note("reduce_scatter", x, n, repeats)
    d = scatter_dimension
    if not tiled and x.shape[d] != n:
        raise ValueError(f"reduce_scatter(tiled=False): dimension {d} has "
                         f"size {x.shape[d]}, the axis {n}")
    if group is None:
        out = x
    else:
        xs = x.movedim(d, 0).contiguous()
        if xs.shape[0] % n:
            raise ValueError(f"reduce_scatter: dimension {d} of size "
                             f"{xs.shape[0]} not divisible by the axis "
                             f"size {n}")
        res = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        LAUNCHES["reduce_scatter"] += 1
        dist.reduce_scatter_tensor(res, xs, op=dist.ReduceOp.SUM,
                                   group=group)
        out = res.movedim(0, d)
    return out if tiled else out.squeeze(d)


def all_to_all(x, axis_name, *, split_axis, concat_axis, tiled=False,
               repeats=1):
    """`jax.lax.all_to_all` on a participant's tensor: chunk j of
    `split_axis` goes to participant j, and the received chunks are
    concatenated along `concat_axis` in rank order (tiled), or stacked
    there as a new axis with `split_axis` (of size n) dropped."""
    group, n = _group(axis_name)
    _note("all_to_all", x, n, repeats)
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: split_axis of size "
                             f"{x.shape[split_axis]} not divisible by {n}")
        chunks = x.chunk(n, dim=split_axis)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all(tiled=False): split_axis has size "
                             f"{x.shape[split_axis]}, the axis {n}")
        chunks = x.unbind(split_axis)
    send = torch.stack(chunks)
    if group is None:
        recv = send
    else:
        recv = torch.empty_like(send)
        LAUNCHES["all_to_all"] += 1
        dist.all_to_all_single(recv, send, group=group)
    if tiled:
        return torch.cat(recv.unbind(0), dim=concat_axis)
    return recv.movedim(0, concat_axis)


def ppermute(x, axis_name, perm, *, repeats=1):
    """Participant i's tensor goes to j for each (i, j) in `perm`; a
    participant no one sends to gets zeros (`jax.lax.ppermute`)."""
    group, n = _group(axis_name)
    _note("ppermute", x, n, repeats)
    if group is None:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(group, d), group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, s), group))
    if ops:
        LAUNCHES["ppermute"] += 1
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


register_op("all_reduce", lax=psum)
register_op("all_gather", lax=all_gather)
register_op("reduce_scatter", lax=reduce_scatter)
register_op("all_to_all", lax=all_to_all)
register_op("ppermute", lax=ppermute)


# ------------------------------------------------------------------
# Wire transforms (compression hooks)
# ------------------------------------------------------------------


def group_quant_int8(x, group_size=DEFAULT_GROUP_SIZE):
    """x: [..., D] -> (int8 [..., D], f32 scales [..., D // group_size]).
    Groupwise symmetric quant, scale = max|group| / 127 (one group when D
    is not a multiple of `group_size`)."""
    D = x.shape[-1]
    g = max(1, D // group_size) if D % group_size == 0 else 1
    gs = D // g
    xg = x.float().reshape(tuple(x.shape[:-1]) + (g, gs))
    amax = xg.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xg / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return q.reshape(x.shape), scale


def group_dequant_int8(q, scale, dtype):
    """Inverse of `group_quant_int8` (the reduction runs in f32)."""
    D = q.shape[-1]
    g = scale.shape[-1]
    x = q.float().reshape(tuple(q.shape[:-1]) + (g, D // g)) * scale[..., None]
    return x.reshape(q.shape).to(dtype)


_BIT_WEIGHTS = [1 << i for i in range(8)]


def _pack_signs(bits):
    """bool [..., M] with M % 8 == 0 -> uint8 [..., M // 8] (bit i of a
    byte is element i of its eight)."""
    b = bits.reshape(tuple(bits.shape[:-1]) + (-1, 8)).to(torch.int32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (b * w).sum(dim=-1).to(torch.uint8)


def _unpack_signs(packed, numel):
    """uint8 [..., P] -> f32 [..., numel] of +-1 (a set bit is +1)."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed[..., :, None].to(torch.int32) >> shifts) & 1
    flat = bits.reshape(tuple(packed.shape[:-1]) + (-1,))[..., :numel]
    return (flat * 2 - 1).float()


def onebit_encode(x):
    """Flat f32 [N] -> (packed signs uint8 [ceil(N / 8)], scale f32 [1]):
    sign(x) * mean|x|, with sign(0) -> +1 so each value packs to one bit.
    The scale's sum runs in torch's order, so it may differ from jnp's by
    a few ulp."""
    numel = x.shape[0]
    scale = x.float().abs().mean()[None]
    bits = x >= 0
    pad = (-numel) % 8
    if pad:
        bits = torch.cat([bits, torch.zeros(pad, dtype=torch.bool,
                                            device=x.device)])
    return _pack_signs(bits), scale


def onebit_decode(packed, scale, numel):
    """Inverse of `onebit_encode`: +-scale values, f32 [..., numel]."""
    return _unpack_signs(packed, numel) * scale[..., :1]


@dataclasses.dataclass(frozen=True)
class WireTransform:
    """Encode/decode pair over f32 payloads. encode: f32 [..., D] ->
    (payloads, meta); every payload keeps the input's leading dims so a
    collective moves them alike. decode: (payloads, meta) -> f32
    [..., D]."""
    name: str
    encode: Callable[[torch.Tensor], Tuple[Tuple[torch.Tensor, ...], dict]]
    decode: Callable[[Tuple[torch.Tensor, ...], dict], torch.Tensor]


def _none_encode(x):
    return (x.float(),), {}


def _none_decode(payloads, meta):
    return payloads[0]


def _int8_encode(x, group_size=DEFAULT_GROUP_SIZE):
    q, scale = group_quant_int8(x, group_size)
    return (q, scale), {}


def _int8_decode(payloads, meta):
    q, scale = payloads
    return group_dequant_int8(q, scale, torch.float32)


def _onebit_encode_t(x):
    packed, scale = onebit_encode(x.reshape(-1))
    return (packed, scale), {"numel": int(x.shape[-1])}


def _onebit_decode_t(payloads, meta):
    packed, scale = payloads
    return onebit_decode(packed, scale, meta["numel"])


_TRANSFORMS: Dict[str, WireTransform] = {}


def register_transform(transform):
    _TRANSFORMS[transform.name] = transform
    return transform


def get_transform(name, group_size=DEFAULT_GROUP_SIZE):
    if name == "int8" and group_size != DEFAULT_GROUP_SIZE:
        return WireTransform(name="int8",
                             encode=lambda x: _int8_encode(x, group_size),
                             decode=_int8_decode)
    if name not in _TRANSFORMS:
        raise ValueError(f"unknown wire transform {name!r}; registered "
                         f"transforms: {sorted(_TRANSFORMS)}")
    return _TRANSFORMS[name]


def transform_names():
    return tuple(sorted(_TRANSFORMS))


register_transform(WireTransform("none", _none_encode, _none_decode))
register_transform(WireTransform("int8", _int8_encode, _int8_decode))
register_transform(WireTransform("onebit", _onebit_encode_t,
                                 _onebit_decode_t))


# ------------------------------------------------------------------
# Composite compressed collectives
# ------------------------------------------------------------------


def transform_all_gather(x, axis_name, transform="int8",
                         group_size=DEFAULT_GROUP_SIZE, out_dtype=None):
    """All-gather with an encoded wire: local [...] -> stacked [n, ...].
    The payloads cross the wire; the receiver decodes. ``"none"`` is the
    plain all_gather."""
    out_dtype = out_dtype or x.dtype
    if transform == "none":
        return all_gather(x.to(out_dtype), axis_name)
    t = get_transform(transform, group_size)
    payloads, meta = t.encode(x.reshape(-1))
    gathered = tuple(all_gather(p, axis_name) for p in payloads)
    deq = t.decode(gathered, meta)                      # [n, numel] f32
    return deq.reshape((deq.shape[0],) + tuple(x.shape)).to(out_dtype)


def transform_reduce_scatter(x, axis_name, transform="int8",
                             group_size=DEFAULT_GROUP_SIZE):
    """Reduce-scatter with an encoded wire: flat [N] (N % n == 0) -> the
    f32 sum's [N / n]. The encoded chunks move by all_to_all; receivers
    decode and reduce in f32 (the qgZ dequant-reduce). onebit has no
    scatter form."""
    if transform not in ("none", "int8"):
        raise ValueError(f"transform_reduce_scatter supports transforms "
                         f"('none', 'int8'); got {transform!r}")
    n = axis_size(axis_name)
    N = x.shape[0]
    if N % n:
        raise ValueError(f"transform_reduce_scatter: leading dim {N} not "
                         f"divisible by axis size {n}")
    if transform == "none":
        return reduce_scatter(x.float(), axis_name)
    t = get_transform(transform, group_size)
    payloads, meta = t.encode(x.float().reshape(n, N // n))
    received = tuple(all_to_all(p, axis_name, split_axis=0, concat_axis=0)
                     for p in payloads)
    return t.decode(received, meta).sum(dim=0)         # [n, N/n] -> [N/n]


def transform_all_to_all(x, axis_name, *, split_axis, concat_axis,
                         tiled=True, transform="none",
                         group_size=DEFAULT_GROUP_SIZE, out_dtype=None):
    """All-to-all with an encoded wire (the MoE dispatch primitive):
    ``"none"`` the plain all_to_all, ``"int8"`` the quantized payload
    dequantized by the receiver; ``"onebit"`` is refused (a gradient codec
    with error feedback, not an activation codec)."""
    if transform == "onebit":
        raise ValueError(
            "transform_all_to_all does not support 'onebit' — the 1-bit wire "
            "is an error-feedback gradient codec, not an activation codec; "
            "use transform='int8' for compressed expert dispatch")
    out_dtype = out_dtype or x.dtype
    if transform == "none":
        return all_to_all(x, axis_name, split_axis=split_axis,
                          concat_axis=concat_axis, tiled=tiled)
    t = get_transform(transform, group_size)
    payloads, meta = t.encode(x)
    moved = tuple(all_to_all(p, axis_name, split_axis=split_axis,
                             concat_axis=concat_axis, tiled=tiled)
                  for p in payloads)
    return t.decode(moved, meta).to(out_dtype)


def compressed_all_reduce(x, axis_name, transform="none",
                          group_size=DEFAULT_GROUP_SIZE, err=None):
    """SUM over `axis_name` with a compressed wire. ``"none"`` / ``"int8"``
    run the 2-hop reduce-scatter + all-gather scheme; ``"onebit"`` the
    1-bit error-feedback reduce, which needs ``err`` (the f32 residual,
    shaped as ``x``) and returns ``(sum, new_err)``. Axis size 1 is the
    identity (onebit still returns its residual pair)."""
    if transform not in TRANSFORM_NAMES:
        raise ValueError(f"compressed_all_reduce supports transforms "
                         f"{TRANSFORM_NAMES}; got {transform!r}")
    if transform == "onebit":
        if err is None:
            raise ValueError(
                "compressed_all_reduce(transform='onebit') needs `err`, the "
                "error-feedback residual carried between steps (init zeros)")
        return _onebit_allreduce(x, axis_name, err)
    n = axis_size(axis_name)
    if n == 1:
        return x.float()
    flat = x.reshape(-1).float()
    numel = flat.shape[0]
    pad = (-numel) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = transform_reduce_scatter(flat, axis_name, transform, group_size)
    full = transform_all_gather(mine, axis_name, transform, group_size,
                                out_dtype=torch.float32)
    return full.reshape(-1)[:numel].reshape(x.shape)


def _onebit_allreduce(x, axis_name, err):
    """1-bit error-feedback allreduce: compensate, sign + scale, gather,
    decode and sum; the residual (what compression lost this step) feeds
    back next step. Wire: 1 bit an element + one f32 scale a rank."""
    c = x.float() + err.float()
    flat = c.reshape(-1)
    numel = flat.shape[0]
    packed, scale = onebit_encode(flat)
    decoded_self = onebit_decode(packed, scale, numel)
    new_err = (flat - decoded_self).reshape(c.shape)
    if axis_size(axis_name) == 1:
        return decoded_self.reshape(c.shape), new_err
    p_all = all_gather(packed, axis_name)               # [n, P] uint8
    s_all = all_gather(scale, axis_name)                # [n, 1] f32
    vals = onebit_decode(p_all, s_all, numel)           # [n, numel] f32
    return vals.sum(dim=0).reshape(c.shape), new_err


def onebit_error_init(tree):
    """Zero error-feedback residuals matching a grad tree (f32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)
