"""Stable token sort by expert (counterpart of
`deepspeed_tpu/ops/pallas/token_sort.py`) — the dropless MoE's dispatch
primitive.

`token_sort(expert_idx, num_experts) -> (pos [N] int32, counts [E] int32)`:
`pos[i]` is token i's 0-based rank within expert `expert_idx[i]`'s queue
(the number of earlier tokens routed to the same expert), `counts[e]` the
number of tokens routed to expert e. An id outside [0, E), negative
included, counts nowhere and gets pos 0. Ids may be int32 or int64; they
are cast to int32 first, as JAX's `astype` does.

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/token_sort.cu`: one block walks the tokens in 1024-token tiles,
ranking within each warp with `__match_any_sync`) and counts the launch in
`op_builder.LAUNCHES["token_sort"]`; on a CPU tensor it runs the plain
version beside it. Both are int32 throughout, so they agree bit for bit.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder

_MAX_EXPERTS = {}        # CUDA device index -> largest E one block takes


def token_sort_reference(expert_idx, num_experts):
    """Plain version (the counterpart of JAX's `token_sort_oracle`): a
    one-hot [N, E] and its running sum down the tokens."""
    idx = expert_idx.to(torch.int32)
    experts = torch.arange(num_experts, dtype=torch.int32, device=idx.device)
    onehot = (idx[:, None] == experts[None, :]).to(torch.int32)
    csum = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    pos = ((csum - 1) * onehot).sum(dim=1, dtype=torch.int32)
    return pos, onehot.sum(dim=0, dtype=torch.int32)


def _kernel(name, argtypes):
    fn = getattr(op_builder.load("token_sort"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def max_experts(device):
    """The largest expert count the kernel takes on `device` (its shared
    memory holds (32 + 1) x E ints)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _MAX_EXPERTS:
        _MAX_EXPERTS[index] = _kernel("dstt_token_sort_max_experts",
                                      [ctypes.c_int])(index)
    return _MAX_EXPERTS[index]


def token_sort(expert_idx, num_experts):
    """expert_idx [N] int -> (pos [N] int32, counts [E] int32)."""
    if expert_idx.device.type == "cpu":
        return token_sort_reference(expert_idx, num_experts)
    if not expert_idx.is_cuda:
        raise ValueError(f"token_sort: unsupported device {expert_idx.device}")
    if expert_idx.dim() != 1:
        raise ValueError(f"token_sort: expert_idx must be 1-D, got shape "
                         f"{tuple(expert_idx.shape)}")
    if expert_idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"token_sort: expert ids must be int32 or int64, "
                         f"got {expert_idx.dtype}")
    E = int(num_experts)
    limit = max_experts(expert_idx.device)
    if not 1 <= E <= limit:
        raise ValueError(f"token_sort: {E} experts; the kernel's block takes "
                         f"1..{limit} on this device")
    idx = expert_idx.to(torch.int32).contiguous()
    n = idx.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=idx.device)
    counts = torch.empty(E, dtype=torch.int32, device=idx.device)
    rc = _kernel("dstt_token_sort",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p])(
        idx.data_ptr(), pos.data_ptr(), counts.data_ptr(), n, E,
        op_builder.stream_ptr(idx.device))
    op_builder.check(rc, "token_sort")
    op_builder.LAUNCHES["token_sort"] += 1
    return pos, counts
