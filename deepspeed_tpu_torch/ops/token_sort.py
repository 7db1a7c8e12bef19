"""Stable token sort by expert (counterpart of
`deepspeed_tpu/ops/pallas/token_sort.py`) — the dropless MoE's dispatch
primitive.

`token_sort(expert_idx, num_experts) -> (pos [N] int32, counts [E] int32)`:
`pos[i]` is token i's 0-based rank within expert `expert_idx[i]`'s queue
(the number of earlier tokens routed to the same expert), `counts[e]` the
number of tokens routed to expert e. Ids may be int32 or int64 and are
compared as they are: an id outside [0, E), negative or past int32
included, counts nowhere and gets pos 0. (JAX's `astype(int32)` wraps
an int64 id first, so 2^32 + 3 would be expert 3 there; its callers, as
the port's, route only ids in range.)

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/token_sort.cu`: one launch, a grid of blocks of K x 1024-token
tiles, warp ranks from ballots over the ids' bits, a scan a tile and a
decoupled look-back across tiles), handing it the ids in their own
width, and counts the launch in `op_builder.LAUNCHES["token_sort"]`; on
a CPU tensor it runs the plain version beside it. Both are int32
throughout, so they agree bit for bit. `token_sort_blocked_reference` is
the kernel's blocked algorithm in plain PyTorch, for the tests.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder

_MAX_EXPERTS = {}        # CUDA device index -> largest E the kernel takes
_TILE = {}               # (device index, E) -> tokens a block's tile
_SCRATCH = {}            # (device, stream) -> int64 look-back scratch


def token_sort_reference(expert_idx, num_experts):
    """Plain version (the counterpart of JAX's `token_sort_oracle`): a
    one-hot [N, E] and its running sum down the tokens. Ids are compared
    in their own width."""
    experts = torch.arange(num_experts, dtype=expert_idx.dtype,
                           device=expert_idx.device)
    onehot = (expert_idx[:, None] == experts[None, :]).to(torch.int32)
    csum = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    pos = ((csum - 1) * onehot).sum(dim=1, dtype=torch.int32)
    return pos, onehot.sum(dim=0, dtype=torch.int32)


def token_sort_blocked_reference(expert_idx, num_experts, tile):
    """The kernel's algorithm in plain PyTorch: the tokens cut into tiles
    of `tile`; each tile's count of every expert; an exclusive scan of
    those counts across the tiles (what the look-back computes); then each
    token's rank within its tile, plus its tile's base. Equal to
    `token_sort_reference` bit for bit (tests only)."""
    n = expert_idx.shape[0]
    E = num_experts
    tiles = max(1, -(-n // tile))
    experts = torch.arange(E, dtype=expert_idx.dtype,
                           device=expert_idx.device)
    onehot = torch.zeros((tiles * tile, E), dtype=torch.int32,
                         device=expert_idx.device)
    onehot[:n] = (expert_idx[:, None] == experts[None, :]).to(torch.int32)
    onehot = onehot.reshape(tiles, tile, E)
    per_tile = onehot.sum(dim=1, dtype=torch.int32)               # [tiles, E]
    base = torch.cumsum(per_tile, dim=0, dtype=torch.int32) - per_tile
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1     # in tile
    pos = ((rank + base[:, None, :]) * onehot).sum(dim=2, dtype=torch.int32)
    return pos.reshape(-1)[:n], per_tile.sum(dim=0, dtype=torch.int32)


_ARGTYPES = {
    "dstt_token_sort_max_experts": [ctypes.c_int],
    "dstt_token_sort_tile": [ctypes.c_int] * 2,
    "dstt_token_sort": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2,
}


def _kernel(name):
    fn = getattr(op_builder.load("token_sort"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _index(device):
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def max_experts(device):
    """The largest expert count the kernel takes on `device` (its shared
    memory holds 32 x (E | 1) ints a sub-tile)."""
    index = _index(device)
    if index not in _MAX_EXPERTS:
        _MAX_EXPERTS[index] = _kernel("dstt_token_sort_max_experts")(index)
    return _MAX_EXPERTS[index]


def tile_tokens(device, num_experts):
    """Tokens a block of the kernel takes at `num_experts` on `device`: a
    launch over N tokens is ceil(N / tile) blocks (one at the dropless
    path's 4096 tokens over 8 experts)."""
    key = (_index(device), int(num_experts))
    if key not in _TILE:
        _TILE[key] = _kernel("dstt_token_sort_tile")(key[1], key[0])
    return _TILE[key]


def _scratch(idx, stream, words):
    """The look-back scratch on idx's card for `stream`: at least `words`
    int64 words, zero at rest (each launch leaves it zero), made zero when
    first asked for or when it must grow."""
    key = (idx.device, stream.value)
    have = _SCRATCH.get(key)
    if have is None or have.numel() < words:
        have = _SCRATCH[key] = idx.new_zeros((words,), dtype=torch.int64)
    return have


def token_sort(expert_idx, num_experts):
    """expert_idx [N] int32 / int64 -> (pos [N] int32, counts [E] int32)."""
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
    device = expert_idx.device
    limit = max_experts(device)
    if not 1 <= E <= limit:
        raise ValueError(f"token_sort: {E} experts; the kernel takes "
                         f"1..{limit} on this device")
    n = expert_idx.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"token_sort: {n} tokens; int32 ranks take fewer "
                         f"than 2^31")
    idx = expert_idx.contiguous()   # a strided view packed; else no copy
    pos = idx.new_empty((n,), dtype=torch.int32)
    counts = idx.new_empty((E,), dtype=torch.int32)
    tile = tile_tokens(device, E)
    stream = op_builder.stream_ptr(device)
    tiles = -(-n // tile)
    scratch = _scratch(idx, stream, 2 + tiles * E).data_ptr() \
        if tiles > 1 else None
    rc = _kernel("dstt_token_sort")(
        idx.data_ptr(), idx.dtype == torch.int64, pos.data_ptr(),
        counts.data_ptr(), n, E, tile, scratch, stream)
    op_builder.check(rc, "token_sort")
    op_builder.LAUNCHES["token_sort"] += 1
    return pos, counts
