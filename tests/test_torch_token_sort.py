"""The token sort's blocked algorithm (the CUDA kernel's), held to the JAX
package on the CPU.

The kernel behind `token_sort` (`deepspeed_tpu_torch/ops/csrc/token_sort.cu`)
cuts the tokens into tiles, counts each tile's tokens of every expert,
scans those counts across the tiles (a decoupled look-back) and ranks each
token within its tile. `token_sort_blocked_reference` is that algorithm in
plain PyTorch. Here it runs on the same numpy ids as JAX's Pallas
`token_sort` (interpret mode on the CPU, as tests/test_moe.py runs it) and
`token_sort_oracle`, at N one short of a tile, a tile, one past it and
three tiles and one, with 1, 8 and 128 experts, every id equal, and ids out
of range, negative and int64 past 2^32; at a small tile, so that the
Pallas kernel walks few grid steps, and at the kernel's own tiles against
the plain version. int32 throughout: every comparison is bit for bit.

The port compares an int64 id as it is, where JAX's `astype(int32)` wraps
it first (2^32 + 3 would be expert 3 there). Both match no expert with an
id outside [0, E), so JAX is handed each such id as -1.

The wrapper's host side is checked with stand-ins for CUDA tensors: the
dropless path's int64 ids reach the kernel as they are, with no cast, in
one launch.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import token_sort as jts
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import token_sort as tts
from deepspeed_tpu_torch.parallel import moe as tmoe

TILE = 32            # small, so the Pallas kernel in interpret mode is quick
KERNEL_TILES = (1024, 2048, 4096)   # K = 1, 2, 4 sub-tiles of 1024


def _as_jax_sees_it(ids, E):
    """The ids for JAX's int32 kernel under the port's contract: an id
    outside [0, E) as its full value becomes -1, which matches no expert
    there too."""
    return np.where((ids >= 0) & (ids < E), ids, -1).astype(np.int32)


def _assert_sorts_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _check_against_jax(ids, E, tile=TILE):
    jids = jnp.asarray(_as_jax_sees_it(ids, E))
    oracle = jts.token_sort_oracle(jids, E)
    pallas = jts.token_sort(jids, E, interpret=True)
    t = torch.from_numpy(ids)
    blocked = tts.token_sort_blocked_reference(t, E, tile)
    assert blocked[0].dtype == blocked[1].dtype == torch.int32
    for got in (blocked, tts.token_sort_reference(t, E),
                tts.token_sort(t, E)):
        _assert_sorts_equal(got, oracle)
        _assert_sorts_equal(got, pallas)
    valid = (ids >= 0) & (ids < E)
    pos = blocked[0].numpy()
    assert (pos[~valid] == 0).all()
    assert int(blocked[1].sum()) == int(valid.sum())
    pairs = set(zip(ids[valid].tolist(), pos[valid].tolist()))
    assert len(pairs) == int(valid.sum())


@pytest.mark.parametrize("E", [1, 8, 128])
@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 3 * TILE + 1])
def test_blocked_algorithm_equals_pallas_and_oracle(n, E):
    rng = np.random.default_rng(7 * n + E)
    _check_against_jax(rng.integers(0, E, n).astype(np.int32), E)


def _edge_ids(kind, n=3 * TILE + 1):
    rng = np.random.default_rng(11)
    if kind == "all_equal":
        return np.full(n, 5, np.int32)
    if kind == "out_of_range":
        return rng.integers(0, 13, n).astype(np.int32)      # E 8: 8..12
    if kind == "negative":
        return rng.integers(-6, 8, n).astype(np.int32)
    ids = rng.integers(0, 8, n).astype(np.int64)
    ids[::5] += 2 ** 32               # expert 0..7 once wrapped to int32
    ids[1::7] = 2 ** 31 + 1           # negative once wrapped
    ids[2::11] = -(2 ** 32) + 3       # 3 once wrapped
    return ids


@pytest.mark.parametrize("kind", ["all_equal", "out_of_range", "negative",
                                  "int64_past_2_32"])
def test_blocked_algorithm_on_edge_ids(kind):
    """Every id equal (one expert's queue across every tile), ids past E
    and below 0, and int64 ids that an int32 cast would wrap into range:
    those match no expert, get pos 0 and count nowhere."""
    ids = _edge_ids(kind)
    _check_against_jax(ids, 8)
    if kind == "int64_past_2_32":
        pos, counts = tts.token_sort_reference(torch.from_numpy(ids), 8)
        wrapped = ids.astype(np.int32)
        assert int(counts.sum()) < int(((wrapped >= 0) & (wrapped < 8)).sum())


@pytest.mark.parametrize("tile", KERNEL_TILES)
@pytest.mark.parametrize("E, dtype", [(8, np.int64), (128, np.int32),
                                      (1, np.int64)])
def test_blocked_algorithm_at_the_kernels_tiles(tile, E, dtype):
    """At the kernel's own tiles (N = 3 tiles + 1, the look-back over three
    predecessors; ids out of range among them) the blocked algorithm is the
    plain version bit for bit."""
    rng = np.random.default_rng(tile + E)
    ids = rng.integers(-1, E + 1, 3 * tile + 1).astype(dtype)
    t = torch.from_numpy(ids)
    _assert_sorts_equal(tts.token_sort_blocked_reference(t, E, tile),
                        tts.token_sort_reference(t, E))


def test_blocked_algorithm_with_no_tokens():
    pos, counts = tts.token_sort_blocked_reference(
        torch.zeros(0, dtype=torch.int64), 8, TILE)
    assert pos.shape == (0,) and counts.tolist() == [0] * 8


def test_the_dropless_layer_hands_the_sort_argmax_ids_uncast(monkeypatch):
    """`dropless_moe` passes argmax's int64 ids to `token_sort` as they
    are: the cast the kernel once needed is gone from the path."""
    seen = []
    sort = tmoe.token_sort

    def recorded(idx, n_experts):
        seen.append(idx.dtype)
        return sort(idx, n_experts)
    monkeypatch.setattr(tmoe, "token_sort", recorded)
    rng = np.random.default_rng(2)
    flat = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    gate_w = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    out, _, counts = tmoe.dropless_moe(flat, gate_w, lambda xe: xe * 2.0, 4)
    assert seen == [torch.int64]
    assert int(counts.sum()) == 40 and out.shape == (40, 16)


class _Buf:
    """A CUDA-like output: shape, dtype and an address."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def numel(self):
        return int(np.prod(self.shape))

    def data_ptr(self):
        return id(self)


class _Ids:
    """A CUDA-like [N] id tensor: what the wrapper reads before it
    launches. It has no `to`, so a cast would raise; `made` records the
    zeroed buffers it is asked for."""

    made = []

    def __init__(self, n, dtype, ptr=4096):
        self.shape, self.dtype, self.ptr = torch.Size((n,)), dtype, ptr
        self.device, self.is_cuda = torch.device("cuda", 0), True

    def dim(self):
        return 1

    def contiguous(self):
        return self

    def data_ptr(self):
        return self.ptr

    def new_empty(self, shape, dtype):
        return _Buf(shape, dtype)

    def new_zeros(self, shape, dtype):
        buf = _Buf(shape, dtype)
        _Ids.made.append(buf)
        return buf


class _Entry:
    """A library entry point: records its calls, returns `ret`."""

    argtypes = restype = None

    def __init__(self, ret=0):
        self.ret, self.calls = ret, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_the_wrapper_hands_the_ids_to_the_kernel_uncast(dtype, monkeypatch):
    """On a CUDA tensor `token_sort` is one launch of `dstt_token_sort`,
    handed the ids' own pointer and width (int64 as the dropless path
    holds them: no cast launch), N, E and the tile the library names; one
    tile needs no scratch; past one tile the look-back's zeroed scratch of
    2 + tiles x E words, kept for the stream and grown only when a launch
    needs more."""
    sort = _Entry()
    lib = type("Lib", (), {"dstt_token_sort_max_experts": _Entry(1815),
                           "dstt_token_sort_tile": _Entry(4096),
                           "dstt_token_sort": sort})
    monkeypatch.setattr(op_builder, "load", lambda name: lib)
    monkeypatch.setattr(op_builder, "stream_ptr",
                        lambda device: ctypes.c_void_p(None))
    for name in ("_MAX_EXPERTS", "_TILE", "_SCRATCH"):
        monkeypatch.setattr(tts, name, {})
    monkeypatch.setattr(tts, "token_sort_reference", None)
    _Ids.made = []
    op_builder.LAUNCHES.clear()
    ids = _Ids(4096, dtype)
    pos, counts = tts.token_sort(ids, 8)
    assert dict(op_builder.LAUNCHES) == {"token_sort": 1}
    (args,) = sort.calls
    assert args[0] == ids.ptr and bool(args[1]) == (dtype == torch.int64)
    assert args[2:4] == (id(pos), id(counts))
    assert args[4:8] == (4096, 8, 4096, None)
    assert (pos.shape, pos.dtype) == ((4096,), torch.int32)
    assert (counts.shape, counts.dtype) == ((8,), torch.int32)
    assert _Ids.made == []
    tts.token_sort(_Ids(3 * 4096 + 1, dtype), 8)
    (scratch,) = _Ids.made
    assert (scratch.shape, scratch.dtype) == ((2 + 4 * 8,), torch.int64)
    assert sort.calls[1][7] == id(scratch)
    tts.token_sort(_Ids(2 * 4096, dtype), 8)
    assert len(_Ids.made) == 1 and sort.calls[2][7] == id(scratch)
    tts.token_sort(_Ids(9 * 4096, dtype), 8)
    assert len(_Ids.made) == 2 and _Ids.made[1].shape == (2 + 9 * 8,)
    assert op_builder.LAUNCHES["token_sort"] == 4


@pytest.mark.parametrize("bad, match", [
    (lambda: _Ids(10, torch.int16), "int32 or int64"),
    (lambda: _Ids(10, torch.int64), "1815"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, match,
                                                           monkeypatch):
    lib = type("Lib", (), {"dstt_token_sort_max_experts": _Entry(1815),
                           "dstt_token_sort_tile": _Entry(4096),
                           "dstt_token_sort": _Entry()})
    monkeypatch.setattr(op_builder, "load", lambda name: lib)
    monkeypatch.setattr(tts, "_MAX_EXPERTS", {})
    with pytest.raises(ValueError, match=match):
        tts.token_sort(bad(), 1816)
