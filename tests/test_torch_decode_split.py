"""The decode kernel's split algorithm, held to the JAX package.

The CUDA kernel behind `decode_attention`, `paged_decode_attention` and
`paged_decode_attention_quant` cuts each row's live prefix into chunks of
positions (`split_plan`), compute one partial softmax (m, l, acc) a chunk
and merge a row's partials at the end. `paged_partials_reference` and
`combine_partials_reference` are that algorithm in plain PyTorch; here they
run over the same numpy inputs as JAX's Pallas kernels (interpret mode on
the CPU, as tests/test_torch_kernels.py and tests/test_torch_quant.py run
them), with rows at position 0, chunk - 1, chunk and capacity - 1. The
contiguous cache [B, Hkv, M, hd] runs the same algorithm as a pool of B
blocks of M rows whose row b owns block b (an identity table).

Tolerance: fp32 on both sides, the sums in another order (chunks merged
at the end against one online softmax over the pool's blocks): rtol = atol
= 2e-5.

The wrappers' host side is checked with stand-ins for CUDA tensors: the
split plan handed to the kernel follows from the shapes alone, and `pos`
is never read on the host.
"""

import ctypes
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.ops.pallas.decode_attention import (
    decode_attention, paged_decode_attention, paged_decode_attention_quant)
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import op_builder

TOL = dict(rtol=2e-5, atol=2e-5)
B, Hkv, HD, BS, NB = 4, 2, 64, 32, 6          # capacity 192
CHUNKS = [32, 64, 128]


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pos(chunk):
    return np.asarray([0, chunk - 1, chunk, NB * BS - 1], np.int32)


@functools.lru_cache(maxsize=None)
def _inputs(G, group=None):
    """q, the pools (int8 payload and scales where `group` is given, by
    JAX's `quantize_kv`) and shuffled tables, as numpy arrays."""
    rng = np.random.default_rng(100 * G + (group or 0))
    N = B * NB + 1
    q = _normal(rng, B, Hkv * G, HD)
    tables = rng.permutation(np.arange(1, N))[:B * NB].reshape(
        B, NB).astype(np.int32)
    k, v = _normal(rng, N, Hkv, BS, HD), _normal(rng, N, Hkv, BS, HD)
    if group is None:
        return q, tables, (k, v)
    kq, ks = jq.quantize_kv(jnp.asarray(k), group)
    vq, vs = jq.quantize_kv(jnp.asarray(v), group)
    return q, tables, tuple(np.array(a) for a in (kq, vq, ks, vs))


@functools.lru_cache(maxsize=None)
def _pallas(G, chunk, group=None):
    """JAX's Pallas kernel (interpret mode) over `_inputs` at `_pos`."""
    q, tables, pool = _inputs(G, group)
    args = [jnp.asarray(a) for a in pool] + [jnp.asarray(tables),
                                             jnp.asarray(_pos(chunk))]
    if group is None:
        return np.asarray(paged_decode_attention(jnp.asarray(q), *args))
    return np.asarray(paged_decode_attention_quant(jnp.asarray(q), *args))


def _split(G, chunk, group=None):
    """The port's plain split algorithm over the same inputs: partials at
    `chunk`, then the combine."""
    q, tables, pool = _inputs(G, group)
    t = [torch.from_numpy(a) for a in pool]
    scales = None if group is None else (t[2], t[3])
    m, l, acc = tda.paged_partials_reference(
        torch.from_numpy(q), t[0], t[1], torch.from_numpy(tables),
        torch.from_numpy(_pos(chunk)), chunk, scales=scales)
    return m, l, acc, tda.combine_partials_reference(m, l, acc,
                                                     torch.float32)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_matches_pallas_paged_decode(chunk, G):
    *_, out = _split(G, chunk)
    np.testing.assert_allclose(out.numpy(), _pallas(G, chunk), **TOL)


@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_matches_pallas_paged_decode_quant(chunk, G, group):
    *_, out = _split(G, chunk, group)
    np.testing.assert_allclose(out.numpy(), _pallas(G, chunk, group), **TOL)


M_CACHE = 192                                 # the contiguous cache's M


@functools.lru_cache(maxsize=None)
def _cache_inputs(G):
    """q and the contiguous cache k, v [B, Hkv, M, hd] as numpy arrays."""
    rng = np.random.default_rng(500 + G)
    return (_normal(rng, B, Hkv * G, HD), _normal(rng, B, Hkv, M_CACHE, HD),
            _normal(rng, B, Hkv, M_CACHE, HD))


def _cache_pos(chunk):
    return np.asarray([0, chunk - 1, chunk, M_CACHE - 1], np.int32)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_over_the_contiguous_cache_matches_pallas_decode(chunk, G):
    """Row 4's algorithm: the split partials and their combine over the
    contiguous cache, viewed as a pool whose row b owns block b of M rows
    (identity table, bs = M), equal JAX's Pallas `decode_attention` on the
    same inputs (M 192: the last chunk of 128 half live)."""
    q, k, v = _cache_inputs(G)
    pos = _cache_pos(chunk)
    want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(pos)))
    m, l, acc = tda.paged_partials_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.arange(B, dtype=torch.int32)[:, None], torch.from_numpy(pos),
        chunk)
    assert m.shape[2] == -(-M_CACHE // chunk)
    out = tda.combine_partials_reference(m, l, acc, torch.float32)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.from_numpy(pos)).numpy(), want, **TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_partials_are_empty_past_each_rows_prefix(chunk):
    """A chunk that starts past pos (clamped to the capacity) contributes
    nothing: m = -inf, l = 0, acc = 0; every live chunk has a finite m and
    l >= 1 (its largest score gives exp(0))."""
    m, l, acc, _ = _split(4, chunk)
    lens = np.minimum(_pos(chunk), NB * BS - 1) + 1
    n_live = -(-lens // chunk)
    for b, n in enumerate(n_live):
        assert torch.isinf(m[b, :, n:]).all() and (l[b, :, n:] == 0).all()
        assert (acc[b, :, n:] == 0).all()
        assert torch.isfinite(m[b, :, :n]).all() and (l[b, :, :n] >= 1).all()


def test_combine_of_one_chunk_is_the_softmax_of_that_chunk():
    """With one chunk covering the capacity the combine is the plain
    decode attention itself."""
    q, tables, (k, v) = _inputs(1)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(_pos(64)))
    m, l, acc = tda.paged_partials_reference(*args, chunk=NB * BS)
    assert m.shape[2] == 1
    np.testing.assert_allclose(
        tda.combine_partials_reference(m, l, acc, torch.float32).numpy(),
        tda.paged_decode_attention_reference(*args).numpy(), **TOL)


@pytest.mark.parametrize("capacity, rows, want", [
    (1024, 96, (128, 8)), (4096, 64, (512, 8)), (1, 8, (64, 1)),
    (640, 24, (64, 10)), (1024, 2048, (1024, 1)), (4096, 1, (64, 64)),
    (1000, 7, (64, 16))])
def test_split_plan(capacity, rows, want):
    """At most about SPLIT_ITEMS work items a call, in chunks of a power of
    two positions, at least MIN_CHUNK, that cover the capacity."""
    chunk, n = tda.split_plan(capacity, rows)
    assert (chunk, n) == want
    assert chunk >= tda.MIN_CHUNK and chunk & (chunk - 1) == 0
    assert (n - 1) * chunk < capacity <= n * chunk


class _Pos:
    """A CUDA-like pos whose every host read fails: the wrapper may only
    hand its address to the kernel."""

    def __init__(self, n):
        self.shape, self.dtype = torch.Size((n,)), torch.int32
        self.device, self.is_cuda = torch.device("cuda", 0), True

    def to(self, device=None, dtype=None):
        return self

    def contiguous(self):
        return self

    def data_ptr(self):
        return 4096

    def __getattr__(self, name):
        raise AssertionError(f"pos read on the host: .{name}")


class _Buf:
    """A CUDA-like tensor the paged wrappers take to their launch; what the
    wrappers allocate is recorded in `made`."""

    made = []

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device, self.is_cuda = torch.device("cuda", 0), True
        self.requires_grad = False

    def to(self, device=None, dtype=None):
        return self

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def dim(self):
        return len(self.shape)

    def data_ptr(self):
        return 16 * id(self)

    def numel(self):
        return int(np.prod(self.shape))

    def new_empty(self, shape, dtype):
        _Buf.made.append((tuple(shape), dtype))
        return _Buf(shape, dtype)

    def zero_(self):
        return self


class _Entry:
    """Stands in for the library's `dstt_paged_decode`: records each call's
    arguments and returns 0 (no error)."""
    argtypes = restype = None

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hd, bs, nb, G", [(64, 512, 2, 1), (128, 16, 40, 4),
                                           (64, 16, 3, 8)])
def test_the_split_plan_follows_from_the_shapes_alone(hd, bs, nb, G, quant,
                                                      monkeypatch):
    """On CUDA tensors each paged wrapper launches once, handing the kernel
    `split_plan(nb * bs, rows x kv heads)` and the stream's fp32 scratch
    for that many partials a (row, kv head): the same for every pos (which
    the host never reads: `_Pos` fails on any access but its address)."""
    entry = _Entry()
    monkeypatch.setattr(op_builder, "load", lambda name: type(
        "Lib", (), {"dstt_paged_decode": entry}))
    monkeypatch.setattr(op_builder, "stream_ptr",
                        lambda device: ctypes.c_void_p(None))
    monkeypatch.setattr(tda, "_SCRATCH", {})
    outs = []
    monkeypatch.setattr(torch, "empty_like", lambda t: outs.append(
        (tuple(t.shape), t.dtype)) or _Buf(t.shape, t.dtype))
    op_builder.LAUNCHES.clear()
    Bq, Hk = 3, 2
    dt = torch.bfloat16
    q = _Buf((Bq, Hk * G, hd), dt)
    kv_dt = torch.int8 if quant else dt
    k, v = _Buf((9, Hk, bs, hd), kv_dt), _Buf((9, Hk, bs, hd), kv_dt)
    scales = [_Buf((9, Hk, bs, hd // 64), torch.float32) for _ in range(2)]
    tables = _Buf((Bq, nb), torch.int32)
    _Buf.made = []
    for _ in range(2):
        if quant:
            tda.paged_decode_attention_quant(q, k, v, *scales, tables,
                                             _Pos(Bq))
        else:
            tda.paged_decode_attention(q, k, v, tables, _Pos(Bq))
    what = "paged_decode_attention_quant" if quant else \
        "paged_decode_attention"
    assert dict(op_builder.LAUNCHES) == {what: 2}
    chunk, n = tda.split_plan(nb * bs, Bq * Hk)
    for args in entry.calls:
        *_, Bn, H, Hkv, hd_, bs_, nb_, ng, chunk_, n_, scale, code, _ = args
        assert (Bn, H, Hkv, hd_, bs_, nb_) == (Bq, Hk * G, Hk, hd, bs, nb)
        assert (chunk_, n_) == (chunk, n)
        assert ng == (hd // 64 if quant else 0)
        assert code == op_builder.dtype_code(dt)
        assert abs(scale - hd ** -0.5) < 1e-7
    assert entry.calls[0][10:21] == entry.calls[1][10:21]
    # each call: out in q's shape and dtype; the stream's scratch for the
    # partials and its tickets once, kept
    assert outs == [((Bq, Hk * G, hd), dt)] * 2
    assert _Buf.made == [((Bq * Hk * G * n * (hd + 2),), torch.float32),
                         ((tda._MIN_TICKETS,), torch.int32)]
    assert entry.calls[0][8:10] == entry.calls[1][8:10]


@pytest.mark.parametrize("hd, M, G", [(64, 1024, 1), (128, 4096, 4),
                                      (64, 77, 16)])
def test_decode_attention_hands_the_split_kernel_no_table(hd, M, G,
                                                          monkeypatch):
    """On CUDA tensors `decode_attention` launches the split kernel once a
    call with no table (bs = M, nb = 1), `split_plan(M, rows x kv heads)`
    and the stream's scratch: the same for every pos, which the host never
    reads (`_Pos` fails on any access but its address)."""
    entry = _Entry()
    monkeypatch.setattr(op_builder, "load", lambda name: type(
        "Lib", (), {"dstt_paged_decode": entry}))
    monkeypatch.setattr(op_builder, "stream_ptr",
                        lambda device: ctypes.c_void_p(None))
    monkeypatch.setattr(tda, "_SCRATCH", {})
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: _Buf(t.shape, t.dtype))
    op_builder.LAUNCHES.clear()
    Bq, Hk, dt = 4, 3, torch.float16
    q = _Buf((Bq, Hk * G, hd), dt)
    k, v = _Buf((Bq, Hk, M, hd), dt), _Buf((Bq, Hk, M, hd), dt)
    _Buf.made = []
    for _ in range(2):
        tda.decode_attention(q, k, v, _Pos(Bq))
    assert dict(op_builder.LAUNCHES) == {"decode_attention": 2}
    chunk, n = tda.split_plan(M, Bq * Hk)
    for args in entry.calls:
        assert args[7] is None and args[3] is None and args[4] is None
        *_, Bn, H, Hkv, hd_, bs_, nb_, ng, chunk_, n_, scale, code, _ = args
        assert (Bn, H, Hkv, hd_, bs_, nb_, ng) == (Bq, Hk * G, Hk, hd, M, 1,
                                                   0)
        assert (chunk_, n_) == (chunk, n)
        assert code == op_builder.dtype_code(dt)
        assert abs(scale - hd ** -0.5) < 1e-7
    assert _Buf.made == [((Bq * Hk * G * n * (hd + 2),), torch.float32),
                         ((tda._MIN_TICKETS,), torch.int32)]
    with pytest.raises(ValueError, match="for 4 rows"):
        tda.decode_attention(q, _Buf((Bq + 1, Hk, M, hd), dt),
                             _Buf((Bq + 1, Hk, M, hd), dt), _Pos(Bq))


# the check chip_smoke.py holds the paged kernels to on the card, and its
# planted faults, on plain versions
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _serve_case(quant):
    """chip_smoke's serve-path case (8 slots, 512-row blocks, its
    positions) on the CPU in bf16; the int8 pool at g 64 for `quant`."""
    rng = np.random.default_rng(8)
    case = dict(chip_smoke.PAGED_SERVE, g=64) if quant else \
        chip_smoke.PAGED_SERVE
    B, Hq, Hk, hd, bs, nb = (case[n] for n in ("B", "H", "Hkv", "hd", "bs",
                                               "nb"))
    N = B * nb + 1
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb)
    tables[np.asarray(case["pos"]) == 0] = 0
    bf = lambda *s: torch.from_numpy(_normal(rng, *s)).bfloat16()
    kw = dict(q=bf(B, Hq, hd), block_tables=torch.from_numpy(
        tables.astype(np.int32)), pos=torch.tensor(case["pos"],
                                                   dtype=torch.int32))
    k, v = (torch.from_numpy(_normal(rng, N, Hk, bs, hd)) for _ in range(2))
    if quant:
        from deepspeed_tpu_torch.ops import quant as tqo
        (kw["k_pool"], kw["k_scale"]), (kw["v_pool"], kw["v_scale"]) = (
            tqo.quantize_reference(x, 64) for x in (k, v))
        ref = tda.paged_decode_attention_quant_reference(
            kw["q"], {"k": kw["k_pool"], "v": kw["v_pool"],
                      "k_scale": kw["k_scale"], "v_scale": kw["v_scale"]},
            kw["block_tables"], kw["pos"])
    else:
        kw["k_pool"], kw["v_pool"] = k.bfloat16(), v.bfloat16()
        ref = tda.paged_decode_attention_reference(**kw)
    return case, kw, ref


@pytest.mark.parametrize("quant", [False, True])
def test_chip_smoke_paged_check_sees_each_planted_fault(quant):
    """At the serve path's shape, the split algorithm at the wrapper's plan
    passes chip_smoke's paged check (1e-2; the int8 pool also one bf16
    step an element), and each planted fault — the combine skipping a
    row's last live chunk, one chunk's partial stale from the previous
    call — fails it."""
    case, kw, ref = _serve_case(quant)
    name = "paged_decode_attention_quant" if quant else \
        "paged_decode_attention"
    cap = case["bs"] * case["nb"]
    chunk, _ = tda.split_plan(cap, case["B"] * case["Hkv"])
    scales = (kw["k_scale"], kw["v_scale"]) if quant else None
    sound = tda.combine_partials_reference(*tda.paged_partials_reference(
        kw["q"], kw["k_pool"], kw["v_pool"], kw["block_tables"], kw["pos"],
        chunk, scales=scales), torch.bfloat16)
    chip_smoke._paged_check([], name, "cpu", sound, ref)
    for fault in ("dropped_last_chunk", "stale_partial"):
        checks = []
        chip_smoke._paged_check(checks, name, "cpu",
                                chip_smoke._paged_fault(kw, fault), ref,
                                fault=fault)
        assert checks[0]["seen"]


def test_chip_smoke_paged_bounds():
    """The bounds the kernels line states for rows 5 and 6: each row's live
    K/V (and int8 scales) once, q and out once, the tables."""
    serve = chip_smoke.PAGED_SERVE
    live = sum(p + 1 for p in serve["pos"])
    want = 2 * live * 12 * 64 * 2 + 2 * 8 * 12 * 64 * 2 + 8 * 2 * 4
    assert chip_smoke._paged_bound(serve) == chip_smoke.bound(
        want, 4 * live * 12 * 64, chip_smoke.FP32_FLOPS)
    long_q = dict(chip_smoke.PAGED_LONG, g=64)
    nbytes = 2 * 8 * 4096 * 8 * (128 + 8) + 2 * 8 * 32 * 128 * 2 + 8 * 8 * 4
    assert chip_smoke._paged_bound(long_q)[0] == pytest.approx(
        nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_chip_smoke_decode_check_sees_each_planted_fault():
    """Row 4 at generate()'s shape (bf16, chip_smoke.DECODE_GENERATE): the
    split algorithm over the cache as a table-less pool passes chip_smoke's
    check (1e-2), and each planted fault fails it."""
    case = chip_smoke.DECODE_GENERATE
    rng = np.random.default_rng(9)
    bf = lambda *s: torch.from_numpy(_normal(rng, *s)).bfloat16()
    kw = dict(q=bf(case["B"], case["H"], case["hd"]),
              k=bf(case["B"], case["Hkv"], case["M"], case["hd"]),
              v=bf(case["B"], case["Hkv"], case["M"], case["hd"]),
              pos=torch.tensor(case["pos"], dtype=torch.int32))
    ref = tda.decode_attention_reference(**kw)
    paged = chip_smoke._decode_as_paged(kw)
    chunk, n = tda.split_plan(case["M"], case["B"] * case["Hkv"])
    assert (chunk, n) == (64, 16)
    sound = tda.combine_partials_reference(*tda.paged_partials_reference(
        paged["q"], paged["k_pool"], paged["v_pool"], paged["block_tables"],
        paged["pos"], chunk), torch.bfloat16)
    chip_smoke._paged_check([], "decode_attention", "cpu", sound, ref)
    for fault in ("dropped_last_chunk", "stale_partial"):
        checks = []
        chip_smoke._paged_check(checks, "decode_attention", "cpu",
                                chip_smoke._paged_fault(paged, fault), ref,
                                fault=fault)
        assert checks[0]["seen"]


def test_chip_smoke_decode_bounds():
    """Row 4's bound in the kernels line: each row's live K/V (pos clamped
    to M - 1) once, q and out once."""
    live = sum(p + 1 for p in chip_smoke.DECODE_GENERATE["pos"])
    want = 2 * live * 12 * 64 * 2 + 2 * 4 * 12 * 64 * 2
    assert chip_smoke._decode_bound(chip_smoke.DECODE_GENERATE) == \
        chip_smoke.bound(want, 4 * live * 12 * 64, chip_smoke.FP32_FLOPS)
    nbytes = 2 * 8 * 4096 * 8 * 128 * 2 + 2 * 8 * 32 * 128 * 2
    assert chip_smoke._decode_bound(chip_smoke.DECODE_LONG)[0] == \
        pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    clamped = dict(B=1, H=1, Hkv=1, hd=64, M=100, pos=[500],
                   dtype="float32")
    assert chip_smoke._decode_bound(clamped)[0] == pytest.approx(
        (2 * 100 * 64 * 4 + 2 * 64 * 4) / chip_smoke.HBM_BYTES_PER_S * 1e3)
