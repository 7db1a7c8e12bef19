"""Attention dispatch — one decision layer for every attention call site
(counterpart of `deepspeed_tpu/ops/attention_dispatch.py`).

A call site builds an `AttnSite` (the dispatch key) and `select()` walks the
program registry, highest priority first, to name the program that runs.
The phases this port carries:

  * `train` (also the contiguous prefill): `external` | `ring_ulysses` |
    `ring` | `chunked` | `flash` | `dense`. `ring` (priority 100) and
    `ring_ulysses` (110) are context parallelism over the `sequence` mesh
    axis (`parallel/ring.py`), taken on request
    (`GPTConfig.attention_backend`) when that axis is live (`mesh_axes`,
    `active_mesh_axes()`); each ring step is the flash kernel on CUDA. A
    request with no `sequence` axis falls through to the auto choice, as
    in JAX; an unknown backend raises ValueError, and so does a ring
    request on a live `sequence` axis at a site outside the ring's
    contract. A live `sequence` axis with no ring request and no `attn_fn`
    raises NotImplementedError: the JAX package lets GSPMD shard any
    attention over it, the port has no GSPMD. `external` wins whenever the
    caller passed its own
    `attn_fn` (e.g. `ops/sparse_attention.sparse_attn_fn`, whose kernels
    take or refuse the site themselves). `chunked` is the query-chunked
    escape hatch (`ops/chunked_attention.py`), taken where
    `GPTConfig.chunked_attn_min_seq` is set and T reaches it, on every
    device, above flash as in JAX. Operands may require grad:
    `flash` differentiates through the backward kernels
    (`ops/flash_attention.py`), `chunked` and `dense` through autograd;
  * `decode` (one token over the contiguous cache): `decode_kernel` |
    `decode_dense`;
  * `paged_decode` / `prefill_chunk` / `verify` (the serving pool; verify
    is the spec-decode chunk of k + 1 tokens a row): `paged_kernel` |
    `paged_gather`, and over the int8 pool (`kv_dtype="int8"`)
    `paged_kernel_quant` | `paged_gather_quant`. The paged kernels take
    `paged_decode` only;
  * `encoder` (bidirectional self-attention: `models/bert.py`, whose JAX
    counterpart computes it as dense einsums outside the dispatch):
    `flash` with `causal=False` when no mask was passed, `block_sparse` (an
    all-ones layout with the additive key-padding row, `ops/
    block_sparse_attention.key_padded_attention`) when one was, `dense` on
    CPU operands. The choice reads only whether a mask was passed, never
    its values (that would wait for the card every call). The masked
    program's plan (`dense_plan`) refuses a T that is not a multiple of 16,
    on every device.

The predicates are the JAX package's — no alibi, no window, and
`use_flash_attention=False` forbids a kernel — minus its TPU crossovers
(`FLASH_MIN_SEQ`, `DECODE_KERNEL_MIN_CTX`) and 128-multiple shape rules,
which were Mosaic tiling limits. Where the H100's own crossovers lie is not
measured yet.

One route per device. On CUDA operands the kernel program runs, and a site
the kernel does not take (dtype, head width, a forbidding flag) raises
`NotImplementedError`: the port runs no plain attention on the card. The
exceptions are plain torch in the JAX package too: `prefill_chunk` and
`verify`, whose gather + dense attend its registry runs on every device
(over the int8 pool the dequantization is the `dequantize_int8` kernel),
and the opt-in `chunked` training program, which JAX runs as plain XLA.
On CPU operands the plain programs run the kernels' plain versions;
`use_flash_attention=True` routes through the kernel wrappers instead,
which on the CPU run those same plain versions.
"""

import dataclasses
from typing import Callable, Dict, Optional, Tuple

# dtypes and head widths the CUDA kernels take (ops/csrc/*.cu)
FLASH_DTYPES = ("bfloat16", "float16")
DECODE_DTYPES = ("float32", "bfloat16", "float16")
KERNEL_HEAD_DIMS = (64, 128)
QUANT_KV_DTYPES = ("int8",)       # the int8 pool's payload (csrc/decode_attention.cu)
RING_PROGRAMS = ("ring", "ring_ulysses")


def active_mesh_axes() -> Tuple[str, ...]:
    """Mesh axes with size > 1 on the installed mesh (() when none) — the
    `mesh_axes` component of the dispatch key."""
    from deepspeed_tpu_torch.comm import mesh as mesh_mod
    if not mesh_mod.has_mesh():
        return ()
    sizes = mesh_mod.get_spec().axis_sizes()
    return tuple(name for name, n in sizes.items() if n > 1)


@dataclasses.dataclass(frozen=True)
class AttnSite:
    """One attention call site's dispatch key: shapes, dtype, device and
    the masking flags that disqualify kernels."""
    phase: str                    # "train" | "decode" | "paged_decode" |
                                  # "prefill_chunk" | "verify" | "encoder"
    q_len: int                    # query length (T; chunk C; 1 for decode)
    kv_len: int                   # key/context length (T, M, or nb*block)
    head_dim: int = 64
    has_bias: bool = False        # additive bias (alibi) present
    has_window: bool = False      # sliding-window mask
    kv_dtype: str = "bfloat16"    # K/V dtype: the operands', or "int8"
                                  # for the quantized pool
    on_cuda: bool = False         # operands live on a CUDA device
    force_flash: Optional[bool] = None  # GPTConfig.use_flash_attention
    external_fn: bool = False     # caller supplied its own attn_fn, which
                                  # the "external" program runs
    chunk_min: Optional[int] = None  # GPTConfig.chunked_attn_min_seq: the
                                  # "chunked" program takes T >= it
    key_padding: bool = False     # encoder: a key-padding mask was passed
    backend: Optional[str] = None  # GPTConfig.attention_backend request
    mesh_axes: Tuple[str, ...] = ()  # active (size > 1) mesh axes

    @property
    def square(self) -> bool:
        return self.q_len == self.kv_len


def kernel_wanted(site: AttnSite) -> bool:
    """THE kernel predicate shared by the three kernel programs: forbidden
    by alibi, a window or use_flash_attention=False; otherwise engaged on
    CUDA operands, and on the CPU only when forced by
    use_flash_attention=True."""
    if site.has_bias or site.has_window or site.force_flash is False:
        return False
    return site.on_cuda or site.force_flash is True


def kernel_refusal(site: AttnSite, dtypes) -> Optional[str]:
    """Why the CUDA kernel cannot take this site, or None when it can."""
    if site.force_flash is False:
        return "a site with use_flash_attention=False"
    if site.kv_dtype not in dtypes:
        return f"dtype {site.kv_dtype} (the kernel takes {dtypes})"
    if site.head_dim not in KERNEL_HEAD_DIMS:
        return (f"head_dim {site.head_dim} (the kernel takes "
                f"{KERNEL_HEAD_DIMS})")
    return None


@dataclasses.dataclass(frozen=True)
class AttentionProgram:
    """One registered attention implementation; `matches` decides
    eligibility from the AttnSite alone."""
    name: str
    phases: tuple
    priority: int                 # higher wins among eligible programs
    matches: Callable[[AttnSite], bool]
    kernel_dtypes: tuple = ()     # a CUDA kernel's dtypes; () = plain torch


_REGISTRY: Dict[str, AttentionProgram] = {}


def register_program(program: AttentionProgram) -> AttentionProgram:
    _REGISTRY[program.name] = program
    return program


def registered_programs(phase: str):
    """The phase's programs, highest priority first (name-tiebroken) — the
    order `select` walks."""
    progs = [p for p in _REGISTRY.values() if phase in p.phases]
    return sorted(progs, key=lambda p: (-p.priority, p.name))


def select(site: AttnSite) -> str:
    """Name the program this site runs. On CUDA operands a kernel program
    whose contract fails, or no program at all, raises NotImplementedError
    rather than run plain attention on the card. An unknown `backend`, or
    a ring request on a live `sequence` axis at a site the ring programs
    do not take, raises ValueError (JAX's checks); a live `sequence` axis
    that resolves to a program of one rank's tokens raises
    NotImplementedError."""
    if site.phase == "train" and site.backend is not None \
            and site.backend not in _REGISTRY:
        raise ValueError(
            f"unknown attention_backend {site.backend!r}: no program of "
            f"that name is registered (registered: {sorted(_REGISTRY)})")
    for prog in registered_programs(site.phase):
        if not prog.matches(site):
            continue
        if site.phase == "train" and "sequence" in site.mesh_axes and \
                prog.name not in RING_PROGRAMS + ("external",):
            if site.backend in RING_PROGRAMS:
                raise ValueError(
                    f"attention_backend={site.backend!r} was requested on "
                    f"a `sequence` mesh but this site is ineligible for "
                    f"the ring programs (alibi/sliding-window bias or "
                    f"non-square attention — the plain-causal kernel "
                    f"contract) — resolved program would be "
                    f"{prog.name!r}. Drop the backend request or the "
                    f"arch flag")
            raise NotImplementedError(
                f"attention on a `sequence` mesh resolves to {prog.name!r}, "
                f"which sees one rank's tokens: set attention_backend "
                f"'ring' or 'ring_ulysses', or pass a sequence-parallel "
                f"attn_fn (parallel.DistributedAttention). Sharding any "
                f"attention over the axis as GSPMD does is not ported to "
                f"deepspeed_tpu_torch yet (ROADMAP queue 1 item 8)")
        why = kernel_refusal(site, prog.kernel_dtypes) \
            if site.on_cuda and prog.kernel_dtypes else None
        if why:
            raise NotImplementedError(
                f"attention {site.phase!r} on CUDA: the {prog.name} kernel "
                f"does not take {why}, and the port runs no plain attention "
                f"on the card")
        return prog.name
    if site.on_cuda:
        raise NotImplementedError(
            f"attention {site.phase!r} on CUDA: no kernel program takes "
            f"{site} (alibi, a window or use_flash_attention=False forbid "
            f"the kernels), and the port runs no plain attention on the card")
    raise LookupError(f"no attention program registered for phase "
                      f"{site.phase!r} (registry: {sorted(_REGISTRY)})")


def _plain(site: AttnSite) -> bool:
    return not site.on_cuda


# the caller's attn_fn (the JAX package's "external" pseudo-program)
register_program(AttentionProgram(
    name="external", phases=("train",), priority=1000,
    matches=lambda s: s.external_fn))

def _train_ring(site: AttnSite) -> bool:
    return (site.backend in RING_PROGRAMS and "sequence" in site.mesh_axes
            and not site.has_bias and not site.has_window and site.square)


# attention_backend="ring_ulysses" / "ring" on a live `sequence` axis:
# context parallelism (parallel/ring.py), the flash kernels every ring
# step on CUDA (their plain versions on the CPU)
register_program(AttentionProgram(
    name="ring_ulysses", phases=("train",), priority=110,
    matches=lambda s: _train_ring(s) and s.backend == "ring_ulysses",
    kernel_dtypes=FLASH_DTYPES))

register_program(AttentionProgram(
    name="ring", phases=("train",), priority=100,
    matches=lambda s: _train_ring(s) and s.backend == "ring",
    kernel_dtypes=FLASH_DTYPES))

# chunked_attn_min_seq set and T >= it, square, no alibi/window, not
# forbidden by use_flash_attention=False: the query-chunked escape hatch,
# plain torch on every device
register_program(AttentionProgram(
    name="chunked", phases=("train",), priority=60,
    matches=lambda s: (s.chunk_min is not None and s.q_len >= s.chunk_min
                       and s.square and not s.has_bias and not s.has_window
                       and s.force_flash is not False)))

# square attention, no alibi/window, no key-padding mask: causal in
# `train`, full in `encoder`
register_program(AttentionProgram(
    name="flash", phases=("train", "encoder"), priority=50,
    matches=lambda s: s.square and not s.key_padding and kernel_wanted(s),
    kernel_dtypes=FLASH_DTYPES))


# encoder with a key-padding mask: the block-sparse kernels on an all-ones
# layout, the mask as their additive padding row
register_program(AttentionProgram(
    name="block_sparse", phases=("encoder",), priority=50,
    matches=lambda s: s.square and s.key_padding and kernel_wanted(s),
    kernel_dtypes=FLASH_DTYPES))

# CPU operands: the kernels' plain versions (train), the JAX package's
# dense encoder arithmetic (encoder)
register_program(AttentionProgram(
    name="dense", phases=("train", "encoder"), priority=0, matches=_plain))

# no alibi/window
register_program(AttentionProgram(
    name="decode_kernel", phases=("decode",), priority=50,
    matches=kernel_wanted, kernel_dtypes=DECODE_DTYPES))

# CPU operands: the decode kernel's plain version
register_program(AttentionProgram(
    name="decode_dense", phases=("decode",), priority=0, matches=_plain))

def _gather_wanted(site: AttnSite) -> bool:
    return site.phase in ("prefill_chunk", "verify") or _plain(site)


# int8 pool, C == 1, no alibi/window: tiles dequantize in-kernel
register_program(AttentionProgram(
    name="paged_kernel_quant", phases=("paged_decode",), priority=60,
    matches=lambda s: (s.kv_dtype in QUANT_KV_DTYPES and s.q_len == 1
                       and kernel_wanted(s)),
    kernel_dtypes=QUANT_KV_DTYPES))

# C == 1, no alibi/window
register_program(AttentionProgram(
    name="paged_kernel", phases=("paged_decode",), priority=50,
    matches=lambda s: (s.kv_dtype not in QUANT_KV_DTYPES and s.q_len == 1
                       and kernel_wanted(s)),
    kernel_dtypes=DECODE_DTYPES))

# int8 pool: the dequantizing gather + dense attend, where `paged_gather`
# would run
register_program(AttentionProgram(
    name="paged_gather_quant",
    phases=("paged_decode", "prefill_chunk", "verify"), priority=10,
    matches=lambda s: s.kv_dtype in QUANT_KV_DTYPES and _gather_wanted(s)))

# table gather + dense attend: chunked prefill and the spec-decode verify
# on every device (plain XLA in the JAX package too), single-token decode
# on CPU operands
register_program(AttentionProgram(
    name="paged_gather", phases=("paged_decode", "prefill_chunk", "verify"),
    priority=0,
    matches=lambda s: (s.kv_dtype not in QUANT_KV_DTYPES
                       and _gather_wanted(s))))
