"""Attention dispatch — one decision layer for every attention call site
(counterpart of `deepspeed_tpu/ops/attention_dispatch.py`).

A call site builds an `AttnSite` (the dispatch key) and `select()` walks the
program registry, highest priority first, to name the program that runs.
The phases this port carries:

  * `train` (also the contiguous prefill): `external` | `flash` |
    `dense`. `external` wins whenever the caller passed its own `attn_fn`
    (e.g. `ops/sparse_attention.sparse_attn_fn`, whose kernels take or
    refuse the site themselves). Operands may require grad: `flash`
    differentiates through the backward kernels (`ops/flash_attention.py`),
    `dense` through autograd on CPU tensors;
  * `decode` (one token over the contiguous cache): `decode_kernel` |
    `decode_dense`;
  * `paged_decode` / `prefill_chunk` (the serving pool): `paged_kernel` |
    `paged_gather`, and over the int8 pool (`kv_dtype="int8"`)
    `paged_kernel_quant` | `paged_gather_quant`.

The predicates are the JAX package's — no alibi, no window, and
`use_flash_attention=False` forbids a kernel — minus its TPU crossovers
(`FLASH_MIN_SEQ`, `DECODE_KERNEL_MIN_CTX`) and 128-multiple shape rules,
which were Mosaic tiling limits. Where the H100's own crossovers lie is not
measured yet.

One route per device. On CUDA operands the kernel program runs, and a site
the kernel does not take (dtype, head width, a forbidding flag) raises
`NotImplementedError`: the port runs no plain attention on the card. The
one exception is `prefill_chunk`, whose gather + dense attend is plain
torch in the JAX package too (over the int8 pool its dequantization is the
`dequantize_int8` kernel). On CPU operands the plain programs run the
kernels' plain versions; `use_flash_attention=True` routes through the
kernel wrappers instead, which on the CPU run those same plain versions.
"""

import dataclasses
from typing import Callable, Dict, Optional

# dtypes and head widths the CUDA kernels take (ops/csrc/*.cu)
FLASH_DTYPES = ("bfloat16", "float16")
DECODE_DTYPES = ("float32", "bfloat16", "float16")
KERNEL_HEAD_DIMS = (64, 128)
QUANT_KV_DTYPES = ("int8",)       # the int8 pool's payload (csrc/decode_attention.cu)


@dataclasses.dataclass(frozen=True)
class AttnSite:
    """One attention call site's dispatch key: shapes, dtype, device and
    the masking flags that disqualify kernels."""
    phase: str                    # "train" | "decode" | "paged_decode" |
                                  # "prefill_chunk"
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
    rather than run plain attention on the card."""
    for prog in registered_programs(site.phase):
        if not prog.matches(site):
            continue
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

# square causal attention, no alibi/window
register_program(AttentionProgram(
    name="flash", phases=("train",), priority=50,
    matches=lambda s: s.square and kernel_wanted(s),
    kernel_dtypes=FLASH_DTYPES))

# CPU operands: the flash kernel's plain version
register_program(AttentionProgram(
    name="dense", phases=("train",), priority=0, matches=_plain))

# no alibi/window
register_program(AttentionProgram(
    name="decode_kernel", phases=("decode",), priority=50,
    matches=kernel_wanted, kernel_dtypes=DECODE_DTYPES))

# CPU operands: the decode kernel's plain version
register_program(AttentionProgram(
    name="decode_dense", phases=("decode",), priority=0, matches=_plain))

def _gather_wanted(site: AttnSite) -> bool:
    return site.phase == "prefill_chunk" or _plain(site)


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
    name="paged_gather_quant", phases=("paged_decode", "prefill_chunk"),
    priority=10,
    matches=lambda s: s.kv_dtype in QUANT_KV_DTYPES and _gather_wanted(s)))

# table gather + dense attend: chunked prefill on every device (plain XLA
# in the JAX package too), single-token decode on CPU operands
register_program(AttentionProgram(
    name="paged_gather", phases=("paged_decode", "prefill_chunk"),
    priority=0,
    matches=lambda s: (s.kv_dtype not in QUANT_KV_DTYPES
                       and _gather_wanted(s))))
