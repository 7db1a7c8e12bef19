"""CUDA kernel builder (counterpart of `deepspeed_tpu/ops/op_builder.py`).

Each `ops/csrc/<name>.cu` is compiled on first use by `nvcc` into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch
headers: a build takes seconds, not minutes). Libraries land in
`build/deepspeed_tpu_torch/` beside the package (listed in `.gitignore`),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads the existing file. A failed build raises.

Every C entry point returns `cudaGetLastError()` after its launch;
`check(rc, what)` turns a non-zero code into a RuntimeError.

`LAUNCHES` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path really went through the kernels.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepspeed_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = collections.Counter()

_LIBS = {}


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def _lib_path(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name):
    """Start nvcc for `name` unless its library is current; returns
    (Popen | None, output path, temp path)."""
    src, out = _lib_path(name)
    if out.exists():
        return None, out, None
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(f"cannot build kernel {name!r}: no nvcc found "
                           f"(set CUDA_HOME)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish_build(name, proc, out, tmp):
    """Wait for one nvcc; returns an error message, or None on success."""
    if proc is None:
        return None
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"nvcc failed building kernel {name!r} "
                f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return None


def build_all(names=None):
    """Build every kernel source (or `names`), one nvcc each, all started
    together; waits for all of them, then raises on any failure. Returns
    the library paths."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = [(n, *_start_build(n)) for n in names]
    errors = [e for e in (_finish_build(*job) for job in jobs) if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: out for n, _, out, _ in jobs}


def load(name):
    """The ctypes library for `ops/csrc/<name>.cu`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return lib


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_DTYPE_CODES = {}


def dtype_code(dtype):
    if not _DTYPE_CODES:
        import torch
        _DTYPE_CODES.update({torch.float32: 0, torch.bfloat16: 1,
                             torch.float16: 2})
    return _DTYPE_CODES[dtype]


def stream_ptr(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
