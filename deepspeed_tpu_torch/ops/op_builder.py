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

The host half builds the repo's C++ host libraries (`csrc/aio`, the
thread-pooled pread/pwrite swap library, and `csrc/cpu_optim`, the OpenMP
Adam / Lion / Adagrad step) with g++ and `csrc/Makefile`'s flags, reading
the sources in place, into `build/deepspeed_tpu_torch/host/` under the same
hash naming and temp-then-rename publication as the CUDA libraries (several
test workers may build at once). A missing g++ or a failed build raises:
these libraries have no Python stand-in. `AIO_ARGTYPES` / `CPU_OPTIM_ARGTYPES`
are the C signatures, this package's own copy.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepspeed_tpu_torch"
HOST_CSRC = Path(__file__).resolve().parents[2] / "csrc"
HOST_BUILD_DIR = BUILD_DIR / "host"
# csrc/Makefile's CXXFLAGS (less -Wall) and LDFLAGS
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17"]
GXX_LDFLAGS = ["-shared", "-fopenmp", "-lpthread"]
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


# ----------------------------------------------------------------------
# host libraries: csrc/aio and csrc/cpu_optim, built with g++
# ----------------------------------------------------------------------

_c = ctypes
AIO_ARGTYPES = {
    "dstpu_aio_create": (_c.c_void_p, [_c.c_int, _c.c_int]),
    "dstpu_aio_create_ex": (_c.c_void_p, [_c.c_int, _c.c_int, _c.c_int,
                                          _c.c_int]),
    "dstpu_aio_destroy": (None, [_c.c_void_p]),
    "dstpu_aio_pread": (_c.c_int64, [_c.c_void_p, _c.c_char_p, _c.c_void_p,
                                     _c.c_int64, _c.c_int64]),
    "dstpu_aio_pwrite": (_c.c_int64, [_c.c_void_p, _c.c_char_p, _c.c_void_p,
                                      _c.c_int64, _c.c_int64]),
    "dstpu_aio_wait": (_c.c_int64, [_c.c_void_p]),
    "dstpu_aio_pending": (_c.c_int64, [_c.c_void_p]),
}
CPU_OPTIM_ARGTYPES = {
    "dstpu_cpu_adam_step": (None, [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64,
        _c.c_float, _c.c_float, _c.c_float, _c.c_float, _c.c_float,
        _c.c_int, _c.c_int64, _c.c_int]),
    "dstpu_cpu_lion_step": (None, [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_float,
        _c.c_float, _c.c_float, _c.c_float]),
    "dstpu_cpu_adagrad_step": (None, [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_float,
        _c.c_float, _c.c_float]),
    "dstpu_fp32_to_bf16": (None, [_c.c_void_p, _c.c_void_p, _c.c_int64]),
}
HOST_LIBS = {"dstpu_aio": ("aio/dstpu_aio.cpp", AIO_ARGTYPES),
             "dstpu_cpu_optim": ("cpu_optim/dstpu_cpu_adam.cpp",
                                 CPU_OPTIM_ARGTYPES)}


def _host_lib_path(name):
    src = HOST_CSRC / HOST_LIBS[name][0]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LDFLAGS).encode())
    return src, HOST_BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_host(name):
    """Build `csrc/`'s host library `name` with g++ unless its library is
    current; returns its path. Raises on a missing g++ or a failed build."""
    src, out = _host_lib_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"cannot build host library {name!r}: no g++ "
                           f"found")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(src), *GXX_LDFLAGS, "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building host library {name!r} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_host(name):
    """The ctypes library for `csrc/`'s `name` ("dstpu_aio" or
    "dstpu_cpu_optim"), built if needed, its functions typed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_host(name)))
        for fn, (restype, argtypes) in HOST_LIBS[name][1].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def omp_threads():
    """OpenMP's thread count for the host optimizer step (libgomp, which
    the host library links)."""
    return int(load_host("dstpu_cpu_optim").omp_get_max_threads())
