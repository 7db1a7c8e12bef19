"""NVMe tensor swapping (counterpart of `deepspeed_tpu/runtime/swap_tensor.py`).

Drives the repo's C++ AIO library (`csrc/aio`, built by
`ops/op_builder.load_host`) over ctypes: each named tensor maps to one file
under the swap folder; reads and writes are asynchronous (a thread pool of
pread/pwrite) with `wait()` barriers, so a swap-out overlaps what runs
after it.

Buffers are CPU tensors whose data pointer and padded length are 4 KiB
aligned (`aligned_empty`), so the library can use O_DIRECT end to end. It
falls back to buffered I/O on its own for an unaligned request or a
filesystem without O_DIRECT (tmpfs). `aligned_empty(pin=True)` takes the
buffer from pinned memory, which a CUDA engine asks for so that its
host-to-device copies from the buffer are asynchronous; a CPU engine
(the caller's explicit choice) passes `pin=False`, and CPU-only torch cannot
pin at all.
"""

import pathlib

import torch

from deepspeed_tpu_torch.ops import op_builder

ALIGN = 4096  # O_DIRECT alignment (page / NVMe logical block)


def _padded(nbytes, align=ALIGN):
    return (int(nbytes) + align - 1) // align * align


def aligned_empty(shape, dtype, pin=False, align=ALIGN):
    """A CPU tensor of `shape` / `dtype` whose data pointer is `align`-ed
    and whose allocation extends to the next `align` boundary past its
    bytes (the O_DIRECT read length). Pinned when `pin`."""
    dtype = torch.empty((), dtype=dtype).dtype
    n = 1
    for d in shape:
        n *= int(d)
    nbytes = n * dtype.itemsize
    raw = torch.empty(_padded(nbytes, align) + align, dtype=torch.uint8,
                      pin_memory=bool(pin))
    off = (-raw.data_ptr()) % align
    return raw[off:off + nbytes].view(dtype).view(tuple(int(d)
                                                        for d in shape))


class AsyncTensorSwapper:
    """Swap CPU tensors to and from files asynchronously: O_DIRECT, 1 MiB
    requests, no per-write fsync (swap files are scratch)."""

    def __init__(self, swap_folder, num_threads=4):
        self.lib = op_builder.load_host("dstpu_aio")
        self.handle = self.lib.dstpu_aio_create_ex(num_threads, 1 << 20, 1, 0)
        self.folder = pathlib.Path(swap_folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self._buffers = {}   # name -> tensor kept alive until wait()

    def path_for(self, name):
        return str(self.folder / (name.replace("/", "__") + ".swp"))

    def swap_out(self, name, tensor):
        """Async write of a CPU tensor (made contiguous); it stays alive
        until wait(). The library bounces an unaligned buffer through an
        aligned copy in its worker thread and pads the file to the 4 KiB
        read boundary."""
        t = tensor.detach().contiguous()
        self._buffers[name] = t
        self.lib.dstpu_aio_pwrite(self.handle, self.path_for(name).encode(),
                                  t.data_ptr(), t.numel() * t.element_size(),
                                  0)

    def swap_in(self, name, shape, dtype, out=None):
        """Async read into `out` (an `aligned_empty` buffer) or a fresh
        one; returns it, valid after wait(). The read is issued at the
        padded length, so it takes the O_DIRECT path."""
        t = aligned_empty(shape, dtype) if out is None else out
        self._buffers[name] = t
        self.lib.dstpu_aio_pread(self.handle, self.path_for(name).encode(),
                                 t.data_ptr(),
                                 _padded(t.numel() * t.element_size()), 0)
        return t

    def wait(self):
        errors = self.lib.dstpu_aio_wait(self.handle)
        self._buffers.clear()
        if errors:
            raise IOError(f"{errors} swap I/O requests failed in "
                          f"{self.folder}")

    def release(self):
        if self.handle:
            self.lib.dstpu_aio_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class OptimizerStateSwapper:
    """A dict of named fp32 states kept on NVMe between steps:
    swap_in_all -> step -> swap_out_all."""

    def __init__(self, swap_folder, num_threads=4):
        self.swapper = AsyncTensorSwapper(swap_folder, num_threads=num_threads)
        self.meta = {}  # name -> (shape, dtype)

    def swap_in_all(self):
        out = {name: self.swapper.swap_in(name, shape, dtype)
               for name, (shape, dtype) in self.meta.items()}
        self.swapper.wait()
        return out

    def swap_out_all(self, named):
        for name, t in named.items():
            self.meta[name] = (tuple(t.shape), t.dtype)
            self.swapper.swap_out(name, t)
        self.swapper.wait()
