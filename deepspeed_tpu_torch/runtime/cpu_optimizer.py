"""Host-side optimizer step for ZeRO-Offload / ZeRO-Infinity (counterpart
of `deepspeed_tpu/runtime/cpu_optimizer.py`).

The fp32 master weights and the moments live on the host (the moments
optionally on NVMe through `runtime/swap_tensor.py`), the step runs on the
host's cores in the repo's C++ library (`csrc/cpu_optim`, OpenMP SIMD) and
only compute-dtype params go back to the device. The same C++ as the JAX
package's tier, on the same fp32 inputs, gives bit-equal masters.

`step(grads)` takes a tree of gradients on the host or on the card. Card
gradients land leaf by leaf in one pinned fp32 buffer, with one wait a
step. `push(leaves)` writes the updated masters,
rounded to each leaf's dtype, into the device tensors: the rounding goes
into a pinned staging buffer whose host-to-device copy is asynchronous,
and the next push waits for that copy before it refills the buffer.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)

HOST_OPTIMIZERS = ("adam", "lion", "adagrad")

# config optimizer names the C++ step serves -> (kind, adamw_mode), for the
# ordinary engine's host step and the Infinity tier alike. Adam decays
# coupled (L2), as the port's device Adam does for the same names; AdamW,
# Lion and Adagrad decoupled
HOST_OPTIMIZER_NAMES = {
    "adam": ("adam", False), "deepspeedcpuadam": ("adam", False),
    "adamw": ("adam", True), "lion": ("lion", True),
    "deepspeedcpulion": ("lion", True), "adagrad": ("adagrad", True),
    "deepspeedcpuadagrad": ("adagrad", True)}


def host_optimizer_kind(name):
    """(kind, adamw_mode) of the host step for a config optimizer type;
    ValueError for an optimizer the C++ library does not have."""
    key = name.lower()
    if key not in HOST_OPTIMIZER_NAMES:
        raise ValueError(f"the host (C++) optimizer step supports "
                         f"adam/adamw/lion/adagrad (and their DeepSpeedCPU* "
                         f"names), not {key}")
    return HOST_OPTIMIZER_NAMES[key]


def _host_fp32(leaf):
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    return t.detach().to("cpu", torch.float32).contiguous().clone()


class HostOffloadOptimizer:
    """Flat-leaf host Adam / AdamW (and Lion / Adagrad) over a parameter
    tree, with an optional NVMe tier for the moments (`nvme_folder`)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, bias_correction=True,
                 optimizer="adam", nvme_folder=None, lr_schedule=None,
                 aio_threads=4):
        if optimizer not in HOST_OPTIMIZERS:
            raise ValueError(f"host optimizer {optimizer!r} is not one of "
                             f"{HOST_OPTIMIZERS}")
        self.lib = op_builder.load_host("dstpu_cpu_optim")
        self.lr = lr
        self.lr_schedule = lr_schedule
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.optimizer = optimizer
        self.step_count = 0
        self.tree = tree_map(lambda _: 0, params)    # the structure only
        self.master = [_host_fp32(leaf) for leaf in tree_leaves(params)]
        self._grad_landing = None     # pinned fp32 flat for card grads
        self._staging = None          # pinned compute-dtype push buffers
        self._push_event = None

        self.nvme = None
        if nvme_folder is not None:
            from deepspeed_tpu_torch.runtime.swap_tensor import \
                OptimizerStateSwapper
            self.nvme = OptimizerStateSwapper(nvme_folder,
                                              num_threads=aio_threads)
            self.nvme.swap_out_all(self._moment_dict(
                [torch.zeros_like(m) for m in self.master],
                [torch.zeros_like(m) for m in self.master]
                if optimizer == "adam" else None))
            self.exp_avg = self.exp_avg_sq = None
        else:
            self.exp_avg = [torch.zeros_like(m) for m in self.master]
            self.exp_avg_sq = ([torch.zeros_like(m) for m in self.master]
                               if optimizer == "adam" else None)

    @staticmethod
    def _moment_dict(exp_avg, exp_avg_sq):
        out = {}
        for i, m in enumerate(exp_avg):
            out[f"m_{i}"] = m
            if exp_avg_sq is not None:
                out[f"v_{i}"] = exp_avg_sq[i]
        return out

    def _current_lr(self):
        if self.lr_schedule is not None:
            return float(self.lr_schedule(self.step_count))
        return self.lr

    def _land(self, leaves):
        """fp32 host copies of the gradient leaves. Card leaves are copied
        leaf by leaf into slices of one pinned fp32 buffer (no whole-model
        flat on the card), then waited for once."""
        if not any(isinstance(g, torch.Tensor) and g.is_cuda for g in leaves):
            return [g if isinstance(g, torch.Tensor) and
                    g.dtype == torch.float32 and g.is_contiguous()
                    else _host_fp32(g) for g in leaves]
        n = sum(m.numel() for m in self.master)
        if self._grad_landing is None:
            self._grad_landing = torch.empty(n, dtype=torch.float32,
                                             pin_memory=True)
        out, off = [], 0
        for g, m in zip(leaves, self.master):
            dst = self._grad_landing[off:off + m.numel()].view(m.shape)
            dst.copy_(g.detach(), non_blocking=True)
            out.append(dst)
            off += m.numel()
        torch.cuda.current_stream(leaves[0].device).synchronize()
        return out

    def step(self, grads_tree):
        """One optimizer step on `grads_tree` (same structure as the
        params, fp32 or not, host or card). Returns the updated fp32
        masters as a tree of CPU tensors."""
        self.step_count += 1
        lr = self._current_lr()
        grads = self._land(tree_leaves(grads_tree))
        if self.nvme is not None:
            states = self.nvme.swap_in_all()
            exp_avg = [states[f"m_{i}"] for i in range(len(self.master))]
            exp_avg_sq = [states.get(f"v_{i}")
                          for i in range(len(self.master))]
        else:
            exp_avg = self.exp_avg
            exp_avg_sq = self.exp_avg_sq or [None] * len(self.master)
        b1, b2 = self.betas
        for i, (p, g, m) in enumerate(zip(self.master, grads, exp_avg)):
            n = p.numel()
            if self.optimizer == "adam":
                self.lib.dstpu_cpu_adam_step(
                    p.data_ptr(), g.data_ptr(), m.data_ptr(),
                    exp_avg_sq[i].data_ptr(), n, lr, b1, b2, self.eps,
                    self.weight_decay, 1 if self.adamw_mode else 0,
                    self.step_count, 1 if self.bias_correction else 0)
            elif self.optimizer == "lion":
                self.lib.dstpu_cpu_lion_step(
                    p.data_ptr(), g.data_ptr(), m.data_ptr(), n, lr, b1, b2,
                    self.weight_decay)
            else:
                self.lib.dstpu_cpu_adagrad_step(
                    p.data_ptr(), g.data_ptr(), m.data_ptr(), n, lr,
                    self.eps, self.weight_decay)
        if self.nvme is not None:
            self.nvme.swap_out_all(self._moment_dict(
                exp_avg, exp_avg_sq if self.optimizer == "adam" else None))
        return tree_unflatten(self.tree, self.master)

    def push(self, leaves):
        """Write the masters, rounded to each leaf's dtype, into `leaves`
        (tensors in `tree_leaves` order, on the card or the host). On the
        card the copies are asynchronous from pinned staging; the next
        push waits for them before it refills the staging."""
        if not leaves or not leaves[0].is_cuda:
            for dst, m in zip(leaves, self.master):
                dst.copy_(m)
            return
        if self._push_event is not None:
            self._push_event.synchronize()
        if self._staging is None:
            self._staging = [torch.empty(m.shape, dtype=dst.dtype,
                                         pin_memory=True)
                             for dst, m in zip(leaves, self.master)]
        for dst, st, m in zip(leaves, self._staging, self.master):
            st.copy_(m)
            dst.copy_(st, non_blocking=True)
        self._push_event = torch.cuda.Event()
        self._push_event.record(torch.cuda.current_stream(leaves[0].device))

    def state_dict(self):
        sd = {"step": self.step_count, "master": self.master}
        if self.nvme is None:
            sd["exp_avg"] = self.exp_avg
            if self.exp_avg_sq is not None:
                sd["exp_avg_sq"] = self.exp_avg_sq
        else:
            states = self.nvme.swap_in_all()
            n = len(self.master)
            sd["exp_avg"] = [states[f"m_{i}"].clone() for i in range(n)]
            if self.optimizer == "adam":
                sd["exp_avg_sq"] = [states[f"v_{i}"].clone()
                                    for i in range(n)]
        return sd

    def load_state_dict(self, sd):
        self.step_count = int(sd["step"])
        self.master = [_host_fp32(m) for m in sd["master"]]
        if "exp_avg" not in sd:
            return
        exp_avg = [_host_fp32(m) for m in sd["exp_avg"]]
        exp_avg_sq = [_host_fp32(m) for m in sd["exp_avg_sq"]] \
            if "exp_avg_sq" in sd else None
        if self.nvme is None:
            self.exp_avg = exp_avg
            if exp_avg_sq is not None:
                self.exp_avg_sq = exp_avg_sq
        else:
            self.nvme.swap_out_all(self._moment_dict(exp_avg, exp_avg_sq))
