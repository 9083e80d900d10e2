"""The port's Adam: `Adam`, a `torch.optim.Adam` whose step runs one launch
of the hand-written kernel `csrc/adam.cu` over every leaf with a gradient
(CUDA tensors), or the plain twin `adam_plain` (CPU tensors);
`runs_kernels` chooses, and any other device raises.

The state is torch's: `optimizer.state[p]` holds "exp_avg", "exp_avg_sq"
and the CPU float "step", created at a leaf's first step as torch creates
them, and `param_groups` keep their keys (a group's "lr" is read at every
step). So `state_dict` and `load_state_dict` are torch's, and a state saved
from `torch.optim.Adam` loads and goes on step for step. A leaf whose
`.grad` is None is skipped, its moments and step untouched. Weight decay,
amsgrad, maximize and a closure are not taken.

Each leaf's bias corrections come from its own step count, in double on
the host as torch forms them; nothing is copied to the device and nothing
is read back from it. The kernel takes up to `MAX_LEAVES` leaves a launch
(one launch for the six leaves of a `GaussianModel`); `build.launch_counts()`
counts the launches under "adam". The kernel replaces no TPU kernel: the
JAX package's Adam is optax's, under XLA.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch

from . import runs_kernels
from .build import KERNELS, check

MAX_LEAVES = 8          # leaves a launch (csrc/adam.cu's kMaxLeaves)


class Leaf(NamedTuple):
    """One leaf's update: its parameter, gradient and moments, its step
    size lr / (1 - beta1^t) and sqrt(1 - beta2^t) from its step count t,
    and its group's betas and eps."""

    p: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    step_size: float
    bc2_sqrt: float
    beta1: float
    beta2: float
    eps: float


class _Leaf(ctypes.Structure):
    """csrc/adam.cu's `AdamLeaf`."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("step_size", ctypes.c_float),
                ("bc2_sqrt", ctypes.c_float), ("weight", ctypes.c_float),
                ("beta2", ctypes.c_float),
                ("one_minus_beta2", ctypes.c_float), ("eps", ctypes.c_float)]


def adam_plain(leaves: List[Leaf]) -> None:
    """The kernel's update in PyTorch, one leaf at a time, in place: the
    operations of torch's single-tensor Adam, in its order."""
    for x in leaves:
        x.m.lerp_(x.g, 1 - x.beta1)
        x.v.mul_(x.beta2).addcmul_(x.g, x.g, value=1 - x.beta2)
        denom = (x.v.sqrt() / x.bc2_sqrt).add_(x.eps)
        x.p.addcdiv_(x.m, denom, value=-x.step_size)


def adam_cuda(leaves: List[Leaf]) -> None:
    """The update of `leaves` (CUDA float32, contiguous, on one device)
    through csrc/adam.cu: one launch per `MAX_LEAVES` leaves."""
    dev = leaves[0].p.device
    table = []
    for x in leaves:
        for t, name in ((x.p, "p"), (x.g, "grad"), (x.m, "exp_avg"),
                        (x.v, "exp_avg_sq")):
            check(t, name, torch.float32, dev, t.dim())
            if t.shape != x.p.shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {tuple(x.p.shape)}")
        if x.p.numel():
            table.append(_Leaf(
                x.p.data_ptr(), x.g.data_ptr(), x.m.data_ptr(),
                x.v.data_ptr(), x.p.numel(), x.step_size, x.bc2_sqrt,
                1 - x.beta1, x.beta2, 1 - x.beta2, x.eps))
    for i in range(0, len(table), MAX_LEAVES):
        chunk = table[i:i + MAX_LEAVES]
        arr = (_Leaf * len(chunk))(*chunk)
        KERNELS["adam"](dev, ctypes.addressof(arr), len(chunk))


class Adam(torch.optim.Adam):
    """`torch.optim.Adam` (its defaults, groups and state) whose `step`
    updates every leaf with a gradient in one pass: see the module
    docstring."""

    @torch.no_grad()
    def step(self) -> None:
        leaves = []
        for group in self.param_groups:
            if group["weight_decay"] or group["amsgrad"] or group["maximize"]:
                raise ValueError("the port's Adam takes no weight decay, "
                                 "amsgrad or maximize")
            beta1, beta2 = group["betas"]
            lr = float(group["lr"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                st["step"] += 1
                t = st["step"].item()
                leaves.append(Leaf(p, p.grad, st["exp_avg"],
                                   st["exp_avg_sq"], lr / (1 - beta1 ** t),
                                   (1 - beta2 ** t) ** 0.5, beta1, beta2,
                                   group["eps"]))
        if leaves:
            dev = leaves[0].p.device
            (adam_cuda if runs_kernels(dev, "Adam") else adam_plain)(leaves)
