"""Exact pairwise L1/L2 distances: the wrapper of the CUDA kernel
``csrc/pairwise.cu`` and its plain PyTorch version.

The kernel replaces heat_tpu/ops/pairwise.py::_pairwise_kernel. It takes x
(n, f) and y (m, f) where they lie, with their row strides, and writes the
(n, m) distances into an output that may be a column block of a wider
array (its row stride is the kernel's leading dimension), so a ring step
writes its tile in place. The difference is taken first and the feature
axis is reduced inside the tile: the (n, m, f) broadcast of the plain
expression never exists. The TPU wrapper's pads of rows to the 256-tile
and of features to 128 lanes have no use here; the kernel masks its
ragged edges itself.

It is bound by operations: two FP32 lane instructions per (pair, feature)
against n·m·itemsize bytes written. The kernel loads and stores 16 bytes
at a time where the base and the row stride of an operand allow it
(:func:`aligned16`, decided here and passed to the kernel), else element
by element.

:func:`pairwise_kernel` launches the kernel for CUDA tensors and runs
:func:`pairwise_plain` for CPU tensors; it never falls back from one to the
other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = [
    "LAUNCHES",
    "aligned16",
    "kernel_info",
    "pairwise_distance",
    "pairwise_kernel",
    "pairwise_kernel_supported",
    "pairwise_plain",
]

MAX_FEATURES = 512
"""The feature limit of the public :func:`pairwise_distance`, kept from the
JAX package (heat_tpu/ops/pairwise.py:46). The kernel itself takes any f."""

LAUNCHES = 0
"""Launches of the CUDA kernel in this process; only the launch adds to it."""

PLAIN_ELEMENTS = 1 << 26
"""The plain version works in blocks of rows so that its (rows, m, f)
difference never holds more than this many elements."""


def aligned16(data_ptr: int, row_stride: int, itemsize: int) -> bool:
    """Whether the kernel may read or write an operand 16 bytes at a time:
    its base address and its row stride (in elements) are both multiples
    of 16 bytes, so every row starts 16-byte aligned."""
    return data_ptr % 16 == 0 and (row_stride * itemsize) % 16 == 0


def pairwise_kernel_supported(f: int) -> bool:
    """CUDA present and ``f ≤ 512``: what :func:`pairwise_distance` takes
    (counterpart of ``pallas_supported``)."""
    return torch.cuda.is_available() and f <= MAX_FEATURES


def pairwise_distance(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, p: int = 2, squared: bool = False
) -> torch.Tensor:
    """Exact pairwise Lp distance matrix ``(n, m)`` with the feature axis
    reduced in the tile. ``p`` ∈ {1, 2}; ``squared=True`` skips the final
    sqrt (L2 only). Inputs are promoted to at least float32."""
    if y is None:
        y = x
    if p not in (1, 2):
        raise ValueError(f"p must be 1 or 2, got {p}")
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"x and y must be 2D, got {x.ndim}D and {y.ndim}D")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature counts differ: {x.shape[1]} != {y.shape[1]}")
    f = x.shape[1]
    if f > MAX_FEATURES:
        raise ValueError(
            f"f={f} exceeds the kernel's limit (max {MAX_FEATURES}); "
            "use spatial.cdist for wide features"
        )
    dtype = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    return pairwise_kernel(x.to(dtype), y.to(dtype), p, p == 2 and not squared)


def _check(x: torch.Tensor, y: torch.Tensor, p: int, out: Optional[torch.Tensor]) -> None:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"need x (n, f) and y (m, f), got {tuple(x.shape)}, {tuple(y.shape)}")
    if x.dtype not in (torch.float32, torch.float64) or y.dtype != x.dtype:
        raise TypeError(f"x and y must both be float32 or float64, got {x.dtype}, {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if p not in (1, 2):
        raise ValueError(f"p must be 1 or 2, got {p}")
    if out is not None:
        if tuple(out.shape) != (x.shape[0], y.shape[0]) or out.dtype != x.dtype:
            raise ValueError(
                f"out must be ({x.shape[0]}, {y.shape[0]}) {x.dtype}, got "
                f"{tuple(out.shape)} {out.dtype}"
            )
        if out.device != x.device:
            raise ValueError(f"out on {out.device} but x on {x.device}")


def pairwise_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    p: int = 2,
    post_sqrt: bool = True,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The distances of x (n, f) and y (m, f), both float32 or both float64,
    written into ``out`` (allocated when None) and returned. ``out`` may be a
    strided view, such as a column block of a wider array, whose last
    dimension is contiguous. Any f. A CUDA tensor goes to the kernel, a CPU
    tensor to :func:`pairwise_plain`; another device raises."""
    _check(x, y, p, out)
    if x.device.type == "cpu":
        return pairwise_plain(x, y, p, post_sqrt, out)
    if x.device.type != "cuda":
        raise ValueError(f"no pairwise kernel for device {x.device}")
    return _launch(x, y, p, post_sqrt, out)


def _library():
    lib = _build.library("pairwise")
    if not getattr(lib, "_typed", False):
        lib.pairwise_distance.argtypes = (
            [ctypes.c_void_p] * 3
            + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        lib.pairwise_distance.restype = ctypes.c_int
        lib.pairwise_kernel_info.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.pairwise_kernel_info.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(x, y, p: int, post_sqrt: bool, out: Optional[torch.Tensor]) -> torch.Tensor:
    global LAUNCHES
    n, f = x.shape
    m = y.shape[0]
    if out is None:
        out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    elif m > 1 and out.stride(1) != 1:
        raise ValueError(f"out needs a contiguous last dimension, got strides {out.stride()}")
    if n == 0 or m == 0:
        return out
    x, y = (t if t.stride(1) == 1 else t.contiguous() for t in (x, y))
    ldo = out.stride(0) if n > 1 else m
    item = x.element_size()
    vec = [
        int(aligned16(t.data_ptr(), ld, item))
        for t, ld in ((x, x.stride(0)), (y, y.stride(0)), (out, ldo))
    ]
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.pairwise_distance(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, f,
            x.stride(0), y.stride(0), ldo, p, int(bool(post_sqrt)),
            int(x.dtype == torch.float64), *vec, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"pairwise kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def kernel_info() -> dict:
    """What the build gave the kernel's main variant (float32, L2 with the
    sqrt) on the current card: registers and spilled (local) bytes per
    thread, and CTAs per SM, which is the persistent grid's width per SM.
    Needs CUDA."""
    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _library().pairwise_kernel_info(ctypes.byref(regs), ctypes.byref(local), ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"pairwise kernel info failed: CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value, "ctas_per_sm": ctas.value}


def pairwise_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    p: int = 2,
    post_sqrt: bool = True,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`pairwise_kernel`, the arithmetic
    of the JAX package's broadcast metrics (difference first, then square
    or abs, then the sum over f), in blocks of rows so that it never holds
    more than ``PLAIN_ELEMENTS`` of the (rows, m, f) difference. Any
    device."""
    n, f = x.shape
    m = y.shape[0]
    if out is None:
        out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    rows = max(1, PLAIN_ELEMENTS // max(1, m * f))
    for r0 in range(0, n, rows):
        diff = x[r0 : r0 + rows, None, :] - y[None, :, :]
        diff = diff.abs_() if p == 1 else diff.mul_(diff)
        torch.sum(diff, dim=-1, out=out[r0 : r0 + rows])
    return out.sqrt_() if post_sqrt else out
