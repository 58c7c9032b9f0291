"""Fused Lloyd iteration for k-means: the wrapper of the CUDA kernel
``csrc/lloyd.cu``, its plain PyTorch version, and the iteration loops.

The kernel replaces heat_tpu/ops/lloyd.py::_lloyd_kernel. One launch reads
the (n, f) samples once and returns everything an iteration needs: the
per-cluster sums (k, f), the counts (k,) and the inertia without the
loop-invariant Σ|x|². The iteration is bound by HBM bytes, n·f·itemsize per
iteration, so the kernel reads the data once per iteration and nothing per
row is written; the labels come from one plain epilogue per run
(:func:`_assign_labels`), against the last iteration's input centers. The
samples stay row-major: the TPU kernel's samples-in-lanes transpose was for
the TPU's 128-lane vector memory and has no use on the GPU.

:func:`lloyd_accumulate` launches the kernel for a CUDA tensor and runs
:func:`lloyd_accumulate_plain` for a CPU tensor; it never falls back from
one to the other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "LAUNCHES",
    "fused_lloyd_iter",
    "fused_lloyd_iter_sharded",
    "fused_lloyd_run",
    "fused_lloyd_run_sharded",
    "fused_supported",
    "lloyd_accumulate",
    "lloyd_accumulate_plain",
    "prepare_run_operands",
]

MAX_FEATURES = 512
MAX_CLUSTERS = 128

LAUNCHES = 0
"""Launches of the CUDA kernel in this process; only the launch adds to it."""

_PLANS = {}

ROW_BLOCK = 1 << 20
"""Rows per block of the plain passes around the kernel (Σ|x|², labels),
so they never hold a temporary the size of the data."""


def fused_supported(f: int, k: int) -> bool:
    """The shapes the kernel takes: f ≤ 512 features, k ≤ 128 clusters."""
    return 1 <= f <= MAX_FEATURES and 1 <= k <= MAX_CLUSTERS


def _check(data: torch.Tensor, centers: torch.Tensor, n_valid: int) -> None:
    if data.ndim != 2 or centers.ndim != 2 or centers.shape[1] != data.shape[1]:
        raise ValueError(f"need data (n, f) and centers (k, f), got {tuple(data.shape)}, {tuple(centers.shape)}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"data must be float32 or bfloat16, got {data.dtype}")
    if centers.dtype != torch.float32:
        raise TypeError(f"centers must be float32, got {centers.dtype}")
    if data.device != centers.device:
        raise ValueError(f"data on {data.device} but centers on {centers.device}")
    if not (data.is_contiguous() and centers.is_contiguous()):
        raise ValueError("data and centers must be contiguous")
    if not fused_supported(data.shape[1], centers.shape[0]):
        raise ValueError(
            f"shape f={data.shape[1]}, k={centers.shape[0]} outside the kernel's "
            f"f <= {MAX_FEATURES}, k <= {MAX_CLUSTERS}"
        )
    if not 0 <= n_valid <= data.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {data.shape[0]}]")


def _unpack(packed: torch.Tensor, k: int, f: int):
    """(sums (k, f), counts (k,), inertia ()) views of a packed accumulator."""
    kf = k * f
    return packed[:kf].view(k, f), packed[kf : kf + k], packed[kf + k]


def lloyd_accumulate(
    data: torch.Tensor, centers: torch.Tensor, n_valid: int, return_labels: bool = False
):
    """One Lloyd accumulation pass over the first ``n_valid`` rows of ``data``.

    Parameters
    ----------
    data : (n, f) contiguous float32 or bfloat16 tensor. Rows at index
        ≥ ``n_valid`` are never read.
    centers : (k, f) contiguous float32 tensor, unquantized.
    n_valid : number of leading rows to use.
    return_labels : also return the int32 label of each used row.

    Returns ``(sums (k, f), counts (k,), inertia ())``, all float32, where
    the inertia omits Σ|x|²; then the labels if asked. A CUDA tensor goes to
    the kernel, a CPU tensor to :func:`lloyd_accumulate_plain`.
    """
    packed, labels = _accumulate(data, centers, n_valid, return_labels)
    out = _unpack(packed, centers.shape[0], data.shape[1])
    return (*out, labels) if return_labels else out


def _accumulate(data, centers, n_valid: int, return_labels: bool = False):
    """The packed accumulator [sums, counts, inertia] of :func:`lloyd_accumulate`."""
    _check(data, centers, n_valid)
    if data.device.type == "cpu":
        return _accumulate_plain(data, centers, n_valid)
    if data.device.type != "cuda":
        raise ValueError(f"no Lloyd kernel for device {data.device}")
    return _launch(data, centers, n_valid, return_labels)


def _library():
    lib = _build.library("lloyd")
    if not getattr(lib, "_typed", False):
        lib.lloyd_plan.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.lloyd_plan.restype = ctypes.c_int
        lib.lloyd_accumulate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.lloyd_accumulate.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(data, centers, n_valid: int, return_labels: bool):
    global LAUNCHES
    lib = _library()
    n, f = data.shape
    k = centers.shape[0]
    bf16 = int(data.dtype == torch.bfloat16)
    with torch.cuda.device(data.device):
        key = (data.device.index, n_valid, f, k, bf16)
        plan = _PLANS.get(key)
        if plan is None:
            grid, stride = ctypes.c_int(), ctypes.c_int()
            err = lib.lloyd_plan(n_valid, f, k, bf16, ctypes.byref(grid), ctypes.byref(stride))
            if err:
                raise RuntimeError(f"Lloyd kernel plan failed: CUDA error {err}")
            plan = _PLANS[key] = (grid.value, stride.value)
        grid, stride = plan
        partials = torch.empty(grid * stride, dtype=torch.float32, device=data.device)
        packed = torch.empty(stride, dtype=torch.float32, device=data.device)
        labels = (
            torch.empty(n_valid, dtype=torch.int32, device=data.device) if return_labels else None
        )
        err = lib.lloyd_accumulate(
            data.data_ptr(), centers.data_ptr(), n_valid, f, k, bf16, grid,
            partials.data_ptr(), packed.data_ptr(),
            labels.data_ptr() if labels is not None else None,
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"Lloyd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return packed, labels


def _scores(x32: torch.Tensor, centers: torch.Tensor, bf16: bool) -> torch.Tensor:
    """(n, k) assignment scores |c|² − 2c·x (|x|² omitted: constant per row).
    |c|² comes from the unquantized f32 centers; for bfloat16 data the dot's
    centers are rounded to bfloat16, as the kernel does."""
    c32 = centers.float()
    csq = torch.sum(c32 * c32, dim=1)
    cdot = c32.bfloat16().float() if bf16 else c32
    return csq[None, :] - 2.0 * (x32 @ cdot.T)


def lloyd_accumulate_plain(
    data: torch.Tensor, centers: torch.Tensor, n_valid: int, return_labels: bool = False
):
    """The plain PyTorch version of :func:`lloyd_accumulate`: the same math
    as a product, an argmin, a one-hot and masked sums. Any device."""
    _check(data, centers, n_valid)
    packed, labels = _accumulate_plain(data, centers, n_valid)
    out = _unpack(packed, centers.shape[0], data.shape[1])
    return (*out, labels) if return_labels else out


def _accumulate_plain(data, centers, n_valid: int):
    k = centers.shape[0]
    x = data[:n_valid].float()  # the padding is never read
    score = _scores(x, centers, data.dtype == torch.bfloat16)
    labels = torch.argmin(score, dim=1)
    onehot = F.one_hot(labels, k).float()
    packed = torch.cat(
        [
            (onehot.T @ x).reshape(-1),
            onehot.sum(dim=0),
            torch.amin(score, dim=1).sum().reshape(1) if n_valid else x.new_zeros(1),
        ]
    )
    return packed, labels.to(torch.int32)


def _assign_labels(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Labels against ``centers``, scored as the kernel scores: the label
    epilogue, one plain pass per run, by blocks of rows."""
    bf16 = data.dtype == torch.bfloat16
    blocks = data.split(ROW_BLOCK) or (data,)
    return torch.cat([torch.argmin(_scores(b.float(), centers, bf16), dim=1) for b in blocks])


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Σ|x|² in float32, by blocks of rows."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in x.split(ROW_BLOCK):
        b32 = block.float()
        total += torch.sum(b32 * b32)
    return total


def _finalize(sums, counts, inertia, centers, xsq_sum):
    """Centroid update (empty clusters keep their center), the inertia with
    Σ|x|² restored, and the convergence shift (heat_tpu/ops/lloyd.py:291-304)."""
    c32 = centers.float()
    new_centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), c32
    ).to(centers.dtype)
    inertia_full = torch.clamp(inertia + xsq_sum, min=0.0)
    shift = torch.sum((new_centers - centers).float() ** 2)
    return new_centers, inertia_full, shift


def prepare_run_operands(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, Σ|x|²) for the iteration loops: the contiguous operand the kernel
    streams (bfloat16 stays bfloat16, every other dtype becomes float32) and
    the loop-invariant sum of squares in float32. Callers running many
    chunks over one operand compute these once."""
    x = stream_operand(data)
    return x, _sum_squares(x)


def stream_operand(data: torch.Tensor) -> torch.Tensor:
    """The contiguous operand the kernel streams: bfloat16 stays bfloat16,
    every other dtype becomes float32. No copy when ``data`` already is one."""
    return (data if data.dtype == torch.bfloat16 else data.float()).contiguous()


def fused_lloyd_iter(data: torch.Tensor, centers: torch.Tensor, k: int, xsq_sum=None):
    """One fused Lloyd iteration: ``(new_centers, labels, inertia, shift)``,
    the contract of heat_tpu.cluster.kmeans._lloyd_iter (labels against the
    input centers, inertia with Σ|x|²)."""
    return fused_lloyd_run(data, centers, k, 1, xsq_sum=xsq_sum)


def fused_lloyd_run(
    data: torch.Tensor,
    centers: torch.Tensor,
    k: int,
    n_steps: int,
    xsq_sum: Optional[torch.Tensor] = None,
):
    """``n_steps`` fused iterations, one kernel pass each, then the labels
    against the last iteration's input centers. Pass ``xsq_sum`` (from
    :func:`prepare_run_operands`) to reuse it across calls."""
    if xsq_sum is None:
        x, xsq_sum = prepare_run_operands(data)
    else:
        x = stream_operand(data)
    c, used, inertia, shift = run_steps([x], centers, k, None, x.shape[0], n_steps, xsq_sum)
    return c, _assign_labels(x, used), inertia, shift


def _local_valid(n_global: int, rows: int, p: int, first_rank: int = 0) -> List[int]:
    """Rows inside the logical extent ``n_global`` of each of the ``p``
    shards of global ranks ``first_rank`` on."""
    return [min(max(n_global - (first_rank + i) * rows, 0), rows) for i in range(p)]


def logical_xsq_sum(shards: Sequence[torch.Tensor], n_global: int, comm=None, first_rank: int = 0) -> torch.Tensor:
    """Σ|x|² over the logical rows of row-sharded data, shards in order; the
    padding's content is unspecified and never summed. ``shards`` are the
    global ranks ``first_rank`` on; with a ``comm`` whose ranks span
    processes, the per-shard sums of every process are folded in rank order
    by ``comm.allreduce``, as one process folds its own."""
    valid = _local_valid(n_global, shards[0].shape[0], len(shards), first_rank)
    parts = [_sum_squares(s[:v]) for s, v in zip(shards, valid)]
    if getattr(comm, "spans_processes", False):
        return comm.allreduce(parts)[0]
    first = shards[0].device
    total = None
    for part in parts:
        part = part.to(first)
        total = part if total is None else total + part
    return total


def fused_lloyd_run_sharded(
    shards: Sequence[torch.Tensor],
    centers: torch.Tensor,
    k: int,
    comm,
    n_global: int,
    n_steps: int,
    xsq_sum: Optional[torch.Tensor] = None,
):
    """``n_steps`` fused iterations over row-sharded data (the physical
    shards of a split=0 DNDarray, each ``ceil(n/p)`` rows, the padding a
    suffix of the global rows), then the labels. Returns ``(centers, labels
    (n_global,), inertia, shift)`` on the first shard's device.

    Over a ``comm`` whose ranks span processes (``ProcessMeshCommunication``),
    ``shards`` are this process's, global ranks ``comm.first_rank`` on, the
    accumulators are summed across processes, and the labels are those of
    this process's logical rows."""
    first_rank = comm.first_rank if comm is not None else 0
    xs = [stream_operand(s) for s in shards]
    if xsq_sum is None:
        xsq_sum = logical_xsq_sum(xs, n_global, comm, first_rank)
    c, used, inertia, shift = run_steps(xs, centers, k, comm, n_global, n_steps, xsq_sum, first_rank)
    return c, sharded_labels(xs, used, n_global, first_rank), inertia, shift


def fused_lloyd_iter_sharded(
    shards: Sequence[torch.Tensor],
    centers: torch.Tensor,
    k: int,
    comm,
    n_global: int,
    xsq_sum: Optional[torch.Tensor] = None,
):
    """One fused Lloyd iteration over row-sharded data: ``(new_centers,
    labels (n_global,), inertia, shift)``, the return contract of
    heat_tpu.ops.lloyd.fused_lloyd_iter_sharded (labels against the input
    centers). :func:`fused_lloyd_run_sharded` with one step."""
    return fused_lloyd_run_sharded(shards, centers, k, comm, n_global, 1, xsq_sum=xsq_sum)


def run_steps(xs, centers, k: int, comm, n_global: int, n_steps: int, xsq_sum, first_rank: int = 0):
    """The iteration loop of the fused runs, without the label epilogue:
    ``(centers, used, inertia, shift)``, where ``used`` are the last
    iteration's input centers, which the labels are taken against.

    ``xs`` are row shards as the kernel streams them (:func:`stream_operand`),
    global ranks ``first_rank`` on; each shard's pass masks its own share of
    the padding, ``clip(n_global − i·rows, 0, rows)`` for global rank i, and
    with more than one shard, or a ``comm`` whose ranks span processes, the
    packed accumulators are summed over the ranks with one
    ``comm.allreduce`` per iteration."""
    if centers.shape[0] != k:
        raise ValueError(f"centers hold {centers.shape[0]} clusters, not k={k}")
    valid = _local_valid(n_global, xs[0].shape[0], len(xs), first_rank)
    f = xs[0].shape[1]
    c = used = centers
    inertia = shift = None
    for _ in range(n_steps):
        c32 = c.float().contiguous()
        parts = [_accumulate(x, c32.to(x.device), v)[0] for x, v in zip(xs, valid)]
        several = len(parts) > 1 or getattr(comm, "spans_processes", False)
        packed = comm.allreduce(parts)[0] if several else parts[0]
        new, inertia, shift = _finalize(*_unpack(packed, k, f), c, xsq_sum)
        used, c = c, new
    return c, used, inertia, shift


def sharded_labels(xs, centers: torch.Tensor, n_global: int, first_rank: int = 0) -> torch.Tensor:
    """Labels of the logical rows of row shards (global ranks ``first_rank``
    on) against ``centers``, on the first shard's device."""
    valid = _local_valid(n_global, xs[0].shape[0], len(xs), first_rank)
    first = xs[0].device
    return torch.cat(
        [_assign_labels(x[:v], centers.to(x.device)).to(first) for x, v in zip(xs, valid)]
    )
