"""Signal processing (reference: heat/core/signal.py, heat_tpu/core/signal.py).

The reference convolves a row-split array by exchanging halos between
neighbouring shards (``get_halo``) and convolving ``[prev | local | next]``
on each shard (overlap-save, heat_tpu/core/signal.py:42-57). Here every
mode of a split array takes that schedule: halos of ``k - 1`` rows each
way, one local convolution per shard. In ``'same'`` mode a shard's outputs
are its own block, so nothing else moves; ``'full'`` and ``'valid'``
outputs differ in length from the input, so the shards' pieces are re-cut
into the result's blocks (joined across processes by one ``allgather``
where the ranks span processes). When the halo is wider than a shard, the
whole array is convolved on the first device.

Every output element is one sum over the taps in tap order (a product
and an add per tap, never fused), so a split array's result equals the
unsplit one bit for bit.

A pending signal stays pending (heat_tpu/core/signal.py:31-114): its halo
exchange and the per-shard convolutions record into its chain
(``fusion.defer_apply``), one program with the ops that made it.
"""

from __future__ import annotations

import torch

from . import factories, fusion, types
from .dndarray import DNDarray, _distribute, _wrap

__all__ = ["convolve"]


def _stencil(ext: torch.Tensor, taps: torch.Tensor, length: int) -> torch.Tensor:
    """The first ``length`` outputs of the valid convolution of ``ext`` with
    ``taps``: ``out[i] = sum_j taps[j] ext[i + k - 1 - j]``, j ascending."""
    k = taps.shape[0]
    out = ext.narrow(0, k - 1, length) * taps[0]
    for j in range(1, k):
        out = out + ext.narrow(0, k - 1 - j, length) * taps[j]
    return out


def _full_local(t: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The full convolution of a whole tensor."""
    k = taps.shape[0]
    zeros = t.new_zeros(k - 1)
    return _stencil(torch.cat([zeros, t, zeros]), taps, t.shape[0] + k - 1)


def _convolve_kernel(a, prev, nxt, v, *, comm, mode: str, start: int, stop: int):
    """The split schedule over the shards of ``a`` (a DNDarray, or a shard
    view inside a fused program) and its halos ``prev``/``nxt`` of ``k - 1``
    rows: per shard, the full convolution's outputs from position ``displ
    + offset`` on, the shard's padding rows counted as zeros. ``'same'``
    keeps each shard's own block; ``'full'`` and ``'valid'`` re-cut the
    outputs ``start:stop`` into the result's blocks. ``v`` holds the taps.
    Returns the result's shards."""
    taps = v.shards[0]
    k = taps.shape[0]
    offset = start if mode == "same" else 0
    # this process's ranks' counts (every rank's on a one-process mesh)
    counts = comm.local_counts_displs(a.gshape, 0)[0] if comm.spans_processes else a.counts_displs()[0]
    pieces = []
    for p_, shard, n_, count in zip(prev.shards, a.shards, nxt.shards, counts):
        if count < shard.shape[0]:
            shard = torch.cat([shard[:count], shard.new_zeros(shard.shape[0] - count)])
        # ext starts k - 1 rows before the shard, so its i-th valid output is
        # the full convolution's output at displ + i
        ext = torch.cat([p_, shard, n_]).narrow(0, offset, shard.shape[0] + 2 * (k - 1) - offset)
        pieces.append(_stencil(ext, taps.to(ext.device), ext.shape[0] - k + 1))
    if mode == "same":
        # each shard's own block of outputs: no other data moves
        block = a.shards[0].shape[0]
        return [p[:block] for p in pieces]
    if comm.spans_processes:
        return _distribute(_joined_outputs(a, pieces, counts, k, comm)[start:stop], 0, comm)
    first = comm.devices[0]
    last = [r for r, c in enumerate(counts) if c][-1]
    full = [p[:c].to(first) for p, c in zip(pieces, counts)]
    # the last shard with data also holds the k - 1 outputs past the end
    full.append(pieces[last][counts[last] : counts[last] + k - 1].to(first))
    return _distribute(torch.cat(full)[start:stop], 0, comm)


def _joined_outputs(a, pieces, counts, k: int, comm) -> torch.Tensor:
    """The full convolution's outputs on ``home`` in every process, over a
    mesh whose ranks span processes: each rank's own outputs, the last rank
    with data followed by the k - 1 past the end, joined in rank order by
    one ``allgather``."""
    every = comm.counts_displs_shape(a.gshape, 0)[0]
    last = [r for r, c in enumerate(every) if c][-1]
    sent = []
    for r, p, c in zip(comm.local_ranks, pieces, counts):
        sent.append(p[: c + k - 1] if r == last else p[:c])
    return comm.allgather(sent, dim=0)[0]


def _convolve_whole_kernel(a, v, *, comm, start: int, stop: int):
    """The convolution of the whole signal on the first device, outputs
    ``start:stop``, cut into the signal's split (the schedule of one shard,
    a replicated signal, or a halo wider than a shard)."""
    result = _full_local(a.larray, v.shards[0])[start:stop]
    return [result] if a.split is None else _distribute(result, a.split, comm)


def convolve(a, v, mode: str = "full") -> DNDarray:
    """1-D convolution of ``a`` with ``v`` (reference signal.py:16-148),
    numpy's modes; the longer operand is the signal. Integers compute in
    their promotion with float32, as in the reference; the result is split
    like the signal."""
    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if not isinstance(v, DNDarray):
        v = factories.array(v)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError("Only 1-dimensional input DNDarrays are allowed")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"Supported modes are 'full', 'same', 'valid', got {mode!r}")
    if mode == "same" and v.gshape[0] % 2 == 0:
        raise ValueError("Mode 'same' cannot be used with even-sized kernel")
    if a.gshape[0] < v.gshape[0]:
        a, v = v, a
    promoted = types.promote_types(a.dtype, v.dtype)
    if types.heat_type_is_exact(promoted):
        promoted = types.promote_types(promoted, types.float32)
    if a.dtype is not promoted:
        a = a.astype(promoted)
    tdt = promoted.torch_type()
    taps = v.larray.to(a.comm.home, tdt)
    k, n = taps.shape[0], a.gshape[0]
    start, stop = {"full": (0, n + k - 1), "same": ((k - 1) // 2, (k - 1) // 2 + n), "valid": (k - 1, n)}[mode]
    stop = max(stop, start)
    if a.split == 0 and a.comm.size > 1 and n and k > 1:
        a.get_halo(k - 1)
        halos = a._halo_arrays()
        if halos is not None:
            gshape = (n if mode == "same" else stop - start,)
            kw = dict(mode=mode, start=start, stop=stop)
            node = fusion.defer_apply(a.comm, _convolve_kernel, (a, *halos, ((taps,), (k,), None)), **kw)
            if node is not None:
                return fusion.wrap_node(node, gshape, 0, a)
            shards = _convolve_kernel(a, *halos, factories.array(taps, comm=a.comm), comm=a.comm, **kw)
            return DNDarray(shards, gshape, promoted, 0, a.device, a.comm)
    gshape = (stop - start,)
    node = fusion.defer_apply(a.comm, _convolve_whole_kernel, (a, ((taps,), (k,), None)), start=start, stop=stop)
    if node is not None:
        return fusion.wrap_node(node, gshape, a.split, a)
    return _wrap(_full_local(a.larray, taps)[start:stop], a.split, a.device, a.comm)
