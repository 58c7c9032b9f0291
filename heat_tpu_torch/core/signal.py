"""Signal processing (reference: heat/core/signal.py, heat_tpu/core/signal.py).

The reference convolves a row-split array by exchanging halos between
neighbouring shards (``get_halo``) and convolving ``[prev | local | next]``
on each shard (overlap-save, heat_tpu/core/signal.py:42-57). Here every
mode of a split array takes that schedule: halos of ``k - 1`` rows each
way, one local convolution per shard. In ``'same'`` mode a shard's outputs
are its own block, so nothing else moves; ``'full'`` and ``'valid'``
outputs differ in length from the input, so the shards' pieces are re-cut
into the result's blocks. When the halo is wider than a shard, the whole
array is convolved on the first device.

Every output element is one sum over the taps in tap order (a product
and an add per tap, never fused), so a split array's result equals the
unsplit one bit for bit.
"""

from __future__ import annotations

import torch

from . import factories, types
from .dndarray import DNDarray, _wrap

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


def _shard_pieces(a: DNDarray, taps: torch.Tensor, offset: int):
    """Per shard, the full convolution's outputs from position ``displ +
    offset`` on, as many as ``[prev | shard | next]`` with halos of ``k - 1``
    rows determines; the shard's padding rows count as zeros. Returns None
    when the halo is wider than a shard."""
    k = taps.shape[0]
    a.get_halo(k - 1)
    if a.halos is None:
        return None
    counts = a.counts_displs()[0]
    pieces = []
    for prev, shard, nxt, count in zip(a.halos[0], a.shards, a.halos[1], counts):
        if count < shard.shape[0]:
            shard = torch.cat([shard[:count], shard.new_zeros(shard.shape[0] - count)])
        # ext starts k - 1 rows before the shard, so its i-th valid output is
        # the full convolution's output at displ + i
        ext = torch.cat([prev, shard, nxt]).narrow(0, offset, shard.shape[0] + 2 * (k - 1) - offset)
        pieces.append(_stencil(ext, taps.to(ext.device), ext.shape[0] - k + 1))
    return pieces


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
    taps = v.larray.to(a.comm.devices[0], tdt)
    k, n = taps.shape[0], a.gshape[0]
    start, stop = {"full": (0, n + k - 1), "same": ((k - 1) // 2, (k - 1) // 2 + n), "valid": (k - 1, n)}[mode]
    stop = max(stop, start)
    if a.split == 0 and a.comm.size > 1 and n and k > 1:
        if mode == "same":
            # each shard's own block of outputs: no other data moves
            pieces = _shard_pieces(a, taps, start)
            if pieces is not None:
                block = a.shards[0].shape[0]
                return DNDarray([p[:block] for p in pieces], (n,), promoted, 0, a.device, a.comm)
        else:
            counts = a.counts_displs()[0]
            last = max(r for r, c in enumerate(counts) if c)
            pieces = _shard_pieces(a, taps, 0)
            if pieces is not None:
                first = a.comm.devices[0]
                full = [p[:c].to(first) for p, c in zip(pieces, counts)]
                # the last shard with data also holds the k - 1 outputs past the end
                full.append(pieces[last][counts[last] : counts[last] + k - 1].to(first))
                return _wrap(torch.cat(full)[start:stop], 0, a.device, a.comm)
    result = _full_local(a.larray, taps)[start:stop]
    return _wrap(result, a.split, a.device, a.comm)
