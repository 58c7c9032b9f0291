"""Communication over a list of torch devices (reference:
heat/core/communication.py:88-1891, heat_tpu/core/communication.py).

One Python process drives every device, as in the JAX package: a
:class:`MeshCommunication` holds a list of p torch devices, a distributed
array holds one shard per device, and the collectives are in-process torch
operations over the shard list, combined in a fixed shard order so that a
result does not depend on timing. On the GPU the default mesh is every
visible CUDA device; on the CPU it is ``HEAT_TPU_TEST_DEVICES`` copies of the
CPU device (default 8), the same mesh size the JAX package's tests use.

Each verb records itself in :mod:`.telemetry` (its op name, the mesh axis
``"split"``, one participant's payload bytes and dtype) and fires its
``collective.<verb>`` fault site of :mod:`.resilience` before it moves
anything (heat_tpu/core/communication.py:120-242). A schedule that declares
its collectives itself runs its verbs inside :func:`_declared`.
"""

from __future__ import annotations

import math
import os
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import devices as devices_module
from . import resilience, telemetry

__all__ = [
    "Communication",
    "MeshCommunication",
    "get_comm",
    "sanitize_comm",
    "use_comm",
]


#: the mesh axis name the verbs record, as the JAX package's mesh names it
SPLIT_AXIS = "split"

_DECLARED = threading.local()


@contextmanager
def _declared():
    """Run verbs that neither record nor fire their fault sites: the caller
    declares its schedule's collectives and fires its one site itself, with
    the JAX package's op names, bytes and multiplicities
    (heat_tpu/core/linalg/qr.py:215-228, solver.py:322-333)."""
    _DECLARED.depth = getattr(_DECLARED, "depth", 0) + 1
    try:
        yield
    finally:
        _DECLARED.depth -= 1


def _declare(verb: str, dtype, *records) -> None:
    """A declared schedule's fault site ``collective.<verb>``, fired once,
    and its collectives: ``count`` ``verb``s of ``nbytes`` each per
    ``(nbytes, count)`` record. Its verbs then run inside :func:`_declared`."""
    if resilience._ARMED:
        resilience.check("collective." + verb)
    if telemetry._MODE:
        for nbytes, count in records:
            telemetry.record_collective(verb, SPLIT_AXIS, int(nbytes), telemetry._dtype_name(dtype), count=count)


def _note(verb: str, payload) -> None:
    """Record verb ``verb`` of one participant's ``payload`` and fire its
    fault site, unless a declared schedule is running."""
    if getattr(_DECLARED, "depth", 0):
        return
    telemetry.record_collective_operand(verb, SPLIT_AXIS, payload)
    if resilience._ARMED:
        resilience.check("collective." + verb)


class Communication:
    """Base class for communication contexts (reference communication.py:88-101)."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None):
        raise NotImplementedError()


class MeshCommunication(Communication):
    """A communication context over a list of torch devices.

    Parameters
    ----------
    devices : sequence of torch.device
        One entry per shard, all of one device type. A device may repeat
        (p shards on the one CPU).
    """

    #: whether the verbs record themselves and fire their fault sites; the
    #: fusion recorder's programs run the verbs' arithmetic without either
    _records = True

    def __init__(self, devices: Sequence[torch.device]):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {devices}")
        self._devices = tuple(devices)
        self.rank = 0

    @property
    def size(self) -> int:
        """Parallelism degree: the number of shards along the split axis."""
        return len(self._devices)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self._devices

    @property
    def device_type(self) -> str:
        """``"cpu"`` or ``"gpu"``, the :class:`~.devices.Device` kind of the mesh."""
        return "gpu" if self._devices[0].type == "cuda" else "cpu"

    def is_distributed(self) -> bool:
        return self.size > 1

    def sub(self, ranks: Sequence[int]) -> "MeshCommunication":
        """The mesh of the shards ``ranks``, in that order (the group of an
        MPI ``Comm.Split``)."""
        return MeshCommunication([self._devices[r] for r in ranks])

    # ------------------------------------------------------------------
    # block-distribution arithmetic (reference communication.py:161-209)
    # ------------------------------------------------------------------
    def counts_displs_shape(
        self, shape: Sequence[int], split: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-shard counts and displacements along ``split`` under the
        ceil-division block rule of the pad+mask layout."""
        n = int(shape[split])
        p = self.size
        block = -(-n // p) if n else 0
        counts = tuple(max(0, min(block, n - i * block)) for i in range(p))
        displs = tuple(min(i * block, n) for i in range(p))
        return counts, displs

    def chunk(
        self, shape: Sequence[int], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """Offset, logical local shape and slices of shard ``rank``; the full
        array for ``split=None``."""
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        rank = 0 if rank is None else rank
        counts, displs = self.counts_displs_shape(shape, split)
        start, count = displs[rank], counts[rank]
        lshape = list(shape)
        lshape[split] = count
        slices = [slice(0, s) for s in shape]
        slices[split] = slice(start, start + count)
        return start, tuple(lshape), tuple(slices)

    def lshape_map(self, shape: Sequence[int], split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of each shard's logical shape."""
        out = np.empty((self.size, len(shape)), dtype=np.int64)
        for r in range(self.size):
            out[r] = self.chunk(shape, split, rank=r)[1]
        return out

    # ------------------------------------------------------------------
    # collectives over the shard list
    # ------------------------------------------------------------------
    def allreduce(self, shards: Sequence, op: Union[str, Callable] = "sum") -> List:
        """Combine one value per shard in shard order and give every shard
        the result on its own device (reference Allreduce,
        heat_tpu/core/communication.py:120). A value is a tensor or a tuple
        of tensors; ``op`` is one of {'sum', 'prod', 'max', 'min', 'land',
        'lor'} or a callable combining two values (a custom reduce op such
        as :func:`~heat_tpu_torch.core.statistics.mpi_argmax`)."""
        self._check(shards)
        if self._records and (telemetry._MODE or resilience._ARMED):
            _note("allreduce", shards[0])
        return _allreduce(shards, op, self._devices)

    def bcast(self, shards: Sequence, root: int = 0) -> List:
        """Every shard gets shard ``root``'s value, moved to its device
        (reference Bcast, heat_tpu/core/communication.py:192)."""
        self._check(shards)
        if self._records and (telemetry._MODE or resilience._ARMED):
            _note("bcast", shards[root])
        return [_to(shards[root], d) for d in self._devices]

    def exscan(self, shards: Sequence, op: Union[str, Callable] = "sum", neutral=None) -> List:
        """Exclusive prefix combine in shard order (reference Exscan,
        heat_tpu/core/communication.py:209): shard d gets the combination of
        shards 0..d-1, shard 0 the neutral element (given for a callable
        ``op``, else made from the op)."""
        self._check(shards)
        if self._records and (telemetry._MODE or resilience._ARMED):
            _note("exscan", shards[0])
        if neutral is None and callable(op):
            raise ValueError("a callable op requires an explicit neutral element")
        return _exscan(shards, op, self._devices, neutral)

    def scan(self, shards: Sequence, op: Union[str, Callable] = "sum") -> List:
        """Inclusive prefix combine in shard order (reference Scan): shard d
        gets the combination of shards 0..d."""
        self._check(shards)
        if self._records and (telemetry._MODE or resilience._ARMED):
            _note("scan", shards[0])
        return self._prefixes(shards, op)

    def _prefixes(self, shards: Sequence, op) -> List:
        return _prefixes(shards, op, self._devices)

    def allgather(self, shards: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
        """Concatenate one tensor per shard along ``dim`` and give every shard
        the result on its own device (reference Allgather(v))."""
        self._check(shards)
        if self._records and (telemetry._MODE or resilience._ARMED):
            _note("allgather", shards[0])
        first = self._devices[0]
        whole = torch.cat([s.to(first) for s in shards], dim=dim)
        return [whole if whole.device == d else whole.to(d) for d in self._devices]

    def ppermute(
        self,
        shards: Sequence[torch.Tensor],
        shift: int = 1,
        perm: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> List[torch.Tensor]:
        """Ring rotation (heat_tpu/core/communication.py:175-189): shard d
        receives shard ``(d + shift) % p``, moved to device d (the same
        tensor when it already lies there). An explicit ``perm`` of (src,
        dst) pairs overrides ``shift``; a shard that no pair names as its
        destination receives zeros, as in ``lax.ppermute``."""
        self._check(shards)
        if self._records and (telemetry._MODE or resilience._ARMED):
            _note("ppermute", shards[0])
        p = self.size
        if perm is None:
            perm = [((d + shift) % p, d) for d in range(p)]
        received: List[Optional[torch.Tensor]] = [None] * p
        for src, dst in perm:
            if received[dst] is not None:
                raise ValueError(f"perm names destination {dst} twice")
            received[dst] = shards[src].to(self._devices[dst])
        return [
            torch.zeros_like(shards[d]) if r is None else r for d, r in enumerate(received)
        ]

    def alltoall(
        self, shards: Sequence[torch.Tensor], split_axis: int = 0, concat_axis: int = 0
    ) -> List[torch.Tensor]:
        """Tiled all-to-all (heat_tpu/core/communication.py:163-172): each
        shard is cut into p equal pieces along ``split_axis``; piece j of
        shard d goes to shard j, which concatenates what it receives along
        ``concat_axis`` in source order."""
        self._check(shards)
        if self._records and (telemetry._MODE or resilience._ARMED):
            _note("alltoall", shards[0])
        p = self.size
        for s in shards:
            if s.shape[split_axis] % p:
                raise ValueError(
                    f"alltoall splits axis {split_axis} of size {s.shape[split_axis]} "
                    f"into {p} equal pieces"
                )
        pieces = [s.tensor_split(p, dim=split_axis) for s in shards]
        return [
            torch.cat([pieces[d][j].to(dev) for d in range(p)], dim=concat_axis)
            for j, dev in enumerate(self._devices)
        ]

    def _check(self, shards: Sequence[torch.Tensor]) -> None:
        if len(shards) != self.size:
            raise ValueError(f"expected {self.size} shards, got {len(shards)}")

    def __repr__(self) -> str:
        return f"MeshCommunication({self.size} {self._devices[0].type} device(s))"


def _allreduce(shards: Sequence, op, devices: Sequence[torch.device]) -> List:
    """The arithmetic of :meth:`MeshCommunication.allreduce`: the values
    combined in shard order on the first device, then given to every
    device. The fusion recorder's programs call it directly: they record no
    collective."""
    combine = _combine(op)
    first = devices[0]
    total = _to(shards[0], first)
    for s in shards[1:]:
        total = combine(total, _to(s, first))
    return [_to(total, d) for d in devices]


def _prefixes(shards: Sequence, op, devices: Sequence[torch.device]) -> List:
    """s0, s0∘s1, ..., each on the device of its last shard."""
    combine = _combine(op)
    out, acc = [], None
    for d, s in zip(devices, shards):
        s = _to(s, d)
        acc = s if acc is None else combine(_to(acc, d), s)
        out.append(acc)
    return out


def _exscan(shards: Sequence, op, devices: Sequence[torch.device], neutral=None) -> List:
    """The arithmetic of :meth:`MeshCommunication.exscan` (``neutral``
    made from a named ``op`` when not given)."""
    if neutral is None:
        neutral = _tree(lambda t: _neutral(op, t), shards[0])
    prefixes = _prefixes(shards[:-1], op, devices)
    return [_to(neutral, devices[0])] + [_to(v, d) for v, d in zip(prefixes, devices[1:])]


def _tree(fn, value):
    """Apply ``fn`` to a tensor, or to each tensor of a tuple."""
    if isinstance(value, tuple):
        return tuple(fn(v) for v in value)
    return fn(value)


def _to(value, device: torch.device):
    return _tree(lambda t: t if t.device == device else t.to(device), value)


def _neutral(op: str, like: torch.Tensor) -> torch.Tensor:
    """The neutral element of ``op`` in the shape and type of ``like``."""
    if op in ("sum", "lor"):
        return torch.zeros_like(like)
    if op in ("prod", "land"):
        return torch.ones_like(like)
    if op not in ("max", "min"):
        raise ValueError(f"unknown reduce op {op!r}")
    dt = like.dtype
    if dt == torch.bool:
        value = op == "min"
    elif dt.is_floating_point or dt.is_complex:
        value = -math.inf if op == "max" else math.inf
    else:
        info = torch.iinfo(dt)
        value = info.min if op == "max" else info.max
    return torch.full_like(like, value)


def _extreme_of(greater: bool) -> Callable:
    """Elementwise maximum (``greater``) or minimum of two tensors, NaN
    propagating; complex values in numpy's lexicographic order, real part
    first, a NaN in either part propagating."""
    real_op = torch.maximum if greater else torch.minimum
    order = torch.gt if greater else torch.lt

    def extreme(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not (a.is_complex() or b.is_complex()):
            return real_op(a, b)
        a_nan, b_nan = torch.isnan(a), torch.isnan(b)
        b_wins = order(b.real, a.real) | ((b.real == a.real) & order(b.imag, a.imag))
        return torch.where((b_wins | b_nan) & ~a_nan, b, a)

    return extreme


_maximum = _extreme_of(True)
_minimum = _extreme_of(False)

_COMBINE = {
    "sum": torch.add,
    "prod": torch.mul,
    "max": _maximum,
    "min": _minimum,
    "land": torch.logical_and,
    "lor": torch.logical_or,
}


def _combine(op: Union[str, Callable]) -> Callable:
    """The binary combiner of a reduce op: a callable as given, a named op
    applied to a tensor or to each tensor of a tuple (max and min propagate
    NaN)."""
    if callable(op):
        return op
    if op not in _COMBINE:
        raise ValueError(f"unknown reduce op {op!r}")
    fn = _COMBINE[op]
    return lambda a, b: tuple(map(fn, a, b)) if isinstance(a, tuple) else fn(a, b)


def _cpu_mesh_size() -> int:
    return int(os.environ.get("HEAT_TPU_TEST_DEVICES", "8"))


_WORLDS: Dict[str, MeshCommunication] = {}
__default_comm: Optional[MeshCommunication] = None


def _world(device_type: str) -> MeshCommunication:
    """The default mesh of a device kind: every CUDA device, or the CPU
    repeated ``HEAT_TPU_TEST_DEVICES`` times."""
    comm = _WORLDS.get(device_type)
    if comm is None:
        torch_devices = devices_module.sanitize_device(device_type).torch_devices()
        if device_type == "cpu":
            torch_devices = torch_devices * _cpu_mesh_size()
        comm = _WORLDS[device_type] = MeshCommunication(torch_devices)
    return comm


def get_comm() -> MeshCommunication:
    """The current default communication context (reference
    communication.py:1919-1925): the one set by :func:`use_comm`, else the
    default mesh of the default device."""
    if __default_comm is not None:
        return __default_comm
    return _world(devices_module.get_device().device_type)


def _built_comm() -> Optional[MeshCommunication]:
    """The default communication context if it exists already, else None:
    the read of the runtime's report, which must not build a mesh."""
    if __default_comm is not None:
        return __default_comm
    return _WORLDS.get(devices_module.get_device().device_type)


def sanitize_comm(
    comm: Optional[Communication], device: Optional[devices_module.Device] = None
) -> MeshCommunication:
    """Validate a communication context, or pick the default one for
    ``device`` (reference communication.py:1900)."""
    if comm is None:
        if device is None:
            return get_comm()
        if __default_comm is not None and __default_comm.device_type == device.device_type:
            return __default_comm
        return _world(device.device_type)
    if isinstance(comm, MeshCommunication):
        if device is not None and comm.device_type != device.device_type:
            raise ValueError(f"device {device} does not match the mesh {comm}")
        return comm
    raise TypeError(f"Given communication object is not valid: {comm!r}")


def use_comm(comm: Optional[Communication] = None) -> None:
    """Set the default communication context (reference
    communication.py:1927-1937); ``None`` returns to the default mesh of the
    default device."""
    global __default_comm
    prev = _built_comm()
    __default_comm = None if comm is None else sanitize_comm(comm)
    new = _built_comm()
    if prev is not None and new is not None and new.devices != prev.devices:
        _refresh_world_state()


def _refresh_world_state() -> None:
    """Invalidate the mesh-keyed state after the default mesh changed
    (heat_tpu/core/communication.py:530-551): the fusion recorder's program
    cache and the memory gate's resolved budget, a fraction of the old
    mesh's memory."""
    from . import fusion, memledger

    fusion.clear_cache()
    memledger.invalidate_resolved_budget()
