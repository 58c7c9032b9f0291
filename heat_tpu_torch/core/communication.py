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

import hashlib
import math
import os
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import devices as devices_module
from . import resilience, telemetry

__all__ = [
    "Communication",
    "CrossProcessMeshError",
    "ForeignSubMesh",
    "MeshCommunication",
    "ProcessMeshCommunication",
    "get_comm",
    "initialize",
    "reform",
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
            # heat-lint: disable=H005 — the site is collective.<verb>, fired above for this schedule's verb
            telemetry.record_collective(verb, SPLIT_AXIS, int(nbytes), telemetry._dtype_name(dtype), count=count)


def _note(verb: str, payload) -> None:
    """Record verb ``verb`` of one participant's ``payload`` and fire its
    fault site, unless a declared schedule is running."""
    if getattr(_DECLARED, "depth", 0):
        return
    # heat-lint: disable=H005 — the site is collective.<verb>, fired below for this verb
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

    #: whether the ranks of this mesh live in more than one process
    spans_processes = False
    #: the global rank of this process's first shard
    first_rank = 0

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the shards this process holds: every device here.
        A DNDarray holds one shard per local device, shard i being global
        rank ``first_rank + i``."""
        return self._devices

    @property
    def local_ranks(self) -> range:
        """The global ranks of the shards this process holds."""
        return range(self.first_rank, self.first_rank + len(self._devices))

    @property
    def home(self) -> torch.device:
        """Where a replicated or whole tensor is built: this process's
        first device (every process builds the same global value there)."""
        return self._devices[0]

    #: the process index the per-process seam of :mod:`.multihost` reads
    #: for this mesh; None: the live world's (every rank is this process's)
    process: Optional[int] = None

    def local_counts_displs(
        self, shape: Sequence[int], split: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """:meth:`counts_displs_shape` of this process's ranks only."""
        counts, displs = self.counts_displs_shape(shape, split)
        ranks = self.local_ranks
        return counts[ranks.start : ranks.stop], displs[ranks.start : ranks.stop]

    @property
    def placements(self) -> Tuple:
        """One entry per rank, what the per-process seam of
        :mod:`.multihost` reads: here the torch devices, which carry no
        ``process_index`` and so are all this process's."""
        return self._devices

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


class CrossProcessMeshError(NotImplementedError):
    """A global device list, or a re-formation of the mesh inside one
    process (``reform``, the elastic supervisor, the autoscaler), was asked
    for over a mesh whose ranks live in several processes. Every other
    layer runs there; these are ROADMAP A11.5b(c2b)."""


def _spanning(what: str) -> CrossProcessMeshError:
    return CrossProcessMeshError(
        f"{what} over a mesh whose ranks span processes is not ported yet (ROADMAP A11.5b(c2b)): "
        "the verbs, sub-meshes, the array and every layer above it run across processes; a global device "
        "list, reform, elastic and autoscale do not"
    )


class RankPlacement(NamedTuple):
    """Where one rank of a process-spanning mesh lives: its global ``rank``,
    the ``process_index`` that holds it and, in that process, its torch
    ``device`` (None in the others)."""

    rank: int
    process_index: int
    device: Optional[torch.device]


#: the axis a cross-process verb records when its CUDA shards went through
#: the host: gloo is a host transport
HOST_STAGED_AXIS = "split:host"

#: the types a verb's header can name, each by its index
_HEADER_DTYPES = (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.complex64, torch.complex128,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
)
_HEADER_CODES = {dt: i for i, dt in enumerate(_HEADER_DTYPES)}
#: a header entry: the rank, whether the value is a tuple and its leaf
#: count, then per leaf its type code, its rank and its dimensions
_MAX_LEAVES, _MAX_NDIM = 8, 8
_ENTRY = 3 + _MAX_LEAVES * (2 + _MAX_NDIM)
#: the bytes of the signature's digest before a reduction's payload
_DIGEST = 16


def _leaves(value) -> tuple:
    return value if isinstance(value, tuple) else (value,)


def _signature(value) -> tuple:
    """What the verbs with equal shapes compare: tupleness, each leaf's
    shape and type."""
    return isinstance(value, tuple), tuple((tuple(t.shape), t.dtype) for t in _leaves(value))


def _flat_bytes(value, transport: torch.device) -> List[torch.Tensor]:
    return [t.detach().contiguous().reshape(-1).view(torch.uint8).to(transport) for t in _leaves(value)]


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _unflatten(raw: torch.Tensor, at: int, signature) -> Tuple[object, int]:
    """The value of ``signature`` whose bytes start at ``at`` of ``raw``,
    and the offset past them."""
    is_tuple, leaves = signature
    got = []
    for shape, dtype in leaves:
        nbytes = _nbytes(shape, dtype)
        got.append(raw[at : at + nbytes].clone().view(dtype).reshape(shape))
        at += nbytes
    return (tuple(got) if is_tuple else got[0]), at


class ForeignSubMesh:
    """The sub-mesh of ranks that all live in other processes: this process
    holds none of its shards, so every verb raises ``ValueError``."""

    spans_processes = False
    local_devices: Tuple[torch.device, ...] = ()

    def __init__(self, ranks: Sequence[int]):
        self.ranks = tuple(ranks)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def local_ranks(self) -> range:
        return range(0)

    def _refuse(self, *args, **kwargs):
        raise ValueError(f"this process holds none of ranks {list(self.ranks)}: the processes that hold them run "
                         "this sub-mesh's verbs")

    allreduce = bcast = exscan = scan = allgather = ppermute = alltoall = sub = _refuse

    def __repr__(self) -> str:
        return f"ForeignSubMesh(ranks {list(self.ranks)})"


class ProcessMeshCommunication(MeshCommunication):
    """A mesh whose ranks live in several processes of a ``torch.distributed``
    world (heat_tpu/core/communication.py:574-637, where XLA's global arrays
    span processes).

    The global ranks are each process's local mesh concatenated in process
    order; ``counts[q]`` is process q's number of ranks. ``chunk``,
    ``counts_displs_shape`` and ``lshape_map`` stay global. A process holds
    the shards of its own ranks only, ``first_rank`` to ``first_rank +
    len(local_devices)``, and each verb takes those shards, in rank order,
    and returns this process's results.

    A reduction or a scan gathers every rank's value over ``group`` in one
    ``all_gather`` and runs the one-process arithmetic on them in rank
    order, folding with ``_allreduce``/``_prefixes``/``_exscan`` on this
    process's own device type, so a world of N processes gives, bit for bit,
    what the one-process mesh of the same p gives. Its values have one
    shape by contract, so no header travels: a 16-byte digest of each
    process's shapes and types leads its bytes, and a process whose digest
    differs raises ``ValueError`` everywhere. ``allgather`` and ``alltoall``
    first gather a fixed-layout ``int64`` header of every process's shapes
    and types over the gloo ``control`` group; ``bcast`` broadcasts the
    root's header and then its bytes. ``ppermute`` moves each block from the
    process of its source rank to the process of its destination rank, by
    one point-to-point pair, or in place when both live in one process. On a
    gloo ``group`` CUDA shards go through the host, and the verb records the
    axis :data:`HOST_STAGED_AXIS`.

    A DNDarray over this mesh holds the shards of this process's ranks
    (``local_ranks``), each on its ``local_devices`` entry; a replicated or
    whole tensor is built on ``home``, the same value in every process (the
    multi-controller rule). ``devices`` is the global device list, which a
    process cannot hold once the ranks span processes: it raises
    :class:`CrossProcessMeshError` then (ROADMAP A11.5b(c2b)). The layers
    above the verbs use ``local_devices`` and ``home``; the verbs move
    bytes, which autograd cannot see through, so a layer differentiates
    across processes through the verbs' autograd functions (:func:`permute`,
    :func:`take_blocks` and the others below this class). In a world of
    one process ``devices`` is the local list, and the mesh is the
    in-process mesh whose verbs go through
    ``torch.distributed``. ``process_ranks[q]`` is the world rank of the
    mesh's process q (a sub-mesh's processes are some of the world's)."""

    def __init__(self, local_devices: Sequence[torch.device], counts: Sequence[int], process: int, group, control,
                 process_ranks: Optional[Sequence[int]] = None):
        super().__init__(local_devices)
        counts = tuple(int(c) for c in counts)
        if counts[process] != len(self._devices):
            raise ValueError(f"process {process} holds {len(self._devices)} ranks, counts say {counts[process]}")
        self.counts = counts
        self.process = int(process)
        self.group = group
        self.control = control
        self.process_ranks = tuple(range(len(counts)) if process_ranks is None else process_ranks)
        self.first_rank = sum(counts[:process])
        self._size = sum(counts)
        self.spans_processes = len(counts) > 1
        self._placements = tuple(
            RankPlacement(r, q, self._devices[r - self.first_rank] if q == process else None)
            for q, c in enumerate(counts)
            for r in range(sum(counts[:q]), sum(counts[:q]) + c)
        )
        self._subs: Dict[Tuple[int, ...], object] = {}

    @property
    def size(self) -> int:
        return self._size

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        if self.spans_processes:
            raise _spanning("a global device list")
        return self._devices

    @property
    def placements(self) -> Tuple[RankPlacement, ...]:
        return self._placements

    @property
    def _staged(self) -> bool:
        """Whether the payload goes through the host: CUDA shards on gloo."""
        import torch.distributed as dist

        return self._devices[0].type == "cuda" and dist.get_backend(self.group) == "gloo"

    def _transport(self) -> torch.device:
        return torch.device("cpu") if self._staged or self._devices[0].type == "cpu" else self._devices[0]

    def sub(self, ranks: Sequence[int]) -> Union[MeshCommunication, ForeignSubMesh]:
        """The mesh of the shards ``ranks``, in that order. Every process
        calls it with the same ranks: ranks that all live in this process
        give the in-process mesh of their devices; ranks in several processes
        a :class:`ProcessMeshCommunication` over a new group of those
        processes (created by every process of the world, in the same order,
        and cached by the rank tuple), its ranks listed process by process in
        process order; ranks that all live elsewhere a
        :class:`ForeignSubMesh`, whose verbs raise."""
        ranks = tuple(int(r) for r in ranks)
        if not self.spans_processes:
            return MeshCommunication([self._devices[r] for r in ranks])
        if ranks in self._subs:
            return self._subs[ranks]
        owners = [self._placements[r].process_index for r in ranks]
        members = sorted(set(owners))
        mine = [self._devices[r - self.first_rank] for r, q in zip(ranks, owners) if q == self.process]
        if len(members) == 1:
            sub = MeshCommunication(mine) if mine else ForeignSubMesh(ranks)
        else:
            import torch.distributed as dist

            if owners != sorted(owners):
                raise ValueError(f"a sub-mesh over processes lists its ranks process by process, in process "
                                 f"order: ranks {list(ranks)} live in processes {owners}")
            if self.group is not dist.group.WORLD:
                raise CrossProcessMeshError(f"a sub-mesh over processes of {self!r}: only the world's mesh "
                                            "creates process groups")
            peers = [self.process_ranks[q] for q in members]
            backend = dist.get_backend(self.group)
            group = dist.new_group(peers, backend=backend)
            control = group if backend == "gloo" else dist.new_group(peers, backend="gloo")
            if mine:
                sub = ProcessMeshCommunication(mine, [owners.count(q) for q in members], members.index(self.process),
                                               group, control, process_ranks=peers)
            else:
                sub = ForeignSubMesh(ranks)
        self._subs[ranks] = sub
        return sub

    # ------------------------------------------------------------------
    # the exchange under every verb
    # ------------------------------------------------------------------
    def _fire(self, verb: str) -> None:
        if self._records and resilience._ARMED and not getattr(_DECLARED, "depth", 0):
            resilience.check("collective." + verb)

    def _record(self, verb: str, payload) -> None:
        if self._records and telemetry._MODE and not getattr(_DECLARED, "depth", 0):
            # heat-lint: disable=H005 — every verb calls _fire (collective.<verb>) beside _record
            telemetry.record_collective_operand(verb, HOST_STAGED_AXIS if self._staged else SPLIT_AXIS, payload)

    def _payload(self, bufs: List[torch.Tensor], transport: torch.device, longest: int) -> List[torch.Tensor]:
        """Every process's bytes, in process order: this process's ``bufs``
        concatenated, padded to ``longest``, in one ``all_gather`` over
        ``group``."""
        import torch.distributed as dist

        buf = torch.cat(bufs) if bufs else torch.empty(0, dtype=torch.uint8, device=transport)
        if not longest:
            return [buf] * len(self.counts)
        padded = torch.zeros(longest, dtype=torch.uint8, device=transport)
        padded[: buf.numel()] = buf
        out = [torch.empty_like(padded) for _ in self.counts]
        dist.all_gather(out, padded, group=self.group)
        return out

    def _header(self, contrib: Dict[int, object], slots: int) -> torch.Tensor:
        """This process's fixed-layout header: its byte count, its entry
        count, then ``slots`` entries of :data:`_ENTRY` ``int64`` each."""
        header = torch.zeros(2 + slots * _ENTRY, dtype=torch.int64)
        header[1] = len(contrib)
        total = 0
        for e, (rank, value) in enumerate(contrib.items()):
            leaves = _leaves(value)
            if len(leaves) > _MAX_LEAVES:
                raise ValueError(f"a verb's value holds at most {_MAX_LEAVES} tensors, got {len(leaves)}")
            row = [rank, int(isinstance(value, tuple)), len(leaves)]
            for t in leaves:
                if t.dim() > _MAX_NDIM or t.dtype not in _HEADER_CODES:
                    raise ValueError(f"a verb moves tensors of at most {_MAX_NDIM} dimensions and the types "
                                     f"{_HEADER_DTYPES}, got {tuple(t.shape)} {t.dtype}")
                row += [_HEADER_CODES[t.dtype], t.dim(), *t.shape]
                row += [0] * (_MAX_NDIM - t.dim())
                total += t.numel() * t.element_size()
            at = 2 + e * _ENTRY
            header[at : at + len(row)] = torch.tensor(row, dtype=torch.int64)
        header[0] = total
        return header

    @staticmethod
    def _entries(header: torch.Tensor):
        """The ``(rank, signature)`` entries of one process's header."""
        values = header.tolist()
        out = []
        for e in range(values[1]):
            at = 2 + e * _ENTRY
            rank, is_tuple, n_leaves = values[at : at + 3]
            leaves, at = [], at + 3
            for _ in range(n_leaves):
                code, ndim = values[at : at + 2]
                leaves.append((tuple(values[at + 2 : at + 2 + ndim]), _HEADER_DTYPES[code]))
                at += 2 + _MAX_NDIM
            out.append((rank, (bool(is_tuple), tuple(leaves))))
        return out

    def _gather(self, contrib: Dict[int, object]) -> Dict[int, object]:
        """Every process's ``{rank: value}`` merged into one dict, the
        tensors on the transport's device: the fixed-layout headers of
        every process in one ``all_gather`` over the control group, then the
        bytes in one ``all_gather`` over ``group``."""
        import torch.distributed as dist

        transport = self._transport()
        header = self._header(contrib, max(self.counts))
        headers = [torch.empty_like(header) for _ in self.counts]
        dist.all_gather(headers, header, group=self.control)
        bufs = [b for value in contrib.values() for b in _flat_bytes(value, transport)]
        raws = self._payload(bufs, transport, max(int(h[0]) for h in headers))
        out: Dict[int, object] = {}
        for h, raw in zip(headers, raws):
            at = 0
            for rank, signature in self._entries(h):
                out[rank], at = _unflatten(raw, at, signature)
        return out

    def _everyone(self, shards: Sequence) -> List:
        """Every rank's value, in rank order, for the verbs whose values
        share one shape and type by contract (``allreduce``, ``scan``,
        ``exscan``): checked on this process's shards, then one
        ``all_gather`` of the bytes and no header. The bytes start with a
        digest of this process's signature, which every process checks
        against its own: a process whose values differ in shape or type
        raises ``ValueError`` in every process."""
        signature = _signature(shards[0])
        for s in shards[1:]:
            if _signature(s) != signature:
                raise ValueError(f"the values of one reduction share a shape and a type: {signature} against "
                                 f"{_signature(s)}")
        transport = self._transport()
        size = sum(_nbytes(shape, dt) for shape, dt in signature[1])
        digest = hashlib.blake2b(repr(signature).encode(), digest_size=_DIGEST).digest()
        mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8).to(transport)
        bufs = [mine] + [b for s in shards for b in _flat_bytes(s, transport)]
        raws = self._payload(bufs, transport, _DIGEST + size * max(self.counts))
        values = []
        for q, (c, raw) in enumerate(zip(self.counts, raws)):
            if not torch.equal(raw[:_DIGEST], mine):
                raise ValueError(f"the values of one reduction share a shape and a type in every process: process "
                                 f"{q}'s differ from this process's {signature}")
            at = _DIGEST
            for _ in range(c):
                value, at = _unflatten(raw, at, signature)
                values.append(value)
        return values

    def _standins(self) -> List[torch.device]:
        """A device per global rank for the one-process arithmetic: this
        process's own for its ranks, its first device for the others (the
        same device type everywhere, so the same rounding)."""
        devs = [self._devices[0]] * self._size
        devs[self.first_rank : self.first_rank + len(self._devices)] = self._devices
        return devs

    def _mine(self, values: Sequence) -> List:
        return list(values[self.first_rank : self.first_rank + len(self._devices)])

    def _owner(self, rank: int) -> int:
        return self._placements[rank].process_index

    # ------------------------------------------------------------------
    # the verbs, across processes
    # ------------------------------------------------------------------
    def allreduce(self, shards: Sequence, op: Union[str, Callable] = "sum") -> List:
        self._check(shards)
        self._fire("allreduce")
        values = self._everyone(shards)
        self._record("allreduce", shards[0])
        return _allreduce(values, op, self._devices)

    def bcast(self, shards: Sequence, root: int = 0) -> List:
        """Every shard gets rank ``root``'s value: the root's process
        broadcasts its header over the control group, then its bytes over
        ``group``; the other processes' values are not read."""
        import torch.distributed as dist

        self._check(shards)
        self._fire("bcast")
        src = self.process_ranks[self._owner(root)]
        transport = self._transport()
        held = self._owner(root) == self.process
        header = self._header({root: shards[root - self.first_rank]} if held else {}, 1)
        dist.broadcast(header, src=src, group=self.control)
        (_, signature), = self._entries(header)
        if held:
            buf = torch.cat(_flat_bytes(shards[root - self.first_rank], transport))
        else:
            buf = torch.empty(int(header[0]), dtype=torch.uint8, device=transport)
        if buf.numel():
            dist.broadcast(buf, src=src, group=self.group)
        got, _ = _unflatten(buf, 0, signature)
        self._record("bcast", got)
        return [_to(got, d) for d in self._devices]

    def exscan(self, shards: Sequence, op: Union[str, Callable] = "sum", neutral=None) -> List:
        self._check(shards)
        if neutral is None and callable(op):
            raise ValueError("a callable op requires an explicit neutral element")
        self._fire("exscan")
        values = self._everyone(shards)
        self._record("exscan", shards[0])
        return self._mine(_exscan(values, op, self._standins(), neutral))

    def scan(self, shards: Sequence, op: Union[str, Callable] = "sum") -> List:
        self._check(shards)
        self._fire("scan")
        values = self._everyone(shards)
        self._record("scan", shards[0])
        return self._mine(_prefixes(values, op, self._standins()))

    def allgather(self, shards: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
        self._check(shards)
        self._fire("allgather")
        got = self._gather({self.first_rank + i: s for i, s in enumerate(shards)})
        self._record("allgather", shards[0])
        first = self._devices[0]
        whole = torch.cat([got[r].to(first) for r in range(self._size)], dim=dim)
        return [whole if whole.device == d else whole.to(d) for d in self._devices]

    def ppermute(
        self,
        shards: Sequence[torch.Tensor],
        shift: int = 1,
        perm: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> List[torch.Tensor]:
        """Shard d receives shard ``(d + shift) % p``, or what ``perm``'s
        (src, dst) pairs say (zeros where no pair names d). Every shard of
        one permute has one shape and type, as in ``lax.ppermute``: each
        receiver allocates its block like its own shard. A pair within this
        process moves in place; a pair across processes is one send and one
        receive of ``dist.batch_isend_irecv`` over ``group``, tagged by its
        index in ``perm``, every process posting its pairs in that order."""
        import torch.distributed as dist

        self._check(shards)
        like = shards[0]
        for s in shards[1:]:
            if s.shape != like.shape or s.dtype != like.dtype:
                raise ValueError(f"the shards of one ppermute share a shape and a type: {tuple(like.shape)} "
                                 f"{like.dtype} against {tuple(s.shape)} {s.dtype}")
        self._fire("ppermute")
        p, first, me = self._size, self.first_rank, self.process
        if perm is None:
            perm = [((d + shift) % p, d) for d in range(p)]
        received: List[Optional[torch.Tensor]] = [None] * len(self._devices)
        named = set()
        ops, incoming = [], []
        staged = self._staged
        for tag, (src, dst) in enumerate(perm):
            if dst in named:
                raise ValueError(f"perm names destination {dst} twice")
            named.add(dst)
            q_src, q_dst = self._owner(src), self._owner(dst)
            if q_src == q_dst == me:
                received[dst - first] = shards[src - first].to(self._devices[dst - first])
            elif q_src == me:
                block = shards[src - first].detach().contiguous()
                ops.append(dist.P2POp(dist.isend, block.cpu() if staged else block, self.process_ranks[q_dst],
                                      self.group, tag))
            elif q_dst == me:
                block = torch.empty(like.shape, dtype=like.dtype, device=self._transport())
                ops.append(dist.P2POp(dist.irecv, block, self.process_ranks[q_src], self.group, tag))
                incoming.append((dst - first, block))
        if ops:
            for request in dist.batch_isend_irecv(ops):
                request.wait()
        for i, block in incoming:
            received[i] = block.to(self._devices[i])
        self._record("ppermute", like)
        return [torch.zeros_like(shards[i]) if r is None else r for i, r in enumerate(received)]

    def alltoall(
        self, shards: Sequence[torch.Tensor], split_axis: int = 0, concat_axis: int = 0
    ) -> List[torch.Tensor]:
        self._check(shards)
        p = self._size
        for s in shards:
            if s.shape[split_axis] % p:
                raise ValueError(
                    f"alltoall splits axis {split_axis} of size {s.shape[split_axis]} into {p} equal pieces"
                )
        self._fire("alltoall")
        got = self._gather({self.first_rank + i: s for i, s in enumerate(shards)})
        self._record("alltoall", shards[0])
        pieces = [got[r].tensor_split(p, dim=split_axis) for r in range(p)]
        return [
            torch.cat([pieces[d][j].to(dev) for d in range(p)], dim=concat_axis)
            for j, dev in zip(range(self.first_rank, self.first_rank + len(self._devices)), self._devices)
        ]

    def _check(self, shards: Sequence) -> None:
        if len(shards) != len(self._devices):
            raise ValueError(f"expected this process's {len(self._devices)} shards, got {len(shards)}")

    def __repr__(self) -> str:
        return (f"ProcessMeshCommunication({self._size} {self._devices[0].type} rank(s) over "
                f"{len(self.counts)} process(es), this one process {self.process} holding "
                f"ranks {self.first_rank}..{self.first_rank + len(self._devices) - 1})")


# ---------------------------------------------------------------------------
# the verbs under autograd, across processes
# ---------------------------------------------------------------------------
# The in-process verbs are torch operations, so autograd differentiates a
# schedule over them as it does any torch code. The verbs of a
# ProcessMeshCommunication move bytes, where autograd stops; the layers above
# them call the functions below instead, each a verb with its transpose as
# the backward, run with the same verbs. Two rules hold every backward to
# what autograd gives through the one-process mesh of the same p, bit for
# bit:
# * a value every process holds whole and every process's loss reads once
#   (an allreduce's total, the blocks joined into the whole) is not summed
#   over the processes in the backward: each process's gradient of it is
#   already the whole gradient;
# * a backward that exchanges runs in every process, in the same order: every
#   output of such a function reaches the loss in every process (the layers
#   use all of them), and the graphs of the processes are the same.
# A gradient summed from several uses is folded as autograd's engine folds a
# tensor used several times on one mesh: the last use first.


def differentiable(comm) -> bool:
    """Whether autograd sees through ``comm``'s verbs as they are: the
    in-process verbs are torch operations; the verbs of a
    :class:`ProcessMeshCommunication` move bytes, so a layer calls the
    functions of this section on it."""
    return not isinstance(comm, ProcessMeshCommunication)


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, perm, *shards):
        ctx.comm, ctx.perm = comm, perm
        return tuple(comm.ppermute(list(shards), perm=list(perm)))

    @staticmethod
    def backward(ctx, *grads):
        back = ctx.comm.ppermute(list(grads), perm=[(dst, src) for src, dst in ctx.perm])
        return (None, None, *back)


def permute(comm, shards: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``comm.ppermute(shards, perm=perm)``, differentiable on any mesh: the
    transpose is the permute of the inverse pairs, so a source that no pair
    names gets a zero gradient."""
    if differentiable(comm) or not _needs_grad(shards):
        return comm.ppermute(list(shards), perm=list(perm))
    return list(_Permute.apply(comm, tuple(tuple(p) for p in perm), *shards))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, split_axis, concat_axis, *shards):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return tuple(comm.alltoall(list(shards), split_axis=split_axis, concat_axis=concat_axis))

    @staticmethod
    def backward(ctx, *grads):
        split_axis, concat_axis = ctx.axes
        back = ctx.comm.alltoall(list(grads), split_axis=concat_axis, concat_axis=split_axis)
        return (None, None, None, *back)


def all_to_all(comm, shards: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """``comm.alltoall``, differentiable on any mesh: the transpose swaps
    the two axes."""
    if differentiable(comm) or not _needs_grad(shards):
        return comm.alltoall(list(shards), split_axis=split_axis, concat_axis=concat_axis)
    return list(_AllToAll.apply(comm, split_axis, concat_axis, *shards))


class _SumToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, *parts):
        ctx.devices = [t.device for t in parts]
        return comm.allreduce(list(parts))[0]

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.to(d) for d in ctx.devices))


def sum_to_all(comm, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``comm.allreduce(parts)[0]``: the sum over every rank, on ``home``
    in every process. The total is read once per process, so each part's
    gradient is the total's, unsummed: no verb runs in the backward."""
    if differentiable(comm) or not _needs_grad(parts):
        return comm.allreduce(list(parts))[0]
    return _SumToAll.apply(comm, *parts)


def _sent(comm, grads: dict, senders: Sequence[int], dim: int, like: torch.Tensor) -> List[torch.Tensor]:
    """Per local rank, the gradients of the blocks it sends, joined along
    ``dim`` in block order (an empty block when it sends none)."""
    out = []
    for r, dev in zip(comm.local_ranks, comm.local_devices):
        mine = [grads[b].to(dev) for b, s in enumerate(senders) if s == r]
        if mine:
            out.append(torch.cat(mine, dim=dim))
        else:
            shape = list(like.shape)
            shape[dim] = 0
            out.append(like.new_zeros(shape, device=dev))
    return out


def _check_senders(comm, senders: Sequence[int], held: Sequence[int]) -> None:
    if list(senders) != sorted(senders):
        raise ValueError(f"the blocks' senders are ranks in block order, got {list(senders)}")
    local = set(comm.local_ranks)
    missing = [b for b, s in enumerate(senders) if s in local and b not in held]
    if missing:
        raise ValueError(f"this process sends blocks {missing} it does not hold")


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _TakeBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, sizes, dim, held, senders, whole):
        ctx.comm, ctx.sizes, ctx.dim, ctx.held, ctx.senders = comm, sizes, dim, held, senders
        ctx.device = whole.device
        blocks = whole.split(list(sizes), dim)
        return tuple(blocks[b].to(d) for b, d in held)

    @staticmethod
    def backward(ctx, *grads):
        by_block = {b: g for (b, _), g in zip(ctx.held, grads)}
        sent = _sent(ctx.comm, by_block, ctx.senders, ctx.dim, grads[0])
        whole = ctx.comm.allgather(sent, dim=ctx.dim)[0].to(ctx.device)
        return (None, None, None, None, None, whole)


def take_blocks(comm, whole: torch.Tensor, sizes: Sequence[int], dim: int, held: Sequence[Tuple[int, torch.device]],
                senders: Sequence[int]) -> List[torch.Tensor]:
    """The blocks ``b`` of ``held`` of a value every process holds whole,
    cut along ``dim`` into blocks of ``sizes``, each moved to its device.
    The transpose is an allgather of the blocks' gradients: block b's from
    rank ``senders[b]``, which lives in a process that holds b (ranks in
    block order), joined into the whole gradient in every process."""
    held = tuple((int(b), torch.device(d)) for b, d in held)
    if differentiable(comm) or not _needs_grad([whole]):
        # one split, whose backward joins the blocks' gradients; the joined
        # gradient made contiguous, as the allgather across processes makes
        # it, so that a reduction over it (a bias's gradient) runs in the
        # same order on both meshes
        if _needs_grad([whole]):
            whole = _ContiguousGrad.apply(whole)
        blocks = whole.split(list(sizes), dim)
        return [blocks[b].to(d) for b, d in held]
    _check_senders(comm, senders, [b for b, _ in held])
    return list(_TakeBlocks.apply(comm, tuple(sizes), dim, held, tuple(senders), whole))


class _JoinBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, sizes, dim, ids, senders, device, everywhere, *blocks):
        ctx.sizes, ctx.dim, ctx.ids = sizes, dim, ids
        ctx.devices = [t.device for t in blocks]
        return _join(comm, sizes, dim, ids, senders, device, everywhere, blocks)

    @staticmethod
    def backward(ctx, g):
        blocks = g.split(list(ctx.sizes), ctx.dim)
        back = [blocks[b].to(d) for b, d in zip(ctx.ids, ctx.devices)]
        return (None, None, None, None, None, None, None, *back)


def _join(comm, sizes, dim, ids, senders, device, everywhere, blocks) -> torch.Tensor:
    if everywhere:
        order = sorted(range(len(ids)), key=lambda i: ids[i])
        return torch.cat([blocks[i].to(device) for i in order], dim=dim)
    sent = _sent(comm, dict(zip(ids, blocks)), senders, dim, blocks[0])
    return comm.allgather(sent, dim=dim)[0].to(device)


def join_blocks(comm, blocks: Sequence[torch.Tensor], ids: Sequence[int], sizes: Sequence[int], dim: int,
                senders: Sequence[int], device, everywhere: bool = False) -> torch.Tensor:
    """The whole value on ``device`` in every process, from the blocks
    ``ids`` this process holds: block b (of ``sizes`` along ``dim``) sent by
    rank ``senders[b]`` through one allgather, in block order; with
    ``everywhere`` (every process holds every block, a fact of the layout,
    the same in every process), and on an in-process mesh, nothing moves.
    Every process reads the whole once, so the transpose takes this
    process's blocks of its gradient and no verb runs in the backward."""
    ids = tuple(int(b) for b in ids)
    device = torch.device(device)
    # one process holds every block of an in-process mesh: they join as they are
    everywhere = everywhere or differentiable(comm)
    if not everywhere:
        _check_senders(comm, senders, ids)
    if differentiable(comm) or not _needs_grad(blocks):
        return _join(comm, sizes, dim, ids, senders, device, everywhere, list(blocks))
    return _JoinBlocks.apply(comm, tuple(sizes), dim, ids, tuple(senders), device, everywhere, *blocks)


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, uses, shapes, local_uses, shadows, keys, *tensors):
        ctx.comm, ctx.uses, ctx.shapes, ctx.local_uses, ctx.keys = comm, uses, shapes, local_uses, keys
        if len({t.dtype for t in tensors}) > 1:
            raise ValueError(f"shared tensors have one type, got {sorted({str(t.dtype) for t in tensors})}")
        ctx.likes = [(t.dtype, t.device) for t in tensors]
        held = dict(zip(keys, tensors))
        return tuple(held[uses[u][0]].to(d) for u, d in local_uses) + tuple(held[k].to(d) for k, d in shadows)

    @staticmethod
    def backward(ctx, *grads):
        comm, uses = ctx.comm, ctx.uses
        dtype = ctx.likes[0][0]
        mine = dict(zip((u for u, _ in ctx.local_uses), grads))
        flats = []
        for r, dev in zip(comm.local_ranks, comm.local_devices):
            parts = [mine[u].to(dev, dtype).reshape(-1) for u, (_, rank) in enumerate(uses) if rank == r]
            flats.append(torch.cat(parts) if parts else torch.zeros(0, dtype=dtype, device=dev))
        flat = comm.allgather(flats, dim=0)[0]
        got, at = {}, 0
        for r in range(comm.size):
            for u, (key, rank) in enumerate(uses):
                if rank == r:
                    n = math.prod(ctx.shapes[key])
                    got[u] = flat[at : at + n].reshape(ctx.shapes[key])
                    at += n
        out = []
        for key, (dt, dev) in zip(ctx.keys, ctx.likes):
            mine_uses = [u for u, (k, _) in enumerate(uses) if k == key]
            if not mine_uses:
                out.append(None)
                continue
            acc = got[mine_uses[-1]]
            for u in reversed(mine_uses[:-1]):
                acc = acc + got[u]
            out.append(acc.to(dev, dt))
        return (None, None, None, None, None, None, *out)


def share(comm, tensors: Dict, uses: Sequence[Tuple[object, int]], shapes: Dict,
          shadows: Sequence[Tuple[object, int]] = ()) -> List[torch.Tensor]:
    """Tensors every process holds whole (``tensors``, by key: this
    process's, which may be some of the keys) used by several ranks:
    ``uses`` lists every use in the order of the one-process schedule, as
    (key, rank). Returns one copy per use whose rank is this process's, on
    that rank's device, in use order, then one per ``shadows`` entry whose
    rank is this process's: a use that another process's rank also makes on
    the same values (a replicated result computed in both), whose gradient
    that rank's use carries. The transpose sums a key's gradient over all
    its uses, whichever process computed them: one allgather of every use's
    gradient over ``comm``, folded as autograd folds the uses of one tensor
    (the last use first), so each process gets the whole gradient.
    ``shapes`` holds every key's shape."""
    local = {r: d for r, d in zip(comm.local_ranks, comm.local_devices)}
    local_uses = tuple((u, local[rank]) for u, (_, rank) in enumerate(uses) if rank in local)
    local_shadows = tuple((key, local[rank]) for key, rank in shadows if rank in local)
    keys = tuple(tensors)
    values = [tensors[k] for k in keys]
    if differentiable(comm) or not _needs_grad(values):
        return [tensors[uses[u][0]].to(d) for u, d in local_uses] + [tensors[k].to(d) for k, d in local_shadows]
    used = {uses[u][0] for u, _ in local_uses} | {k for k, _ in local_shadows}
    if not used <= set(keys):
        raise ValueError(f"this process uses {sorted(map(str, used - set(keys)))} but does not hold them")
    return list(_Share.apply(comm, tuple(uses), dict(shapes), local_uses, local_shadows, keys, *values))


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
    if prev is not None and new is not None and new.placements != prev.placements:
        _refresh_world_state()


def _refresh_world_state() -> None:
    """Invalidate the mesh-keyed state after the default mesh changed
    (heat_tpu/core/communication.py:530-551): the fusion recorder's program
    cache and the memory gate's resolved budget, a fraction of the old
    mesh's memory, and the recorder's shape inference, whose keys hold the
    shard count and whose ops may close over a mesh (the reference's
    ``_apply_program.cache_clear()``). The other caches of the package hold
    no mesh: ``spatial.distance._gaussian_metric`` is keyed by sigma,
    ``statistics._var_reduction`` by ddof, ``types._promote`` by types, and
    the serving layer's ``programs.jsonl`` index by program keys, which name
    their shard count and stay true for the mesh they name."""
    from . import fusion, memledger

    fusion.clear_cache()
    fusion._infer_cached.cache_clear()
    fusion._infer_multi_cached.cache_clear()
    memledger.invalidate_resolved_budget()


def reform(devices: Optional[Sequence] = None) -> MeshCommunication:
    """Re-form the default mesh on ``devices``, or on the default mesh of
    the default device when None (heat_tpu/core/communication.py:557-571):
    the elastic supervisor's and the autoscaler's rebuild, and the idiom
    that restores the whole world after an elastic test. The new mesh
    becomes the default one, as with :func:`use_comm`, and every
    mesh-keyed cache is dropped, whether or not the devices changed.
    Arrays made before keep their old mesh.

    Raises :class:`CrossProcessMeshError` while the default mesh spans
    processes: a lost peer process is the launcher's reform
    (:mod:`.multihost`), not one inside this process."""
    global __default_comm
    current = _built_comm()
    if current is not None and current.spans_processes:
        raise CrossProcessMeshError(
            f"cannot re-form {current!r} inside one process (ROADMAP A11.5b(c2b)): a world of several "
            "processes shrinks through its launcher (multihost.PeerLostError, exit multihost.REFORM_EXIT, a "
            "respawn under a new epoch)"
        )
    comm = None if devices is None else MeshCommunication(devices)
    __default_comm = comm
    _refresh_world_state()
    return get_comm()


#: the gloo group of the live process world that carries barriers and the
#: verbs' shapes and types, whatever the payload's backend
_CONTROL = None


def _control_group():
    """The live process world's control group, or None before
    :func:`initialize`."""
    return _CONTROL


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    timeout_s: float = 600.0,
) -> ProcessMeshCommunication:
    """Join this process to a ``torch.distributed`` world and make the
    default mesh span every process's devices (heat_tpu/core/communication.py:574-637,
    over ``jax.distributed.initialize``).

    ``coordinator_address`` (``host:port``) is where process 0's TCPStore
    listens; without one, a world of one process listens on a free port of
    this host. ``backend`` is ``"gloo"`` for a CPU mesh and ``"nccl"`` for a
    CUDA one unless named; ``device`` is the device kind of this process's
    local mesh (default: the default device), which is every CUDA device or
    the CPU repeated ``HEAT_TPU_TEST_DEVICES`` times. ``timeout_s`` bounds
    every collective of the groups. A gloo control group carries barriers
    and the verbs' metadata in every world.

    Idempotent: with a live world it builds the mesh again over it. Returns
    the :class:`ProcessMeshCommunication`, installed with :func:`use_comm`
    (which refreshes the mesh-keyed state)."""
    import datetime

    import torch.distributed as dist

    from .multihost import _free_port

    global _CONTROL
    kind = devices_module.sanitize_device(device).device_type if device is not None else (
        devices_module.get_device().device_type)
    local = list(_world(kind).local_devices)
    if kind == "gpu":
        torch.cuda.set_device(local[0])
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if not dist.is_initialized():
        world = 1 if num_processes is None else int(num_processes)
        if coordinator_address is None:
            if world != 1:
                raise ValueError(f"a world of {world} processes needs a coordinator address")
            coordinator_address = f"127.0.0.1:{_free_port()}"
        rank = 0 if process_id is None else int(process_id)
        if backend is None:
            backend = "nccl" if kind == "gpu" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
                                timeout=timeout)
        _CONTROL = None
    if _CONTROL is None:
        _CONTROL = dist.new_group(backend="gloo", timeout=timeout)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, (len(local), kind), group=_CONTROL)
    kinds = {k for _, k in counts}
    if kinds != {kind}:
        raise ValueError(f"the processes' meshes hold devices of different kinds: {[k for _, k in counts]}")
    comm = ProcessMeshCommunication(local, [c for c, _ in counts], dist.get_rank(), dist.group.WORLD, _CONTROL)
    use_comm(comm)
    return comm
