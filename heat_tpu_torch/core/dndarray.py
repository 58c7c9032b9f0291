"""DNDarray — the distributed n-dimensional array (reference:
heat/core/dndarray.py, heat_tpu/core/dndarray.py).

A DNDarray holds one torch tensor per device of its
:class:`~heat_tpu_torch.core.communication.MeshCommunication`, in the pad+mask
layout of the JAX package (heat_tpu/core/dndarray.py:116-132): along the
``split`` axis every shard has ``ceil(n/p)`` rows, and the rows past the
global size ``n`` are padding, a suffix of the global axis. The padding's
content is unspecified; consumers that read the physical shards mask it.
A replicated array (``split=None``) holds the whole array on every device.

Under the fusion recorder (``core/fusion.py``) the shard list may be a
pending :class:`~heat_tpu_torch.core.fusion.LazyArray` chain instead. Every
reader of the shards forces it (``shards``, ``parray``, ``larray``,
``lshards``, ``numpy``, ``item``, indexing, printing, I/O, ``astype`` of a
concrete array); each force is attributed to its forcing point in
telemetry. ``resplit_`` and ``get_halo`` of a pending chain record nodes
of it instead (with ``HEAT_TPU_FUSION_COLLECTIVES=0`` they force it).
Shape, dtype, split and ``padded`` are metadata and never force.

* ``parray`` is the physical global tensor (shards concatenated, padding
  included); with one shard it is that shard, without a copy.
* ``larray`` is the logical global tensor: ``parray`` without the padding.

Indexing follows numpy, not torch: negative slice steps work, an index out
of range raises ``IndexError`` (the JAX package clamps it), and a result
never aliases its source. ``__setitem__`` writes into the shards in place
unless another array shares their storage, which it then copies first, so
that no other array sees the write (the JAX package's buffers are
immutable); a pending chain that reads the storage is forced first, so
that no result recorded before the write sees it either.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fusion, health_runtime, memledger, resilience, telemetry, types
from .communication import MeshCommunication
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray", "LocalIndex"]

# forcing-point attribution (telemetry): entered only when a chain is pending
_T_LARRAY = telemetry.force_trigger("larray")
_T_INDEXING = telemetry.force_trigger("indexing")
_T_COLLECTIVE = telemetry.force_trigger("collective")


class LocalIndex:
    """Marker wrapper to index into the local shard (reference
    dndarray.py:63). With one controller the whole array is addressable, so
    ``x.lloc[key]`` indexes ``x``."""

    def __init__(self, obj, key=None):
        self.obj = obj
        self.key = key

    def __getitem__(self, key):
        return self.obj[key]

    def __setitem__(self, key, value):
        self.obj[key] = value


class DNDarray:
    """Distributed n-dimensional array: one physical shard per mesh device.

    Parameters
    ----------
    shards : sequence of torch.Tensor
        The physical shards, one per device of ``comm``, in device order.
    gshape : tuple of int
        The logical global shape.
    dtype : heat type class
    split : int or None
        The distribution axis, or None for replicated.
    device : heat_tpu_torch.core.devices.Device
    comm : MeshCommunication
    """

    def __init__(
        self,
        shards: Sequence[torch.Tensor],
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device,
        comm: MeshCommunication,
    ):
        if len(shards) != comm.size:
            raise ValueError(f"expected {comm.size} shards, got {len(shards)}")
        self.__shards = _tagged(shards)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def comm(self) -> MeshCommunication:
        return self.__comm

    @property
    def device(self):
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    shape = gshape

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64)) if self.__gshape else 1

    gnumel = size

    @property
    def nbytes(self) -> int:
        """Bytes of the logical array."""
        return self.size * self._itemsize()

    gnbytes = nbytes

    @property
    def lnumel(self) -> int:
        """Elements of the first shard's logical block (reference dndarray.py:178)."""
        return int(np.prod(self.lshape, dtype=np.int64))

    @property
    def lnbytes(self) -> int:
        """Bytes of the first shard's logical block (reference dndarray.py:188)."""
        return self.lnumel * self._itemsize()

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Logical shape of the first shard (reference dndarray.py:404)."""
        return self.__comm.chunk(self.__gshape, self.__split, rank=0)[1]

    @property
    def stride(self) -> Tuple[int, ...]:
        """C-order strides of the global shape, in elements (reference
        dndarray.py:431)."""
        strides, acc = [], 1
        for n in reversed(self.__gshape):
            strides.append(acc)
            acc *= n
        return tuple(reversed(strides))

    @property
    def strides(self) -> Tuple[int, ...]:
        """C-order strides of the global shape, in bytes (reference
        dndarray.py:441)."""
        item = self._itemsize()
        return tuple(s * item for s in self.stride)

    @property
    def balanced(self) -> bool:
        """Always True: the pad+mask layout is balanced."""
        return True

    @property
    def lloc(self) -> LocalIndex:
        return LocalIndex(self)

    @property
    def T(self) -> "DNDarray":
        """The transpose, axes reversed."""
        from .linalg import basics

        return basics.transpose(self, None)

    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def shards(self) -> List[torch.Tensor]:
        """The physical shards, one per mesh device, padding included."""
        return list(self._forced())

    @property
    def _payload(self):
        """The stored shard list, or the pending ``fusion.LazyArray``,
        without forcing: the fusion recorder's read."""
        return self.__shards

    def _itemsize(self) -> int:
        payload = self.__shards
        if isinstance(payload, fusion.LazyArray):
            return payload.dtype.itemsize
        return payload[0].element_size()

    def _forced(self, scope=None) -> List[torch.Tensor]:
        """The shard list, a pending chain forced first (attributed to the
        forcing point ``scope``): the program's shards become this array's,
        claimed from the ``fusion`` owner, after the ``ht.errstate`` policy
        has checked their logical extent. A raise leaves the chain
        pending."""
        lazy = self.__shards
        if not isinstance(lazy, fusion.LazyArray):
            return lazy
        if scope is None:
            value = fusion.force(lazy, self.__comm)
        else:
            with scope:
                value = fusion.force(lazy, self.__comm)
        split = self.__split
        shards = list(value) if split is not None else _distribute(value[0], None, self.__comm)
        if resilience._ERRSTATE is not None or resilience._TLS_ARMED:
            if split is not None:
                counts = self.__comm.counts_displs_shape(self.__gshape, split)[0]
                logical = [s.narrow(split, 0, c) for s, c in zip(shards, counts)]
            else:
                logical = shards[:1]
            resilience.check_nonfinite(logical, "force", program=lazy.program, cid=lazy.cid)
        self.__shards = _tagged(shards)
        return self.__shards

    def _pending_cid(self) -> Optional[int]:
        """The correlation id of a pending chain, else None."""
        payload = self.__shards
        if isinstance(payload, fusion.LazyArray) and payload._value is None:
            return payload.cid
        return None

    @property
    def padded(self) -> bool:
        """True when the shards carry suffix padding along the split axis."""
        s = self.__split
        if s is None:
            return False
        payload = self.__shards
        rows = payload.shape[s] if isinstance(payload, fusion.LazyArray) else payload[0].shape[s]
        return rows * self.__comm.size != self.__gshape[s]

    @property
    def parray(self) -> torch.Tensor:
        """The physical global tensor, on the first mesh device: the shards
        concatenated along ``split``, padding included."""
        return self._physical(self._forced())

    def _physical(self, shards: List[torch.Tensor]) -> torch.Tensor:
        if self.__split is None or len(shards) == 1:
            return shards[0]
        first = self.__comm.devices[0]
        return torch.cat([s.to(first) for s in shards], dim=self.__split)

    @property
    def larray(self) -> torch.Tensor:
        """The logical global tensor: :attr:`parray` without the padding."""
        arr = self._physical(self._forced(_T_LARRAY))
        if self.padded:
            arr = arr.narrow(self.__split, 0, self.__gshape[self.__split])
        return arr

    @larray.setter
    def larray(self, array: torch.Tensor) -> None:
        """Replace the data with a new logical global tensor (reference
        dndarray.py:229-247): shape and dtype follow it, and it is cut into
        the pad+mask shards of the mesh along the split, which is dropped
        when the new tensor has no such axis."""
        if not isinstance(array, torch.Tensor):
            raise TypeError(f"larray must be a torch.Tensor, got {type(array)}")
        split = self.__split
        if split is not None and split >= array.ndim:
            split = None
        self.__shards = _tagged(_distribute(array.to(self.__comm.devices[0]), split, self.__comm))
        self.__gshape = tuple(int(s) for s in array.shape)
        self.__dtype = types.canonical_heat_type(array.dtype)
        self.__split = split

    @property
    def lshards(self) -> List[torch.Tensor]:
        """Per-device logical shards: each physical shard without its padding."""
        shards = self._forced()
        if self.__split is None:
            return list(shards)
        counts, _ = self.counts_displs()
        return [s.narrow(self.__split, 0, c) for s, c in zip(shards, counts)]

    @property
    def lshape_map(self) -> "DNDarray":
        """(n_devices, ndim) map of the logical shard shapes (reference
        dndarray.py:569-600)."""
        from . import factories

        lmap = self.__comm.lshape_map(self.__gshape, self.__split)
        return factories.array(lmap, dtype=types.int64, device=self.__device, comm=self.__comm)

    def is_distributed(self) -> bool:
        """True if data lives on more than one device (reference dndarray.py:957)."""
        return self.__split is not None and self.__comm.is_distributed()

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Counts/displacements along the split axis (reference dndarray.py:543)."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray has no counts and displacements")
        return self.__comm.counts_displs_shape(self.__gshape, self.__split)

    def _replace(self, shards: Sequence[torch.Tensor], gshape: Tuple[int, ...], split: Optional[int]) -> "DNDarray":
        """Swap the shards and their layout (the engines' ``out=`` path);
        the dtype follows the new shards."""
        if len(shards) != self.__comm.size:
            raise ValueError(f"expected {self.__comm.size} shards, got {len(shards)}")
        self.__shards = _tagged(shards)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__split = split
        self.__dtype = types.canonical_heat_type(shards[0].dtype)
        return self

    # ------------------------------------------------------------------
    # distribution and conversion
    # ------------------------------------------------------------------
    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Redistribute in place to a new split axis (reference
        dndarray.py:1235-1357). A pending chain stays pending: the
        redistribution records a node of it (``fusion.defer_reshard``,
        heat_tpu/core/dndarray.py:495-530)."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        if resilience._ARMED:
            # the fault fires before the array changes (heat_tpu dndarray.py:505-509)
            resilience.check("collective.reshard")
        payload = self.__shards
        if isinstance(payload, fusion.LazyArray) and payload._value is None and fusion.collectives_active():
            node = fusion.defer_reshard(payload, self.__gshape, self.__split, axis, self.__comm)
            if node is not None:
                self.__shards = node
                self.__split = axis
                fusion.register_root(self)
                return self
        self._forced(_T_COLLECTIVE)  # a redistribution is a collective: it forces
        self.__shards = _tagged(_distribute(self.larray, axis, self.__comm))
        self.__split = axis
        return self

    def is_balanced(self, force_check: bool = False) -> bool:
        """Always True: every shard holds ``ceil(n/p)`` rows (reference
        dndarray.py:475)."""
        return True

    def balance_(self) -> "DNDarray":
        """A no-op: the pad+mask layout is always balanced (reference
        dndarray.py:478)."""
        return self

    def redistribute_(self, lshape_map=None, target_map=None) -> "DNDarray":
        """Only the balanced identity map is representable; any other target
        map raises, as in the reference (dndarray.py:539)."""
        if target_map is not None:
            tm = np.asarray(target_map.numpy() if isinstance(target_map, DNDarray) else target_map)
            if not np.array_equal(tm, self.__comm.lshape_map(self.__gshape, self.__split)):
                raise NotImplementedError(
                    "arbitrary (ragged) target maps are not representable: arrays are always balanced"
                )
        return self

    def create_lshape_map(self, force_check: bool = False) -> "DNDarray":
        """Method form of :attr:`lshape_map` (reference dndarray.py:686)."""
        return self.lshape_map

    def ranked_shards(self):
        """Yield ``(rank, block)`` for every shard with logical rows, in rank
        order: each block is the shard's logical extent as a host numpy array
        (reference dndarray.py:374). A replicated or 0-d array yields
        ``(0, whole array)``."""
        if self.__split is None or self.ndim == 0:
            yield 0, self.numpy()
            return
        for r, (s, c) in enumerate(zip(self.lshards, self.counts_displs()[0])):
            if c:
                yield r, _host(s)

    def cpu(self) -> "DNDarray":
        """A copy on the CPU mesh (reference dndarray.py:751); the array
        itself when it is there already."""
        from . import devices

        return self._to_device(devices.cpu)

    def gpu(self) -> "DNDarray":
        """A copy on the GPU mesh, the counterpart of :meth:`cpu`."""
        from . import devices

        return self._to_device(devices.gpu)

    def _to_device(self, device) -> "DNDarray":
        from .communication import sanitize_comm

        if self.__device == device:
            return self
        comm = sanitize_comm(None, device)
        return DNDarray(
            _distribute(self.larray.to(comm.devices[0]), self.__split, comm), self.__gshape,
            self.__dtype, self.__split, device, comm,
        )

    # ------------------------------------------------------------------
    # halos (reference dndarray.py:552-684)
    # ------------------------------------------------------------------
    def get_halo(self, halo_size: int) -> None:
        """Exchange split-axis halos with the neighbouring shards: two
        ``ppermute`` shifts, shard d+1 receiving d's trailing ``halo_size``
        physical rows and shard d-1 its leading ones; the shards at the ends
        receive zeros, and padding rows go as zeros (reference
        dndarray.py:552). Nothing is exchanged on one shard or when the
        halo is wider than a shard. The halos of a pending chain are a
        node of it (``fusion.defer_apply``, heat_tpu/core/dndarray.py:
        570-598): arrays of the exchanged rows, read by ``convolve``
        without a force."""
        if not isinstance(halo_size, int):
            raise TypeError(f"halo_size needs to be of Python type integer, {type(halo_size)} given")
        if halo_size < 0:
            raise ValueError(f"halo_size needs to be a positive Python integer, {halo_size} given")
        self.__halo_size = halo_size
        self.__halos = None
        split, p = self.__split, self.__comm.size
        if not halo_size or split is None or p == 1:
            return
        payload = self.__shards
        if isinstance(payload, fusion.LazyArray) and payload._value is None and fusion.collectives_active():
            if halo_size > payload.shape[split]:
                return
            if resilience._ARMED:
                resilience.check("collective.halo")
            nodes = fusion.defer_apply(self.__comm, _halo_kernel, (self,), out_split=(split, split), halo_size=halo_size)
            if nodes is not None:
                hshape = list(self.__gshape)
                hshape[split] = halo_size * p
                self.__halos = tuple(fusion.wrap_node(n, tuple(hshape), split, self) for n in nodes)
                return
        shards = self._forced(_T_COLLECTIVE)
        if halo_size > shards[0].shape[split]:
            return
        if resilience._ARMED:
            resilience.check("collective.halo")
        self.__halos = _halo_kernel(self, comm=self.__comm, halo_size=halo_size)

    def _halo_arrays(self) -> Optional[Tuple["DNDarray", "DNDarray"]]:
        """The halos of the last :meth:`get_halo` as arrays of split rows,
        ``halo_size`` per shard, without a force (a pending exchange stays
        pending), or None."""
        halos = getattr(self, "_DNDarray__halos", None)
        if halos is None or isinstance(halos[0], DNDarray):
            return halos
        gshape = list(self.__gshape)
        gshape[self.__split] = halos[0][0].shape[self.__split] * self.__comm.size
        return tuple(DNDarray(h, tuple(gshape), self.__dtype, self.__split, self.__device, self.__comm) for h in halos)

    @property
    def halos(self) -> Optional[Tuple[List[torch.Tensor], List[torch.Tensor]]]:
        """The ``(from_prev, from_next)`` shard lists of the last
        :meth:`get_halo`, or None (a pending exchange is forced)."""
        halos = getattr(self, "_DNDarray__halos", None)
        if halos is not None and isinstance(halos[0], DNDarray):
            return tuple(h._forced(_T_COLLECTIVE) for h in halos)
        return halos

    @property
    def array_with_halos(self) -> torch.Tensor:
        """Every physical shard extended by its halos, ``[from_prev | shard |
        from_next]``, concatenated along the split axis on the first device
        (reference dndarray.py:619); the logical array when no halos were
        exchanged."""
        if getattr(self, "_DNDarray__halos", None) is None:
            return self.larray
        # the array first: a pending exchange of its chain rides the same
        # program, reading the chain's result instead of computing it again
        shards = self._forced(_T_COLLECTIVE)
        halos = self.halos
        first = self.__comm.devices[0]
        return torch.cat(
            [torch.cat([a, s, b], dim=self.__split).to(first) for a, s, b in zip(halos[0], shards, halos[1])],
            dim=self.__split,
        )

    def _halo_slice(self, rank: int, trailing: bool) -> Optional[torch.Tensor]:
        hs = getattr(self, "_DNDarray__halo_size", None)
        if not hs or self.__split is None or self.__comm.size < 2:
            return None
        _, _, slices = self.__comm.chunk(self.__gshape, self.__split, rank=rank)
        bound = slices[self.__split]
        if trailing:
            start = max(bound.stop - hs, 0)
            length = bound.stop - start
        else:
            start = bound.start
            length = min(hs, self.__gshape[self.__split] - start)
        return self.larray.narrow(self.__split, start, length)

    @property
    def halo_prev(self) -> Optional[torch.Tensor]:
        """The trailing ``halo_size`` rows of shard 0, which shard 1 receives
        (reference dndarray.py:660)."""
        return self._halo_slice(0, True)

    @property
    def halo_next(self) -> Optional[torch.Tensor]:
        """The leading ``halo_size`` rows of shard 1, which shard 0 receives
        (reference dndarray.py:674)."""
        return self._halo_slice(1, False)

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to a new element type (reference dndarray.py:443-468,
        693-719). A pending chain records the cast as a node."""
        dtype = types.canonical_heat_type(dtype)
        payload = self.__shards
        if isinstance(payload, fusion.LazyArray) and payload._value is None:
            try:
                casted = fusion.cast(payload, dtype.torch_type())
            except Exception as exc:  # the defer sites' one policy
                if not resilience.record_recoverable(exc):
                    raise
                casted = None
            if casted is not None:
                if copy:
                    return fusion.wrap_node(casted, self.__gshape, self.__split, self)
                self.__shards = casted
                self.__dtype = dtype
                fusion.register_root(self)
                return self
        shards = [s.to(dtype.torch_type()) for s in self._forced()]
        if copy:
            return DNDarray(shards, self.__gshape, dtype, self.__split, self.__device, self.__comm)
        self.__shards = _tagged(shards)
        self.__dtype = dtype
        return self

    def numpy(self) -> np.ndarray:
        """The logical array as a host numpy array (reference
        dndarray.py:991-1003); bfloat16, which numpy lacks, comes back as
        float32. A host read: telemetry counts it as a blocking sync, and the
        watchdog guards it as ``sync:numpy``."""
        cid = self._pending_cid()
        token = telemetry.record_blocking_sync("numpy", cid=cid) if telemetry._MODE else None
        with health_runtime.watch("sync:numpy", cid=cid):
            out = _host(self.larray)
        telemetry.end_blocking_sync(token)
        return out

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out.astype(dtype) if dtype is not None else out

    def item(self):
        """The single scalar value (reference dndarray.py:965)."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        cid = self._pending_cid()
        token = telemetry.record_blocking_sync("item", cid=cid) if telemetry._MODE else None
        with health_runtime.watch("sync:item", cid=cid):
            out = self.larray.item()
        telemetry.end_blocking_sync(token)
        return out

    def tolist(self, keepsplit: bool = False) -> list:
        """The values as nested Python lists (reference dndarray.py:748);
        with one controller the local data is the global array, so
        ``keepsplit`` changes nothing."""
        return self.numpy().tolist()

    def __bool__(self) -> bool:
        return bool(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def __complex__(self) -> complex:
        return complex(self.item())

    def __index__(self) -> int:
        if not types.heat_type_is_exact(self.__dtype):
            raise TypeError("only integer DNDarrays can be converted to an index")
        return int(self.item())

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------------
    # indexing (reference dndarray.py:801-913)
    # ------------------------------------------------------------------
    @staticmethod
    def _unwrap_key(key, device: Optional[torch.device] = None):
        """A numpy-style key with its array parts as torch tensors on
        ``device``: a list is an array index, an empty list an int64 one."""
        if isinstance(key, DNDarray):
            return key.larray.to(device)
        if isinstance(key, tuple):
            return tuple(DNDarray._unwrap_key(k, device) for k in key)
        if isinstance(key, list):
            if not key:
                return torch.zeros(0, dtype=torch.int64, device=device)
            return torch.as_tensor(np.asarray([np.asarray(k) if isinstance(k, DNDarray) else k for k in key]), device=device)
        if isinstance(key, np.ndarray):
            return torch.as_tensor(key, device=device)
        if isinstance(key, torch.Tensor):
            return key.to(device)
        if isinstance(key, (np.integer, np.bool_)):
            return key.item()
        return key

    def _result_split(self, key) -> Optional[int]:
        """The split of an indexing result (reference dndarray.py:817-879):
        the split axis followed through the key. A single advanced key that
        consumes the split axis splits the result along the block's first
        output dim; more than one advanced key gives None."""
        if self.__split is None:
            return None
        key_t = _expand_ellipsis(key if isinstance(key, tuple) else (key,), self.ndim)
        if sum(1 for k in key_t if _is_advanced_key(k)) > 1:
            return None
        out_dim = in_dim = 0
        for k in key_t:
            if k is None:
                out_dim += 1
                continue
            if _is_advanced_key(k):
                is_bool = _key_dtype_is_bool(k)
                consumed = _key_ndim(k) if is_bool else 1
                produced = 1 if is_bool else _key_ndim(k)
                if in_dim <= self.__split < in_dim + consumed:
                    return out_dim if produced > 0 else None
                in_dim += consumed
                out_dim += produced
                continue
            if in_dim == self.__split:
                return out_dim if isinstance(k, slice) else None
            in_dim += 1
            if isinstance(k, slice):
                out_dim += 1
        return out_dim + (self.__split - in_dim)

    def _shardwise_key(self, key) -> Optional[tuple]:
        """The key as each shard applies it alone, or None: only ints,
        slices, None and Ellipsis, the split axis taken whole with step 1
        (its entry becomes ``slice(None)``)."""
        if self.__split is None or self.__comm.size == 1:
            return None
        key_t = key if isinstance(key, tuple) else (key,)
        if any(k is not None and k is not Ellipsis and not isinstance(k, (int, np.integer, slice)) for k in key_t):
            return None
        if any(isinstance(k, (bool, np.bool_)) for k in key_t):
            return None
        key_t = _expand_ellipsis(key_t, self.ndim)
        n_dims = sum(1 for k in key_t if k is not None)
        if n_dims > self.ndim:
            return None
        key_t = key_t + (slice(None),) * (self.ndim - n_dims)
        out, in_dim, n = [], 0, self.__gshape[self.__split]
        for k in key_t:
            if k is not None and in_dim == self.__split:
                if not isinstance(k, slice) or k.indices(n) != (0, n, 1):
                    return None
                k = slice(None)
            in_dim += k is not None
            out.append(k)
        return tuple(out)

    def __getitem__(self, key) -> "DNDarray":
        """numpy indexing (reference dndarray.py:881): negative steps work,
        an index out of range raises ``IndexError``, and the result is a new
        array, never a view of this one."""
        shards = self._forced(_T_INDEXING)
        split = self._result_split(key)
        local = self._shardwise_key(key)
        if local is not None:
            shards = [_take(s, local) for s in shards]
            gshape = list(_take(self.__shards[0].narrow(self.__split, 0, 0), local).shape)
            gshape[split] = self.__gshape[self.__split]
            return DNDarray(shards, tuple(gshape), self.__dtype, split, self.__device, self.__comm)
        source = self.larray
        result = _take(source, DNDarray._unwrap_key(key, source.device))
        if result.ndim == 0 or (split is not None and split >= result.ndim):
            split = None
        return DNDarray(
            _distribute(result, split, self.__comm), tuple(result.shape),
            types.canonical_heat_type(result.dtype), split, self.__device, self.__comm,
        )

    def __setitem__(self, key, value) -> None:
        """numpy assignment (reference dndarray.py:898-911): the value is
        cast to this array's type and broadcast; an index out of range raises
        ``IndexError``; the padding stays padding. With repeated indices the
        write that wins is unspecified, as in the reference and torch."""
        with _T_INDEXING:
            fusion.release(self._forced())
        dtype = self.__dtype.torch_type()
        if isinstance(value, DNDarray):
            value = value.larray
        elif not isinstance(value, (torch.Tensor, int, float, bool, complex)):
            value = torch.as_tensor(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(self.__comm.devices[0], dtype)
        split = self.__split
        if split is None or self.__comm.size == 1:
            target = _owned(self.__shards[0])
            _put(target, DNDarray._unwrap_key(key, target.device), value)
            self.__shards = _tagged(_distribute(target, split, self.__comm))
            return
        local = self._shardwise_key(key)
        if local is not None:
            # each shard writes its logical rows and the value's rows that
            # land there
            out_split = self._result_split(key)
            target_shape = _take(self.__shards[0].narrow(split, 0, 0), local).shape
            full = list(target_shape)
            full[out_split] = self.__gshape[split]
            if isinstance(value, torch.Tensor):
                value = value.broadcast_to(full)
            counts, displs = self.counts_displs()
            shards = []
            for s, c, d in zip(self.__shards, counts, displs):
                s = _owned(s)
                if c:
                    v = value.narrow(out_split, d, c).to(s.device) if isinstance(value, torch.Tensor) else value
                    _put(s.narrow(split, 0, c), local, v)
                shards.append(s)
            self.__shards = _tagged(shards)
            return
        target = self.larray
        _put(target, DNDarray._unwrap_key(key, target.device), value)
        self.__shards = _tagged(_distribute(target, split, self.__comm))

    def fill_diagonal(self, value) -> "DNDarray":
        """Fill the main diagonal in place (reference dndarray.py:913)."""
        if self.ndim != 2:
            raise ValueError("Only 2D tensors supported")
        with _T_INDEXING:
            fusion.release(self._forced())
        split = self.__split
        if split is None:
            target = _owned(self.__shards[0])
            target.diagonal().fill_(value)
            self.__shards = _tagged(_distribute(target, None, self.__comm))
            return self
        counts, displs = self.counts_displs()
        shards = []
        for s, c, d in zip(self.__shards, counts, displs):
            s = _owned(s)
            s.narrow(split, 0, c).diagonal(offset=d if split == 0 else -d).fill_(value)
            shards.append(s)
        self.__shards = _tagged(shards)
        return self

    # ------------------------------------------------------------------
    # operators: the operator library bound as methods (reference
    # dndarray.py:930-1080)
    # ------------------------------------------------------------------
    def __add__(self, other):
        return arithmetics.add(self, other)

    def __radd__(self, other):
        return arithmetics.add(other, self)

    def __sub__(self, other):
        return arithmetics.sub(self, other)

    def __rsub__(self, other):
        return arithmetics.sub(other, self)

    def __mul__(self, other):
        return arithmetics.mul(self, other)

    def __rmul__(self, other):
        return arithmetics.mul(other, self)

    def __truediv__(self, other):
        return arithmetics.div(self, other)

    def __rtruediv__(self, other):
        return arithmetics.div(other, self)

    def __floordiv__(self, other):
        return arithmetics.floordiv(self, other)

    def __rfloordiv__(self, other):
        return arithmetics.floordiv(other, self)

    def __mod__(self, other):
        return arithmetics.mod(self, other)

    def __rmod__(self, other):
        return arithmetics.mod(other, self)

    def __pow__(self, other):
        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        return arithmetics.pow(other, self)

    def __matmul__(self, other):
        from .linalg import basics

        return basics.matmul(self, other)

    def __rmatmul__(self, other):
        from . import factories
        from .linalg import basics

        return basics.matmul(factories.array(other, device=self.__device, comm=self.__comm), self)

    def __and__(self, other):
        return arithmetics.bitwise_and(self, other)

    def __or__(self, other):
        return arithmetics.bitwise_or(self, other)

    def __xor__(self, other):
        return arithmetics.bitwise_xor(self, other)

    def __lshift__(self, other):
        return arithmetics.left_shift(self, other)

    def __rshift__(self, other):
        return arithmetics.right_shift(self, other)

    def __invert__(self):
        return arithmetics.invert(self)

    def __neg__(self):
        return arithmetics.neg(self)

    def __pos__(self):
        return arithmetics.pos(self)

    def __abs__(self):
        return rounding.abs(self)

    def __eq__(self, other):  # type: ignore[override]
        return relational.eq(self, other)

    def __ne__(self, other):  # type: ignore[override]
        return relational.ne(self, other)

    def __lt__(self, other):
        return relational.lt(self, other)

    def __le__(self, other):
        return relational.le(self, other)

    def __gt__(self, other):
        return relational.gt(self, other)

    def __ge__(self, other):
        return relational.ge(self, other)

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        from . import printing

        return printing.__str__(self)

    __str__ = __repr__


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16, which numpy lacks, as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# indexing helpers
# ---------------------------------------------------------------------------
def _is_advanced_key(k) -> bool:
    """True for boolean-mask and integer-array key parts (reference
    dndarray.py:1132): arrays of either package, numpy arrays, tensors and
    lists."""
    return isinstance(k, (list, np.ndarray, torch.Tensor, DNDarray))


def _key_dtype_is_bool(k) -> bool:
    if isinstance(k, DNDarray):
        return k.dtype is types.bool
    if isinstance(k, list):
        return len(k) > 0 and isinstance(k[0], (bool, np.bool_))
    if isinstance(k, torch.Tensor):
        return k.dtype == torch.bool
    return np.asarray(k).dtype == np.bool_


def _key_ndim(k) -> int:
    if isinstance(k, list):
        return np.asarray(k).ndim
    return k.ndim


def _expand_ellipsis(key_t: tuple, ndim: int) -> tuple:
    """Replace an Ellipsis by the full slices it stands for; a boolean key
    counts its ndim."""
    if not any(k is Ellipsis for k in key_t):
        return key_t
    explicit = sum(
        _key_ndim(k) if _is_advanced_key(k) and _key_dtype_is_bool(k) else 1
        for k in key_t
        if k is not Ellipsis and k is not None
    )
    out: list = []
    for k in key_t:
        out.extend([slice(None)] * (ndim - explicit) if k is Ellipsis else [k])
    return tuple(out)


def _torch_key(t: torch.Tensor, key) -> Tuple[tuple, List[int]]:
    """A numpy key as torch applies it to ``t``: integer arrays checked
    against their axis (``IndexError`` out of range, without letting the
    card assert), and each slice of negative step rewritten as a positive
    one over the axis reversed. Returns the key and the axes to reverse."""
    key_t = _expand_ellipsis(key if isinstance(key, tuple) else (key,), t.ndim)
    out, flips, dim = [], [], 0
    for k in key_t:
        if k is None or isinstance(k, (bool, np.bool_)):
            out.append(k)
            continue
        if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            out.append(k)
            dim += max(k.ndim, 1) if k.ndim else 0
            continue
        if dim >= t.ndim:
            raise IndexError(f"too many indices for array: array is {t.ndim}-dimensional")
        n = t.shape[dim]
        if isinstance(k, torch.Tensor):
            if k.is_floating_point() or k.is_complex():
                raise IndexError("arrays used as indices must be of integer (or boolean) type")
            if k.dtype == torch.uint8:  # an index to numpy, a mask to torch
                k = k.long()
            if k.numel():
                lo, hi = (int(v) for v in torch.aminmax(k))
                bad = hi if hi >= n else lo if lo < -n else None
                if bad is not None:
                    raise IndexError(f"index {bad} is out of bounds for axis {dim} with size {n}")
        elif isinstance(k, slice) and k.step is not None and k.step < 0:
            start, stop, step = k.indices(n)
            m = len(range(start, stop, step))
            first = n - 1 - start
            k = slice(first, first + (m - 1) * -step + 1, -step) if m else slice(0, 0)
            flips.append(dim)
        out.append(k)
        dim += 1
    return tuple(out), flips


def _take(t: torch.Tensor, key) -> torch.Tensor:
    """``t[key]`` with numpy's semantics, as a new contiguous tensor."""
    key, flips = _torch_key(t, key)
    if flips:
        return t.flip(flips)[key].contiguous()
    out = t[key]
    return out.clone(memory_format=torch.contiguous_format) if out._is_view() else out.contiguous()


def _put(t: torch.Tensor, key, value) -> None:
    """``t[key] = value`` in place with numpy's semantics."""
    key, flips = _torch_key(t, key)
    if isinstance(value, torch.Tensor) and value.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        value = value.clone()
    if flips:
        flipped = t.flip(flips)
        flipped[key] = value
        t.copy_(flipped.flip(flips))
    else:
        t[key] = value


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when another tensor shares its storage, so that
    a write into it reaches no other array."""
    try:
        # the storage object made for the call holds one reference
        shared = torch._C._storage_Use_Count(t.untyped_storage()._cdata) > 2
    except AttributeError:
        shared = True
    return t.clone() if shared else t


def _tagged(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards as a list, each attributed to ``dndarray`` in the memory
    ledger: every store of a payload goes through here."""
    shards = list(shards)
    for s in shards:
        memledger.tag(s, "dndarray")
    return shards


def _halo_kernel(x, *, comm, halo_size: int):
    """The halo exchange over the shards of ``x`` (a DNDarray, or a shard
    view inside a fused program): two ``ppermute`` shifts, shard d + 1
    receiving d's trailing ``halo_size`` physical rows and shard d - 1 its
    leading ones, padding rows sent as zeros. Returns ``(from_prev,
    from_next)``, one tensor per shard each."""
    split, p = x.split, comm.size
    shards = x.shards
    block = shards[0].shape[split]
    counts = x.counts_displs()[0]

    def edge(t: torch.Tensor, count: int, lead: bool) -> torch.Tensor:
        start = 0 if lead else block - halo_size
        piece = t.narrow(split, start, halo_size)
        if count < start + halo_size:  # padding goes as zeros
            keep = max(count - start, 0)
            zeros_shape = list(piece.shape)
            zeros_shape[split] = halo_size - keep
            piece = torch.cat([piece.narrow(split, 0, keep), piece.new_zeros(zeros_shape)], dim=split)
        return piece.clone()

    from_prev = comm.ppermute(
        [edge(t, c, False) for t, c in zip(shards, counts)], perm=[(j, j + 1) for j in range(p - 1)]
    )
    from_next = comm.ppermute(
        [edge(t, c, True) for t, c in zip(shards, counts)], perm=[(j, j - 1) for j in range(1, p)]
    )
    return from_prev, from_next


def _distribute(array: torch.Tensor, split: Optional[int], comm: MeshCommunication) -> List[torch.Tensor]:
    """Cut a logical global tensor into the pad+mask shards of ``comm``: along
    ``split``, ``ceil(n/p)`` rows per shard, the last ones zero-padded; the
    whole tensor on every device for ``split=None``. A single shard on the
    tensor's own device is the tensor itself, not a copy."""
    devices = comm.devices
    if split is None or array.ndim == 0:
        return [array.to(d) for d in devices]
    n = array.shape[split]
    p = comm.size
    block = -(-n // p) if n else 0
    if block * p != n:
        pad_shape = list(array.shape)
        pad_shape[split] = block * p - n
        array = torch.cat([array, array.new_zeros(pad_shape)], dim=split)
    if p == 1:
        return [array.to(devices[0])]
    return [
        array.narrow(split, i * block, block).to(d).contiguous() for i, d in enumerate(devices)
    ]


def _wrap(array: torch.Tensor, split: Optional[int], device, comm: MeshCommunication) -> DNDarray:
    """Distribute a logical global tensor and wrap it."""
    split = split if array.ndim else None
    return DNDarray(
        _distribute(array, split, comm),
        tuple(array.shape),
        types.canonical_heat_type(array.dtype),
        split,
        device,
        comm,
    )


# the operator library, bound above as methods; imported last because it
# imports this module
from . import arithmetics, relational, rounding  # noqa: E402
