"""Parallel I/O (reference: heat/core/io.py, heat_tpu/core/io.py).

The reference's per-chunk protocol, on the shards of a
:class:`~heat_tpu_torch.core.communication.MeshCommunication`:

* **Loads with a split** read each shard's block from the file on its own
  (an HDF5 hyperslab, a range of a memory-mapped ``.npy`` or netCDF3
  variable) and pad it to the ``ceil(n/p)`` rows of the pad+mask layout, so
  no host buffer holds the whole array. A file written from one mesh size
  loads at any other.
* **Saves stream the shards**: each shard's logical block (never its
  padding) is copied to the host and written in shard order; the array is
  never gathered. ``.npy`` and ``.csv`` are row-major, so a column split is
  resplit to rows first, as the reference does (io.py:543, 689).
* **HDF5** goes through h5py. **netCDF4** files are HDF5 files with
  dimension scales and are read and written as such (the reference does
  the same without the netCDF4 library); **classic netCDF3** (magic
  ``CDF``) is read through ``scipy.io.netcdf_file``'s mmap and written by
  :func:`_write_netcdf3`, one shard at a time, with
  ``save_netcdf(..., format="NETCDF3_CLASSIC")`` or ``"NETCDF3_64BIT"``.
* **CSV** is read and written by the native multithreaded codec
  (:mod:`heat_tpu_torch._native`) for floats, with the reference's Python
  path where there is no compiler, for integers (float64 would corrupt
  int64 above 2^53), for other separators and encodings, and for input the
  strict native parser refuses.

Every ``save_*`` writes a temporary file beside the target and renames it
into place (``resilience.atomic_write``): a failed write leaves the old
file, or none. Each write attempt is retried on a transient ``OSError``
(``resilience.call_with_retries``, fault site ``io.write``; the rename is
``io.rename``), as is each block read of a load (``io.read``). In verbose
telemetry a load's per-shard ingest and a save's shard stream each leave
one ``io`` event (heat_tpu/core/io.py:186-206, 310-326).

numpy has no bfloat16: such arrays are written as float32 values, which
hold them exactly.
"""

from __future__ import annotations

import csv as csv_module
import mmap
import os
import struct
from io import BytesIO
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import communication, factories, memledger, resilience, telemetry, types
from .dndarray import DNDarray

# the forcing-point attribution of the saves: a pending chain runs here
_T_IO = telemetry.force_trigger("io")

try:
    import h5py

    _HAS_HDF5 = True
except ImportError:  # pragma: no cover - h5py is in the test image
    h5py = None
    _HAS_HDF5 = False

try:
    import scipy.io as _scipy_io

    _HAS_SCIPY = True
except ImportError:  # pragma: no cover - scipy is in the test image
    _scipy_io = None
    _HAS_SCIPY = False

_HDF5_EXTENSIONS = frozenset([".h5", ".hdf5"])
_CSV_EXTENSIONS = frozenset([".csv"])
_NETCDF_EXTENSIONS = frozenset([".nc", ".nc4", ".netcdf"])
_NPY_EXTENSIONS = frozenset([".npy"])
_NETCDF3_FORMATS = {"NETCDF3_CLASSIC": 1, "NETCDF3_64BIT": 2, "NETCDF3_64BIT_OFFSET": 2}

__all__ = [
    "load",
    "load_csv",
    "load_hdf5",
    "load_netcdf",
    "load_npy",
    "save",
    "save_csv",
    "save_hdf5",
    "save_netcdf",
    "save_npy",
    "supports_hdf5",
    "supports_netcdf",
]


def supports_hdf5() -> bool:
    """True if HDF5 I/O is available: h5py imports (reference io.py:40-48)."""
    return _HAS_HDF5


def supports_netcdf() -> bool:
    """True if netCDF I/O is available (reference io.py:49-57): netCDF4
    files need h5py, classic netCDF3 files scipy."""
    return _HAS_HDF5 or _HAS_SCIPY


def _unsupported_extension(extension: str) -> ValueError:
    """A ValueError naming the formats this installation supports and the
    libraries the others need."""
    supported = [".csv", ".npy"]
    missing = []
    if supports_hdf5():
        supported += [".h5", ".hdf5"]
    else:
        missing.append(".h5/.hdf5 need h5py")
    if supports_netcdf():
        supported += [".nc", ".nc4", ".netcdf"]
    else:
        missing.append(".nc/.nc4/.netcdf need h5py (netCDF4) or scipy (classic NETCDF3)")
    msg = f"Unsupported file extension {extension!r}; supported extensions: {', '.join(supported)}"
    if missing:
        msg += f" (missing optional dependencies: {'; '.join(missing)})"
    return ValueError(msg)


def _extension(path) -> str:
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    return os.path.splitext(path)[-1].strip().lower()


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by file extension (reference io.py:662-712)."""
    extension = _extension(path)
    if extension in _CSV_EXTENSIONS:
        return load_csv(path, *args, **kwargs)
    if extension in _NPY_EXTENSIONS:
        return load_npy(path, *args, **kwargs)
    if extension in _HDF5_EXTENSIONS and supports_hdf5():
        return load_hdf5(path, *args, **kwargs)
    if extension in _NETCDF_EXTENSIONS and supports_netcdf():
        return load_netcdf(path, *args, **kwargs)
    raise _unsupported_extension(extension)


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by file extension (reference io.py:1060-1110)."""
    extension = _extension(path)
    if extension in _CSV_EXTENSIONS:
        return save_csv(data, path, *args, **kwargs)
    if extension in _NPY_EXTENSIONS:
        return save_npy(data, path, *args, **kwargs)
    if extension in _HDF5_EXTENSIONS and supports_hdf5():
        return save_hdf5(data, path, *args, **kwargs)
    if extension in _NETCDF_EXTENSIONS and supports_netcdf():
        return save_netcdf(data, path, *args, **kwargs)
    raise _unsupported_extension(extension)


# ---------------------------------------------------------------------------
# host transfers and the per-shard ingest
# ---------------------------------------------------------------------------
def _file_dtype(dtype) -> np.dtype:
    """The numpy type an array of heat type ``dtype`` is written as:
    bfloat16, which numpy lacks, as float32."""
    dtype = types.canonical_heat_type(dtype)
    if dtype is types.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(torch.empty(0, dtype=dtype.torch_type()).numpy().dtype)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One tensor copied to a host numpy array (bfloat16 as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _from_host(block: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host block as a tensor of ``dtype`` that owns its memory: a
    read-only (memory-mapped), strided or big-endian (netCDF3) block is
    copied first."""
    block = np.asarray(block)
    if not block.dtype.isnative:
        block = block.astype(block.dtype.newbyteorder("="))
    if not block.flags.writeable or not block.flags.c_contiguous:
        block = np.array(block, order="C")
    return torch.from_numpy(block).to(dtype)


def _ingest(read_block, gshape, dtype, split: int, device, comm, convert=_from_host) -> DNDarray:
    """A split DNDarray whose shards are read one at a time:
    ``read_block(slices)`` returns the host block of the global ``slices``,
    ``convert(block, torch_dtype)`` makes it a tensor, which is padded to the
    shard's ``ceil(n/p)`` rows and moved to its device (the reference's
    per-device ingest, io.py:149-210). Each block read, the host copy out
    of a memory map included, is retried at the ``io.read`` site. The
    memory ledger attributes each staged shard to ``io``, or to the
    enclosing :func:`~.memledger.owner_scope` (a checkpoint restore's),
    until the array that wraps it claims it. This process reads only the
    blocks of the ranks it holds, ``multihost.ranks_to_read``
    (heat_tpu/core/io.py:160-180): over a mesh whose ranks span processes,
    every process reads its own ranks' rows of the same file."""
    from . import multihost

    dtype = types.canonical_heat_type(dtype)
    tdt = dtype.torch_type()
    gshape = tuple(int(s) for s in gshape)
    n = gshape[split]
    block = -(-n // comm.size) if n else 0
    counts, displs = comm.counts_displs_shape(gshape, split)
    shards = []
    read_bytes = 0
    for r, placement in multihost.ranks_to_read(comm.placements, comm.process):
        dev = placement.device if isinstance(placement, communication.RankPlacement) else placement
        count, displ = counts[r], displs[r]
        sl = [slice(None)] * len(gshape)
        sl[split] = slice(displ, displ + count)
        host = resilience.call_with_retries("io.read", lambda: np.asarray(read_block(tuple(sl))))
        read_bytes += host.nbytes
        local = convert(host, tdt)
        if count < block:
            pad = list(gshape)
            pad[split] = block - count
            local = torch.cat([local, local.new_zeros(pad)], dim=split)
        piece = local.to(dev)
        memledger.tag(piece, memledger.current_owner() or "io")
        shards.append(piece)
    if telemetry._MODE >= 2:
        telemetry.record_event("io", op="sharded_ingest", bytes=int(read_bytes), blocks=len(shards), split=split)
    return DNDarray(shards, gshape, dtype, split, device, comm)


def _replicated(values: np.ndarray, dtype, device, comm) -> DNDarray:
    """A replicated DNDarray of host ``values`` as heat type ``dtype``."""
    dtype = types.canonical_heat_type(dtype)
    t = _from_host(values, dtype.torch_type())
    return factories.array(t, dtype=dtype, split=None, device=device, comm=comm, copy=False)


def _shard_blocks(data: DNDarray) -> Iterator[Tuple[int, int, np.ndarray]]:
    """``(rank, start, block)`` for every shard with logical rows, in shard
    order: the shard's logical block copied to the host, one at a time.

    A process that does not hold every rank refuses (heat_tpu/core/io.py:296-312):
    its blocks alone would make a file whose header declares the global
    shape over a short payload."""
    from . import multihost

    proc = data.comm.process
    if not all(multihost.is_addressable(d, proc) for d in data.comm.placements):
        raise NotImplementedError(
            "streaming save of a split array under a mesh whose ranks span processes: this process holds "
            "only part of the array, so a single-file write would be incomplete. Gather first "
            "(resplit_(None)), save per-process files, or use ht.checkpoint (per-process shard files)."
        )
    counts, displs = data.counts_displs()
    written = blocks = 0
    for r, (shard, count, displ) in enumerate(zip(data.shards, counts, displs)):
        if count:
            block = _to_host(shard.narrow(data.split, 0, count))
            written += block.nbytes
            blocks += 1
            yield r, displ, block
    if telemetry._MODE >= 2:
        telemetry.record_event("io", op="stream_blocks", bytes=int(written), blocks=blocks)


def _whole(data: DNDarray) -> np.ndarray:
    """The host copy of a replicated (or one-shard, or 0-d) array: its
    first shard's logical extent, not a gather."""
    if data.split is None or data.ndim == 0:
        return _to_host(data.shards[0])
    return _to_host(data.lshards[0])


def _rows(data: DNDarray) -> DNDarray:
    """A split array as one split along rows (one alltoall for a column
    split), for the row-major formats."""
    if data.split is None or data.split == 0:
        return data
    from .manipulations import resplit

    return resplit(data, 0)


# ---------------------------------------------------------------------------
# HDF5 (reference io.py:58-245)
# ---------------------------------------------------------------------------
def _need_h5py() -> None:
    if not _HAS_HDF5:
        raise RuntimeError("HDF5 I/O needs h5py, which does not import here")


def load_hdf5(
    path: str,
    dataset: str,
    dtype=types.float32,
    load_fraction: float = 1.0,
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Load an HDF5 dataset (reference io.py:58-147). With ``split`` given,
    each shard's block is its own h5py hyperslab read."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be str, but was {type(dataset)}")
    if not isinstance(load_fraction, float):
        raise TypeError(f"load_fraction must be float, but was {type(load_fraction)}")
    if load_fraction <= 0.0 or load_fraction > 1.0:
        raise ValueError(f"load_fraction must be in (0, 1], but was {load_fraction}")
    _need_h5py()
    device, comm = factories._resolve(device, comm)
    with resilience.call_with_retries("io.read", h5py.File, path, "r") as handle:
        data = handle[dataset]
        gshape = list(data.shape)
        if load_fraction < 1.0 and split == 0:
            gshape[0] = int(gshape[0] * load_fraction)
        gshape = tuple(gshape)
        if split is None or len(gshape) == 0:
            sl = tuple(slice(0, s) for s in gshape)
            values = resilience.call_with_retries("io.read", lambda: np.asarray(data[sl] if gshape else data[()]))
            return _replicated(values, dtype, device, comm)
        return _ingest(lambda sl: data[sl], gshape, dtype, split % len(gshape), device, comm)


def _check_mode(mode: str, path: str) -> None:
    if mode not in ("w", "a", "r+"):
        raise ValueError(f"mode was {mode}, not in possible modes ('w', 'a', 'r+')")
    if mode == "r+" and not os.path.exists(path):
        raise FileNotFoundError(f"mode 'r+' requires an existing file: {path}")


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
    """Save to an HDF5 dataset (reference io.py:148-245), one hyperslab per
    shard, written in shard order."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be heat tensor, but was {type(data)}")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be str, but was {type(dataset)}")
    _check_mode(mode, path)
    _need_h5py()
    data._forced(_T_IO)

    def _write():
        with resilience.atomic_write(path, preserve=mode in ("a", "r+")) as tmp:
            with h5py.File(tmp, mode) as handle:
                _write_h5_dataset(handle, dataset, data, **kwargs)

    resilience.call_with_retries("io.write", _write)


def _write_h5_dataset(handle, dataset: str, data: DNDarray, **kwargs):
    """Create ``dataset`` and write ``data`` into it shard by shard."""
    dset = handle.create_dataset(dataset, shape=data.gshape, dtype=_file_dtype(data.dtype), **kwargs)
    if data.split is None or data.ndim == 0:
        dset[...] = _whole(data)
        return dset
    counts = data.counts_displs()[0]
    for r, start, block in _shard_blocks(data):
        target = [slice(None)] * data.ndim
        target[data.split] = slice(start, start + counts[r])
        dset[tuple(target)] = block
    return dset


# ---------------------------------------------------------------------------
# netCDF (reference io.py:246-661): netCDF4 over h5py, classic netCDF3
# through scipy (read) and the writer below
# ---------------------------------------------------------------------------
def _is_netcdf3(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(3) == b"CDF"


def _load_netcdf3(path, variable, dtype, split, device, comm) -> DNDarray:
    """Classic netCDF3 through ``scipy.io.netcdf_file``'s mmap: each shard's
    block is copied out of the mapped variable on its own."""
    if not _HAS_SCIPY:
        raise RuntimeError("classic NETCDF3 files need scipy, which does not import here")
    device, comm = factories._resolve(device, comm)
    nc = resilience.call_with_retries("io.read", _scipy_io.netcdf_file, path, "r", mmap=True)
    var = None
    try:
        if variable not in nc.variables:
            raise KeyError(f"variable {variable!r} not in {sorted(nc.variables)}")
        var = nc.variables[variable]
        gshape = tuple(int(s) for s in var.shape)
        if split is None or len(gshape) == 0:
            values = resilience.call_with_retries("io.read", lambda: np.array(var[...] if gshape else var.getValue()))
            return _replicated(values, dtype, device, comm)
        return _ingest(lambda sl: np.array(var[sl]), gshape, dtype, split % len(gshape), device, comm)
    finally:
        del var
        nc.close()


def load_netcdf(
    path: str, variable: str, dtype=types.float32, split: Optional[int] = None, device=None, comm=None
) -> DNDarray:
    """Load a netCDF variable (reference io.py:246-414): classic netCDF3
    (magic ``CDF``) through scipy's mmap, netCDF4 as an HDF5 dataset."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    if not isinstance(variable, str):
        raise TypeError(f"variable must be str, but was {type(variable)}")
    if _is_netcdf3(path):
        return _load_netcdf3(path, variable, dtype, split, device, comm)
    return load_hdf5(path, variable, dtype=dtype, split=split, device=device, comm=comm)


def save_netcdf(
    data: DNDarray, path: str, variable: str, mode: str = "w", dimension_names=None,
    format: str = "NETCDF4", **kwargs,
) -> None:
    """Save to a netCDF variable (reference io.py:415-661), streamed shard by
    shard. ``format="NETCDF4"``, the reference's only output, writes an HDF5
    file whose variable carries one dimension scale per axis (named
    ``dimension_names[i]`` or ``<variable>_dim_<i>``); ``"NETCDF3_CLASSIC"``
    and ``"NETCDF3_64BIT"`` write the classic format, which needs neither
    h5py nor a copy of the whole array (mode ``"w"`` only; types int8,
    int16, int32, float32 and float64)."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be heat tensor, but was {type(data)}")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    if not isinstance(variable, str):
        raise TypeError(f"variable must be str, but was {type(variable)}")
    _check_mode(mode, path)
    data._forced(_T_IO)
    if dimension_names is None:
        dimension_names = [f"{variable}_dim_{i}" for i in range(data.ndim)]
    elif len(dimension_names) != data.ndim:
        raise ValueError(f"{len(dimension_names)} names given for {data.ndim} dimensions")
    if format in _NETCDF3_FORMATS:
        if mode != "w":
            raise ValueError(f"classic netCDF3 files are written whole: mode must be 'w', got {mode!r}")

        def _write3():
            with resilience.atomic_write(path) as tmp:
                _write_netcdf3(tmp, variable, data, list(dimension_names), _NETCDF3_FORMATS[format])

        resilience.call_with_retries("io.write", _write3)
        return
    if format != "NETCDF4":
        raise ValueError(f"format must be 'NETCDF4', 'NETCDF3_CLASSIC' or 'NETCDF3_64BIT', got {format!r}")
    _need_h5py()

    def _write():
        with resilience.atomic_write(path, preserve=mode in ("a", "r+")) as tmp:
            with h5py.File(tmp, mode) as handle:
                dset = _write_h5_dataset(handle, variable, data, **kwargs)
                for i, name in enumerate(dimension_names):
                    if name not in handle:
                        scale = handle.create_dataset(name, shape=(data.gshape[i],), dtype=np.float64)
                        scale.make_scale(name)
                    dset.dims[i].attach_scale(handle[name])

    resilience.call_with_retries("io.write", _write)


#: classic netCDF type codes (the netCDF3 file format specification)
_NC_TYPES = {
    np.dtype(np.int8): 1, np.dtype(np.int16): 3, np.dtype(np.int32): 4,
    np.dtype(np.float32): 5, np.dtype(np.float64): 6,
}


def _nc_name(name: str) -> bytes:
    raw = name.encode()
    return struct.pack(">i", len(raw)) + raw + b"\0" * (-len(raw) % 4)


def _write_netcdf3(path: str, variable: str, data: DNDarray, dimension_names: List[str], version: int) -> None:
    """Write ``data`` as the one variable of a classic netCDF3 file: the
    header (format version 1, or 2 for 64-bit offsets), then the values
    big-endian, shard by shard in row order (a column split is resplit to
    rows first)."""
    npdtype = _file_dtype(data.dtype)
    if npdtype not in _NC_TYPES:
        raise TypeError(f"classic netCDF3 has no type for {data.dtype.__name__}")
    if len(set(dimension_names)) != len(dimension_names):
        raise ValueError(f"dimension names must differ, got {dimension_names}")
    data = _rows(data)
    nbytes = int(np.prod(data.gshape, dtype=np.int64)) * npdtype.itemsize
    head = bytearray(b"CDF" + bytes([version]) + struct.pack(">i", 0))
    if data.ndim:
        head += struct.pack(">ii", 0x0A, data.ndim)
        for name, n in zip(dimension_names, data.gshape):
            head += _nc_name(name) + struct.pack(">i", n)
    else:
        head += b"\0" * 8
    head += b"\0" * 8  # no global attributes
    head += struct.pack(">ii", 0x0B, 1) + _nc_name(variable) + struct.pack(">i", data.ndim)
    head += b"".join(struct.pack(">i", i) for i in range(data.ndim))
    head += b"\0" * 8  # no variable attributes
    vsize = nbytes + (-nbytes % 4)
    head += struct.pack(">ii", _NC_TYPES[npdtype], min(vsize, 2**32 - 1))
    offset_format = ">i" if version == 1 else ">q"
    begin = len(head) + struct.calcsize(offset_format)
    if version == 1 and begin + vsize >= 2**31:
        raise ValueError("the variable is too large for NETCDF3_CLASSIC: use format='NETCDF3_64BIT'")
    head += struct.pack(offset_format, begin)
    big = npdtype.newbyteorder(">")
    with open(path, "wb") as fh:
        fh.write(head)
        if data.split is None or data.ndim == 0:
            fh.write(_whole(data).astype(big).tobytes())
        else:
            for _, _, block in _shard_blocks(data):
                block.astype(big).tofile(fh)
        fh.write(b"\0" * (vsize - nbytes))


# ---------------------------------------------------------------------------
# npy (numpy's own format, beyond the reference's heat)
# ---------------------------------------------------------------------------
def load_npy(path: str, dtype=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Load a ``.npy`` file, memory-mapped, so with ``split`` given each
    shard's block is its own range read (reference heat_tpu io.py:487-512).
    The dtype defaults to the file's."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    device, comm = factories._resolve(device, comm)
    mm = resilience.call_with_retries("io.read", np.load, path, mmap_mode="r")
    if dtype is None:
        dtype = types.canonical_heat_type(mm.dtype)
    if split is None or mm.ndim == 0:
        return _replicated(resilience.call_with_retries("io.read", np.array, mm), dtype, device, comm)
    # np.array copies the pages out of the map inside the retried read
    return _ingest(lambda sl: np.array(mm[sl]), tuple(mm.shape), dtype, split % mm.ndim, device, comm)


def save_npy(data: DNDarray, path: str) -> None:
    """Save to ``.npy``: the header, then the row blocks of the shards in
    shard order (a column split is resplit to rows first, reference
    heat_tpu io.py:515-562); a replicated array writes its own copy."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, but was {type(data)}")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    data._forced(_T_IO)
    if data.split is None or data.comm.size == 1 or data.ndim == 0:

        def _write_whole():
            with resilience.atomic_write(path) as tmp:
                # a file object: np.save of a str path would append '.npy'
                with open(tmp, "wb") as fh:
                    np.save(fh, _whole(data))

        resilience.call_with_retries("io.write", _write_whole)
        return
    data = _rows(data)
    header = {
        "descr": np.lib.format.dtype_to_descr(_file_dtype(data.dtype)),
        "fortran_order": False,
        "shape": tuple(int(s) for s in data.gshape),
    }

    def _write():
        with resilience.atomic_write(path) as tmp:
            with open(tmp, "wb") as fh:
                np.lib.format.write_array_header_1_0(fh, header)
                for _, _, block in _shard_blocks(data):
                    np.ascontiguousarray(block).tofile(fh)

    resilience.call_with_retries("io.write", _write)


# ---------------------------------------------------------------------------
# CSV (reference io.py:713-1059)
# ---------------------------------------------------------------------------
def _native_codec():
    """The native CSV codec when it is in use here, else None."""
    from .. import _native

    return _native if _native.native_available() else None


def _scan_line_offsets(path: str, header_lines: int) -> np.ndarray:
    """Byte offsets of each data line's start, and the end offset, from a
    scan of the file in bounded chunks (reference heat_tpu io.py:462-481)."""
    size = os.path.getsize(path)
    offsets = [0]
    with open(path, "rb") as f:
        pos = 0
        while True:
            buf = f.read(1 << 24)
            if not buf:
                break
            nl = np.flatnonzero(np.frombuffer(buf, dtype=np.uint8) == ord("\n"))
            offsets.extend((nl + pos + 1).tolist())
            pos += len(buf)
    if offsets[-1] != size:
        offsets.append(size)  # no trailing newline
    return np.asarray(offsets[header_lines:-1] + [offsets[-1]], dtype=np.int64)


def _load_csv_ranges(path, header_lines, sep, npdtype, dtype, device, comm) -> DNDarray:
    """The split=0 Python path: each shard's rows parsed from their own
    byte range of the memory-mapped file (reference heat_tpu io.py:589-631)."""
    offs = resilience.call_with_retries("io.read", _scan_line_offsets, path, header_lines)
    with open(path, "rb") as f:
        if os.path.getsize(path) == 0:
            return _replicated(np.empty((0, 0), npdtype), dtype, device, comm).resplit_(0)
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            lengths = np.diff(offs)
            crlf = bool(len(offs) > 1 and offs[1] >= 2 and mm[offs[1] - 2 : offs[1]] == b"\r\n")
            rows = np.flatnonzero(lengths > (2 if crlf else 1)).tolist()
            if lengths.size and lengths[-1] in (1, 2) and (len(offs) - 2) not in rows:
                if bytes(mm[offs[-2] : offs[-1]]).strip():
                    rows.append(len(offs) - 2)
            if not rows:
                return _replicated(np.empty((0, 0), npdtype), dtype, device, comm).resplit_(0)
            first = bytes(mm[offs[rows[0]] : offs[rows[0] + 1]]).strip()
            ncols = first.count(sep.encode()) + 1

            def read_block(sl):
                r0, r1 = sl[0].start, sl[0].stop
                if r1 <= r0:
                    return np.empty((0, ncols), dtype=npdtype)
                payload = bytes(mm[offs[rows[r0]] : offs[rows[r1 - 1] + 1]])
                out = np.loadtxt(BytesIO(payload), delimiter=sep, dtype=np.float64, ndmin=2)
                return out.astype(npdtype, copy=False)

            return _ingest(read_block, (len(rows), ncols), dtype, 0, device, comm)


def _parse_csv_python(path, header_lines, sep, encoding, npdtype) -> np.ndarray:
    rows: List[List[float]] = []
    with open(path, "r", encoding=encoding) as f:
        for i, line in enumerate(f):
            if i < header_lines:
                continue
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split(sep)])
    return np.asarray(rows, dtype=npdtype)


def _plain_encoding(encoding: str) -> bool:
    return encoding.lower().replace("-", "") in ("utf8", "ascii")


def load_csv(
    path: str,
    header_lines: int = 0,
    sep: str = ",",
    dtype=types.float32,
    encoding: str = "utf-8",
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Load a CSV file (reference io.py:713-925). The native codec parses
    the file with C++ threads (any split: each shard then takes its rows);
    without it, a split=0 load parses each shard's byte range on its own
    and other loads take the Python parser. Input the strict native parser
    refuses takes the Python path."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    if not isinstance(sep, str):
        raise TypeError(f"separator must be str, but was {type(sep)}")
    if not isinstance(header_lines, int):
        raise TypeError(f"header_lines must be int, but was {type(header_lines)}")
    dtype = types.canonical_heat_type(dtype)
    npdtype = _file_dtype(dtype)
    device, comm = factories._resolve(device, comm)
    plain = len(sep) == 1 and _plain_encoding(encoding)
    values = None
    native = _native_codec() if plain else None
    if native is not None:
        try:
            values = native.csv_parse(path, sep, header_lines)
        except ValueError:
            values = None  # malformed for the strict parser: the Python path decides
    if values is None and split == 0 and plain:
        return _load_csv_ranges(path, header_lines, sep, npdtype, dtype, device, comm)
    if values is None:
        values = resilience.call_with_retries("io.read", _parse_csv_python, path, header_lines, sep, encoding, npdtype)
    if split is None or values.ndim == 0:
        return _replicated(values.astype(npdtype, copy=False), dtype, device, comm)
    return _ingest(lambda sl: values[sl].astype(npdtype), values.shape, dtype, split % values.ndim, device, comm)


def save_csv(
    data: DNDarray,
    path: str,
    header_lines: Optional[List[str]] = None,
    sep: str = ",",
    decimals: int = -1,
    encoding: str = "utf-8",
    **kwargs,
) -> None:
    """Save to CSV, the row blocks of the shards in shard order (a column
    split is resplit to rows first; reference io.py:926-1059). Floats go
    through the native writer (shortest round-trip values of their float64
    form); integers, other separators and encodings through Python's
    ``csv`` (``%s``, numpy's shortest repr of the value's own type), both
    reading back to the same values."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, but was {type(data)}")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, but was {type(path)}")
    if data.ndim > 2:
        raise ValueError("CSV can only store 1-D or 2-D arrays")
    data._forced(_T_IO)
    data = _rows(data)

    def row_blocks():
        if data.split is None or data.comm.size == 1:
            blocks = [_whole(data)]
        else:
            blocks = (block for _, _, block in _shard_blocks(data))
        for block in blocks:
            yield block if block.ndim == 2 else block[:, None]

    def write_header(f):
        for line in header_lines or ():
            f.write(line if line.endswith("\n") else line + "\n")

    npdtype = _file_dtype(data.dtype)
    native = None
    if np.issubdtype(npdtype, np.floating) and len(sep) == 1 and ord(sep) < 128 and _plain_encoding(encoding):
        native = _native_codec()

    def _write():
        with resilience.atomic_write(path) as tmp:
            with open(tmp, "w", encoding=encoding, newline="") as f:
                write_header(f)
                if native is None:
                    fmt = f"%.{decimals}f" if decimals >= 0 else None
                    writer = csv_module.writer(f, delimiter=sep, lineterminator="\n")
                    for block in row_blocks():
                        for row in block:
                            writer.writerow([fmt % v for v in row] if fmt else row)
            if native is not None:
                for block in row_blocks():
                    native.csv_write(tmp, block, sep=sep, decimals=decimals, append=True)

    resilience.call_with_retries("io.write", _write)
