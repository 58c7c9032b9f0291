"""Tile decompositions of distributed arrays (reference: heat/core/tiling.py,
heat_tpu/core/tiling.py).

A tile is a rectangle of the global index space, so both classes are index
arithmetic over the pad+mask layout's ceil-division blocks, with reads and
writes through the array's own ``__getitem__``/``__setitem__``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .dndarray import DNDarray

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _axis_tile_sizes(length: int, n: int) -> np.ndarray:
    """The extents of ``n`` contiguous blocks of ``length`` under the
    ceil-division rule, the layout the shards are placed with."""
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    block = -(-length // n) if length else 0
    return np.array([max(0, min(block, length - i * block)) for i in range(n)], dtype=np.int64)


class SplitTiles:
    """One tile per device along every axis (reference tiling.py:45):
    ``tile_dimensions[d]`` holds the extents along axis d,
    ``tile_ends_g`` their inclusive global ends, and ``tile_locations`` the
    device owning each tile, given by the split axis alone."""

    def __init__(self, arr: DNDarray):
        self.__arr = arr
        n = arr.comm.size
        sizes = np.zeros((max(arr.ndim, 1), n), dtype=np.int64)
        for d in range(arr.ndim):
            sizes[d] = _axis_tile_sizes(arr.gshape[d], n)
        self.__tile_dimensions = sizes
        self.__tile_ends_g = np.cumsum(sizes, axis=1) - 1
        self.__tile_locations = self.set_tile_locations(arr.split, sizes, arr)

    @staticmethod
    def set_tile_locations(split: Optional[int], tile_dims: np.ndarray, arr: DNDarray) -> np.ndarray:
        """The owner of each tile: the device holding its slab of the split
        axis; device 0 for a replicated array."""
        n = arr.comm.size
        locs = np.zeros((tile_dims.shape[1],) * max(arr.ndim, 1), dtype=np.int64)
        if split is None or arr.ndim == 0:
            return locs
        idx = [None] * arr.ndim
        idx[split] = slice(None)
        return locs + np.arange(n, dtype=np.int64)[tuple(idx)]

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def lshape_map(self) -> np.ndarray:
        return self.__arr.comm.lshape_map(self.__arr.gshape, self.__arr.split)

    @property
    def tile_locations(self) -> np.ndarray:
        return self.__tile_locations

    @property
    def tile_ends_g(self) -> np.ndarray:
        return self.__tile_ends_g

    @property
    def tile_dimensions(self) -> np.ndarray:
        return self.__tile_dimensions

    def __tile_slices(self, key) -> Tuple[slice, ...]:
        """Global slices of the tiles a per-axis tile key selects."""
        if not isinstance(key, tuple):
            key = (key,)
        out = []
        for d in range(self.__arr.ndim):
            k = key[d] if d < len(key) else slice(None)
            ends = self.__tile_ends_g[d] + 1
            starts = np.concatenate(([0], ends[:-1]))
            if isinstance(k, slice):
                idx = range(*k.indices(len(ends)))
                out.append(slice(int(starts[idx[0]]), int(ends[idx[-1]])) if len(idx) else slice(0, 0))
            else:
                out.append(slice(int(starts[int(k)]), int(ends[int(k)])))
        return tuple(out)

    def get_tile_size(self, key) -> Tuple[int, ...]:
        """The shape of the tiles ``key`` selects."""
        return tuple(s.stop - s.start for s in self.__tile_slices(key))

    def __getitem__(self, key) -> DNDarray:
        return self.__arr[self.__tile_slices(key)]

    def __setitem__(self, key, value) -> None:
        self.__arr[self.__tile_slices(key)] = value


class SquareDiagTiles:
    """Tiles square along the diagonal, ``tiles_per_proc`` of them on each
    device's slab of the split axis (reference tiling.py:132): the row
    boundaries equal the column boundaries up to the diagonal's end."""

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2):
        if not isinstance(tiles_per_proc, int) or tiles_per_proc < 1:
            raise ValueError(f"tiles_per_proc must be a positive int, got {tiles_per_proc}")
        if arr.ndim != 2:
            raise ValueError(f"arr must be 2D, got {arr.ndim}D")
        self.__arr = arr
        m, k = arr.gshape
        split = arr.split if arr.split is not None else 0
        slab_sizes = _axis_tile_sizes(arr.gshape[split], arr.comm.size)
        bounds: List[int] = [0]
        for size in slab_sizes:
            for t in _axis_tile_sizes(int(size), tiles_per_proc):
                if t > 0:
                    bounds.append(bounds[-1] + int(t))
        split_inds = sorted(set(bounds))[:-1]
        other = [b for b in split_inds if b < min(m, k) and b < arr.gshape[1 - split]]
        self.__row_inds, self.__col_inds = (split_inds, other) if split == 0 else (other, split_inds)
        self.__tiles_per_proc = tiles_per_proc
        self.__split = split
        self.__slab_starts = np.cumsum(np.concatenate(([0], slab_sizes)))[:-1]
        self.__rebuild_maps()

    def __rebuild_maps(self) -> None:
        """tile_map and last_diagonal_process from the boundaries."""
        m, k = self.__arr.gshape

        def owner(start: int) -> int:
            return int(np.searchsorted(self.__slab_starts, start, side="right") - 1)

        rows, cols = self.__row_inds + [m], self.__col_inds + [k]
        self.__tile_map = np.zeros((len(self.__row_inds), len(self.__col_inds), 3), dtype=np.int64)
        for i in range(len(self.__row_inds)):
            for j in range(len(self.__col_inds)):
                self.__tile_map[i, j] = (rows[i], cols[j], owner(rows[i] if self.__split == 0 else cols[j]))
        self.__last_diag_pr = owner(min(m, k) - 1)

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def col_indices(self) -> List[int]:
        return list(self.__col_inds)

    @property
    def row_indices(self) -> List[int]:
        return list(self.__row_inds)

    @property
    def lshape_map(self) -> np.ndarray:
        return self.__arr.comm.lshape_map(self.__arr.gshape, self.__arr.split)

    @property
    def last_diagonal_process(self) -> int:
        return self.__last_diag_pr

    @property
    def tile_columns(self) -> int:
        return len(self.__col_inds)

    @property
    def tile_rows(self) -> int:
        return len(self.__row_inds)

    @property
    def tile_columns_per_process(self) -> List[int]:
        if self.__arr.split != 1:
            return [self.tile_columns] * self.__arr.comm.size
        return [int(c) for c in np.bincount(self.__tile_map[0, :, 2], minlength=self.__arr.comm.size)]

    @property
    def tile_rows_per_process(self) -> List[int]:
        if self.__arr.split not in (0, None):
            return [self.tile_rows] * self.__arr.comm.size
        return [int(c) for c in np.bincount(self.__tile_map[:, 0, 2], minlength=self.__arr.comm.size)]

    @property
    def tile_map(self) -> np.ndarray:
        return self.__tile_map

    @property
    def tiles_per_proc(self) -> int:
        return self.__tiles_per_proc

    def get_start_stop(self, key) -> Tuple[int, int, int, int]:
        """Global (row start, row stop, column start, column stop) of the
        tiles at ``key``."""
        rs, cs = self.__key_to_slices(key)
        return rs.start, rs.stop, cs.start, cs.stop

    def __key_to_slices(self, key) -> Tuple[slice, slice]:
        if not isinstance(key, tuple):
            key = (key, slice(None))

        def resolve(k, bounds):
            if isinstance(k, slice):
                idx = range(*k.indices(len(bounds) - 1))
                return slice(bounds[idx[0]], bounds[idx[-1] + 1]) if len(idx) else slice(0, 0)
            return slice(bounds[int(k)], bounds[int(k) + 1])

        m, k = self.__arr.gshape
        return resolve(key[0], self.__row_inds + [m]), resolve(key[1], self.__col_inds + [k])

    def __getitem__(self, key) -> DNDarray:
        return self.__arr[self.__key_to_slices(key)]

    def __setitem__(self, key, value) -> None:
        self.__arr[self.__key_to_slices(key)] = value

    def local_get(self, key) -> DNDarray:
        """Every tile is addressable with one controller: ``self[key]``."""
        return self[key]

    def local_set(self, key, value) -> None:
        """``self[key] = value``."""
        self[key] = value

    def local_to_global(self, key, rank: Optional[int] = None):
        """The identity: keys are global already."""
        return key

    def match_tiles(self, tiles_to_match: "SquareDiagTiles") -> None:
        """Take another decomposition's boundaries, so that tile keys agree
        between the two arrays."""
        self.__row_inds = [b for b in tiles_to_match.row_indices if b < self.__arr.gshape[0]]
        self.__col_inds = [b for b in tiles_to_match.col_indices if b < self.__arr.gshape[1]]
        self.__rebuild_maps()
