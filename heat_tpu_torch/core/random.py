"""Random number generation on ``torch.Generator`` (reference:
heat/core/random.py, heat_tpu/core/random.py).

The JAX package folds a draw counter into a threefry key; torch has no
threefry, so the values differ from the JAX package's. The contract kept is
that of the reference:

* the same seed gives the same values at every mesh size: each draw is made
  whole, on the mesh's ``home`` device, by a generator seeded from
  (seed, counter), and only then cut into shards. Over a mesh whose ranks
  span processes every process makes the same draw and keeps its ranks'
  blocks, so the stream advances identically everywhere; an unset seed is
  process 0's, broadcast at the first such draw;
* ``get_state``/``set_state`` round-trip;
* the distributions are right (uniform, standard normal, uniform integers,
  permutations).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from .dndarray import DNDarray, _wrap
from .factories import _resolve
from .stride_tricks import sanitize_shape

__all__ = [
    "get_state",
    "normal",
    "permutation",
    "rand",
    "randint",
    "randn",
    "random",
    "random_integer",
    "random_sample",
    "randperm",
    "ranf",
    "sample",
    "seed",
    "set_state",
    "standard_normal",
    "uniform",
]

_ALGORITHM = "Torch"

# global generator state: (seed, counter) — reference random.py:39-43
__seed: Optional[int] = None
__counter: int = 0


def seed(new_seed: Optional[int] = None) -> None:
    """Seed the global generator (reference random.py:772-790); ``None``
    draws the seed from the operating system's entropy, as numpy does."""
    global __seed, __counter
    if new_seed is None:
        new_seed = int.from_bytes(os.urandom(4), "little") % (2**31)
    __seed = int(new_seed)
    __counter = 0


def get_state() -> Tuple[str, int, int, int, float]:
    """The state tuple ('Torch', seed, counter, 0, 0.0), in the reference's
    layout (reference random.py:203-219)."""
    if __seed is None:
        seed(None)
    return (_ALGORITHM, __seed, __counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    """Restore generator state (reference random.py:791-826)."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise TypeError("state needs to be a 3- or 5-tuple")
    if state[0] != _ALGORITHM:
        raise ValueError(f"algorithm must be {_ALGORITHM!r}")
    __seed = int(state[1])
    __counter = int(state[2])


def _next_generator(device: torch.device) -> torch.Generator:
    """A generator for the next draw on ``device``, seeded from (seed,
    counter): each draw's stream depends on nothing but those two numbers."""
    global __counter
    if __seed is None:
        seed(None)
    mixed = np.random.SeedSequence([__seed, __counter]).generate_state(2, np.uint32)
    __counter += 1
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed[0]) << 31 | int(mixed[1]) >> 1)
    return gen


def _shape(d) -> Tuple[int, ...]:
    if len(d) == 1 and isinstance(d[0], (tuple, list)):
        return sanitize_shape(d[0])
    return sanitize_shape(d)


def _float_dtype(dtype):
    dtype = types.float32 if dtype is None else types.canonical_heat_type(dtype)
    if dtype not in (types.float32, types.float64, types.bfloat16):
        raise ValueError(f"Unsupported dtype {dtype} for random floats")
    return dtype


def _agree_on_seed(comm) -> None:
    """Give every process of a spanning mesh process 0's seed when none is
    set: every process draws the same stream."""
    global __seed
    if __seed is None and comm.spans_processes:
        seed(None)
        mine = torch.tensor([__seed], dtype=torch.int64, device=comm.home)
        __seed = int(comm.bcast([mine] * len(comm.local_devices), root=0)[0].item())


def _draw(sampler, shape, dtype, split, device, comm) -> DNDarray:
    device, comm = _resolve(device, comm)
    _agree_on_seed(comm)
    first = comm.home
    t = sampler(shape, generator=_next_generator(first), dtype=dtype, device=first)
    return _wrap(t, split if shape else None, device, comm)


def rand(*d, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1) (reference random.py:268-319)."""
    dtype = _float_dtype(dtype).torch_type()
    return _draw(torch.rand, _shape(d), dtype, split, device, comm)


def randn(*d, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples (reference random.py:422-477)."""
    dtype = _float_dtype(dtype).torch_type()
    return _draw(torch.randn, _shape(d), dtype, split, device, comm)


def randint(
    low: int, high: Optional[int] = None, size=None, dtype=None, split=None, device=None, comm=None
) -> DNDarray:
    """Uniform integers in [low, high) (reference random.py:320-421)."""
    if high is None:
        low, high = 0, low
    if high <= low:
        raise ValueError("low >= high")
    shape = sanitize_shape(() if size is None else size)
    dtype = types.int32 if dtype is None else types.canonical_heat_type(dtype)
    if not types.heat_type_is_exact(dtype):
        raise ValueError("Unsupported dtype for randint")

    def sampler(shape, generator, dtype, device):
        return torch.randint(int(low), int(high), shape, generator=generator, dtype=dtype, device=device)

    return _draw(sampler, shape, dtype.torch_type(), split, device, comm)


random_integer = randint


def standard_normal(shape=None, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples (reference random.py:179)."""
    return randn(*sanitize_shape(() if shape is None else shape), dtype=dtype, split=split, device=device, comm=comm)


def normal(mean=0.0, std=1.0, shape=None, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Normal samples, ``standard_normal * std + mean`` (reference
    random.py:186); ``mean`` and ``std`` may be arrays."""
    base = standard_normal(shape, dtype, split, device, comm)
    first = base.comm.home
    mean = mean.larray.to(first) if isinstance(mean, DNDarray) else mean
    std = std.larray.to(first) if isinstance(std, DNDarray) else std
    t = base.larray * std + mean
    return _wrap(t, split if t.ndim else None, base.device, base.comm)


def random(shape=None, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1), numpy's name (reference random.py:197)."""
    return rand(*sanitize_shape(() if shape is None else shape), dtype=dtype, split=split, device=device, comm=comm)


random_sample = random
ranf = random
sample = random


def uniform(low=0.0, high=1.0, size=None, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [low, high) (reference random.py:209)."""
    shape = sanitize_shape(() if size is None else size)
    dtype = _float_dtype(dtype).torch_type()

    def sampler(shape, generator, dtype, device):
        return torch.empty(shape, dtype=dtype, device=device).uniform_(float(low), float(high), generator=generator)

    return _draw(sampler, shape, dtype, split, device, comm)


def _permuted(n: int, dtype, split, device, comm) -> DNDarray:
    def sampler(shape, generator, dtype, device):
        return torch.randperm(shape[0], generator=generator, dtype=dtype, device=device)

    return _draw(sampler, (n,), dtype, split, device, comm)


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``range(x)`` for an int, else ``x`` with its
    first axis shuffled (reference random.py:221)."""
    if isinstance(x, (int, np.integer)):
        return _permuted(int(x), torch.int64, split, device, comm)
    if isinstance(x, DNDarray):
        order = _permuted(x.gshape[0], torch.int64, None, device or x.device, comm or x.comm)
        t = x.larray[order.larray.to(x.larray.device)]
        return _wrap(t, x.split if split is None else split, order.device, order.comm)
    raise TypeError(f"x must be int or DNDarray, but was {type(x)}")


def randperm(n: int, dtype=types.int64, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``range(n)`` (reference random.py:233)."""
    if not isinstance(n, (int, np.integer)):
        raise TypeError(f"n must be an integer, got {type(n)}")
    return _permuted(int(n), types.canonical_heat_type(dtype).torch_type(), split, device, comm)
