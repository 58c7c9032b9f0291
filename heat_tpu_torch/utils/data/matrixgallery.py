"""Test-matrix generators (reference: heat/utils/data/matrixgallery.py,
heat_tpu/utils/data/matrixgallery.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core import factories, types
from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["hermitian", "parter", "random_known_rank"]


def parter(n: int, split: Optional[int] = None, device=None, comm=None, dtype=types.float32) -> DNDarray:
    """The Parter matrix ``A[i, j] = 1 / (i - j + 0.5)``, a Cauchy matrix
    with singular values clustered at pi (reference matrixgallery.py:14-56)."""
    i = torch.arange(n, dtype=types.canonical_heat_type(dtype).torch_type())
    a = 1.0 / (i[:, None] - i[None, :] + 0.5)
    return factories.array(a, split=split, device=device, comm=comm, dtype=dtype)


def hermitian(
    n: int, split: Optional[int] = None, device=None, comm=None, dtype=types.complex64,
    positive_definite: bool = False,
) -> DNDarray:
    """A random Hermitian matrix (symmetric for a real ``dtype``), positive
    definite on request (reference matrixgallery.py:57-120)."""
    real = ht_random.randn(n, n, split=split, device=device, comm=comm)
    a = real.larray
    if types.heat_type_is_complexfloating(dtype):
        imag = ht_random.randn(n, n, split=split, device=device, comm=comm)
        a = torch.complex(a, imag.larray.to(a.device))
    if positive_definite:
        h = a @ a.T.conj() + n * torch.eye(n, dtype=a.dtype, device=a.device)
    else:
        h = 0.5 * (a + a.T.conj())
    return factories.array(h, split=split, device=device, comm=comm, dtype=dtype)


def random_known_rank(
    m: int, n: int, rank: int, split: Optional[int] = None, device=None, comm=None, dtype=types.float32
) -> Tuple[DNDarray, Tuple[DNDarray, DNDarray]]:
    """A random (m, n) matrix of rank ``rank`` and its factors ``(u, v)``,
    ``a = u vᵀ`` (reference matrixgallery.py:121-170)."""
    if rank > min(m, n):
        raise ValueError(f"rank must be <= min(m, n) = {min(m, n)}, got {rank}")
    u = ht_random.randn(m, rank, split=split, device=device, comm=comm)
    v = ht_random.randn(n, rank, device=device, comm=comm)
    a = u.larray @ v.larray.to(u.larray.device).T
    return factories.array(a, split=split, device=device, comm=comm, dtype=dtype), (u, v)
