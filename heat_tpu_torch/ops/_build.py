"""Build the CUDA sources under ``heat_tpu_torch/csrc`` into shared libraries.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, compiled by
``nvcc`` for ``sm_90a`` with a plain C interface and loaded with ``ctypes``.
The hash of the source names the library, so an edited source is rebuilt.
Nothing is built when the package is imported: a kernel's wrapper calls
:func:`library` at its first launch, and :func:`build` compiles several
sources at once, one ``nvcc`` process each. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build", "library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")


def _target(name: str) -> Path:
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes at once; return each library's path. Raises ``RuntimeError``
    with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    running = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
        running[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in running.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{output}")
        else:
            os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
