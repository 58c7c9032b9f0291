"""Build the CUDA sources under ``heat_tpu_torch/csrc`` and the host C++
sources under ``heat_tpu_torch/_native`` into shared libraries.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, compiled by
``nvcc`` for ``sm_90a`` with a plain C interface and loaded with ``ctypes``;
the compiler's report (``ptxas -v``: registers, shared memory and spills of
each kernel) is kept beside it as ``<name>-<hash>.log``.
The hash of the source names the library, so an edited source is rebuilt.
Nothing is built when the package is imported: a kernel's wrapper calls
:func:`library` at its first launch, and :func:`build` compiles several
sources at once, one ``nvcc`` process each. :func:`build_host` compiles
host C++ with ``g++`` the same way. A failed build raises. Every library is
compiled under a name of its own process and moved into place with
``os.replace``, so processes that build at once (test workers) never load
a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

__all__ = ["build", "build_host", "build_log", "library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

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
            targets[name].with_suffix(".log").write_text(output)
            os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def build_log(name: str) -> str:
    """The compiler's report of the current build of ``csrc/<name>.cu``
    (empty when the library was built without one)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def gxx() -> str:
    """The host C++ compiler: ``$CXX`` or ``g++`` on the path; raises
    ``RuntimeError`` when there is none."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found:
        return found
    raise RuntimeError("g++ not found: the native host code is built with the image's C++ compiler")


def build_host(name: str, sources: Sequence[Path]) -> Path:
    """Compile host C++ ``sources`` with ``g++`` into
    ``_build/lib<name>-<hash>.so`` (the hash of every source), unless it is
    built already; return its path. Raises ``RuntimeError`` with the
    compiler's output if the build fails."""
    digest = hashlib.sha256(b"".join(Path(src).read_bytes() for src in sources)).hexdigest()[:16]
    target = BUILD_DIR / f"lib{name}-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [gxx(), *GXX_FLAGS, *(str(s) for s in sources), "-o", str(tmp), "-lpthread"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return target
