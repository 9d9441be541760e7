"""Build-at-first-use for the port's CUDA kernels.

Each kernel source ``ops/csrc/<name>.cu`` exposes a plain C interface. It
is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``pathway_tpu_torch/_build/``, named by the hash of the source and of
the headers it includes (``#include "x.cuh"``, from ``ops/csrc/``) so an
edit to either rebuilds, and loaded with ``ctypes``. Nothing here runs at import: a module
that holds a kernel creates its :class:`CudaLibrary` object, and the first
launch builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


class KernelBuildError(RuntimeError):
    pass


# every launch count of the port's kernels, in creation order: a CUDA
# graph's replay adds to each what the graph's capture counted
# (ops/knn.py GraphedIngestStep)
LAUNCH_COUNTS: list = []


class LaunchCount:
    """Launches of one kernel: incremented by its wrapper where it
    launches the kernel, and nowhere else (a replay of a captured graph
    adds the launches its capture made); a caller may reset it to 0."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        LAUNCH_COUNTS.append(self)


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): under
    ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``), else on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", name)
    if os.path.exists(path):
        return path
    found = shutil.which(name)
    if found is None:
        raise KernelBuildError(
            f"{name} not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are compiled on the machine with the card")
    return found


class CudaLibrary(LaunchCount):
    """One kernel source, its shared library and its launch count (for a
    source with one kernel).

    ``signatures`` maps each exported C function to ``(restype,
    argtypes)`` for ctypes."""

    def __init__(self, name: str, signatures: dict[str, tuple]):
        super().__init__(name)
        self.signatures = signatures
        self.source = os.path.join(_SRC_DIR, f"{name}.cu")
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def sources(self) -> list[str]:
        """The source and every header it includes with quotes, directly
        or through another header, each once, in include order."""
        seen: list[str] = []
        todo = [self.source]
        while todo:
            path = todo.pop(0)
            if path in seen:
                continue
            seen.append(path)
            with open(path, "rb") as f:
                text = f.read()
            todo += [os.path.join(os.path.dirname(path), m.decode())
                     for m in _LOCAL_INCLUDE.findall(text)]
        return seen

    def path(self) -> str:
        h = hashlib.sha256()
        for src in self.sources():
            with open(src, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _build(self) -> None:
        """Compile the source with ``nvcc`` unless its library is built."""
        out = self.path()
        if os.path.exists(out):
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp,
                               self.source],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed for {self.source}:\n{self.build_log}")
        os.replace(tmp, out)  # atomic: racing builders are safe

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    self._build()
                    lib = ctypes.CDLL(self.path())
                    for fn, (restype, argtypes) in self.signatures.items():
                        getattr(lib, fn).restype = restype
                        getattr(lib, fn).argtypes = argtypes
                    self._lib = lib
        return self._lib
