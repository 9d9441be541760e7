"""Build-at-first-use for the port's native (C++) components — port of
pathway_tpu/native/build.py.

Each source ``pathway_tpu_torch/native/<name>.cpp`` is compiled with the
system's ``g++`` into ``pathway_tpu_torch/_build/``, named by the hash of
the source so an edit rebuilds, and renamed into place atomically so
racing processes are safe.
The ABI is plain C consumed through ctypes, or, with ``python_api=True``,
a CPython extension module. Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str, python_api: bool = False) -> str:
    """Where ``native/<name>.cpp``'s library is (or will be) built: its
    name carries the source's hash, and for a CPython extension the
    interpreter's ABI tag."""
    with open(os.path.join(_SRC_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    if python_api:
        # an extension built under one interpreter version must not be
        # dlopen'd by another
        digest = f"{digest}-{sys.implementation.cache_tag}"
    return os.path.join(_BUILD_DIR, f"{name}-{digest}.so")


def ensure_built(name: str, python_api: bool = False) -> str:
    """Compile ``native/<name>.cpp`` unless its library is built; return
    the library's path. ``python_api=True`` builds a CPython extension
    (the source defines ``PyInit_torch_<name>``)."""
    out = library_path(name, python_api)
    if os.path.exists(out):
        return out
    with _LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC"]
        if python_api:
            cmd.append(f"-I{sysconfig.get_paths()['include']}")
        cmd += [os.path.join(_SRC_DIR, f"{name}.cpp"), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:  # no compiler on PATH
            raise NativeBuildError(
                f"native build failed for {name}: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed for {name}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent processes race safely
        return out


# a port extension's module name: the JAX package builds its own
# ``fastjoin`` / ``fastgroup`` from sources of the same name, and a process
# that loads both packages' passes (the parity tests do) must get each
# package its own module
EXTENSION_PREFIX = "torch_"


def load_extension(name: str):
    """Build and import a CPython extension module from
    ``native/<name>.cpp``, whose module is ``torch_<name>`` (the source
    defines ``PyInit_torch_<name>``)."""
    import importlib.machinery
    import importlib.util

    path = ensure_built(name, python_api=True)
    module = EXTENSION_PREFIX + name
    loader = importlib.machinery.ExtensionFileLoader(module, path)
    spec = importlib.util.spec_from_file_location(module, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod
