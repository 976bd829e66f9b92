"""Build-at-first-use loader for the C++ host helpers in ``native/``.

The shared libraries are not kept in git: each one is compiled from its
committed source into ``native/build/`` the first time it is loaded on a
host (or ahead of time with ``make -C native``), and again
whenever its source is newer than the built file.  The build writes to a
temporary file in the same directory and renames it into place, so
concurrent processes (test workers) never load a half-written library.
No ``-march=native``: the library must run on any x86-64 host that loads
it.

A host without a C++ compiler gets ``None`` from ``load`` and callers fall
back to their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from typing import Optional

NATIVE_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "..",
                                           "..", "native"))
BUILD_DIR = os.path.join(NATIVE_DIR, "build")

# library name -> (source file, extra link flags)
LIBRARIES = {
    "bvh_builder": ("bvh_builder.cpp", ()),
    "display": ("display.cpp", ("-lz",)),
}
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra")

_loaded: dict = {}


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(name: str) -> str:
    """Compile ``name`` from source; returns the library path.

    Raises ``OSError`` when no compiler is found and
    ``subprocess.CalledProcessError`` when compilation fails."""
    src, ldflags = LIBRARIES[name]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(name)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp,
               os.path.join(NATIVE_DIR, src), *ldflags]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _stale(name: str) -> bool:
    out = library_path(name)
    src = os.path.join(NATIVE_DIR, LIBRARIES[name][0])
    return (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src))


def load(name: str) -> Optional[ctypes.CDLL]:
    """The ``ctypes`` handle of library ``name``, building it if needed;
    ``None`` when it cannot be built on this host."""
    if name in _loaded:
        return _loaded[name]
    lib = None
    try:
        if _stale(name):
            build(name)
        lib = ctypes.CDLL(library_path(name))
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        print(f"spt_tpu: native library {name!r} unavailable: {detail}",
              file=sys.stderr)
    _loaded[name] = lib
    return lib

