"""Build and load the host storage library in ``storage/csrc``.

``csrc/rbf.cc`` becomes one shared library with a plain C interface,
compiled by ``g++`` at first use and loaded with ``ctypes``.  The build
lands in ``build/torch_host/<hash>/`` under the repository root (listed
in ``.gitignore``); the hash covers the sources and the flags, so an
edited source rebuilds and an unchanged one is reused.  A lock file in
that directory lets one process build while others wait (the test
workers import the library at once), and the finished library is
renamed into place, so no loader ever sees half a file.  A failed build
raises with g++'s output: there is no other storage path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _sources() -> list[Path]:
    return sorted([*_CSRC.glob("*.cc"), *_CSRC.glob("*.h")])


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _ROOT / "build" / "torch_host" / h.hexdigest()[:16]


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the storage library needs a C++ "
                           "compiler on PATH")
    return found


def build(name: str) -> Path:
    """The path of ``lib<name>.so`` built from ``csrc/<name>.cc``,
    compiling it if it is missing."""
    out = build_dir()
    so = out / f"lib{name}.so"
    if so.exists():
        return so
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():                 # another process built it
            return so
        tmp = out / f".lib{name}.{os.getpid()}.so"
        proc = subprocess.run(
            [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cc")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building lib{name}.so:\n"
                               + proc.stdout.decode(errors="replace"))
        os.replace(tmp, so)
    return so


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cc``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
