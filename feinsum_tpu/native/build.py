"""
Build + load the first-party native components (C++ via g++, loaded with
ctypes).  No pybind11: the C ABI is tiny (ints in, ints out) and numpy arrays
pass as raw pointers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIBS: dict = {}


def _cache_dir() -> Path:
    d = _HERE / "_build"
    d.mkdir(parents=True, exist_ok=True)
    return d


def build_and_load(source_name: str) -> ctypes.CDLL:
    """Compile ``native/<source_name>`` into a cached shared object and load
    it.  The cache key is the source hash, so edits trigger rebuilds."""
    with _LOCK:
        if source_name in _LIBS:
            return _LIBS[source_name]
        src = _HERE / source_name
        code = src.read_bytes()
        tag = hashlib.sha256(code).hexdigest()[:16]
        so_path = _cache_dir() / f"{src.stem}-{tag}.so"
        if not so_path.exists():
            tmp = so_path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                   str(src), "-o", str(tmp)]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        _LIBS[source_name] = lib
        return lib


def load_canon():
    """Load the canonical-labeling core; returns None if unbuildable (callers
    fall back to the pure-Python implementation)."""
    try:
        lib = build_and_load("canon.cpp")
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.fe_canonical_labeling.restype = ctypes.c_int
    lib.fe_canonical_labeling.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib
