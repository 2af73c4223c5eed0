"""Build and load the native OBJ reader (ctypes ABI, no pybind11).

``native/objio.cpp`` is compiled on first use with ``g++ -O3`` into this
package's ``_build/`` directory, under a name keyed by a hash of the source
and flags (``native/`` itself is never written), and bound as the JAX
package's ``wcsph_tpu/utils/native.py`` binds it.  ``load()`` returns None
where the source or the toolchain is missing; ``objio.load_obj`` then
parses in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "objio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libwcsph_objio_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile into a file of this process, then move it into place (a
    second process building at once replaces it with the same bytes)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not SRC.is_file():
            _failed = True
            return None
        path = _library_path()
        if not path.is_file() and not _build(path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _failed = True
            return None
        lib.obj_parse.restype = ctypes.c_int
        lib.obj_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
