"""ctypes binding of the native decode core (the repo root's
``native/decode.cpp``): a host JPEG / PNG decoder with a Pillow-exact
BICUBIC resize, not a device kernel.

On first use the source is compiled with ``native/Makefile``'s flags into
the port's git-ignored ``_build/libcqvad_decode-<hash>.so`` (the hash
covers the source and the flags); nothing is written into ``native/``.
Where ``g++``, libjpeg or libpng is missing every function returns None and
the datasets decode with PIL instead, as the JAX package's binding does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ["-O3", "-march=native", "-funroll-loops", "-fPIC", "-std=c++17",
            "-Wall"]
LDFLAGS = ["-shared", "-ljpeg", "-lpng", "-lpthread"]
_lib = None
_tried = False


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return BUILD_DIR / f"libcqvad_decode-{h.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(
        [os.environ.get("CXX", "g++"), *CXXFLAGS, str(SOURCE), "-o", str(tmp),
         *LDFLAGS], check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)     # atomic: a concurrent build never sees half a file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SOURCE.exists() or shutil.which(os.environ.get("CXX", "g++")) is None:
        return None
    path = lib_path()
    if not path.exists():
        try:
            _build(path)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                OSError):
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cq_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, u8p]
    lib.cq_decode_resize.restype = ctypes.c_int
    lib.cq_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    u8p, ctypes.c_int]
    lib.cq_decode_batch.restype = ctypes.c_int
    lib.cq_resize.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                              ctypes.c_int, ctypes.c_int]
    lib.cq_resize.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_resize(path: str, out_w: int, out_h: int) -> Optional[np.ndarray]:
    """Decode one JPEG / PNG and bicubic-resize it to (out_h, out_w) RGB
    uint8; None if the library is unavailable or the decode fails."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.cq_decode_resize(path.encode(), out_w, out_h, _u8(out))
    return out if rc == 0 else None


def decode_batch(paths: List[str], out_w: int, out_h: int,
                 n_threads: int = 8) -> Optional[np.ndarray]:
    """Threaded decode of ``paths`` -> [N, out_h, out_w, 3] uint8 (None on
    failure)."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.cq_decode_batch(arr, n, out_w, out_h, _u8(out), n_threads)
    return out if rc == 0 else None


def resize(img: np.ndarray, out_w: int, out_h: int) -> Optional[np.ndarray]:
    """Pillow-BICUBIC-exact resize of an RGB uint8 array."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.cq_resize(_u8(img), img.shape[0], img.shape[1], _u8(out),
                       out_h, out_w)
    return out if rc == 0 else None
