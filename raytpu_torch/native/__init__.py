"""Native (C++) host runtime: ASCII STL parsing and BMP IO (counterpart of
raytpu/native/__init__.py).

The source, src/raytpu_native.cpp, is a copy of the JAX package's. At first
use it is compiled with g++ into ``build/raytpu_torch/`` beside the
package, named by a hash of the source and flags, and loaded with ctypes.
Nothing is built at import. Where g++ or the build fails, ``available()``
says False and the callers take the python versions in raytpu_torch.core,
as the JAX package does: this is host I/O, not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "raytpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raytpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256("\0".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"raytpu_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: no process ever loads half a file
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.raytpu_parse_stl.restype = ctypes.c_int
        lib.raytpu_parse_stl.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.raytpu_write_bmp.restype = ctypes.c_int
        lib.raytpu_write_bmp.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                         ctypes.c_int]
        lib.raytpu_read_bmp.restype = ctypes.c_int
        lib.raytpu_read_bmp.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                        intp, intp]
        _lib = lib
        return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def available() -> bool:
    """Whether the library built and loaded."""
    return _load() is not None


def parse_stl(path: str) -> np.ndarray:
    """ASCII STL -> (T, 3, 3) float32 vertices. Raises FileNotFoundError
    for a missing file and ValueError for one without facets or with a
    malformed vertex line."""
    lib = _require()
    cap = 16384
    while True:  # the parser returns the file's count; grow and re-run
        buf = np.empty((cap, 9), np.float32)
        n = lib.raytpu_parse_stl(
            os.fsencode(path),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
        if n == -1:
            raise FileNotFoundError(path)
        if n == -2:
            raise ValueError(f"{path}: STL parse error")
        if n == 0:
            raise ValueError(f"{path}: no facets found")
        if n <= cap:
            return buf[:n].reshape(n, 3, 3).copy()
        cap = n


def write_bmp(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as a 24-bpp bottom-up BMP."""
    lib = _require()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    rc = lib.raytpu_write_bmp(os.fsencode(path),
                              rgb.ctypes.data_as(ctypes.POINTER(
                                  ctypes.c_uint8)), w, h)
    if rc != 0:
        raise IOError(f"native BMP write failed ({rc}): {path}")


def read_bmp(path: str) -> np.ndarray:
    """An uncompressed 24- or 32-bpp BMP as (H, W, 3) uint8 RGB."""
    lib = _require()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.raytpu_read_bmp(os.fsencode(path), None, 0, ctypes.byref(w),
                             ctypes.byref(h))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"{path}: unsupported BMP")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.raytpu_read_bmp(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"native BMP read failed ({rc}): {path}")
    return out
