"""Native host runtime: C++ helpers built with ``g++`` at first use and
loaded with ctypes. The counterpart of ``txr/_native``, with its own copy of
the source (``txr_native.cpp``) and its own library name, so that the port
never loads ``txr``'s.

Importing this module builds nothing: ``get_lib`` compiles the library the
first time a caller needs it. When no compiler is available the callers
fall back to numpy (and ``cv2`` for the codecs), as ``txr``'s do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "txr_native.cpp")
_NAME = "libtxr_torch_native.so"
_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    """Where the compiled library lives (or is built): the package directory
    when it holds the library or is writable, else a user cache directory
    (a read-only install would otherwise retry the build in every process
    and drop to the fallbacks)."""
    in_pkg = os.path.join(_DIR, _NAME)
    if os.path.exists(in_pkg) or os.access(_DIR, os.W_OK):
        return in_pkg
    cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.join(os.path.expanduser("~"), ".cache")),
        "txr_torch")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, _NAME)


def _build(path: str) -> bool:
    """Compile into a temporary file beside ``path`` and rename it into
    place: processes that build at the same moment (test workers) each
    rename a whole library, so none ever loads a half-written one."""
    jpeg = ["-DTXR_HAVE_JPEG", "-ljpeg"]
    png = ["-DTXR_HAVE_PNG", "-lpng"]
    variants = [jpeg + png,   # full host codecs
                jpeg,         # no libpng dev files
                png,          # no libjpeg dev files
                []]           # neither present
    fd, tmp = tempfile.mkstemp(prefix=_NAME + ".", suffix=".tmp",
                               dir=os.path.dirname(path))
    os.close(fd)
    try:
        for extra in variants:
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
                   _SRC] + extra
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
            except (subprocess.CalledProcessError, FileNotFoundError,
                    subprocess.TimeoutExpired):
                continue
            os.replace(tmp, path)
            return True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded native library, building it on first use; None if it
    cannot be built (no compiler)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) or (
                os.path.getmtime(path) < os.path.getmtime(_SRC)):
            if not _build(path):
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            # a library built on another machine (a copied tree) may link
            # codec libraries this one lacks: build it here and load again
            if not _build(path):
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                return None
        lib.txr_write_ply.restype = ctypes.c_int
        lib.txr_write_ply.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.txr_pack_xyzrgb.restype = ctypes.c_int
        lib.txr_pack_xyzrgb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.txr_compact_points.restype = ctypes.c_int64
        lib.txr_compact_points.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.txr_has_jpeg.restype = ctypes.c_int
        lib.txr_has_jpeg.argtypes = []
        lib.txr_has_png.restype = ctypes.c_int
        lib.txr_has_png.argtypes = []
        if lib.txr_has_png():
            lib.txr_png16_dims.restype = ctypes.c_int
            lib.txr_png16_dims.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.txr_decode_png16.restype = ctypes.c_int
            lib.txr_decode_png16.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int]
            lib.txr_encode_png16.restype = ctypes.c_int64
            lib.txr_encode_png16.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64]
        if lib.txr_has_jpeg():
            lib.txr_jpeg_dims.restype = ctypes.c_int
            lib.txr_jpeg_dims.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.txr_decode_jpeg.restype = ctypes.c_int
            lib.txr_decode_jpeg.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def codecs() -> dict:
    """Which host codecs the built library has (both False without one)."""
    lib = get_lib()
    return {"jpeg": bool(lib is not None and lib.txr_has_jpeg()),
            "png": bool(lib is not None and lib.txr_has_png())}


def native_decode_jpeg(data: bytes) -> np.ndarray | None:
    """Decode a JPEG byte string to a BGR uint8 array with libjpeg. None when
    the native decoder is unavailable or the stream is not a decodable
    baseline JPEG (the caller falls back to cv2). The array is allocated
    anew per call: consumers hold frames for an unbounded time."""
    lib = get_lib()
    if lib is None or not lib.txr_has_jpeg():
        return None
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    if lib.txr_jpeg_dims(buf.ctypes.data_as(ctypes.c_void_p), buf.size,
                         ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.txr_decode_jpeg(buf.ctypes.data_as(ctypes.c_void_p), buf.size,
                             out.ctypes.data_as(ctypes.c_void_p),
                             w.value, h.value)
    if rc != 0:
        return None
    return out


def native_decode_png16(data: bytes) -> np.ndarray | None:
    """Decode a 16-bit single-channel PNG byte string to a uint16 (h, w)
    array with libpng. None when the native decoder is unavailable or the
    stream is not a 16-bit grayscale PNG (the caller falls back to cv2)."""
    lib = get_lib()
    if lib is None or not lib.txr_has_png():
        return None
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    bd = ctypes.c_int()
    ch = ctypes.c_int()
    if lib.txr_png16_dims(buf.ctypes.data_as(ctypes.c_void_p), buf.size,
                          ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(bd), ctypes.byref(ch)) != 0:
        return None
    if bd.value != 16 or ch.value != 1:
        return None
    out = np.empty((h.value, w.value), np.uint16)
    rc = lib.txr_decode_png16(buf.ctypes.data_as(ctypes.c_void_p), buf.size,
                              out.ctypes.data_as(ctypes.c_void_p),
                              w.value, h.value)
    if rc != 0:
        return None
    return out


def native_encode_png16(img: np.ndarray) -> bytes | None:
    """Encode a uint16 (h, w) array as a 16-bit grayscale PNG byte string.
    None when the native encoder is unavailable (the caller falls back to
    cv2). Lossless, so pixels equal cv2's both ways."""
    lib = get_lib()
    if lib is None or not lib.txr_has_png():
        return None
    img = np.ascontiguousarray(img, dtype=np.uint16)
    h, w = img.shape
    # Raw size + headroom covers any compressible input; incompressible
    # inputs report the true size and are encoded once more.
    cap = img.nbytes + 4096
    out = np.empty(cap, np.uint8)
    n = lib.txr_encode_png16(img.ctypes.data_as(ctypes.c_void_p), w, h,
                             out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    if n > cap:
        cap = int(n)
        out = np.empty(cap, np.uint8)
        n = lib.txr_encode_png16(img.ctypes.data_as(ctypes.c_void_p), w, h,
                                 out.ctypes.data_as(ctypes.c_void_p), cap)
        if n < 0 or n > cap:
            return None
    return out[:n].tobytes()


def native_write_ply(path: str, xyz: np.ndarray,
                     rgb: np.ndarray | None) -> bool:
    """Write float32-xyz (+ uchar rgb) binary PLY natively. False when the
    native library is unavailable (the caller falls back)."""
    lib = get_lib()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    rgb_ptr = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, dtype=np.float32)
        if rgb.size and rgb.max() > 1.5:  # tolerate 0..255 input
            rgb = rgb / 255.0
        rgb_ptr = rgb.ctypes.data_as(ctypes.c_void_p)
    rc = lib.txr_write_ply(
        path.encode(), xyz.ctypes.data_as(ctypes.c_void_p), rgb_ptr,
        xyz.shape[0])
    return rc == 0


def native_pack_xyzrgb(xyz: np.ndarray,
                       rgb: np.ndarray | None) -> bytes | None:
    """PointCloud2 XYZ(RGB) records (16 bytes with colour, 12 without), or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    rec = 16 if rgb is not None else 12
    out = np.empty(n * rec, np.uint8)
    rgb_ptr = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, dtype=np.float32)
        rgb_ptr = rgb.ctypes.data_as(ctypes.c_void_p)
    lib.txr_pack_xyzrgb(xyz.ctypes.data_as(ctypes.c_void_p), rgb_ptr, n,
                        out.ctypes.data_as(ctypes.c_void_p))
    return out.tobytes()


def native_compact(xyz: np.ndarray, rgb: np.ndarray | None,
                   mask: np.ndarray):
    """Masked compaction -> (dense_xyz, dense_rgb or None), or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    n = xyz.shape[0]
    out_xyz = np.empty_like(xyz)
    out_rgb = None
    rgb_ptr = out_rgb_ptr = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, dtype=np.float32)
        out_rgb = np.empty_like(rgb)
        rgb_ptr = rgb.ctypes.data_as(ctypes.c_void_p)
        out_rgb_ptr = out_rgb.ctypes.data_as(ctypes.c_void_p)
    m = lib.txr_compact_points(
        xyz.ctypes.data_as(ctypes.c_void_p), rgb_ptr,
        mask.ctypes.data_as(ctypes.c_void_p), n,
        out_xyz.ctypes.data_as(ctypes.c_void_p), out_rgb_ptr)
    return (out_xyz[:m], out_rgb[:m] if out_rgb is not None else None)
