"""ctypes bindings for the native C++ data-path core (native/image_pipe.cpp).

The port's own copy of `hybrid_diffusion_tpu/data/native.py` (:1-211),
over the same library: `native/libimage_pipe.so`, built with `make -C
native` at first use (git-ignored, so a clean checkout builds it). Every
entry point has a numpy fallback, so the package works without a
toolchain; the numpy bilinear resize (`_numpy_resize`) gives the library's
bytes. `batch_resize` is the hot call: one C invocation resizes a whole
decoded batch into a contiguous NHWC uint8 buffer with a std::thread pool.
This is host-side data code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libimage_pipe.so"))
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

BILINEAR, NEAREST = 0, 1


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", os.path.abspath(_NATIVE_DIR)],
            check=True, capture_output=True, timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load_library(require: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_failed and not require:
            return None
        if not os.path.exists(_LIB_PATH) and not _build():
            _lib_failed = True
            if require:
                raise RuntimeError("could not build native/libimage_pipe.so")
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.hdt_version.restype = ctypes.c_int
        lib.hdt_resize_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.hdt_batch_resize_u8.argtypes = [
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.hdt_decode_supported.restype = ctypes.c_int
        lib.hdt_decode_info.restype = ctypes.c_int
        lib.hdt_decode_info.argtypes = [
            u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.hdt_decode_u8.restype = ctypes.c_int
        lib.hdt_decode_u8.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int, ctypes.c_int]
        lib.hdt_batch_decode_resize_u8.argtypes = [
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return lib


def native_available() -> bool:
    return load_library() is not None


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize(img: np.ndarray, size: tuple[int, int],
           mode: int = BILINEAR) -> np.ndarray:
    """Resize one HWC uint8 image to (out_h, out_w)."""
    assert img.dtype == np.uint8 and img.ndim == 3
    oh, ow = size
    lib = load_library()
    if lib is None:
        return _numpy_resize(img, oh, ow, mode)
    img = np.ascontiguousarray(img)
    out = np.empty((oh, ow, img.shape[2]), np.uint8)
    lib.hdt_resize_u8(_as_u8p(img), img.shape[0], img.shape[1],
                      img.shape[2], _as_u8p(out), oh, ow, mode)
    return out


def batch_resize(images: Sequence[np.ndarray], size: tuple[int, int],
                 mode: int = BILINEAR, threads: int = 0) -> np.ndarray:
    """Resize N HWC uint8 images into one (N, out_h, out_w, C) batch."""
    oh, ow = size
    n = len(images)
    c = images[0].shape[2]
    lib = load_library()
    if lib is None:
        return np.stack([_numpy_resize(im, oh, ow, mode) for im in images])
    imgs = [np.ascontiguousarray(im) for im in images]
    out = np.empty((n, oh, ow, c), np.uint8)
    srcs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_as_u8p(im) for im in imgs])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in imgs])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in imgs])
    lib.hdt_batch_resize_u8(srcs, hs, ws, n, c, _as_u8p(out), oh, ow,
                            mode, threads)
    return out


def _numpy_resize(img: np.ndarray, oh: int, ow: int, mode: int) -> np.ndarray:
    """Pure-numpy twin of the C++ resize, bit for bit: the same float32
    arithmetic in the same order (scale h/oh, half-pixel centres, the
    four weights, the taps summed left to right, then truncation of
    v + 0.5)."""
    h, w, c = img.shape
    if (h, w) == (oh, ow):
        return img.copy()
    f32 = np.float32
    sy, sx = f32(h) / f32(oh), f32(w) / f32(ow)
    if mode == NEAREST:
        ys = np.minimum((np.arange(oh, dtype=f32) * sy).astype(np.int64), h - 1)
        xs = np.minimum((np.arange(ow, dtype=f32) * sx).astype(np.int64), w - 1)
        return img[ys][:, xs]
    half = f32(0.5)
    fy = (np.arange(oh, dtype=f32) + half) * sy - half
    fx = (np.arange(ow, dtype=f32) + half) * sx - half
    y0 = np.where(fy >= 0, fy, fy - f32(1)).astype(np.int64)  # C++ floor
    x0 = np.where(fx >= 0, fx, fx - f32(1)).astype(np.int64)
    wy = (fy - y0.astype(f32))[:, None, None]
    wx = (fx - x0.astype(f32))[None, :, None]
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    one = f32(1)
    w00, w01 = (one - wy) * (one - wx), (one - wy) * wx
    w10, w11 = wy * (one - wx), wy * wx
    f = img.astype(f32)
    v = (w00 * f[y0c][:, x0c] + w01 * f[y0c][:, x1c]
         + w10 * f[y1c][:, x0c] + w11 * f[y1c][:, x1c])
    return (v + half).astype(np.uint8)


def decode_supported() -> bool:
    """True when the native lib was built with libjpeg/libpng decode."""
    lib = load_library()
    return bool(lib is not None and getattr(lib, "hdt_decode_supported")())


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG/PNG bytes to RGB uint8 HWC via the native core.

    Returns None when the native decoder is unavailable or the bytes are
    not a decodable JPEG/PNG (callers fall back to cv2/PIL).
    """
    lib = load_library()
    if lib is None or not lib.hdt_decode_supported():
        return None
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.hdt_decode_info(_as_u8p(buf), len(data),
                           ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.hdt_decode_u8(_as_u8p(buf), len(data), _as_u8p(out),
                         h.value, w.value) != 0:
        return None
    return out


def batch_decode_resize(blobs: Sequence[bytes], size: tuple[int, int],
                        mode: int = BILINEAR, threads: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Decode N encoded JPEG/PNG blobs and resize into one contiguous
    (N, out_h, out_w, 3) RGB batch — the whole file→tensor hot path in a
    single native call, decode+resize fused per worker thread.

    Returns (batch, ok) where ok[i] is False for undecodable blobs (their
    slots are zeroed). Raises RuntimeError when native decode is absent.
    """
    lib = load_library()
    if lib is None or not lib.hdt_decode_supported():
        raise RuntimeError("native decode unavailable "
                           "(libimage_pipe.so without libjpeg/libpng)")
    oh, ow = size
    n = len(blobs)
    bufs = [np.frombuffer(b, np.uint8) for b in blobs]
    out = np.empty((n, oh, ow, 3), np.uint8)
    rcs = (ctypes.c_int * n)()
    srcs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_as_u8p(b) for b in bufs])
    lens = (ctypes.c_int64 * n)(*[len(b) for b in blobs])
    lib.hdt_batch_decode_resize_u8(srcs, lens, n, _as_u8p(out), oh, ow,
                                   mode, threads, rcs)
    return out, np.asarray([rcs[i] == 0 for i in range(n)])
