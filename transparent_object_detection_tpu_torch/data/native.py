"""ctypes bindings for the native preprocessing kernels (native/*.cpp at the
root of the repository): the port's own copy of
transparent_object_detection_tpu/data/native.py.

Builds the shared library on demand with g++ (no pybind11 dependency) into
the port's own build directory, `build/torch_native/` (never the library
beside the source, which the JAX package builds and loads), and degrades
gracefully: `available()` is False when no compiler exists, and the
pure-numpy/cv2 paths in augment.py remain the behavior-defining fallback.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "fused_preprocess.cpp")
_OUT = os.path.join(_ROOT, "build", "torch_native", "libfused_preprocess.so")


def build_native(force: bool = False) -> Optional[str]:
    """Compile the native library; returns its path or None on failure.

    The .so is a local build artifact (never committed: it is compiled with
    -march=native and would SIGILL on other hosts) and is rebuilt whenever
    the C++ source is newer than the library.
    """
    if not os.path.exists(_SRC):
        return _OUT if os.path.exists(_OUT) else None
    if (
        os.path.exists(_OUT)
        and not force
        and os.path.getmtime(_OUT) >= os.path.getmtime(_SRC)
    ):
        return _OUT
    # built under a name of this process and renamed into place, so that
    # processes building at once never load a half-written library
    os.makedirs(os.path.dirname(_OUT), exist_ok=True)
    tmp = f"{_OUT}.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _OUT)
    except (OSError, subprocess.SubprocessError):
        return None
    return _OUT


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = build_native()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        c_int, c_float = ctypes.c_int, ctypes.c_float
        lib.letterbox_u8_to_f32.argtypes = [
            u8p, c_int, c_int, f32p, c_int, c_int, c_int, c_int, c_int, c_int, c_float,
        ]
        lib.letterbox_batch_u8_to_f32.argtypes = [
            u8p, c_int, c_int, c_int, f32p, c_int, c_int, c_int, c_int, c_int, c_int,
            c_float,
        ]
        lib.hsv_jitter_u8.argtypes = [u8p, c_int, c_int, c_float, c_float, c_float]
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.mosaic4_u8.argtypes = [
            u8p, u8p, u8p, u8p, i32p, i32p, u8p, c_int, c_int, c_int, c_int,
            ctypes.c_uint8, c_float, c_float, c_float,
        ]
        lib.blend_half_u8.argtypes = [u8p, u8p, u8p, ctypes.c_long]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def letterbox_u8(
    image: np.ndarray, input_shape: Tuple[int, int], fill: float = 128.0 / 255.0
) -> np.ndarray:
    """uint8 HWC RGB -> float32 letterboxed (h, w, 3) in [0, 1], one pass."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native preprocessing unavailable")
    sh, sw = image.shape[:2]
    h, w = input_shape
    scale = min(w / sw, h / sh)
    nw, nh = int(sw * scale), int(sh * scale)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    image = np.ascontiguousarray(image)
    out = np.empty((h, w, 3), dtype=np.float32)
    lib.letterbox_u8_to_f32(image, sh, sw, out, h, w, nh, nw, dx, dy, fill)
    return out


def letterbox_batch_u8(
    images: np.ndarray, input_shape: Tuple[int, int], fill: float = 128.0 / 255.0
) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, h, w, 3) float32, threaded across images."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native preprocessing unavailable")
    n, sh, sw = images.shape[:3]
    h, w = input_shape
    scale = min(w / sw, h / sh)
    nw, nh = int(sw * scale), int(sh * scale)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    images = np.ascontiguousarray(images)
    out = np.empty((n, h, w, 3), dtype=np.float32)
    lib.letterbox_batch_u8_to_f32(images, n, sh, sw, out, h, w, nh, nw, dx, dy, fill)
    return out


def mosaic4_u8(
    images,
    geom: np.ndarray,
    out_shape: Tuple[int, int],
    cutx: int,
    cuty: int,
    fill: int = 128,
    hsv_gains: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """Fused mosaic assembly: 4 uint8 RGB sources -> (h, w, 3) uint8 canvas.

    geom: (4, 5) int32 [nw, nh, dx, dy, flip] per tile (quadrant order
    0 TL, 1 BL, 2 BR, 3 TR). One pass over the output — resize + flip +
    quadrant paste + optional HSV jitter composed per pixel.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native preprocessing unavailable")
    h, w = out_shape
    srcs = [np.ascontiguousarray(im) for im in images]
    src_hw = np.asarray([d for im in srcs for d in im.shape[:2]], dtype=np.int32)
    geom = np.ascontiguousarray(geom, dtype=np.int32)
    out = np.empty((h, w, 3), dtype=np.uint8)
    lib.mosaic4_u8(
        srcs[0], srcs[1], srcs[2], srcs[3], src_hw, geom, out, h, w,
        int(cutx), int(cuty), fill,
        float(hsv_gains[0]), float(hsv_gains[1]), float(hsv_gains[2]),
    )
    return out


def blend_half_u8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """0.5/0.5 uint8 blend (mixup) in one pass."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native preprocessing unavailable")
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    out = np.empty_like(a)
    lib.blend_half_u8(a, b, out, a.size)
    return out


def hsv_jitter_u8(image: np.ndarray, h_gain: float, s_gain: float, v_gain: float) -> np.ndarray:
    """In-place HSV jitter on uint8 RGB; returns the same array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native preprocessing unavailable")
    image = np.ascontiguousarray(image)
    lib.hsv_jitter_u8(image, image.shape[0], image.shape[1], h_gain, s_gain, v_gain)
    return image
