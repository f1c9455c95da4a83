"""ctypes bindings for the cv::linemod ORACLE (native/linemod_oracle.cpp):
the genuine OpenCV linemod engine behind a C interface, as the second
referee of the port's tests.

It exposes what the original system uses of cv::linemod:
Detector(ColorGradient[/DepthNormal], T={5, 8}), addTemplate, match, the
per-level quantizers and FileStorage I/O in the writeLinemod / readLinemod
layout.  The library is compiled on first use against the system's OpenCV
(headers under /usr/include/opencv4, libopencv_rgbd) into `build/native/`
with the atomic rename of ``utils/native.py``.  `available()` is false
where it cannot build (a machine without OpenCV's rgbd module, say):
tests skip there, and nothing outside the tests depends on it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .native import BUILD_DIR, NATIVE_DIR, build_shared

_SOURCE = os.path.join(NATIVE_DIR, "linemod_oracle.cpp")
_SO_PATH = os.path.join(BUILD_DIR, "liblpe_oracle.so")
_OPENCV = ("-I/usr/include/opencv4", "-lopencv_rgbd", "-lopencv_core",
           "-lopencv_imgproc")  # as native/Makefile

_lib = None
_tried = False


def _get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH):
        try:
            build_shared(_SO_PATH, _SOURCE, _OPENCV, timeout=180)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.lpe_oracle_create.restype = ctypes.c_void_p
    lib.lpe_oracle_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lpe_oracle_destroy.argtypes = [ctypes.c_void_p]
    lib.lpe_oracle_add_template.restype = ctypes.c_int
    lib.lpe_oracle_add_template.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.lpe_oracle_match.restype = ctypes.c_int
    lib.lpe_oracle_match.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.lpe_oracle_write.restype = ctypes.c_int
    lib.lpe_oracle_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.lpe_oracle_read.restype = ctypes.c_void_p
    lib.lpe_oracle_read.argtypes = [ctypes.c_char_p]
    lib.lpe_oracle_num_templates.restype = ctypes.c_int
    lib.lpe_oracle_num_templates.argtypes = [ctypes.c_void_p]
    lib.lpe_oracle_pyramid_levels.restype = ctypes.c_int
    lib.lpe_oracle_pyramid_levels.argtypes = [ctypes.c_void_p]
    lib.lpe_oracle_template.restype = ctypes.c_int
    lib.lpe_oracle_template.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.lpe_oracle_quantize.restype = ctypes.c_int
    lib.lpe_oracle_quantize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.lpe_oracle_quantize_level.restype = ctypes.c_int
    lib.lpe_oracle_quantize_level.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


class LinemodOracle:
    """Thin OO wrapper over the C shim."""

    def __init__(self, use_depth: bool = False, num_features: int = 63,
                 _handle=None):
        self._lib = _get_lib()
        if self._lib is None:
            raise RuntimeError("oracle library unavailable")
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self._lib.lpe_oracle_create(int(use_depth), num_features)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.lpe_oracle_destroy(self._h)
            self._h = None

    def add_template(self, rgb: np.ndarray, mask: np.ndarray,
                     depth_mm: np.ndarray | None = None):
        rgb = np.ascontiguousarray(rgb, np.uint8)
        mask = np.ascontiguousarray(mask, np.uint8)
        h, w = mask.shape
        bbox = np.zeros(4, np.int32)
        dep = (np.ascontiguousarray(depth_mm, np.uint16)
               if depth_mm is not None else None)
        tid = self._lib.lpe_oracle_add_template(
            self._h, rgb.ctypes.data, h, w,
            dep.ctypes.data if dep is not None else None,
            mask.ctypes.data, bbox.ctypes.data,
        )
        return tid, tuple(int(v) for v in bbox)

    def match(self, rgb: np.ndarray, threshold: float,
              depth_mm: np.ndarray | None = None, cap: int = 4096):
        rgb = np.ascontiguousarray(rgb, np.uint8)
        h, w = rgb.shape[:2]
        xyt = np.zeros((cap, 3), np.int32)
        sim = np.zeros(cap, np.float32)
        dep = (np.ascontiguousarray(depth_mm, np.uint16)
               if depth_mm is not None else None)
        n = self._lib.lpe_oracle_match(
            self._h, rgb.ctypes.data, h, w,
            dep.ctypes.data if dep is not None else None,
            float(threshold), xyt.ctypes.data, sim.ctypes.data, cap,
        )
        return xyt[:n], sim[:n]

    def write(self, path: str) -> None:
        rc = self._lib.lpe_oracle_write(self._h, path.encode())
        if rc != 0:
            raise IOError(f"oracle write failed: {path}")

    @classmethod
    def read(cls, path: str) -> "LinemodOracle":
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("oracle library unavailable")
        h = lib.lpe_oracle_read(path.encode())
        if not h:
            raise IOError(f"oracle read failed: {path}")
        return cls(_handle=h)

    @property
    def num_templates(self) -> int:
        return self._lib.lpe_oracle_num_templates(self._h)

    @property
    def pyramid_levels(self) -> int:
        return self._lib.lpe_oracle_pyramid_levels(self._h)

    def quantize(self, rgb: np.ndarray | None, modality: int = 0,
                 depth_mm: np.ndarray | None = None) -> np.ndarray:
        """cv::linemod's level-0 quantized orientation bitmask (the one-hot
        u8 image before spreading) for ColorGradient (0) or DepthNormal (1).
        """
        if modality == 0:
            rgb = np.ascontiguousarray(rgb, np.uint8)
            h, w = rgb.shape[:2]
            rgb_ptr = rgb.ctypes.data
            dep_ptr = None
        else:
            dep = np.ascontiguousarray(depth_mm, np.uint16)
            h, w = dep.shape
            rgb_ptr = None
            dep_ptr = dep.ctypes.data
        out = np.zeros((h, w), np.uint8)
        rc = self._lib.lpe_oracle_quantize(
            self._h, modality, rgb_ptr, h, w, dep_ptr, out.ctypes.data
        )
        if rc != 0:
            raise RuntimeError(f"oracle quantize failed: {rc}")
        return out

    def quantize_level(self, rgb: np.ndarray | None, modality: int = 0,
                       depth_mm: np.ndarray | None = None,
                       level: int = 0) -> np.ndarray:
        """Quantized bitmask after `level` QuantizedPyramid::pyrDown calls
        — the real engine's per-level quantization (e.g. DepthNormal's
        level-1 semantics)."""
        if modality == 0:
            rgb = np.ascontiguousarray(rgb, np.uint8)
            h, w = rgb.shape[:2]
            rgb_ptr = rgb.ctypes.data
            dep_ptr = None
        else:
            dep = np.ascontiguousarray(depth_mm, np.uint16)
            h, w = dep.shape
            rgb_ptr = None
            dep_ptr = dep.ctypes.data
        out = np.zeros((h >> level, w >> level), np.uint8)
        rc = self._lib.lpe_oracle_quantize_level(
            self._h, modality, rgb_ptr, h, w, dep_ptr, level, out.ctypes.data
        )
        if rc != 0:
            raise RuntimeError(f"oracle quantize_level failed: {rc}")
        return out

    def template(self, tid: int, idx: int, cap: int = 256):
        """Features [(x, y, label)] + (width, height) of pyramid entry idx
        (idx = level * num_modalities + modality)."""
        out = np.zeros((cap, 3), np.int32)
        size = np.zeros(2, np.int32)
        n = self._lib.lpe_oracle_template(
            self._h, tid, idx, out.ctypes.data, cap, size.ctypes.data
        )
        if n < 0:
            raise IndexError((tid, idx))
        return out[:n], (int(size[0]), int(size[1]))
