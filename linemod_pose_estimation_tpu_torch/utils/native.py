"""ctypes bindings for the native C++ bank loader (native/ directory).

`native/bank_loader.cpp` parses the OpenCV-YAML bank files.  The port
compiles it on first use with g++ into its own library under
`build/native/` at the repository root (git-ignored), never into
`native/build/`: `make -C native` writes its output in place, so a process
that loads that path while another is still linking it reads a truncated
file ("file too short").  Here each process compiles to a file of its own
and publishes it with an atomic rename, so concurrent loaders (pytest
workers, say) see either no library or a whole one.  It is the bank
readers' first route; where it cannot build, `available()` is false and
``models/templates.py`` reads through PyYAML instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")
_SOURCE = os.path.join(NATIVE_DIR, "bank_loader.cpp")
_SO_PATH = os.path.join(BUILD_DIR, "liblpe_native.so")
_CXXFLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")  # as native/Makefile

_lib = None
_tried = False


def build_shared(so_path: str, source: str, extra: tuple[str, ...] = (),
                 timeout: int = 120) -> None:
    """Compile `source` to a per-process file, then rename it onto
    `so_path` (atomic on one file system).  `extra` follows the source on
    g++'s command line (include paths, libraries)."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, source, *extra],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH):
        try:
            build_shared(_SO_PATH, _SOURCE)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    for name in ("lpe_load_params_blob", "lpe_load_templates_blob"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_uint8)
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.lpe_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.lpe_free.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


def _grab_blob(fn, path: str) -> bytes | None:
    size = ctypes.c_int64(0)
    ptr = fn(path.encode(), ctypes.byref(size))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, size.value)
    finally:
        _get_lib().lpe_free(ptr)


def load_params_native(path: str):
    """Parse a renderer_params.yml via the native loader.

    Returns (R (N,3,3) f64, T (N,3) f64, K (N,3,3) f32, D (N,), Ori_dist
    (N,), Rect (N,4) i32, globals (11,) f64) or None if unavailable/failed.
    """
    lib = _get_lib()
    if lib is None:
        return None
    blob = _grab_blob(lib.lpe_load_params_blob, path)
    if blob is None:
        return None
    off = 0
    (n,) = np.frombuffer(blob, np.int64, 1, off)
    off += 8
    n = int(n)

    def take(dtype, count, shape):
        nonlocal off
        a = np.frombuffer(blob, dtype, count, off).reshape(shape).copy()
        off += a.nbytes
        return a

    R = take(np.float64, n * 9, (n, 3, 3))
    T = take(np.float64, n * 3, (n, 3))
    K = take(np.float32, n * 9, (n, 3, 3))
    D = take(np.float64, n, (n,))
    Od = take(np.float64, n, (n,))
    Rect = take(np.int32, n * 4, (n, 4))
    glob = take(np.float64, 11, (11,))
    return R, T, K, D, Od, Rect, glob


def load_templates_native(path: str):
    """Parse a templates.yml via the native loader.

    Returns (entries (M,6) i32 rows [pyramid_id, w, h, level, modality, nf],
    features (F,3) i32 rows [x, y, label] in file order, header (4,) i32
    [pyramid_levels, modality_mask, T0, T1], modality_params (2,4) f64)
    or None if unavailable/failed.
    """
    lib = _get_lib()
    if lib is None:
        return None
    blob = _grab_blob(lib.lpe_load_templates_blob, path)
    if blob is None:
        return None
    off = 0
    n_entries, n_feat = np.frombuffer(blob, np.int64, 2, off)
    off += 16

    def take(dtype, count, shape):
        nonlocal off
        a = np.frombuffer(blob, dtype, count, off).reshape(shape).copy()
        off += a.nbytes
        return a

    entries = take(np.int32, int(n_entries) * 6, (int(n_entries), 6))
    features = take(np.int32, int(n_feat) * 3, (int(n_feat), 3))
    header = take(np.int32, 4, (4,))
    mparams = take(np.float64, 8, (2, 4))
    return entries, features, header, mparams
