"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

On first use each source is compiled by its own ``nvcc`` for ``sm_90a``
(all started together), and the objects are linked into one shared
library with a plain C interface, under ``build/torch_kernels/`` at the
repository root (git-ignored), loaded with ``ctypes``.  The
library is keyed by a hash of the sources and flags, so an edit rebuilds.
Every entry point takes raw device pointers, the device index and the
CUDA stream (the library links its own CUDA runtime, so it selects the
tensors' device itself), launches on the stream and returns
``cudaGetLastError()``; ``check`` raises on non-zero.

Nothing is compiled or loaded at import, so the package imports (and its
CPU paths run) without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SOURCES = ("quantize_cg.cu", "spread_response.cu", "walk_scores.cu",
           "raster_zbuffer.cu", "refine_scores.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No FMA contraction: fastAtan2's polynomial (K1) and the rasterizer's
    # edge functions (K4) must round after every product and sum, exactly
    # like their plain versions.  No fast-math: divisions stay IEEE.
    "-fmad=false",
    "-Xcompiler", "-fPIC",
)

# One plain integer per kernel: each wrapper adds one where it launches.
launch_counts = {"quantize_cg": 0, "spread_response": 0, "walk_scores": 0,
                 "raster_zbuffer": 0, "refine_scores": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (img, img_is_f32, out, mag2 or NULL, B, H, W, rows, weak2, device, stream)
    "lpe_quantize_cg": (_P, _I, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P),
    # (quant, out, B, H, W, T, C, c0, rows, device, stream)
    "lpe_spread_response": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (R0, oris, dys, dxs, live, gy0, gx0, n_valid, out,
    #  B, C, H, W, K, F, T, device, stream)
    "lpe_walk_scores": (_P,) * 9 + (_I,) * 8 + (_P,),
    # (coefs, zbuf, sbuf, scratch, P, Tn, H, W, device, stream)
    "lpe_raster_zbuffer": (_P,) * 4 + (_I,) * 5 + (_P,),
    # (R, oris, dys, dxs, nf, anchor_y, anchor_x, frame, out,
    #  B, C, H, W, K, F, window, words_ok, device, stream)
    "lpe_refine_scores": (_P,) * 9 + (_I,) * 9 + (_P,),
}

_lib = None
last_build_seconds: float | None = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build on a machine with the CUDA toolkit")
    return path


def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"liblpe_torch_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        nvcc = _nvcc()
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
        tmp = f"{so}.{os.getpid()}.tmp"
        procs = []
        try:
            for s, o in zip(srcs, objs):
                procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                              stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
            logs = [p.communicate(timeout=600)[0] for p in procs]
            for s, p, log in zip(srcs, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{log}")
            proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in (*objs, tmp):
                if os.path.exists(f):
                    os.remove(f)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a CUDA tensor."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    """Validate a kernel operand: CUDA (on `device`, if given), dtype,
    contiguity, shape."""
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a CUDA tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
