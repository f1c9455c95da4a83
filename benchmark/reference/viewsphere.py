"""Frozen copy of ``linemod_pose_estimation_tpu_torch/utils/viewsphere.py`` for the
benchmark's plain reference: plain PyTorch only, no hand-written kernel,
imported by nothing of the program, and never edited to follow it.

The original's docstring:

View-sphere sampling for offline template training, host numpy — the
port's own copy of ``linemod_pose_estimation_tpu/utils/viewsphere.py``
(the port imports nothing of the JAX package), with the same formulas in
the same order, so the views come out equal element for element.

Walks ~uniform points on a view sphere around the object (a Fibonacci
spiral), with in-plane camera rotations (`angle_step` degrees) and a
radius sweep (`radius_min..radius_max` by `radius_step`), and gives the
per-view pose metadata the original renderer stores per template:

  R     — object->camera rotation,
  T     — negative camera position in the object frame (the bank's T),
  D_obj — camera-to-object-origin distance (the bank's Ori_dist).

`restricted=True` keeps the upper hemisphere (z >= min_elevation).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ViewSphereParams:
    n_points: int = 150
    angle_step: int = 10  # degrees, in-plane rotation step
    radius_min: float = 0.5
    radius_max: float = 1.0
    radius_step: float = 0.1
    restricted: bool = True
    min_elevation: float = 0.1  # z-component floor for restricted sampling
    # In-plane rotation sweep; full turn by default.
    angle_min: float = 0.0
    angle_max: float = 360.0


@dataclass
class View:
    R: np.ndarray  # (3,3) object->camera rotation
    T: np.ndarray  # (3,) negative camera position (bank "T")
    D_obj: float  # camera-to-origin distance (bank "Ori_dist")
    up: np.ndarray  # (3,) GL-style up vector used for the render


def fibonacci_sphere(n: int, hemisphere: bool = False, min_z: float = 0.0) -> np.ndarray:
    """Deterministic ~uniform unit directions (n, 3)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    if hemisphere:
        z = min_z + (1.0 - min_z) * (i / n)  # z in (min_z, 1)
    else:
        z = 1.0 - 2.0 * i / n
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i  # golden angle
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _look_at_np(eye: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Numpy twin of utils.geometry.look_at_object, with its degenerate-up
    branch (up parallel to the view axis: another up is taken)."""
    fwd = -eye / np.linalg.norm(eye)
    s = np.cross(fwd, up)
    sl = np.linalg.norm(s)
    if sl < 1e-9:
        up = np.array([1.0, 0.0, 0.0]) if abs(fwd[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        s = np.cross(fwd, up)
        sl = np.linalg.norm(s)
    s = s / sl
    u_gl = np.cross(s, fwd)
    return np.stack([s, -u_gl, fwd], axis=0)


def generate_views(params: ViewSphereParams) -> list[View]:
    """The full (radius x in-plane angle x sphere point) grid, radius-major,
    then angle, then point: template ids increase along this walk."""
    dirs = fibonacci_sphere(
        params.n_points, hemisphere=params.restricted, min_z=params.min_elevation
    )
    radii = []
    r = params.radius_min
    while r <= params.radius_max + 1e-9:
        radii.append(r)
        r += params.radius_step
    angles = np.arange(params.angle_min, params.angle_max - 1e-9, float(params.angle_step))

    # Vectorized over the grid; the same formulas elementwise as _look_at_np.
    P = dirs.shape[0]
    A = angles.shape[0]

    fwd = -dirs  # (P, 3)
    base = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (P, 3)).copy()
    degen = np.abs(fwd[:, 2]) > 0.999
    base[degen] = np.array([0.0, 1.0, 0.0])
    base = base - np.sum(base * fwd, axis=1, keepdims=True) * fwd
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    side = np.cross(fwd, base)  # (P, 3)

    ca = np.cos(np.radians(angles))[:, None, None]  # (A,1,1)
    sa = np.sin(np.radians(angles))[:, None, None]
    up = ca * base[None] + sa * side[None]  # (A, P, 3)

    # look_at: forward = -eye/|eye| = fwd (radius-independent)
    f = np.broadcast_to(fwd[None], (A, P, 3))
    s = np.cross(f, up)
    sl = np.linalg.norm(s, axis=-1, keepdims=True)
    dg = sl[..., 0] < 1e-9  # degenerate up || view axis: another up
    if dg.any():
        alt = np.where(
            (np.abs(f[..., 0]) < 0.9)[..., None],
            np.array([1.0, 0.0, 0.0]),
            np.array([0.0, 1.0, 0.0]),
        )
        s = np.where(dg[..., None], np.cross(f, alt), s)
        sl = np.linalg.norm(s, axis=-1, keepdims=True)
    s = s / sl
    u_gl = np.cross(s, f)
    Rmat = np.stack([s, -u_gl, f], axis=2)  # (A, P, 3, 3)

    views: list[View] = []
    for radius in radii:
        eye = radius * dirs  # (P, 3)
        for ai in range(A):
            for pi in range(P):
                views.append(
                    View(R=Rmat[ai, pi], T=-eye[pi], D_obj=float(radius), up=up[ai, pi])
                )
    return views
