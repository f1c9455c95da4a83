"""Robot-frame transform chain, host-side numpy — the port of
``linemod_pose_estimation_tpu/api/transforms.py``.

pose_base<-obj = pose_base<-tool0 (robot TF) x pose_tool0<-depth (hand-eye)
x pose_depth<-obj (the detection), the service node's chain.  The
hand-eye calibration constant is the one the reference ships.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np

# Hand-eye result: translation (x, y, z), quaternion (qw, qx, qy, qz).
REFERENCE_HAND_EYE = (0.0672827, -0.0546864, 0.0466534, 0.701074, 2.999e-05, 0.00514592, 0.71307)


@dataclass
class Transform:
    """The wire shape of geometry_msgs/Transform (srv/linemod_pose.srv)."""

    translation: tuple[float, float, float]
    rotation: tuple[float, float, float, float]  # (qx, qy, qz, qw), ROS order

    @classmethod
    def identity(cls) -> "Transform":
        return cls((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def quat_to_mat_np(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ])


def _fma32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c rounded once to float32 (a fused multiply-add), from the
    exact rational value."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    near = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    # nearest to the exact value; a tie goes to the even mantissa
    return min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                    int(v.view(np.uint32)) & 1))


def mat_to_quat_np(R: np.ndarray) -> tuple[float, float, float, float]:
    """(qx, qy, qz, qw), w >= 0, of a rotation matrix (3, 3): Shepperd's
    method (the candidate with the largest pivot, the first on ties), in
    float32 and bit for bit as the reference computes it — its quaternion
    goes through JAX with 64-bit floats off, so even a float64 matrix is
    rounded to float32 first, and XLA's norm sums the squares as a chain
    of fused multiply-adds before the square root and the division."""
    m = np.asarray(R, np.float32)
    one = np.float32(1.0)
    m00, m01, m02 = m[0]
    m10, m11, m12 = m[1]
    m20, m21, m22 = m[2]
    tr = m00 + m11 + m22
    cands = np.array([
        [one + tr, m21 - m12, m02 - m20, m10 - m01],
        [m21 - m12, one + m00 - m11 - m22, m01 + m10, m02 + m20],
        [m02 - m20, m01 + m10, one - m00 + m11 - m22, m12 + m21],
        [m10 - m01, m02 + m20, m12 + m21, one - m00 - m11 + m22],
    ], np.float32)  # (component w x y z, branch)
    pivots = np.array([one + tr, one + m00 - m11 - m22, one - m00 + m11 - m22,
                       one - m00 - m11 + m22], np.float32)
    q = cands[:, int(np.argmax(pivots))]
    n = np.sqrt(_fma32(q[3], q[3], _fma32(q[2], q[2], _fma32(q[1], q[1], q[0] * q[0]))))
    q = q / n
    if q[0] < 0:
        q = -q
    w, x, y, z = (float(v) for v in q)
    return (x, y, z, w)


def make_affine(x, y, z, qw, qx, qy, qz) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_mat_np(qw, qx, qy, qz)
    T[:3, 3] = [x, y, z]
    return T


def tool0_to_depth(hand_eye=REFERENCE_HAND_EYE) -> np.ndarray:
    """getTool0toDepthTF: the hand-eye transform."""
    return make_affine(*hand_eye)


def base_to_object(pose_base_tool0: np.ndarray, pose_depth_obj: np.ndarray,
                   hand_eye=REFERENCE_HAND_EYE) -> np.ndarray:
    """The full chain base <- tool0 <- depth <- object."""
    return pose_base_tool0 @ tool0_to_depth(hand_eye) @ pose_depth_obj


def affine_to_transform(T: np.ndarray) -> Transform:
    """affineTotrans: a (4, 4) pose as the wire Transform."""
    qx, qy, qz, qw = mat_to_quat_np(T[:3, :3])
    t = T[:3, 3]
    return Transform((float(t[0]), float(t[1]), float(t[2])), (qx, qy, qz, qw))
