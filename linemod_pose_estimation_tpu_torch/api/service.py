"""PoseService: the `/linemod_object_pose` request/response surface
(srv/linemod_pose.srv: int32 object_id -> Transform) — the port of
``linemod_pose_estimation_tpu/api/service.py``.

An object registry (0 = memory chip, 1 = CPU in the reference launch), a
frame-source callback (the camera grab seam; replay fixtures and tests
inject frames here), the full detection cascade per call on the object's
pipeline — on the pipeline's device, the card unless it was built with
``device="cpu"`` — and the base-frame transform chain.  A miss, and an
unknown object id, return the identity transform.

Frame conditioning as on the reference service path: mono -> BGR
replication, 3 x 3 Gaussian blur and the crop Rect(bias_x, 0, crop_w,
crop_h) of 752-wide Ensenso frames.  Frames carry RGB and an organized
cloud and no depth image, so a bank's DepthNormal modality scores nothing
here: the service matches on colour.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..models.pipeline import Detection, DetectionPipeline
from .transforms import REFERENCE_HAND_EYE, Transform, affine_to_transform, base_to_object


@dataclass
class ObjectConfig:
    pipeline: DetectionPipeline
    threshold: float = 91.0


@dataclass
class Frame:
    """One grabbed RGB + cloud frame (the grab_registered_image payload)."""

    rgb: np.ndarray  # (H, W, 3) u8 (or (H, W) mono)
    cloud: np.ndarray  # (H, W, 3) float32 metres, NaN = invalid


@dataclass(frozen=True)
class FrameConditioning:
    """condition_frame's settings, the service's defaults.  Given to
    `models.serving.BatchedMatcher(conditioning=...)`, a batch of raw
    frames is conditioned on the matcher's device
    (`ops.features.condition_frames`), bit for bit as condition_frame
    conditions each frame."""

    bias_x: int = 56
    crop_w: int = 640
    crop_h: int = 480
    blur: bool = True


def condition_frame(frame: Frame, bias_x: int = 56, crop_w: int = 640, crop_h: int = 480,
                    blur: bool = True) -> Frame:
    """mono -> BGR, 3 x 3 Gaussian (separable [1/4, 1/2, 1/4], wrapping at
    the edges, in float64 as numpy promotes it), horizontal crop.  The
    cloud stays full-width; the cascade re-applies bias_x when indexing
    it."""
    rgb = frame.rgb
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=-1)
    if blur:
        k = np.array([0.25, 0.5, 0.25])
        f = rgb.astype(np.float32)
        f = k[0] * np.roll(f, 1, 0) + k[1] * f + k[2] * np.roll(f, -1, 0)
        f = k[0] * np.roll(f, 1, 1) + k[1] * f + k[2] * np.roll(f, -1, 1)
        rgb = np.clip(f, 0, 255).astype(np.uint8)
    rgb = rgb[:crop_h, bias_x:bias_x + crop_w]
    return Frame(rgb=rgb, cloud=frame.cloud)


class PoseService:
    """linemod_object_pose(object_id) -> base-frame Transform."""

    def __init__(self, frame_source: Callable[[], Frame],
                 base_tool0_source: Callable[[], np.ndarray] | None = None,
                 hand_eye=REFERENCE_HAND_EYE, bias_x: int = 0):
        self.objects: dict[int, ObjectConfig] = {}
        self.frame_source = frame_source
        # The robot's TF lookup; identity when no robot is attached.
        self.base_tool0_source = base_tool0_source or (lambda: np.eye(4))
        self.hand_eye = hand_eye
        self.bias_x = bias_x

    def register_object(self, object_id: int, cfg: ObjectConfig) -> None:
        self.objects[object_id] = cfg

    def detect_camera_frame(self, object_id: int) -> list[Detection]:
        """The cascade half of the callback: grab, condition, detect."""
        cfg = self.objects[object_id]
        frame = self.frame_source()
        if self.bias_x or frame.rgb.ndim == 2:
            frame = condition_frame(frame, bias_x=self.bias_x)
        return cfg.pipeline.detect(frame.rgb, frame.cloud, cfg.threshold)

    def linemod_object_pose(self, object_id: int) -> Transform:
        """The best target's base-frame pose; identity on a miss or an
        unknown object id."""
        if object_id not in self.objects:
            return Transform.identity()
        targets = self.detect_camera_frame(object_id)
        if not targets:
            return Transform.identity()
        pose_base_obj = base_to_object(self.base_tool0_source(), targets[0].pose,
                                       self.hand_eye)
        return affine_to_transform(pose_base_obj)
