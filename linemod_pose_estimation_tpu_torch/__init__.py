"""PyTorch / CUDA port of the LINEMOD pose-estimation framework.

The JAX package ``linemod_pose_estimation_tpu`` is the reference this
package is held against; the layout mirrors it module for module:

- ``utils``  — the native bank loader, STL loading, SE(3) geometry and
               point-cloud primitives, the view sphere, scene helpers, the
               cv::linemod oracle.
- ``ops``    — quantized modalities, spreading / response maps, the
               template-scoring engines (the exact int8 GEMM, the gather
               scan and the convolution), the rasterizer, ICP, cloud
               segmentation (normals, MLS smoothing, region growing,
               euclidean clustering), the aux image filters, and the
               hand-written CUDA kernels (``csrc/``) with their plain
               PyTorch versions.
- ``models`` — template banks, the Detector (``engine=`` "gather",
               "conv" or "auto"), the batched serving matcher and
               PipelinedRunner, the renderer, the detection cascade and
               DetectionPipeline, the offline trainer, the grasp planner.
- ``parallel`` — the device mesh and rank launcher on torch.distributed
               (make_mesh, spawn), the sharded steps (the bank-sharded
               detect step and coarse matcher, the row-sharded and ring
               matchers), put_global_batch, and host-side multi-camera
               ingest (FrameBatcher, PacedSource).
- ``api``    — the pose service, the application nodes and replay
               sources, the robot-frame transform chain.
- ``eval``   — the accuracy harness (match-position error against known
               poses, head to head against the cv::linemod oracle).
- ``__main__`` — the CLI: ``python -m linemod_pose_estimation_tpu_torch
               train|detect|serve ... [--device cpu]``.

Nothing here imports ``jax``: the reference package imports it at package
import time, so even its numpy-only helpers are copied, not imported.
"""

__version__ = "0.1.0"

import torch as _torch

# Full f32 matmuls and convolutions: the counterpart of the reference's
# jax_default_matmul_precision=float32.  TF32 keeps ~10 mantissa bits, and
# reduced-precision f32 products are a correctness hazard for the geometry
# stages, not a speed knob.  The int8 scoring GEMMs are integer ops and
# unaffected.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
