"""PyTorch / CUDA port of the LINEMOD pose-estimation framework.

The JAX package ``linemod_pose_estimation_tpu`` is the reference this
package is held against; the layout mirrors it module for module:

- ``utils``  — the native bank loader, STL loading, SE(3) geometry and
               point-cloud primitives, scene helpers.
- ``ops``    — quantized modalities, spreading / response maps, the
               template-scoring engines, the rasterizer, ICP, and the
               hand-written CUDA kernels (``csrc/``) with their plain
               PyTorch versions.
- ``models`` — template banks, the Detector, the batched serving matcher,
               the renderer, the detection cascade and DetectionPipeline.

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
