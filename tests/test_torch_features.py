"""PyTorch port vs the JAX reference: the preprocess (ops/features.py and
preprocess_frames_batched), on CPU, where each kernel wrapper runs its
plain PyTorch version.  Pallas references run in interpret mode.

Tolerance: exact equality for every output (u8 bitmasks and responses;
the f32 pyrDown output is integer-valued and every partial sum is exact).
"""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.ops import features as JF
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu.ops.pallas_kernels import spread_response_batched
from linemod_pose_estimation_tpu.ops.pallas_preprocess import (
    quantize_color_gradient_pallas,
)
from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
from linemod_pose_estimation_tpu_torch.ops import features as TF
from linemod_pose_estimation_tpu_torch.ops import match as TM


def _renders(h):
    out = []
    for f in sorted(glob.glob("tests/data/render_cache/*.npz")):
        with np.load(f) as z:
            if z["rgb"].shape[0] == h:
                out.append((z["rgb"].copy(), z["depth_mm"].astype(np.float32)))
    return out


def _structured(H=40, W=52):
    rgb = np.zeros((H, W, 3), np.uint8)
    rgb[:, : W // 2] = (200, 40, 40)
    rgb[: H // 3, W // 2:] = (0, 220, 0)
    yy, xx = np.mgrid[0:H, 0:W]
    rgb[((yy + xx) // 9) % 2 == 0] //= 2
    rgb[25:35, 30:45] = (255, 255, 255)
    return rgb


def _color_inputs(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.integers(0, 256, size=(2, 32, 48, 3)).astype(np.uint8), 10.0
    if kind == "structured":
        return _structured()[None], 10.0
    if kind == "odd_height":
        return rng.integers(0, 256, size=(1, 37, 40, 3)).astype(np.uint8), 55.0
    # level-1 input: the integer-valued f32 pyrDown output of a u8 frame
    src = rng.integers(0, 256, size=(2, 64, 72, 3)).astype(np.float32)
    src[1, :, :30] = (200.0, 40.0, 40.0)
    lvl1 = np.stack([np.asarray(JF.pyr_down(jnp.asarray(src[b, ..., c])))
                     for b in range(2) for c in range(3)], -1)
    return lvl1.reshape(32, 36, 2, 3).transpose(2, 0, 1, 3).copy(), 10.0


@pytest.mark.parametrize("kind", ["random", "structured", "odd_height", "f32_level1"])
def test_quantize_color_gradient_equals_reference(kind):
    """K1's plain version == features.quantize_color_gradient (both outputs)
    and == the Pallas kernel in interpret mode; exact."""
    rgb, weak = _color_inputs(kind)
    got_q, got_m = TF.quantize_color_gradient(torch.from_numpy(rgb), weak)
    for b in range(rgb.shape[0]):
        q, m = JF.quantize_color_gradient(jnp.asarray(rgb[b]), weak)
        np.testing.assert_array_equal(got_q[b].numpy(), np.asarray(q))
        np.testing.assert_array_equal(got_m[b].numpy(), np.asarray(m))
    pal = quantize_color_gradient_pallas(jnp.asarray(rgb), weak, interpret=True)
    wrapped = CP.quantize_color_gradient(torch.from_numpy(rgb), weak)
    np.testing.assert_array_equal(wrapped.numpy(), np.asarray(pal))
    assert (got_q.numpy() > 0).any()


@pytest.mark.parametrize("h", [240, 120])
def test_quantize_depth_normal_equals_reference(h):
    """Depth normals on cached renders (plus the degenerate nz == 0 LUT
    row via a tilted ramp): the direct NORMAL_LUT lookup equals the
    reference's arithmetic + patches, exactly."""
    depths = [d for _, d in _renders(h)][:3]
    H, W = depths[0].shape
    yy, xx = np.mgrid[0:H, 0:W]
    depths.append((600 + 7 * xx + 3 * yy).astype(np.float32))
    batch = np.stack(depths)
    got = TF.quantize_depth_normal(torch.from_numpy(batch)).numpy()
    for b in range(batch.shape[0]):
        want = np.asarray(JF.quantize_depth_normal(jnp.asarray(batch[b])))
        np.testing.assert_array_equal(got[b], want)
    assert (got > 0).any()


@pytest.mark.parametrize("T", [5, 8])
def test_spread_response_equals_reference(T):
    """K2's plain version == orientation_spread + response_maps and ==
    spread_response_batched in interpret mode; exact."""
    rng = np.random.default_rng(T)
    q = ((1 << rng.integers(0, 8, size=(2, 45, 70)))
         * (rng.random((2, 45, 70)) < 0.3)).astype(np.uint8)
    got = CK.spread_response(torch.from_numpy(q), T).numpy()
    pal = np.asarray(spread_response_batched(jnp.asarray(q), T, interpret=True))
    np.testing.assert_array_equal(got, pal)
    for b in range(2):
        want = JF.response_maps(JF.orientation_spread(jnp.asarray(q[b]), T))
        np.testing.assert_array_equal(got[b], np.asarray(want))


@pytest.mark.parametrize("shape", [(37, 53), (48, 64)])
def test_pyr_down_equals_reference(shape):
    img = np.random.default_rng(1).integers(0, 256, size=shape).astype(np.float32)
    got = TF.pyr_down(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.pyr_down(jnp.asarray(img))))


def test_preprocess_frames_batched_equals_reference():
    """(R0, R1) RGB-D response stacks of two 240x320 renders, exact."""
    frames = _renders(240)[:2]
    rgbs = np.stack([r for r, _ in frames])
    deps = np.stack([d for _, d in frames])
    R0, R1 = TM.preprocess_frames_batched(
        torch.from_numpy(rgbs), torch.from_numpy(deps), T0=5, T1=8,
        use_depth=True)
    J0, J1 = JM.preprocess_frames_batched(
        jnp.asarray(rgbs), jnp.asarray(deps), T0=5, T1=8, use_depth=True)
    assert R0.shape == (2, 16, 240, 320) and R1.shape == (2, 16, 120, 160)
    np.testing.assert_array_equal(R0.numpy(), np.asarray(J0))
    np.testing.assert_array_equal(R1.numpy(), np.asarray(J1))
    # the plain switch takes the same functions on the CPU
    P0, P1 = TM.preprocess_frames_batched(
        torch.from_numpy(rgbs), torch.from_numpy(deps), use_depth=True,
        plain=True)
    assert torch.equal(P0, R0) and torch.equal(P1, R1)
