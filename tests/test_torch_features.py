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
from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC


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


@pytest.fixture(scope="module")
def depth_normal_cases():
    return KC.depth_normal_cases("cpu")


@pytest.mark.parametrize("name", KC.DEPTH_NORMAL_CASES)
def test_quantize_depth_normal_edge_cases_equal_reference(depth_normal_cases, name):
    """The plain DepthNormal (DN's twin) on the edge cases that hold DN to
    it on the card: thresholds crossed by fractional millimetres, 49-51 mm
    steps, holes, depths near 65535, shapes off DN's tile and below the
    band, int32 input; exact."""
    depth, dist, diff = depth_normal_cases[name]
    got = TF.quantize_depth_normal(depth, dist, diff).numpy()
    for b in range(depth.shape[0]):
        want = np.asarray(JF.quantize_depth_normal(jnp.asarray(depth[b].numpy()), dist, diff))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("name", KC.DEPTH_NORMAL_CASES)
def test_depth_normal_wrapper_on_cpu_equals_plain(depth_normal_cases, name):
    """DN's wrapper takes the plain version for a CPU tensor."""
    depth, dist, diff = depth_normal_cases[name]
    got = CP.quantize_depth_normal(depth, dist, diff)
    assert got.dtype == torch.uint8 and got.shape == depth.shape
    assert torch.equal(got, CP.quantize_depth_normal_plain(depth, dist, diff))


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


def test_normal_lut_is_the_ports_own_copy():
    """The port reads its own copy of the DepthNormal NORMAL_LUT, and the
    copy is byte-equal to the JAX package's file."""
    import os

    port = TF._NORMAL_LUT_PATH
    ref = os.path.join(os.path.dirname(JF.__file__), "normal_lut_calib.npz")
    assert os.path.dirname(os.path.realpath(port)) == os.path.dirname(
        os.path.realpath(TF.__file__))
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("use_depth", [False, True])
def test_stacked_preprocess_equals_the_concatenated_path(use_depth):
    """K2 (plain on the CPU) writing into channel slices of preallocated
    stacks gives the same bytes as separate spread_response calls joined
    by torch.cat, at both levels; the pyramid's fields are views of those
    stacks, and the untouched channels of a stack keep their bytes."""
    frames = _renders(120)[:2]
    rgbs = torch.from_numpy(np.stack([r for r, _ in frames]))
    deps = torch.from_numpy(np.stack([d for _, d in frames]))
    R0, R1 = TM.preprocess_frames_batched(rgbs, deps, use_depth=use_depth)
    q0 = TF.quantize_color_gradient(rgbs)[0]
    rgb1 = torch.stack([TF.pyr_down(rgbs[..., c].float()) for c in range(3)], -1)
    q1 = TF.quantize_color_gradient(rgb1)[0]
    want0 = [CK.spread_response_plain(q0, 5)]
    want1 = [CK.spread_response_plain(q1, 8)]
    if use_depth:
        n0 = TF.quantize_depth_normal(deps)
        want0.append(CK.spread_response_plain(n0, 5))
        want1.append(CK.spread_response_plain(n0[:, ::2, ::2].contiguous(), 8))
    assert torch.equal(R0, torch.cat(want0, dim=1))
    assert torch.equal(R1, torch.cat(want1, dim=1))
    pyr = TM.preprocess_pyramid_batched(rgbs, deps, use_depth=use_depth)
    assert torch.equal(pyr.grad_r0, want0[0]) and torch.equal(pyr.grad_r1, want1[0])
    if use_depth:
        assert pyr.norm_r0.data_ptr() == pyr.grad_r0.data_ptr() + 8 * R0[0, 0].numel()
        assert torch.equal(pyr.norm_r0, want0[1]) and torch.equal(pyr.norm_r1, want1[1])
    else:
        assert pyr.norm_r0 is None and pyr.norm_r1 is None
    # a channel-offset write leaves the other channels as they were
    stack = torch.full((2, 19, *q0.shape[1:]), 0xAB, dtype=torch.uint8)
    got = CK.spread_response(q0, 5, out=stack, channel=6)
    assert got.data_ptr() == stack[:, 6].data_ptr()
    assert torch.equal(stack[:, 6:14], want0[0])
    assert bool((stack[:, :6] == 0xAB).all()) and bool((stack[:, 14:] == 0xAB).all())
    with pytest.raises(ValueError, match="channel"):
        CK.spread_response(q0, 5, out=stack, channel=12)
