"""The bound reckoner (ops/roofline.py): byte and operation counts at the
main path's shapes, and which of the two bounds each kernel."""

import pytest

from linemod_pose_estimation_tpu_torch.ops import roofline as RL


def test_preprocess_kernels_at_the_main_path_shapes():
    k1_0 = RL.quantize_cg(32, 480, 640, 1)
    assert k1_0.bytes == 39_321_600
    assert k1_0.by == "operations"
    assert k1_0.ms == pytest.approx(32 * 480 * 640 * RL.QUANTIZE_CG_OPS_PER_PX / 67e9)
    k1_1 = RL.quantize_cg(32, 240, 320, 4)  # level 1: the f32 pyrDown output
    assert k1_1.bytes == 31_948_800 and k1_1.by == "bytes"
    assert k1_1.ms == pytest.approx(31_948_800 / 3.35e9)
    for T in (5, 8):
        k2 = RL.spread_response(32, 480, 640, T)
        assert k2.bytes == 88_473_600 and k2.by == "bytes"
        assert k2.ms == pytest.approx(88_473_600 / 3.35e9)
    assert RL.spread_response(32, 240, 320, 8).bytes == 22_118_400
    assert RL.spread_response(1, 480, 640, 5).bytes == 2_764_800  # K2b


def test_data_dependent_kernels():
    # K3: 568 walked slots of 4096, 120 live features each; the operands of
    # the 3528 slots past n_valid are not counted, their zero scores are
    k3 = RL.walk_scores(32, 128, 128, 568, 568 * 120, 1_000_000)
    assert k3.ops == 568 * 120 * 256
    assert k3.bytes == (32 * 4 + 568 * (8 + 128) + 568 * 120 * 12 + 1_000_000
                        + 32 * 128 * 1024)
    assert k3.by == "bytes"
    assert RL.walk_scores(32, 128, 128, 0, 0, 0).bytes == 32 * 4 + 32 * 128 * 1024
    # K4 is operation-bound at the cascade's shapes, K5 at 4096 candidates
    k4 = RL.raster_zbuffer(8, 1984, 256, 256, 21, 10**8)
    assert k4.by == "operations" and k4.ops == 10**8 * RL.RASTER_OPS_PER_PAIR
    k5 = RL.refine_scores(4096, 128, 24, 4096 * 100, 2_000_000)
    assert k5.ops == 4096 * 100 * 576
    # operands of the live slots only: slots past nf[k] are never read
    assert k5.bytes == 4096 * 100 * 12 + 4096 * 16 + 2_000_000 + 4096 * 576 * 4
    assert RL.refine_scores(4096, 128, 24, 0, 0).bytes == 4096 * 16 + 4096 * 576 * 4


def test_bound_takes_the_larger_time():
    b = RL.bound(3_350_000_000, 10**9)  # 1 ms of bytes, 0.015 ms of operations
    assert (b.bytes, b.ops, b.by) == (3_350_000_000, 10**9, "bytes")
    assert b.ms == pytest.approx(1.0)
    b = RL.bound(10**6, 67_000_000_000)
    assert b.by == "operations" and b.ms == pytest.approx(1.0)


def test_select_topk_counts_raw_once_whatever_the_passes():
    # TK at batch32-fullbin's shape: 32 frames of 1200 x 10,624 int32
    # scores, the (1200, 10,624) bool mask, the f32 scale, (32, 128) f32
    # values and int64 indices out; bytes bound it
    tk = RL.select_topk(32, 1200, 10624, 128)
    n = 1200 * 10624
    assert tk.bytes == 32 * n * 4 + n + 10624 * 4 + 32 * 128 * 12
    assert tk.ops == 32 * n * RL.SELECT_TOPK_OPS_PER_ELEMENT
    assert tk.by == "bytes" and tk.ms == pytest.approx(tk.bytes / 3.35e9)
    assert RL.select_topk(1, 1200, 2652, 512).bytes == 1200 * 2652 * 5 + 2652 * 4 + 512 * 12


def test_bound_margins_counts_int8_products_on_the_tensor_cores():
    # BM at the cell tier's shape: 38,400 rows of 2304 int8 against 10,624
    # templates; products over ceil8(N), held to the int8 tensor-core peak
    bm = RL.bound_margins(38400, 10624, 2304, 1200)
    assert bm.ops == 2 * 38400 * 10624 * 2304 and bm.by == "operations"
    assert bm.ms == pytest.approx(bm.ops / 1979e9)
    assert bm.bytes == 38400 * 2304 + 10624 * 2304 + 1200 * 10624 + 10624 * 4 + 38400 * 4
    # the weight's zero rows to a multiple of 8 are multiplied too
    assert RL.bound_margins(9, 37, 32, 5).ops == 2 * 9 * 40 * 32
