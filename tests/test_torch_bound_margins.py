"""The pooled tiers' bound seam, ops/match.py::bound_margins, on the CPU:
its plain route (the route every CPU call takes, and a card's with
`plain=True`) equals, bit for bit, the chain the tiers ran before it: the
int8 GEMM, then the validity gather vpos[pos] & keep, the subtraction of
t, the select against the sentinel and the row max.  The operand sets
(utils/kernel_cases.py) are the four call shapes cut to a CPU's size (the
group tier's rows m % P, the cell tier's pool with dead slots, the fine
tier's K = 9216, every position at the int32 minimum), and n % 8 != 0,
M <= 16, K % 16 != 0, full-range int8 operands and one template.  The
card holds kernel BM to the same plain route (tests/test_torch_cuda.py).
"""

import pytest
import torch

from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC


@pytest.mark.parametrize("case", list(KC.BOUND_MARGIN_CASES))
def test_bound_margins_plain_route_equals_the_chain(case):
    A, nk, n, t, vpos, pos, keep, sentinel = KC.bound_margin_case(case, "cpu")
    W = TM.MatmulWeight(nk, n)
    M = A.shape[0]
    rows = torch.arange(M) % vpos.shape[0] if pos is None else pos
    valid = vpos[rows]
    if keep is not None:
        valid = valid & keep[:, None]
    ub = TM.int8_mm(A, W)
    want = torch.where(valid, ub - t[None, :], sentinel).amax(dim=1)
    assert want.dtype == torch.int32 and want.shape == (M,)
    if keep is not None:
        assert (want[~keep] == sentinel).all()
    for plain in (False, True):
        got = TM.bound_margins(A, W, t, vpos, pos, keep, sentinel, plain)
        assert got.dtype == torch.int32 and torch.equal(got, want), plain
