"""The port's main path as a whole: Detector.read -> BatchedMatcher(
prune_mode="pooled") -> Matches, against the JAX reference on CPU; the
import boundary (no jax); and the committed golden batch.  The kernels'
tests on a card are in test_torch_cuda.py.

Tolerance: exact equality of every output (Matches, PooledStats, R0/R1).
"""

import hashlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.serving import BatchedMatcher as JMatcher
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher, slice_settings
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.utils import scenes as S

BANK = "data/boxNew_rgbd_templates.yml.gz"
GOLDEN = "tests/data/torch_port_golden.npz"



def test_batched_matcher_equals_reference():
    jd, td = JDetector.read(BANK), Detector.read(BANK)
    cid = td.class_ids[0]
    jb, tb = jd.bank(cid), td.bank(cid)
    jsub, tsub = JDetector(jb.params), Detector(tb.params)
    jsub.attach_bank(JBank(cid, jb.params, [jb.templates[i] for i in S.CROP_BANK_SUBSET]))
    tsub.attach_bank(TemplateBank(cid, tb.params, [tb.templates[i] for i in S.CROP_BANK_SUBSET]))
    B = 2
    kw = dict(top_k=64, prune=True, prune_mode="pooled", fine_g=4,
              group_bound=16, pool_coarse=56 * B, pool_fine=36 * B,
              pool_group=B * 15 * 20, sel_row_cap=128)
    rgbs, deps = S.golden_crops()
    jm = JMatcher(jsub, cid, 70.0, B, **kw)
    want = jm.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    tm = BatchedMatcher(tsub, cid, 70.0, B, **kw)
    got = tm.match_batch(rgbs, deps)
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name, a, b in zip(jm.last_pool._fields, tm.last_pool, jm.last_pool):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # the scene exercises the pooled branch and the walk
    assert not bool(tm.last_pool.fallback)
    assert int(got.valid.sum()) > 0


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with jax blocked
    and never pull in the JAX package."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import linemod_pose_estimation_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'linemod_pose_estimation_tpu'\n"
        "       or m.startswith('linemod_pose_estimation_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# The committed golden batch (tools/make_torch_port_golden.py).
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_golden_batch_on_cpu():
    """The full-size 8-frame batch on the untiled 2652-template bank:
    Matches, n_valid and per-frame R0/R1 hashes equal the JAX reference's."""
    with np.load(GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    rgbs, deps, _ = S.golden_batch(int(gold["seed"]))
    B = rgbs.shape[0]
    m = BatchedMatcher(td, cid, float(gold["threshold"]), B,
                       **slice_settings(B))
    R0, R1 = TM.preprocess_frames_batched(
        torch.from_numpy(rgbs), torch.from_numpy(deps), use_depth=True)
    for b in range(B):
        assert hashlib.sha256(R0[b].numpy().tobytes()).hexdigest() == str(gold["r0_sha256"][b])
        assert hashlib.sha256(R1[b].numpy().tobytes()).hexdigest() == str(gold["r1_sha256"][b])
    got = m.match_batch(rgbs, deps)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), gold[name], err_msg=name)
    np.testing.assert_array_equal(m.last_n_valid.numpy(), gold["n_valid"])
    for name in m.last_pool._fields:
        np.testing.assert_array_equal(getattr(m.last_pool, name).numpy(),
                                      gold["stats_" + name], err_msg=name)
