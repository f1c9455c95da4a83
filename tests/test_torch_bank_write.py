"""PyTorch port vs the JAX reference: bank writing and the YAML route —
utils/opencv_yaml.py (the port's own copy), TemplateBank.write_templates_yaml
/ write_params_yaml, the PyYAML branch of read_templates_yaml /
read_params_yaml, Detector.write / num_templates / template_rect0 — and the
RGB-only bank (C = 8, one modality) through BatchedMatcher.

Tolerance: a file written by the port is byte-identical to the same bank
written by the reference, and reads back equal (every feature row, size,
parameter and pose array) through the native loader, through PyYAML and,
where cv2 is importable, through cv2.FileStorage.  The RGB-only matches
equal the reference's exactly.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.serving import BatchedMatcher as JMatcher
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.utils import opencv_yaml as joy
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher
from linemod_pose_estimation_tpu_torch.models.templates import (DetectorParams,
                                                                TemplateBank,
                                                                TemplateFeatures)
from linemod_pose_estimation_tpu_torch.utils import native
from linemod_pose_estimation_tpu_torch.utils import opencv_yaml as oy
from linemod_pose_estimation_tpu_torch.utils import scenes as S

RGBD = "data/boxNew_rgbd_templates.yml.gz"
RGB = "data/boxNew_full_templates.yml.gz"
PARAMS = "data/boxNew_rgbd_params.yml.gz"
GOLDEN = "tests/data/opencv_linemod_golden.yml"


@pytest.fixture
def no_native(monkeypatch):
    """The bank readers as on a machine where the native loader cannot
    build: they take the PyYAML route."""
    monkeypatch.setattr(native, "available", lambda: False)


def _assert_banks_equal(a, b):
    assert a.class_id == b.class_id
    assert a.params == b.params
    assert len(a.templates) == len(b.templates)
    for ta, tb in zip(a.templates, b.templates):
        assert [tuple(s) for s in ta.size] == [tuple(s) for s in tb.size]
        assert tuple(ta.rect0) == tuple(tb.rect0)
        for la, lb in ((ta.grad, tb.grad), (ta.norm, tb.norm)):
            assert len(la) == len(lb)
            for fa, fb in zip(la, lb):
                np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def _port_bank(jbank, ids=None):
    """The reference bank's templates (all, or `ids`) as a port bank, and
    the reference bank over the same templates."""
    if ids is not None:
        jbank = JBank(jbank.class_id, jbank.params, [jbank.templates[i] for i in ids],
                      f_cap=jbank.f_cap)
    return jbank, convert.detector_from_reference(jbank, device="cpu").bank(jbank.class_id)


# ---------------------------------------------------------------------------
# The YAML emitter and parser
# ---------------------------------------------------------------------------

DOCS = {
    "scalars": {"a": 1, "b": 0.5, "c": 1000.0, "d": True, "e": "obj", "f": "a: b",
                "g": "", "h": np.float32(0.1), "i": np.int64(-3), "j": 1e-7, "k": -2.5e20},
    "matrices": {"R": joy.CvMatrix(np.arange(9, dtype=np.float64).reshape(3, 3) / 7.0),
                 "K": joy.CvMatrix(np.array([[535.5, 0, 320], [0, 537.1, 240], [0, 0, 1]],
                                            np.float32)),
                 "depth": joy.CvMatrix(np.arange(60, dtype=np.uint16).reshape(3, 20) * 37),
                 "mask": np.eye(4, dtype=np.uint8) * 255,
                 "row": joy.CvMatrix(np.arange(5, dtype=np.int32))},
    "sequences": {"rect": [1, 2, 3, 4], "empty": [], "long": list(range(60)),
                  "pairs": [[1, 2], [3, 4]], "floats": np.linspace(0, 1, 7),
                  "rows": joy.BlockRows([[14, 2, 4], [22, 2, 4]]),
                  "no_rows": joy.BlockRows([]),
                  "maps": [{"type": "ColorGradient", "weak_threshold": 10.0},
                           {"type": "DepthNormal", "nested": {"x": 1, "y": [1.5, 2]}}]},
}


def _to_port(v):
    """A reference document's marker objects as the port's."""
    if isinstance(v, joy.CvMatrix):
        return oy.CvMatrix(v.array)
    if isinstance(v, joy.BlockRows):
        return oy.BlockRows(v)
    if isinstance(v, dict):
        return {k: _to_port(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_port(x) for x in v]
    return v


@pytest.mark.parametrize("name", list(DOCS))
def test_emitter_equals_reference_and_parses_back(name):
    text = oy.dumps(_to_port(DOCS[name]))
    assert text == joy.dumps(DOCS[name])
    got, want = oy.loads(text), joy.loads(text)
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


def test_writer_needs_no_pyyaml(monkeypatch, tmp_path):
    """The writer half runs where PyYAML is absent (importing it fails
    only inside loads)."""
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    p = tmp_path / "doc.yml"
    oy.dump({"x": oy.CvMatrix(np.eye(2)), "n": 3}, str(p))
    assert p.read_text().startswith("%YAML:1.0\n---\nx: !!opencv-matrix\n")
    with pytest.raises(ImportError):
        oy.load(str(p))


def test_emitted_yaml_readable_by_opencv(tmp_path):
    cv2 = pytest.importorskip("cv2")
    R = np.arange(9, dtype=np.float64).reshape(3, 3) / 7.0
    p = str(tmp_path / "emit.yml")
    oy.dump({"Template 0": {"ID": 7, "R": oy.CvMatrix(R), "Rect": [276, 205, 89, 67]},
             "renderer_radius_step": 0.1, "renderer_far": 1000.0}, p)
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    node = fs.getNode("Template 0")
    assert int(node.getNode("ID").real()) == 7
    np.testing.assert_allclose(node.getNode("R").mat(), R)
    assert [int(node.getNode("Rect").at(i).real()) for i in range(4)] == [276, 205, 89, 67]
    np.testing.assert_allclose(fs.getNode("renderer_radius_step").real(), 0.1)
    fs.release()


def test_opencv_written_yaml_readable_by_port(tmp_path):
    cv2 = pytest.importorskip("cv2")
    p = str(tmp_path / "cvout.yml")
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_WRITE)
    fs.write("mat", np.linspace(0, 1, 12).reshape(3, 4))
    fs.write("count", 42)
    fs.write("name", "obj")
    fs.release()
    doc = oy.load(p)
    np.testing.assert_allclose(doc["mat"], np.linspace(0, 1, 12).reshape(3, 4))
    assert doc["count"] == 42 and doc["name"] == "obj"


# ---------------------------------------------------------------------------
# Template banks: written bytes, and both read routes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_banks():
    out = {}
    for key, path in (("rgbd", RGBD), ("rgb", RGB)):
        jd = JDetector.read(path)
        out[key] = jd.bank(jd.class_ids[0])
    return out


def _depth_only_bank():
    t = TemplateFeatures(
        grad=[], norm=[np.array([[3, 11, 4], [7, 25, 2]], np.int32),
                       np.array([[2, 6, 3]], np.int32)],
        size=[(30, 40), (15, 20)], rect0=(0, 0, 40, 30))
    return TemplateBank("depth_obj", DetectorParams(use_color_gradient=False,
                                                    use_depth_normal=True), [t], f_cap=8)


BANK_CASES = {"rgbd_subset": ("rgbd", list(range(0, 2652, 83))),
              "rgb_subset": ("rgb", list(range(5, 2652, 97))),
              "rgb_every_7th": ("rgb", list(range(0, 2652, 7)))}


@pytest.mark.parametrize("case", list(BANK_CASES))
def test_written_bank_is_byte_identical_and_reads_back(reference_banks, tmp_path, case,
                                                       monkeypatch):
    key, ids = BANK_CASES[case]
    jbank, tbank = _port_bank(reference_banks[key], ids)
    pj, pt = str(tmp_path / "ref.yml"), str(tmp_path / "port.yml")
    jbank.write_templates_yaml(pj)
    tbank.write_templates_yaml(pt)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    assert tbank._modality_names() == jbank._modality_names()
    assert native.available()
    by_native = TemplateBank.read_templates_yaml(pt)
    _assert_banks_equal(by_native, tbank)
    monkeypatch.setattr(native, "available", lambda: False)
    by_yaml = TemplateBank.read_templates_yaml(pt)
    _assert_banks_equal(by_yaml, tbank)
    # a gzipped file reads the same way
    pz = pt + ".gz"
    with open(pt, "rb") as f, gzip.open(pz, "wb") as g:
        g.write(f.read())
    _assert_banks_equal(TemplateBank.read_templates_yaml(pz), tbank)


def test_depth_only_bank_roundtrip(tmp_path, monkeypatch):
    bank = _depth_only_bank()
    p = str(tmp_path / "depth_only.yml")
    bank.write_templates_yaml(p)
    jb = JBank.read_templates_yaml(p, f_cap=8)
    pj = str(tmp_path / "ref.yml")
    jb.write_templates_yaml(pj)
    with open(p, "rb") as f, open(pj, "rb") as g:
        assert f.read() == g.read()
    for route in ("native", "yaml"):
        if route == "yaml":
            monkeypatch.setattr(native, "available", lambda: False)
        b2 = TemplateBank.read_templates_yaml(p, f_cap=8)
        assert not b2.params.use_color_gradient and b2.params.use_depth_normal
        _assert_banks_equal(b2, bank)


def test_yaml_route_reads_opencv_layout_bank(no_native):
    """A cv::linemod-layout templates.yml (entries carry no modality name,
    feature rows are [x, y, label]) through PyYAML equals the reference's
    reading of it."""
    bank = TemplateBank.read_templates_yaml(GOLDEN, f_cap=8)
    assert bank.class_id == "golden_obj" and len(bank.templates) == 2
    np.testing.assert_array_equal(
        bank.templates[0].grad[0], np.array([[3, 11, 4], [7, 25, 2], [29, 39, 7]], np.int32))
    np.testing.assert_array_equal(bank.templates[0].norm[1], np.array([[4, 2, 5]], np.int32))
    jb = JBank.read_templates_yaml(GOLDEN, f_cap=8)
    _assert_banks_equal(bank, convert.detector_from_reference(jb, device="cpu").bank(jb.class_id))


def test_written_bank_readable_by_opencv(tmp_path):
    cv2 = pytest.importorskip("cv2")
    t = TemplateFeatures(
        grad=[np.array([[3, 11, 4], [7, 25, 2]], np.int32), np.array([[2, 6, 3]], np.int32)],
        norm=[], size=[(30, 40), (15, 20)], rect0=(0, 0, 40, 30))
    det = Detector(DetectorParams(), f_cap=8, device="cpu")
    det.attach_bank(TemplateBank("obj", det.params, [t], f_cap=8))
    p = str(tmp_path / "templates.yml")
    det.write(p)
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    cls = fs.getNode("classes").at(0)
    assert cls.getNode("class_id").string() == "obj"
    assert cls.getNode("modalities").at(0).string() == "ColorGradient"
    e0 = cls.getNode("template_pyramids").at(0).getNode("templates").at(0)
    assert int(e0.getNode("width").real()) == 40
    f0 = e0.getNode("features").at(0)
    assert [int(f0.at(i).real()) for i in range(3)] == [11, 3, 4]  # [x, y, label]
    fs.release()


# ---------------------------------------------------------------------------
# Pose metadata
# ---------------------------------------------------------------------------


def test_written_params_are_byte_identical_and_read_back(tmp_path, monkeypatch):
    jmeta, jglob = JBank.read_params_yaml(PARAMS)
    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    n = 40  # the first templates: their records index the metadata rows
    jd = JDetector.read(GOLDEN)
    jb = jd.bank(jd.class_ids[0])
    jbank = JBank("obj", jb.params, jb.templates * (n // 2), metadata=jmeta,
                  globals_=jglob)
    tbank = TemplateBank("obj", convert.detector_params_from_reference(jb.params),
                         convert.templates_from_reference(jb.templates) * (n // 2),
                         metadata=meta, globals_=glob)
    pj, pt = str(tmp_path / "ref.yml"), str(tmp_path / "port.yml")
    jbank.write_params_yaml(pj)
    tbank.write_params_yaml(pt)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()

    def check(m, g):
        assert g == glob
        for name in ("R", "T", "K", "D", "Ori_dist", "Rect"):
            a, b = getattr(m, name), getattr(meta, name)[:n]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)

    check(*TemplateBank.read_params_yaml(pt))
    monkeypatch.setattr(native, "available", lambda: False)
    check(*TemplateBank.read_params_yaml(pt))
    jm, _ = JBank.read_params_yaml(pt)
    np.testing.assert_array_equal(jm.R, meta.R[:n])


def test_yaml_route_equals_native_on_committed_params(monkeypatch):
    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    monkeypatch.setattr(native, "available", lambda: False)
    meta2, glob2 = TemplateBank.read_params_yaml(PARAMS)
    assert glob2 == glob and meta2.R.shape == (2652, 3, 3)
    for name in ("R", "T", "K", "D", "Ori_dist", "Rect"):
        np.testing.assert_array_equal(getattr(meta2, name), getattr(meta, name), err_msg=name)


def test_write_params_needs_metadata(tmp_path):
    with pytest.raises(ValueError, match="no pose metadata"):
        _depth_only_bank().write_params_yaml(str(tmp_path / "p.yml"))


def test_written_params_readable_by_opencv(tmp_path):
    cv2 = pytest.importorskip("cv2")
    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    bank = _depth_only_bank()
    bank.metadata, bank.globals = meta, glob
    p = str(tmp_path / "params.yml")
    bank.write_params_yaml(p)
    fs = cv2.FileStorage(p, cv2.FILE_STORAGE_READ)
    node = fs.getNode("Template 0")
    np.testing.assert_array_equal(node.getNode("R").mat(), meta.R[0])
    np.testing.assert_array_equal(node.getNode("K").mat(), meta.K[0])
    assert node.getNode("D").real() == meta.D[0]
    assert [int(node.getNode("Rect").at(i).real()) for i in range(4)] == list(meta.Rect[0])
    assert fs.getNode("renderer_focal_length_x").real() == glob.focal_length_x
    fs.release()


# ---------------------------------------------------------------------------
# Detector surface
# ---------------------------------------------------------------------------


def test_detector_num_templates_rect0_and_write(reference_banks, tmp_path):
    jbank, tbank = _port_bank(reference_banks["rgbd"], list(range(0, 2652, 221)))
    jd = JDetector(jbank.params)
    jd.attach_bank(jbank)
    td = Detector(tbank.params, device="cpu")
    td.attach_bank(tbank)
    td.attach_bank(TemplateBank("second", tbank.params, tbank.templates[:5]))
    assert td.num_templates(jbank.class_id) == jd.num_templates(jbank.class_id) == 12
    assert td.num_templates("second") == 5 and td.num_templates() == 17
    assert td.num_templates("absent") == jd.num_templates("absent") == 0
    for i in (0, 7, 11):
        assert td.template_rect0(jbank.class_id, i) == jd.template_rect0(jbank.class_id, i)
    pj, pt, p2 = (str(tmp_path / n) for n in ("ref.yml", "port.yml", "second.yml"))
    jd.write(pj)
    td.write(pt)
    td.write(p2, "second")
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    back = Detector.read(p2, device="cpu")
    assert back.class_ids == ["second"] and back.num_templates() == 5


# ---------------------------------------------------------------------------
# The RGB-only bank through the batched matcher
# ---------------------------------------------------------------------------

RGB_THR = 60.0
RGB_MODES = {"exhaustive": dict(),
             "pooled": dict(prune=True, prune_mode="pooled"),
             "positions": dict(prune=True),
             "positions_fine_overflow": dict(prune=True, fine_pos_cap=1)}


@pytest.fixture(scope="module")
def rgb_detectors(reference_banks):
    ids = sorted(set(S.CROP_BANK_SUBSET))
    jbank, tbank = _port_bank(reference_banks["rgb"], ids)
    jd = JDetector(jbank.params)
    jd.attach_bank(jbank)
    td = Detector(tbank.params, device="cpu")
    td.attach_bank(tbank)
    return jd, td, jbank.class_id


@pytest.mark.parametrize("mode", list(RGB_MODES))
def test_rgb_only_bank_matches_reference(rgb_detectors, mode):
    jd, td, cid = rgb_detectors
    rgbs, _ = S.golden_crops()
    B = rgbs.shape[0]
    kw = dict(top_k=64, **RGB_MODES[mode])
    jm = JMatcher(jd, cid, RGB_THR, B, **kw)
    want = jm.match_batch(jnp.asarray(rgbs))
    tm = BatchedMatcher(td, cid, RGB_THR, B, device="cpu", **kw)
    assert not tm.use_depth and tm.feats1.oris.max() < 8
    R0, cands, n_valid = tm.candidates(rgbs)
    assert R0.shape == (B, 8, 240, 320)  # one modality: 8 channels
    got = tm.refine(R0, cands, n_valid)
    for name, a, b in zip(want._fields, got, want):
        a, b = a.numpy(), np.asarray(b)
        if b.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got.valid.sum()) > 0
    for name, ours, theirs in (("last_pool", tm.last_pool, jm.last_pool),
                               ("last_prune", tm.last_prune, jm.last_prune),
                               ("last_fine", tm.last_fine, jm.last_fine)):
        assert (ours is None) == (theirs is None), name
        if ours is not None:
            for f, a, b in zip(theirs._fields, ours, theirs):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name}.{f}")
