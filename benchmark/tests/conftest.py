"""Small cells for the CPU tests: the committed RGB-D bank cut to a slice
that holds the templates the seed's views are rendered from, so the
planted objects match; frames keep their 640x480 (the bank's templates do
not fit smaller ones)."""

import json
import os

import pytest
import torch

from benchmark import run as R
from benchmark.harness.common import seeded_templates

SEED = 2**31 + 77
PARAMS = "data/boxNew_rgbd_params.yml.gz"


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    torch.set_num_threads(min(8, os.cpu_count() or 1))


@pytest.fixture(scope="session")
def manifest():
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def slice_bank(tmp_path_factory):
    """A 33-template slice of the bank (every 83rd template and the seed's
    view) written as a bank file; returns its path."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank

    det = Detector.read(os.path.join(R.BENCH, "data/boxNew_rgbd_templates.yml.gz"),
                        device="cpu")
    cid = det.class_ids[0]
    bank = det.bank(cid)
    keep = sorted(set(seeded_templates(SEED, 2652, 1).tolist()) | set(range(0, 2652, 83)))
    path = str(tmp_path_factory.mktemp("bank") / "slice.yml")
    TemplateBank(cid, bank.params, [bank.templates[i] for i in keep]).write_templates_yaml(path)
    return path


@pytest.fixture(scope="session")
def batch_cell(slice_bank):
    config = {"templates": slice_bank, "params": PARAMS, "tile": [2, 2 * 33 + 6]}
    traffic = {"driver": "batch", "batch": 2, "pool": 2, "objects": 1, "views": 1,
               "threshold": 91.0, "trace_steps": 1}
    return {"name": "batch32-planted", "chips": 1}, config, traffic
