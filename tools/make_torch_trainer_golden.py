"""Write tests/data/torch_trainer_golden.npz: the JAX reference trainer's
banks at full width, against which the PyTorch port's trainer is held on
the card (chip_smoke.py phase 12, which reads only this file: the card's
machine has no JAX) and in the slow CPU test of tests/test_torch_trainer.py.

The mesh is the cuboid stand-in for the boxNew STL
(``utils.scenes.cuboid_mesh()``, 1952 triangles), written here as a binary
STL by the port's ``utils.stl.save_binary_stl`` and read back by the
reference's loader, so both trainers take the same path argument.  The
configuration is the reference's ``TrainerConfig()`` (640x480, fx
535.566011, fy 537.168115, the default view sphere) over its first
`VIEWS` views, in both modes: RGB-only (the default) and ColorGradient +
DepthNormal.  ``render_batch`` is 4 instead of 16, to bound the JAX CPU
render's memory; the bank does not depend on it.

Stored: `views`; per mode (`rgb`, `rgbd`) the two YAML files as gzip'd
bytes (`{mode}_templates_yml_gz`, `{mode}_params_yml_gz`, u8 arrays) and
`{mode}_kept` (the view index of each template); `rects` (VIEWS, 4), each
view's render rect as the reference's renderer gave it.

Runs the reference on the CPU (a 640x480 JAX CPU render takes seconds a
view, so several minutes; ~7 on a many-core x86 host):

    python tools/make_torch_trainer_golden.py [--out PATH] [--views N]
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWS = 32
RENDER_BATCH = 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_trainer_golden.npz"))
    ap.add_argument("--views", type=int, default=VIEWS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation_tpu.models import renderer as RD
    from linemod_pose_estimation_tpu.models.templates import DetectorParams
    from linemod_pose_estimation_tpu.models.trainer import TrainerConfig, train_and_write
    from linemod_pose_estimation_tpu.utils.viewsphere import ViewSphereParams, generate_views
    from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh
    from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl

    views = generate_views(ViewSphereParams())[:args.views]
    rects: list = []
    orig = RD.Renderer.render_batch

    def spy(self, Rs, Ts):  # records each rendered view's rect
        out = orig(self, Rs, Ts)
        rects.extend(np.asarray(out.rect))
        return out

    out: dict = {"views": args.views}
    with tempfile.TemporaryDirectory() as d:
        stl = os.path.join(d, "cuboid.stl")
        save_binary_stl(stl, cuboid_mesh().triangles)
        for mode, use_depth in (("rgb", False), ("rgbd", True)):
            cfg = TrainerConfig(detector=DetectorParams(use_depth_normal=use_depth),
                                render_batch=RENDER_BATCH)
            tyml, pyml = os.path.join(d, f"{mode}_t.yml"), os.path.join(d, f"{mode}_p.yml")
            rects.clear()
            RD.Renderer.render_batch = spy
            try:
                _, bank = train_and_write(stl, tyml, pyml, config=cfg, max_views=args.views)
            finally:
                RD.Renderer.render_batch = orig
            for kind, path in (("templates", tyml), ("params", pyml)):
                with open(path, "rb") as f:
                    z = gzip.compress(f.read(), mtime=0)
                out[f"{mode}_{kind}_yml_gz"] = np.frombuffer(z, np.uint8)
            out[f"{mode}_kept"] = np.array(
                [next(i for i, v in enumerate(views) if np.array_equal(v.R, R))
                 for R in bank.metadata.R], np.int32)
            out["rects"] = np.stack(rects[:args.views]).astype(np.int32)
            print(f"{mode}: {bank.num_templates} templates of {args.views} views",
                  flush=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
