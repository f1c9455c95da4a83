"""Write tests/data/torch_aux_golden.npz: the JAX reference's answers for the
grasp planner, the cloud segmentation ops and the aux filters, which the
PyTorch port is held against (tests/test_torch_segmentation.py,
tests/test_torch_filters.py and phase 13 of chip_smoke.py, which reads
only this file: the card's machine has no JAX).  In-repo data only.

Clouds (`{name}_*` for view00, view45, roi):
- view00, view45: the scene clouds of data/sweep_view{00,45}_clouds.npz
  (1024 slots, the cascade's scene_cap);
- roi: 4096 points of frame 0 of tests/data/torch_cascade_golden.npz
  inside its first detection's rect (depth_to_cloud at the bank's focal
  lengths, principal point at the frame's centre, then
  extract_rect_points), stored as `roi_pts` / `roi_valid`.
For each: `mls` (mls_smooth at its defaults), `support` (each point's
neighbours within the MLS radius: below 3 the plane is the solver's
choice), `normals` / `curvature` (estimate_normals(k=50) of `mls`),
`region` and `pose` (grasping_pose_region_growing at its defaults),
`euclid` (euclidean_cluster_largest at EUCLID_TOL, which splits both
sweep clouds).

Filters, on the four golden frames (rgb (4, 480, 640, 3), depth_mm) and
on seeded inputs (numpy default_rng(SEED)): a 480x640 RGB image `noise`
(integers in [0, 256)), 64 rects and 512 vote cells:
- `hsv_sha256` (4, 32) u8: the SHA-256 of each frame's rgb_to_hsv_u8
  (f32 bytes), `hsv_noise_sha256` the noise image's, with every 16th row
  and column kept as `hsv_sample` / `hsv_noise_sample`;
- `gate` (R, G): hsv_color_filter under each range of GATE_RANGES at
  `gate_rects` (R, 4) on frame `gate_frame` (R,) (-1: the noise image):
  each frame's Matches' valid rects (x, y and the matched template's
  level-0 rect size), then the seeded rects;
- `absrect` (4, 2, 4): absolute_rectangle of (1500 - depth_mm) at
  threshold 10 inside the frame's first detection rect and the whole
  frame; `absrect_noise` (64, 4): of the noise image's green channel (f32)
  at threshold 250 inside each seeded rect;
- `nms_keep` (4, 2, 512): nms_distance over each frame's Matches slots,
  cells (y // 8, x // 8, template % 4), scored by similarity, valid by the
  Matches' flag, at neighbour sizes NMS_SIZES; `nms_noise_keep` (2, 512)
  over the seeded cells `nms_cells` (hy, hx in [0, 40), hd in [0, 4)),
  `nms_scores` (multiples of 0.5 in [80, 100): ties) and `nms_valid` (80 %).

Runs the reference on the CPU (~20 s):

    python tools/make_torch_aux_golden.py [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")
BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
FX, FY = 535.566011, 537.168115  # the bank's focal lengths (its params file)
ROI_CAP = 4096
MLS_RADIUS = 0.04  # mls_smooth's default
EUCLID_TOL = 0.005
SEED = 13
GATE_RANGES = (((0.0, 180.0), (0.0, 255.0), (0.0, 255.0)),
               ((0.0, 30.0), (50.0, 255.0), (50.0, 255.0)),
               ((90.0, 150.0), (0.0, 255.0), (0.0, 255.0)),
               ((0.0, 180.0), (0.0, 20.0), (0.0, 222.0)))
NMS_SIZES = (1, 3)


def sha(a) -> "np.ndarray":
    import numpy as np

    return np.frombuffer(hashlib.sha256(np.ascontiguousarray(a).tobytes()).digest(), np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_aux_golden.npz"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation_tpu.models.grasp import grasping_pose_region_growing
    from linemod_pose_estimation_tpu.models.templates import TemplateBank
    from linemod_pose_estimation_tpu.ops import filters as FL
    from linemod_pose_estimation_tpu.ops import segmentation as seg
    from linemod_pose_estimation_tpu.utils import pointcloud as pcu

    out = {}
    with np.load(FRAMES) as z:
        g = {k: z[k] for k in z.files}

    # -- clouds ----------------------------------------------------------------
    clouds = {}
    for name in ("view00", "view45"):
        with np.load(os.path.join(REPO, "data", f"sweep_{name}_clouds.npz")) as z:
            clouds[name] = (z["scene"], z["svalid"])
    H, W = g["depth_mm"].shape[1:]
    K = jnp.array([[FX, 0, W / 2.0], [0, FY, H / 2.0], [0, 0, 1.0]], jnp.float32)
    cloud = pcu.depth_to_cloud(jnp.asarray(g["depth_mm"][0]) / 1000.0, K)
    pts, valid = pcu.extract_rect_points(cloud, jnp.asarray(g["p_rect"][0, 0]), ROI_CAP)
    clouds["roi"] = (np.asarray(pts), np.asarray(valid))
    out["roi_pts"], out["roi_valid"] = clouds["roi"]

    for name, (p, v) in clouds.items():
        p, v = jnp.asarray(p), jnp.asarray(v)
        sm = seg.mls_smooth(p, v)
        idx, ok = seg.knn_indices(p, v, 32)
        d2 = jnp.sum((p[idx] - p[:, None, :]) ** 2, axis=-1)
        n, c = seg.estimate_normals(sm, v, k=50)
        pose, region = grasping_pose_region_growing(p, v)
        out.update({
            f"{name}_mls": np.asarray(sm),
            f"{name}_support": np.asarray(jnp.sum(ok & (d2 < MLS_RADIUS**2), axis=1),
                                          np.int32),
            f"{name}_normals": np.asarray(n), f"{name}_curvature": np.asarray(c),
            f"{name}_region": np.asarray(region), f"{name}_pose": np.asarray(pose),
            f"{name}_euclid": np.asarray(seg.euclidean_cluster_largest(p, v, EUCLID_TOL)),
        })
        print(name, int(v.sum()), "valid,", int(region.sum()), "in the region, z",
              float(pose[2, 3]), "euclid", int(out[f"{name}_euclid"].sum()), flush=True)

    # -- filters ----------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    noise = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    xy = rng.integers(-20, [W, H], (64, 2))
    seeded_rects = np.concatenate([xy, rng.integers(1, 200, (64, 2))], 1).astype(np.int32)
    out["nms_cells"] = np.concatenate([rng.integers(0, 40, (512, 2)),
                                       rng.integers(0, 4, (512, 1))], 1).astype(np.int32)
    out["nms_scores"] = (80.0 + 0.5 * rng.integers(0, 40, 512)).astype(np.float32)
    out["nms_valid"] = rng.random(512) < 0.8

    hsv = [np.asarray(FL.rgb_to_hsv_u8(jnp.asarray(f))) for f in g["rgb"]]
    out["hsv_sha256"] = np.stack([sha(h) for h in hsv])
    out["hsv_sample"] = np.stack([h[::16, ::16] for h in hsv])
    hn = np.asarray(FL.rgb_to_hsv_u8(jnp.asarray(noise)))
    out["hsv_noise_sha256"], out["hsv_noise_sample"] = sha(hn), hn[::16, ::16]

    templates = TemplateBank.read_templates_yaml(BANK).templates
    rects, frames = [], []
    for f in range(len(g["rgb"])):
        for s in np.nonzero(g["m_valid"][f])[0]:
            _, _, w, h = templates[g["m_template_id"][f, s]].rect0
            rects.append([g["m_x"][f, s], g["m_y"][f, s], w, h])
            frames.append(f)
    out["gate_rects"] = np.concatenate([np.asarray(rects, np.int32), seeded_rects])
    out["gate_frame"] = np.asarray(frames + [-1] * len(seeded_rects), np.int32)
    imgs = list(g["rgb"]) + [noise]
    out["gate"] = np.asarray([[bool(FL.hsv_color_filter(jnp.asarray(imgs[f]), jnp.asarray(r),
                                                         *ranges))
                               for ranges in GATE_RANGES]
                              for f, r in zip(out["gate_frame"], out["gate_rects"])])

    full = np.array([0, 0, W, H], np.int32)
    out["absrect"] = np.stack([
        np.stack([np.asarray(FL.absolute_rectangle(jnp.asarray(1500.0 - g["depth_mm"][f]),
                                                   jnp.asarray(roi), 10.0))
                  for roi in (g["p_rect"][f, 0], full)])
        for f in range(len(g["rgb"]))])
    green = jnp.asarray(noise[..., 1].astype(np.float32))
    out["absrect_noise"] = np.stack([np.asarray(FL.absolute_rectangle(green, jnp.asarray(r),
                                                                      250.0))
                                     for r in seeded_rects])
    keep = []
    for f in range(len(g["rgb"])):
        cells = np.stack([g["m_y"][f] // 8, g["m_x"][f] // 8, g["m_template_id"][f] % 4], -1)
        keep.append([np.asarray(FL.nms_distance(jnp.asarray(cells.astype(np.int32)),
                                                jnp.asarray(g["m_similarity"][f]),
                                                jnp.asarray(g["m_valid"][f]), s))
                     for s in NMS_SIZES])
    out["nms_keep"] = np.asarray(keep)
    out["nms_noise_keep"] = np.stack([
        np.asarray(FL.nms_distance(jnp.asarray(out["nms_cells"]),
                                   jnp.asarray(out["nms_scores"]),
                                   jnp.asarray(out["nms_valid"]), s)) for s in NMS_SIZES])
    print("gates", out["gate"].sum(0).tolist(), "of", len(out["gate"]), "absrect",
          out["absrect"].tolist(), "nms kept", out["nms_keep"].sum(-1).tolist(),
          out["nms_noise_keep"].sum(-1).tolist(), "of", int(out["nms_valid"].sum()))
    np.savez_compressed(args.out, **out)
    print("wrote", args.out, os.path.getsize(args.out), "bytes")


if __name__ == "__main__":
    main()
