"""Multi-camera frame ingest on the host — the port of the host-side half
of ``linemod_pose_estimation_tpu/parallel/ingest.py`` (numpy, copied).

`FrameBatcher` polls any number of camera callables (grab services,
replay fixtures) round-robin into fixed-size batches; `PacedSource` is a
camera with a fixed frame cadence and a ring-buffer backlog, so a
streaming run measures latency under load rather than in lockstep.  The
batches are pageable numpy arrays: the step that takes them copies them
to the card.  `put_global_batch` turns each rank's frames into its shard
of the global batch over a device mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch


class FrameBatcher:
    """Round-robin N camera sources into (B, H, W, 3) u8 + (B, ...) cloud
    batches (B = frames per step)."""

    def __init__(self, sources: Sequence[Callable[[], object]], batch: int):
        if not sources:
            raise ValueError("need at least one frame source")
        self.sources = list(sources)
        self.batch = batch
        self._i = 0

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        rgbs, clouds = [], []
        for _ in range(self.batch):
            f = self.sources[self._i % len(self.sources)]()
            self._i += 1
            rgbs.append(np.asarray(f.rgb))
            clouds.append(np.asarray(f.cloud))
        return np.stack(rgbs), np.stack(clouds)

    def poll_batch(self, now: float | None = None):
        """Take whatever frames the paced sources have ready, up to
        `batch`, without waiting: camera cadence, not the matcher, sets the
        arrival rate, and late frames batch up instead of dropping.

        Sources expose poll(now) -> (frame, t_grab) | None (see
        PacedSource).  Returns (rgbs (B, ...), clouds (B, ...), stamps
        (B,), n_filled); slots past n_filled repeat the last real frame so
        the step's shapes never change — callers mask by n_filled.  Returns
        None when no source had a frame ready."""
        if now is None:
            now = time.perf_counter()
        rgbs, clouds, stamps = [], [], []
        for k in range(len(self.sources)):
            if len(rgbs) >= self.batch:
                break
            src = self.sources[(self._i + k) % len(self.sources)]
            got = src.poll(now)
            while got is not None:
                f, t_grab = got
                rgbs.append(np.asarray(f.rgb))
                clouds.append(np.asarray(f.cloud))
                stamps.append(t_grab)
                if len(rgbs) >= self.batch:
                    break
                got = src.poll(now)
        self._i += 1  # rotate the polling priority for fairness
        n = len(rgbs)
        if n == 0:
            return None
        while len(rgbs) < self.batch:  # pad: repeat the last real frame
            rgbs.append(rgbs[n - 1])
            clouds.append(clouds[n - 1])
            stamps.append(stamps[n - 1])
        return np.stack(rgbs), np.stack(clouds), np.asarray(stamps), n


class PacedSource:
    """A camera with a fixed frame cadence: poll(now) returns (frame,
    t_grab) for each elapsed frame period, else None.  A slow consumer
    sees a backlog of up to `max_backlog` frames, past which the oldest
    are dropped (a sensor ring buffer) and counted in `dropped`."""

    def __init__(self, fn: Callable[[], object], fps: float,
                 start: float | None = None, max_backlog: int = 64):
        self.fn = fn
        self.period = 1.0 / float(fps)
        # None anchors the cadence to the first poll's clock: a fixed 0.0
        # against a perf_counter-scale `now` would fabricate a huge backlog.
        self._next_due = start
        self.max_backlog = max_backlog
        self.dropped = 0

    def poll(self, now: float):
        if self._next_due is None:
            self._next_due = now
        if now < self._next_due:
            return None
        behind = int((now - self._next_due) / self.period)
        if behind >= self.max_backlog:
            self.dropped += behind - self.max_backlog + 1
            self._next_due += (behind - self.max_backlog + 1) * self.period
        t_grab = self._next_due
        self._next_due += self.period
        return self.fn(), t_grab


def put_global_batch(mesh, local_rgbs, local_depths=None):
    """This rank's frames as its shard of the GLOBAL data-parallel batch:
    the port of the reference's `make_array_from_process_local_data` seam.

    Every rank calls this with its cameras' frames (equal batch sizes);
    the result is a DTensor over `mesh` placed as `frame_sharding`, whose
    global batch is the sum of the "data" rows' local batches.  The ranks
    of one "data" row hold the row's first rank's frames (the "bank" dim
    is replicated: DTensor.from_local(run_check=True) broadcasts them).
    Returns (rgbs, depths or None), on the mesh's device type (a CUDA mesh:
    the current device); the sharded steps take these or plain local
    tensors."""
    from torch.distributed.tensor import DTensor

    from .mesh import frame_sharding

    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))

    def put(a):
        t = torch.as_tensor(np.asarray(a)).to(device)
        return DTensor.from_local(t, mesh, frame_sharding(mesh), run_check=True)

    return put(local_rgbs), None if local_depths is None else put(local_depths)
