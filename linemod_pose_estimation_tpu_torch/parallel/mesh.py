"""Device mesh and rank launcher for multi-device LINEMOD, on
``torch.distributed`` — the port of ``linemod_pose_estimation_tpu/
parallel/mesh.py``.

Axes, as in the reference:

- "data": frames / cameras across ranks;
- "bank": the template bank sharded across ranks; each rank scores its
  shard against the full frame and the shards' results merge with
  collectives (``sharded_match.py``).

JAX runs one controller over every device; here every rank is a process
(``spawn``) that joins one process group, and ``make_mesh`` lays the
world out as a (data, bank) ``DeviceMesh``.  Each rank's device is chosen
by the caller (``cuda:0`` for every rank on a one-GPU machine, ``cpu`` in
the tests): nothing here picks a device because a card is missing.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(data: int = 1, bank: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, bank) DeviceMesh over the initialized world, rank r at
    (r // bank, r % bank); `bank=None` takes the rest of the world."""
    n = dist.get_world_size()
    if bank is None:
        bank = n // data
    if data * bank != n:
        raise ValueError(f"mesh {data}x{bank} != {n} devices")
    return init_device_mesh(device_type, (data, bank), mesh_dim_names=("data", "bank"))


def bank_sharding(mesh: DeviceMesh) -> list:
    """Template-bank tensors: the leading template axis sharded over
    "bank" (the reference's P("bank"))."""
    return [Replicate(), Shard(0)]


def frame_sharding(mesh: DeviceMesh) -> list:
    """Frame batches: the leading batch axis sharded over "data" (the
    reference's P("data"))."""
    return [Shard(0), Replicate()]


def _rank_main(rank: int, fn, world_size: int, backend: str, init_file: str,
               timeout_s: float, args: tuple) -> None:
    dist.init_process_group(backend, init_method="file://" + init_file,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, init_file: str, args: tuple = (),
          timeout_s: float = 120.0) -> None:
    """Run fn(rank, world_size, *args) in `world_size` fresh processes that
    have joined one process group (`backend`, a file:// rendezvous at
    `init_file`, which must not exist yet; `timeout_s` bounds every
    collective).  Returns when every rank has exited 0.  A rank that
    raises fails the call with its traceback (the others are killed); a
    run past `timeout_s` kills every rank and raises TimeoutError.  `fn`
    and `args` are pickled: `fn` must be importable from its module."""
    ctx = mp.spawn(_rank_main, nprocs=world_size, join=False,
                   args=(fn, world_size, backend, init_file, timeout_s, tuple(args)))
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__qualname__} ran past "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
