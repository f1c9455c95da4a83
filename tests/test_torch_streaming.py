"""PyTorch port vs the JAX reference, on CPU: the streaming seams —
models/serving.py's PipelinedRunner and parallel/ingest.py's PacedSource
and FrameBatcher — in the seven cases of tests/test_streaming.py, each
also held to the reference's classes under the same `now` sequence: the
same frames, grab stamps, drop counts and batches, exactly (host-side
numpy and Python floats on both sides).  The runner runs CPU tensors with
device="cpu"; its CUDA-event path is in tests/test_torch_cuda.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.models.serving import PipelinedRunner as JRunner
from linemod_pose_estimation_tpu.parallel import ingest as JI
from linemod_pose_estimation_tpu_torch.models.serving import PipelinedRunner
from linemod_pose_estimation_tpu_torch.parallel.ingest import FrameBatcher, PacedSource


def _runner(fn, depth=2):
    return PipelinedRunner(fn, depth=depth, device="cpu")


def _counter():
    calls = {"n": 0}

    def grab():
        calls["n"] += 1
        return calls["n"]

    return grab


def _same_polls(make_port, make_ref, nows):
    """Poll a port source and a reference source over `nows`; every answer
    (None or (frame, t_grab)) and the drop count must agree."""
    port, ref = make_port(), make_ref()
    out = []
    for now in nows:
        a, b = port.poll(now), ref.poll(now)
        assert a == b, (now, a, b)
        assert port.dropped == ref.dropped
        out.append(a)
    return out


def test_pipelined_runner_order_and_equality():
    f = lambda x: x * 2 + 1
    run = _runner(f)
    outs = []
    for i in range(7):
        got = run.submit(torch.tensor(float(i)))
        if got is not None:
            outs.append(float(got))
        assert len(run) <= 2
    outs.extend(float(g) for g in run.drain())
    assert outs == [float(i) * 2 + 1 for i in range(7)]
    assert len(run) == 0
    ref = JRunner(f, depth=2)
    want = [r for r in (ref.submit(float(i)) for i in range(7)) if r is not None]
    assert outs == [float(v) for v in want + ref.drain()]


def test_pipelined_runner_depth_one_is_synchronous():
    run = _runner(lambda x: x + 1, depth=1)
    assert run.submit(1) is None
    assert run.submit(10) == 2
    assert run.drain() == [11]
    with pytest.raises(ValueError):
        _runner(lambda x: x, depth=0)
    with pytest.raises(RuntimeError):
        _runner(lambda x: x).collect()


def test_pipelined_runner_submit_failure_loses_nothing():
    def f(x):
        if x == "boom":
            raise RuntimeError("transient")
        return x + 1

    run = _runner(f)
    assert run.submit(0) is None
    assert run.submit(10) is None
    with pytest.raises(RuntimeError):
        run.submit("boom")
    assert len(run) == 2  # both in-flight results survive, in order
    assert run.submit(20) == 1
    assert run.drain() == [11, 21]


def test_pipelined_runner_defaults_to_the_card():
    """Without `device` the runner is for the card: on a host without one
    it raises at construction (no silent CPU fallback)."""
    if torch.cuda.is_available():
        assert PipelinedRunner(lambda x: x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelinedRunner(lambda x: x)


def test_paced_source_cadence_and_backlog():
    nows = [-0.01, 0.0, 0.05, 0.1]
    got = _same_polls(lambda: PacedSource(_counter(), fps=10.0, start=0.0, max_backlog=4),
                      lambda: JI.PacedSource(_counter(), fps=10.0, start=0.0, max_backlog=4),
                      nows)
    assert got == [None, (1, 0.0), None, (2, 0.1)]
    # Far behind: the backlog caps at 4, the rest counted as dropped.
    src = PacedSource(_counter(), fps=10.0, start=0.0, max_backlog=4)
    ref = JI.PacedSource(_counter(), fps=10.0, start=0.0, max_backlog=4)
    polls = []
    while True:
        g = src.poll(1.0)  # 11 frames elapsed (0.0 .. 1.0)
        assert g == ref.poll(1.0)
        if g is None:
            break
        polls.append(g)
    assert len(polls) == 4 and src.dropped == ref.dropped == 7
    assert all(abs((t * 10) - round(t * 10)) < 1e-9 for _, t in polls)


def test_paced_source_lazy_start_anchor():
    uptime = 98765.4321  # a perf_counter-scale clock
    nows = [uptime, uptime + 0.05, uptime + 0.1, uptime + 0.35, uptime + 10.0]
    got = _same_polls(lambda: PacedSource(lambda: "f", fps=10.0, max_backlog=4),
                      lambda: JI.PacedSource(lambda: "f", fps=10.0, max_backlog=4), nows)
    assert got[0] == ("f", uptime) and got[1] is None
    assert got[2][0] == "f" and abs(got[2][1] - (uptime + 0.1)) < 1e-9


def _frame(i):
    return SimpleNamespace(rgb=np.full((4, 6, 3), i, np.uint8),
                           cloud=np.full((4, 6), float(i), np.float32))


def _batchers(n_src, fps, batch):
    port = FrameBatcher([PacedSource(lambda i=i: _frame(i), fps=fps, start=0.0)
                         for i in range(n_src)], batch=batch)
    ref = JI.FrameBatcher([JI.PacedSource(lambda i=i: _frame(i), fps=fps, start=0.0)
                           for i in range(n_src)], batch=batch)
    return port, ref


def _same_batch(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


def test_poll_batch_fill_and_padding():
    fb, ref = _batchers(3, 10.0, 8)
    outs = []
    for now in (-1.0, 0.0, 0.05, 1.0, 1.05, 1.1):
        outs.append(fb.poll_batch(now=now))
        _same_batch(outs[-1], ref.poll_batch(now=now))
    assert outs[0] is None
    rgbs, clouds, stamps, n = outs[1]
    assert n == 3 and rgbs.shape == (8, 4, 6, 3) and stamps.shape == (8,)
    assert (rgbs[3:] == rgbs[2]).all() and (stamps[3:] == stamps[2]).all()
    assert outs[2] is None
    assert outs[3][3] == 8  # after a long gap the batch caps at 8
    # next_batch round-robins plain camera callables, one frame each
    cams = [lambda i=i: _frame(i) for i in range(3)]
    a, b = FrameBatcher(cams, batch=5), JI.FrameBatcher(cams, batch=5)
    for _ in range(2):
        for x, y in zip(a.next_batch(), b.next_batch()):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        FrameBatcher([], batch=2)


def test_poll_batch_under_slow_consumer_accumulates():
    fb, ref = _batchers(2, 100.0, 16)
    got = []
    for now in (0.0, 0.05, 0.051, 0.5):
        got.append(fb.poll_batch(now=now))
        _same_batch(got[-1], ref.poll_batch(now=now))
    assert got[0][3] == 2
    assert got[1][3] == 10  # 5 more periods elapsed per camera
    assert got[2] is None
    assert got[3][3] == 16
    assert [s.dropped for s in fb.sources] == [s.dropped for s in ref.sources]


def test_runner_over_batches_equals_blocking():
    """The runner over a stream of polled batches gives what blocking calls
    give, in submission order, with one stamp set per submitted batch."""
    fb, _ = _batchers(3, 50.0, 4)
    step = lambda rgbs: torch.as_tensor(rgbs).float().mean(dim=(1, 2, 3))
    run, piped, blocking, stamps = _runner(step), [], [], []
    for k in range(12):
        got = fb.poll_batch(now=0.02 * k)
        if got is None:
            continue
        rgbs, _, st, n = got
        stamps.append((st, n))
        blocking.append(step(rgbs))
        out = run.submit(rgbs)
        if out is not None:
            piped.append(out)
    piped += run.drain()
    assert len(piped) == len(blocking) == len(stamps) > 3
    for a, b in zip(piped, blocking):
        assert torch.equal(a, b)
