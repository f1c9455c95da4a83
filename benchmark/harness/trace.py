"""Spans, launch records and the reduction of a torch.profiler trace.

Spans are `torch.profiler.record_function` ranges that the benchmark wraps
around the program's calls into a layer, by patching the attribute where
the caller looks it up; nothing is patched in an untraced run.  A span's
device work is the kernels, copies and fills whose launching runtime call
lies inside the span's host range (the trace links the two by correlation
id).  The trace goes to a file under TMPDIR, is read once and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Patches:
    """Attribute patches, undone in reverse order by `restore`."""

    def __init__(self):
        self._undo: list = []

    def _set(self, owner, attr, fn):
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, fn)

    def span(self, owner, attr: str, name: str) -> None:
        """Wrap owner.attr in a record_function range called `name`."""
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return orig(*a, **k)

        self._set(owner, attr, wrapped)

    def spy(self, owner, attr: str, record) -> None:
        """Call record(args, kwargs, result) after each call of owner.attr."""
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            out = orig(*a, **k)
            record(a, k, out)
            return out

        self._set(owner, attr, wrapped)

    def restore(self) -> None:
        while self._undo:
            owner, attr, fn = self._undo.pop()
            setattr(owner, attr, fn)


class Trace:
    """The device operations, host spans and runtime launches of one
    traced window (times in microseconds on the trace's clock)."""

    def __init__(self, events: list[dict]):
        self.ops = []  # (start, end, name, correlation)
        self.launch = {}  # correlation -> host time of the runtime call
        self.spans = defaultdict(list)  # name -> [(start, end)]
        self.cpu_ops = []  # (start, end, name)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.ops.append((ts, ts + dur, e["name"], corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                self.launch[corr] = ts
            elif cat == "user_annotation":
                self.spans[e["name"]].append((ts, ts + dur))
            elif cat == "cpu_op":
                self.cpu_ops.append((ts, ts + dur, e["name"]))
        self.ops.sort()
        win = self.spans.get(WINDOW)
        if not win:
            raise RuntimeError("the trace holds no window range")
        self.t0, self.t1 = win[0]
        self.ops = [o for o in self.ops if o[1] > self.t0 and o[0] < self.t1]
        self._by_launch = sorted((self.launch[o[3]], i) for i, o in enumerate(self.ops)
                                 if o[3] in self.launch)
        self._launch_ts = [t for t, _ in self._by_launch]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        out: list = []
        for s, e, _, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, []))

    def span_ops(self, name: str) -> list[list[tuple]]:
        """Per instance of span `name`, the device ops it launched."""
        out = []
        for a, b in self.spans.get(name, []):
            lo = bisect.bisect_left(self._launch_ts, a)
            hi = bisect.bisect_right(self._launch_ts, b)
            out.append([self.ops[i] for _, i in self._by_launch[lo:hi]])
        return out

    def span_device_ms(self, name: str) -> list[float]:
        """Per instance, the summed device time of the ops it launched."""
        return [sum(e - s for s, e, _, _ in ops) / 1e3 for ops in self.span_ops(name)]

    def span_to_last_op_ms(self, name: str) -> list[float]:
        """Per instance, from the host entering the span to the end of the
        last device op it launched (or the host leaving it, if later)."""
        out = []
        for (a, b), ops in zip(self.spans.get(name, []), self.span_ops(name)):
            end = max([b] + [e for _, e, _, _ in ops])
            out.append((end - a) / 1e3)
        return out

    def kernels(self, fragment: str) -> list[tuple]:
        """Device ops whose name holds `fragment`, in time order."""
        return [o for o in self.ops if fragment in o[2]]

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps
        named by the innermost span and host op active in their middle."""
        tot: dict = defaultdict(float)
        for s, e, name, _ in self.ops:
            tot[name] += (e - s) / 1e6
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        ops = [(_short(n), t) for n, t in ops]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        named = []
        for length, start in gaps:
            mid = start + length / 2
            span = _innermost(((a, b, n) for n, ivs in self.spans.items() if n != WINDOW
                               for a, b in ivs), mid) or "outside spans"
            op = _innermost(self.cpu_ops, mid) or "python"
            named.append([f"{span} / {op}", length / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def _short(name: str, keep: int = 96) -> str:
    """A device op's name without the leading `void`, cut to `keep` letters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= keep else name[:keep - 3] + "..."


def _innermost(intervals, t: float) -> str | None:
    best = None
    for a, b, name in intervals:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else None


class Capture:
    """Trace the calls made inside the `with` block on the card; `read()`
    then gives the reduced Trace."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             acc_events=True)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def read(self) -> Trace:
        """Export the trace (after the window: it takes seconds) and reduce it."""
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        del self._prof
        return Trace(events)
