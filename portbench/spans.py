"""Spans around calls into the program's layers, taken from outside, and
the device trace of a window.

`Spans` times named spans: the harness opens one around its own calls
(`span`), and `wrap` patches a program function so that each call is a
span (the way `chip_smoke.py::stage_clock` clocks the port's stages).
Each span's self time (its wall time less that of the spans it
encloses, on the same thread) is summed by label.  With `annotate`
every span is also a `torch.profiler.record_function`, so the device
trace can name what the host was doing in each idle gap.

`DeviceTrace` profiles a window with torch.profiler (CUPTI) and reads
the device's events off the trace as recorded (`kineto_results`), as
`chip_smoke.py::profile_device` does: time by kernel, the busy time
(the union of device intervals), and idle time by host span."""
from __future__ import annotations

import contextlib
import threading
import time
from unittest import mock


class Spans:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.self_s: dict[str, float] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._patches = contextlib.ExitStack()

    @contextlib.contextmanager
    def span(self, label: str):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(0.0)                       # time of enclosed spans
        rf = contextlib.nullcontext()
        if self.annotate:
            import torch
            rf = torch.profiler.record_function(label)
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            dt = time.perf_counter() - t0
            inner = stack.pop()
            if stack:
                stack[-1] += dt
            with self._lock:
                self.self_s[label] = self.self_s.get(label, 0.0) + dt - inner

    def wrap(self, module, name: str, label: str) -> None:
        """Make every call of module.<name> a span (until `close`)."""
        fn = getattr(module, name)

        def spanned(*a, **kw):
            with self.span(label):
                return fn(*a, **kw)
        self.patch(module, name, spanned)

    def patch(self, module, name: str, replacement) -> None:
        """Put `replacement` in module.<name>'s place (until `close`)."""
        self._patches.enter_context(
            mock.patch.object(module, name, replacement))

    def close(self) -> None:
        self._patches.close()


class DeviceTrace:
    """torch.profiler over a window: device events and host spans."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.window_s = 0.0

    def __enter__(self):
        self._torch.cuda.synchronize()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def read(self, span_labels) -> dict:
        """{"busy_s", "ops": {name: (launches, s)}, "idle_by_span":
        {label: s}} from the trace; busy_s 0 when no device time."""
        torch = self._torch
        dev, host = [], []
        ops: dict[str, list] = {}
        labels = set(span_labels)
        for e in self._prof.profiler.kineto_results.events():
            t0, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a span's range on the device's timeline is no activity
                if dur <= 0 or e.name() in labels:
                    continue
                name = e.name().replace("(anonymous namespace)::", "")
                if not name.startswith(("Memcpy", "Memset")):
                    name = name.split("(")[0].strip()[:60]
                dev.append((t0, t0 + dur))
                c = ops.setdefault(name, [0, 0.0])
                c[0] += 1
                c[1] += dur * 1e-9
            elif e.name() in labels:
                host.append((t0, t0 + dur, e.name()))
        dev.sort()
        busy, gaps = 0, []
        end = None
        for a, b in dev:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        idle = _idle_by_span(gaps, host)
        return {"busy_s": busy * 1e-9,
                "ops": {k: (c, s) for k, (c, s) in ops.items()},
                "idle_by_span": idle}


def _idle_by_span(gaps, host) -> dict:
    """Seconds of the idle `gaps` [(start, end)] under each host span
    [(start, end, label)], each instant given to the innermost span open
    then (the latest opened) or to "(no span)"."""
    edges = sorted({t for h in host for t in h[:2]}
                   | {t for g in gaps for t in g})
    opens: dict = {}
    for i, (h0, h1, _) in enumerate(host):
        opens.setdefault(h0, []).append(i)
        opens.setdefault(h1, [])
    active: list = []
    segments = []                     # (start, end, label)
    for a, b in zip(edges, edges[1:]):
        active = [i for i in active if host[i][1] > a] + opens.get(a, [])
        label = (max(active, key=lambda i: host[i][0])
                 if active else None)
        segments.append((a, b, "(no span)" if label is None
                         else host[label][2]))
    idle: dict = {}
    k = 0
    for a, b in gaps:
        while k < len(segments) and segments[k][1] <= a:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < b:
            s0, s1, name = segments[j]
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                idle[name] = idle.get(name, 0.0) + ov * 1e-9
            j += 1
    return idle
