"""The traced span: ``torch.profiler`` over a bounded run of requests or
ticks, reduced to plain interval arithmetic that the per-layer readers
(``metrics/<name>.py``) share.

Device busy time is the UNION of the device's activity intervals (kernels,
copies, memsets) inside the span, so work that overlaps on several
streams counts once and ``busy_s`` never exceeds ``window_s``.

The profiler slows the span's host side (each graph launch under CUPTI,
with or without host activity recorded), so the span's length is no
unit's time: the readers take only what the device did from it (busy
time, kernel events and their counts) and a unit's time from the untraced
window (``Context.window``)."""
from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass
from typing import Callable, Optional

SPAN = "bench.span"
TOP = 10


@dataclass(frozen=True)
class Event:
    name: str
    start: float          # seconds, on the profiler's clock
    end: float
    device: bool

    @property
    def kernel(self) -> bool:
        return self.device and not self.name.startswith(("Memcpy", "Memset"))


@dataclass
class Span:
    """A profiled run of ``units`` requests (or pipeline ticks) over
    [start, end], with ``images`` images served."""
    events: list
    start: float
    end: float
    units: int
    images: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def device_events(self) -> list:
        return [e for e in self.events if e.device]

    def busy_intervals(self) -> list:
        return union([(max(e.start, self.start), min(e.end, self.end))
                      for e in self.device_events()
                      if e.end > self.start and e.start < self.end])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())


@dataclass
class Context:
    """What a per-layer reader may read: the traced span, for what the
    device did (busy time, kernel events and their counts); ``calls``, the
    hand-written kernels' calls of one unit (``reference/<model>
    .kernel_calls``); ``launches``, the program's own count of each
    kernel's launches a unit; ``window``, what the untraced window counted
    and timed (``units``, ``images``, ``unit_s``: its mean time a unit on
    the host's clock, and the program's counters), which the profiler's own
    host cost does not touch; ``model_ops``, one image's operations."""
    span: Span
    calls: dict
    launches: dict
    window: dict
    model_ops: int
    log: Callable[[str], None] = print

    @property
    def busy_per_unit_s(self) -> Optional[float]:
        """The device's busy time a unit in the traced span."""
        busy = self.span.busy_s
        return busy / self.span.units if busy > 0 and self.span.units \
            else None


def union(intervals) -> list:
    """Merge (start, end) intervals into disjoint sorted ones."""
    out: list = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def matching(span: Span, pattern: str) -> list:
    """The span's kernel events whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return [e for e in span.device_events() if e.kernel and rx.search(e.name)]


def gaps(span: Span) -> list:
    """(start, end) of every stretch of the span with nothing on the
    device."""
    out, at = [], span.start
    for a, b in span.busy_intervals():
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if span.end > at:
        out.append((at, span.end))
    return out


def host_label(cpu: list, starts: list, t: float) -> str:
    """The innermost host event (not the span itself) running at ``t``:
    of those that contain it, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(cpu[max(0, i - 400):i]):
        if e.end >= t and e.name != SPAN:
            return e.name
    return "no host op"


def breakdown(span: Span) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each the TOP largest, in seconds."""
    by_op: dict = {}
    for e in span.device_events():
        by_op[e.name] = by_op.get(e.name, 0.0) + (e.end - e.start)
    cpu = sorted((e for e in span.events if not e.device),
                 key=lambda e: e.start)
    starts = [e.start for e in cpu]
    by_host: dict = {}
    for a, b in gaps(span):
        label = host_label(cpu, starts, (a + b) / 2)
        by_host[label] = by_host.get(label, 0.0) + (b - a)

    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


@contextlib.contextmanager
def profiled(sync: Callable[[], None]):
    """Profile the body (host and device) inside one ``bench.span`` range,
    ending with ``sync()``; yields a list that holds the events and the
    span's bounds after the body."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    box: list = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            yield box
            sync()
    events, bounds = [], None
    for e in prof.events():
        ev = Event(e.name, e.time_range.start * 1e-6,
                   e.time_range.end * 1e-6, e.device_type == DeviceType.CUDA)
        if ev.device and (getattr(e, "is_user_annotation", False)
                          or ev.name == SPAN):
            continue          # a range's shadow on the device's timeline
        if ev.name == SPAN:
            bounds = (ev.start, ev.end)
        events.append(ev)
    if bounds is None:
        raise RuntimeError("the profiler recorded no bench.span range")
    box.extend([events, bounds])


def reader(path) -> Callable[[Context], Optional[float]]:
    """Load ``read`` from a reader file (``metrics/<name>.py``); the names
    hold dots, so they are loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
