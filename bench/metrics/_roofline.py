"""A hand-written kernel's share of its roofline over the traced span:
the sum of its calls' bounds (``work/<kernel>.py``, ``peaks.bound_s``)
over the sum of its measured times. The kernel's events are taken by the
name pattern its reader keeps, and their count is held to the program's
own launch count a unit times the units profiled."""
from __future__ import annotations

import importlib
from typing import Optional

from bench import peaks
from bench.trace import Context, matching


def roofline(ctx: Context, kernel: str, pattern: str) -> Optional[float]:
    events = matching(ctx.span, pattern)
    per_unit = ctx.launches.get(kernel, 0)
    want = per_unit * ctx.span.units
    ctx.log(f"[trace] {kernel}: {len(events)} kernel events matched "
            f"/{pattern}/, {want} launches counted by the program "
            f"({per_unit} a unit x {ctx.span.units} units)")
    calls = ctx.calls.get(kernel, [])
    if not events or len(events) != want or len(calls) != per_unit:
        return None
    work = importlib.import_module(f"bench.work.{kernel}").work
    bound = sum(peaks.bound_s(ops, nbytes, dtype)
                for ops, nbytes, dtype in map(work, calls))
    measured = sum(e.end - e.start for e in events)
    return 100.0 * bound * ctx.span.units / measured
