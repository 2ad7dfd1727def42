"""Batch-1 requests (``traffic`` kind "request"): one client sends single
images (in page-locked host memory) at ``rate_per_s``, evenly spaced,
through the program's
``launch.serve.latency_request`` (H2D, one CUDA graph replay of the whole
forward, D2H). Open loop: a request's latency runs from its due time, so
a request that is late delays those behind it and they count the wait."""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from bench.trace import Span, profiled


def latency_metrics(latencies_s) -> dict:
    """The median and 95th percentile, in ms, of every request due in the
    window (numpy's linear interpolation between order statistics)."""
    p50, p95 = np.percentile(np.asarray(latencies_s) * 1e3, [50, 95])
    return {"request_ms_p50": float(p50), "request_ms_p95": float(p95)}


#: the mix's parameters this driver reads; a mix that sets any other is
#: refused, so no key of a mix does nothing
KEYS = ("rate_per_s", "pool_images", "warm_requests", "trace_requests",
        "max_late_s")


class Driver:
    unit = "request"

    def __init__(self, setup, fault=None):
        from repro_torch.launch.serve import ServeConfig, latency_request
        self.setup = setup
        tr = setup.traffic
        self.period = 1.0 / float(tr["rate_per_s"])
        self.max_late = float(tr["max_late_s"])
        cfg = ServeConfig(arch=setup.config["port_arch"], mode="latency",
                          image_size=setup.image_size,
                          quantize=setup.quantize, device=setup.device,
                          verbose=False)
        self.request, info = latency_request(cfg, native=setup.port_params)
        if fault is not None:
            self.request = fault(self.request)
        self.launches = dict(info["launches_per_request"])
        # the client's images wait in page-locked host memory, as a
        # server's receive buffers do: the H2D is one DMA, and the host's
        # own copy through a staging buffer does not add its noise
        pool = setup.pool.pin_memory() if setup.device == "cuda" \
            else setup.pool
        self.images = [pool[i:i + 1] for i in range(pool.shape[0])]
        self.order = setup.rng.integers(0, len(self.images), size=1 << 16)
        self.served = 0
        self.waiting = contextlib.nullcontext
        self.keys: list = []
        self.outs: list = []
        for _ in range(int(tr["warm_requests"])):
            self._one(time.perf_counter(), keep=False)

    def _one(self, due: float, keep: bool = True):
        with self.waiting():
            while time.perf_counter() < due:
                pass
        k = int(self.order[self.served % len(self.order)])
        self.served += 1
        t = time.perf_counter()
        y = self.request(self.images[k])
        done = time.perf_counter()
        if keep:
            self.keys.append(k)
            self.outs.append(y)
        return done - due, done - t

    def _schedule(self, n=None, seconds=None):
        """Serve the requests due in ``seconds`` (or ``n`` of them) from
        now; returns (latencies, own walls)."""
        lat, walls = [], []
        t0 = time.perf_counter()
        i = 0
        while (n is None or i < n):
            due = t0 + i * self.period
            if seconds is not None and due - t0 >= seconds:
                break
            late, wall = self._one(due)
            lat.append(late)
            walls.append(wall)
            if late - wall > self.max_late:
                raise RuntimeError(f"request {i} started {late - wall:.1f} s"
                                   " after its due time: the offered rate "
                                   "is far beyond what the program serves")
            i += 1
        return lat, walls

    def trace(self, sync) -> Span:
        from torch.profiler import record_function
        n = int(self.setup.traffic["trace_requests"])
        # the wait for each request's due time shows in the trace by name
        self.waiting = lambda: record_function("bench.wait_for_arrival")
        try:
            with profiled(sync) as box:
                self._schedule(n=n)
        finally:
            self.waiting = contextlib.nullcontext
        events, (a, b) = box
        return Span(events, a, b, units=n, images=n)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        lat, walls = self._schedule(seconds=seconds)
        served = time.perf_counter() - t0
        ms = np.asarray(lat) * 1e3
        metrics = latency_metrics(lat)
        p50, p95 = metrics["request_ms_p50"], metrics["request_ms_p95"]
        thirds = "/".join(f"{np.median(t):.4f}"
                          for t in np.array_split(ms, 3))
        return {"attempted": len(lat), "failed": 0, "metrics": metrics,
                "window": {"units": len(lat), "images": len(lat),
                           "unit_s": float(np.mean(walls))},
                "log": f"{len(lat)} requests due in {seconds} s at "
                       f"{1 / self.period:g}/s, served in {served:.3f} s; "
                       f"latency p50 {p50:.4f} ms ({thirds} by third of "
                       f"the window), p95 {p95:.4f} ms, max "
                       f"{ms.max():.4f} ms; own wall p50 "
                       f"{np.median(walls) * 1e3:.4f}, mean "
                       f"{np.mean(walls) * 1e3:.4f} ms"}

    def answers(self):
        """(pool index of each image answered, its logits), every answer of
        the traced span and the window."""
        return (np.asarray(self.keys),
                torch.cat(self.outs).float().numpy())

    def close(self):
        self.request = None
