"""An offline image stream (``traffic`` kind "stream"): requests of
``images_per_request`` images, submitted ``requests_per_round`` at a time
to the program's ``launch.serve.CNNPipelineServer`` and drained with its
``run()``; the pipeline of ``n_stages`` stages runs one captured tick a
microbatch of ``mb_size`` images. The rate is every image completed over
the whole window, round boundaries included."""
from __future__ import annotations

import time

import numpy as np

from bench.trace import Span, profiled


#: the mix's parameters this driver reads (see ``drivers/request.py``)
KEYS = ("images_per_request", "requests_per_round", "mb_size", "n_stages",
        "n_replicas", "pool_images", "warm_rounds", "trace_rounds")


class Driver:
    unit = "tick"

    def __init__(self, setup, fault=None):
        from repro_torch.launch.serve import CNNPipelineServer
        self.setup = setup
        tr = setup.traffic
        self.per_req = int(tr["images_per_request"])
        self.per_round = int(tr["requests_per_round"])
        self.server = CNNPipelineServer(
            setup.config["port_arch"], mb_size=int(tr["mb_size"]),
            n_stages=int(tr["n_stages"]), n_replicas=int(tr["n_replicas"]),
            image_size=setup.image_size, params=setup.port_params,
            quantize=setup.quantize, device=setup.device, verbose=False)
        self.results = self.server.results if fault is None \
            else fault(self.server.results)
        # counted while a tick was captured (on the CPU nothing launches)
        per_tick = self.server.launches_per_tick
        self.launches = dict(per_tick[0]) if per_tick else {}
        pool = setup.pool.numpy()
        n_req = pool.shape[0] // self.per_req
        # request g is the pool's images [g * per_req, (g + 1) * per_req)
        self.requests = [pool[g * self.per_req:(g + 1) * self.per_req]
                         for g in range(n_req)]
        self.order = setup.rng.integers(0, n_req, size=1 << 16)
        self.sent = 0
        self.keys: list = []
        self.outs: list = []
        for _ in range(int(tr["warm_rounds"])):
            self._round(keep=False)

    def _round(self, keep: bool = True) -> int:
        groups = [int(self.order[(self.sent + i) % len(self.order)])
                  for i in range(self.per_round)]
        self.sent += self.per_round
        ids = [self.server.submit(self.requests[g]) for g in groups]
        self.server.run()
        for g, r in zip(groups, ids):
            y = self.results(r)
            if keep:
                self.keys.append(np.arange(g * self.per_req,
                                           (g + 1) * self.per_req))
                self.outs.append(y)
        return self.per_round * self.per_req

    def _counts(self):
        s = self.server
        return s.ticks, s.ticks * s.n_replicas, s.injected_slots

    def trace(self, sync) -> Span:
        ticks0, _, _ = self._counts()
        images = 0
        with profiled(sync) as box:
            for _ in range(int(self.setup.traffic["trace_rounds"])):
                images += self._round()
        events, (a, b) = box
        return Span(events, a, b, units=self._counts()[0] - ticks0,
                    images=images)

    def window(self, seconds: float) -> dict:
        t_before, slots_before, inj_before = self._counts()
        images = reqs = 0
        t0 = time.perf_counter()
        while True:
            images += self._round()
            reqs += self.per_round
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        ticks, slots, inj = self._counts()
        rate = images / elapsed
        return {"attempted": reqs, "failed": 0,
                "metrics": {"images_per_s": rate},
                "window": {"units": ticks - t_before, "images": images,
                           "unit_s": elapsed / (ticks - t_before),
                           "slot_ticks": slots - slots_before,
                           "injected": inj - inj_before},
                "log": f"{reqs} requests, {images} images in {elapsed:.3f} s"
                       f" ({ticks - t_before} ticks, {inj - inj_before} "
                       f"microbatches): {rate:.2f} images/s"}

    def answers(self):
        return np.concatenate(self.keys), np.concatenate(self.outs)

    def close(self):
        self.server = self.results = None
