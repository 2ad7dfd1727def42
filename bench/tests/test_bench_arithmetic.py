"""The benchmark's arithmetic on the CPU: kernel work counts and roofline
shares at hand-worked shapes, the union of overlapping device intervals,
idle gaps, the latency percentiles, and the per-layer metric assembly."""
import math

import numpy as np
import pytest

from bench import peaks
from bench.metrics._roofline import roofline
from bench.trace import Context, Event, Span, breakdown, gaps, union
from bench.work import dw_pw, sparse_conv


def test_sparse_conv_work_by_hand():
    # 3x3 conv over 8x8x64 (n 1, stride 1), 64 -> 64 out in 32 x 32
    # blocks, 3 of the 18 row blocks kept, with a residual
    call = {"n": 1, "h": 8, "w": 8, "c": 64, "k": 3, "stride": 1,
            "ob": 2, "n_k": 3, "bm": 32, "bn": 32, "w_bytes": 2,
            "residual": True}
    ops, nbytes, dtype = sparse_conv.work(call)
    assert ops == 2 * 64 * 2 * 3 * 32 * 32 == 786432
    # x 8*8*64*2 + blocks 2*3*32*32*2 + ids 2*3*4 + bias 64*2
    # + residual and output 2 * 64*64*2
    assert nbytes == 8192 + 12288 + 24 + 128 + 16384 == 37016
    assert dtype == "bfloat16"
    # bytes bound: 37016 / 3.35e12 s > ops bound 786432 / 989e12 s
    assert peaks.bound_s(ops, nbytes) == pytest.approx(37016 / 3.35e12)


def test_dw_pw_work_by_hand():
    # 3x3 depthwise over 4x4x16, stride 2 -> 2x2, then 16 -> 24
    call = {"n": 2, "h": 4, "w": 4, "c": 16, "cout": 24, "k": 3,
            "stride": 2, "residual": False, "w_bytes": 2}
    ops, nbytes, _ = dw_pw.work(call)
    m = 2 * 2 * 2
    assert ops == 2 * m * 16 * (9 + 24) == 8448
    assert nbytes == (2 * 2 * 16 * 16 + 2 * (9 * 16 + 16) + 2 * 16 * 24
                      + 2 * 24 + 2 * m * 24) == 2544


def _span(events, start=0.0, end=1.0, units=1, images=1):
    return Span([Event(*e) for e in events], start, end, units, images)


def test_union_counts_overlap_once():
    assert union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (4, 4)]) == \
        [(0, 3), (5, 6)]
    # three streams overlapping: busy never exceeds the window
    span = _span([("k1", 0.1, 0.6, True), ("k2", 0.2, 0.9, True),
                  ("k3", 0.3, 0.4, True), ("cpu", 0.0, 1.0, False),
                  ("k4", 0.95, 1.2, True)])
    assert span.busy_s == pytest.approx(0.8 + 0.05)
    assert span.busy_s <= span.window_s
    assert gaps(span) == [(0.0, 0.1), (0.9, 0.95)]


def test_breakdown_names_the_host_op_in_each_gap():
    span = _span([("bench.span", 0.0, 1.0, False),
                  ("cudaStreamSynchronize", 0.05, 0.3, False),
                  ("bench.wait", 0.5, 0.9, False),
                  ("kern", 0.3, 0.5, True), ("kern", 0.9, 1.0, True)])
    b = breakdown(span)
    assert b["device_ops"] == [["kern", pytest.approx(0.3)]]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "cudaStreamSynchronize": pytest.approx(0.3),
        "bench.wait": pytest.approx(0.4)}


def test_roofline_share_and_count_check():
    call = {"n": 1, "h": 8, "w": 8, "c": 64, "k": 3, "stride": 1,
            "ob": 2, "n_k": 3, "bm": 32, "bn": 32, "w_bytes": 2,
            "residual": False}
    bound = peaks.bound_s(*sparse_conv.work(call))
    ev = [("void sparse_conv_mma<32, __nv_bfloat16>(...)", 0.0, 4 * bound,
           True),
          ("void sparse_conv_simt<__nv_bfloat16>(...)", 0.5, 0.5 + 4 * bound,
           True),
          ("void dw_pw_mma<3, 32, 64>(...)", 0.2, 0.3, True)]
    logs = []
    ctx = Context(_span(ev, units=2), {"sparse_conv": [call]},
                  {"sparse_conv": 1}, {}, 0, logs.append)
    pat = r"sparse_conv_(mma|simt)"
    assert roofline(ctx, "sparse_conv", pat) == pytest.approx(25.0)
    assert "2 kernel events matched" in logs[0] and "2 launches" in logs[0]
    # a count that disagrees with the program's launches reads nothing
    ctx.launches = {"sparse_conv": 3}
    assert roofline(ctx, "sparse_conv", pat) is None


def test_every_roofline_pattern_covers_every_variant():
    from repro_torch.kernels._build import VARIANTS
    from bench.metrics import dw_pw_roofline, sparse_conv_roofline
    import re
    for mod, kernel in ((sparse_conv_roofline, "sparse_conv"),
                        (dw_pw_roofline, "dw_pw")):
        for v in VARIANTS[kernel]:
            assert re.search(mod.PATTERN, f"void {kernel}_{v}<3>(float*)")
            assert re.search(mod.PATTERN, f"_Z{len(kernel) + 4}{kernel}_{v}I")


def test_percentiles_take_every_request():
    from bench.drivers.request import latency_metrics
    lat = np.arange(1, 101) * 1e-3          # 1 .. 100 ms
    m = latency_metrics(lat)
    assert m["request_ms_p50"] == pytest.approx(50.5)
    assert m["request_ms_p95"] == pytest.approx(95.05)


def test_readers_of_an_empty_span_end_the_run_naming_the_metric():
    from bench import run
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")

    class Idle:
        unit, launches = "tick", {"dw_pw": 17}

    empty = _span([("bench.span", 0.0, 1.0, False)], units=4, images=8)
    with pytest.raises(SystemExit, match="dw_pw_roofline.stream"):
        run.per_layer(manifest, "mobilenet_v2.stream", Idle(), lambda: empty,
                      {"dw_pw": []}, {"slot_ticks": 4, "injected": 3}, 1,
                      lambda m: None)


def test_per_layer_readings_from_a_span():
    """Device quantities come from the span, times a unit from the
    untraced window: the profiler's own host cost (here a span ten times
    the window's time a request) moves none of them."""
    from bench import run
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")

    class Drv:
        unit, launches = "request", {"dw_pw": 1}

    call = {"n": 1, "h": 4, "w": 4, "c": 16, "cout": 24, "k": 3,
            "stride": 1, "residual": False, "w_bytes": 2}
    span = _span([("bench.span", 0.0, 0.1, False),
                  ("void dw_pw_mma<3, 16, 64>()", 0.001, 0.002, True),
                  ("cudnn_conv", 0.002, 0.004, True),
                  ("Memcpy HtoD (Pageable -> Device)", 0.0, 0.001, True)],
                 end=0.1, units=1, images=1)
    window = {"units": 500, "images": 500, "unit_s": 0.01}
    got, _, brk = run.per_layer(manifest, "mobilenet_v2.request", Drv(),
                                lambda: span, {"dw_pw": [call]}, window,
                                1e9, lambda m: None)
    v = {k: x["value"] for k, x in got.items()}
    assert v["library_ms.request"] == pytest.approx(2.0)
    assert v["device_idle.request"] == pytest.approx(60.0)
    assert v["host_ms.request"] == pytest.approx(6.0)
    assert v["mfu.request"] == pytest.approx(100 * 1e9 / 0.01 / 989e12)
    assert v["dw_pw_roofline.request"] == pytest.approx(
        100 * peaks.bound_s(*dw_pw.work(call)) / 0.001)
    assert set(v) == {"host_ms.request", "library_ms.request",
                      "dw_pw_roofline.request", "mfu.request",
                      "device_idle.request"}
    assert brk["device_ops"][0][0] == "cudnn_conv"
    assert all(math.isfinite(x) for x in v.values())


def test_stream_readings_take_the_windows_time_a_tick():
    from bench import run
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")

    class Drv:
        unit, launches = "tick", {"sparse_conv": 1}

    call = {"n": 2, "h": 8, "w": 8, "c": 64, "k": 3, "stride": 1,
            "ob": 2, "n_k": 3, "bm": 32, "bn": 32, "w_bytes": 2,
            "residual": False}
    # two slot streams overlap: 0.6 ms of library work and 1 ms of
    # sparse_conv in two ticks, 0.8 ms busy a tick
    span = _span([("bench.span", 0.0, 0.01, False),
                  ("cudnn_conv", 0.001, 0.0015, True),
                  ("cudnn_conv", 0.0012, 0.0016, True),
                  ("void sparse_conv_mma<32>()", 0.002, 0.0025, True),
                  ("void sparse_conv_mma<32>()", 0.007, 0.0075, True)],
                 end=0.01, units=2, images=4)
    window = {"units": 1000, "images": 1994, "unit_s": 0.001,
              "slot_ticks": 1000, "injected": 997}
    got, _, _ = run.per_layer(manifest, "resnet50.stream", Drv(),
                              lambda: span, {"sparse_conv": [call]}, window,
                              2e9, lambda m: None)
    v = {k: x["value"] for k, x in got.items()}
    assert v["device_idle.stream"] == pytest.approx(20.0)
    assert v["library_ms.stream"] == pytest.approx(0.45)
    assert v["pipeline_bubble.stream"] == pytest.approx(0.3)
    assert v["mfu.stream"] == pytest.approx(100 * 2e9 * 1994 / 1.0 / 989e12)
    assert v["sparse_conv_roofline.stream"] == pytest.approx(
        100 * peaks.bound_s(*sparse_conv.work(call)) / 0.0005)


def test_compare_holds_every_answer_due():
    from bench import checks
    rng = np.random.default_rng(5)
    ref = rng.normal(size=(4, 10))
    keys = np.array([0, 1, 2, 3, 1])
    limits = dict.fromkeys(checks.NUMBERS, 1e-3)
    ok, got = checks.compare(keys, ref[keys], ref, limits, 5, 0)
    assert ok and got["worst_logit_err"]["value"] == 0.0
    # one answer lost, or one more than was sent: not correct
    ok, got = checks.compare(keys[:4], ref[keys[:4]], ref, limits, 5, 0)
    assert not ok and got["worst_logit_err"]["value"] == 1e308
    assert not checks.compare(keys, ref[keys], ref, limits, 4, 0)[0]
    assert not checks.compare(keys, ref[keys[:4]], ref, limits, 5, 0)[0]
    assert not checks.compare(keys, ref[keys], ref, limits, 5, 1)[0]


def test_a_traffic_key_no_driver_reads_is_refused(monkeypatch):
    import importlib
    from bench import run
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    for w in manifest["workloads"]:
        mix = run.load_json(run.BENCH / "traffic" / f"{w['traffic']}.json")
        drv = importlib.import_module(f"bench.drivers.{mix['kind']}")
        assert set(mix) - {"kind", "about"} <= set(drv.KEYS), w["traffic"]
    load = run.load_json

    def with_arrivals(path):
        d = load(path)
        return {**d, "arrivals": "poisson"} if "traffic" in str(path) else d
    monkeypatch.setattr(run, "load_json", with_arrivals)
    with pytest.raises(ValueError, match="arrivals"):
        run.build(manifest, "resnet50.request", 1, device="cpu")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    from bench import run
    for name in ("repro_torch_x", "jaxtyping_x", "repro.y", "jax.numpy_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = run.forbidden_modules()
    assert "repro.y" in found and "jax.numpy_x" in found
    assert "repro_torch_x" not in found and "jaxtyping_x" not in found
