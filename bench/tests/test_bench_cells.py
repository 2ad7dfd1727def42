"""A run of each cell on the CPU at 64 px (the harness's look for a card
skipped; the program's plain path): the reference against the program on
the same weights, the modules a run loads, the control (the program's own
int8 store) and planted faults, each of which must come out not
correct."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import run
from bench.reference import common

M = run.load_json(run.ROOT / "BENCHMARK.json")
SMALL = {"request": {"rate_per_s": 40, "warm_requests": 1,
                     "pool_images": 8},
         "stream": {"requests_per_round": 2, "images_per_request": 4,
                    "pool_images": 16, "warm_rounds": 0}}
SEED = 2**31 + 977
#: the smallest size at which a sound run keeps inside the limits set at
#: 224 px: the last feature map is 2 x 2 (1 x 1 at 32 px, where one bf16
#: rounding that falls the other way moves a logit more)
SIZE = 64


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_run(cell, **kw):
    kind = "stream" if cell.endswith(".stream") else "request"
    return run.run_cell(M, cell, SEED, 0.2, False, device="cpu",
                        image_size=SIZE, traffic_overrides=SMALL[kind],
                        log=lambda m: None, **kw)


@pytest.mark.parametrize("name", ["resnet50", "mobilenet_v2"])
def test_reference_matches_the_plain_path(name):
    """Same weights, same images, one image at a time on both sides: most
    answers agree to f32 rounding. Where one bf16 rounding of an
    activation falls the other way (an f32 sum in another order), the gap
    grows through the layers to the bf16 noise floor, a few 1e-3."""
    import importlib
    from repro_torch.configs import get_config
    from repro_torch.models import cnn
    from bench.weights import make_images, make_raw, to_port
    cfg = run.load_json(run.BENCH / "configs" / f"{name}.json")
    mod = importlib.import_module(f"bench.reference.{cfg['model']}")
    gen = torch.Generator().manual_seed(SEED)
    raw = make_raw(mod.layers(cfg, 32), cfg["sparsity"], gen)
    imgs = make_images(8, 32, gen)
    ref = common.logits_in_blocks(lambda p, x: mod.forward(cfg, p, x),
                                  common.prepare(raw), imgs, 1, "cpu")
    out = cnn.cnn_forward(get_config(name), to_port(raw), imgs, device="cpu")
    gap = ((out - ref).abs().amax(1) / ref.abs().amax(1)).numpy()
    assert np.median(gap) < 1e-6 and gap.max() < 2e-2, gap


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "import bench.reference.resnet50, bench.reference.mobilenet_v2\n"
        "import bench.checks, bench.weights, bench.peaks\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax'))\n"
        "import bench.run, bench.trace, bench.control, bench.sweep\n"
        "import bench.drivers.request, bench.drivers.stream\n"
        "import repro_torch.launch.serve\n"
        "print(ref, bench.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_a_sound_run_is_correct(cell):
    line = cell_run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", ["resnet50.request", "mobilenet_v2.stream"])
def test_the_int8_control_is_not_correct(cell):
    line = cell_run(cell, quantize="int8")
    assert not line["correct"], line["checks"]


def _stale(entry):
    """A step that returns its state unchanged: every answer is the
    first one."""
    first = []

    def f(x):
        y = entry(x)
        if not first:
            first.append(y)
        return first[0].copy() if isinstance(y, np.ndarray) \
            else first[0].clone()
    return f


def _altered(entry):
    """One answer altered where it is produced: a logit of the second
    answer moved by 5% of the largest."""
    n = [0]

    def f(x):
        y = entry(x)
        n[0] += 1
        if n[0] == 2:
            y = y.copy() if isinstance(y, np.ndarray) else y.clone()
            y[0, 7] += 0.05 * abs(y).max()
        return y
    return f


def _lost(entry):
    """One answer lost: the second call's answer comes back a row short
    (a request's only row, a stream request's last image)."""
    n = [0]

    def f(x):
        y = entry(x)
        n[0] += 1
        return y[:-1] if n[0] == 2 else y
    return f


def _half_batch(results):
    """Half of a request's batch left out, the mean of the rest in its
    place."""
    def f(req):
        y = results(req).copy()
        h = y.shape[0] // 2
        y[h:] = y[:h].mean(axis=0)
        return y
    return f


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("resnet50.request", "mobilenet_v2.request")
    for f in (_stale, _altered)] + [
    (c, f) for c in ("resnet50.stream", "mobilenet_v2.stream")
    for f in (_stale, _altered, _half_batch)] + [
    ("resnet50.request", _lost), ("mobilenet_v2.stream", _lost)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    line = cell_run(cell, fault=fault)
    assert not line["correct"], line["checks"]
