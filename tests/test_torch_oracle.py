"""The port's ``cnn_forward_reference``, the reference's frozen pre-IR
oracle (per-model forward monoliths through the same node executors as
the interpreter), on the CPU: bitwise the port's unfused interpreter
for the three nets, sparse and dense, batch 2; and within the parity
bars of the reference's own oracle on the reference's weights (seed 0,
carried across with ``params_from_numpy``). Images come from a numpy
seed."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.graph import graph_for  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402

ARCHS = ["resnet50", "mobilenet_v1", "mobilenet_v2"]
# the parity bar of tests/test_torch_cnn.py, and the MobileNets' bar
# (ROADMAP Queue 3 item 5); see tests/test_torch_cnn_leftovers.py
LOGIT_RTOL = 1e-3
MOBILENET_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, and a full torch thread pool in each oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, sparse):
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, sparsity=dataclasses.replace(cfg.sparsity, enabled=sparse))


def _numpy_tree(params):
    tree = {}
    for name, p in params.items():
        w = p["w"]
        if isinstance(w, RefSparseWeight):
            w = {"vals": np.asarray(w.vals), "idx": np.asarray(w.idx),
                 "d_in": w.d_in}
        else:
            w = np.asarray(w)
        tree[name] = {"w": w, "b": np.asarray(p["b"])}
    return tree


def _weights(arch):
    """(reference params, port params): the reference's seed-0 weights."""
    ref = jax.jit(lambda k: ref_cnn.init_cnn(ref_get_config(arch), k))(
        jax.random.PRNGKey(0))
    return ref, cnn.params_from_numpy(_numpy_tree(ref), device="cpu")


def _images(n, size, seed):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _assert_logits_close(got, ref, rtol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= rtol * scale, \
        (np.abs(got - ref).max(), scale)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_oracle_equals_unfused_interpreter_bitwise(arch, sparse):
    """The oracle and the unfused view run the same node executors on the
    same values: equal bit for bit (the reference's own contract), with
    every conv pruned or every conv dense."""
    cfg = _cfg(arch, sparse)
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    n_sparse = sum(isinstance(p["w"], SparseWeight) for p in params.values())
    assert (n_sparse > 0) == sparse
    x = _images(2, 32, 7)
    got = cnn.cnn_forward_reference(cfg, params, x, device="cpu")
    want = cnn.cnn_forward(cfg, params, x, graph=graph_for(arch),
                           device="cpu")
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    assert torch.equal(got, want)
    # and one image at a time gives the batch's rows
    assert torch.equal(cnn.cnn_forward_reference(cfg, params, x[1:],
                                                 device="cpu"), got[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_oracle_matches_the_references_oracle(arch):
    """Against the reference's own oracle, batch 2, within the parity
    bars: sparse ResNet-50 at 1e-3 against its XLA path (the Pallas conv
    in interpret mode takes minutes a forward); the MobileNets at their
    bar, 1e-2, against the reference's Pallas depthwise, as the unfused
    views are held (ROADMAP Queue 3 item 5: its XLA twin rounds in
    bf16). The oracle's pointwise convs are the unfused view's, whose
    f32 sums the reference rounds across bf16 ties where the port sums
    exactly (Queue 3 item 2), and a flip carries on through the
    random-init net."""
    ref_params, params = _weights(arch)
    x = _images(2, 32, 8)
    impl, rtol = ("xla", LOGIT_RTOL) if arch == "resnet50" \
        else ("pallas", MOBILENET_RTOL)
    with ref_ops.config(impl=impl):
        fwd = functools.partial(ref_cnn.cnn_forward_reference,
                                ref_get_config(arch))
        want = np.asarray(fwd(ref_params, x) if impl == "pallas"
                          else jax.jit(fwd)(ref_params, x))
    got = cnn.cnn_forward_reference(get_config(arch), params, x,
                                    device="cpu")
    _assert_logits_close(got.numpy(), want, rtol)
