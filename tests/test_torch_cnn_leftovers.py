"""The CNN leftovers of the port against the reference, on the CPU (the
frozen oracle is in tests/test_torch_oracle.py):

- the interpreter's parity against the reference's at 64 px (three
  nets), ResNet-50 at batch 4, and dense ResNet-50;
- ``fusion.graph_hbm_bytes`` / ``fused_block_traffic``, the sparsity
  helpers (``density``, run-length codes, ``partition_for_splits``,
  ``unstructured_mask``) and ``costmodel.op_cost_unstructured``: equal
  to the reference's on the same inputs;
- the deprecated ``serve_cnn*`` shims: a ``DeprecationWarning``, then
  what the private call returns.

Weights are the reference's (seed 0), carried across with
``params_from_numpy``; images come from a numpy seed."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import costmodel as ref_costmodel  # noqa: E402
from repro.core import fusion as ref_fusion  # noqa: E402
from repro.core import sparsity as ref_sparsity  # noqa: E402
from repro.core.fusion import fused_graph_for as ref_fused_graph_for  # noqa: E402
from repro.core.graph import graph_for as ref_graph_for  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import costmodel, fusion, sparsity  # noqa: E402
from repro_torch.core.fusion import fused_graph_for  # noqa: E402
from repro_torch.core.graph import INPUT, graph_for  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402

ARCHS = ["resnet50", "mobilenet_v1", "mobilenet_v2"]
# the parity bar of tests/test_torch_cnn.py: max |diff| <= 1e-3 of max
# |ref logit| and equal top-1
LOGIT_RTOL = 1e-3
# the MobileNets' bar past 32 px (ROADMAP, Queue 3 item 5): 1e-2 of max
# |ref logit| and equal top-1, with every node, fed the reference's
# inputs, within one bf16 ulp of the reference's node. Where the
# reference's f32 pointwise sum rounds a bf16 activation across a tie
# the port (an exact sum) takes the other side, and the random-init
# network carries that flip on (Queue 3 item 2).
MOBILENET_RTOL = 1e-2
# dense ResNet-50 is held to the same bar for the same reason
DENSE_RTOL = MOBILENET_RTOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, and a full torch thread pool in each oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(arch, sparse=None):
    cfg = ref_get_config(arch)
    if sparse is None:
        return cfg
    return dataclasses.replace(
        cfg, sparsity=dataclasses.replace(cfg.sparsity, enabled=sparse))


def _cfg(arch, sparse=None):
    cfg = get_config(arch)
    if sparse is None:
        return cfg
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


@functools.lru_cache(maxsize=None)
def _weights(arch, sparse=None):
    """(reference params, port params): the reference's seed-0 weights,
    the net's own sparsity unless ``sparse`` says otherwise."""
    cfg = _ref_cfg(arch, sparse)
    ref = jax.jit(lambda k: ref_cnn.init_cnn(cfg, k))(jax.random.PRNGKey(0))
    return ref, cnn.params_from_numpy(_numpy_tree(ref), device="cpu")


def _images(n, size, seed):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _ref_forward(arch, ref_params, x, *, sparse=None, impl="xla",
                 oracle=False):
    cfg = _ref_cfg(arch, sparse)
    fwd = ref_cnn.cnn_forward_reference if oracle else ref_cnn.cnn_forward
    with ref_ops.config(impl=impl):
        if impl == "pallas":        # interpret mode: eager, as its tests
            return np.asarray(fwd(cfg, ref_params, x))
        return np.asarray(jax.jit(lambda p, im: fwd(cfg, p, im))(
            ref_params, x))


def _assert_logits_close(got, ref, rtol=LOGIT_RTOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= rtol * scale, \
        (np.abs(got - ref).max(), scale)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _assert_nodes_track_reference(arch, ref_params, params, x):
    """The port's fused forward node by node against the reference's node
    fed the same inputs: bf16 values within one bf16 ulp of the
    reference's, the logits within the parity bar."""
    env = {INPUT: torch.from_numpy(x).to(torch.bfloat16)}
    with torch.inference_mode(), ref_ops.config(impl="xla"):
        for node, ref_node, srcs in zip(fused_graph_for(arch).nodes,
                                        ref_fused_graph_for(arch).nodes,
                                        fused_graph_for(arch).inputs):
            assert node.name == ref_node.name
            args = [env[s] for s in srcs]
            got = cnn.run_node(node, params, *args)
            ref_args = [jnp.asarray(a.float().numpy()).astype(
                jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
                for a in args]
            want = np.asarray(jax.jit(
                lambda *a, n=ref_node: ref_cnn.run_node(n, ref_params, *a))(
                    *ref_args), np.float32)
            if got.dtype == torch.bfloat16:
                np.testing.assert_allclose(
                    got.float().numpy(), want, rtol=2 ** -7,
                    atol=2 ** -7 * np.abs(want).max(), err_msg=node.name)
            else:
                _assert_logits_close(got.numpy(), want)
            env[node.name] = got


# --- the interpreter's parity gates ------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_parity_at_64px(arch):
    ref_params, params = _weights(arch)
    x = _images(1, 64, 9)
    want = _ref_forward(arch, ref_params, x)
    got = cnn.cnn_forward(get_config(arch), params, x, device="cpu")
    if arch == "resnet50":
        _assert_logits_close(got.numpy(), want)
        return
    _assert_logits_close(got.numpy(), want, rtol=MOBILENET_RTOL)
    _assert_nodes_track_reference(arch, ref_params, params, x)


def test_resnet50_batch4_matches_reference():
    ref_params, params = _weights("resnet50")
    x = _images(4, 32, 10)
    _assert_logits_close(
        cnn.cnn_forward(get_config("resnet50"), params, x, device="cpu"
                        ).numpy(), _ref_forward("resnet50", ref_params, x))


def test_dense_resnet50_matches_reference():
    """Every conv dense: 53 library convs whose f32 sums run in another
    order than the reference's, so the MobileNets' bar (a bf16 rounding
    flip carried on, every node within one bf16 ulp)."""
    ref_params, params = _weights("resnet50", sparse=False)
    assert not any(isinstance(p["w"], SparseWeight) for p in params.values())
    x = _images(1, 32, 11)
    _assert_logits_close(
        cnn.cnn_forward(_cfg("resnet50", False), params, x,
                        device="cpu").numpy(),
        _ref_forward("resnet50", ref_params, x, sparse=False),
        rtol=DENSE_RTOL)
    _assert_nodes_track_reference("resnet50", ref_params, params, x)


# --- modeled HBM traffic -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_graph_hbm_bytes_and_block_traffic_equal_the_references(arch):
    ref_params, _ = _weights(arch)
    shape = (1, 224, 224, 3)
    ref_shapes = ref_cnn.node_shapes(ref_get_config(arch), ref_params, shape,
                                     graph=ref_graph_for(arch))
    shapes = cnn.node_shapes(get_config(arch), None, shape,
                             graph=graph_for(arch))
    for g, rg in ((graph_for(arch), ref_graph_for(arch)),
                  (fused_graph_for(arch), ref_fused_graph_for(arch))):
        got = fusion.graph_hbm_bytes(g, shapes)
        assert got == ref_fusion.graph_hbm_bytes(rg, ref_shapes)
        assert all(isinstance(v, int) and v > 0 for v in got.values())
    got = fusion.fused_block_traffic(arch, shapes)
    assert got == ref_fusion.fused_block_traffic(arch, ref_shapes)
    if arch != "resnet50":
        # a MobileNet dw->pw pair: 4 full-tensor passes unfused, 2 fused
        assert all((v["unfused_passes"], v["fused_passes"]) == (4, 2)
                   for k, v in got.items() if k.endswith("_pw")
                   and len(v["parts"]) == 2)


# --- the sparsity helpers and the unstructured cost ---------------------------

def test_density_runlength_and_partition_equal_the_references():
    """Over every pruned layer of sparse ResNet-50: the density, the
    run-length stream (and its inverse), and the per-split block counts
    at 1-8 splits."""
    ref_params, params = _weights("resnet50")
    n = 0
    for name, p in params.items():
        w, rw = p["w"], ref_params[name]["w"]
        if not isinstance(w, SparseWeight):
            continue
        n += 1
        assert sparsity.density(w) == ref_sparsity.density(rw)
        idx = w.idx.numpy()
        rl = sparsity.encode_runlength(idx)
        want = ref_sparsity.encode_runlength(np.asarray(rw.idx))
        assert rl.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(rl, want)
        np.testing.assert_array_equal(sparsity.decode_runlength(rl),
                                      ref_sparsity.decode_runlength(want))
        np.testing.assert_array_equal(sparsity.decode_runlength(rl), idx)
        for splits in (1, 2, 3, 4, 8):
            counts, padded = sparsity.partition_for_splits(w, splits)
            rc, rp = ref_sparsity.partition_for_splits(rw, splits)
            assert counts.dtype == rc.dtype and padded == rp
            np.testing.assert_array_equal(counts, rc)
    assert n == 48


@pytest.mark.parametrize("key,shape,frac,clump", [
    (0, (64, 32), 0.85, 0.5), (7, (96, 40), 0.5, 0.0),
    (123, (17, 5), 0.9, 1.3), (2 ** 31 - 1, (256, 128), 0.7, 0.8)])
def test_unstructured_mask_and_cost_equal_the_references(key, shape, frac,
                                                         clump):
    mask = sparsity.unstructured_mask(key, shape, frac, clump=clump)
    want = ref_sparsity.unstructured_mask(key, shape, frac, clump=clump)
    assert mask.dtype == want.dtype == np.bool_ and mask.shape == shape
    np.testing.assert_array_equal(mask, want)
    cost = costmodel.op_cost_unstructured("layer", mask, 14, 28)
    ref = ref_costmodel.op_cost_unstructured("layer", want, 14, 28)
    assert (cost.name, cost.lines, cost.width, cost.n_in_units, cost.idx) \
        == (ref.name, ref.lines, ref.width, ref.n_in_units, ref.idx)
    assert cost.nnz_per_co.dtype == ref.nnz_per_co.dtype
    np.testing.assert_array_equal(cost.nnz_per_co, ref.nnz_per_co)
    np.testing.assert_array_equal(cost.mask, ref.mask)
    for splits in (1, 2, 3, 5, 16):
        for model in ("naive", "aware"):
            assert cost.cycles(splits, model) == ref.cycles(splits, model)
        assert cost.resource(splits) == ref.resource(splits)


# --- the deprecated shims ---------------------------------------------------

@pytest.mark.parametrize("shim", ["serve_cnn", "serve_cnn_continuous",
                                  "serve_cnn_tier"])
def test_deprecated_shims_warn_and_return_the_private_call(shim):
    kw = dict(image_size=32, n_stages=2, verbose=False, device="cpu")
    if shim == "serve_cnn":
        kw.update(batch=4, n_microbatches=2, iters=1)
        private = port_serve._serve_cnn
    elif shim == "serve_cnn_continuous":
        kw.update(n_requests=2, batch=3, mb_size=2)
        private = port_serve._serve_cnn_continuous
    else:
        kw.update(n_requests=2, batch=4, mb_size=2, n_replicas=2)
        private = port_serve._serve_cnn_tier
    with pytest.warns(DeprecationWarning, match=f"{shim}\\(\\) is deprecated"):
        got = getattr(port_serve, shim)("mobilenet_v1", **kw)
    want = private("mobilenet_v1", **kw)
    assert got.keys() == want.keys()
    logits = got["logits"] if isinstance(got["logits"], list) \
        else [got["logits"]]
    want_logits = want["logits"] if isinstance(want["logits"], list) \
        else [want["logits"]]
    assert len(logits) == len(want_logits) > 0
    for a, b in zip(logits, want_logits):
        np.testing.assert_array_equal(a, b)
