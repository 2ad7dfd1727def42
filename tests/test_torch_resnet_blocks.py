"""Sparse ResNet-50 at SparsityConfig's default 128 x 128 blocks: the
port against the JAX reference on the CPU, at full width and 32 px.

The reference's weights go across through ``params_from_numpy`` bit for
bit: 30 convs pruned at 128 x 128, the 3 whose 64 input channels a
128-row block does not divide at 64 x 64, and the classifier at 128 x
125. The port's plain forward is held to the reference's ``cnn_forward``
on its XLA path, and one 128 x 128 node to the reference's Pallas
``sparse_conv`` in interpret mode. On the card the same blocks run
through the mma variants that walk a block as 32 x 32 pieces
(``chip_smoke.py``'s ``[domain]`` phase).
"""
import collections
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.sparse_conv import sparse_conv_pallas  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import sparse_conv as sc  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.cnn import tensor_from_numpy as _t  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402

IMAGE = 32
# max |diff| <= 1e-3 * max |ref logit| and equal top-1, as at the 32 x 32
# blocks (tests/test_torch_cnn.py): f32 sums in another order may round
# a bf16 activation the other way, which later layers carry on
LOGIT_RTOL = 1e-3
BLOCKS = {(128, 128): 30, (64, 64): 3, (128, 125): 1}


def _large_blocks(cfg):
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, block_m=128, block_n=128))


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, reference params, numpy tree, port cfg, port
    params) at 128 x 128 blocks."""
    ref_cfg = _large_blocks(ref_get_config("resnet50"))
    ref_params = jax.jit(lambda k: ref_cnn.init_cnn(ref_cfg, k))(
        jax.random.PRNGKey(0))
    tree = {}
    for name, p in ref_params.items():
        w = p["w"]
        if isinstance(w, RefSparseWeight):
            w = {"vals": np.asarray(w.vals), "idx": np.asarray(w.idx),
                 "d_in": w.d_in}
        else:
            w = np.asarray(w)
        tree[name] = {"w": w, "b": np.asarray(p["b"])}
    cfg = _large_blocks(get_config("resnet50"))
    return ref_cfg, ref_params, tree, cfg, cnn.params_from_numpy(
        tree, device="cpu")


def test_params_from_numpy_keeps_128_blocks_bit_for_bit(weights):
    _, _, tree, cfg, params = weights
    blocks = collections.Counter()
    for name, p in params.items():
        want = tree[name]["w"]
        if not isinstance(want, dict):
            continue
        w = p["w"]
        assert isinstance(w, SparseWeight) and w.d_in == want["d_in"]
        np.testing.assert_array_equal(w.idx.numpy(), want["idx"])
        np.testing.assert_array_equal(w.vals.view(torch.int16).numpy(),
                                      want["vals"].view(np.int16))
        blocks[tuple(w.vals.shape[2:])] += 1
    assert blocks == BLOCKS
    # the port's own init prunes the same layers at the same blocks
    mine = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert collections.Counter(
        tuple(p["w"].vals.shape[2:]) for p in mine.values()
        if isinstance(p["w"], SparseWeight)) == BLOCKS
    assert tuple(params["fc"]["w"].vals.shape) == \
        tuple(mine["fc"]["w"].vals.shape) == (8, 2, 128, 125)


def test_forward_at_128_blocks_matches_reference_xla(weights):
    ref_cfg, ref_params, _, cfg, params = weights
    x = np.random.default_rng(7).normal(
        size=(1, IMAGE, IMAGE, 3)).astype(np.float32)
    with ref_ops.config(impl="xla"):
        ref = jax.jit(lambda p, im: ref_cnn.cnn_forward(ref_cfg, p, im))(
            ref_params, x)
    got = cnn.cnn_forward(cfg, params, x, device="cpu").numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (1, 1000) and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= LOGIT_RTOL * scale, \
        (np.abs(got - ref).max(), scale)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("node", ["s1b1_c2", "s0b1_c2"])
def test_node_at_large_blocks_matches_reference_pallas(weights, node):
    """A 3x3 conv pruned at 128 x 128 (stage 1, 4 x 4 px at 32 px) and
    one at 64 x 64 (stage 0, 8 x 8), the reference's weights on both
    sides: the port's plain sparse_conv within 1 bf16 ulp of the Pallas
    kernel in interpret mode."""
    _, ref_params, _, _, params = weights
    sw, rsw = params[node]["w"], ref_params[node]["w"]
    bm = sw.vals.shape[2]
    cin = sw.d_in // 9
    h = {128: 4, 64: 8}[bm]
    rng = np.random.default_rng(bm)
    x = np.asarray(jnp.asarray(rng.normal(size=(1, h, h, cin)).astype(
        np.float32)).astype(jnp.bfloat16))
    b = np.asarray(jnp.asarray((rng.normal(size=(sw.d_out,)) * 0.1).astype(
        np.float32)).astype(jnp.bfloat16))
    got = sc.sparse_conv_torch(_t(x), sw.vals, sw.idx, _t(b), k=3)
    want = np.asarray(sparse_conv_pallas(jnp.asarray(x), rsw.vals, rsw.idx,
                                         jnp.asarray(b), k=3)
                      .astype(jnp.float32))
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert (np.abs(got - want) <= tol).all()
