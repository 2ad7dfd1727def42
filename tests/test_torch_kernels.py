"""The port's plain kernel versions vs the JAX reference's Pallas kernels
(interpret mode, their default here) and XLA paths, at small sizes; and
the port's dispatch: a CPU tensor takes the plain version, and the CUDA
wrappers refuse anything that is not on a card."""
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SparsityConfig as RefSparsityConfig  # noqa: E402
from repro.core import sparsity as ref_sparsity  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.sparse_conv import sparse_conv_pallas  # noqa: E402
from repro.kernels.sparse_matmul import sparse_matmul_pallas  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import sparse_conv as sc  # noqa: E402
from repro_torch.kernels import sparse_matmul as sm  # noqa: E402
from repro_torch.models.cnn import params_from_numpy  # noqa: E402
from repro_torch.models.cnn import tensor_from_numpy as _t  # noqa: E402


def _bf16(a):
    """numpy f32 -> numpy bf16 (JAX's rounding)."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32))
                      .astype(jnp.bfloat16))


def _sparse(rng, d_in, d_out, bm, bn, sp):
    """A pruned weight in both worlds: (reference SparseWeight, port
    SparseWeight), from one seeded numpy draw."""
    w = _bf16(rng.uniform(-1, 1, (d_in, d_out)) / math.sqrt(d_in))
    rsw = ref_sparsity.to_block_balanced(
        jnp.asarray(w), RefSparsityConfig(enabled=True, sparsity=sp,
                                          block_m=bm, block_n=bn))
    tree = {"t": {"w": {"vals": np.asarray(rsw.vals),
                        "idx": np.asarray(rsw.idx), "d_in": rsw.d_in},
                  "b": np.zeros(1, np.float32)}}
    return rsw, params_from_numpy(tree, device="cpu")["t"]["w"]


def bf16_tol(ref):
    """At most 1 bf16 ulp: the outputs round f32 sums taken in another
    order, so rtol 2**-7 plus an atol of the bf16 spacing at the output's
    scale (for values that cancel to near zero)."""
    scale = float(np.abs(ref).max())
    return 2.0 ** -7 * np.abs(ref) + 2.0 ** (math.floor(math.log2(scale)) - 7)


def f32_tol(ref):
    """f32 outputs of f32 sums in another order."""
    return 1e-5 * np.abs(ref) + 1e-5 * float(np.abs(ref).max())


def _close(got, want, tol_fn):
    got = got.float().numpy()
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol_fn(want)).all(), float(err.max())


# (H, N, cin, cout, bm, bn, sparsity): odd sizes, batch 1 and 2, 32x32
# and 16x16 blocks, K >= 2 everywhere. Each (k, stride, residual, relu)
# runs one of them, alternating, so each case meets every value of each
# flag (every variant is a separate Pallas compile).
_CONV_CASES = [(7, 1, 128, 64, 32, 32, 0.5), (9, 2, 64, 32, 16, 16, 0.5)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_sparse_conv_matches_reference(k, stride, residual, relu):
    h, n, cin, cout, bm, bn, sp = _CONV_CASES[(k + stride + residual
                                               + relu) % 2]
    rng = np.random.default_rng([k, stride, int(residual), int(relu), h])
    rsw, sw = _sparse(rng, k * k * cin, cout, bm, bn, sp)
    assert sw.vals.shape[1] >= 2
    x = _bf16(rng.normal(size=(n, h, h, cin)))
    b = _bf16(rng.normal(size=(cout,)) * 0.1)
    ho = -(-h // stride)
    res = _bf16(rng.normal(size=(n, ho, ho, cout))) if residual else None
    got = ops.sparse_conv(_t(x), sw, _t(b), k=k, stride=stride, relu=relu,
                          residual=None if res is None else _t(res))
    assert got.dtype == torch.bfloat16
    jres = None if res is None else jnp.asarray(res)
    want = sparse_conv_pallas(jnp.asarray(x), rsw.vals, rsw.idx,
                              jnp.asarray(b), jres, k=k, stride=stride,
                              relu=relu)
    _close(got, want, bf16_tol)
    with ref_ops.config(impl="xla"):
        want_xla = ref_ops.sparse_conv(jnp.asarray(x), rsw, jnp.asarray(b),
                                       k=k, stride=stride, relu=relu,
                                       residual=jres)
    _close(got, want_xla, bf16_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("shape", [(256, 128, 32, 32), (256, 100, 32, 25)],
                         ids=["bn32", "bn25"])
def test_sparse_matmul_matches_reference(shape, m, dtype):
    d_in, d_out, bm, bn = shape
    rng = np.random.default_rng([d_out, m])
    rsw, sw = _sparse(rng, d_in, d_out, bm, bn, 0.75)
    x = rng.normal(size=(m, d_in)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    tol = f32_tol if dtype == "float32" else bf16_tol
    got = ops.sparse_matmul(_t(x), sw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, d_out)
    _close(got, sparse_matmul_pallas(jnp.asarray(x), rsw.vals, rsw.idx,
                                     block_m_x=m), tol)
    _close(got, ref_oracles.sparse_matmul_ref(jnp.asarray(x), rsw), tol)
    _close(got, ref.sparse_matmul_ref(_t(x), sw), tol)


def test_cpu_tensors_take_the_plain_version():
    """The dispatch picks the plain version from the tensor's device and
    launches (counts) nothing."""
    rng = np.random.default_rng(0)
    _, sw = _sparse(rng, 9 * 32, 32, 16, 16, 0.5)
    x = _t(_bf16(rng.normal(size=(1, 5, 5, 32))))
    b = torch.zeros(32, dtype=torch.bfloat16)
    ops.reset_launches()
    y = ops.sparse_conv(x, sw, b, k=3)
    assert torch.equal(y, sc.sparse_conv_torch(x, sw.vals, sw.idx, b, k=3))
    xm = torch.randn(2, 9 * 32)
    assert torch.equal(ops.sparse_matmul(xm, sw),
                       sm.sparse_matmul_torch(xm, sw.vals, sw.idx))
    assert set(ops.LAUNCHES) == set(_build.SOURCES)
    assert not any(ops.LAUNCHES.values())


def test_cuda_wrappers_refuse_cpu_tensors(monkeypatch):
    """No fallback: the kernel wrappers raise on a CPU tensor instead of
    running the plain version, before building anything."""
    built = []
    monkeypatch.setattr(_build, "load", built.append)
    sc._kernel.cache_clear()
    sm._kernel.cache_clear()
    rng = np.random.default_rng(1)
    _, sw = _sparse(rng, 64, 64, 32, 32, 0.5)
    b = torch.zeros(64, dtype=torch.bfloat16)
    with pytest.raises((ValueError, RuntimeError)):
        sc.sparse_conv(torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16),
                       sw.vals, sw.idx, b, k=1)
    with pytest.raises((ValueError, RuntimeError)):
        sm.sparse_matmul(torch.zeros(1, 64), sw.vals, sw.idx)
    with pytest.raises(ValueError):       # int8 codes with their scale
        sc.sparse_conv(torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16),
                       sw.vals.to(torch.int8), sw.idx, b,
                       scale=torch.ones(2, 32), k=1)
    assert built == []


def test_same_pads_and_block_coords_match_reference():
    from repro.kernels import sparse_conv as ref_sc
    for size in (7, 9, 56, 112, 224):
        for k in (1, 3, 7):
            for s in (1, 2):
                assert sc.same_pads(size, k, s) == ref_sc.same_pads(size, k, s)
    idx = np.arange(9 * 4).reshape(4, 9)
    for got, want in zip(sc.conv_block_coords(torch.from_numpy(idx), 3, 128,
                                              32),
                         ref_sc.conv_block_coords(idx, 3, 128, 32)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert sc.same_pads(224, 7, 2) == (112, 2, 3)    # the stem pads (2, 3)
    assert sc.same_pads(112, 3, 2) == (56, 0, 1)     # its max-pool (0, 1)
