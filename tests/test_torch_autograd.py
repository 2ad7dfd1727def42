"""The plain backwards of the two kernels the LM trains through
(``sparse_matmul_backward_torch``, ``flash_attention_backward_torch``:
the backwards of the port's ``torch.autograd.Function``s on the card)
against ``jax.vjp`` of the reference's ops and against torch autograd
through the port's plain forwards, on the CPU, on inputs made with
numpy.

Bars. Against torch autograd through the plain forward: 1 bf16 ulp
(2**-7 of each element plus the spacing at the output's largest): the
autograd path sums a gathered input block's cotangents in bf16, the
backward in f64 rounded once. Against ``jax.vjp``: sparse_matmul within
the same bar (XLA's scatter-add sums dx in bf16 as well); flash within
the same bar of the reference's naive f32 oracle (``kernels/ref.py::
attention_ref``, p in f32 as the port's), and within 2e-2 of each
gradient's largest against the reference's XLA twin
(``blockwise_attention``, which rounds p to bf16 before the PV product:
the port computes what the Pallas kernel computes, p in f32).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_ref import one_torch_thread  # noqa: E402,F401
from repro.core import sparsity as ref_sparsity  # noqa: E402
from repro.configs.base import SparsityConfig as RefSparsityConfig  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import sparse_matmul as sm  # noqa: E402
from repro_torch.models.layers import _repeat_kv  # noqa: E402
from repro_torch.models.layers import tensor_from_numpy as t_  # noqa: E402

XLA_FLASH_RTOL = 2e-2


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(
        jnp.bfloat16))


def _within(got, want, what):
    """1 bf16 ulp: 2**-7 of each element plus the spacing at the largest."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    atol = 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0
    bad = np.abs(got - want) > 2.0 ** -7 * np.abs(want) + atol
    assert not bad.any(), (what, float(np.abs(got - want).max()), scale)


def _sparse(seed, d_in, d_out, block, sparsity):
    """A block-balanced weight of both packages (the reference's pruning
    of one numpy matrix): (ref SparseWeight, port vals, port idx)."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(_bf16(rng.standard_normal((d_in, d_out)) / 8))
    sw = ref_sparsity.to_block_balanced(
        w, RefSparsityConfig(True, sparsity, block, block))
    return sw, t_(np.asarray(sw.vals)), t_(np.asarray(sw.idx)).int()


@pytest.mark.parametrize("m,d_in,d_out,block,sparsity", [
    (24, 128, 96, 16, 0.5), (7, 256, 128, 32, 0.75), (40, 192, 64, 64, 0.34)])
def test_sparse_matmul_backward(m, d_in, d_out, block, sparsity):
    rsw, vals, idx = _sparse(m, d_in, d_out, block, sparsity)
    rng = np.random.default_rng(m + 1)
    x = _bf16(rng.standard_normal((m, d_in)))
    dy = _bf16(rng.standard_normal((m, d_out)))
    dx, dvals = sm.sparse_matmul_backward_torch(t_(x), vals, idx, t_(dy))
    assert dx.dtype == dvals.dtype == torch.bfloat16
    # torch autograd through the plain forward
    xa, va = t_(x).requires_grad_(), vals.clone().requires_grad_()
    y = sm.sparse_matmul_torch(xa, va, idx)
    ga, gv = torch.autograd.grad(y, (xa, va), t_(dy))
    _within(dx, ga, "dx vs autograd")
    _within(dvals, gv, "dvals vs autograd")
    # jax.vjp of the reference's op (its XLA twin)
    with ref_ops.config(impl="xla"):
        _, vjp = jax.vjp(lambda xx, vv: ref_ops.sparse_matmul(
            xx, RefSparseWeight(vv, rsw.idx, rsw.d_in)),
            jnp.asarray(x), rsw.vals)
        rdx, rdv = vjp(jnp.asarray(dy))
    _within(dx, rdx, "dx vs jax.vjp")
    _within(dvals, rdv, "dvals vs jax.vjp")


def test_sparse_matmul_transposed_index():
    """Every (j, k) appears once, under its input block, in ascending
    j; the index is built once per weight view."""
    _, vals, idx = _sparse(3, 256, 192, 32, 0.5)
    jt, kt, valid = sm.transposed_index(idx, 8)
    seen = set()
    for i in range(8):
        js = jt[i][valid[i]].tolist()
        assert js == sorted(js)
        for j, k in zip(js, kt[i][valid[i]].tolist()):
            assert int(idx[j, k]) == i
            seen.add((j, k))
    assert seen == {(j, k) for j in range(idx.shape[0])
                    for k in range(idx.shape[1])}
    assert sm.transposed_index(idx, 8)[0] is jt


CASES = [  # (b, tq, tk, h, kv, d, causal, window, q_offset)
    (1, 70, 70, 2, 2, 32, True, 0, 0),
    (2, 130, 130, 4, 2, 64, True, 0, 0),          # GQA
    (1, 96, 96, 4, 1, 32, True, 24, 0),           # window, MQA
    (1, 40, 104, 2, 2, 32, True, 0, 64),          # a chunk at q_offset
    (1, 33, 77, 2, 2, 32, False, 0, 0),           # cross-attention
    (1, 600, 600, 2, 1, 32, True, 0, 0),          # two backward chunks
]


@pytest.mark.parametrize("b,tq,tk,h,kv,d,causal,window,q_offset", CASES)
def test_flash_attention_backward(b, tq, tk, h, kv, d, causal, window,
                                  q_offset):
    rng = np.random.default_rng(tq + tk + h)
    q = _bf16(rng.standard_normal((b, tq, h, d)))
    k = _bf16(rng.standard_normal((b, tk, kv, d)))
    v = _bf16(rng.standard_normal((b, tk, kv, d)))
    do = _bf16(rng.standard_normal((b, tq, h, d)))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    rep = h // kv

    def expand(t):
        return _repeat_kv(t, rep)

    # the backward on the expanded K/V, folded back over the groups by
    # autograd through the expansion (as the model's attention does)
    kk, vv = t_(k).requires_grad_(), t_(v).requires_grad_()
    ke, ve = expand(kk), expand(vv)
    dq, dke, dve = fa.flash_attention_backward_torch(
        t_(q), ke.detach(), ve.detach(), t_(do), causal, window, q_offset)
    dk, dv = torch.autograd.grad((ke, ve), (kk, vv), (dke, dve))
    assert dq.dtype == torch.bfloat16
    # torch autograd through the plain forward
    qa = t_(q).requires_grad_()
    ka, va = t_(k).requires_grad_(), t_(v).requires_grad_()
    o = fa.flash_attention_torch(qa, expand(ka), expand(va), **mask)
    for got, want, what in zip((dq, dk, dv), torch.autograd.grad(
            o, (qa, ka, va), t_(do)), "qkv"):
        _within(got, want, f"d{what} vs autograd")

    def ref_expand(t):
        return jnp.repeat(t, rep, axis=2)

    # jax.vjp of the reference's naive f32 oracle and of its XLA twin
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, vjp = jax.vjp(lambda a, bb, c: ref_kref.attention_ref(
        a, ref_expand(bb), ref_expand(c), **mask), *args)
    for got, want, what in zip((dq, dk, dv), vjp(jnp.asarray(do)), "qkv"):
        _within(got, want, f"d{what} vs jax.vjp(attention_ref)")
    with ref_ops.config(impl="xla"):
        _, vjp = jax.vjp(lambda a, bb, c: ref_ops.flash_attention(
            a, ref_expand(bb), ref_expand(c), **mask), *args)
        for got, want, what in zip((dq, dk, dv), vjp(jnp.asarray(do)),
                                   "qkv"):
            want = np.asarray(want.astype(jnp.float32))
            err = float(np.abs(got.float().numpy() - want).max())
            assert err <= XLA_FLASH_RTOL * float(np.abs(want).max()), (
                what, err)
