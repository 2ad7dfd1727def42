"""Every CUDA kernel's domain against its Pallas kernel's, on the CPU.

Two kinds of check, both without a card:

- the plain version of each kernel, the function the kernel is held to
  on the card, against the reference's Pallas kernel in interpret mode
  at the shapes the kernels took on only lately: SparsityConfig's
  default 128 x 128 blocks (and the 64 x 64 and 128 x 125 ones sparse
  ResNet-50 takes at it), block sides that are no multiple of 64 or
  past 128, head sizes 16 / 40 / 80 / 96, the int8 and f32 pointwise at
  k 5 and 7, and k 9;
- each wrapper's shape check (``check_shapes``, which the wrapper runs
  before it launches) on a grid of shapes, against the Pallas kernel's
  own asserts (``jax.eval_shape`` traces the kernel, so its asserts run
  and nothing is computed): every shape the Pallas kernel takes, the
  check takes, and the check refuses only what the Pallas kernel
  refuses; and for every shape taken, the variant ``variant()`` names
  has a plan the launcher runs.
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SparsityConfig as RefSparsityConfig  # noqa: E402
from repro.core import sparsity as ref_sparsity  # noqa: E402
from repro.kernels.depthwise_conv import depthwise_conv_pallas  # noqa: E402
from repro.kernels.dw_pw_fused import dw_pw_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.sparse_conv import sparse_conv_pallas  # noqa: E402
from repro.kernels.sparse_matmul import sparse_matmul_pallas  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw  # noqa: E402
from repro_torch.kernels import dw_pw_fused as dwpw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import sparse_conv as sc  # noqa: E402
from repro_torch.kernels import sparse_matmul as sm  # noqa: E402
from repro_torch.models.cnn import params_from_numpy  # noqa: E402
from repro_torch.models.cnn import tensor_from_numpy as _t  # noqa: E402

S = jax.ShapeDtypeStruct


def _cast(a, dtype="bfloat16"):
    """numpy f32 -> numpy ``dtype`` ("bfloat16" rounds as JAX does)."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(dtype))


def bf16_tol(ref):
    """At most 1 bf16 ulp: f32 sums taken in another order, rounded once,
    so rtol 2**-7 plus an atol of the bf16 spacing at the output's scale
    (for values that cancel to near zero)."""
    scale = float(np.abs(ref).max())
    return 2.0 ** -7 * np.abs(ref) + 2.0 ** (math.floor(math.log2(scale)) - 7)


def f32_tol(ref):
    """f32 outputs of f32 sums in another order: rtol 1e-5 plus 1e-5 of
    the output's scale."""
    return 1e-5 * np.abs(ref) + 1e-5 * float(np.abs(ref).max())


def _close(got, want, tol_fn):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol_fn(want)).all(), float(err.max())


def _sparse(rng, d_in, d_out, bm, bn, sp):
    """A pruned weight in both worlds: (reference SparseWeight, port
    SparseWeight), from one seeded numpy draw."""
    w = _cast(rng.uniform(-1, 1, (d_in, d_out)) / math.sqrt(d_in))
    rsw = ref_sparsity.to_block_balanced(
        jnp.asarray(w), RefSparsityConfig(enabled=True, sparsity=sp,
                                          block_m=bm, block_n=bn))
    tree = {"t": {"w": {"vals": np.asarray(rsw.vals),
                        "idx": np.asarray(rsw.idx), "d_in": rsw.d_in},
                  "b": np.zeros(1, np.float32)}}
    return rsw, params_from_numpy(tree, device="cpu")["t"]["w"]


def _accepts(fn) -> bool:
    """Whether ``fn()`` returns (True) or raises the refusal its kernel
    makes (False): AssertionError for a Pallas kernel, ValueError for a
    port's shape check."""
    try:
        fn()
    except (AssertionError, ValueError):
        return False
    return True


# --- the plain versions against the Pallas kernels --------------------------

@pytest.mark.parametrize("d", [16, 40, 80, 96])
def test_flash_attention_any_head_size_matches_reference(d):
    """Head sizes no config of the repo has (Phi-2's 80, Phi-3-mini's 96)
    and ones no multiple of 16 or 32: causal, a window and an offset,
    f32."""
    rng = np.random.default_rng(d)
    t = 64 if d % 32 else 128
    q, k, v = (rng.normal(size=(1, t, 2, d)).astype(np.float32)
               for _ in range(3))
    kw = {"q_offset": 16, "window": 40}
    got = fa.flash_attention_torch(_t(q), _t(k), _t(v), **kw)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=32, block_k=32,
                                  **kw)
    _close(got, want, f32_tol)


@pytest.mark.parametrize("shape,dtype", [
    ((1024, 500, 128, 125), "float32"), ((768, 192, 96, 64), "bfloat16"),
    ((512, 512, 256, 256), "bfloat16")], ids=["b128x125", "bm96", "bm256"])
def test_sparse_matmul_any_block_matches_reference(shape, dtype):
    """The classifier's 128 x 125 blocks at SparsityConfig's default (f32
    x, as the forward feeds it), a side no multiple of 64 and one past
    128 (bf16), at M 16."""
    d_in, d_out, bm, bn = shape
    rng = np.random.default_rng([d_in, bm, bn])
    rsw, sw = _sparse(rng, d_in, d_out, bm, bn, 0.5)
    tol = f32_tol if dtype == "float32" else bf16_tol
    x = _cast(rng.normal(size=(16, d_in)), dtype)
    got = sm.sparse_matmul_torch(_t(x), sw.vals, sw.idx)
    _close(got, sparse_matmul_pallas(jnp.asarray(x), rsw.vals, rsw.idx,
                                     block_m_x=16), tol)


# (N, H, cin, cout, bm, bn, k, stride, residual): sparse ResNet-50's
# blocks at SparsityConfig's default, at 8 x 8 px
# (the 3x3 at 64 x 64 is in tests/test_torch_resnet_blocks.py)
_CONV_CASES = [(1, 8, 128, 256, 128, 128, 3, 1, True),
               (1, 8, 256, 128, 128, 128, 1, 2, False),
               (2, 8, 64, 64, 64, 64, 1, 2, True)]


@pytest.mark.parametrize("case", _CONV_CASES, ids=str)
def test_sparse_conv_large_blocks_match_reference(case):
    n, h, cin, cout, bm, bn, k, stride, residual = case
    rng = np.random.default_rng([cin, cout, bm, k])
    rsw, sw = _sparse(rng, k * k * cin, cout, bm, bn, 0.5)
    x = _cast(rng.normal(size=(n, h, h, cin)))
    b = _cast(rng.normal(size=(cout,)) * 0.1)
    ho = -(-h // stride)
    res = _cast(rng.normal(size=(n, ho, ho, cout))) if residual else None
    got = sc.sparse_conv_torch(_t(x), sw.vals, sw.idx, _t(b),
                               None if res is None else _t(res), k=k,
                               stride=stride)
    want = sparse_conv_pallas(jnp.asarray(x), rsw.vals, rsw.idx,
                              jnp.asarray(b),
                              None if res is None else jnp.asarray(res),
                              k=k, stride=stride)
    _close(got, want, bf16_tol)


@pytest.mark.parametrize("store,k", [("int8", 5), ("float32", 7),
                                     ("bfloat16", 9)])
def test_dw_pw_every_store_and_k_matches_reference(store, k):
    """int8 pointwise codes with their scale at k 5, all f32 at k 7 and
    bf16 at k 9 (past the templated kernel sizes)."""
    from repro.core import quant as ref_quant
    rng = np.random.default_rng(k)
    n, h, c, co, stride = 1, 11, 24, 40, 2
    dt = "float32" if store == "float32" else "bfloat16"
    x = _cast(rng.normal(size=(n, h, h, c)), dt)
    dw_w = _cast(rng.uniform(-1, 1, (k, k, c)) / k, dt)
    dw_b = _cast(rng.normal(size=(c,)) * 0.1, dt)
    pw_w = _cast(rng.uniform(-1, 1, (c, co)) / math.sqrt(c), dt)
    pw_b = _cast(rng.normal(size=(co,)) * 0.1, dt)
    res = _cast(rng.normal(size=(n, -(-h // stride), -(-h // stride), co)),
                dt)
    scale = None
    if store == "int8":
        q = ref_quant.quantize_tree({"l": {"w": jnp.asarray(pw_w)}},
                                    "int8")["l"]["w"]
        pw_w, scale = np.asarray(q.codes), np.asarray(q.scale)
        assert pw_w.dtype == np.int8
    got = dwpw.dw_pw_torch(_t(x), _t(dw_w), _t(dw_b), _t(pw_w), _t(pw_b),
                           _t(res), None if scale is None else _t(scale),
                           stride=stride)
    want = dw_pw_pallas(*(jnp.asarray(a) for a in (x, dw_w, dw_b, pw_w,
                                                    pw_b, res)),
                        None if scale is None else jnp.asarray(scale),
                        stride=stride)
    _close(got, want, f32_tol if dt == "float32" else bf16_tol)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_k9_matches_reference(stride):
    rng = np.random.default_rng(9 + stride)
    x = _cast(rng.normal(size=(1, 13, 13, 40)))
    w = _cast(rng.uniform(-1, 1, (9, 9, 40)) / 9)
    got = dw.depthwise_conv_torch(_t(x), _t(w), stride=stride)
    _close(got, depthwise_conv_pallas(jnp.asarray(x), jnp.asarray(w),
                                      stride=stride), bf16_tol)


# --- the shape checks against the Pallas asserts ----------------------------

def test_sparse_conv_check_takes_what_pallas_takes():
    n_grid = n_refused = 0
    for c in (48, 64, 128, 256):
        for bm in (8, 16, 24, 32, 48, 64, 96, 128):
            for bn in (40, 125):
                n_grid += 1
                k, stride = (3, 1) if (bm + bn) % 2 else (1, 2)
                x, vals = (1, 8, 8, c), (2, 3, bm, bn)
                ok = _accepts(lambda: jax.eval_shape(
                    functools.partial(sparse_conv_pallas, k=k,
                                      stride=stride),
                    S(x, jnp.bfloat16), S(vals, jnp.bfloat16),
                    S((2, 3), jnp.int32), S((2 * bn,), jnp.bfloat16)))
                assert ok == _accepts(lambda: sc.check_shapes(
                    x, vals, (2, 3), (2 * bn,), k=k, stride=stride)), \
                    (x, vals)
                assert ok == (c % bm == 0)
                n_refused += not ok
                if not ok:
                    continue
                ho = -(-8 // stride)
                if sc.variant(bm, bn) == "mma":
                    assert bm % 16 == 0 and bn % 8 == 0
                    steps = sc.k_steps(3, bm)
                    plan = sc.plan(ho * ho, 2, steps)
                    assert sc.check_plan(plan, steps) == plan
                    assert plan in sc.plan_candidates(steps)
                if sc.variant(bm, bn, torch.float32) != "simt":
                    raise AssertionError("f32 weights take simt")
    assert (n_grid, n_refused) == (64, 28)


def test_sparse_matmul_check_takes_what_pallas_takes():
    seen = set()
    for d_in in (240, 256, 1000):
        for bm in (8, 40, 64, 96, 125, 128, 256):
            for bn in (8, 25, 96, 125, 256):
                for m in (1, 256):
                    x, vals = (m, d_in), (3, 2, bm, bn)
                    ok = _accepts(lambda: jax.eval_shape(
                        sparse_matmul_pallas, S(x, jnp.bfloat16),
                        S(vals, jnp.bfloat16), S((3, 2), jnp.int32)))
                    assert ok == _accepts(lambda: sm.check_shapes(
                        x, vals, (3, 2))), (x, vals)
                    assert ok == (d_in % bm == 0)
                    if ok:
                        v = sm.variant(torch.bfloat16, m, bm, bn)
                        seen.add(v)
                        assert v != "mma" or (bm % 8 == 0 and bn % 8 == 0)
    assert seen == {"gemv", "mma", "simt"}


def test_flash_attention_check_takes_what_pallas_takes():
    for d in (1, 16, 20, 40, 64, 80, 96, 112, 128, 200, 256, 300):
        for t in (96, 200, 256):
            for dtype in (jnp.float32, jnp.bfloat16):
                q = (1, t, 2, d)
                ok = _accepts(lambda: jax.eval_shape(
                    flash_attention_pallas, S(q, dtype), S(q, dtype),
                    S(q, dtype)))
                # the Pallas blocks span the head: any d; a length its
                # 128-row blocks divide (or below 128)
                assert ok == (t <= 128 or t % 128 == 0)
                if ok:
                    assert _accepts(lambda: fa.check_shapes(q, q, q))
                torch_dtype = getattr(torch, jnp.dtype(dtype).name)
                assert fa.variant(torch_dtype, d) == (
                    "mma" if dtype == jnp.bfloat16 and d <= fa.MMA_MAX_D
                    else "simt")
    # lengths the Pallas blocks do not divide, the port takes too
    assert _accepts(lambda: fa.check_shapes((1, 200, 2, 40), (1, 300, 2, 40),
                                            (1, 300, 2, 40)))
    assert not _accepts(lambda: fa.check_shapes((1, 8, 2, 0), (1, 8, 2, 0),
                                                (1, 8, 2, 0)))


def test_dw_pw_check_takes_what_pallas_takes():
    n_mma = 0
    for k in (1, 3, 4, 7, 9):
        for stride in (1, 3):
            for c, co in ((24, 40), (36, 24), (64, 20)):
                for w_dtype in (jnp.bfloat16, jnp.int8, jnp.float32):
                    p_dtype = jnp.float32 if w_dtype == jnp.float32 \
                        else jnp.bfloat16
                    shapes = ((1, 9, 9, c), (k, k, c), (c,), (c, co), (co,))
                    scale = S((co,), jnp.float32) if w_dtype == jnp.int8 \
                        else None
                    ok = _accepts(lambda: jax.eval_shape(
                        functools.partial(dw_pw_pallas, stride=stride),
                        S(shapes[0], jnp.bfloat16), S(shapes[1], p_dtype),
                        S(shapes[2], p_dtype), S(shapes[3], w_dtype),
                        S(shapes[4], p_dtype), None, scale))
                    assert ok
                    assert _accepts(lambda: dwpw.check_shapes(
                        *shapes, None, None if scale is None else (co,),
                        stride=stride))
                    v = dwpw.variant(c, co, k, stride,
                                     getattr(torch, jnp.dtype(w_dtype).name))
                    if v == "mma":
                        n_mma += 1
                        assert k <= dwpw.MAX_K and (
                            w_dtype == jnp.bfloat16 or k == dwpw.QUANT_K)
                        ho = -(-9 // stride)
                        p = dwpw.plan(1, ho, ho, c, co, k, stride)
                        assert dwpw.check_plan(
                            p, 1, ho, ho, c, co, k, stride,
                            codes=w_dtype == jnp.int8)[:6] == p[:6]
    # bf16 at k <= 7 and int8 at k 3, x strides x C 24
    assert n_mma == (4 + 1) * 2 * 1


def test_depthwise_conv_check_takes_what_pallas_takes():
    for k in (1, 7, 8, 13):
        for stride in (1, 2):
            for c in (37, 64):
                x, w = (2, 11, 11, c), (k, k, c)
                assert _accepts(lambda: jax.eval_shape(
                    functools.partial(depthwise_conv_pallas, stride=stride),
                    S(x, jnp.bfloat16), S(w, jnp.bfloat16)))
                ho, wo, _, _ = dw.check_shapes(x, w, stride=stride)
                plan = dw.plan(2, ho, wo, c, k, stride)
                assert dw.check_plan(plan, c, stride, k) == plan
                assert plan[0] == 1 or k <= dw.MAX_K
