"""The port's stored weight dtypes (``core/quant.py``) vs the JAX
reference, at full width, 32 px: the quantizer bit for bit, the stored
bytes, the plain versions with a scale against the Pallas kernels with
a scale, and serving at every store dtype on the CPU. The int8 and f32
forwards against the reference are in
``tests/test_torch_quant_forward.py``; both files share
``tests/_torch_quant_ref.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core.costmodel import pytree_param_bytes as ref_param_bytes  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import dw_pw_fused as dwpw  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparse_conv as sc  # noqa: E402
from repro_torch.kernels import sparse_matmul as sm  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight, tensor_from_numpy  # noqa: E402
from _torch_quant_ref import (  # noqa: E402
    ARCHS, IMAGE, _assert_same_leaf, _forward, _numpy_tree, _weights)


# --- the quantizer ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_matches_reference_bitwise(arch):
    """Codes, scales and orig_dtype of every leaf equal the reference's
    bit for bit; int8 touches every weight of two or more axes and no
    bias; quantizing again changes nothing."""
    _, ref8, native = _weights(arch)
    want = cnn.params_from_numpy(_numpy_tree(ref8), device="cpu")
    got = quant.quantize_tree(native, "int8")
    assert got.keys() == want.keys()
    for name in got:
        for part in ("w", "b"):
            _assert_same_leaf(got[name][part], want[name][part])
        assert isinstance(got[name]["w"], (quant.QuantizedWeight,
                                           SparseWeight))
        assert got[name]["w"].orig_dtype == "bfloat16"
        assert got[name]["b"].dtype == torch.bfloat16
    again = quant.quantize_tree(got, "int8")
    for name in got:
        assert again[name]["w"] is got[name]["w"]
        _assert_same_leaf(again[name]["b"], got[name]["b"])
    # the other store dtypes: bf16 is a bitwise no-op on native weights
    for sd in ("bf16", "f32"):
        restored = quant.quantize_tree(native, sd)
        ref_sd = cnn.params_from_numpy(_numpy_tree(
            ref_quant.quantize_tree(_weights(arch)[0], sd)), device="cpu")
        for name in restored:
            for part in ("w", "b"):
                _assert_same_leaf(restored[name][part], ref_sd[name][part])


def test_unknown_store_dtype_refused_by_both():
    w = {"w": {"w": torch.ones(2, 2), "b": torch.ones(2)}}
    for port_fn, ref_fn in ((quant.quantize_tree, ref_quant.quantize_tree),
                            (quant.tree_stored_bytes,
                             ref_quant.tree_stored_bytes)):
        for bad in ("int4", "fp8"):
            with pytest.raises(ValueError) as port_err:
                port_fn(w, bad)
            with pytest.raises(ValueError) as ref_err:
                ref_fn({"w": jnp.ones((2, 2))}, bad)
            assert str(port_err.value) == str(ref_err.value)


def test_quantizer_rules():
    """Per last-axis channel, symmetric, f32 scales; an all-zero channel
    gets scale 1.0 and dequantizes to exactly 0; codes round half to
    even and clip to [-127, 127]."""
    w = torch.tensor([[0.5, 0.0, -2.0], [1.0, 0.0, 254.0 / 127.0],
                      [-0.25, 0.0, 1.0 / 127.0]], dtype=torch.float32)
    q = quant.quantize_tree({"l": {"w": w}}, "int8")["l"]["w"]
    assert q.scale.dtype == torch.float32 and q.codes.dtype == torch.int8
    np.testing.assert_array_equal(q.scale.numpy(),
                                  np.float32([1.0 / 127, 1.0, 2.0 / 127]))
    np.testing.assert_array_equal(q.codes[:, 2].numpy(), [-127, 127, 0])
    np.testing.assert_array_equal(q.codes[:, 1].numpy(), [0, 0, 0])
    assert float(q.dequant()[:, 1].abs().max()) == 0.0
    # 0.5 / (1/127) = 63.5 rounds to 64 (even), -0.25 * 127 = -31.75 -> -32
    np.testing.assert_array_equal(q.codes[:, 0].numpy(), [64, 127, -32])
    err = (q.dequant() - w).abs()
    assert bool((err <= 0.5 * q.scale + 1e-7).all())


@pytest.mark.parametrize("sd", quant.STORE_DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_stored_bytes_match_tree_and_reference(arch, sd):
    """``tree_stored_bytes`` equals the bytes of the materialised tree
    and the reference's number for the same weights."""
    ref, _, native = _weights(arch)
    got = quant.tree_stored_bytes(native, sd)
    assert got == quant.pytree_param_bytes(quant.quantize_tree(native, sd))
    assert got == quant.pytree_param_bytes(native, sd)
    assert got == ref_quant.tree_stored_bytes(ref, sd) == \
        ref_param_bytes(ref, sd)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_a_quantized_tree_bitwise(arch):
    """int8 codes, f32 scales and orig_dtype names cross unchanged, and
    dequantize exactly as the reference's do."""
    _, ref8, _ = _weights(arch)
    tree = _numpy_tree(ref8)
    params = cnn.params_from_numpy(tree, device="cpu")
    for name, p in params.items():
        w, want = p["w"], tree[name]["w"]
        if "codes" in want:
            assert isinstance(w, quant.QuantizedWeight)
            np.testing.assert_array_equal(w.codes.numpy(), want["codes"])
            ref_dq = np.asarray(ref8[name]["w"].dequant())
        else:
            assert isinstance(w, SparseWeight) and w.d_in == want["d_in"]
            np.testing.assert_array_equal(w.vals.numpy(), want["vals"])
            np.testing.assert_array_equal(w.idx.numpy(), want["idx"])
            ref_dq = np.asarray(ref8[name]["w"].dequant_vals())
        assert w.orig_dtype == want["orig_dtype"]
        np.testing.assert_array_equal(w.scale.numpy(), want["scale"])
        dq = w.dequant() if "codes" in want else w.dequant_vals()
        np.testing.assert_array_equal(dq.view(torch.int16).numpy(),
                                      ref_dq.view(np.int16))
    back = quant.dequantize_tree(params)
    ref_back = cnn.params_from_numpy(_numpy_tree(
        ref_quant.dequantize_tree(ref8)), device="cpu")
    for name in back:
        _assert_same_leaf(back[name]["w"], ref_back[name]["w"])


# --- the plain versions with a scale vs the Pallas kernels -----------------------

def _codes_and_scale(rng, shape, scale_shape):
    codes = rng.integers(-127, 128, size=shape).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, size=scale_shape) / 127).astype(
        np.float32)
    return codes, scale


def _bf16(rng, shape, s=1.0):
    return jnp.asarray(rng.normal(size=shape) * s, jnp.bfloat16)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
def test_sparse_conv_torch_with_scale_matches_pallas(residual):
    from repro.kernels.sparse_conv import sparse_conv_pallas
    rng = np.random.default_rng(8)
    c, co, k, bm, bn, n_k = 64, 64, 3, 32, 32, 5
    ob = co // bn
    x = _bf16(rng, (1, 9, 9, c))
    codes, scale = _codes_and_scale(rng, (ob, n_k, bm, bn), (ob, bn))
    idx = np.stack([np.sort(rng.choice(k * k * c // bm, n_k, replace=False))
                    for _ in range(ob)]).astype(np.int32)
    b = _bf16(rng, (co,), 0.1)
    res = _bf16(rng, (1, 5, 5, co)) if residual else None
    want = sparse_conv_pallas(x, jnp.asarray(codes), jnp.asarray(idx), b, res,
                              jnp.asarray(scale), k=k, stride=2, relu=True)
    got = sc.sparse_conv_torch(_t(x), torch.from_numpy(codes),
                               torch.from_numpy(idx), _t(b),
                               None if res is None else _t(res),
                               torch.from_numpy(scale), k=k, stride=2,
                               relu=True)
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def test_sparse_matmul_torch_with_int8_codes_matches_pallas():
    """The code product (the scale is applied after the kernel, in
    ``ops.sparse_matmul``, as in the reference)."""
    from repro.kernels.sparse_matmul import sparse_matmul_pallas
    rng = np.random.default_rng(9)
    codes, scale = _codes_and_scale(rng, (4, 3, 32, 25), (4, 25))
    idx = np.stack([np.sort(rng.choice(8, 3, replace=False))
                    for _ in range(4)]).astype(np.int32)
    x = rng.normal(size=(2, 256)).astype(np.float32)
    want = np.asarray(sparse_matmul_pallas(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(idx)))
    got = sm.sparse_matmul_torch(torch.from_numpy(x), torch.from_numpy(codes),
                                 torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    sw = SparseWeight(torch.from_numpy(codes), torch.from_numpy(idx), 256,
                      torch.from_numpy(scale), "bfloat16")
    ref_sw = RefSparseWeight(jnp.asarray(codes), jnp.asarray(idx), 256,
                             scale=jnp.asarray(scale), orig_dtype="bfloat16")
    with ref_ops.config(impl="pallas"):
        ref_y = np.asarray(ref_ops.sparse_matmul(jnp.asarray(x), ref_sw))
    np.testing.assert_allclose(ops.sparse_matmul(torch.from_numpy(x),
                                                 sw).numpy(), ref_y,
                               rtol=1e-5, atol=1e-5 * np.abs(ref_y).max())


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
def test_dw_pw_torch_with_scale_matches_pallas(residual):
    from repro.kernels.dw_pw_fused import dw_pw_pallas
    rng = np.random.default_rng(10)
    c, co = 48, 40
    x = _bf16(rng, (1, 10, 10, c))
    dw_w, dw_b = _bf16(rng, (3, 3, c), 1 / 3), _bf16(rng, (c,), 0.1)
    codes, scale = _codes_and_scale(rng, (c, co), (co,))
    pw_b = _bf16(rng, (co,), 0.1)
    res = _bf16(rng, (1, 10, 10, co)) if residual else None
    want = np.asarray(dw_pw_pallas(x, dw_w, dw_b, jnp.asarray(codes), pw_b,
                                   res, jnp.asarray(scale), stride=1,
                                   relu=not residual), np.float32)
    got = dwpw.dw_pw_torch(_t(x), _t(dw_w), _t(dw_b), torch.from_numpy(codes),
                           _t(pw_b), None if res is None else _t(res),
                           torch.from_numpy(scale), stride=1,
                           relu=not residual)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def test_sparse_weight_scale_comes_with_int8_codes():
    idx = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        SparseWeight(torch.zeros(1, 1, 4, 4), idx, 16, scale=torch.ones(1, 4),
                     orig_dtype="bfloat16")
    with pytest.raises(ValueError, match="scale"):
        SparseWeight(torch.zeros(1, 1, 4, 4, dtype=torch.int8), idx, 16,
                     scale=torch.ones(1, 4))
    sw = SparseWeight(torch.ones(1, 1, 4, 4, dtype=torch.int8), idx, 16,
                      scale=torch.full((1, 4), 0.5), orig_dtype="bfloat16")
    assert sw.dequantized().vals.dtype == torch.bfloat16
    assert float(sw.dequant_vals().float().max()) == 0.5
    assert sw.to("cpu").scale is not None


# --- serving ----------------------------------------------------------------------

@pytest.mark.parametrize("sd", quant.STORE_DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cpu_at_every_store_dtype(arch, sd):
    """``serve`` on the CPU at each store dtype: the requests run eagerly,
    the logits equal the plain forward on the same stored weights, and
    ``param_bytes_stored`` is the reference's number."""
    out = serve(ServeConfig(arch=arch, mode="latency", quantize=sd,
                            device="cpu", image_size=IMAGE, n_requests=2,
                            verbose=False))
    assert out["quantize"] == sd and not out["captured"]
    ref_shapes = jax.eval_shape(
        lambda k: ref_cnn.init_cnn(ref_get_config(arch), k),
        jax.random.PRNGKey(0))
    assert out["param_bytes_stored"] == ref_param_bytes(ref_shapes, sd)
    assert out["logits"].shape == (2, 1000)
    assert np.isfinite(out["logits"]).all()
    assert not any(out["launches_per_request"].values())
    params = quant.quantize_tree(cnn.init_cnn(
        get_config(arch), torch.Generator().manual_seed(0), device="cpu"), sd)
    for i in range(2):
        want = _forward(arch, params,
                        torch.from_numpy(out["request_images"][i:i + 1]))
        assert torch.equal(torch.from_numpy(out["logits"][i:i + 1]), want)
