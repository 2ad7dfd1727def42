"""Shared by ``tests/test_torch_quant.py`` and
``tests/test_torch_quant_forward.py``: the reference's weights at full
width (native and int8) carried across to the port, the forwards of
both packages at 32 px, and the bars."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402

IMAGE = 32
ARCHS = ["resnet50", "mobilenet_v1", "mobilenet_v2"]
# The native parity bar of tests/test_torch_cnn.py and
# tests/test_torch_mobilenet.py: max |diff| <= 1e-3 of max |ref logit|,
# top-1 equal (both frameworks do the same f32 sums and bf16 rounds, in
# other orders; random-init logits are tiny, so the bar is relative).
LOGIT_RTOL = 1e-3
# The reference's own int8 bars (tests/test_quant.py:156-190): int8 vs
# the unquantized forward, and the fast path vs dequantize-at-entry.
ORACLE_RTOL = 0.05
FAST_RTOL = 0.02


def _numpy_tree(params):
    """The reference's params as numpy, in ``params_from_numpy``'s
    format (quantized leaves included)."""
    tree = {}
    for name, p in params.items():
        w = p["w"]
        if isinstance(w, RefSparseWeight):
            d = {"vals": np.asarray(w.vals), "idx": np.asarray(w.idx),
                 "d_in": w.d_in}
            if w.scale is not None:
                d.update(scale=np.asarray(w.scale), orig_dtype=w.orig_dtype)
            w = d
        elif isinstance(w, ref_quant.QuantizedWeight):
            w = {"codes": np.asarray(w.codes), "scale": np.asarray(w.scale),
                 "orig_dtype": w.orig_dtype}
        else:
            w = np.asarray(w)
        tree[name] = {"w": w, "b": np.asarray(p["b"])}
    return tree


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(reference native params, reference int8 params, port native
    params on the CPU)."""
    ref = jax.jit(lambda k: ref_cnn.init_cnn(ref_get_config(arch), k))(
        jax.random.PRNGKey(0))
    return (ref, ref_quant.quantize_tree(ref, "int8"),
            cnn.params_from_numpy(_numpy_tree(ref), device="cpu"))


def _images(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, IMAGE, IMAGE, 3)).astype(np.float32)


def _forward(arch, params, x):
    with torch.inference_mode():
        return cnn.cnn_forward(get_config(arch), params, x, device="cpu")


def _reference(arch, params, x, impl):
    cfg = ref_get_config(arch)
    with ref_ops.config(impl=impl):
        if impl == "pallas":            # interpret mode: eager, as its tests
            return np.asarray(ref_cnn.cnn_forward(cfg, params, x))
        return np.asarray(jax.jit(lambda p, im: ref_cnn.cnn_forward(
            cfg, p, im))(params, x))


def _assert_close(got, ref, rtol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= rtol * scale, \
        (np.abs(got - ref).max(), scale)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def _assert_same_leaf(got, want):
    assert type(got) is type(want)
    if isinstance(got, quant.QuantizedWeight):
        assert got.orig_dtype == want.orig_dtype
        pairs = [(got.codes, want.codes), (got.scale, want.scale)]
    elif isinstance(got, SparseWeight):
        assert got.d_in == want.d_in and got.orig_dtype == want.orig_dtype
        assert (got.scale is None) == (want.scale is None)
        pairs = [(got.vals, want.vals), (got.idx, want.idx)]
        if got.scale is not None:
            pairs.append((got.scale, want.scale))
    else:
        pairs = [(got, want)]
    for a, b in pairs:
        assert _same_bits(a, b), (a.dtype, b.dtype, a.shape, b.shape)
