"""The port's depthwise and fused dw->pw plain versions vs the JAX
reference's Pallas kernels (interpret mode, their default here) and XLA
twin, at small sizes; the dispatch of both ops by the tensor's device;
and the CUDA wrappers' refusal of anything that is not on a card."""
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.depthwise_conv import depthwise_conv_pallas  # noqa: E402
from repro.kernels.depthwise_conv import depthwise_conv_ref  # noqa: E402
from repro.kernels.dw_pw_fused import dw_pw_pallas, dw_pw_xla  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw  # noqa: E402
from repro_torch.kernels import dw_pw_fused as dwpw  # noqa: E402
from repro_torch.models.cnn import tensor_from_numpy as _t  # noqa: E402


def _cast(a, dtype):
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


# (N, H, C, Cout, stride, residual, dw_relu, relu, dtype): stride 1 and
# 2, even and odd H, residual on and off, each ReLU on and off, widths
# that are not multiples of 32, bf16 and f32 inputs
_DW_PW_CASES = [
    (1, 7, 24, 24, 1, True, True, False, "bfloat16"),
    (1, 8, 48, 24, 2, False, True, True, "bfloat16"),
    (2, 9, 24, 40, 2, False, False, True, "bfloat16"),
    (1, 6, 48, 24, 1, True, True, True, "bfloat16"),
    (1, 9, 32, 16, 1, False, False, False, "bfloat16"),
    (1, 9, 24, 24, 1, True, False, False, "float32"),
    (2, 8, 48, 24, 2, False, True, True, "float32"),
]


@pytest.mark.parametrize("case", _DW_PW_CASES,
                         ids=lambda c: "n{}h{}c{}co{}s{}r{}dr{}r{}{}".format(
                             *c[:5], *map(int, c[5:8]), c[8][:2]))
def test_dw_pw_matches_reference(case):
    n, h, c, co, stride, residual, dw_relu, relu, dtype = case
    rng = np.random.default_rng([n, h, c, co, stride])
    x = _cast(rng.normal(size=(n, h, h, c)), dtype)
    dw_w = _cast(rng.uniform(-1, 1, (3, 3, c)) / 3, dtype)
    dw_b = _cast(rng.normal(size=(c,)) * 0.1, dtype)
    pw_w = _cast(rng.uniform(-1, 1, (c, co)) / math.sqrt(c), dtype)
    pw_b = _cast(rng.normal(size=(co,)) * 0.1, dtype)
    ho = -(-h // stride)
    res = _cast(rng.normal(size=(n, ho, ho, co)), dtype) if residual else None
    kw = dict(stride=stride, dw_relu=dw_relu, relu=relu)
    got = dwpw.dw_pw_torch(_t(x), _t(dw_w), _t(dw_b), _t(pw_w), _t(pw_b),
                           None if res is None else _t(res), **kw)
    assert got.dtype == getattr(torch, dtype)
    j = [jnp.asarray(a) for a in (x, dw_w, dw_b, pw_w, pw_b)]
    jres = None if res is None else jnp.asarray(res)
    tol = bf16_tol if dtype == "bfloat16" else f32_tol
    _close(got, dw_pw_pallas(*j, jres, **kw), tol)
    _close(got, dw_pw_xla(*j, jres, **kw), tol)


def test_dw_pw_plain_never_holds_the_full_depthwise(monkeypatch):
    """The plain version runs the depthwise one chunk of 10 output rows
    at a time (the (N, Ho, Wo, C) depthwise tensor never exists), and
    the chunks join into the reference's result (1 bf16 ulp)."""
    seen = []
    real = dwpw.depthwise_acc

    def spy(xp, w, *, stride, ho, wo):
        seen.append(ho)
        return real(xp, w, stride=stride, ho=ho, wo=wo)

    monkeypatch.setattr(dwpw, "depthwise_acc", spy)
    rng = np.random.default_rng(40)
    a = [_cast(rng.normal(size=s) * f, "bfloat16") for s, f in
         (((1, 40, 40, 8), 1), ((3, 3, 8), 1 / 3), ((8,), 0.1),
          ((8, 16), 8 ** -0.5), ((16,), 0.1), ((1, 40, 40, 16), 1))]
    y = dwpw.dw_pw_torch(*map(_t, a), relu=False)
    assert seen == [10] * 4
    _close(y, dw_pw_xla(*map(jnp.asarray, a), relu=False), bf16_tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,c,stride", [(7, 24, 1), (8, 48, 2), (9, 32, 2),
                                        (6, 40, 1)])
def test_depthwise_conv_matches_reference(h, c, stride, dtype):
    rng = np.random.default_rng([h, c, stride])
    x = _cast(rng.normal(size=(2, h, h, c)), dtype)
    w = _cast(rng.uniform(-1, 1, (3, 3, c)) / 3, dtype)
    got = dw.depthwise_conv_torch(_t(x), _t(w), stride=stride)
    assert got.dtype == getattr(torch, dtype)
    tol = bf16_tol if dtype == "bfloat16" else f32_tol
    _close(got, depthwise_conv_pallas(jnp.asarray(x), jnp.asarray(w),
                                      stride=stride), tol)
    if dtype == "float32":
        # the XLA oracle is a grouped lax.conv; in bf16 it sums in bf16
        # (the reference's own test allows 5e-2 there), in f32 it is an
        # f32 oracle
        _close(got, depthwise_conv_ref(jnp.asarray(x), jnp.asarray(w),
                                       stride=stride), tol)


def test_cpu_tensors_take_the_plain_versions():
    """The dispatch picks the plain version from the tensor's device and
    launches (counts) nothing."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 9, 9, 24), generator=g).to(torch.bfloat16)
    dw_w = torch.randn((3, 3, 24), generator=g).to(torch.bfloat16)
    dw_b = torch.randn((24,), generator=g).to(torch.bfloat16)
    pw_w = torch.randn((24, 16), generator=g).to(torch.bfloat16)
    pw_b = torch.randn((16,), generator=g).to(torch.bfloat16)
    ops.reset_launches()
    assert torch.equal(ops.depthwise_conv(x, dw_w, stride=2),
                       dw.depthwise_conv_torch(x, dw_w, stride=2))
    assert torch.equal(
        ops.dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b, stride=2, relu=False),
        dwpw.dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b, stride=2, relu=False))
    assert set(ops.LAUNCHES) == set(_build.SOURCES)
    assert not any(ops.LAUNCHES.values())


def test_cuda_wrappers_refuse_cpu_tensors(monkeypatch):
    """No fallback: the kernel wrappers raise on a CPU tensor instead of
    running the plain version, before building anything, int8 codes
    with their pointwise scale included; the plain version takes them."""
    built = []
    monkeypatch.setattr(_build, "load", built.append)
    dw._kernel.cache_clear()
    dwpw._kernel.cache_clear()
    x = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    dw_w = torch.zeros(3, 3, 32, dtype=torch.bfloat16)
    dw_b = torch.zeros(32, dtype=torch.bfloat16)
    pw_w = torch.zeros(32, 16, dtype=torch.bfloat16)
    pw_b = torch.zeros(16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dw.depthwise_conv(x, dw_w)
    with pytest.raises(ValueError):
        dwpw.dw_pw(x, dw_w, dw_b, pw_w, pw_b)
    codes = torch.ones(32, 16, dtype=torch.int8)
    with pytest.raises(ValueError):
        dwpw.dw_pw(x, dw_w, dw_b, codes, pw_b, pw_scale=torch.ones(16))
    assert dwpw.dw_pw_torch(x, dw_w, dw_b, codes, pw_b,
                            pw_scale=torch.ones(16)).shape == (1, 4, 4, 16)
    assert built == []
