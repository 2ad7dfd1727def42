"""The port's plain flash attention and its block-sparse matmul against
the JAX reference on the CPU: ``flash_attention_torch`` against
``flash_attention_pallas`` (interpret mode, its default here) and the
XLA ``blockwise_attention`` on the reference's own test grid and
tolerances (tests/test_kernels.py), at padded and odd lengths, and at
the large dense LMs' head size 128 (a prefill and a cache chunk); and
``sparse_matmul_torch`` at SmolLM-360M's 64 x 64 FFN blocks and at the
large LMs' 128 x 128 blocks against the reference's XLA path and
Pallas kernel. The CUDA kernels themselves
are held to these plain versions on the card (tests/test_torch_cuda.py).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.base import SparsityConfig as RefSparsityConfig  # noqa: E402
from repro.core import sparsity as ref_sparsity  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.sparse_matmul import sparse_matmul_pallas  # noqa: E402
from repro.models.layers import blockwise_attention  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import sparse_matmul as sm  # noqa: E402
from repro_torch.models.layers import tensor_from_numpy as _t  # noqa: E402
from repro_torch.models.lm import params_from_numpy  # noqa: E402

# the reference's own bars for its flash kernel (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 4e-2}


def _cast(a, dtype):
    """numpy f32 -> numpy ``dtype`` with JAX's rounding."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(
        getattr(jnp, dtype)))


def _qkv(seed, b, tq, tk, h, d, dtype):
    rng = np.random.default_rng(seed)
    return [_cast(rng.normal(size=(b, t, h, d)), dtype)
            for t in (tq, tk, tk)]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("tq,tk,causal,window", [
    (128, 128, True, 0),
    (128, 128, False, 0),
    (64, 256, True, 0),     # cross-length
    (128, 128, True, 48),   # sliding window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(tq, tk, causal, window, dtype):
    q, k, v = _qkv([tq, tk, window], 2, tq, tk, 3, 32, dtype)
    offset = tk - tq if tq != tk else 0
    kw = dict(causal=causal, window=window, q_offset=offset)
    got = fa.flash_attention_torch(_t(q), _t(k), _t(v), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, flash_attention_pallas(jq, jk, jv, block_q=32, block_k=64,
                                       **kw), TOL[dtype])
    _close(got, blockwise_attention(jq, jk, jv, block_q=32, block_k=64,
                                    **kw), TOL[dtype])


@pytest.mark.parametrize("tq,tk,causal,window,q_offset", [
    (128, 128, True, 0, 0),     # a prefill
    (128, 128, False, 0, 0),
    (64, 256, True, 0, 192),    # a cache chunk: its queries at 192..255
    (128, 128, True, 48, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_d128_matches_reference(tq, tk, causal, window,
                                                q_offset, dtype):
    """Head size 128 (Mistral-Nemo-12B, Qwen3-32B, Granite-20B): the
    plain version against the Pallas kernel (interpret) and the XLA
    twin, at the reference's own bars."""
    q, k, v = _qkv([tq, tk, window, 128], 1, tq, tk, 2, 128, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention_torch(_t(q), _t(k), _t(v), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, flash_attention_pallas(jq, jk, jv, block_q=32, block_k=64,
                                       **kw), TOL[dtype])
    _close(got, blockwise_attention(jq, jk, jv, block_q=32, block_k=64,
                                    **kw), TOL[dtype])


@pytest.mark.parametrize("tq,tk,causal,window,q_offset", [
    (128, 128, True, 0, 0),     # a prefill
    (128, 128, True, 48, 0),    # zamba2's window, shorter than T
    (64, 256, True, 32, 192),   # a cache chunk, windowed
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_d112_matches_reference(tq, tk, causal, window,
                                                q_offset, dtype):
    """Head size 112 (zamba2-7b's shared attention): the plain version
    against the Pallas kernel (interpret; its blocks span the whole
    head, so it takes D 112 as it is) and the XLA twin, at the
    reference's own bars."""
    q, k, v = _qkv([tq, tk, window, 112], 1, tq, tk, 2, 112, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention_torch(_t(q), _t(k), _t(v), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, flash_attention_pallas(jq, jk, jv, block_q=32, block_k=64,
                                       **kw), TOL[dtype])
    _close(got, blockwise_attention(jq, jk, jv, block_q=32, block_k=64,
                                    **kw), TOL[dtype])


@pytest.mark.parametrize("tq,tk", [(100, 100), (37, 150), (150, 37)])
def test_flash_attention_not_causal_cross_lengths(tq, tk):
    """whisper's shapes in small: non-causal attention with Tq != Tk
    (cross-attention, 448 x 1500 at full size) and a key count that is
    no tile multiple (1500), at q_offset 0."""
    q, k, v = _qkv([tq, tk, 64], 1, tq, tk, 3, 64, "float32")
    got = fa.flash_attention_torch(_t(q), _t(k), _t(v), causal=False)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, ref_oracles.attention_ref(jq, jk, jv, causal=False),
           TOL["float32"])
    _close(got, blockwise_attention(jq, jk, jv, causal=False, block_q=32,
                                    block_k=64), TOL["float32"])


def test_flash_attention_d128_cache_chunk_odd_lengths():
    """A cache chunk whose key count is no tile multiple (the reference's
    Pallas kernel asserts tiles; its XLA twin pads): 37 queries at
    positions 63..99 over 100 keys, and windowed."""
    q, k, v = _qkv(5, 1, 37, 100, 2, 128, "float32")
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for window in (0, 30):
        kw = dict(causal=True, window=window, q_offset=63)
        got = fa.flash_attention_torch(_t(q), _t(k), _t(v), **kw)
        _close(got, ref_oracles.attention_ref(jq, jk, jv, **kw),
               TOL["float32"])
        _close(got, blockwise_attention(jq, jk, jv, block_q=32, block_k=64,
                                        **kw), TOL["float32"])


def test_flash_attention_padded_lengths():
    """Lengths that are no multiple of the tiles: the tail is masked
    (the reference's XLA path pads; its Pallas kernel asserts)."""
    q, k, v = _qkv(2, 1, 100, 100, 2, 16, "float32")
    got = fa.flash_attention_torch(_t(q), _t(k), _t(v), causal=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, blockwise_attention(jq, jk, jv, causal=True, block_q=32,
                                    block_k=32), TOL["float32"])
    _close(got, ref_oracles.attention_ref(jq, jk, jv, causal=True),
           TOL["float32"])


@pytest.mark.parametrize("case", [
    (1, 37, 101, 2, 32, True, 20, 64),
    (2, 70, 70, 3, 64, False, 0, 0),
    (1, 1, 130, 2, 64, True, 0, 129),      # one query at the end
    (1, 130, 130, 1, 16, False, 40, 0),    # window without causality
], ids=str)
def test_flash_attention_odd_lengths_windows_offsets(case):
    b, tq, tk, h, d, causal, window, q_offset = case
    q, k, v = _qkv(list(case[:5]), b, tq, tk, h, d, "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention_torch(_t(q), _t(k), _t(v), **kw)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, ref_oracles.attention_ref(jq, jk, jv, **kw), TOL["float32"])
    _close(got, blockwise_attention(jq, jk, jv, block_q=32, block_k=64,
                                    **kw), TOL["float32"])


class _Sizes(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel.append(t.numel())
        return out


def test_flash_attention_plain_never_builds_the_score_matrix():
    """One (64 x 64) score tile at a time: no tensor of the call is as
    large as the (Tq, Tk) scores."""
    q, k, v = _qkv(3, 1, 256, 256, 1, 8, "float32")
    with _Sizes() as sizes:
        fa.flash_attention_torch(_t(q), _t(k), _t(v), causal=False)
    assert max(sizes.numel) <= fa.BLOCK_Q * fa.BLOCK_K < 256 * 256


def test_kv_tile_range_skips_only_masked_tiles():
    # causal: the tiles up to the tile of the last query's position
    assert fa.kv_tile_range(0, 63, 2048, causal=True, window=0) == (0, 1)
    assert fa.kv_tile_range(192, 255, 256, causal=True, window=0) == (0, 4)
    # window 48 from position 128: keys 81.. -> tiles 1..
    assert fa.kv_tile_range(128, 191, 256, causal=True, window=48) == (1, 3)
    assert fa.kv_tile_range(0, 63, 100, causal=False, window=0) == (0, 2)


def test_cpu_tensors_take_the_plain_flash_attention():
    q, k, v = map(_t, _qkv(4, 1, 50, 50, 2, 32, "bfloat16"))
    ops.reset_launches()
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       fa.flash_attention_torch(q, k, v, causal=True))
    assert set(ops.LAUNCHES) == set(_build.SOURCES)
    assert "flash_attention" in ops.LAUNCHES
    assert not any(ops.LAUNCHES.values())


def test_flash_wrapper_refuses_cpu_tensors(monkeypatch):
    """No fallback: the kernel wrapper raises on a CPU tensor instead of
    running the plain version, before building anything."""
    built = []
    monkeypatch.setattr(_build, "load", built.append)
    fa._kernel.cache_clear()
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, q, q)
    assert built == []


def _flash_split_p(q, k, v, *, causal, window, q_offset):
    """A torch emulation of the CUDA kernel's mma variant: S from the
    bf16 q, k with f32 sums (exact products), the online softmax over
    64-key tiles in f32, and O += P V as two bf16 products, p_hi =
    bf16(p) and p_lo = bf16(p - p_hi), summed in f32. Returns the f32
    output before its final rounding to q's dtype."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    qpos = q_offset + torch.arange(tq)
    m = torch.full((b, h, tq), fa.NEG_INF)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros((b, h, tq, d))
    for k0 in range(0, tk, fa.BLOCK_K):
        kpos = torch.arange(k0, min(k0 + fa.BLOCK_K, tk))
        s = (qf @ kf[:, :, kpos].transpose(-1, -2)) / math.sqrt(d)
        mask = torch.ones((tq, kpos.numel()), dtype=torch.bool)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None] + p_hi @ vf[:, :, kpos]
               + p_lo @ vf[:, :, kpos])
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).permute(0, 2, 1, 3)


SPLIT_P_CASES = [
    (128, 128, True, 0),
    (128, 128, False, 0),
    (64, 256, True, 0),
    (128, 128, True, 48),
]


@pytest.mark.parametrize("tq,tk,causal,window", SPLIT_P_CASES)
def test_split_p_product_computes_the_plain_function(tq, tk, causal, window):
    _check_split_p(tq, tk, causal, window, 32, [tq, tk, window, 1])


@pytest.mark.parametrize("tq,tk,causal,window", SPLIT_P_CASES)
def test_split_p_product_at_d128_computes_the_plain_function(tq, tk, causal,
                                                             window):
    """The same at the large LMs' head size 128."""
    _check_split_p(tq, tk, causal, window, 128, [tq, tk, window, 1, 128])


@pytest.mark.parametrize("tq,tk,causal,window", SPLIT_P_CASES)
def test_split_p_product_at_d112_computes_the_plain_function(tq, tk, causal,
                                                             window):
    """The same at zamba2's head size 112."""
    _check_split_p(tq, tk, causal, window, 112, [tq, tk, window, 1, 112])


def _check_split_p(tq, tk, causal, window, d, seed):
    """The mma variant rounds nothing the plain version keeps: its split
    p lands within the reference's bf16 bar of the Pallas kernel and
    within 2^-16 of max |o| of the plain version's f32 output, far
    below the output's bf16 ulp (2^-8 relative), so the kernel can stay
    held to the unchanged plain version at 1 bf16 ulp."""
    q, k, v = _qkv(seed, 2, tq, tk, 3, d, "bfloat16")
    kw = dict(causal=causal, window=window,
              q_offset=tk - tq if tq != tk else 0)
    got = _flash_split_p(_t(q), _t(k), _t(v), **kw)
    plain = fa.flash_attention_torch(*(_t(a).float() for a in (q, k, v)),
                                     **kw)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 2.0 ** -16 * scale
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got.to(torch.bfloat16), flash_attention_pallas(
        jq, jk, jv, block_q=32, block_k=64, **kw), TOL["bfloat16"])


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 32, "mma"),
    (torch.float32, 64, "simt"),
    (torch.float32, 32, "simt"),
    (torch.bfloat16, 128, "mma"),     # the large dense LMs
    (torch.float32, 128, "simt"),
    (torch.bfloat16, 112, "mma"),     # zamba2's shared attention
    (torch.float32, 112, "simt"),
    (torch.bfloat16, 48, "mma"),      # padded to 48 inside the kernel
    (torch.bfloat16, 80, "mma"),      # Phi-2's heads
    (torch.bfloat16, 256, "mma"),     # Gemma-7B's, the largest mma head
    (torch.bfloat16, 300, "simt"),    # past it: the CUDA cores
    (torch.float32, 40, "simt"),
])
def test_flash_attention_variant_choice(dtype, d, want):
    assert fa.variant(dtype, d) == want


@pytest.mark.parametrize("dtype,m,bm,bn,want", [
    (torch.bfloat16, 8, 64, 64, "gemv"),     # decode rows
    (torch.bfloat16, 9, 64, 64, "mma"),
    (torch.bfloat16, 2048, 64, 64, "mma"),   # SmolLM-360M's prefill
    (torch.bfloat16, 1, 32, 25, "gemv"),
    (torch.bfloat16, 9, 32, 25, "simt"),     # bn no multiple of 8
    (torch.bfloat16, 9, 32, 24, "mma"),
    (torch.bfloat16, 9, 16, 8, "mma"),       # the smallest mma tiles
    (torch.bfloat16, 9, 8, 8, "mma"),        # 8 rows zero-filled to 16
    (torch.bfloat16, 9, 48, 64, "mma"),
    (torch.bfloat16, 9, 80, 64, "mma"),      # a ragged 16-row piece
    (torch.bfloat16, 9, 64, 72, "mma"),      # a ragged 8-column piece
    (torch.bfloat16, 2048, 128, 128, "mma"),  # the large LMs' prefill
    (torch.bfloat16, 9, 128, 64, "mma"),
    (torch.bfloat16, 9, 64, 128, "mma"),
    (torch.bfloat16, 4, 128, 128, "gemv"),    # their decode
    (torch.bfloat16, 9, 192, 64, "mma"),     # three 64-row pieces
    (torch.float32, 9, 64, 64, "simt"),      # f32 x
    (torch.float32, 1, 32, 25, "gemv"),      # the ResNet-50 classifier
    (torch.bfloat16, 16, 128, 125, "simt"),  # the classifier at the
    (torch.bfloat16, 1, 128, 125, "gemv"),   # default blocks
    (torch.bfloat16, 9, 96, 256, "mma"),
])
def test_sparse_matmul_variant_choice(dtype, m, bm, bn, want):
    assert sm.variant(dtype, m, bm, bn) == want


def test_variant_counters_reset_with_the_launch_counters():
    assert set(ops.VARIANT_LAUNCHES) == {
        ("sparse_conv", "simt"), ("sparse_conv", "mma"),
        ("sparse_matmul", "simt"), ("sparse_matmul", "mma"),
        ("sparse_matmul", "gemv"), ("dw_pw", "simt"), ("dw_pw", "mma"),
        ("flash_attention", "simt"), ("flash_attention", "mma")}
    ops.VARIANT_LAUNCHES[("sparse_matmul", "mma")] += 3
    ops.reset_launches()
    assert not any(ops.VARIANT_LAUNCHES.values())


def _bf16_tol(want):
    scale = float(np.abs(want).max())
    return 2.0 ** -7 * np.abs(want) + 2.0 ** (math.floor(math.log2(scale))
                                              - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("d_in,d_out", [(960, 2560), (2560, 960)],
                         ids=["w1", "w2"])
def test_sparse_matmul_64x64_blocks_match_reference(d_in, d_out, m, dtype):
    """SmolLM-360M's FFN weights: 64 x 64 blocks at 85% sparsity, K 2
    (w1/w3) and 6 (w2), pruned by the reference, carried across with
    the LM weight bridge."""
    rng = np.random.default_rng([d_in, m])
    w = _cast(rng.uniform(-1, 1, (d_in, d_out)) / math.sqrt(d_in),
              "bfloat16")
    rsw = ref_sparsity.to_block_balanced(
        jnp.asarray(w), RefSparsityConfig(enabled=True, sparsity=0.85,
                                          block_m=64, block_n=64))
    sw = params_from_numpy({"w": {"vals": np.asarray(rsw.vals),
                                  "idx": np.asarray(rsw.idx),
                                  "d_in": rsw.d_in}}, device="cpu")["w"]
    assert tuple(sw.vals.shape) == (d_out // 64, {960: 2, 2560: 6}[d_in],
                                    64, 64)
    x = _cast(rng.normal(size=(m, d_in)), dtype)
    got = ops.sparse_matmul(_t(x), sw)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        tol = lambda r: 1e-5 * np.abs(r) + 1e-5 * float(np.abs(r).max())  # noqa: E731
    else:
        tol = _bf16_tol
    with ref_ops.config(impl="xla"):
        want_xla = ref_ops.sparse_matmul(jnp.asarray(x), rsw)
    for want in (sparse_matmul_pallas(jnp.asarray(x), rsw.vals, rsw.idx,
                                      block_m_x=4), want_xla):
        want = np.asarray(want, np.float32)
        assert (np.abs(got.float().numpy() - want) <= tol(want)).all()
    assert torch.equal(got, sm.sparse_matmul_torch(_t(x), sw.vals, sw.idx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("d_in,d_out", [(1280, 768), (768, 1280)],
                         ids=["w1", "w2"])
def test_sparse_matmul_128x128_blocks_match_reference(d_in, d_out, m, dtype):
    """The large dense LMs' FFN blocks, 128 x 128 at 85% sparsity (the
    reference's ``SparsityConfig`` default), at narrow widths: K 2 of 10
    input blocks (w1 / w3) and 1 of 6 (w2), pruned by the reference."""
    rng = np.random.default_rng([d_in, m, 128])
    w = _cast(rng.uniform(-1, 1, (d_in, d_out)) / math.sqrt(d_in),
              "bfloat16")
    rsw = ref_sparsity.to_block_balanced(
        jnp.asarray(w), RefSparsityConfig(enabled=True))
    sw = params_from_numpy({"w": {"vals": np.asarray(rsw.vals),
                                  "idx": np.asarray(rsw.idx),
                                  "d_in": rsw.d_in}}, device="cpu")["w"]
    assert tuple(sw.vals.shape) == (d_out // 128, {1280: 2, 768: 1}[d_in],
                                    128, 128)
    x = _cast(rng.normal(size=(m, d_in)), dtype)
    got = ops.sparse_matmul(_t(x), sw)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        tol = lambda r: 1e-5 * np.abs(r) + 1e-5 * float(np.abs(r).max())  # noqa: E731
    else:
        tol = _bf16_tol
    with ref_ops.config(impl="xla"):
        want_xla = ref_ops.sparse_matmul(jnp.asarray(x), rsw)
    for want in (sparse_matmul_pallas(jnp.asarray(x), rsw.vals, rsw.idx,
                                      block_m_x=4), want_xla):
        want = np.asarray(want, np.float32)
        assert (np.abs(got.float().numpy() - want) <= tol(want)).all()
    assert torch.equal(got, sm.sparse_matmul_torch(_t(x), sw.vals, sw.idx))


def test_sparse_matmul_wrapper_refuses_blocks_the_kernel_lacks(monkeypatch):
    """The wrapper refuses only blocks the Pallas kernel refuses too (bm
    must divide d_in); sides past 64 that are no multiple of 64, and
    past 128, now reach the launch in the variant ``variant()`` names
    (no card needed: the library and the stream are stubbed)."""
    from repro_torch.kernels import _build
    launched = []

    def fake(*args):
        launched.append(args[4:10])       # M, d_in, ob, K, bm, bn
        return 0

    monkeypatch.setattr(sm, "_kernel", lambda: (None, {
        torch.bfloat16: fake, torch.float32: fake}))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(_build, "VARIANT_LAUNCHES",
                        dict(_build.VARIANT_LAUNCHES))
    for m, bm, bn in ((9, 96, 64), (9, 64, 192), (4, 192, 64),
                      (16, 128, 125)):
        x = torch.zeros((m, 4 * bm), dtype=torch.bfloat16)
        vals = torch.zeros((2, 1, bm, bn), dtype=torch.bfloat16)
        idx = torch.zeros((2, 1), dtype=torch.int32)
        v = sm.variant(x.dtype, m, bm, bn)
        before = _build.VARIANT_LAUNCHES[("sparse_matmul", v)]
        assert sm.sparse_matmul(x, vals, idx).shape == (m, 2 * bn)
        assert launched[-1] == (m, 4 * bm, 2, 1, bm, bn)
        assert _build.VARIANT_LAUNCHES[("sparse_matmul", v)] == before + 1
    x = torch.zeros((9, 100), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not fit"):
        sm.sparse_matmul(x, torch.zeros((2, 1, 64, 64), dtype=torch.bfloat16),
                         torch.zeros((2, 1), dtype=torch.int32))
