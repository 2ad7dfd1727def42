"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; skips without them (whether there is a
card is decided inside the fixture, never at import). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX here: the machine with the card has none. The plain versions are
held to the JAX reference by tests/test_torch_kernels.py on the CPU.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SparsityConfig, get_config, reduced  # noqa: E402
from repro_torch.core.fusion import fused_graph_for  # noqa: E402
from repro_torch.core.graph import graph_for  # noqa: E402
from repro_torch.core.sparsity import to_block_balanced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw  # noqa: E402
from repro_torch.kernels import dw_pw_fused as dwpw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparse_conv as sc  # noqa: E402
from repro_torch.kernels import sparse_matmul as sm  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import cnn, lm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _bf16_close(got, want):
    """At most 1 bf16 ulp (f32 sums in another order, rounded once)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    atol = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + atol).all()


def _assert_launches(want):
    """Every launch counter by name: the kernels ``want`` names launched
    exactly that often, every other kernel not at all."""
    assert set(want) <= set(ops.LAUNCHES)
    assert ops.LAUNCHES == {k: want.get(k, 0) for k in ops.LAUNCHES}


def _assert_variant(name, variant, n=1):
    """``n`` launches of ``name`` since the last reset, all of
    ``variant``."""
    for v in _build.VARIANTS[name]:
        assert ops.VARIANT_LAUNCHES[(name, v)] == (n if v == variant else 0)


def _weight(gen, d_in, d_out, bm, bn, sp, dev):
    w = (torch.rand((d_in, d_out), generator=gen) * 2 - 1) / math.sqrt(d_in)
    return to_block_balanced(w.to(torch.bfloat16),
                             SparsityConfig(True, sp, bm, bn)).to(dev)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2), (7, 2)])
@pytest.mark.parametrize("case", [(1, 9, 64, 64, 32, 32),
                                  (2, 7, 32, 48, 16, 16),
                                  (1, 65, 32, 32, 32, 32)],
                         ids=["n1h9b32", "n2h7b16", "n1h65m2tiles"])
def test_sparse_conv_kernel_matches_plain(dev, case, k, stride, residual,
                                          relu):
    n, h, cin, cout, bm, bn = case
    gen = torch.Generator().manual_seed(k * 10 + stride)
    sw = _weight(gen, k * k * cin, cout, bm, bn, 0.5, dev)
    x = torch.randn((n, h, h, cin), generator=gen).to(dev, torch.bfloat16)
    b = (torch.randn((cout,), generator=gen) * 0.1).to(dev, torch.bfloat16)
    ho = -(-h // stride)
    r = (torch.randn((n, ho, ho, cout), generator=gen)
         .to(dev, torch.bfloat16) if residual else None)
    ops.reset_launches()
    got = sc.sparse_conv(x, sw.vals, sw.idx, b, r, k=k, stride=stride,
                         relu=relu)
    _assert_variant("sparse_conv", sc.variant(bm, bn))
    want = sc.sparse_conv_torch(x, sw.vals, sw.idx, b, r, k=k,
                                stride=stride, relu=relu)
    torch.cuda.synchronize()
    _bf16_close(got, want)


# (N, H, cin, cout, bm, bn, k, stride, sparsity): the mma variant where
# K is no multiple of the split, K = 1, batch 2, M no tile multiple, and
# bn < 32; the simt variant at a block shape mma does not take (bm 8)
CONV_SPLIT_CASES = [
    (1, 7, 512, 512, 32, 32, 3, 1, 0.85),    # s3b*_c2: K 22, split 8
    (1, 7, 2048, 512, 32, 32, 1, 1, 0.85),   # s3b*_c1: K 10, split 4
    (1, 14, 256, 256, 32, 32, 3, 1, 0.85),   # s2b*_c2: K 11, split 4
    (1, 7, 96, 64, 32, 32, 3, 1, 0.5),       # K 14 over 2 columns
    (2, 7, 128, 64, 32, 32, 3, 1, 0.7),      # batch 2, M 98
    (1, 11, 64, 96, 32, 32, 1, 1, 0.5),      # K 1, M 121
    (1, 9, 64, 48, 16, 16, 3, 2, 0.6),       # 16 x 16 blocks, M 25
    (1, 10, 64, 48, 32, 24, 3, 1, 0.6),      # three 8-column tiles
    (1, 9, 32, 32, 8, 8, 3, 1, 0.5),         # simt: bm 8
    (2, 13, 16, 24, 8, 8, 1, 2, 0.5),        # simt: bm 8, batch 2
]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("case", CONV_SPLIT_CASES, ids=str)
def test_sparse_conv_variants_and_splits_match_plain(dev, case, residual):
    n, h, cin, cout, bm, bn, k, stride, sp = case
    gen = torch.Generator().manual_seed(cin + cout + h)
    sw = _weight(gen, k * k * cin, cout, bm, bn, sp, dev)
    x = torch.randn((n, h, h, cin), generator=gen).to(dev, torch.bfloat16)
    b = (torch.randn((cout,), generator=gen) * 0.1).to(dev, torch.bfloat16)
    ho = -(-h // stride)
    r = (torch.randn((n, ho, ho, cout), generator=gen)
         .to(dev, torch.bfloat16) if residual else None)
    v = sc.variant(bm, bn)
    assert v == ("simt" if bm == 8 else "mma")
    n_k = sw.vals.shape[1]
    if v == "mma" and n_k > sc.STEPS_PER_SLICE:
        assert sc.plan(n * ho * ho, cout // bn, n_k)[1] > 1
    ops.reset_launches()
    got = sc.sparse_conv(x, sw.vals, sw.idx, b, r, k=k, stride=stride,
                         relu=not residual)
    _assert_variant("sparse_conv", v)
    want = sc.sparse_conv_torch(x, sw.vals, sw.idx, b, r, k=k,
                                stride=stride, relu=not residual)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("d_in,d_out,bm,bn,sp", [
    (2048, 1000, 32, 25, 0.85),       # the ResNet-50 classifier
    (960, 2560, 64, 64, 0.85),        # SmolLM-360M's w1 / w3
    (2560, 960, 64, 64, 0.85),        # and w2
    (80, 75, 16, 25, 0.5),            # rows no multiple of 8 a column
], ids=["fc", "w1", "w2", "odd"])
def test_sparse_matmul_gemv_matches_plain(dev, d_in, d_out, bm, bn, sp, m,
                                          dtype):
    gen = torch.Generator().manual_seed(d_in + d_out + m)
    sw = _weight(gen, d_in, d_out, bm, bn, sp, dev)
    x = torch.randn((m, d_in), generator=gen).to(dev, dtype)
    assert sm.variant(dtype, m, bm, bn) == "gemv"
    ops.reset_launches()
    got = sm.sparse_matmul(x, sw.vals, sw.idx)
    _assert_variant("sparse_matmul", "gemv")
    want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("d_out,bn", [(128, 32), (100, 25)])
def test_sparse_matmul_kernel_matches_plain(dev, d_out, bn, m, dtype):
    gen = torch.Generator().manual_seed(m)
    sw = _weight(gen, 256, d_out, 32, bn, 0.75, dev)
    x = torch.randn((m, 256), generator=gen).to(dev, dtype)
    got = sm.sparse_matmul(x, sw.vals, sw.idx)
    want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want)


def test_forward_on_card_matches_cpu_and_uses_the_kernels(dev):
    cfg = get_config("resnet50")
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
    cpu = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    got = cnn.cnn_forward(cfg, params, x, device=dev).cpu()
    _assert_launches({"sparse_conv": 47, "sparse_matmul": 1, "dw_pw": 0,
                      "depthwise_conv": 0})
    _assert_variant("sparse_conv", "mma", 47)
    _assert_variant("sparse_matmul", "gemv", 1)     # batch 2: M = 2
    want = cnn.cnn_forward(cfg, cpu, x, device="cpu")
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale
    assert torch.equal(got.argmax(-1), want.argmax(-1))


MOBILENETS = ("mobilenet_v1", "mobilenet_v2")
# every distinct (C, Cout, H, stride, residual, relu) of the fused
# MobileNet blocks at 224 px, and every distinct (C, H, stride) of the
# unfused views' depthwise nodes; plus batch 2 at odd sizes
DW_PW_SHAPES = sorted({(n.cin, n.cout, n.in_hw, n.stride,
                        bool(n.residual_from), n.relu)
                       for a in MOBILENETS for n in fused_graph_for(a).nodes
                       if n.kind == "dw_pw"})
DW_SHAPES = sorted({(n.cin, n.in_hw, n.stride)
                    for a in MOBILENETS for n in graph_for(a).nodes
                    if n.kind == "dw"})


def _dw_pw_inputs(gen, n, c, co, h, stride, residual, dev, k=3):
    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            dev, torch.bfloat16)
    ho = -(-h // stride)
    return (rnd((n, h, h, c)), rnd((k, k, c), 1 / k), rnd((c,), 0.1),
            rnd((c, co), c ** -0.5), rnd((co,), 0.1),
            rnd((n, ho, ho, co)) if residual else None)


def _check_dw_pw(dev, shape, k=3):
    """Both ReLU settings of the depthwise at one shape, each launch in
    the variant ``variant()`` names, within 1 bf16 ulp of the plain
    version."""
    c, co, h, stride, residual, relu = shape
    n = 1 if h > 9 else 2
    gen = torch.Generator().manual_seed(c + co + h + k)
    x, dw_w, dw_b, pw_w, pw_b, r = _dw_pw_inputs(gen, n, c, co, h, stride,
                                                 residual, dev, k)
    v = dwpw.variant(c, co, k, stride)
    for dw_relu in (True, False):
        kw = dict(stride=stride, dw_relu=dw_relu, relu=relu)
        ops.reset_launches()
        got = dwpw.dw_pw(x, dw_w, dw_b, pw_w, pw_b, r, **kw)
        _assert_variant("dw_pw", v)
        want = dwpw.dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b, r, **kw)
        torch.cuda.synchronize()
        _bf16_close(got, want)
    return v


@pytest.mark.parametrize("shape", DW_PW_SHAPES + [(24, 40, 9, 2, False, True),
                                                  (48, 24, 7, 1, True, False)],
                         ids=str)
def test_dw_pw_kernel_matches_plain(dev, shape):
    """Every MobileNet block shape (and two at batch 2) takes mma."""
    assert _check_dw_pw(dev, shape) == "mma"


# (k, C, Cout, H, stride, residual, relu): k 1 to 7 through the mma
# variant, at one and two image rows a tile, stride 1 and 2, C over a
# cluster; C or Cout not a multiple of 8 takes simt, at k 3 and 5
DW_PW_K_CASES = [
    (5, 96, 64, 14, 1, True, False), (5, 576, 160, 7, 2, False, True),
    (7, 128, 128, 28, 1, False, True), (7, 384, 64, 14, 2, True, False),
    (1, 64, 32, 12, 1, False, True), (1, 512, 96, 7, 2, True, True),
    (2, 32, 48, 10, 1, False, True), (4, 64, 24, 9, 2, True, False),
    (6, 256, 40, 11, 1, False, True),
    (3, 36, 24, 9, 1, True, True), (5, 44, 20, 8, 2, False, True),
    (3, 64, 20, 7, 1, True, False),
]


@pytest.mark.parametrize("case", DW_PW_K_CASES, ids=str)
def test_dw_pw_kernel_sizes_and_simt_match_plain(dev, case):
    k, *shape = case
    c, co = shape[0], shape[1]
    want = "mma" if c % 8 == 0 and co % 8 == 0 else "simt"
    assert _check_dw_pw(dev, tuple(shape), k) == want


@pytest.mark.parametrize("shape", DW_SHAPES + [(24, 9, 2), (40, 8, 1)],
                         ids=str)
def test_depthwise_conv_kernel_matches_plain(dev, shape):
    c, h, stride = shape
    n = 1 if h > 9 else 2
    gen = torch.Generator().manual_seed(c + h + stride)
    x = torch.randn((n, h, h, c), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((3, 3, c), generator=gen) / 3).to(dev, torch.bfloat16)
    got = dw.depthwise_conv(x, w, stride=stride)
    want = dw.depthwise_conv_torch(x, w, stride=stride)
    torch.cuda.synchronize()
    _bf16_close(got, want)


# (k, C, H, stride, N): odd C and C not a multiple of 8 (the masked
# tail), k 1 to 7, stride 1, 2 and 3 (one pixel a thread)
DW_K_CASES = [
    (3, 3, 9, 1, 2), (3, 37, 14, 2, 1), (3, 1001, 7, 1, 1),
    (5, 96, 14, 1, 1), (5, 33, 12, 2, 2), (7, 64, 13, 1, 1),
    (7, 20, 15, 2, 1), (1, 24, 9, 1, 2), (2, 16, 8, 2, 1),
    (4, 8, 10, 1, 1), (6, 40, 9, 1, 1), (3, 32, 13, 3, 1),
]


@pytest.mark.parametrize("case", DW_K_CASES, ids=str)
def test_depthwise_conv_odd_c_and_kernel_sizes_match_plain(dev, case):
    k, c, h, stride, n = case
    gen = torch.Generator().manual_seed(k * 100 + c + h)
    x = torch.randn((n, h, h, c), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((k, k, c), generator=gen) / k).to(dev, torch.bfloat16)
    ops.reset_launches()
    got = dw.depthwise_conv(x, w, stride=stride)
    _assert_launches({"depthwise_conv": 1})
    want = dw.depthwise_conv_torch(x, w, stride=stride)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize("name", MOBILENETS)
def test_mobilenet_on_card_matches_cpu_and_uses_the_kernels(dev, name):
    """Fused graph: one dw_pw launch per block; unfused view: one
    depthwise_conv launch per dw node; nothing else launches."""
    cfg = get_config(name)
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
    cpu = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    blocks = {"mobilenet_v1": 13, "mobilenet_v2": 17}[name]
    for graph, key in ((None, "dw_pw"), (graph_for(name), "depthwise_conv")):
        ops.reset_launches()
        got = cnn.cnn_forward(cfg, params, x, graph=graph, device=dev).cpu()
        want_launches = {"sparse_conv": 0, "sparse_matmul": 0, "dw_pw": 0,
                         "depthwise_conv": 0}
        want_launches[key] = blocks
        _assert_launches(want_launches)
        if key == "dw_pw":                    # every block on the mma
            _assert_variant("dw_pw", "mma", blocks)
        want = cnn.cnn_forward(cfg, cpu, x, graph=graph, device="cpu")
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-3 * scale
        assert torch.equal(got.argmax(-1), want.argmax(-1))


# (B, Tq, Tk, H, D, causal, window, q_offset): the reference's test grid
# (tests/test_kernels.py), its padded case, SmolLM-360M's prefill shape
# and lengths that are not tile multiples, both head sizes the kernel
# takes
FLASH_CASES = [
    (2, 128, 128, 3, 32, True, 0, 0),
    (2, 128, 128, 3, 32, False, 0, 0),
    (2, 64, 256, 3, 32, True, 0, 192),
    (2, 128, 128, 3, 32, True, 48, 0),
    (1, 100, 100, 2, 32, True, 0, 0),
    (1, 2048, 2048, 15, 64, True, 0, 0),
    (1, 1000, 1000, 15, 64, True, 0, 0),
    (2, 77, 77, 4, 64, False, 0, 0),
    (1, 65, 300, 2, 64, True, 100, 235),
    (1, 200, 200, 2, 64, True, 0, 0),
    (3, 1, 129, 2, 64, True, 0, 128),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(dev, case, dtype):
    b, tq, tk, h, d, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(tq + tk + d)
    q, k, v = (torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
               for t in (tq, tk, tk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want)


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 8, 2, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="all bf16"):
        fa.flash_attention(q, q, q.float())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 9, 2048])
@pytest.mark.parametrize("d_in,d_out", [(960, 2560), (2560, 960)],
                         ids=["w1", "w2"])
def test_sparse_matmul_kernel_64x64_blocks(dev, d_in, d_out, m, dtype):
    """SmolLM-360M's FFN blocks: 64 x 64, K 2 (w1/w3) and 6 (w2), at the
    decode (M = B) and prefill (M = B*T) row counts."""
    gen = torch.Generator().manual_seed(d_in + m)
    sw = _weight(gen, d_in, d_out, 64, 64, 0.85, dev)
    assert sw.vals.shape[1] == {960: 2, 2560: 6}[d_in]
    x = torch.randn((m, d_in), generator=gen).to(dev, dtype)
    got = sm.sparse_matmul(x, sw.vals, sw.idx)
    want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want)


# bf16 through the tensor-core variant: lengths 1, under a tile, a tile,
# a tile + 1, two tiles - 1, long and odd, SmolLM-360M's 2048; both head
# sizes; causal or not; B*H > 1 (B 1, H 15 at 2048)
FLASH_MMA_CASES = [
    (1, t, t, 15, d, causal, 0, 0) if t == 2048 else
    (2, t, t, 3, d, causal, 0, 0)
    for t in (1, 17, 64, 65, 127, 1000, 2048) for d in (32, 64)
    for causal in (True, False)
] + [
    (2, 127, 127, 3, 32, True, 48, 0),       # sliding window
    (2, 1000, 1000, 2, 64, False, 200, 0),   # window without causality
    (1, 65, 300, 2, 64, True, 100, 235),     # window and q_offset
    (3, 17, 1000, 2, 64, True, 0, 983),      # q_offset: the last 17 rows
]


@pytest.mark.parametrize("case", FLASH_MMA_CASES, ids=str)
def test_flash_attention_mma_variant_matches_plain(dev, case):
    b, tq, tk, h, d, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(tq * 7 + tk + d + window)
    q, k, v = (torch.randn((b, t, h, d), generator=gen).to(dev,
                                                           torch.bfloat16)
               for t in (tq, tk, tk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert fa.variant(q.dtype, d) == "mma"
    ops.reset_launches()
    got = fa.flash_attention(q, k, v, **kw)
    _assert_variant("flash_attention", "mma")
    want = fa.flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _bf16_close(got, want)


def test_flash_attention_f32_takes_the_simt_variant(dev):
    q = torch.randn((1, 65, 2, 64), device=dev)
    ops.reset_launches()
    got = fa.flash_attention(q, q, q)
    _assert_variant("flash_attention", "simt")
    torch.testing.assert_close(got, fa.flash_attention_torch(q, q, q),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [9, 16, 100, 129, 2048])
@pytest.mark.parametrize("d_in,d_out,bm,bn,sp", [
    (256, 128, 32, 32, 0.75),
    (960, 2560, 64, 64, 0.85),        # SmolLM-360M's w1 / w3
    (2560, 960, 64, 64, 0.85),        # and w2
    (256, 96, 16, 24, 0.5),           # an odd number of 8-column tiles
], ids=["32x32", "w1_64x64", "w2_64x64", "16x24"])
def test_sparse_matmul_mma_variant_matches_plain(dev, d_in, d_out, bm, bn,
                                                 sp, m):
    gen = torch.Generator().manual_seed(d_in + d_out + m)
    sw = _weight(gen, d_in, d_out, bm, bn, sp, dev)
    x = torch.randn((m, d_in), generator=gen).to(dev, torch.bfloat16)
    assert sm.variant(x.dtype, m, bm, bn) == "mma"
    ops.reset_launches()
    got = sm.sparse_matmul(x, sw.vals, sw.idx)
    _assert_variant("sparse_matmul", "mma")
    want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


@pytest.mark.parametrize("m,bn,dtype,variant", [
    (8, 32, torch.bfloat16, "gemv"),    # decode rows
    (9, 32, torch.bfloat16, "mma"),
    (17, 25, torch.bfloat16, "simt"),   # bn no multiple of 8
    (17, 32, torch.float32, "simt"),
])
def test_sparse_matmul_launches_the_variant_it_names(dev, m, bn, dtype,
                                                     variant):
    gen = torch.Generator().manual_seed(m + bn)
    sw = _weight(gen, 256, 4 * bn, 32, bn, 0.75, dev)
    x = torch.randn((m, 256), generator=gen).to(dev, dtype)
    assert sm.variant(dtype, m, 32, bn) == variant
    ops.reset_launches()
    got = sm.sparse_matmul(x, sw.vals, sw.idx)
    _assert_variant("sparse_matmul", variant)
    want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want)


def test_mma_variants_take_unaligned_tensors(dev):
    """A contiguous tensor whose data does not start on 16 bytes is
    copied before the mma variant reads it in 16-byte vectors."""
    gen = torch.Generator().manual_seed(5)
    sw = _weight(gen, 256, 128, 32, 32, 0.75, dev)
    x = torch.randn((33 * 256 + 1,), generator=gen).to(dev, torch.bfloat16)
    x = x[1:].view(33, 256)
    assert x.data_ptr() % 16
    _bf16_close(sm.sparse_matmul(x, sw.vals, sw.idx),
                sm.sparse_matmul_torch(x, sw.vals, sw.idx))
    qkv = torch.randn((3 * 40 * 2 * 32 + 1,), generator=gen).to(
        dev, torch.bfloat16)[1:].view(3, 1, 40, 2, 32)
    q, k, v = qkv.unbind(0)
    assert q.is_contiguous() and q.data_ptr() % 16
    _bf16_close(fa.flash_attention(q, k, v), fa.flash_attention_torch(q, k, v))


def test_lm_on_card_matches_cpu_and_uses_the_kernels(dev):
    """reduced(smollm-360m): a prefill launches one flash_attention and
    three sparse_matmul per layer, a decode step three sparse_matmul per
    layer; the card's logits are within 1e-2 of max |logit| of the
    CPU's on the same weights."""
    cfg = reduced(get_config("smollm-360m"))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cpu = lm.params_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    got = make_prefill_step(cfg)(params, toks.to(dev)).cpu()
    n = cfg.n_layers
    _assert_launches({"flash_attention": n, "sparse_matmul": 3 * n})
    _assert_variant("flash_attention", "mma", n)      # bf16
    _assert_variant("sparse_matmul", "mma", 3 * n)    # M = 80, 16x16 blocks
    want = make_prefill_step(cfg)(cpu, toks)
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())
    cache = lm.init_cache(cfg, 2, 8, device=dev)
    ops.reset_launches()
    lg, _ = lm.decode_step(cfg, params, cache, toks[:, :1].to(dev), 0)
    _assert_launches({"sparse_matmul": 3 * n})
    _assert_variant("sparse_matmul", "gemv", 3 * n)   # M = 2
    assert lg.shape == (2, 1, cfg.vocab_size) and torch.isfinite(lg).all()


# ---- stored weights: int8 codes with their scales, and f32 ----------------

def _int8(sw):
    """An int8 SparseWeight (codes and (ob, bn) scales) from a float one."""
    from repro_torch.core.quant import quantize_tree
    return quantize_tree({"l": {"w": sw.to("cpu")}}, "int8")["l"]["w"].to(
        sw.vals.device)


# (n, H, C, Cout, bm, bn, k, stride, sparsity): ResNet-50 shapes through
# mma (one without split, some over a cluster), and blocks only simt takes
CONV_STORE_CASES = [
    (1, 56, 64, 64, 32, 32, 3, 1, 0.85), (1, 7, 512, 512, 32, 32, 3, 1, 0.85),
    (1, 56, 256, 128, 32, 32, 1, 2, 0.85), (1, 7, 2048, 512, 32, 32, 1, 1,
                                            0.85),
    (1, 9, 32, 32, 8, 8, 3, 1, 0.5),
]


@pytest.mark.parametrize("store", ["int8", "f32"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("case", CONV_STORE_CASES, ids=str)
def test_sparse_conv_stored_weights_match_plain(dev, case, residual, store):
    """int8 codes take mma where the blocks allow (simt otherwise), their
    scale in the epilogue; f32 weights take simt with an f32 bias."""
    n, h, cin, cout, bm, bn, k, stride, sp = case
    gen = torch.Generator().manual_seed(cin + cout + h + k)
    sw = _weight(gen, k * k * cin, cout, bm, bn, sp, dev)
    x = torch.randn((n, h, h, cin), generator=gen).to(dev, torch.bfloat16)
    b = (torch.randn((cout,), generator=gen) * 0.1).to(dev, torch.bfloat16)
    ho = -(-h // stride)
    r = (torch.randn((n, ho, ho, cout), generator=gen)
         .to(dev, torch.bfloat16) if residual else None)
    if store == "int8":
        sw = _int8(sw)
        want_v = "simt" if bm == 8 else "mma"
    else:
        sw = type(sw)(sw.vals.float(), sw.idx, sw.d_in)
        b = b.float()
        want_v = "simt"
    assert sc.variant(bm, bn, sw.vals.dtype) == want_v
    ops.reset_launches()
    got = sc.sparse_conv(x, sw.vals, sw.idx, b, r, sw.scale, k=k,
                         stride=stride, relu=not residual)
    _assert_variant("sparse_conv", want_v)
    want = sc.sparse_conv_torch(x, sw.vals, sw.idx, b, r, sw.scale, k=k,
                                stride=stride, relu=not residual)
    torch.cuda.synchronize()
    _bf16_close(got, want)


@pytest.mark.parametrize("store", ["int8", "f32"])
@pytest.mark.parametrize("m", [1, 4, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_out,bn", [(1000, 25), (256, 32)])
def test_sparse_matmul_stored_weights_match_plain(dev, d_out, bn, dtype, m,
                                                  store):
    """int8 codes: gemv at M <= 8, simt above; f32 weights: simt. The
    kernel computes the code product; ``ops.sparse_matmul`` applies the
    scale after it."""
    gen = torch.Generator().manual_seed(d_out + m)
    sw = _weight(gen, 2048, d_out, 32, bn, 0.85, dev)
    sw = _int8(sw) if store == "int8" else type(sw)(sw.vals.float(), sw.idx,
                                                     sw.d_in)
    x = torch.randn((m, 2048), generator=gen).to(dev, dtype)
    want_v = "gemv" if store == "int8" and m <= 8 else "simt"
    assert sm.variant(dtype, m, 32, bn, sw.vals.dtype) == want_v
    ops.reset_launches()
    got = sm.sparse_matmul(x, sw.vals, sw.idx)
    _assert_variant("sparse_matmul", want_v)
    want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        _bf16_close(got, want)
    else:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
    y = ops.sparse_matmul(x, sw)
    torch.cuda.synchronize()
    y_cpu = ops.sparse_matmul(x.cpu(), sw.to("cpu"))
    if dtype == torch.bfloat16:
        _bf16_close(y.cpu(), y_cpu)
    else:
        assert float((y.cpu() - y_cpu).abs().max()) <= \
            1e-5 * float(y_cpu.abs().max())


@pytest.mark.parametrize("store", ["int8", "f32"])
@pytest.mark.parametrize("shape", [(32, 64, 112, 1, False, True),
                                   (144, 24, 56, 1, True, False),
                                   (576, 96, 14, 1, True, False),
                                   (960, 320, 7, 1, False, False),
                                   (512, 1024, 14, 2, False, True),
                                   (36, 24, 9, 1, True, True)], ids=str)
def test_dw_pw_stored_weights_match_plain(dev, shape, store):
    """int8 pointwise codes take mma (simt at C 36), their scale in the
    epilogue; f32 weights and biases take simt."""
    from repro_torch.core.quant import quantize_tree
    c, co, h, stride, residual, relu = shape
    gen = torch.Generator().manual_seed(c + co + h)
    x, dw_w, dw_b, pw_w, pw_b, r = _dw_pw_inputs(gen, 1, c, co, h, stride,
                                                 residual, dev)
    if store == "int8":
        q = quantize_tree({"l": {"w": pw_w.cpu()}}, "int8")["l"]["w"]
        args = (x, dw_w, dw_b, q.codes.to(dev), pw_b, r, q.scale.to(dev))
        want_v = "mma" if c % 8 == 0 and co % 8 == 0 else "simt"
    else:
        args = (x, dw_w.float(), dw_b.float(), pw_w.float(), pw_b.float(), r,
                None)
        want_v = "simt"
    assert dwpw.variant(c, co, 3, stride, args[3].dtype) == want_v
    kw = dict(stride=stride, relu=relu)
    ops.reset_launches()
    got = dwpw.dw_pw(*args, **kw)
    _assert_variant("dw_pw", want_v)
    want = dwpw.dw_pw_torch(*args, **kw)
    torch.cuda.synchronize()
    _bf16_close(got, want)


def test_stored_weights_refused_where_not_built(dev):
    """int8 and f32 dw_pw are built for the 3x3 depthwise only; a scale
    without int8 codes is refused; nothing falls back."""
    gen = torch.Generator().manual_seed(0)
    x, dw_w, dw_b, pw_w, pw_b, _ = _dw_pw_inputs(gen, 1, 32, 32, 8, 1, False,
                                                 dev, k=5)
    codes = torch.ones((32, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="k in"):
        dwpw.dw_pw(x, dw_w, dw_b, codes, pw_b, None,
                   torch.ones(32, device=dev))
    with pytest.raises(ValueError, match="pw_scale"):
        dwpw.dw_pw(x, dw_w, dw_b, pw_w, pw_b, None,
                   torch.ones(32, device=dev))


@pytest.mark.parametrize("quantize", ["native", "int8"])
def test_graph_replay_equals_eager_bitwise(dev, quantize):
    """A ResNet-50 request replayed from its CUDA graph gives the eager
    request's logits bit for bit; the capture holds one request's
    launches (47 sparse_conv mma + 1 sparse_matmul gemv)."""
    from repro_torch.launch.serve import ServeConfig, _serve_cnn_latency
    cfg = ServeConfig(arch="resnet50", mode="latency", image_size=64,
                      n_requests=3, quantize=quantize, device="cuda",
                      verbose=False)
    ops.reset_launches()
    graph = _serve_cnn_latency(cfg)
    assert graph["captured"]
    assert ops.LAUNCHES["sparse_conv"] == 2 * 47     # warm-up + capture
    eager = _serve_cnn_latency(cfg, capture=False)
    assert not eager["captured"]
    for out in (graph, eager):
        assert out["launches_per_request"]["sparse_conv"] == 47
        assert out["variant_launches_per_request"][
            ("sparse_matmul", "gemv")] == 1
    assert (graph["logits"].view("uint32") ==
            eager["logits"].view("uint32")).all()


@pytest.mark.parametrize("quantize", ["native", "int8"])
@pytest.mark.parametrize("arch", ["resnet50", "mobilenet_v1",
                                  "mobilenet_v2"])
def test_pipeline_serving_equals_sequential_on_the_card(dev, arch, quantize):
    """Throughput serving on the card at 64 px: the batched executor
    (batch 8, M 4, S 3, each stage on its own stream, captured as one CUDA
    graph) and the continuous server (mb 2, one captured tick a
    microbatch) give the sequential forward's logits, microbatch by
    microbatch, bit for bit; the one-stream executor gives the same; the
    capture holds M x one forward's launches, the tick one forward's."""
    from repro_torch.core.quant import quantize_tree
    from repro_torch.launch import serve as srv
    cfg = get_config(arch)
    params = cnn.params_to(quantize_tree(srv._init_native(cfg, 0), quantize),
                           dev)
    per_forward = {"resnet50": {"sparse_conv": 47, "sparse_matmul": 1}}.get(
        arch, {"dw_pw": 13 if arch == "mobilenet_v1" else 17})
    kw = dict(batch=8, n_microbatches=4, n_stages=3, image_size=64,
              iters=2, quantize=quantize, verbose=False)
    ops.reset_launches()
    out = srv._serve_cnn(arch, **kw)
    assert out["captured"] and out["streams"] == 3
    for name, n in per_forward.items():
        assert out["launches_per_batch"][name] == 4 * n
        assert ops.LAUNCHES[name] == 2 * 4 * n     # warm-up + capture
    images = torch.from_numpy(out["images"])
    seq = torch.cat([cnn.cnn_forward(cfg, params, images[i:i + 2],
                                     device="cuda").cpu()
                     for i in range(0, 8, 2)])
    assert torch.equal(torch.from_numpy(out["logits"]), seq)
    one = srv._serve_cnn(arch, streams=False, **kw)
    assert one["streams"] == 1
    assert (one["logits"].view("uint32") == out["logits"].view("uint32")).all()
    ops.reset_launches()
    cont = srv._serve_cnn_continuous(arch, n_requests=2, batch=5, mb_size=2,
                                     n_stages=3, image_size=64,
                                     quantize=quantize, verbose=False)
    for name, n in per_forward.items():
        assert cont["launches_per_tick"][0][name] == n
    assert cont["ticks"] == 3 + 3 + 2
    for x, got in zip(cont["request_images"], cont["logits"]):
        # the server's microbatches: the last one zero-padded to mb 2
        x = torch.cat([torch.from_numpy(x), torch.zeros((1,) + x.shape[1:])])
        want = torch.cat([cnn.cnn_forward(cfg, params, x[i:i + 2],
                                          device="cuda").cpu()
                          for i in range(0, 6, 2)])
        assert torch.equal(torch.from_numpy(got), want[:5])


# -- tuned plans (core/tuning.py) ---------------------------------------------

def _groups_bitwise(outs, order_key):
    """Candidates whose knobs that order the sums (``order_key``) agree
    give the same output bit for bit: the tile and thread knobs change
    where a sum is taken, not its order."""
    firsts = {}
    for plan, y in outs:
        k = order_key(plan)
        if k in firsts:
            assert torch.equal(y, firsts[k]), (plan, k)
        else:
            firsts[k] = y


# (N, H, C, Cout, k, stride, sparsity): a ResNet-50 stage-2 3x3 layer at
# n 1 and its 1x1 stage-3 layer at n 4
TUNE_CONV_CASES = [(1, 28, 128, 128, 3, 1, 0.85), (4, 7, 2048, 512, 1, 1, 0.85)]


@pytest.mark.parametrize("case", TUNE_CONV_CASES, ids=str)
def test_sparse_conv_every_candidate_plan(dev, case):
    """Every (tm, split) the autotuner may pick: within 1 bf16 ulp of the
    plain version; the same split gives the default plan's bits."""
    n, h, cin, cout, k, stride, sp = case
    gen = torch.Generator().manual_seed(h + cin)
    sw = _weight(gen, k * k * cin, cout, 32, 32, sp, dev)
    x = torch.randn((n, h, h, cin), generator=gen).to(dev, torch.bfloat16)
    b = (torch.randn((cout,), generator=gen) * 0.1).to(dev, torch.bfloat16)
    n_k = sw.vals.shape[1]
    want = sc.sparse_conv_torch(x, sw.vals, sw.idx, b, k=k, stride=stride)
    default = sc.sparse_conv(x, sw.vals, sw.idx, b, k=k, stride=stride)
    d_plan = sc.plan(n * -(-h // stride) ** 2, cout // 32, n_k)
    outs = [(d_plan, default)]
    for plan in sc.plan_candidates(n_k):
        y = sc.sparse_conv(x, sw.vals, sw.idx, b, k=k, stride=stride,
                           plan=plan)
        torch.cuda.synchronize()
        _bf16_close(y, want)
        outs.append((plan, y))
    _groups_bitwise(outs, lambda p: p[1])


# (N, H, C, Cout, stride): a MobileNet-V1 block at n 1 and a V2 block at n 4
TUNE_DW_PW_CASES = [(1, 56, 128, 128, 1), (4, 14, 576, 160, 2)]


@pytest.mark.parametrize("case", TUNE_DW_PW_CASES, ids=str)
def test_dw_pw_every_candidate_plan(dev, case):
    """Every plan of ``dw_pw_fused.plan_candidates``: within 1 bf16 ulp of
    the plain version; the same (ck, split) gives the same bits."""
    n, h, c, co, stride = case
    gen = torch.Generator().manual_seed(c + co)
    x, dw_w, dw_b, pw_w, pw_b, r = _dw_pw_inputs(gen, n, c, co, h, stride,
                                                 True, dev)
    want = dwpw.dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b, r, stride=stride)
    ho = -(-h // stride)
    d_plan = dwpw.plan(n, ho, ho, c, co, 3, stride)
    outs = [(d_plan, dwpw.dw_pw(x, dw_w, dw_b, pw_w, pw_b, r,
                                stride=stride))]
    for plan in dwpw.plan_candidates(n, ho, ho, c, co, 3, stride):
        y = dwpw.dw_pw(x, dw_w, dw_b, pw_w, pw_b, r, stride=stride,
                       plan=plan)
        torch.cuda.synchronize()
        _bf16_close(y, want)
        outs.append((plan, y))
    _groups_bitwise(outs, lambda p: (p.ck, p.split))


@pytest.mark.parametrize("case", [(2, 56, 64, 1), (1, 14, 512, 2)], ids=str)
def test_depthwise_every_candidate_plan(dev, case):
    """Every (r, threads): the default plan's bits (no knob orders the
    sums), within 1 bf16 ulp of the plain version."""
    n, h, c, stride = case
    gen = torch.Generator().manual_seed(h + c)
    x = torch.randn((n, h, h, c), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((3, 3, c), generator=gen) / 3).to(dev, torch.bfloat16)
    want = dw.depthwise_conv_torch(x, w, stride=stride)
    default = dw.depthwise_conv(x, w, stride=stride)
    cands = dw.plan_candidates(c, stride)
    assert len(cands) == (12 if stride == 1 else 4)
    for plan in cands:
        y = dw.depthwise_conv(x, w, stride=stride, plan=plan)
        torch.cuda.synchronize()
        _bf16_close(y, want)
        assert torch.equal(y, default), plan


def test_wrappers_refuse_plans_they_cannot_run(dev):
    """An infeasible plan raises; a plan for a variant without knobs
    raises; nothing falls back to the default plan."""
    gen = torch.Generator().manual_seed(3)
    sw = _weight(gen, 9 * 64, 64, 32, 32, 0.5, dev)
    x = torch.randn((1, 9, 9, 64), generator=gen).to(dev, torch.bfloat16)
    b = torch.zeros(64, dtype=torch.bfloat16, device=dev)
    n_k = sw.vals.shape[1]
    for bad in ((64, 1), (32, n_k + 1), (16, 0)):
        with pytest.raises(ValueError, match="plan"):
            sc.sparse_conv(x, sw.vals, sw.idx, b, k=3, plan=bad)
    sw8 = _weight(gen, 9 * 64, 64, 8, 8, 0.5, dev)
    with pytest.raises(ValueError, match="simt"):
        sc.sparse_conv(x, sw8.vals, sw8.idx, b, k=3, plan=(32, 1))
    xd, dw_w, dw_b, pw_w, pw_b, _ = _dw_pw_inputs(gen, 1, 64, 64, 9, 1,
                                                  False, dev)
    good = dwpw.plan(1, 9, 9, 64, 64, 3, 1)
    for bad in (good._replace(split=4), good._replace(tn=32),
                good._replace(tr=9, tw=9)):
        with pytest.raises(ValueError, match="plan"):
            dwpw.dw_pw(xd, dw_w, dw_b, pw_w, pw_b, plan=bad)
    with pytest.raises(ValueError, match="plan"):
        dw.depthwise_conv(xd, dw_w, stride=2, plan=(2, 64))
    with pytest.raises(ValueError, match="plan"):
        dw.depthwise_conv(xd, dw_w, plan=(1, 48))


def test_captured_graph_keeps_its_knobs(dev):
    """ops.dw_pw_conv captured under one cache replays that plan after the
    active cache changes, even to a plan the kernel refuses (the eager
    call then raises); the capture counted one launch, a replay none."""
    from repro_torch.core import tuning
    gen = torch.Generator().manual_seed(5)
    x, dw_w, dw_b, pw_w, pw_b, _ = _dw_pw_inputs(gen, 1, 128, 128, 28, 1,
                                                 False, dev)
    key = tuning.kernel_key("dwpw", x.shape, x.dtype,
                            device=tuning.device_signature(dev), k=3, s=1,
                            co=128)
    good, bad = tuning.TuningCache(), tuning.TuningCache()
    for cache, split in ((good, 2), (bad, 64)):
        for name, v in (("tm", 32), ("tn", 64), ("ck", 32), ("split", split)):
            cache.put_knob(key, name, v)
    with ops.config(tuning_cache=good):
        want = ops.dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        ops.reset_launches()
        with torch.cuda.graph(graph):
            out = ops.dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b)
        _assert_launches({"dw_pw": 1})
    _bf16_close(want, dwpw.dw_pw_torch(x, dw_w, dw_b, pw_w, pw_b))
    with ops.config(tuning_cache=bad):
        with pytest.raises(ValueError, match="plan"):
            ops.dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b)
        ops.reset_launches()
        graph.replay()
        torch.cuda.synchronize()
        _assert_launches({})
    assert torch.equal(out, want)


def test_calibrate_resnet50_covers_every_node(dev):
    """calibrate(..., autotune=True) on the card at 64 px: every fused node
    timed (the measured plan's coverage 1.0, keys on this card), every
    distinct sparse conv shape tuned, and the forward under the cache
    within the bars of the default forward."""
    from repro_torch.core import planner, tuning
    from repro_torch.launch import serve as srv
    cfg = get_config("resnet50")
    params = cnn.params_to(srv._init_native(cfg, 0), dev)
    cache = tuning.calibrate(cfg, params, (1, 64, 64, 3), autotune=True,
                             iters=3)
    sig = tuning.device_signature(dev)
    assert cache.meta["device"] == sig and sig.endswith(":cuda")
    assert all(k.endswith(sig) for k in cache.entries)
    plan = planner.plan(cfg, params, planner.PlanRequest(
        n_stages=4, model="measured", tuning_cache=cache))
    cov = plan["measured_coverage"]
    assert cov["coverage"] == 1.0 and cov["fallback"] == []
    assert all(c > 0 for c in plan["node_cycles"])
    sconv = [k for k in cache.entries if k.startswith("kern/sconv/")]
    assert len(sconv) >= 15
    for key in sconv:
        assert cache.knob(key, "tm") in sc.TILES and cache.time_us(key) > 0
    x = torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    base = cnn.cnn_forward(cfg, params, x, device="cuda").cpu()
    ops.reset_launches()
    with ops.config(tuning_cache=cache):
        tuned = cnn.cnn_forward(cfg, params, x, device="cuda").cpu()
    _assert_launches({"sparse_conv": 47, "sparse_matmul": 1})
    scale = float(base.abs().max())
    assert float((tuned - base).abs().max()) <= 1e-3 * scale


# -- the fault-tolerant tier (runtime/tier.py) on the card --------------------

def _tier_requests(n, batch, size):
    gen = torch.Generator().manual_seed(3)
    return [torch.randn((batch, size, size, 3), generator=gen).numpy()
            for _ in range(n)]


def _tier_sequential(cfg, params, x, mb):
    """The sequential forward on the card, microbatch by microbatch, the
    last one zero-padded to ``mb`` as the tier pads it, under the cuDNN
    setting the tier builds its replicas with."""
    from repro_torch.core.device import deterministic_convs
    x = torch.from_numpy(x)
    params = cnn.params_to(params, "cuda")
    pad = (-len(x)) % mb
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]))])
    with deterministic_convs():
        return torch.cat([cnn.cnn_forward(cfg, params, x[i:i + mb],
                                          device="cuda").cpu()
                          for i in range(0, len(x), mb)])[:len(x) - pad]


@pytest.mark.parametrize("quantize", ["native", "int8"])
@pytest.mark.parametrize("arch", ["resnet50", "mobilenet_v1"])
def test_tier_recovers_bitwise_on_the_card(dev, arch, quantize):
    """The in-process tier at 64 px, R 2, S 4, mb 2: replica 0 fails at
    tick 3 with copies in flight; every request equals the no-failure
    run's and the sequential forward's bitwise; the respawned replica
    kept its buffers (its captured ticks read them); both replicas share
    one copy of the weights and one plan."""
    from repro_torch.runtime import fault, tier as T
    cfg = get_config(arch)
    reqs = _tier_requests(4, 5, 64)
    outs = []
    for injectors in ({}, {0: fault.FailureInjector(fail_at_steps=(3,))}):
        ops.reset_launches()
        t = T.ServingTier(arch, n_replicas=2, n_stages=4, mb_size=2,
                          image_size=64, quantize=quantize,
                          injectors=injectors)
        launched = dict(ops.LAUNCHES)
        bufs = [b.data_ptr() for w in t.workers for b in w.server._bufs]
        rids = [t.submit(x) for x in reqs]
        m = t.run()
        outs.append([t.results(r) for r in rids])
        assert m["completed"] == 4 and m["failed"] == 0
        assert m["respawns"] == (1 if injectors else 0)
        assert bufs == [b.data_ptr() for w in t.workers
                        for b in w.server._bufs]
        servers = [w.server for w in t.workers]
        assert servers[0].plan is servers[1].plan is t.plan
        per_fwd = ({"sparse_conv": 47, "sparse_matmul": 1}
                   if arch == "resnet50" else {"dw_pw": 13})
        for name, n in per_fwd.items():     # 2 replicas x 2 eager + 2
            assert launched[name] == 2 * 4 * n   # captured ticks each
    for a, b, x in zip(outs[0], outs[1], reqs):
        assert (a.view("uint32") == b.view("uint32")).all()
        assert torch.equal(torch.from_numpy(b),
                           _tier_sequential(cfg, t.params, x, 2))


def test_process_and_host_tiers_bitwise_on_the_card(dev):
    """Two worker processes on the card (ResNet-50 at 64 px): a SIGKILL
    of worker 0 at its first tick, then two dial-in workers with every
    connection killed mid-stream; both streams equal the in-process
    tier's on the same weights bitwise. The workers' frames are swallowed
    by the proxy from the submit to the kill, so the kill lands with work
    outstanding whatever the timing."""
    import socket as _socket
    import time
    from repro_torch.runtime import fault, tier as T
    arch, size = "resnet50", 64
    reqs = _tier_requests(3, 4, size)
    ref = T.ServingTier(arch, n_replicas=1, n_stages=2, mb_size=2,
                        image_size=size)
    rids = [ref.submit(x) for x in reqs]
    ref.run()
    want = [ref.results(r) for r in rids]
    with T.ProcessServingTier(arch, n_procs=2, n_stages=2, mb_size=2,
                              image_size=size,
                              worker_hooks={0: {"kill_at_tick": 1}}) as t:
        rids = [t.submit(x) for x in reqs]
        m = t.run()
        got = [t.results(r) for r in rids]
        assert m["respawns"] == 1 and m["failed"] == 0
        assert all(r["launches"]["sparse_conv"] == 4 * 47
                   for r in t.ready_times)
    for a, b in zip(want, got):
        assert (a.view("uint32") == b.view("uint32")).all()
    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proxy = fault.NetFaultProxy(("127.0.0.1", port))
    try:
        with T.HostServingTier(arch, n_procs=2, n_stages=2, mb_size=2,
                               image_size=size, listen=("127.0.0.1", port),
                               dial_addrs={0: proxy.address,
                                           1: proxy.address}) as t:
            # the workers' frames are swallowed until the kill, so work
            # is surely outstanding on the connections that die
            proxy.sever("c2s")
            rids = [t.submit(x) for x in reqs]
            t.run(max_rounds=2)
            proxy.heal("c2s")
            proxy.kill_connections()
            deadline = time.monotonic() + 600
            while t._live_rids() and time.monotonic() < deadline:
                t.run(max_rounds=20)
            got = [t.results(r) for r in rids]
            assert t.respawns >= 1 and t.recovered_microbatches >= 1
    finally:
        proxy.close()
    for a, b in zip(want, got):
        assert (a.view("uint32") == b.view("uint32")).all()


@pytest.mark.parametrize("quantize", ["native", "int8"])
@pytest.mark.parametrize("arch", ["resnet50", "mobilenet_v2"])
def test_placed_rows_equal_closures_on_the_card(dev, arch, quantize):
    """The continuous server on its packed rows (16-byte-aligned leaves)
    against one on closures, 64 px, mb 2, S 4: the same launches a tick
    by name and variant, no aligned16 copy, the same logits and state
    wires bit for bit, and the oracle bitwise the unfused view."""
    import numpy as np
    from repro_torch.launch import serve as port_serve
    cfg = get_config(arch)
    params = port_serve._init_native(cfg, 0)
    reqs = [np.random.default_rng(i).normal(size=(3, 64, 64, 3)).astype(
        np.float32) for i in range(2)]
    srvs, outs = {}, {}
    for closures in (False, True):
        c0 = _build.ALIGN_COPIES
        srv = port_serve.CNNPipelineServer(
            arch, mb_size=2, n_stages=4, image_size=64, quantize=quantize,
            params=params, closures=closures)
        assert _build.ALIGN_COPIES == c0
        ids = [srv.submit(x) for x in reqs]
        srv.run()
        outs[closures] = [srv.results(i) for i in ids]
        srvs[closures] = srv
    assert srvs[False].param_rows is not None
    assert srvs[False].launches_per_tick == srvs[True].launches_per_tick
    for a, b in zip(outs[False], outs[True]):
        assert (a.view("uint32") == b.view("uint32")).all()
    for a, b in zip(srvs[False]._bufs, srvs[True]._bufs):
        assert torch.equal(a, b)
    p_dev = cnn.params_to(params, dev)
    x = torch.from_numpy(reqs[0][:1])
    assert torch.equal(cnn.cnn_forward_reference(cfg, p_dev, x),
                       cnn.cnn_forward(cfg, p_dev, x, graph=graph_for(arch)))


# ---- the large dense LMs: flash at D 128, 128 x 128 blocks, the
# cache-chunk step and the continuous batcher ---------------------------

# (B, Tq, Tk, H, D, causal, window, q_offset): a prefill of each large
# LM's heads at a shortened T, a cache chunk, a key count that is no
# tile multiple, a window, one query at the end
FLASH_D128_CASES = [
    (1, 256, 256, 64, 128, True, 0, 0),      # Qwen3-32B's 64 heads
    (1, 256, 256, 48, 128, True, 0, 0),      # Granite-20B's 48
    (1, 512, 2048, 8, 128, True, 0, 1536),   # the last of 4 chunks
    (2, 100, 1000, 4, 128, True, 0, 900),
    (2, 77, 77, 3, 128, False, 30, 0),
    (1, 1, 129, 2, 128, True, 0, 128),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_D128_CASES, ids=str)
def test_flash_attention_d128_matches_plain(dev, case, dtype):
    b, tq, tk, h, d, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(tq + tk + h)
    q, k, v = (torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
               for t in (tq, tk, tk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ops.reset_launches()
    got = fa.flash_attention(q, k, v, **kw)
    _assert_variant("flash_attention",
                    "mma" if dtype == torch.bfloat16 else "simt")
    want = fa.flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("m", [1, 4, 8, 9, 100, 2048])
@pytest.mark.parametrize("d_in,d_out,bm,bn", [
    (1280, 2560, 128, 128),      # w1 / w3 shaped: K 2 of 10
    (2560, 1280, 128, 128),      # w2 shaped: K 3 of 20
    (1280, 640, 128, 64),        # mixed sides
    (640, 1280, 64, 128),
], ids=["w1_128", "w2_128", "128x64", "64x128"])
def test_sparse_matmul_128_blocks_match_plain(dev, d_in, d_out, bm, bn, m):
    gen = torch.Generator().manual_seed(d_in + d_out + m)
    sw = _weight(gen, d_in, d_out, bm, bn, 0.85, dev)
    x = torch.randn((m, d_in), generator=gen).to(dev, torch.bfloat16)
    var = sm.variant(x.dtype, m, bm, bn)
    assert var == ("gemv" if m <= 8 else "mma")
    ops.reset_launches()
    got = sm.sparse_matmul(x, sw.vals, sw.idx)
    _assert_variant("sparse_matmul", var)
    want = sm.sparse_matmul_torch(x, sw.vals, sw.idx)
    torch.cuda.synchronize()
    _bf16_close(got, want)
    if m == 9:                   # simt at the same blocks, f32 x
        ops.reset_launches()
        xf = x.float()
        got = sm.sparse_matmul(xf, sw.vals, sw.idx)
        _assert_variant("sparse_matmul", "simt")
        torch.testing.assert_close(
            got, sm.sparse_matmul_torch(xf, sw.vals, sw.idx), rtol=1e-5,
            atol=1e-5 * float(got.abs().max()))


@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-20b"])
def test_cache_chunks_and_batcher_on_card_match_cpu(dev, arch):
    """reduced qwen3-32b (GQA, qk_norm) and granite-20b (one KV head): a
    prefill launches one flash_attention and three sparse_matmul a
    layer; a prompt in chunks through the cache launches the same a
    layer for each chunk of more than one token (a one-token chunk takes
    the decode attention and gemv) and matches the CPU's; the continuous
    batcher launches three gemv a layer a step and no flash, and its
    steps' logits match the CPU batcher's within 1e-2 of max |logit| for
    as long as both fed the same tokens (a near tie may part them)."""
    from repro_torch.runtime.scheduler import (ContinuousBatcher, Request,
                                               make_per_slot_decode,
                                               make_slot_cache)
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cpu = lm.params_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(2))
    n = cfg.n_layers
    ops.reset_launches()
    got = make_prefill_step(cfg)(params, toks.to(dev)).cpu()
    _assert_launches({"flash_attention": n, "sparse_matmul": 3 * n})
    want = make_prefill_step(cfg)(cpu, toks)
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())
    outs = {}
    for d, p in ((dev, params), ("cpu", cpu)):
        cache = lm.init_cache(cfg, 2, 32, device=d)
        ops.reset_launches()
        lgs = [lm.prefill_chunk(cfg, p, cache, toks[:, a:b].to(d), a)[0]
               for a, b in ((0, 9), (9, 10), (10, 24))]
        if d == dev:
            _assert_launches({"flash_attention": 2 * n,
                              "sparse_matmul": 9 * n})
            assert ops.VARIANT_LAUNCHES[("sparse_matmul", "gemv")] == 3 * n
        outs[d if d == "cpu" else "card"] = torch.cat(lgs, 1).cpu()
    want = outs["cpu"]
    assert float((outs["card"] - want).abs().max()) <= \
        1e-2 * float(want.abs().max())

    logs = {}
    for d, p in ((dev, params), ("cpu", cpu)):
        rec = logs.setdefault(str(d), [])
        decode = make_per_slot_decode(cfg)

        def recording(p_, c_, t_, pos_, rec=rec, decode=decode):
            lg, c_ = decode(p_, c_, t_, pos_)
            # a copy: on the CPU the batcher's token tensor shares the
            # host buffer it rewrites every step
            rec.append((t_.cpu().clone(), lg[:, -1].float().cpu()))
            return lg, c_
        cb = ContinuousBatcher(
            cfg, p, slots=3, max_seq=32, decode_fn=recording,
            init_cache_fn=lambda c, s, m, d=d: make_slot_cache(c, s, m,
                                                               device=d))
        rng = torch.Generator().manual_seed(4)
        for rid in range(5):
            n_p = int(torch.randint(2, 9, (1,), generator=rng))
            cb.submit(Request(rid=rid, prompt=torch.randint(
                0, cfg.vocab_size, (n_p,), generator=rng).numpy().astype(
                    "int32"), max_new_tokens=4))
        ops.reset_launches()
        cb.run()
        if d == dev:
            _assert_launches({"sparse_matmul": 3 * n * cb.steps})
            _assert_variant("sparse_matmul", "gemv", 3 * n * cb.steps)
    card, cpu_logs = logs[str(dev)], logs["cpu"]
    assert len(card) == len(cpu_logs)
    compared = 0
    for (fed, got), (fed_cpu, want) in zip(card, cpu_logs):
        if not torch.equal(fed, fed_cpu):
            break
        assert float((got - want).abs().max()) <= \
            1e-2 * float(want.abs().max())
        compared += 1
    assert compared >= 8


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("shape", [(1, 256), (4, 1)], ids=["t256", "b4"])
def test_moe_layer_on_card_matches_cpu(dev, shape, cf):
    """granite-moe-3b-a800m's MoE layer at full width (40 experts top-8,
    f 512) on the card against the CPU on the same input, a T 256
    prefill (cap 64 at 1.25) and a batch-4 decode step routed together
    (cap 1): expert ids and kept assignments equal and the output within
    1 bf16 ulp at every token clear of a near tie
    (``checks.clear(route, MOE_TIE_MARGIN)``), aux within 1e-5 relative; no
    hand-written kernel runs (the experts are torch products under
    ``fdot``'s f32 rule); two runs on the card give the same bits (the
    combine adds in one fixed order, no atomics)."""
    from repro_torch import checks as C
    from repro_torch.models import layers as L
    cfg = get_config("granite-moe-3b-a800m")
    p = L.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    p_cpu = {k: v.cpu() for k, v in p.items()}
    x = torch.randn(shape + (cfg.d_model,),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    with L.full_f32(), L.record_moe() as card:
        ops.reset_launches()
        got, aux = L.moe(p, cfg, x.to(dev), capacity_factor=cf)
        _assert_launches({})
        again, _ = L.moe(p, cfg, x.to(dev), capacity_factor=cf)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    with L.full_f32(), L.record_moe() as cpu:
        want, aux_cpu = L.moe(p_cpu, cfg, x, capacity_factor=cf)
    rc, rw = card[0], cpu[0]
    clear = C.clear(rw, C.MOE_TIE_MARGIN)[0]
    print(f"clear tokens: {int(clear.sum())} of {clear.numel()}")
    # measured on an H100: 255 and 220 of 256 (cf 1.25, 0.5), 4 of 4;
    # the floor is the lowest share less 10%
    assert clear.float().mean() >= 0.77
    assert torch.equal(rc.eidx[0].cpu().sort(-1).values[clear],
                       rw.eidx[0].sort(-1).values[clear])
    assert torch.equal(rc.kept[0].cpu()[clear], rw.kept[0][clear])
    if cf < 1 and shape == (4, 1):
        assert int(rw.dropped) > 0
    d = cfg.d_model
    _bf16_close(got.reshape(-1, d).cpu()[clear], want.reshape(-1, d)[clear])
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * abs(float(aux_cpu))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llava-next-mistral-7b"])
def test_moe_and_vlm_models_on_card_match_cpu(dev, arch):
    """Reduced granite-moe and llava: a prefill launches one
    flash_attention a layer and, for llava's pruned FFN, three
    sparse_matmul "mma" (granite-moe none: its blocks have experts, no
    FFN); a decode step three "gemv" a layer for llava, nothing
    hand-written for granite-moe; the logits within 1e-2 of max |logit|
    of the CPU's at every token the routing holds
    (``checks.held_tokens`` at 1e-2)."""
    from repro_torch import checks as C
    from repro_torch.models import layers as L
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cpu = lm.params_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(2))
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.randn(
            (2, cfg.vision_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(3)).bfloat16()
    n = cfg.n_layers
    ffn = 3 * n if cfg.family == "vlm" else 0
    t = toks.shape[1] + (cfg.vision_tokens if extra else 0)
    ops.reset_launches()
    got, _ = lm.forward(cfg, params, toks.to(dev), extra={
        k: v.to(dev) for k, v in extra.items()} or None)
    _assert_launches({"flash_attention": n, "sparse_matmul": ffn})
    _assert_variant("sparse_matmul", "mma", ffn)
    with L.record_moe() as routes:
        want, _ = lm.forward(cfg, cpu, toks, extra=extra or None)
    held = torch.from_numpy(C.held_tokens(routes, 2, t, 1e-2))
    err = (got.cpu() - want).abs().amax(-1)
    print(f"held tokens: {int(held.sum())} of {held.numel()}")
    # measured on an H100: granite-moe 27 of 48, less 10%; llava has no
    # router, so every token is held
    assert int(held.sum()) >= (24 if cfg.family == "moe" else held.numel())
    assert (err[held] <= 1e-2 * float(want.abs().max())).all()
    ops.reset_launches()
    step, _ = lm.decode_step(cfg, params, lm.init_cache(cfg, 2, 8,
                                                        device=dev),
                             toks[:, :1].to(dev), 0)
    _assert_launches({"sparse_matmul": ffn})
    _assert_variant("sparse_matmul", "gemv", ffn)
    assert torch.isfinite(step).all()
