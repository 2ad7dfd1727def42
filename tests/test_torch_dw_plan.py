"""The partitions behind the port's redesigned depthwise kernels, on the
CPU: the tiles, channel chunks and cluster split that ``dw_pw_fused.plan``
picks for the mma variant at every MobileNet block and at odd shapes, the
``depthwise_conv.plan`` grid, a torch emulation of the mma variant's order
of sums (16-channel tensor-core steps per chunk, per-rank partials summed
in rank order, then the epilogue) against the plain version and the JAX
reference, and both plain versions against the reference's Pallas kernels
(interpret mode) at kernel sizes 1, 5 and 7 and at odd C."""
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.depthwise_conv import depthwise_conv_pallas  # noqa: E402
from repro.kernels.dw_pw_fused import dw_pw_pallas, dw_pw_xla  # noqa: E402
from repro_torch.core.fusion import fused_graph_for  # noqa: E402
from repro_torch.core.graph import graph_for  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw  # noqa: E402
from repro_torch.kernels import dw_pw_fused as dwpw  # noqa: E402
from repro_torch.models.cnn import tensor_from_numpy as _t  # noqa: E402

MOBILENETS = ("mobilenet_v1", "mobilenet_v2")


def _bf16(a):
    """numpy f32 -> numpy bf16 (JAX's rounding)."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32))
                      .astype(jnp.bfloat16))


def _bf16_tol(ref):
    """1 bf16 ulp: f32 sums in another order, rounded once."""
    scale = float(np.abs(ref).max())
    return 2.0 ** -7 * np.abs(ref) + 2.0 ** (math.floor(math.log2(scale)) - 7)


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= _bf16_tol(want)).all(), float(err.max())


def _blocks():
    """Every distinct fused dw_pw block of the two MobileNets at 224 px:
    (C, Cout, output H, stride, k)."""
    return sorted({(n.cin, n.cout, n.conv_out_hw, n.stride, n.k)
                   for a in MOBILENETS for n in fused_graph_for(a).nodes
                   if n.kind == "dw_pw"})


def _check_plan(n, ho, wo, c, co, k, stride):
    p = dwpw.plan(n, ho, wo, c, co, k, stride)
    chunks = -(-c // p.ck)
    assert p.tm in dwpw.TILES and p.ck in (32, 64)
    assert 1 <= p.tr * p.tw <= p.tm and p.tr <= ho
    assert p.tw == wo or (p.tr == 1 and p.tw == p.tm)
    assert 1 <= p.split <= dwpw.MAX_SPLIT and p.split & (p.split - 1) == 0
    assert p.split <= chunks                    # no rank without a chunk
    assert p.steps == -(-chunks // p.split)
    assert p.tn in (64, 128)
    assert p.smem == dwpw.smem_bytes(k, p.tm, p.tn, (p.tr - 1) * stride + k,
                                     (p.tw - 1) * stride + k, p.ck, p.split)
    assert p.smem <= dwpw.SMEM_MAX
    assert p.blocks == (n * -(-ho // p.tr) * -(-wo // p.tw)
                        * -(-co // p.tn) * p.split)
    # the docstring's promise: at most 3 chunks a block up to C = 1536
    if c <= 1536:
        assert p.steps <= dwpw.STEPS_PER_SLICE
    return p


@pytest.mark.parametrize("block", _blocks(), ids=str)
def test_plan_at_every_mobilenet_block(block):
    c, co, ho, stride, k = block
    assert dwpw.variant(c, co, k, stride) == "mma"
    p = _check_plan(1, ho, ho, c, co, k, stride)
    # 64-channel chunks wherever C allows; 128-channel Cout tiles past
    # Cout = 64; a cluster where C needs more than 3 chunks
    assert p.ck == (64 if c >= 64 else 32)
    assert p.tn == (128 if co > 64 else 64)
    assert (p.split > 1) == (-(-c // p.ck) > dwpw.STEPS_PER_SLICE
                             or p.blocks // p.split < dwpw.MIN_BLOCKS)


def test_plan_covers_both_networks():
    """21 distinct block shapes, 30 blocks, all on the mma variant."""
    assert len(_blocks()) == 21
    for a, want in (("mobilenet_v1", 13), ("mobilenet_v2", 17)):
        nodes = [n for n in fused_graph_for(a).nodes if n.kind == "dw_pw"]
        assert len(nodes) == want
        assert all(dwpw.variant(n.cin, n.cout, n.k, n.stride) == "mma"
                   for n in nodes)


@pytest.mark.parametrize("shape", [
    (1, 56, 56, 64, 128, 7, 2), (1, 112, 112, 32, 64, 7, 1),
    (1, 112, 112, 512, 64, 7, 2), (2, 9, 9, 24, 40, 5, 1),
    (4, 7, 7, 1536, 256, 3, 1), (1, 3, 3, 8, 8, 1, 1),
    (1, 28, 28, 40, 16, 5, 4), (1, 200, 200, 16, 8, 7, 3),
], ids=str)
def test_plan_at_odd_shapes(shape):
    _check_plan(*shape)


@pytest.mark.parametrize("c,co,k,stride,want", [
    (32, 64, 3, 1, "mma"), (960, 320, 3, 1, "mma"), (24, 40, 7, 2, "mma"),
    (36, 24, 3, 1, "simt"), (64, 20, 3, 1, "simt"), (3, 8, 5, 2, "simt"),
    (64, 64, 8, 1, "simt"), (64, 64, 3, 5, "simt"), (64, 64, 1, 4, "mma"),
])
def test_dw_pw_variant_choice(c, co, k, stride, want):
    assert dwpw.variant(c, co, k, stride) == want


@pytest.mark.parametrize("k", [0, 8, 9])
def test_wrappers_name_the_kernel_size_limit(k):
    """Both wrappers' shape checks refuse a kernel size below 1 and take
    every larger one, as the Pallas kernels do (past MAX_K through the
    simt variant with k at run time), before anything touches a card;
    the variant names the run-time instances past MAX_K."""
    x = (1, 9, 9, 8)
    w = (k, k, 8)
    args = (x, w, (8,), (8, 8), (8,))
    if k < 1:
        with pytest.raises(ValueError, match="k >= 1|do not fit"):
            dwpw.check_shapes(*args)
        with pytest.raises(ValueError, match="k >= 1"):
            dw.check_shapes(x, w)
    else:
        ho = -(-9 // 1)
        assert dwpw.check_shapes(*args)[:2] == (ho, ho)
        assert dw.check_shapes(x, w)[:2] == (ho, ho)
        assert dwpw.variant(8, 8, k) == "simt"
        assert dw.plan(1, ho, ho, 8, k, 1)[0] == 1
        assert dw.plan_candidates(8, 1, k) == [(1, t) for t in dw.THREADS]
    assert dwpw.MAX_K == dw.MAX_K == 7


@pytest.mark.parametrize("shape", sorted({
    (n.cin, n.conv_out_hw, n.stride) for a in MOBILENETS
    for n in graph_for(a).nodes if n.kind == "dw"}) + [
        (37, 15, 1), (1001, 7, 1), (24, 9, 2), (16, 3, 3)], ids=str)
def test_depthwise_plan_fills_the_card(shape):
    c, ho, stride = shape
    r, threads = dw.plan(1, ho, ho, c, 3, stride)
    assert r == (2 if stride == 1 and c % 8 == 0 else 1)
    assert threads in (32, 64, 128, 256)
    items = ho * -(-ho // r) * -(-c // 8)
    blocks = -(-items // threads)
    # the largest block that leaves one block for each SM, else 32 threads
    assert blocks >= dw.MIN_BLOCKS or threads == 32
    if threads < 256:
        assert -(-items // (2 * threads)) < dw.MIN_BLOCKS


def _mma_emulation(x, dw_w, dw_b, pw_w, pw_b, residual, *, stride, dw_relu,
                   relu):
    """The mma variant's order of sums in torch: the depthwise as the
    plain version rounds it, then per cluster rank its chunks of CK
    channels in 16-channel tensor-core steps into that rank's f32
    partial, the partials summed in rank order from zero, then pw_b, the
    residual and ReLU in f32 and one round."""
    n, h, w, c = x.shape
    k = dw_w.shape[0]
    xp, ho, wo = dw.pad_same_nhwc(x, k, stride)
    p = dwpw.plan(n, ho, wo, c, pw_w.shape[1], k, stride)
    d = dw.depthwise_acc(xp, dw_w, stride=stride, ho=ho, wo=wo) \
        + dw_b.float()
    if dw_relu:
        d = torch.relu(d)
    d = d.to(x.dtype).float()                 # the dw->pw boundary round
    wf = pw_w.float()
    chunks = -(-c // p.ck)
    y = torch.zeros((n, ho, wo, pw_w.shape[1]))
    for rank in range(p.split):
        part = torch.zeros_like(y)
        for ch in range(rank * chunks // p.split,
                        (rank + 1) * chunks // p.split):
            for c0 in range(ch * p.ck, min(c, (ch + 1) * p.ck), 16):
                part = part + d[..., c0:c0 + 16] @ wf[c0:c0 + 16]
        y = y + part
    y = y + pw_b.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


# (N, H, C, Cout, k, stride, residual, dw_relu, relu): splits of 1, 2, 4
# and 8 ranks, 32- and 64-channel chunks, k 1 to 7, strides 1 and 2
_EMULATION_CASES = [
    (1, 14, 384, 64, 3, 1, True, True, False),
    (1, 7, 1024, 64, 3, 1, False, True, True),
    (1, 14, 128, 48, 5, 2, False, False, True),
    (2, 9, 32, 16, 7, 1, True, True, False),
    (1, 12, 256, 32, 1, 1, True, True, True),
    (1, 8, 96, 24, 3, 2, False, True, True),
]


@pytest.mark.parametrize("case", _EMULATION_CASES, ids=str)
def test_mma_emulation_matches_plain_and_reference(case):
    n, h, c, co, k, stride, residual, dw_relu, relu = case
    rng = np.random.default_rng([n, h, c, co, k, stride])
    x = _bf16(rng.normal(size=(n, h, h, c)))
    dw_w = _bf16(rng.uniform(-1, 1, (k, k, c)) / k)
    dw_b = _bf16(rng.normal(size=(c,)) * 0.1)
    pw_w = _bf16(rng.uniform(-1, 1, (c, co)) / math.sqrt(c))
    pw_b = _bf16(rng.normal(size=(co,)) * 0.1)
    ho = -(-h // stride)
    res = _bf16(rng.normal(size=(n, ho, ho, co))) if residual else None
    kw = dict(stride=stride, dw_relu=dw_relu, relu=relu)
    args = [_t(a) for a in (x, dw_w, dw_b, pw_w, pw_b)]
    tres = None if res is None else _t(res)
    got = _mma_emulation(*args, tres, **kw)
    p = dwpw.plan(n, ho, ho, c, co, k, stride)
    assert p.split > 1 or c <= 192
    _close(got, dwpw.dw_pw_torch(*args, tres, **kw).float().numpy())
    j = [jnp.asarray(a) for a in (x, dw_w, dw_b, pw_w, pw_b)]
    jres = None if res is None else jnp.asarray(res)
    _close(got, dw_pw_pallas(*j, jres, **kw))
    _close(got, dw_pw_xla(*j, jres, **kw))


# (N, H, C, Cout, k, stride): the kernel sizes and C the redesigned
# kernels take beyond the MobileNets' 3x3 and multiples of 8
_KC_CASES = [
    (1, 9, 24, 16, 1, 1), (2, 8, 16, 24, 1, 2), (1, 11, 24, 16, 5, 1),
    (1, 12, 40, 24, 5, 2), (1, 13, 16, 16, 7, 1), (2, 10, 24, 8, 7, 2),
    (1, 9, 7, 5, 3, 1), (2, 8, 13, 11, 5, 2), (1, 7, 3, 9, 7, 1),
]


@pytest.mark.parametrize("case", _KC_CASES, ids=str)
def test_plain_versions_match_reference_at_kernel_sizes_and_odd_c(case):
    n, h, c, co, k, stride = case
    rng = np.random.default_rng([n, h, c, co, k, stride, 7])
    x = _bf16(rng.normal(size=(n, h, h, c)))
    dw_w = _bf16(rng.uniform(-1, 1, (k, k, c)) / k)
    dw_b = _bf16(rng.normal(size=(c,)) * 0.1)
    pw_w = _bf16(rng.uniform(-1, 1, (c, co)) / math.sqrt(c))
    pw_b = _bf16(rng.normal(size=(co,)) * 0.1)
    j = [jnp.asarray(a) for a in (x, dw_w, dw_b, pw_w, pw_b)]
    _close(dw.depthwise_conv_torch(_t(x), _t(dw_w), stride=stride),
           depthwise_conv_pallas(j[0], j[1], stride=stride))
    kw = dict(stride=stride, dw_relu=True, relu=False)
    got = dwpw.dw_pw_torch(*[_t(a) for a in (x, dw_w, dw_b, pw_w, pw_b)],
                           **kw)
    _close(got, dw_pw_pallas(*j, **kw))
    _close(got, dw_pw_xla(*j, **kw))
