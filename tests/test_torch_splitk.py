"""The partitions behind the port's split kernels, on the CPU: the tile
and cluster split-K that ``sparse_conv.plan`` picks for the mma variant
and the grid and row partition of the ``sparse_matmul`` gemv variant,
and a torch emulation of each kernel's order of sums (partials per
cluster rank or thread, summed in order, then the epilogue) against the
plain versions and the JAX reference, at small sizes."""
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fusion import conv_part, fused_graph_for  # noqa: E402
from repro_torch.kernels import sparse_conv as sc  # noqa: E402
from repro_torch.kernels import sparse_matmul as sm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.cnn import params_from_numpy  # noqa: E402
from repro_torch.models.cnn import tensor_from_numpy as _t  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402


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


def _bf16_tol(ref):
    """1 bf16 ulp: f32 sums in another order, rounded once."""
    scale = float(np.abs(ref).max())
    return 2.0 ** -7 * np.abs(ref) + 2.0 ** (math.floor(math.log2(scale)) - 7)


def _f32_tol(ref):
    return 1e-5 * np.abs(ref) + 1e-5 * float(np.abs(ref).max())


def _close(got, want, tol_fn):
    got = got.float().numpy()
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol_fn(want)).all()


def _check_conv_plan(m, ob, n_k):
    tm, split = sc.plan(m, ob, n_k)
    assert tm in sc.TILES
    assert 1 <= split <= min(sc.MAX_SPLIT, max(n_k, 1))
    grid = (-(-m // tm), ob, split)
    assert 1 <= grid[0] < 2 ** 31 and 1 <= grid[1] <= 65535
    # every K step in exactly one slice, the slices in rank order
    slices = sc.k_slices(n_k, split)
    assert len(slices) == split
    steps = [s for lo, hi in slices for s in range(lo, hi)]
    assert steps == list(range(n_k))
    if n_k >= split:
        assert all(hi > lo for lo, hi in slices)
    # no slice longer than STEPS_PER_SLICE steps while the split allows
    # it, and no split that a shorter chain does not need
    longest = max(hi - lo for lo, hi in slices)
    if n_k <= sc.MAX_SPLIT * sc.STEPS_PER_SLICE:
        assert longest <= sc.STEPS_PER_SLICE
    if split > 1:
        assert -(-n_k // (split - 1)) > sc.STEPS_PER_SLICE
    return tm, split


@pytest.fixture(scope="module")
def resnet50_layers():
    """(name, M, ob, K) of the 47 sparse convs of a 224 px request."""
    cfg = get_config("resnet50")
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    out = []
    for node in fused_graph_for(cfg.name).nodes:
        w = params.get(conv_part(node).name, {}).get("w") \
            if node.kind == "conv" else None
        if isinstance(w, SparseWeight):
            ob, n_k = w.vals.shape[:2]
            out.append((node.name, node.conv_out_hw ** 2, ob, n_k))
    assert len(out) == 47
    return out


def test_plan_at_every_resnet50_layer(resnet50_layers):
    """Every layer gets a valid grid, every layer with K >= 5 is split,
    and none walks more than 3 steps a block."""
    for name, m, ob, n_k in resnet50_layers:
        tm, split = _check_conv_plan(m, ob, n_k)
        if n_k >= 5:
            assert split > 1, name
    plans = {name: sc.plan(m, ob, n_k)
             for name, m, ob, n_k in resnet50_layers}
    assert plans["s3b0_c2"] == (32, 8)      # M 49, ob 16, K 22
    assert plans["s2b0_c2"] == (32, 4)      # M 196, ob 8, K 11
    assert plans["s3b1_c1"] == (32, 4)      # K 10
    assert plans["s0b1_c1"] == (32, 1)      # K 1


@pytest.mark.parametrize("m,ob,n_k", [
    (1, 1, 1), (1, 1, 0), (5, 3, 7), (25, 3, 13), (49, 2, 14), (98, 2, 11),
    (121, 3, 1), (17, 1, 100), (3136, 2, 3), (100000, 1, 2), (7, 200, 9),
])
def test_plan_at_odd_shapes(m, ob, n_k):
    _check_conv_plan(m, ob, n_k)


@pytest.mark.parametrize("ob,n_k,bm,bn", [
    (40, 10, 32, 25),      # the ResNet-50 classifier
    (40, 2, 64, 64),       # SmolLM-360M's w1 / w3
    (15, 6, 64, 64),       # and w2
    (1, 1, 8, 8), (3, 5, 16, 25), (200, 3, 3, 7), (1, 40, 64, 64),
    (5, 1, 5, 3),
])
def test_gemv_grid_covers_every_output_once(ob, n_k, bm, bn):
    """Every output column in exactly one block, every weight row in
    exactly one thread of it, at least ~100 blocks at the main-path
    shapes."""
    gx, gy = sm.gemv_grid(ob, bn)
    assert gy == ob and 1 <= ob <= 65535 and 1 <= gx <= 8
    cols = [c for b in range(gx) for c in range(b * sm.GEMV_COLS,
                                                min(bn, (b + 1)
                                                    * sm.GEMV_COLS))]
    assert cols == list(range(bn))
    rows = n_k * bm
    nt = sm.gemv_threads(rows, bn)
    assert nt in (64, 128, 256)
    owners = sorted(r for t in range(nt) for r in range(t, rows, nt))
    assert owners == list(range(rows))
    if (ob, n_k, bm) in ((40, 10, 32), (40, 2, 64), (15, 6, 64)):
        assert gx * gy >= 100


def _conv_split_emulation(x, vals, idx, bias, residual, *, k, stride, relu,
                          split):
    """The mma variant's sums: each rank's K slice through the plain
    version without its epilogue (f32 x, zero bias, no ReLU, so nothing
    rounds), the partials summed in rank order, then bias, residual and
    ReLU in f32 and one round to bf16."""
    acc = None
    zero = torch.zeros_like(bias, dtype=torch.float32)
    for lo, hi in sc.k_slices(vals.shape[1], split):
        part = sc.sparse_conv_torch(x.float(), vals[:, lo:hi].contiguous(),
                                    idx[:, lo:hi].contiguous(), zero, k=k,
                                    stride=stride, relu=False)
        acc = part if acc is None else acc + part
    y = acc + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@pytest.mark.parametrize("split", [2, 3, 8])
@pytest.mark.parametrize("case", [
    (7, 1, 96, 64, 32, 32, 3, 1, True),    # K 13, a 7 x 7 stage
    (9, 2, 64, 48, 16, 16, 3, 2, False),   # batch 2, stride 2
    (6, 1, 256, 64, 32, 32, 1, 1, True),   # 1x1, K 4
], ids=["h7k3", "n2s2", "k1"])
def test_conv_split_emulation_matches_plain_and_reference(case, split):
    h, n, cin, cout, bm, bn, k, stride, residual = case
    rng = np.random.default_rng([h, cin, split])
    rsw, sw = _sparse(rng, k * k * cin, cout, bm, bn, 0.5)
    ho = -(-h // stride)
    split = min(split, sw.vals.shape[1])
    assert split > 1
    x = _bf16(rng.normal(size=(n, h, h, cin)))
    b = _bf16(rng.normal(size=(cout,)) * 0.1)
    res = _bf16(rng.normal(size=(n, ho, ho, cout))) if residual else None
    tres = None if res is None else _t(res)
    got = _conv_split_emulation(_t(x), sw.vals, sw.idx, _t(b), tres, k=k,
                                stride=stride, relu=True, split=split)
    assert got.dtype == torch.bfloat16
    _close(got, sc.sparse_conv_torch(_t(x), sw.vals, sw.idx, _t(b), tres,
                                     k=k, stride=stride, relu=True),
           _bf16_tol)
    with ref_ops.config(impl="xla"):
        want = ref_ops.sparse_conv(jnp.asarray(x), rsw, jnp.asarray(b), k=k,
                                   stride=stride, relu=True,
                                   residual=None if res is None
                                   else jnp.asarray(res))
    _close(got, want, _bf16_tol)


def _gemv_emulation(x, vals, idx):
    """The gemv variant's sums: column j's blocks as one (K*bm, bn)
    matrix; thread t's f32 partial over rows t, t + threads, ...; each
    warp's 32 partials summed by the xor butterfly (lane 0: halves added
    pairwise, 16 apart, then 8, ...); the warps' sums in order; one
    round to x's dtype."""
    m, _ = x.shape
    ob, n_k, bm, bn = vals.shape
    rows = n_k * bm
    nt = sm.gemv_threads(rows, bn)
    xg = x.float().reshape(m, -1, bm)[:, idx.long()].reshape(m, ob, rows)
    w = vals.float().reshape(ob, rows, bn)
    pad = -rows % nt
    xg = torch.nn.functional.pad(xg, (0, pad)).reshape(m, ob, -1, nt)
    w = torch.nn.functional.pad(w, (0, 0, 0, pad)).reshape(ob, -1, nt, bn)
    part = torch.zeros((m, ob, nt, bn))
    for u in range(xg.shape[2]):                 # thread t's rows, in order
        part = part + xg[:, :, u, :, None] * w[None, :, u]
    acc = torch.zeros((m, ob, bn))
    for warp in range(nt // 32):
        lanes = part[:, :, warp * 32:(warp + 1) * 32]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes[:, :, :o] + lanes[:, :, o:2 * o]
        acc = acc + lanes[:, :, 0]
    return acc.reshape(m, ob * bn).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("shape", [(256, 100, 32, 25), (256, 128, 64, 64),
                                   (80, 75, 16, 25)],
                         ids=["bn25", "64x64", "odd"])
def test_gemv_emulation_matches_plain_and_reference(shape, m, dtype):
    d_in, d_out, bm, bn = shape
    rng = np.random.default_rng([d_in, d_out, m])
    rsw, sw = _sparse(rng, d_in, d_out, bm, bn, 0.5)
    x = rng.normal(size=(m, d_in)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    tol = _f32_tol if dtype == "float32" else _bf16_tol
    assert sm.variant(getattr(torch, dtype), m, bm, bn) == "gemv"
    got = _gemv_emulation(_t(x), sw.vals, sw.idx)
    assert got.dtype == getattr(torch, dtype)
    _close(got, sm.sparse_matmul_torch(_t(x), sw.vals, sw.idx), tol)
    _close(got, ref_oracles.sparse_matmul_ref(jnp.asarray(x), rsw), tol)


@pytest.mark.parametrize("bm,bn,want", [
    (32, 32, "mma"),       # every ResNet-50 layer
    (16, 16, "mma"),
    (16, 8, "mma"),        # the smallest mma tiles
    (32, 24, "mma"),       # three 8-column tiles
    (8, 8, "simt"),        # bm no multiple of 16
    (32, 25, "simt"),      # bn no multiple of 8
    (64, 32, "mma"),       # bm > 32: walked as two 32-row pieces
    (32, 40, "mma"),       # bn > 32: a ragged 8-column piece
    (128, 128, "mma"),     # SparsityConfig's default blocks
    (48, 32, "mma"),       # a ragged 16-row piece
    (128, 125, "simt"),    # the classifier's blocks at the default
])
def test_sparse_conv_variant_choice(bm, bn, want):
    assert sc.variant(bm, bn) == want
