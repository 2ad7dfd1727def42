"""The port's dense LMs (``reduced(smollm-360m)``, and reduced
``qwen3-32b``, ``mistral-nemo-12b`` and ``granite-20b``) against the JAX
reference on the CPU, on the reference's own weights carried across
with ``lm.params_from_numpy``: configs, the weight bridge, each layer,
the prefill forward, decode steps, a multi-token step into a KV cache
(the reference's ``kv_len`` branch), forward-vs-decode consistency and
``serve_lm``.

Bars. The two frameworks do the same f32 sums and bf16 rounds in other
orders, so a bf16 activation may round the other way and later layers
carry it on: the LM outputs are held to 1e-2 of max |logit| (the
reference's own forward-vs-decode bar is 0.02). The prefill attention
differs by design as well: the port computes what the reference's
Pallas flash kernel computes (p in f32), the reference's
``blockwise_attention``, which its ``attention`` calls, rounds p to bf16.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve, serve_lm  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402
from repro_torch.models.layers import tensor_from_numpy as _t  # noqa: E402

ARCH = "smollm-360m"
LOGIT_RTOL = 1e-2


def _numpy_tree(tree):
    """A reference parameter tree as numpy, sparse weights as dicts."""
    if isinstance(tree, ref_layers.SparseWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "d_in": tree.d_in}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


#: the large dense LMs, reduced: 128-wide heads at full size, GQA 8 / 8 /
#: MQA 1 (2 / 2 / 1 reduced), qk_norm for Qwen3
LARGE = ["qwen3-32b", "mistral-nemo-12b", "granite-20b"]


@functools.lru_cache(maxsize=None)
def _model(tie_embeddings: bool = True, arch: str = ARCH):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg, cfg = (dataclasses.replace(reduced_(get(arch)),
                                     tie_embeddings=tie_embeddings)
                 for reduced_, get in ((ref_reduced, ref_get_config),
                                       (reduced, get_config)))
    rparams = jax.jit(lambda k: ref_lm.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    params = lm.params_from_numpy(_numpy_tree(rparams), device="cpu")
    return rcfg, cfg, rparams, params


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


def _cast(a, dtype="bfloat16"):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(
        getattr(jnp, dtype)))


def _within(got, want, rtol=LOGIT_RTOL):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err
    return err


def _layer0(rparams, params):
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"])
    return rp, lm._layer(params["blocks"], 0)


def _check_config_fields(arch, size):
    ref, port = ref_get_config(arch), get_config(arch)
    if size == "reduced":
        ref, port = ref_reduced(ref), reduced(port)
    ref_fields = {f.name: f for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if f.name == "sparsity":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    # the reference's fields the port leaves out (other families) are at
    # their defaults for this arch: nothing it reads is lost
    for name, f in ref_fields.items():
        if not hasattr(port, name):
            assert getattr(ref, name) == f.default, name
    assert (port.kv_heads, port.head_dim) == (ref.kv_heads, ref.head_dim)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_reference_field_for_field(size):
    _check_config_fields(ARCH, size)


@pytest.mark.parametrize("arch", LARGE)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_large_lm_configs_match_reference_field_for_field(size, arch):
    _check_config_fields(arch, size)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_unported_lm_archs_name_their_roadmap_item(arch):
    """Every arch is registered, as in the reference; a family whose
    model code is not ported raises where that code would run, naming
    its ROADMAP item."""
    cfg = get_config(arch)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1, the rest of the LM side "
                             r"\(item 8d"):
        lm.init_params(cfg, torch.Generator())


def _port_leaves(tree, path=()):
    """{path: tensor} of a port tree; a SparseWeight gives vals and idx."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    if isinstance(tree, SparseWeight):
        return {path + ("vals",): tree.vals, path + ("idx",): tree.idx}
    return {path: tree}


def _ref_leaves(tree):
    """{path: numpy array} of a reference tree, keyed as _port_leaves (a
    SparseWeight's children 0 and 1 are its vals and idx)."""
    def name(k):
        k = k.key
        return ("vals", "idx")[k] if isinstance(k, int) else k
    return {tuple(map(name, path)): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_params_from_numpy_round_trips_bit_for_bit():
    _check_round_trip(ARCH)


@pytest.mark.parametrize("arch", LARGE)
def test_large_lm_params_from_numpy_round_trip_bit_for_bit(arch):
    """The reference's trees, qwen3's q_norm / k_norm and the untied
    heads of the large LMs among them."""
    _check_round_trip(arch)


def _check_round_trip(arch):
    _, cfg, rparams, params = _model(arch=arch)
    port, ref = _port_leaves(params), _ref_leaves(rparams)
    assert (("blocks", "attn", "q_norm") in port) == cfg.qk_norm
    assert ("head" in port) == (not cfg.tie_embeddings)
    assert set(port) == set(ref)
    assert port[("blocks", "ffn", "w1", "vals")].dim() == 5   # (L, ob, K, ..)
    for key, want in ref.items():
        got = port[key]
        assert tuple(got.shape) == want.shape, key
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_has_the_reference_layout():
    _, cfg, rparams, _ = _model()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    port, ref = _port_leaves(params), _ref_leaves(rparams)
    assert set(port) == set(ref)
    for key, want in ref.items():
        assert tuple(port[key].shape) == want.shape, key
        assert str(port[key].dtype).split(".")[1] == want.dtype.name, key
    # block-balanced: every output block column keeps K sorted blocks
    idx = params["blocks"]["ffn"]["w2"].idx
    assert (idx[..., 1:] > idx[..., :-1]).all()


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(5)
    x = _cast(rng.normal(size=(2, 7, 4, 32)))
    gamma = _cast(rng.uniform(0.5, 1.5, 32))
    got = L.rms_norm(_t(x), _t(gamma))
    want = ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(gamma))
    _within(got, want, rtol=2 ** -7)
    pos = np.tile(np.arange(7, dtype=np.int32) + 3, (2, 1))
    got = L.rope(_t(x), torch.from_numpy(pos), 10_000.0)
    assert got.dtype == torch.bfloat16
    _within(got, ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
            rtol=2 ** -7)


def _with_qk_norm(rcfg, cfg, rp, p, rng):
    """Both configs with qk_norm on, and both layers' attention params
    with the same random q/k norm gammas."""
    rcfg, cfg = (dataclasses.replace(c, qk_norm=True) for c in (rcfg, cfg))
    gammas = {n: _cast(rng.uniform(0.5, 1.5, cfg.head_dim))
              for n in ("q_norm", "k_norm")}
    rp = {**rp, "attn": {**rp["attn"], **{n: jnp.asarray(g) for n, g in
                                          gammas.items()}}}
    p = {**p, "attn": {**p["attn"], **{n: _t(g) for n, g in gammas.items()}}}
    return rcfg, cfg, rp, p


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("window", [0, 16])
def test_attention_prefill_matches_reference(window, qk_norm):
    rcfg, cfg, rparams, params = _model()
    rp, p = _layer0(rparams, params)
    rng = np.random.default_rng(6)
    if qk_norm:
        rcfg, cfg, rp, p = _with_qk_norm(rcfg, cfg, rp, p, rng)
    x = _cast(rng.normal(size=(2, 40, cfg.d_model)))
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    got, (k, v) = L.attention(p["attn"], cfg, _t(x),
                              positions=torch.from_numpy(pos), window=window)
    want, (rk, rv) = ref_layers.attention(rp["attn"], rcfg, jnp.asarray(x),
                                          positions=jnp.asarray(pos),
                                          window=window)
    assert got.dtype == torch.bfloat16
    _within(got, want)
    # the projections and rope agree to the bit or the last bf16 place
    _within(k, rk, rtol=2 ** -7)
    _within(v, rv, rtol=2 ** -7)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_matches_reference(window, qk_norm):
    rcfg, cfg, rparams, params = _model()
    rp, p = _layer0(rparams, params)
    rng = np.random.default_rng(7)
    if qk_norm:
        rcfg, cfg, rp, p = _with_qk_norm(rcfg, cfg, rp, p, rng)
    s = 16
    ck = _cast(rng.normal(size=(2, s, cfg.kv_heads, cfg.head_dim)))
    cv = _cast(rng.normal(size=(2, s, cfg.kv_heads, cfg.head_dim)))
    x = _cast(rng.normal(size=(2, 1, cfg.d_model)))
    pos = np.full((2, 1), 9, np.int32)
    cache = (_t(ck), _t(cv))
    got, (nk, nv) = L.attention(p["attn"], cfg, _t(x),
                                positions=torch.from_numpy(pos),
                                window=window, kv_cache=cache, cache_pos=9)
    assert nk is cache[0]                     # written in place
    want, (rk, rv) = ref_layers.attention(
        rp["attn"], rcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        window=window, kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_pos=jnp.int32(9))
    _within(got, want)
    _within(nk, rk, rtol=2 ** -7)
    _within(nv, rv, rtol=2 ** -7)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
@pytest.mark.parametrize("cache_pos,t", [(0, 7), (4, 7), (9, 2), (3, 13)])
def test_multi_token_step_into_a_cache_matches_reference(cache_pos, t,
                                                         causal, window,
                                                         qk_norm):
    """The reference's ``kv_len`` branch: t tokens (1 < t < S) written
    into a cache of S = 16 rows at ``cache_pos`` and attending over its
    first ``cache_pos + t`` rows, at cache_pos 0 and > 0, causal,
    windowed and not causal. The port attends through the flash kernel
    (p in f32), the reference through its XLA ``blockwise_attention`` (p
    rounded to bf16): the output is held to the prefill's bar, 1e-2 of
    max |out|; the cache rows to 1 bf16 ulp (the same projections and
    rope), the rows outside the chunk untouched."""
    rcfg, cfg, rparams, params = _model()
    rp, p = _layer0(rparams, params)
    rng = np.random.default_rng([cache_pos, t, window, int(causal)])
    if qk_norm:
        rcfg, cfg, rp, p = _with_qk_norm(rcfg, cfg, rp, p, rng)
    s = 16
    ck = _cast(rng.normal(size=(2, s, cfg.kv_heads, cfg.head_dim)))
    cv = _cast(rng.normal(size=(2, s, cfg.kv_heads, cfg.head_dim)))
    x = _cast(rng.normal(size=(2, t, cfg.d_model)))
    pos = np.tile(np.arange(cache_pos, cache_pos + t, dtype=np.int32), (2, 1))
    cache = (_t(ck), _t(cv))
    ops.reset_launches()
    got, (nk, nv) = L.attention(p["attn"], cfg, _t(x),
                                positions=torch.from_numpy(pos),
                                causal=causal, window=window, kv_cache=cache,
                                cache_pos=cache_pos)
    assert nk is cache[0] and nv is cache[1]       # written in place
    assert not any(ops.LAUNCHES.values())         # CPU: the plain flash
    want, (rk, rv) = ref_layers.attention(
        rp["attn"], rcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        causal=causal, window=window,
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_pos=jnp.int32(cache_pos))
    assert got.dtype == torch.bfloat16
    _within(got, want)
    _within(nk, rk, rtol=2 ** -7)
    _within(nv, rv, rtol=2 ** -7)
    outside = np.r_[0:cache_pos, cache_pos + t:s]
    np.testing.assert_array_equal(nk[:, outside].view(torch.int16).numpy(),
                                  ck[:, outside].view(np.int16))


@pytest.mark.parametrize("kv,n_rep", [(1, 48), (8, 8), (2, 1)])
def test_repeat_kv_gives_the_flash_kernel_contiguous_heads(kv, n_rep):
    """Granite-20B's one KV head repeated 48 times would be a stride-0
    view after a reshape alone; the CUDA kernel takes contiguous
    tensors only, so the expansion is a copy."""
    k = torch.randn(2, 5, kv, 16)
    out = L._repeat_kv(k, n_rep)
    assert out.is_contiguous() and out.shape == (2, 5, kv * n_rep, 16)
    assert torch.equal(out, k.repeat_interleave(n_rep, dim=2))


def test_multi_token_step_into_a_cache_raises():
    """A chunk that does not fit the cache, and per-row positions for a
    chunk (a one-token step's alone), are refused."""
    _, cfg, _, params = _model()
    p = lm._layer(params["blocks"], 0)
    cache = lm.init_cache(cfg, 1, 8, device="cpu")["kv"][0]
    x = torch.zeros(1, 2, cfg.d_model, dtype=torch.bfloat16)
    for pos in (7, -1, torch.tensor([0])):
        with pytest.raises(ValueError, match="one int cache_pos"):
            L.attention(p["attn"], cfg, x,
                        positions=torch.zeros(1, 2, dtype=torch.long),
                        kv_cache=(cache[0], cache[1]), cache_pos=pos)


def test_decode_step_refuses_a_multi_token_step():
    """The reference's ``decode_step`` broadcasts one position over all T
    tokens (ropes each at pos); the port refuses T > 1 and points at
    ``prefill_chunk``, which places them at pos .. pos + T - 1."""
    _, cfg, _, params = _model()
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="one token a row"):
        lm.decode_step(cfg, params, cache, torch.zeros(1, 3, dtype=torch.long),
                       0)
    with pytest.raises(ValueError, match="one position a row"):
        lm.decode_step(cfg, params, cache, torch.zeros(1, 1, dtype=torch.long),
                       torch.tensor([0, 1]))


@pytest.mark.parametrize("arch", [ARCH, "qwen3-32b"])
def test_prefill_in_chunks_matches_the_one_shot_prefill(arch):
    """The prompt in chunks through the cache (``prefill_chunk``) gives
    the one-shot forward's logits, and the reference forward's within
    the bar; the cache rows equal the reference decode loop's."""
    rcfg, cfg, rparams, params = _model(arch=arch)
    toks = _tokens(21, 2, 14, cfg.vocab_size)
    full, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for a, b in ((0, 5), (5, 6), (6, 14)):
        lg, cache = lm.prefill_chunk(cfg, params, cache,
                                     torch.from_numpy(toks[:, a:b]), a)
        assert lg.shape == (2, b - a, cfg.vocab_size)
        outs.append(lg)
    chunked = torch.cat(outs, 1)
    torch.testing.assert_close(chunked, full, rtol=0, atol=1e-2 * float(
        full.abs().max()))
    want, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    _within(chunked, want)
    step = jax.jit(lambda p, c, tk, i: ref_lm.decode_step(rcfg, p, c, tk, i))
    rcache = ref_lm.init_cache(rcfg, 2, 16)
    for i in range(14):
        _, rcache = step(rparams, rcache, jnp.asarray(toks[:, i:i + 1]),
                         jnp.int32(i))
    _within(cache["kv"], rcache["kv"])


@pytest.mark.parametrize("sparse", [True, False])
def test_ffn_matches_reference(sparse):
    _, cfg, rparams, params = _model()
    rp, p = _layer0(rparams, params)
    if not sparse:     # the reference's dense FFN, carried across
        rp = {"ffn": ref_layers.init_ffn(jax.random.PRNGKey(3), cfg.d_model,
                                         cfg.d_ff)}
        p = lm.params_from_numpy(_numpy_tree(rp), device="cpu")
    assert isinstance(p["ffn"]["w1"], SparseWeight) == sparse
    x = _cast(np.random.default_rng(8).normal(size=(2, 40, cfg.d_model)))
    got = L.ffn(p["ffn"], _t(x))
    assert got.dtype == torch.bfloat16
    _within(got, ref_layers.ffn(rp["ffn"], jnp.asarray(x)))


@pytest.mark.parametrize("t,tie", [(40, True), (1, True), (40, False)])
def test_forward_matches_reference(t, tie):
    """T = 40 is no multiple of the flash tiles (64) nor of the
    reference's blockwise tiles; untied embeddings add the head."""
    rcfg, cfg, rparams, params = _model(tie)
    assert ("head" in params) == (not tie)
    toks = _tokens(t, 2, t, cfg.vocab_size)
    got, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    want, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _within(got, want)
    # the last position's logits, the (B, 1, d) x (d, V) product summed
    # in another blocking than the (B, T, d) one
    last = make_prefill_step(cfg)(params, torch.from_numpy(toks))
    torch.testing.assert_close(last, got[:, -1], rtol=1e-5, atol=1e-5)
    hidden, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                           logits_mode="hidden")
    assert hidden.shape == (2, t, cfg.d_model)
    assert hidden.dtype == torch.bfloat16


def test_decode_steps_match_reference():
    rcfg, cfg, rparams, params = _model()
    toks = _tokens(11, 2, 10, cfg.vocab_size)
    step = jax.jit(lambda p, c, tk, i: ref_lm.decode_step(rcfg, p, c, tk, i))
    rcache = ref_lm.init_cache(rcfg, 2, 16)
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    decode = make_decode_step(cfg)
    for i in range(10):
        want, rcache = step(rparams, rcache, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
        got, cache = decode(params, cache, torch.from_numpy(toks[:, i:i + 1]),
                            i)
        assert got.shape == (2, 1, cfg.vocab_size)
        _within(got, want)
    _within(cache["kv"], rcache["kv"])


@pytest.mark.parametrize("arch", LARGE)
def test_large_lm_forward_and_decode_match_reference(arch):
    """Reduced Qwen3-32B (qk_norm, rope 1e6), Mistral-Nemo-12B (rope 1e6)
    and Granite-20B (MQA): the prefill forward and decode steps against
    the reference's, within the bar."""
    rcfg, cfg, rparams, params = _model(arch=arch)
    assert cfg.head_dim == 32 and (cfg.qk_norm, cfg.rope_theta) == (
        rcfg.qk_norm, rcfg.rope_theta)
    toks = _tokens(31, 2, 10, cfg.vocab_size)
    got, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    want, _ = ref_lm.forward(rcfg, rparams, jnp.asarray(toks))
    _within(got, want)
    step = jax.jit(lambda p, c, tk, i: ref_lm.decode_step(rcfg, p, c, tk, i))
    rcache = ref_lm.init_cache(rcfg, 2, 16)
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    for i in range(10):
        want, rcache = step(rparams, rcache, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
        got, cache = lm.decode_step(cfg, params, cache,
                                    torch.from_numpy(toks[:, i:i + 1]), i)
        _within(got, want)
    _within(cache["kv"], rcache["kv"])


def test_forward_matches_own_decode():
    """The reference's contract (tests/test_models.py): token-by-token
    decode reproduces the full forward, rel < 0.02."""
    _, cfg, _, params = _model()
    toks = torch.from_numpy(_tokens(12, 1, 10, cfg.vocab_size))
    full, _ = lm.forward(cfg, params, toks)
    cache = lm.init_cache(cfg, 1, 10, device="cpu")
    outs = []
    for t in range(10):
        lg, cache = lm.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    rel = float((full - dec).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 0.02, rel


def test_serve_lm_matches_reference_decode_loop():
    """Explicit prompts on the reference's weights: the port's greedy
    tokens equal a reference decode loop's, and every step's logits
    (teacher-forced on the port's tokens) are within the bar."""
    rcfg, cfg, rparams, params = _model()
    prompts = _tokens(13, 2, 8, cfg.vocab_size)
    gen = 6
    ops.reset_launches()
    out = serve_lm(ARCH, prompts=prompts, params=params, gen_tokens=gen,
                   max_seq=16, record_logits=True, verbose=False,
                   device="cpu")
    assert not any(ops.LAUNCHES.values())
    assert out["tokens"].shape == (2, gen)
    assert out["logits"].shape == (2, 8 + gen, cfg.vocab_size)
    step = jax.jit(lambda p, c, tk, i: ref_lm.decode_step(rcfg, p, c, tk, i))
    cache = ref_lm.init_cache(rcfg, 2, 16)
    ref_tokens, logits = [], None
    for i in range(8):
        logits, cache = step(rparams, cache, jnp.asarray(prompts[:, i:i + 1]),
                             jnp.int32(i))
        _within(out["logits"][:, i], logits[:, 0])
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        ref_tokens.append(np.asarray(tok)[:, 0])
        logits, cache = step(rparams, cache, tok, jnp.int32(8 + i))
        _within(out["logits"][:, 8 + i], logits[:, 0])
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(out["tokens"], np.stack(ref_tokens, 1))
    np.testing.assert_array_equal(out["prompts"], prompts)


def test_serve_dispatches_an_lm_arch_to_serve_lm():
    out = serve(ServeConfig(arch=ARCH, batch=2, device="cpu", verbose=False))
    assert out["tokens"].shape == (2, 16) and out["device"] == "cpu"
    with pytest.raises(ValueError, match="max_seq"):
        serve_lm(ARCH, prompt_len=100, gen_tokens=40, device="cpu")


@pytest.mark.parametrize("arch", LARGE)
def test_serve_takes_the_large_lms(arch):
    """``serve`` and ``serve_lm`` run the large dense LMs (reduced here;
    ``use_reduced=False`` on the card): greedy tokens from the decode
    path, no kernel launched on the CPU."""
    ops.reset_launches()
    out = serve(ServeConfig(arch=arch, batch=2, device="cpu", verbose=False))
    assert out["tokens"].shape == (2, 16) and out["device"] == "cpu"
    assert not any(ops.LAUNCHES.values())
    cfg = reduced(get_config(arch))
    assert (out["tokens"] >= 0).all() and (out["tokens"] < cfg.vocab_size).all()


@pytest.mark.parametrize("entry", ["serve_lm", "init_cache",
                                   "params_from_numpy"])
def test_lm_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config(ARCH))
    calls = {
        "serve_lm": lambda: serve_lm(ARCH, verbose=False),
        "init_cache": lambda: lm.init_cache(cfg, 1, 8),
        "params_from_numpy": lambda: lm.params_from_numpy({}),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_accum_dtype_scopes_fdot():
    """f64 sums in scope (to measure the sum-order floor), f32 results,
    f32 sums again after it."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((3, 50), generator=gen).to(torch.bfloat16)
    b = torch.randn((50, 4), generator=gen).to(torch.bfloat16)
    with L.accum_dtype(torch.float64):
        got = L.fdot("ij,jk->ik", a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, (a.double() @ b.double()).float())
    assert torch.equal(L.fdot("ij,jk->ik", a, b), a.float() @ b.float())
    with pytest.raises(ValueError, match="f32 or f64"):
        with L.accum_dtype(torch.float16):
            pass
