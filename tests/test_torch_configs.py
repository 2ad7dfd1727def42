"""The port's configuration helpers against the JAX reference's
(``src/repro/configs/base.py``): every registered arch key for key, the
shapes, ``reduced()``, and the analytic counts and applicability rules
over the whole (arch x shape) grid, exactly equal."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro_torch.configs import base  # noqa: E402

ARCHS = sorted(ref_base.all_configs())
SHAPES = sorted(ref_base.SHAPES) + sorted(ref_base.CNN_SHAPES)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_all_configs_match_reference_key_for_key():
    port, ref = base.all_configs(), ref_base.all_configs()
    assert len(port) == 13 and list(port) == list(ref)
    for name in ref:
        assert _fields(port[name]) == _fields(ref[name]), name
    assert [f.name for f in dataclasses.fields(base.ModelConfig)] == \
        [f.name for f in dataclasses.fields(ref_base.ModelConfig)]
    assert [f.name for f in dataclasses.fields(base.SparsityConfig)] == \
        [f.name for f in dataclasses.fields(ref_base.SparsityConfig)]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_matches_reference(arch):
    port = base.reduced(base.get_config(arch))
    ref = ref_base.reduced(ref_base.get_config(arch))
    assert _fields(port) == _fields(ref)
    assert (port.kv_heads, port.head_dim) == (ref.kv_heads, ref.head_dim)


def test_shapes_match_reference():
    for port, ref in ((base.SHAPES, ref_base.SHAPES),
                      (base.CNN_SHAPES, ref_base.CNN_SHAPES)):
        assert list(port) == list(ref)
        for name in ref:
            assert _fields(port[name]) == _fields(ref[name])
            assert port[name].is_decode == ref[name].is_decode


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_applicability_match_reference(arch, shape):
    """n_params, n_active_params, sub_quadratic and applicable, equal for
    every arch x shape cell (full size and reduced)."""
    shapes = {**ref_base.SHAPES, **ref_base.CNN_SHAPES}
    port_shapes = {**base.SHAPES, **base.CNN_SHAPES}
    for size in ("full", "reduced"):
        port = base.get_config(arch)
        ref = ref_base.get_config(arch)
        if size == "reduced":
            port, ref = base.reduced(port), ref_base.reduced(ref)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()
        assert port.sub_quadratic() == ref.sub_quadratic()
        assert base.applicable(port, port_shapes[shape]) == \
            ref_base.applicable(ref, shapes[shape])


def test_the_large_dense_lms_at_their_published_widths():
    """128-wide heads, GQA 8 / 8 / MQA 1, qk_norm for Qwen3, rope 1e6 for
    Qwen3 and Mistral-Nemo; 128 x 128 FFN blocks, 85% pruned."""
    want = {"mistral-nemo-12b": (40, 5120, 32, 8, False, 1e6),
            "qwen3-32b": (64, 5120, 64, 8, True, 1e6),
            "granite-20b": (52, 6144, 48, 1, False, 1e4)}
    for name, (n_l, d, h, kv, qk, theta) in want.items():
        cfg = base.get_config(name)
        assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
                cfg.kv_heads, cfg.head_dim, cfg.qk_norm, cfg.rope_theta) == \
            ("dense", n_l, d, h, kv, 128, qk, theta)
        assert (cfg.sparsity.enabled, cfg.sparsity.block_m,
                cfg.sparsity.block_n, cfg.sparsity.sparsity) == \
            (True, 128, 128, 0.85)


def test_unknown_arch_raises_keyerror():
    with pytest.raises(KeyError, match="unknown arch"):
        base.get_config("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        ref_base.get_config("no-such-arch")


def test_unported_families_name_their_roadmap_item():
    """Every LM family of the registry is ported: none is left to name
    a ROADMAP item, and the model code takes each."""
    from repro_torch.models import lm
    families = {c.family for c in base.all_configs().values()}
    assert families - {"cnn"} == set(lm.BLOCK_KINDS)
    assert base.UNPORTED_LM_FAMILIES == {}
