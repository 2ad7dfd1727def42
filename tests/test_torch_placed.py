"""Placed stage programs on the port (``core/pipeline.ParamFormat``,
``PlacedParams``, ``cnn.stage_programs(placed=True)``) against the
reference's, on the CPU:

- ``ParamFormat`` round-trips leaves of every param dtype at odd byte
  counts bit for bit, lays them out byte for byte as the reference's,
  and refuses what the reference refuses;
- for the three CNNs, native and int8, at 32 px under the reference
  planner's cut, on the same stored weights (the port's, carried to the
  reference bit for bit), every ``PlacedParams`` byte count and the
  bytes of ``pack()`` and ``pack_ragged()`` equal the reference's, and
  the reference's own rows drive the port's placed programs;
- placed == closures BITWISE, through ``pipeline_apply_gspmd_hetero``
  (reference layout, 16-byte-aligned rows, the even buffer's rows) and
  through ``CNNPipelineServer``, the tier and a worker's server;
- the executors take per-stage rows without a mesh and refuse what the
  reference refuses."""
import argparse
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import pipeline as ref_pp  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.core.quant import QuantizedWeight as RefQuantizedWeight  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.layers import SparseWeight as RefSparseWeight  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as pp  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.quant import QuantizedWeight, quantize_tree  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.layers import SparseWeight  # noqa: E402

ARCHS = ["resnet50", "mobilenet_v1", "mobilenet_v2"]
IMAGE = 32
MB = (2, IMAGE, IMAGE, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, and a full torch thread pool in each oversubscribes the
    cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(t) -> np.ndarray:
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t,
                      np.uint8)


def _images(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n,) + MB[1:]).astype(np.float32))


# --- ParamFormat ---------------------------------------------------------------

def _odd_leaves(seed):
    """Leaves of every param dtype at byte counts that are no multiple of
    16 (nor, for some, of 4): numpy, then the reference's and the port's
    trees."""
    rng = np.random.default_rng(seed)
    a = {"a_bf16": rng.normal(size=(3,)).astype(np.float32),
         "b_i32": rng.integers(-2 ** 31, 2 ** 31 - 1, size=(5,),
                               dtype=np.int32),
         "c_i8": rng.integers(-128, 127, size=(7,), dtype=np.int8),
         "d_f32": rng.normal(size=(2, 3)).astype(np.float32),
         "e_u8": rng.integers(0, 255, size=(5,), dtype=np.uint8),
         "f_bf16": rng.normal(size=(3, 3)).astype(np.float32)}
    ref = {k: (jnp.asarray(v).astype(jnp.bfloat16) if "bf16" in k
               else jnp.asarray(v)) for k, v in a.items()}
    port = {}
    for k, v in ref.items():
        if v.dtype == jnp.bfloat16:
            port[k] = torch.from_numpy(np.asarray(v).view(np.int16).copy()
                                       ).view(torch.bfloat16)
        else:
            port[k] = torch.from_numpy(np.asarray(v).copy())
    return ref, port


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_param_format_roundtrips_every_dtype_bitwise():
    ref_tree, tree = _odd_leaves(0)
    ref_fmt = ref_pp.ParamFormat.for_tree(ref_tree)
    fmt = pp.ParamFormat.for_tree(tree)
    assert fmt.nbytes == ref_fmt.nbytes == 6 + 20 + 7 + 24 + 5 + 18
    width = fmt.nbytes + 9
    row = fmt.pack(tree, width)
    assert row.dtype == torch.uint8 and tuple(row.shape) == (width,)
    np.testing.assert_array_equal(_bytes(row),
                                  _bytes(ref_fmt.pack(ref_tree, width)))
    # the reference layout, the 16-byte one, and a row at an odd storage
    # offset (a leaf that cannot be viewed in place is copied)
    big = torch.zeros(width + 3, dtype=torch.uint8)
    big[3:].copy_(row)
    aligned = fmt.pack(tree, fmt.row_bytes(pp.ALIGN), pp.ALIGN)
    assert all(o % 16 == 0 for o in fmt.offsets(pp.ALIGN))
    assert fmt.row_bytes(pp.ALIGN) % 16 == 0
    assert fmt.row_bytes(pp.ALIGN) > fmt.row_bytes() == fmt.nbytes
    for got in (fmt.unpack(row), fmt.unpack(big[3:]),
                fmt.unpack(aligned, pp.ALIGN)):
        assert got.keys() == tree.keys()
        for k, t in tree.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape
            np.testing.assert_array_equal(_bits(got[k]), _bits(t))
    # in place where the offset allows: every leaf of the aligned row is
    # a view into it
    ptr = aligned.data_ptr()
    views = fmt.unpack(aligned, pp.ALIGN)
    for k, off in zip(sorted(tree), fmt.offsets(pp.ALIGN)):
        assert views[k].data_ptr() == ptr + off


@pytest.mark.parametrize("case", ["bool", "count", "width", "mismatch"])
def test_param_format_refuses_what_the_reference_refuses(case):
    ref_tree, tree = _odd_leaves(1)
    if case == "bool":
        for mod, t in ((ref_pp, {"m": jnp.zeros(3, bool)}),
                       (pp, {"m": torch.zeros(3, dtype=torch.bool)})):
            with pytest.raises(ValueError, match="unsupported param leaf"):
                mod.ParamFormat.for_tree(t)
        return
    calls = []
    for mod, t in ((ref_pp, ref_tree), (pp, tree)):
        fmt = mod.ParamFormat.for_tree(t)
        if case == "count":
            t = {k: v for k, v in t.items() if k != "c_i8"}
            calls.append((fmt, t, fmt.nbytes, "expected 6 leaves"))
        elif case == "width":
            calls.append((fmt, t, fmt.nbytes - 1, "param width"))
        else:
            t = dict(t)
            t["d_f32"] = t["d_f32"].reshape(3, 2)
            calls.append((fmt, t, fmt.nbytes, "leaf mismatch"))
    for fmt, t, width, match in calls:
        with pytest.raises(ValueError, match=match):
            fmt.pack(t, width)


# --- PlacedParams against the reference's -------------------------------------

@functools.lru_cache(maxsize=None)
def _port_weights(arch):
    """The port's own seed-0 weights, native, on the CPU."""
    return port_serve._init_native(get_config(arch), 0)


def _ref_array(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _ref_stored(params):
    """The port's stored tree as the reference's, bit for bit (the
    quantizers agree bit for bit, tests/test_torch_quant.py; the
    reference's eager int8 quantizer takes 10-20 s a net here, and under
    ``jax.jit`` XLA rounds some codes otherwise)."""
    def leaf(w):
        if isinstance(w, SparseWeight):
            return RefSparseWeight(
                _ref_array(w.vals), _ref_array(w.idx), w.d_in,
                scale=None if w.scale is None else _ref_array(w.scale),
                orig_dtype=w.orig_dtype)
        if isinstance(w, QuantizedWeight):
            return RefQuantizedWeight(_ref_array(w.codes),
                                      _ref_array(w.scale), w.orig_dtype)
        return _ref_array(w)
    return {n: {k: leaf(v) for k, v in p.items()} for n, p in params.items()}


def _placed(arch, quantize):
    """The reference's and the port's PlacedParams for the same stored
    weights (the port's seed-0 init carried across bit for bit) under the
    reference planner's 4-stage cut."""
    params = _port_weights(arch)
    ref_cfg = ref_get_config(arch)
    plan = ref_planner.plan(ref_cfg, _ref_stored(params),
                            ref_planner.PlanRequest(n_stages=4,
                                                    store_dtype=quantize))
    ref = ref_cnn.stage_programs(
        ref_cfg, _ref_stored(quantize_tree(params, quantize)),
        plan["stage_of"], MB, placed=True, quantize=quantize)[4]
    port = cnn.stage_programs(get_config(arch), params, plan["stage_of"],
                              MB, placed=True, quantize=quantize)
    return plan["stage_of"], ref, port


@pytest.mark.parametrize("quantize", ["native", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_params_bytes_equal_the_references(arch, quantize):
    """Every accounting property, and the bytes of the even buffer and of
    the ragged rows, equal the reference's; the reference's own ragged
    rows, handed to the port's placed programs, give the port's closure
    logits bitwise."""
    stage_of, rp, (pfns, pack_in, unpack_out, _, got) = _placed(arch,
                                                                quantize)
    for prop in ("stage_bytes", "stage_widths", "replicated_bytes",
                 "padded_buffer_bytes", "padding_bytes", "width"):
        assert getattr(got, prop) == getattr(rp, prop), prop
    assert got.align == 1 and got.row_widths == got.stage_widths
    assert got.align_bytes == 0 and got.buffer_width == got.width
    for f, rf in zip(got.formats, rp.formats):
        assert [s for s, _ in f.leaves_meta] == \
            [tuple(s) for s, _ in rf.leaves_meta]
    ref_buf, ref_rows = jax.jit(lambda trees: (
        dataclasses.replace(rp, trees=trees).pack(),
        dataclasses.replace(rp, trees=trees).pack_ragged()))(rp.trees)
    buf = got.pack()
    assert tuple(buf.shape) == tuple(ref_buf.shape) == (4, rp.width)
    np.testing.assert_array_equal(_bytes(buf), _bytes(ref_buf))
    rows = got.pack_ragged()
    assert len(rows) == len(ref_rows) == 4
    for row, ref_row in zip(rows, ref_rows):
        np.testing.assert_array_equal(_bytes(row), _bytes(ref_row))
    # the reference's bytes drive the port's placed programs
    fns = cnn.stage_programs(get_config(arch), _port_weights(arch), stage_of,
                             MB,
                             quantize=quantize)[0]
    x = _images(2, 3)
    want = pack_in(x)
    for fn in fns:
        want = fn(want)
    wire = pack_in(x)
    for fn, row in zip(pfns, ref_rows):
        wire = fn(torch.from_numpy(_bytes(row).copy()), wire)
    assert torch.equal(unpack_out(wire), unpack_out(want))


# --- placed == closures, bitwise ------------------------------------------------

@pytest.mark.parametrize("quantize", ["native", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_equals_closures_bitwise_through_the_executor(arch, quantize):
    """Four microbatches through the 4-stage batch executor: the closure
    programs, and the placed programs on the reference layout's rows,
    the 16-byte-aligned rows and the rows of the even buffers, give the
    same wires bit for bit, and the logits of the sequential forward."""
    cfg, params = get_config(arch), _port_weights(arch)
    stage_of = planner.plan(cfg, params, planner.PlanRequest(
        n_stages=4, store_dtype=quantize))["stage_of"]
    fns, pack_in, unpack_out, _ = cnn.stage_programs(
        cfg, params, stage_of, MB, quantize=quantize)
    pfns, _, _, _, placed = cnn.stage_programs(
        cfg, params, stage_of, MB, placed=True, quantize=quantize)
    afns, _, _, _, aligned = cnn.stage_programs(
        cfg, params, stage_of, MB, placed=True, quantize=quantize,
        align=pp.ALIGN)
    x = _images(8, 4)
    wires = torch.stack([pack_in(x[i:i + 2]) for i in range(0, 8, 2)])
    want = pp.pipeline_apply_gspmd_hetero(fns, wires, n_stages=4)
    assert aligned.stage_bytes == placed.stage_bytes
    assert all(w % 16 == 0 for w in aligned.row_widths)
    assert aligned.align_bytes == sum(aligned.row_widths) - sum(
        placed.stage_bytes) >= 0
    assert aligned.buffer_width % 16 == 0
    for fns_, rows in ((pfns, placed.pack_ragged()),
                       (pfns, tuple(placed.pack())),
                       (afns, aligned.pack_ragged()),
                       (afns, list(aligned.pack()))):
        got = pp.pipeline_apply_gspmd_hetero(fns_, wires, n_stages=4,
                                             stage_params=rows)
        assert torch.equal(got, want)
    seq = cnn.cnn_forward(cfg, quantize_tree(params, quantize), x,
                          device="cpu")
    assert torch.equal(torch.cat([unpack_out(w) for w in want]), seq)


@pytest.mark.parametrize("quantize", ["native", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_server_on_rows_equals_closures_bitwise(arch, quantize):
    """``CNNPipelineServer`` on its packed rows (the default), on
    closures, and with ``placed=True`` at S = 1 (the even buffer's row):
    the same logits bit for bit, each the sequential forward's."""
    cfg, params = get_config(arch), _port_weights(arch)
    reqs = [_images(3, 5).numpy(), _images(2, 6).numpy()]
    kw = dict(mb_size=2, image_size=IMAGE, device="cpu", params=params,
              quantize=quantize)
    out = {}
    for name, extra in (("rows", dict(n_stages=3)),
                        ("closures", dict(n_stages=3, closures=True)),
                        ("even", dict(n_stages=1, placed=True))):
        srv = port_serve.CNNPipelineServer(arch, **kw, **extra)
        if name == "closures":
            assert srv.param_rows is None and srv.pparams is None
        else:
            assert srv.pparams is not None and srv.pparams.align == pp.ALIGN
            assert len(srv.param_rows) == srv.n_stages
            assert srv.placed == (name == "even")
            assert (srv.param_buffer is not None) == (name == "even")
        ids = [srv.submit(x) for x in reqs]
        srv.run()
        out[name] = [srv.results(i) for i in ids]
    stored = quantize_tree(params, quantize)
    for i, x in enumerate(reqs):
        seq = np.concatenate([cnn.cnn_forward(
            cfg, stored, torch.from_numpy(x[j:j + 2]), device="cpu").numpy()
            for j in range(0, len(x), 2)])
        for name in out:
            np.testing.assert_array_equal(out[name][i], seq, err_msg=name)


def test_tier_replicas_share_one_set_of_rows():
    """The in-process tier packs the rows once: both replicas run placed
    programs over the same row tensors, and the tier keeps no device
    copy of the weights beside them."""
    from repro_torch.runtime.tier import ServingTier
    tier = ServingTier("mobilenet_v1", n_replicas=2, n_stages=2, mb_size=2,
                       image_size=IMAGE, device="cpu")
    a, b = (w.server for w in tier.workers)
    assert a.param_rows is b.param_rows is tier.param_rows
    assert len(tier.param_rows) == 2
    assert a.pparams.stage_bytes == b.pparams.stage_bytes
    rid = tier.submit(_images(4, 7).numpy())
    tier.run()
    got = tier.results(rid)
    want = cnn.cnn_forward(get_config("mobilenet_v1"), tier.params,
                           _images(4, 7)[:2], device="cpu").numpy()
    np.testing.assert_array_equal(got[:2], want)


def test_worker_builds_its_rows_from_the_param_blob(tmp_path):
    """A replica worker's server packs its rows from the blob it read."""
    from repro_torch.runtime import worker
    cfg = get_config("mobilenet_v2")
    stored = quantize_tree(port_serve._init_native(cfg, 0), "int8")
    path = worker.write_param_blob(stored, str(tmp_path / "p.blob"))
    args = argparse.Namespace(device="cpu", arch="mobilenet_v2", seed=0,
                              quantize="int8", param_blob=path, stages=2,
                              mb_size=2, image_size=IMAGE)
    srv = worker.build_server(args)
    assert srv.pparams is not None and len(srv.param_rows) == 2
    ref_rows = srv.pparams.pack_ragged()
    for row, want in zip(srv.param_rows, ref_rows):
        assert torch.equal(row, want)
    x = _images(2, 8).numpy()
    rid = srv.submit(x)
    srv.run()
    np.testing.assert_array_equal(srv.results(rid), cnn.cnn_forward(
        cfg, stored, torch.from_numpy(x), device="cpu").numpy())


# --- the executors' param rules ----------------------------------------------

def _ref_fns(n):
    return [lambda row, w, k=k: w * (k + 1) + row.astype(jnp.float32).sum()
            for k in range(n)]


def _port_fns(n):
    def fn(row, w, out=None, k=0):
        return out.copy_(w * (k + 1) + row.float().sum())
    return [functools.partial(fn, k=k) for k in range(n)]


def test_executors_take_rows_without_a_mesh_as_the_reference():
    """Stage k gets row k: the batch executor and the tick with ragged
    rows give the reference's wires."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 2, 5)).astype(np.float32)
    rows = [rng.integers(0, 255, size=(w,), dtype=np.uint8)
            for w in (3, 8, 1)]
    want = ref_pp.pipeline_apply_gspmd_hetero(
        _ref_fns(3), jnp.asarray(x), n_stages=3,
        stage_params=tuple(jnp.asarray(r) for r in rows))
    got = pp.pipeline_apply_gspmd_hetero(
        _port_fns(3), torch.from_numpy(x), n_stages=3,
        stage_params=[torch.from_numpy(r) for r in rows])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    state = rng.normal(size=(3, 2, 5)).astype(np.float32)
    ref_next, ref_emit = ref_pp.pipeline_step_hetero(
        _ref_fns(3), jnp.asarray(state), jnp.asarray(x[0]), n_stages=3,
        stage_params=tuple(jnp.asarray(r) for r in rows))
    nxt, emit = pp.pipeline_step_hetero(
        _port_fns(3), torch.from_numpy(state), torch.from_numpy(x[0]),
        n_stages=3, stage_params=tuple(torch.from_numpy(r) for r in rows))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_next))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(ref_emit))


@pytest.mark.parametrize("case", ["even-buffer", "row-count", "fn-count",
                                  "mesh"])
def test_executors_refuse_what_the_reference_refuses(case):
    x = np.zeros((2, 2, 4), np.float32)
    n_fns, params = 2, None
    if case == "even-buffer":
        params = np.zeros((2, 8), np.uint8)
    elif case == "row-count":
        params = [np.zeros((8,), np.uint8)]
    elif case == "fn-count":
        n_fns = 3
    if case == "mesh":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 9, second half"):
            pp.pipeline_apply_gspmd_hetero(_port_fns(2), torch.from_numpy(x),
                                           n_stages=2, mesh=object())
        return

    def port_p(p):
        if isinstance(p, list):
            return [torch.from_numpy(r) for r in p]
        return None if p is None else torch.from_numpy(p)

    def ref_p(p):
        if isinstance(p, list):
            return tuple(jnp.asarray(r) for r in p)
        return None if p is None else jnp.asarray(p)

    with pytest.raises(ValueError) as ref_err:
        ref_pp.pipeline_apply_gspmd_hetero(_ref_fns(n_fns), jnp.asarray(x),
                                           n_stages=2,
                                           stage_params=ref_p(params))
    for call in (
            lambda: pp.pipeline_apply_gspmd_hetero(
                _port_fns(n_fns), torch.from_numpy(x), n_stages=2,
                stage_params=port_p(params)),
            lambda: pp.pipeline_step_hetero(
                _port_fns(n_fns), torch.from_numpy(x), None, n_stages=2,
                stage_params=port_p(params))):
        with pytest.raises(ValueError) as err:
            call()
        # the reference's message, up to the axis it names
        assert str(err.value).split(" with a ")[0] == \
            str(ref_err.value).split(" with a ")[0]


def test_serve_placed_needs_a_device_per_stage_replica():
    """``placed=True`` on one device: S = R = 1 runs the even buffer,
    S x R > 1 raises the reference's error; ``placed=None`` runs it at
    S = R = 1 (as the reference places there) and the logits equal the
    closures'."""
    kw = dict(batch=4, n_microbatches=2, image_size=IMAGE, iters=1,
              verbose=False, device="cpu")
    with pytest.raises(ValueError, match="placed=True needs >= 2 devices"):
        port_serve._serve_cnn("mobilenet_v2", n_stages=1, n_replicas=2,
                              placed=True, **kw)
    out = {p: port_serve._serve_cnn("mobilenet_v2", n_stages=1, placed=p,
                                    **kw) for p in (None, False, True)}
    assert (out[None]["placed"], out[False]["placed"],
            out[True]["placed"]) == (True, False, True)
    for p in (None, True):
        np.testing.assert_array_equal(out[p]["logits"], out[False]["logits"])
    assert out[True]["param_bytes_placed_per_device"] == \
        out[True]["param_bytes_replicated_per_device"]
