"""The port's dist path (``simd_dct_tpu_torch.dist``) against the JAX
package's, on the CPU.

A JAX mesh of 4 of the configuration's 8 CPU devices and a port mesh of
4 CPU shards (``devices=["cpu"] * 4``), both with the axis ``data``; the
2-D meshes are (2, 2) over ``("host", "chip")``.  Images are made with
numpy from a seed at H = 16*8*4 = 512, W = 128 (4:2:0 at W = 256), as in
``__graft_entry__.dryrun_multichip``.  The JAX side runs its plain XLA tier
(the sharded functions' CPU path), each call under one ``jax.jit`` (eager
``shard_map`` compiles every primitive apart, several times slower); the
gather kernel's Pallas form is never run here, only the JAX gathers that
need no interpreter.  Tolerances:
  * each sharded result against the JAX sharded function: at most +-1 on
    at most 0.2% of bytes -- the ``compare_backends`` contract (the two
    frameworks' f32 transforms may round a boundary byte apart);
  * each sharded result against the port's own unsharded api call, every
    gather form, the stereo segments, the native layout and
    ``gather=True``: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from simd_dct_tpu import dist as JD
from simd_dct_tpu.dist import collectives as JC
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import dist as TD
from simd_dct_tpu_torch.dist import collectives as TC
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.layout import BASE_CHROMA_QUANT_TABLE
from simd_dct_tpu_torch.utils.debug import compare_backends

H, W, W420 = 16 * 8 * 4, 128, 256
CPU = {"device": "cpu"}
LUT32 = T.default_quant_lut(50) * np.float32(255.0)
LUT_Q = T.default_quant_lut(50)
LUMA = T.default_quant_lut(100) * np.float32(255.0)
CHROMA = BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
GATHERS = ("remote", "auto", "ring", "allgather")


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 4
    return JD.make_mesh(4), TD.make_mesh(4, devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0xD157)
    img = rng.integers(0, 256, (H, W), np.uint8)
    img420 = rng.integers(0, 256, (H, W420), np.uint8)
    return {
        "img": img,
        "frames": rng.integers(0, 256, (8, H, W), np.uint8),
        "planes": np.stack([img, img[::-1], img[:, ::-1]]),
        "planes420": np.stack([img420, img420[::-1], img420[:, ::-1]]),
    }


def _np(x):
    if isinstance(x, TD.Sharded):
        x = x.full()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _contract(port, ref):
    rep = compare_backends({"port": _np(port), "jax": _np(ref)})
    assert all(r["ok"] for r in rep.values()), rep


def _jit(fn, *arrays):
    """A JAX sharded function on numpy inputs, traced and compiled once."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


def _gather(form, seg, mesh, **kw):
    fn = {"remote": TC.gather_planes_remote, "auto": TC.gather_planes_auto,
          "ring": TC.gather_planes_ring,
          "allgather": TC.gather_planes_allgather}[form]
    return fn(seg, mesh, **kw)


# -- meshes -------------------------------------------------------------------

def test_mesh_shapes(meshes):
    _, tm = meshes
    assert tm.shape == {"data": 4} and tm.size == 4
    m2 = TD.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    assert m2.shape == {"host": 2, "chip": 2}
    assert m2.devices.shape == (2, 2) and m2.device_type == "cpu"


@pytest.mark.parametrize("build", ["1d", "2d"])
def test_make_mesh_with_too_few_cards_raises(build):
    """The fault not copied: JAX's make_mesh falls back to virtual CPU
    devices when the platform has too few (simd_dct_tpu/dist/mesh.py:32-36,
    50-53); the port's raises, naming devices=, and never takes the CPU."""
    need = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(ValueError, match="devices="):
        if build == "1d":
            TD.make_mesh(need)
        else:
            TD.make_mesh_2d((1, need))


@pytest.mark.parametrize("given", ["devices", "cards"])
def test_make_mesh_without_a_count_takes_every_device(given, monkeypatch):
    """As the JAX make_mesh (simd_dct_tpu/dist/mesh.py:23, "default: all"):
    with no count the mesh spans every device given, or every card (the
    harness's config 5 shards over every card this way)."""
    if given == "devices":
        mesh = TD.make_mesh(devices=["cpu"] * 3)
        assert mesh.size == 3 and mesh.device_type == "cpu"
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = TD.make_mesh()
    assert mesh.shape == {"data": 4}
    assert [str(d) for d in mesh.devices.flat] == [
        f"cuda:{i}" for i in range(4)]


def test_mixed_cpu_cuda_mesh_raises():
    with pytest.raises(T.InvalidParameterError, match="all CPU or all CUDA"):
        TD.make_mesh(2, devices=["cpu", "cuda:0"])
    with pytest.raises(T.InvalidParameterError):
        TD.mesh.Mesh(np.array(["cuda:0", "cpu"]), ("data",))


def test_initialize_distributed_without_configuration(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert TD.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_plain_selfring_returns_true():
    assert TC.remote_dma_selfring_smoke(device="cpu") is True
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (8, 8, 128), np.uint8))
    out = TC.selfring(x)
    assert out.shape == (8, 16, 128)
    assert torch.equal(out[:, :8], x) and torch.equal(out[:, 8:], x)


def test_sharded_value_helpers(meshes):
    _, tm = meshes
    x = torch.arange(64 * 8 * 3, dtype=torch.int32).reshape(64, 8, 3)
    s = TD.strip_sharding(x, tm, dim=1)
    assert s.spec == (None, "data", None) and s.shards[0].shape == (64, 2, 3)
    assert torch.equal(s.full(), x)
    r = TD.replicated(x, tm)
    assert r.is_fully_replicated and torch.equal(r.full(), x)
    m2 = TD.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    s2 = TD.mesh.shard(x, m2, {"host": 0, "chip": 1})
    assert s2.spec == ("host", "chip", None) and torch.equal(s2.full(), x)
    with pytest.raises(ValueError):
        TD.strip_sharding(x[:, :7], tm, dim=1)


# -- the 11 sharded entry points ---------------------------------------------

def _enc32(jm, tm, d):
    img = d["img"]
    return (_jit(lambda x: JD.encode_quantize32_sharded(x, LUT32, jm), img),
            TD.encode_quantize32_sharded(img, LUT32, tm),
            T.encode_quantize32(img, LUT32, **CPU).reshape(H // 16, 8 * W))


def _dec32(jm, tm, d):
    rec = TD.encode_quantize32_sharded(d["img"], LUT32, tm)
    flat = rec.full().reshape(-1)
    return (_jit(lambda r: JD.decode_quantize32_sharded(r, LUT32, W, H, jm),
                 _np(rec)),
            TD.decode_quantize32_sharded(rec, LUT32, W, H, tm),
            T.decode_quantize32(flat, LUT32, W, H, **CPU))


def _stereo(view_layout):
    def case(jm, tm, d):
        img = d["img"]
        single = T.encode_quantize_stereo(img, LUT_Q, view_layout=view_layout,
                                          **CPU)
        if view_layout == "interleaved":
            single = single.reshape(64, H // 16, W // 4)
        return (_jit(lambda x: JD.encode_quantize_stereo_sharded(
                    x, LUT_Q, jm, view_layout=view_layout), img),
                TD.encode_quantize_stereo_sharded(
                    img, LUT_Q, tm, view_layout=view_layout),
                single)
    return case


def _stereo_dec(view_layout):
    def case(jm, tm, d):
        seg = TD.encode_quantize_stereo_sharded(d["img"], LUT_Q, tm,
                                                view_layout=view_layout)
        whole = seg.full()
        return (_jit(lambda p: JD.decode_quantize_stereo_sharded(
                    p, LUT_Q, W, H, jm, view_layout=view_layout),
                     whole.numpy()),
                TD.decode_quantize_stereo_sharded(seg, LUT_Q, W, H, tm,
                                                  view_layout=view_layout),
                T.decode_quantize_stereo(
                    whole if view_layout == "native" else whole.reshape(-1),
                    LUT_Q, W, H, view_layout=view_layout, **CPU))
    return case


def _batch(jm, tm, d):
    fr = d["frames"]
    return (_jit(lambda x: JD.encode_quantize32_batch(x, LUT32, jm), fr),
            TD.encode_quantize32_batch(fr, LUT32, tm),
            T.encode_quantize32(fr, LUT32, **CPU).reshape(8, H // 16, 8 * W))


def _batch_2d(jm, tm, d):
    fr = d["frames"][:4]
    jm2 = JD.make_mesh_2d((2, 2))
    tm2 = TD.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    out = TD.encode_quantize32_batch_2d(fr, LUT32, tm2)
    assert out.spec == ("host", "chip", None)
    return (_jit(lambda x: JD.encode_quantize32_batch_2d(x, LUT32, jm2), fr),
            out,
            T.encode_quantize32(fr, LUT32, **CPU).reshape(4, H // 16, 8 * W))


def _roundtrip_batch(jm, tm, d):
    fr = d["frames"]
    return (_jit(lambda x: JD.roundtrip_quantize32_batch(x, LUT32, jm), fr),
            TD.roundtrip_quantize32_batch(fr, LUT32, tm),
            T.roundtrip_quantize32(fr, LUT32, **CPU))


def _ycc(jm, tm, d):
    pl = d["planes"]
    return (_jit(lambda x: JD.encode_quantize32_ycbcr_sharded(
                x, LUMA, CHROMA, jm), pl),
            TD.encode_quantize32_ycbcr_sharded(pl, LUMA, CHROMA, tm),
            T.encode_quantize32_ycbcr(pl, LUMA, CHROMA, **CPU).reshape(
                3, H // 16, 8 * W))


def _ycc_dec(jm, tm, d):
    rec = TD.encode_quantize32_ycbcr_sharded(d["planes"], LUMA, CHROMA, tm)
    whole = rec.full()
    return (_jit(lambda r: JD.decode_quantize32_ycbcr_sharded(
                r, LUMA, CHROMA, W, H, jm), whole.numpy()),
            TD.decode_quantize32_ycbcr_sharded(rec, LUMA, CHROMA, W, H, tm),
            T.decode_quantize32_ycbcr(whole.reshape(3, -1), LUMA, CHROMA, W,
                                      H, **CPU))


def _ycc420(jm, tm, d):
    pl = d["planes420"]
    jy, jc = _jit(lambda x: JD.encode_quantize32_ycbcr420_sharded(
        x, LUMA, CHROMA, jm), pl)
    ty, tc = TD.encode_quantize32_ycbcr420_sharded(pl, LUMA, CHROMA, tm)
    assert ty.spec == ("data", None) and tc.spec == (None, "data", None)
    return (np.concatenate([_np(jy).reshape(-1), _np(jc).reshape(-1)]),
            np.concatenate([_np(ty).reshape(-1), _np(tc).reshape(-1)]),
            T.encode_quantize32_ycbcr420(pl, LUMA, CHROMA, **CPU))


def _ycc420_dec(jm, tm, d):
    ty, tc = TD.encode_quantize32_ycbcr420_sharded(d["planes420"], LUMA,
                                                   CHROMA, tm)
    y, c = _np(ty), _np(tc)
    stream = np.concatenate([y.reshape(-1), c.reshape(-1)])
    return (_jit(lambda a, b: JD.decode_quantize32_ycbcr420_sharded(
                a, b, LUMA, CHROMA, W420, H, jm), y, c),
            TD.decode_quantize32_ycbcr420_sharded(ty, tc, LUMA, CHROMA, W420,
                                                  H, tm),
            T.decode_quantize32_ycbcr420(stream, LUMA, CHROMA, W420, H,
                                         **CPU))


CASES = {
    "encode_quantize32_sharded": _enc32,
    "decode_quantize32_sharded": _dec32,
    "encode_quantize_stereo_sharded-interleaved": _stereo("interleaved"),
    "encode_quantize_stereo_sharded-native": _stereo("native"),
    "decode_quantize_stereo_sharded-interleaved": _stereo_dec("interleaved"),
    "decode_quantize_stereo_sharded-native": _stereo_dec("native"),
    "encode_quantize32_batch": _batch,
    "encode_quantize32_batch_2d": _batch_2d,
    "roundtrip_quantize32_batch": _roundtrip_batch,
    "encode_quantize32_ycbcr_sharded": _ycc,
    "decode_quantize32_ycbcr_sharded": _ycc_dec,
    "encode_quantize32_ycbcr420_sharded": _ycc420,
    "decode_quantize32_ycbcr420_sharded": _ycc420_dec,
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax_and_unsharded(name, meshes, data):
    jax_out, port_out, single = CASES[name](*meshes, data)
    port = _np(port_out)
    assert port.shape == _np(jax_out).shape
    _contract(port, jax_out)
    np.testing.assert_array_equal(port, _np(single))


def test_every_sharded_entry_point_has_a_case():
    names = {n.split("-")[0] for n in CASES}
    assert names == set(TD.__all__) - {
        "collectives", "DATA_AXIS", "make_mesh", "make_mesh_2d",
        "strip_sharding", "replicated", "initialize_distributed"}
    assert TD.__all__ == JD.__all__


@pytest.mark.parametrize("view_layout", ["interleaved", "native"])
def test_stereo_gather_is_exact(view_layout, meshes, data):
    _, tm = meshes
    seg = TD.encode_quantize_stereo_sharded(data["img"], LUT_Q, tm,
                                            view_layout=view_layout)
    g = TD.encode_quantize_stereo_sharded(data["img"], LUT_Q, tm,
                                          view_layout=view_layout,
                                          gather=True)
    assert g.is_fully_replicated
    for replica in g.shards:
        assert torch.equal(replica, seg.full())
    # the decode takes the gathered planes as they come
    d_seg = TD.decode_quantize_stereo_sharded(seg, LUT_Q, W, H, tm,
                                              view_layout=view_layout)
    d_g = TD.decode_quantize_stereo_sharded(g, LUT_Q, W, H, tm,
                                            view_layout=view_layout)
    assert torch.equal(d_seg.full(), d_g.full())


# -- the four gather forms ----------------------------------------------------

@pytest.mark.parametrize("view_layout", ["interleaved", "native"])
def test_gather_forms_agree_with_jax(view_layout, meshes, data):
    jm, tm = meshes
    seg = TD.encode_quantize_stereo_sharded(data["img"], LUT_Q, tm,
                                            view_layout=view_layout)
    whole = seg.full().numpy()
    d = 2 if view_layout == "native" else 1
    spec = P(*([None] * d + ["data"] + [None] * (whole.ndim - d - 1)))
    ref = np.asarray(jax.jit(lambda s: JC.gather_planes_auto(s, jm))(
        jax.device_put(whole, NamedSharding(jm, spec))))
    np.testing.assert_array_equal(ref, whole)
    for form in GATHERS:
        out = _gather(form, seg, tm)
        assert out.is_fully_replicated, form
        for replica in out.shards:
            np.testing.assert_array_equal(replica.numpy(), ref)


@pytest.fixture(scope="module")
def seg_2d():
    """(64, 16, 16) segments and JAX's all-gather of them over 'chip' of a
    (2, 2) mesh."""
    seg = np.random.default_rng(41).integers(0, 256, (64, 16, 16), np.uint8)
    jm2 = JD.make_mesh_2d((2, 2))
    ref = _jit(lambda s: JC.gather_planes_allgather(s, jm2, axis_name="chip"),
               seg)
    return seg, np.asarray(ref)


@pytest.mark.parametrize("form", GATHERS)
def test_gather_over_one_axis_of_a_2d_mesh(form, seg_2d):
    """One ring per row of the (host, chip) mesh; whole-tensor input split
    over 'chip' and replicated over 'host', as in JAX."""
    seg, ref = seg_2d
    tm2 = TD.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    out = _gather(form, torch.from_numpy(seg), tm2, axis_name="chip")
    assert out.dims == (None, None)
    for replica in out.shards:
        np.testing.assert_array_equal(replica.numpy(), ref)
    # a value also split over 'host' stays split there
    two = TD.mesh.shard(torch.from_numpy(seg), tm2, {"host": 0, "chip": 1})
    out2 = _gather(form, two, tm2, axis_name="chip")
    assert out2.dims == (0, None)
    np.testing.assert_array_equal(out2.full().numpy(), seg)


@pytest.mark.parametrize("form", GATHERS)
def test_ragged_strip_axis_raises(form, meshes):
    _, tm = meshes
    with pytest.raises(T.InvalidParameterError, match="divide evenly"):
        _gather(form, np.zeros((64, 18, 16), np.uint8), tm)


# -- errors the JAX functions raise -------------------------------------------

def test_uneven_420_strips_raise(meshes):
    _, tm = meshes
    planes = np.random.default_rng(9).integers(0, 256, (3, H + 32, W420),
                                               np.uint8)
    with pytest.raises(AssertionError):
        TD.encode_quantize32_ycbcr420_sharded(planes, LUMA, CHROMA, tm)


def test_stereo_planar_layout_raises(meshes, data):
    _, tm = meshes
    with pytest.raises(T.InvalidParameterError):
        TD.encode_quantize_stereo_sharded(data["img"], LUT_Q, tm,
                                          view_layout="planar")
    with pytest.raises(T.InvalidParameterError):
        TD.decode_quantize_stereo_sharded(np.zeros((64, 32, 32), np.uint8),
                                          LUT_Q, W, H, tm,
                                          view_layout="planar")


def test_unaligned_local_strips_and_whole_tensor_decode(meshes):
    """17 strips a shard (H = 1088 over 4): the sharded encode equals the
    unsharded one; the decode takes the records as a whole tensor too."""
    _, tm = meshes
    img = np.random.default_rng(77).integers(0, 256, (1088, W), np.uint8)
    rec = TD.encode_quantize32_sharded(img, LUT32, tm)
    single = T.encode_quantize32(img, LUT32, **CPU)
    assert torch.equal(rec.full().reshape(-1), single)
    a = TD.decode_quantize32_sharded(rec, LUT32, W, 1088, tm)
    b = TD.decode_quantize32_sharded(rec.full().numpy(), LUT32, W, 1088, tm)
    assert a.full().shape == (544, W) and torch.equal(a.full(), b.full())


# -- the view-level wrappers the shards call ----------------------------------

def test_view_wrappers_take_strided_shards():
    rng = np.random.default_rng(5)
    fr = torch.from_numpy(rng.integers(0, 256, (2, 256, 128), np.uint8))
    part = fr[:, 32:96, :]                       # a shard of the top views
    assert torch.equal(K.encode32_view(part, LUT32),
                       K.encode32_view(part.contiguous(), LUT32))
    rec = K.encode32_view(part, LUT32).reshape(2, 8, 8 * 128)
    assert K.decode32_view(rec, LUT32).shape == (2, 64, 128)
    pl = torch.from_numpy(rng.integers(0, 256, (3, 256, 256), np.uint8))
    view = pl[:, 64:128, :]
    assert torch.equal(K.encode32_rgb_view(view, LUMA, CHROMA),
                       T.encode_quantize32_ycbcr(
                           torch.cat([view, view], dim=1).contiguous(), LUMA,
                           CHROMA))
    assert torch.equal(K.encode420_rgb_view(view, LUMA, CHROMA),
                       T.encode_quantize32_ycbcr420(
                           torch.cat([view, view], dim=1).contiguous(), LUMA,
                           CHROMA))
    with pytest.raises(ValueError, match="contiguous rows"):
        K.encode32_view(fr[0, :, ::2], LUT32)


@pytest.mark.parametrize("view_layout", ["interleaved", "native"])
def test_stereo_view_wrapper_takes_strided_shards(view_layout):
    """A shard's rows of both views, a view stride apart, encode as the
    dual-view image they make."""
    img = np.random.default_rng(6).integers(0, 256, (H, W), np.uint8)
    views = torch.from_numpy(img).reshape(2, H // 2, W)[:, 64:128, :]
    got = K.encode_stereo_view(views, LUT_Q, view_layout=view_layout)
    whole = torch.cat([views[0], views[1]]).contiguous()
    want = T.encode_quantize_stereo(whole, LUT_Q, view_layout=view_layout,
                                    **CPU)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="views must be"):
        K.encode_stereo_view(views[:1], LUT_Q)


# -- the gather kernel's launch plan: host arithmetic, no card ----------------
# An H100 has 132 SMs and holds 3 CTAs of the bulk variant an SM at its most
# shared memory (4 tiles of 16 KB); a launch takes at most 2 an SM.

def test_gather_scope_follows_the_cards():
    """Card scope when every rank of the mesh lies on one card, system
    scope when they lie on several (meshes of cards are only described
    here, never run)."""
    one = TD.make_mesh(4, devices=["cuda:0"] * 4)
    mixed = TD.make_mesh_2d((2, 2), devices=["cuda:0", "cuda:1"] * 2)
    assert TC._per_device(one) == {torch.device("cuda:0"): [0, 1, 2, 3]}
    assert not TC._system_scope(TC._per_device(one))
    assert TC._per_device(mixed) == {torch.device("cuda:0"): [0, 2],
                                     torch.device("cuda:1"): [1, 3]}
    assert TC._system_scope(TC._per_device(mixed))


@pytest.mark.parametrize("outer, row, ranks, want", [
    # the 4K dual view's stereo segments (64, 64, 960) on four ranks of one
    # card: four 15,360-byte tiles a row, 66 CTAs a rank (264 / 4)
    (64, 64 * 960, 4, (15360, 4, 66, 3 * 66)),
    # the self-ring's (8, 8, 128): one tile of all 8 rows, one CTA
    (8, 8 * 128, 1, (8192, 2, 1, 1)),
    # eight ranks of 4K-wide segments: the launch's 264 CTAs bind (33 each)
    (64, 32 * 960, 8, (15360, 4, 33, 7 * 33)),
    # a ring of 2: a CTA for each 32 KB of the segment
    (64, 16 * 480, 2, (15360, 3, 15, 15)),
])
def test_gather_plan_counts_ctas_tiles_and_arrivals(outer, row, ranks, want):
    """(tile bytes, stages, CTAs a rank, arrivals a rank) of one gather;
    arrivals count one from each CTA of each of the ring's other ranks
    (the self-ring's one peer is itself)."""
    fit = TC._ctas_fit(3, 132, ranks)
    assert tuple(TC._plan(outer, row, fit, max(ranks - 1, 1))) == want


@pytest.mark.parametrize("outer, row, tile, n_tiles, last", [
    (16, 16400, 8208, 32, 8192),    # a row cut in two, the last piece short
    (70, 1040, 15600, 5, 10 * 1040),  # 15 rows a tile, the last tile 10
    (1, 65536, 16384, 4, 16384),     # one row of four whole tiles
    (64, 120, 7680, 1, 7680),        # byte-wide rows: the byte variant
])
def test_gather_tiles_cover_the_segment(outer, row, tile, n_tiles, last):
    assert TC._tile(outer, row) == tile
    assert TC._n_tiles(outer, row, tile) == n_tiles
    covered = (outer * row - (n_tiles - 1) * tile if tile >= row else
               row - (n_tiles // outer - 1) * tile)
    assert covered == last


def test_arrival_target_wraps_and_rides_in_the_descriptor():
    plan = TC._plan(64, 64 * 960, TC._ctas_fit(3, 132, 4), 3)
    assert plan.target(5) == 5 + 198
    near = 0xFFFFFFFF - 9
    assert plan.target(near) == (near + 198) & 0xFFFFFFFF == 188
    words = TC._desc(16, 32, 7, plan.target(near), [48, 64], [0, 80],
                     [96], [112])
    assert len(words) == TC._DESC_WORDS and words[6] == 188


def test_too_many_ranks_for_the_card_raise():
    with pytest.raises(T.NotSupportedError, match="too many ranks"):
        TC._ctas_fit(1, 4, 8)
