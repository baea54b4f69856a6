"""The port's .sdt / .sdtv containers and ``Encoder`` facade against the JAX
package's, on the CPU.

Inputs: seeded smooth 64x128 images (three correlated planes for the colour
modes) and seeded frame batches.  The JAX side encodes with its ``xla``
tier, the port with its plain PyTorch version on CPU tensors
(``device="cpu"``).  Tolerances:
  * ``pack`` / ``unpack`` of the same payload and meta: byte for byte;
  * a package's decode of the other's blob against the writer's own decode
    of it: the ``compare_backends`` contract (+-1 on at most 0.2% of bytes);
  * ``compat=True`` decodes of one blob: byte for byte across packages;
  * the facade against the port's api calls: byte for byte.
"""

import functools

import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu import container as JC
from simd_dct_tpu import entropy as JE
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import container as C
from simd_dct_tpu_torch import entropy as E
from simd_dct_tpu_torch.api import SimdDctError
from simd_dct_tpu_torch.utils.debug import compare_backends

CPU = {"device": "cpu"}
H, W = 64, 128
# mode, stereo view layout
MODE_CASES = [(m, "interleaved") for m in C.MODES] + [
    ("enc-quant-stereo", "planar"), ("enc-quant-stereo", "native")]
MODE_IDS = [m if v == "interleaved" else f"{m}-{v}" for m, v in MODE_CASES]
PAYLOADS = {"raw": {"compress": False}, "plain": {}, "rle": {"rle": True},
            "sparse": {"sparse": True}}


def _img(h=H, w=W, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip(128 + 60 * np.sin((xx + seed) / 11) * np.cos(yy / 7),
                   0, 255).astype(np.uint8)


def _image(mode, seed=0):
    if mode.startswith("enc-quant32-ycbcr"):
        return np.stack([_img(seed=seed + s) for s in range(3)])
    return _img(seed=seed)


def _frames(mode, n=3):
    return np.stack([_image(mode, seed=5 * i) for i in range(n)])


def _contract(a, b):
    report = compare_backends({"a": np.asarray(a), "b": np.asarray(b)})
    assert all(v["ok"] for v in report.values()), report


def _both_encode(mode, view_layout, fn="encode", data=None, **kw):
    data = _image(mode) if data is None else data
    port = getattr(C, fn)(data, mode, quality=50.0, view_layout=view_layout,
                          **kw, **CPU)
    ref = getattr(JC, fn)(data, mode, quality=50.0, view_layout=view_layout,
                          backend="xla", **kw)
    return port, ref


# ---------------------------------------------------------------------------
# framing: byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,view_layout", MODE_CASES, ids=MODE_IDS)
def test_pack_unpack_identical(mode, view_layout):
    rng = np.random.default_rng(len(mode) + len(view_layout))
    payload = rng.integers(0, 256, 999, dtype=np.uint8)
    chroma = (rng.uniform(1, 9, 64).astype(np.float32)
              if "ycbcr" in mode else None)
    fields = dict(mode=mode, size_x=W, size_y=H,
                  luma_lut=rng.uniform(1, 9, 64).astype(np.float32),
                  chroma_lut=chroma, rounding="clamp_first", start_y=16,
                  end_y=48, packed=True,
                  stereo_planar=view_layout == "planar",
                  stereo_native=view_layout == "native")
    blob = C.pack(payload, C.FrameMeta(**fields))
    ref = JC.pack(payload, JC.FrameMeta(**fields))
    assert blob.tobytes() == ref.tobytes()
    for unpack in (C.unpack, JC.unpack):
        for b in (blob, ref.tobytes()):
            got, meta = unpack(b)
            assert got.tobytes() == payload.tobytes()
            for k, v in fields.items():
                np.testing.assert_array_equal(getattr(meta, k), v)


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
def test_sdt_blob_identical_for_the_same_records(payload):
    """A container of the JAX package's records, packed by the port's
    coder and framing, is the JAX package's container: the framing and the
    coder add nothing of their own."""
    img = _img()
    lut = T.default_quant_lut(50.0) * np.float32(255.0)
    rec = np.asarray(J.api.encode_quantize32(img, lut, backend="xla"))
    kw = PAYLOADS[payload]
    if not kw.get("compress", True):
        port, ref = rec, rec
    elif kw.get("sparse"):
        port, ref = E.compress_sparse(rec, **CPU), JE.compress_sparse(rec)
    else:
        port = E.compress_records(rec, rle=kw.get("rle", False), **CPU)
        ref = JE.compress_records(rec, rle=kw.get("rle", False))
    fields = dict(mode="enc-quant32", size_x=W, size_y=H, luma_lut=lut,
                  packed=kw.get("compress", True))
    blob = C.pack(port, C.FrameMeta(**fields))
    assert blob.tobytes() == JC.pack(ref, JC.FrameMeta(**fields)).tobytes()
    np.testing.assert_array_equal(
        C.decode(blob, **CPU).numpy(),
        T.decode_quantize32(rec, lut, W, H, **CPU).numpy())


# ---------------------------------------------------------------------------
# each package decodes the other's containers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", sorted(PAYLOADS))
@pytest.mark.parametrize("mode,view_layout", MODE_CASES, ids=MODE_IDS)
def test_sdt_cross_decode(mode, view_layout, payload):
    port, ref = _both_encode(mode, view_layout, **PAYLOADS[payload])
    meta, ref_meta = C.info(port), C.info(ref)
    assert (meta.mode, meta.packed, meta.stereo_planar, meta.stereo_native) \
        == (ref_meta.mode, ref_meta.packed, ref_meta.stereo_planar,
            ref_meta.stereo_native)
    port_own = C.decode(port, **CPU)
    assert isinstance(port_own, torch.Tensor)
    assert port_own.device.type == "cpu"
    ref_own = np.asarray(JC.decode(ref, backend="xla"))
    _contract(np.asarray(JC.decode(port, backend="xla")), port_own)
    _contract(C.decode(ref, **CPU), ref_own)
    # each package's encode and decode against the other's
    _contract(port_own, ref_own)


@pytest.mark.parametrize("mode,view_layout",
                         [c for c in MODE_CASES if "ycbcr" not in c[0]],
                         ids=[i for i in MODE_IDS if "ycbcr" not in i])
def test_compat_decode_identical(mode, view_layout):
    port, ref = _both_encode(mode, view_layout)
    for blob in (port, ref):
        got = C.decode(blob, compat=True, **CPU).numpy()
        want = np.asarray(JC.decode(blob, compat=True, backend="xla"))
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
@pytest.mark.parametrize("mode,view_layout",
                         [("enc-quant32", "interleaved"),
                          ("enc-quant-stereo", "native"),
                          ("enc-quant32-ycbcr420", "interleaved")],
                         ids=["enc-quant32", "stereo-native", "ycbcr420"])
def test_sdtv_cross_decode(mode, view_layout, payload):
    frames = _frames(mode)
    port, ref = _both_encode(mode, view_layout, "encode_video", frames,
                             **PAYLOADS[payload])
    assert C.video_info(port).n_frames == JC.video_info(ref).n_frames == 3
    port_own = C.decode_video(port, **CPU)
    assert port_own.shape[0] == 3
    _contract(np.asarray(JC.decode_video(port, backend="xla")), port_own)
    _contract(C.decode_video(ref, **CPU),
              np.asarray(JC.decode_video(ref, backend="xla")))
    for i in (0, 2):
        np.testing.assert_array_equal(
            C.decode_video_frame(port, i, **CPU).numpy(),
            port_own[i].numpy())


def test_sdtv_plain_payloads_share_one_table():
    """The plain .sdtv payloads of the same records are the JAX package's:
    one table from the whole batch, K chunks a frame."""
    frames = _frames("enc-quant32")
    lut = T.default_quant_lut(50.0) * np.float32(255.0)
    rec = np.array(J.api.encode_quantize32(frames, lut, backend="xla"))
    lengths = E.build_lengths(E.histogram(torch.from_numpy(rec)))
    ref_lengths = JE.build_lengths(JE.histogram(rec))
    assert lengths.tobytes() == ref_lengths.tobytes()
    for i in range(3):
        assert (E.compress(rec[i], lengths, streams=4).tobytes()
                == JE.compress(rec[i], ref_lengths, streams=4).tobytes())


# ---------------------------------------------------------------------------
# header errors: the JAX package's
# ---------------------------------------------------------------------------

@functools.cache
def _sdt_errors(pkg):
    blob = pkg.encode(_img(), "enc-quant32", quality=50.0,
                      **(CPU if pkg is C else {"backend": "xla"}))
    bad_magic, bad_version, bad_size = blob.copy(), blob.copy(), blob.copy()
    bad_magic[0] ^= 0xFF
    bad_version[4] = 99
    pos = pkg._FIXED.size + 256
    bad_size[pos:pos + 8] = np.frombuffer(np.uint64(2**40).tobytes(),
                                          np.uint8)
    both = blob.copy()
    both[pkg._FIXED.size - 4] |= 12          # planar and native bits
    return {"bad_magic": bad_magic, "bad_version": bad_version,
            "payload_size": bad_size, "both_layout_bits": both,
            "cut_3": blob[:3], "cut_10": blob[:10], "cut_40": blob[:40],
            "cut_tail": blob[:-5]}


SDT_ERRORS = ("bad_magic", "bad_version", "payload_size", "both_layout_bits",
              "cut_3", "cut_10", "cut_40", "cut_tail")


@pytest.mark.parametrize("case", SDT_ERRORS)
def test_sdt_header_errors(case):
    with pytest.raises(JC.ContainerError):
        JC.unpack(_sdt_errors(JC)[case])
    for blob in (_sdt_errors(C)[case], _sdt_errors(JC)[case]):
        with pytest.raises(C.ContainerError):
            C.unpack(blob)


VIDEO_ERRORS = ("zero_frames", "bad_magic", "sizes_exceed", "cut")


@pytest.mark.parametrize("case", VIDEO_ERRORS)
def test_sdtv_header_errors(case):
    frames = _frames("enc-quant32", 2)
    blob = C.encode_video(frames, "enc-quant32", quality=50.0, **CPU).copy()
    if case == "zero_frames":
        blob[16:20] = np.frombuffer(np.uint32(0).tobytes(), np.uint8)
    elif case == "bad_magic":
        blob[0] ^= 0xFF
    elif case == "sizes_exceed":
        pos = JC._FIXED_V.size + 256
        blob[pos:pos + 8] = np.frombuffer(np.uint64(2**40).tobytes(),
                                          np.uint8)
    else:
        blob = blob[:-7]
    with pytest.raises(JC.ContainerError):
        JC.decode_video(blob, backend="xla")
    for call in (lambda: C.decode_video(blob, **CPU),
                 lambda: C.video_info(blob),
                 lambda: C.decode_video_frame(blob, 0, **CPU)):
        with pytest.raises(C.ContainerError):
            call()


def test_encode_errors_match_jax():
    planes = _image("enc-quant32-ycbcr")
    cases = [
        (lambda P, kw: P.encode(_img(), "enc-quant64", **kw)),
        (lambda P, kw: P.encode(planes, "enc-quant32-ycbcr", quality=50.0,
                                start_y=8, end_y=24, **kw)),
        (lambda P, kw: P.encode(_img(), "enc-quant32", view_layout="planar",
                                **kw)),
        (lambda P, kw: P.encode_video(_img(), "enc-quant32", **kw)),
        (lambda P, kw: P.encode_video(_frames("enc-quant32")[:0],
                                      "enc-quant32", **kw)),
        (lambda P, kw: P.decode_video_frame(
            P.encode_video(_frames("enc-quant32", 2), "enc-quant32", **kw),
            2, **kw)),
    ]
    for make in cases:
        with pytest.raises(JC.ContainerError):
            make(JC, {"backend": "xla"})
        with pytest.raises(C.ContainerError):
            make(C, CPU)


def test_stereo_payload_size_mismatch_typed():
    port, _ = _both_encode("enc-quant-stereo", "planar", compress=False)
    payload, meta = C.unpack(port)
    short = C.pack(payload[:-64], meta)
    with pytest.raises(C.ContainerError):
        C.decode(short, **CPU)
    with pytest.raises(JC.ContainerError):
        JC.decode(short, backend="xla")


def test_header_fuzz_typed_errors():
    rng = np.random.default_rng(0xC0DE)
    base = C.encode(_img(), "enc-quant32", quality=50.0, **CPU)
    for trial in range(60):
        blob = base.copy()
        if trial % 2:
            idx = rng.integers(0, min(blob.size, 600), 6)
            blob[idx] ^= rng.integers(1, 256, 6).astype(np.uint8)
        else:
            blob = blob[: int(rng.integers(0, blob.size))].copy()
        try:
            C.decode(blob, **CPU)
        except (C.ContainerError, E.EntropyError, SimdDctError,
                ValueError):
            pass


# ---------------------------------------------------------------------------
# the Encoder facade
# ---------------------------------------------------------------------------

def test_config_validation():
    with pytest.raises(ValueError):
        T.EncoderConfig(rounding="nearest")
    with pytest.raises(ValueError):
        T.EncoderConfig(layout="planar")
    with pytest.raises(ValueError):
        T.EncoderConfig(stereo_layout="zigzag")
    with pytest.raises(ValueError):
        T.EncoderConfig(backend="pallas")     # the JAX package's tier
    assert T.EncoderConfig(backend="cuda").backend == "cuda"
    np.testing.assert_array_equal(T.EncoderConfig(quality=50).lut(),
                                  J.EncoderConfig(quality=50).lut())


def test_encoder_methods_match_api():
    enc = T.Encoder(T.EncoderConfig(quality=50, layout="pair", device="cpu",
                                    start_y=16, end_y=48))
    img, planes = _img(), _image("enc-quant32-ycbcr")
    lut, lut32 = enc.lut, enc.lut * np.float32(255.0)
    chroma32 = enc.chroma_lut() * np.float32(255.0)
    np.testing.assert_array_equal(enc.chroma_lut(),
                                  J.Encoder(J.EncoderConfig(quality=50))
                                  .chroma_lut())
    pairs = [
        (enc.encode_quantize(img),
         T.encode_quantize(img, lut, 16, 48, layout="pair", **CPU)),
        (enc.encode_quantize32(img),
         T.encode_quantize32(img, lut32, 16, 48, **CPU)),
        (enc.encode_quantize_stereo(img),
         T.encode_quantize_stereo(img, lut, 16, 48, **CPU)),
        (enc.roundtrip_quantize32(img),
         T.roundtrip_quantize32(img, lut32, **CPU)),
        (enc.encode_quantize32_ycbcr(planes),
         T.encode_quantize32_ycbcr(planes, lut32, chroma32, **CPU)),
        (enc.roundtrip_quantize32_ycbcr(planes),
         T.roundtrip_quantize32_ycbcr(planes, lut32, chroma32, **CPU)),
        (enc.encode_quantize32_ycbcr420(planes),
         T.encode_quantize32_ycbcr420(planes, lut32, chroma32, **CPU)),
    ]
    rec = enc.encode_quantize(img)
    pairs.append((enc.decode_quantize(rec, W, H),
                  T.decode_quantize(rec, lut, W, H, layout="pair")))
    rec32 = enc.encode_quantize32(img)
    pairs.append((enc.decode_quantize32(rec32, W, H),
                  T.decode_quantize32(rec32, lut32, W, H)))
    recs = enc.encode_quantize_stereo(img)
    pairs.append((enc.decode_quantize_stereo(recs, W, H),
                  T.decode_quantize_stereo(recs, lut, W, H)))
    rec_c = enc.encode_quantize32_ycbcr(planes)
    pairs.append((enc.decode_quantize32_ycbcr(rec_c, W, H),
                  T.decode_quantize32_ycbcr(rec_c, lut32, chroma32, W, H)))
    rec_420 = enc.encode_quantize32_ycbcr420(planes)
    pairs.append((enc.decode_quantize32_ycbcr420(rec_420, W, H),
                  T.decode_quantize32_ycbcr420(rec_420, lut32, chroma32, W,
                                               H)))
    for got, want in pairs:
        assert got.device.type == "cpu"
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode,view_layout", MODE_CASES, ids=MODE_IDS)
def test_encoder_containers_over_every_mode(mode, view_layout):
    enc = T.Encoder(T.EncoderConfig(quality=50.0, stereo_layout=view_layout,
                                    device="cpu"))
    blob = enc.encode_container(_image(mode), mode, sparse=True)
    assert blob.tobytes() == C.encode(_image(mode), mode, quality=50.0,
                                      sparse=True, view_layout=view_layout,
                                      **CPU).tobytes()
    meta = C.info(blob)
    assert (meta.mode, meta.stereo_planar, meta.stereo_native) == (
        mode, view_layout == "planar", view_layout == "native")
    out = enc.decode_container(blob)
    assert torch.equal(out, C.decode(blob, **CPU))
    # self-describing: another config decodes it the same
    other = T.Encoder(T.EncoderConfig(quality=2.0, device="cpu"))
    assert torch.equal(other.decode_container(blob), out)
    vblob = enc.encode_video_container(_frames(mode, 2), mode, rle=True)
    vout = enc.decode_video_container(vblob)
    assert vout.shape[0] == 2 and torch.equal(vout[1], C.decode_video_frame(
        vblob, 1, **CPU))


def test_encoder_compressed_pipeline():
    enc = T.Encoder(T.EncoderConfig(quality=100, device="cpu"))
    img = _img()
    ref = enc.decode_quantize32(enc.encode_quantize32(img), W, H)
    for kw in ({}, {"rle": True}, {"sparse": True}):
        blob = enc.encode_quantize32_compressed(img, **kw)
        assert blob.size < H * W // 2
        assert torch.equal(enc.decode_quantize32_compressed(blob, W, H), ref)
        # the JAX facade decodes the port's stream to within the contract
        jenc = J.Encoder(J.EncoderConfig(quality=100, backend="xla"))
        _contract(np.asarray(jenc.decode_quantize32_compressed(blob, W, H)),
                  ref)
