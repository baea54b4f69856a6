"""The port's compressed stream against the JAX package's, on the CPU.

The same records go through both packages: seeded numpy streams of each
regime the coders split on (smooth-dense for SDN1, mid-entropy for SDN2,
sparse 64-byte blocks for SDS1, incompressible for the stored escape) and
the JAX ``xla`` mode32 records of a seeded smooth 128x256 image.  Every
stream the port writes must equal the JAX package's byte for byte, and each
package's ``decompress`` / ``decompress_to_device`` must recover the
other's blob exactly (the port's device half runs on CPU tensors here, the
JAX device half on CPU ``jax.Array``s).  Tolerance: exact everywhere.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_dct_tpu import api as JA
from simd_dct_tpu import entropy as JE
from simd_dct_tpu_torch import api as TA
from simd_dct_tpu_torch import entropy as E
from simd_dct_tpu_torch import native
from simd_dct_tpu_torch.core.quantize import default_quant_lut

CPU = {"device": "cpu"}


def _smooth_image(h=128, w=256, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = 128 + 60 * np.sin(xx / 13 + rng.uniform(0, 6)) * np.cos(yy / 9)
    return np.clip(f + rng.normal(0, 2, f.shape), 0, 255).astype(np.uint8)


def _sparse_records(nblk=512, active_every=4, seed=0):
    rng = np.random.default_rng(seed)
    blocks = np.full((nblk, 64), 127, np.uint8)
    act = np.arange(0, nblk, active_every)
    blocks[act] = rng.integers(100, 156, (act.size, 64), dtype=np.uint8)
    return blocks.reshape(-1)


@functools.cache
def _streams():
    rng = np.random.default_rng(0x5EED)
    lut = default_quant_lut(50) * np.float32(255.0)
    return {
        "mode32": np.array(JA.encode_quantize32(_smooth_image(), lut,
                                                  backend="xla")),
        "dense": np.clip(rng.normal(127, 3, 20_003), 0, 255).astype(np.uint8),
        "mid": np.clip(rng.normal(127, 9, 16_384), 0, 255).astype(np.uint8),
        "wide": rng.integers(0, 256, 9_000, dtype=np.uint8),
        "sparse": _sparse_records(),
        "ragged": _sparse_records(nblk=96)[: 96 * 64 - 37],
    }


def _magic(blob) -> bytes:
    return np.asarray(blob)[:4].tobytes()


def _same(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype == np.uint8
    assert port.tobytes() == ref.tobytes(), (port.size, ref.size)


def _exact_pack(x, streams=None):
    """The JAX package's plain pack of ``x`` under its own table, with the
    stored escape picked by its post-check alone (an explicit table skips
    its pre-check): the stream the port's exact pre-check must give."""
    x = JE.as_u8_stream(x)
    return JE.compress(x, JE.build_lengths(JE.histogram(x, device=False)),
                       streams=streams)


def _same_pack(port, ref, exact):
    """A plain pack with the stored-escape pre-check: the port's stream is
    the post-check's (``exact``), and the JAX package's but where the JAX
    package's fixed +600-byte slack picked SDE0 over a smaller pack; there
    the port's stream is the smaller one."""
    _same(port, exact)
    if np.asarray(port).tobytes() != np.asarray(ref).tobytes():
        assert _magic(ref) == b"SDE0" and port.size < ref.size


def _sds1_split(blob):
    nblk = int(np.frombuffer(blob[12:16].tobytes(), np.uint32)[0])
    return blob[:20 + nblk // 8], blob[20 + nblk // 8:]


def _same_sparse(port, ref):
    """SDS1 streams: header and bitmap identical, the payload held to
    ``_same_pack`` (a plain pack's pre-check may end any payload format).
    Dense fallbacks: identical."""
    if _magic(ref) != b"SDS1":
        _same(port, ref)
        return
    (hp, pp), (hr, pr) = _sds1_split(port), _sds1_split(ref)
    _same(hp, hr)
    if pp.tobytes() != pr.tobytes():
        _same_pack(pp, pr, _exact_pack(JE.decompress(pr)))


# ---------------------------------------------------------------------------
# byte-identical streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streams", [1, 4, 8, 128])
@pytest.mark.parametrize("kind", ["mode32", "dense", "mid", "wide"])
def test_compress_identical(kind, streams):
    x = _streams()[kind]
    _same_pack(E.compress(x, streams=streams),
               JE.compress(x, streams=streams), _exact_pack(x, streams))
    _same(E.compress(x, streams=streams, stored_ok=False),
          JE.compress(x, streams=streams, stored_ok=False))


def test_compress_default_streams_and_reused_table_identical():
    x = _streams()["mode32"]
    _same_pack(E.compress(x), JE.compress(x), _exact_pack(x))
    other = np.concatenate([_streams()["dense"],
                            np.arange(256, dtype=np.uint8)])  # every symbol
    lengths = E.build_lengths(E.histogram(other, device=False))
    _same(lengths, JE.build_lengths(JE.histogram(other, device=False)))
    _same(E.compress(x, lengths, streams=4),
          JE.compress(x, lengths, streams=4))


@pytest.mark.parametrize("streams", [None, 1, 4, 8, 128])
@pytest.mark.parametrize("kind", ["mode32", "sparse"])
def test_compress_rle_identical(kind, streams):
    x = _streams()[kind]
    blob = E.compress(x, rle=True, streams=streams)
    _same(blob, JE.compress(x, rle=True, streams=streams))
    assert _magic(blob) == (b"SDER" if streams is None else b"SDGR")


@pytest.mark.parametrize("kind,magic", [("dense", b"SDN1"), ("mid", b"SDN2"),
                                        ("wide", b"SDE0"),
                                        ("mode32", b"SDN1")])
def test_compress_dense_identical(kind, magic):
    """SDN1, the SDN2 ladder and the plain fallback, by the host split and
    by the device split (port: a CPU tensor; JAX: a CPU jax.Array)."""
    x = _streams()[kind]
    ref = JE.compress_dense(x)
    assert _magic(ref) == magic
    _same(E.compress_dense(x), ref)
    _same(E.compress_dense(torch.from_numpy(x)), ref)
    _same(JE.compress_dense(jnp.asarray(x)), ref)


@pytest.mark.parametrize("opts", [{}, {"rle": True}, {"dense_fast": False},
                                  {"payload_fast": True}])
@pytest.mark.parametrize("kind", ["sparse", "ragged", "mode32", "wide"])
def test_compress_sparse_identical(kind, opts):
    x = _streams()[kind]
    ref = JE.compress_sparse(x, **opts)
    for got in (E.compress_sparse(x, **opts, **CPU),
                E.compress_sparse(torch.from_numpy(x), **opts),
                E.compress_sparse(x.tobytes(), **opts, **CPU)):
        _same_sparse(got, ref)


@pytest.mark.parametrize("rle", [False, True])
def test_compress_sparse_batch_identical(rle):
    recs = np.stack([_sparse_records(nblk=128, active_every=k + 2, seed=k)
                     for k in range(3)] + [_streams()["wide"][:128 * 64]])
    ref = JE.compress_sparse_batch(recs, rle=rle)
    for got in (E.compress_sparse_batch(recs, rle=rle, **CPU),
                E.compress_sparse_batch(torch.from_numpy(recs), rle=rle)):
        assert len(got) == len(ref) == 4
        for g, r in zip(got, ref):
            _same_sparse(g, r)
    with pytest.raises(E.EntropyError):
        E.compress_sparse_batch(recs[0], **CPU)


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("kind", ["mode32", "sparse"])
def test_compress_records_identical(kind, rle):
    x = _streams()[kind]
    ref = JE.compress_records(x, rle=rle)
    _same(E.compress_records(torch.from_numpy(x), rle=rle), ref)
    _same(E.compress_records(x, rle=rle, **CPU), ref)
    _same(E.compress_records(x.tobytes(), rle=rle, **CPU), ref)


def test_stored_escape_identical():
    x = _streams()["wide"]
    for port, ref in ((E.compress(x), JE.compress(x)),
                      (E.compress(x, rle=True), JE.compress(x, rle=True)),
                      (E.compress(x, streams=128), JE.compress(x,
                                                               streams=128))):
        assert _magic(ref) == b"SDE0"
        _same(port, ref)


def test_encode_quantize32_compressed_matches_jax_pack():
    """The port's pipeline writes the JAX package's stream of the records
    it encoded, and decodes it back to its own api decode."""
    img = _smooth_image(64, 128, seed=3)
    lut = default_quant_lut(50) * np.float32(255.0)
    rec = E._host_bytes(TA.encode_quantize32(img, lut, **CPU))
    for kw in ({}, {"rle": True}, {"sparse": True}):
        blob = E.encode_quantize32_compressed(img, lut, **kw, **CPU)
        if kw.get("sparse"):
            _same_sparse(blob, JE.compress_sparse(rec))
        else:
            _same(blob, JE.compress_records(rec, rle=kw.get("rle", False)))
        out = E.decode_quantize32_compressed(blob, lut, 128, 64, **CPU)
        assert out.shape == (32, 128) and out.device.type == "cpu"


# ---------------------------------------------------------------------------
# each package decodes the other's blobs
# ---------------------------------------------------------------------------

def _blobs(pkg, kind):
    x = _streams()[kind]
    return {
        "sde1": pkg.compress(x, streams=1, stored_ok=False),
        "sde4": pkg.compress(x, streams=4, stored_ok=False),
        "sdeg": pkg.compress(x, streams=8, stored_ok=False),
        "sder": pkg.compress(x, rle=True),
        "sdgr": pkg.compress(x, rle=True, streams=8),
        "sdn": pkg.compress_dense(x, max_escape_frac=1.0),
        "sds1": pkg.compress_sparse(x, max_kept_frac=1.0,
                                    **({} if pkg is JE else CPU)),
        "sde0": pkg._stored(x),
    }


@pytest.mark.parametrize("kind", ["mode32", "mid", "ragged"])
def test_cross_decode(kind):
    x = _streams()[kind]
    for writer, reader in ((E, JE), (JE, E)):
        for name, blob in _blobs(writer, kind).items():
            np.testing.assert_array_equal(reader.decompress(blob), x,
                                          err_msg=name)
            dev = (reader.decompress_to_device(blob, **CPU) if reader is E
                   else reader.decompress_to_device(blob))
            np.testing.assert_array_equal(np.asarray(dev), x, err_msg=name)


def test_decompress_to_device_stays_on_device():
    blob = E.compress_sparse(_streams()["sparse"], **CPU)
    out = E.decompress_to_device(blob, **CPU)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert out.device.type == "cpu"
    assert isinstance(E.decompress_on(blob, "cpu"), torch.Tensor)


def test_numpy_input_goes_to_the_card_unless_cpu(monkeypatch):
    """With no card, non-tensor input to a device function raises instead
    of falling back to the host; ``device="cpu"`` runs there."""
    from simd_dct_tpu_torch.api import NotSupportedError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _streams()["sparse"]
    for call in (lambda: E.compress_sparse(x),
                 lambda: E.compress_records(x),
                 lambda: E.histogram(x),
                 lambda: E.decompress_to_device(E.compress(x))):
        with pytest.raises(NotSupportedError):
            call()
    E.compress_sparse(x, **CPU)


# ---------------------------------------------------------------------------
# the device halves against the JAX device halves and the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mode32", "dense", "ragged"])
def test_nib_split_device_matches_jax(kind):
    x = _streams()[kind]
    port = E.nib_split_device(torch.from_numpy(x))
    ref = JE.nib_split_device(jnp.asarray(x))
    assert len(port) == len(ref) == 4 and port[-1] == ref[-1] == x.size
    for p, r in zip(port[:-1], ref[:-1]):
        _same(p, r)
    assert E.nib_split_device(torch.from_numpy(_streams()["wide"]),
                              max_escape_frac=0.35) is None


@pytest.mark.parametrize("kind", ["mid", "ragged"])
def test_nib2_split_device_matches_jax(kind):
    x = _streams()[kind]
    port = E.nib2_split_device(x, **CPU)
    ref = JE.nib2_split_device(jnp.asarray(x))
    assert port[-1] == ref[-1] == x.size
    for p, r in zip(port[:-1], ref[:-1]):
        _same(p, r)
    _same(E.compress_dense_parts2(*port), JE.compress_dense_parts2(*ref))


@pytest.mark.parametrize("kind", ["mode32", "wide", "ragged"])
def test_device_histogram_equals_native(kind):
    x = _streams()[kind]
    host = E.histogram(x, device=False)
    _same(host.view(np.uint8), np.bincount(x, minlength=256)
          .astype(np.uint64).view(np.uint8))
    for dev in (E.histogram(torch.from_numpy(x)),
                E.histogram(x, device="cpu")):
        assert dev.dtype == np.uint64
        np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(JE.histogram(jnp.asarray(x)), host)


def test_expand_sparse_matches_jax():
    rec = _sparse_records(nblk=256, active_every=3, seed=7)
    blocks, n = E._sparse_blocks(rec, **CPU)
    flags = E._significant(blocks)
    bm = E._host(E._packbits(flags))
    _same(bm, np.packbits(flags.numpy(), bitorder="little"))
    out = E.expand_sparse_device(bm, blocks[flags].numpy(), n, **CPU)
    np.testing.assert_array_equal(out.numpy(), rec)
    ref = JE.expand_sparse_device(bm, blocks[flags].numpy(), n)
    np.testing.assert_array_equal(np.asarray(ref), rec)


# ---------------------------------------------------------------------------
# corrupt streams: the JAX package's typed errors
# ---------------------------------------------------------------------------

@functools.cache
def _corrupt_cases():
    dense = _streams()["dense"][: 1 << 14]
    plain = E.compress(np.full(100, 7, np.uint8))
    bad_magic = plain.copy()
    bad_magic[0] ^= 0xFF
    implausible = plain.copy()
    implausible[4:12] = np.frombuffer(np.uint64(10**12).tobytes(), np.uint8)
    sde4 = E.compress(_streams()["wide"], stored_ok=False).copy()
    comp = np.frombuffer(sde4[12:44].tobytes(), np.uint64).copy()
    comp[0], comp[1] = np.uint64(2**64 - 50), np.uint64(50 + int(comp[1]))
    sde4[12:44] = np.frombuffer(comp.tobytes(), np.uint8)
    sparse = E.compress_sparse(_streams()["sparse"], **CPU)
    flip = sparse.copy()
    flip[20] ^= 1
    nib = E.compress_dense(dense)
    stray = nib.copy()
    stray[20] ^= 0x40
    nib_count = nib.copy()
    nib_count[4:12] = np.frombuffer(np.uint64(1 << 40).tobytes(), np.uint8)
    return {
        "truncated": np.zeros(10, np.uint8),
        "bad_magic": bad_magic,
        "bad_magic_bytes": bad_magic.tobytes(),
        "implausible_count": implausible,
        "wrapping_chunk_sizes": sde4,
        "sparse_short": sparse[:10],
        "sparse_cut_header": sparse[:24],
        "sparse_bitmap_count": flip,
        "nib_cut_3": nib[:3], "nib_cut_12": nib[:12], "nib_cut_19": nib[:19],
        "nib_cut_last": nib[:-1],
        "nib_bitmap_count": stray,
        "nib_implausible_count": nib_count,
    }


CORRUPT = ("truncated", "bad_magic", "bad_magic_bytes", "implausible_count",
           "wrapping_chunk_sizes", "sparse_short", "sparse_cut_header",
           "sparse_bitmap_count", "nib_cut_3", "nib_cut_12", "nib_cut_19",
           "nib_cut_last", "nib_bitmap_count", "nib_implausible_count")


@pytest.mark.parametrize("case", CORRUPT)
def test_corrupt_stream_typed(case):
    blob = _corrupt_cases()[case]
    with pytest.raises(JE.EntropyError):
        JE.decompress(blob)
    with pytest.raises(E.EntropyError):
        E.decompress(blob)
    with pytest.raises(E.EntropyError):
        E.decompress_to_device(blob, **CPU)


def test_pad_bit_attack_typed():
    """Clearing the one real escape bit of the last bitmap byte and
    setting a pad bit keeps the byte's popcount; both routes refuse it."""
    n = 4097
    rec = np.full(n, 127, np.uint8)
    rec[4096] = 250
    blob = E.compress_dense(rec, max_escape_frac=1.0)
    _same(blob, JE.compress_dense(rec, max_escape_frac=1.0))
    last = 20 + (n + 7) // 8 - 1
    assert blob[last] == 0x01
    bad = blob.copy()
    bad[last] = 0x80
    for call in (lambda: E.decompress(bad),
                 lambda: E.decompress_to_device(bad, **CPU)):
        with pytest.raises(E.EntropyError):
            call()
    np.testing.assert_array_equal(E.decompress_to_device(blob, **CPU), rec)


def test_empty_input_typed():
    for call in (lambda: E.compress(np.zeros(0, np.uint8)),
                 lambda: E.compress(np.zeros(0, np.uint8), rle=True),
                 lambda: E.compress_dense(np.zeros(0, np.uint8)),
                 lambda: E.compress_dense(torch.zeros(0, dtype=torch.uint8)),
                 lambda: E.compress_sparse(np.zeros(0, np.uint8), **CPU)):
        with pytest.raises(E.EntropyError):
            call()


# ---------------------------------------------------------------------------
# faults of the JAX package the port does not copy
# ---------------------------------------------------------------------------

def test_expand_slots_are_int64():
    """The device expansions number escapes and kept blocks with an int64
    cumsum (the JAX package's int32 one wraps past 2**31 symbols)."""
    flags = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.bool)
    slots = E._slots(flags, 3)
    assert slots.dtype == torch.int64
    assert slots.tolist() == [0, 0, 1, 1, 2, 2, 2, 2]      # clipped to 3
    # past 2**31: the int64 count keeps climbing where int32 would wrap
    big = torch.tensor([2**31 - 1, 1, 1], dtype=torch.int64)
    assert torch.cumsum(big, 0, dtype=torch.int64)[-1] == 2**31 + 1
    assert torch.cumsum(big.to(torch.int32), 0, dtype=torch.int32)[-1] < 0


def test_histogram_counts_in_one_int64_pass(monkeypatch):
    """One count over the whole stream, no 2**31-byte slices (the JAX
    package slices only because its TPU lacks an i64 scatter): one sort of
    every byte, int64 counts equal to the native loop's."""
    calls = []
    real = torch.sort

    def spy(x, *a, **kw):
        calls.append((x.numel(), x.dtype))
        return real(x, *a, **kw)

    monkeypatch.setattr(torch, "sort", spy)
    x = torch.from_numpy(_streams()["mode32"])
    hist = E.histogram(x)
    assert calls == [(x.numel(), torch.uint8)]
    assert E.histogram_tensor(x).dtype == torch.int64
    np.testing.assert_array_equal(hist, E.histogram(x, device=False))


@pytest.mark.parametrize("n", [0, 1, 4097])
def test_histogram_tensor_in_chunks(monkeypatch, n):
    """A stream longer than the sort's chunk is counted chunk by chunk
    into the same int64 counts; empty and one-byte streams count too."""
    monkeypatch.setattr(E, "_HIST_CHUNK", 1000)
    x = torch.from_numpy(
        np.random.default_rng(n).integers(0, 256, n, np.uint8))
    np.testing.assert_array_equal(E.histogram_tensor(x).numpy(),
                                  np.bincount(x.numpy(), minlength=256))


def test_stored_precheck_is_a_lower_bound(monkeypatch):
    """Over seeded inputs, streams and sizes: where the pre-check picks the
    stored escape, the pack would come out at least 12 + n bytes, so the
    stream equals the post-check's; incompressible K=128 input skips the
    pack."""
    rng = np.random.default_rng(1)
    fired = 0
    for trial in range(24):
        n = int(rng.integers(300, 12_000))
        alphabet = int(rng.choice([2, 100, 180, 230, 256]))
        x = rng.integers(0, alphabet, n, dtype=np.uint8)
        hist = E.histogram(x, device=False)
        lengths = E.build_lengths(hist)
        bits = int((hist * lengths.astype(np.uint64)).sum())
        for k in (1, 4, 8, 128):
            if E._pack_header_bytes(k) + bits // 8 >= 12 + n:
                fired += 1
                full = E.compress(x, streams=k, stored_ok=False)
                assert full.size >= 12 + n, (trial, k)
                assert _magic(E.compress(x, streams=k)) == b"SDE0"
    assert fired >= 10
    lib = E._load()
    monkeypatch.setattr(lib, "entropy_encode_g",
                        lambda *a: pytest.fail("packed a stored stream"))
    assert _magic(E.compress(_streams()["wide"], streams=128)) == b"SDE0"


def test_stored_precheck_keeps_the_smaller_pack():
    """In the window the JAX package's fixed +600 slack misjudges (an SDE4
    pack 300 header bytes over its payload, smaller than 12 + n), the port
    keeps the Huffman pack, which is smaller than the JAX package's SDE0
    blob, and each package decodes the other's."""
    x = np.tile(np.arange(128, dtype=np.uint8), 25)      # 7 bits a byte
    ours, theirs = E.compress(x), JE.compress(x)
    assert _magic(ours) == b"SDE4" and _magic(theirs) == b"SDE0"
    assert ours.size < theirs.size == 12 + x.size
    _same(ours, E.compress(x, stored_ok=False))
    np.testing.assert_array_equal(JE.decompress(ours), x)
    np.testing.assert_array_equal(E.decompress(theirs), x)


def test_native_builds_into_the_port_and_names_failures(tmp_path,
                                                        monkeypatch):
    assert native.build("entropy").startswith(native.BUILD_DIR)
    assert "-march=native" not in " ".join(native.FLAGS["entropy"])
    monkeypatch.setattr(native, "SOURCE_DIR", str(tmp_path))
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.build("entropy")
    (tmp_path / "entropy.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(native.NativeBuildError, match="entropy.cpp"):
        native.build("entropy")


# ---------------------------------------------------------------------------
# the strict-IEEE oracle through the port's loader
# ---------------------------------------------------------------------------

ORACLE = ("encode_quantize", "encode_quantize_pair", "encode_quantize32",
          "encode_quantize_stereo", "decode_quantize", "decode_quantize_pair",
          "decode_quantize32", "decode_quantize_stereo", "dct2d_fx",
          "dct2d_fy")


@pytest.mark.parametrize("call", ORACLE)
def test_native_oracle_matches_jax(call):
    """The port's ``native`` oracle API gives the JAX package's ``native``
    bytes (one C++ source, built apart into the port's build directory)."""
    from simd_dct_tpu import native as JN
    rng = np.random.default_rng(len(call))
    img = _smooth_image(64, 128, seed=len(call))
    lut = default_quant_lut(50)
    rec = rng.integers(96, 160, 64 * 128, dtype=np.uint8)
    name = call.removesuffix("_pair")
    kw = {"layout": "pair"} if call.endswith("_pair") else {}
    if name.startswith("encode"):
        lut = lut * np.float32(255.0) if name.endswith("32") else lut
        args = (img, lut, 8, 40)
        kw.update(rounding="clamp_first")
    elif name.startswith("decode"):
        lut = lut * np.float32(255.0) if name.endswith("32") else lut
        args = (rec[: 64 * 128 if "stereo" in name else 32 * 128], lut, 128,
                64)
    else:
        blocks = rng.uniform(-128, 127, (5, 64)).astype(np.float32)
        name, args, kw = "dct2d_blocks", (blocks, call[-2:]), {}
    got, want = (getattr(m, name)(*args, **kw) for m in (native, JN))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    if name != "dct2d_blocks":
        assert got.any()
