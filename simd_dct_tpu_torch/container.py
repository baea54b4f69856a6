"""Self-describing containers for encoded frames: ``.sdt`` (one frame) and
``.sdtv`` (a frame batch with a payload each), the counterpart of
``simd_dct_tpu/container.py``, byte for byte: a container written by either
package decodes in the other.

Layout of ``.sdt`` (little-endian), version 1::

    u32  magic "SDTC" | u16 version | u8 mode | u8 rounding
    u32  size_x | u32 size_y | u32 start_y | u32 end_y
    u8   flags (bit0 entropy-packed, bit1 has chroma LUT, bit2 stereo
         planar, bit3 stereo native) | u8 pad[3]
    f32  luma_lut[64]
    f32  chroma_lut[64]          -- only when flags bit1
    u64  payload_bytes | payload

``.sdtv`` has the magic "SDTV", the frame count in place of the strip
range, and a u64 payload size per frame before the payloads.  The payload
is the mode's records, flattened row-major as ``convert.records_to_numpy``
gives them (stereo planar and native: (2, 64, S, BW[P])), raw or wrapped by
the entropy coder.  LUTs are stored in the domain the mode uses (mode32 and
the colour modes: 255x the normalized table), so decode applies them as
they are.

Device rule: an image or frame batch given as a tensor is encoded where it
lies; other input goes to ``device``, the card unless the call names
another.  A decode unpacks on its target device (``device``, the card
unless it names another): the host decompress for the CPU, the device
expansion otherwise.

Command line (``python -m simd_dct_tpu_torch.container``)::

    info FILE                  print the header of a .sdt or .sdtv file
    decode FILE OUT [--device cpu]
                               decode it to raw u8 (the card by default)
"""

from __future__ import annotations

import dataclasses
import struct
import sys

import numpy as np
import torch

from . import entropy
from .dispatch.capability import default_device

MAGIC = b"SDTC"
VERSION = 1

MODES = ("enc-quant", "enc-quant-pair", "enc-quant32", "enc-quant-stereo",
         "enc-quant32-ycbcr", "enc-quant32-ycbcr420")
_ROUNDINGS = ("rne", "scalar", "clamp_first")
_COLOR_MODES = ("enc-quant32-ycbcr", "enc-quant32-ycbcr420")

_FLAG_PACKED = 1
_FLAG_CHROMA = 2
_FLAG_STEREO_PLANAR = 4     # stereo views apart: (2, 64, S, W/8)
_FLAG_STEREO_NATIVE = 8     # (2, 64, S, BWP), rows padded with 127

_FIXED = struct.Struct("<4sHBBIIIIB3x")


class ContainerError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class FrameMeta:
    """Everything needed to decode the payload."""
    mode: str
    size_x: int
    size_y: int
    luma_lut: np.ndarray                  # f32[64], the mode's domain
    chroma_lut: np.ndarray | None = None  # f32[64] for the colour modes
    rounding: str = "rne"
    start_y: int = 0
    end_y: int | None = None
    packed: bool = False                  # payload is an entropy stream
    stereo_planar: bool = False           # stereo views stored apart
    stereo_native: bool = False           # 128-multiple padded plane rows


def pack(payload, meta: FrameMeta) -> np.ndarray:
    """Frame a record buffer (or entropy stream) into a .sdt container."""
    if meta.mode not in MODES:
        raise ContainerError(f"mode must be one of {MODES}")
    if meta.rounding not in _ROUNDINGS:
        raise ContainerError(f"rounding must be one of {_ROUNDINGS}")
    luma = np.ascontiguousarray(meta.luma_lut, np.float32).reshape(-1)
    if luma.size != 64:
        raise ContainerError("luma_lut must have 64 entries")
    flags = _FLAG_PACKED if meta.packed else 0
    if meta.stereo_planar and meta.stereo_native:
        raise ContainerError(
            "stereo_planar and stereo_native are mutually exclusive")
    if meta.stereo_planar or meta.stereo_native:
        if meta.mode != "enc-quant-stereo":
            raise ContainerError(
                "stereo view layouts only apply to enc-quant-stereo")
        flags |= (_FLAG_STEREO_PLANAR if meta.stereo_planar
                  else _FLAG_STEREO_NATIVE)
    chroma = b""
    if meta.chroma_lut is not None:
        c = np.ascontiguousarray(meta.chroma_lut, np.float32).reshape(-1)
        if c.size != 64:
            raise ContainerError("chroma_lut must have 64 entries")
        flags |= _FLAG_CHROMA
        chroma = c.tobytes()
    data = entropy.as_u8_stream(payload)
    end_y = meta.size_y if meta.end_y is None else meta.end_y
    head = _FIXED.pack(MAGIC, VERSION, MODES.index(meta.mode),
                       _ROUNDINGS.index(meta.rounding),
                       meta.size_x, meta.size_y, meta.start_y, end_y,
                       flags)
    blob = head + luma.tobytes() + chroma + struct.pack("<Q", data.size)
    return np.concatenate([np.frombuffer(blob, np.uint8), data])


def _header(data: np.ndarray, fixed: struct.Struct, magic: bytes):
    """The fixed fields after the magic and version checks."""
    if data.size < fixed.size:
        raise ContainerError("container too short")
    fields = fixed.unpack_from(data[:fixed.size].tobytes())
    if fields[0] != magic:
        raise ContainerError("bad container magic")
    if fields[1] != VERSION:
        raise ContainerError(f"unsupported container version {fields[1]}")
    if fields[2] >= len(MODES) or fields[3] >= len(_ROUNDINGS):
        raise ContainerError("corrupt container header")
    return fields


def _luts(data: np.ndarray, pos: int, flags: int):
    """-> (luma, chroma or None, position after them)."""
    if data.size < pos + 256:
        raise ContainerError("container too short")
    luma = np.frombuffer(data[pos:pos + 256].tobytes(), np.float32).copy()
    pos += 256
    chroma = None
    if flags & _FLAG_CHROMA:
        if data.size < pos + 256:
            raise ContainerError("container too short")
        chroma = np.frombuffer(data[pos:pos + 256].tobytes(),
                               np.float32).copy()
        pos += 256
    return luma, chroma, pos


def _layout_flags(flags: int) -> dict:
    if flags & _FLAG_STEREO_PLANAR and flags & _FLAG_STEREO_NATIVE:
        raise ContainerError("corrupt container: both stereo layout bits")
    return dict(packed=bool(flags & _FLAG_PACKED),
                stereo_planar=bool(flags & _FLAG_STEREO_PLANAR),
                stereo_native=bool(flags & _FLAG_STEREO_NATIVE))


def unpack(blob) -> tuple[np.ndarray, FrameMeta]:
    """Container -> (payload bytes, FrameMeta).  Untrusted input: every
    header field is checked before use."""
    data = entropy.as_u8_stream(blob)
    (_, _, mode_i, rounding_i, size_x, size_y, start_y, end_y,
     flags) = _header(data, _FIXED, MAGIC)
    luma, chroma, pos = _luts(data, _FIXED.size, flags)
    if data.size < pos + 8:
        raise ContainerError("container too short")
    (n,) = struct.unpack("<Q", data[pos:pos + 8].tobytes())
    pos += 8
    if n != data.size - pos:
        raise ContainerError("corrupt container: payload size mismatch")
    layout = _layout_flags(flags)
    meta = FrameMeta(mode=MODES[mode_i], size_x=size_x, size_y=size_y,
                     luma_lut=luma, chroma_lut=chroma,
                     rounding=_ROUNDINGS[rounding_i], start_y=start_y,
                     end_y=end_y, **layout)
    # a copy: a slice would alias the caller's blob
    return data[pos:].copy(), meta


# ---------------------------------------------------------------------------
# image <-> container
# ---------------------------------------------------------------------------

def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.asarray(x).shape


def _encode_records(image, mode: str, quality, rounding: str, backend,
                    start_y: int = 0, end_y: int | None = None,
                    view_layout: str = "interleaved", device=None):
    """The mode ladder shared by encode and encode_video: image (or a
    batch) -> (records tensor, luma_lut, chroma_lut) with each mode's LUT
    domain."""
    from . import api
    from .core.quantize import default_quant_lut
    from .layout.color import BASE_CHROMA_QUANT_TABLE

    lut = default_quant_lut(quality)
    kw = dict(rounding=rounding, backend=backend, device=device)
    if mode == "enc-quant":
        return api.encode_quantize(image, lut, start_y, end_y,
                                   layout="scalar", **kw), lut, None
    if mode == "enc-quant-pair":
        return api.encode_quantize(image, lut, start_y, end_y,
                                   layout="pair", **kw), lut, None
    if mode == "enc-quant32":
        luma = lut * np.float32(255.0)
        return api.encode_quantize32(image, luma, start_y, end_y,
                                     **kw), luma, None
    if mode == "enc-quant-stereo":
        return api.encode_quantize_stereo(image, lut, start_y, end_y,
                                          view_layout=view_layout,
                                          **kw), lut, None
    if view_layout != "interleaved":
        raise ContainerError(
            "view_layout only applies to enc-quant-stereo")
    if mode in _COLOR_MODES:
        if start_y != 0 or (end_y is not None
                            and end_y < _shape(image)[-2]):
            # the colour pipeline has no strip range; a header recording
            # one it did not apply would mislead the reader
            raise ContainerError(
                f"{mode} does not support a start_y/end_y range")
        luma = lut * np.float32(255.0)
        q = 1.0 if quality is None else quality
        chroma = (BASE_CHROMA_QUANT_TABLE * q * 255.0).astype(np.float32)
        fn = (api.encode_quantize32_ycbcr420 if mode.endswith("420")
              else api.encode_quantize32_ycbcr)
        return fn(image, luma, chroma, **kw), luma, chroma
    raise ContainerError(f"mode must be one of {MODES}")


def _host_records(rec: torch.Tensor) -> np.ndarray:
    """Records -> flat host bytes, as ``convert.records_to_numpy`` sees
    them."""
    from .convert import records_to_numpy
    return records_to_numpy(rec).reshape(-1)


def encode(image, mode: str = "enc-quant32", *, quality: float | None = None,
           rounding: str = "rne", compress: bool = True, rle: bool = False,
           sparse: bool = False, start_y: int = 0, end_y: int | None = None,
           backend: str | None = None, view_layout: str = "interleaved",
           device=None) -> np.ndarray:
    """u8 image (or (3, H, W) planes for the colour modes) -> self-contained
    .sdt container.  ``compress`` wraps the records in the entropy coder
    (its table from the histogram on the records' device); ``sparse=True``
    drops all-127 64-byte blocks on the device first (SDS1; dense input
    falls back, and ``decode`` needs no flag).  ``view_layout`` (stereo
    only): ``planar`` or ``native`` store the views' planes apart, flagged
    in the header."""
    h, w = (int(d) for d in _shape(image)[-2:])
    rec, luma, chroma = _encode_records(image, mode, quality, rounding,
                                        backend, start_y, end_y,
                                        view_layout=view_layout,
                                        device=device)
    if compress and sparse:
        payload = entropy.compress_sparse(rec.reshape(-1), rle=rle)
    elif compress:
        payload = entropy.compress_records(rec.reshape(-1), rle=rle)
    else:
        payload = _host_records(rec)
    meta = FrameMeta(mode=mode, size_x=w, size_y=h, luma_lut=luma,
                     chroma_lut=chroma, rounding=rounding,
                     start_y=start_y, end_y=end_y, packed=compress,
                     stereo_planar=(view_layout == "planar"),
                     stereo_native=(view_layout == "native"))
    return pack(payload, meta)


def _payload_records(payload: np.ndarray, packed: bool, device,
                     backend) -> torch.Tensor:
    """A frame's payload -> flat records on the target device
    (``default_device``: the host for the numpy tier)."""
    dev = default_device(device, backend)
    if packed:
        return entropy.decompress_on(payload, dev)
    # a copy: on the CPU the tensor would share the caller's blob
    return torch.as_tensor(payload.copy(), device=dev)


def decode(blob, *, backend: str | None = None, compat: bool = False,
           device=None) -> torch.Tensor:
    """.sdt container -> decoded u8 image on ``device`` (the card unless it
    names another, or the host for the numpy tier): the top view; stereo
    gives the whole dual view, the colour modes (3, H/2, W) RGB planes.  On
    the card, SDN1 / SDN2 and SDS1 payloads expand there."""
    payload, m = unpack(blob)
    rec = _payload_records(payload, m.packed, device, backend)
    return _decode_records(rec, m, backend, compat, device)


def info(blob) -> FrameMeta:
    """Header-only parse (the payload is not read)."""
    return unpack(blob)[1]


# ---------------------------------------------------------------------------
# video container: N frames, a payload each (random access), one Huffman
# table from the whole batch
# ---------------------------------------------------------------------------

MAGIC_V = b"SDTV"

_FIXED_V = struct.Struct("<4sHBBIIIB3x")


@dataclasses.dataclass(frozen=True)
class VideoMeta:
    mode: str
    size_x: int
    size_y: int
    n_frames: int
    luma_lut: np.ndarray
    chroma_lut: np.ndarray | None = None
    rounding: str = "rne"
    packed: bool = False
    stereo_planar: bool = False
    stereo_native: bool = False


def encode_video(frames, mode: str = "enc-quant32", *,
                 quality: float | None = None, rounding: str = "rne",
                 compress: bool = True, rle: bool = False,
                 sparse: bool = False, backend: str | None = None,
                 view_layout: str = "interleaved",
                 device=None) -> np.ndarray:
    """u8 frame batch (B, H, W), or (B, 3, H, W) planes for the colour
    modes -> self-contained .sdtv container.  The frames are encoded in one
    batched call; each frame's records are packed apart (random access)
    with ONE Huffman table from the whole batch's histogram on the device
    (``rle=True`` streams stay self-contained; ``sparse=True`` per-frame
    SDS1 with the batch's block counts in one device pass)."""
    arr = frames if isinstance(frames, torch.Tensor) else np.asarray(frames)
    want = 4 if mode in _COLOR_MODES else 3
    if arr.ndim != want:
        raise ContainerError(f"{mode} expects a {want}-D frame batch, got "
                             f"shape {tuple(arr.shape)}")
    b = int(arr.shape[0])
    if b == 0:
        raise ContainerError("empty frame batch")
    h, w = int(arr.shape[-2]), int(arr.shape[-1])
    rec, luma, chroma = _encode_records(arr, mode, quality, rounding,
                                        backend, view_layout=view_layout,
                                        device=device)
    rec = rec.reshape(b, -1)
    if compress and sparse:
        payloads = entropy.compress_sparse_batch(rec, rle=rle)
    elif not compress:
        host = _host_records(rec).reshape(b, -1)
        payloads = [host[i] for i in range(b)]
    elif rle:
        host = _host_records(rec).reshape(b, -1)
        payloads = [entropy.compress(host[i], rle=True) for i in range(b)]
    else:
        lengths = entropy.build_lengths(entropy.histogram(rec))
        host = _host_records(rec).reshape(b, -1)
        k = entropy.default_chunks(host[0].size)
        payloads = [entropy.compress(host[i], lengths, streams=k)
                    for i in range(b)]

    flags = (_FLAG_PACKED if compress else 0) \
        | (_FLAG_STEREO_PLANAR if view_layout == "planar" else 0) \
        | (_FLAG_STEREO_NATIVE if view_layout == "native" else 0) \
        | (_FLAG_CHROMA if chroma is not None else 0)
    parts = [_FIXED_V.pack(MAGIC_V, VERSION, MODES.index(mode),
                           _ROUNDINGS.index(rounding), w, h, b, flags),
             np.ascontiguousarray(luma, np.float32).tobytes()]
    if chroma is not None:
        parts.append(np.ascontiguousarray(chroma, np.float32).tobytes())
    parts.append(np.asarray([p.size for p in payloads], np.uint64).tobytes())
    head = np.frombuffer(b"".join(parts), np.uint8)
    return np.concatenate([head] + payloads)


def _parse_video(blob):
    data = entropy.as_u8_stream(blob)
    (_, _, mode_i, rounding_i, size_x, size_y, n_frames,
     flags) = _header(data, _FIXED_V, MAGIC_V)
    if n_frames == 0 or n_frames > (1 << 24):
        raise ContainerError("corrupt container: implausible frame count")
    luma, chroma, pos = _luts(data, _FIXED_V.size, flags)
    if data.size < pos + 8 * n_frames:
        raise ContainerError("container too short")
    sizes = np.frombuffer(data[pos:pos + 8 * n_frames].tobytes(), np.uint64)
    pos += 8 * n_frames
    # untrusted u64 sizes: bound each term before summing
    budget = data.size - pos
    offs = [pos]
    for s in sizes:
        if int(s) > budget:
            raise ContainerError("corrupt container: payload sizes "
                                 "exceed blob")
        budget -= int(s)
        offs.append(offs[-1] + int(s))
    if offs[-1] != data.size:
        raise ContainerError("corrupt container: payload size mismatch")
    meta = VideoMeta(mode=MODES[mode_i], size_x=size_x, size_y=size_y,
                     n_frames=n_frames, luma_lut=luma, chroma_lut=chroma,
                     rounding=_ROUNDINGS[rounding_i], **_layout_flags(flags))
    return data, offs, meta


def video_info(blob) -> VideoMeta:
    return _parse_video(blob)[2]


def _decode_records(rec: torch.Tensor, m, backend, compat, device):
    """Records of one frame (flat) or a batch ((B, n)) -> the api decode of
    the header's mode."""
    from . import api
    from .layout.stereo import record_shape

    kw = dict(backend=backend, device=device)
    if m.mode == "enc-quant":
        return api.decode_quantize(rec, m.luma_lut, m.size_x, m.size_y,
                                   layout="scalar", compat=compat, **kw)
    if m.mode == "enc-quant-pair":
        return api.decode_quantize(rec, m.luma_lut, m.size_x, m.size_y,
                                   layout="pair", compat=compat, **kw)
    if m.mode == "enc-quant32":
        return api.decode_quantize32(rec, m.luma_lut, m.size_x, m.size_y,
                                     compat=compat, **kw)
    if m.mode == "enc-quant-stereo":
        if m.stereo_planar or m.stereo_native:
            view_layout = "native" if m.stereo_native else "planar"
            shape = record_shape(view_layout, m.size_y, m.size_x)
            want = int(np.prod(shape))
            if rec.ndim == 1 and rec.numel() != want:
                raise ContainerError(
                    f"corrupt container: stereo payload size "
                    f"{rec.numel()} != {want}")
            rec = rec.reshape(shape if rec.ndim == 1 else (-1, *shape))
            return api.decode_quantize_stereo(
                rec, m.luma_lut, m.size_x, m.size_y,
                view_layout=view_layout, compat=compat, **kw)
        return api.decode_quantize_stereo(rec, m.luma_lut, m.size_x,
                                          m.size_y, compat=compat, **kw)
    if m.mode == "enc-quant32-ycbcr420":
        return api.decode_quantize32_ycbcr420(rec, m.luma_lut, m.chroma_lut,
                                              m.size_x, m.size_y, **kw)
    return api.decode_quantize32_ycbcr(rec, m.luma_lut, m.chroma_lut,
                                       m.size_x, m.size_y, **kw)


def decode_video_frame(blob, index: int, *, backend: str | None = None,
                       compat: bool = False, device=None) -> torch.Tensor:
    """Random-access decode of one frame: only its payload is unpacked."""
    data, offs, m = _parse_video(blob)
    if not 0 <= index < m.n_frames:
        raise ContainerError(f"frame index {index} out of range "
                             f"[0, {m.n_frames})")
    rec = _payload_records(data[offs[index]:offs[index + 1]], m.packed,
                           device, backend)
    return _decode_records(rec, m, backend, compat, device)


def decode_video(blob, *, backend: str | None = None, compat: bool = False,
                 device=None) -> torch.Tensor:
    """.sdtv container -> decoded u8 frame batch: each payload unpacked on
    the target device, stacked there, and decoded in one batched call."""
    data, offs, m = _parse_video(blob)
    batch = torch.stack([
        _payload_records(data[offs[i]:offs[i + 1]], m.packed, device,
                         backend)
        for i in range(m.n_frames)])
    return _decode_records(batch, m, backend, compat, device)


def _layout_text(m) -> str:
    if m.stereo_native:
        return " stereo_layout=native"
    if m.stereo_planar:
        return " stereo_layout=planar"
    return ""


def _main(argv=None) -> int:
    """``python -m simd_dct_tpu_torch.container {info,decode} file [out]``"""
    import argparse

    from .api import NotSupportedError

    p = argparse.ArgumentParser(prog="simd_dct_tpu_torch.container")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("info", help="print container metadata")
    pi.add_argument("file")
    pd = sub.add_parser("decode", help="decode a container to raw u8")
    pd.add_argument("file")
    pd.add_argument("out")
    pd.add_argument("--device", default=None,
                    help="where to decode: the card by default; 'cpu' runs "
                         "the plain version on the host")
    args = p.parse_args(argv)

    blob = np.fromfile(args.file, np.uint8)
    is_video = blob.size >= 4 and blob[:4].tobytes() == MAGIC_V
    if args.cmd == "info":
        if is_video:
            m = video_info(blob)
            print(f"video mode={m.mode} size={m.size_x}x{m.size_y} "
                  f"frames={m.n_frames} rounding={m.rounding} "
                  f"packed={m.packed} "
                  f"chroma={'yes' if m.chroma_lut is not None else 'no'}"
                  + _layout_text(m))
        else:
            m = info(blob)
            print(f"mode={m.mode} size={m.size_x}x{m.size_y} "
                  f"rounding={m.rounding} strips=[{m.start_y},{m.end_y}) "
                  f"packed={m.packed} "
                  f"chroma={'yes' if m.chroma_lut is not None else 'no'}"
                  + _layout_text(m))
        return 0
    try:
        dev = default_device(args.device)
    except NotSupportedError:
        print("error: no CUDA device on this machine; pass --device cpu to "
              "decode with the plain version on the host")
        return 1
    out = (decode_video(blob, device=dev) if is_video
           else decode(blob, device=dev)).cpu().numpy()
    out.tofile(args.out)
    print(f"decoded {out.shape} -> {args.out}")
    return 0


if __name__ == "__main__":   # pragma: no cover
    sys.exit(_main())
