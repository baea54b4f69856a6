"""Entropy-coding stage: quantized records -> compressed bitstream
(counterpart of ``simd_dct_tpu/entropy.py``; every stream format is the JAX
package's, byte for byte, so a blob written by either package decodes in
the other).

The division of labour:

* the host packs bits: order-0 canonical Huffman, length-limited to 15 bits,
  run-length coding of the dominant byte, and the nibble-split dense coders
  (SDN1 / SDN2), in the repo's native C++ coder (``native/entropy.cpp``,
  loaded by ``native.py``).  Variable-length bit packing is sequential and
  stays on the host;
* the device holding the records does the passes that shrink what crosses
  to the host, as plain PyTorch ops on the records' own device: the
  256-bin histogram (1 KB crosses instead of the records), the nibble
  split (the escape bitmap, packed nibbles and compacted escapes cross),
  the sparse compaction (the block bitmap and the significant 64-byte
  blocks cross), and on decode the inverse expansions, so a decode uploads
  parts instead of records.

Device rule: a ``torch.Tensor`` is worked on where it lies, on any device
(CPU tensors take the same device path as CUDA ones); a numpy array or
bytes given to a device function goes to ``device``, the card unless the
call names another.  ``compress_dense`` keeps the JAX package's positive
dispatch: only a tensor takes its device split.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import native
from .dispatch.capability import default_device

HEADER_BYTES4 = 4 + 8 + 4 * 8 + 256    # "SDE4" 4-stream header


class EntropyError(RuntimeError):
    pass


def as_u8_stream(blob) -> np.ndarray:
    """Bytes-like or array-like -> flat u8 array.

    ``np.asarray(b"...")`` yields a 0-d S-dtype scalar, so a ``bytes`` blob
    (a stream read back with ``open(...).read()``) goes through
    ``np.frombuffer`` instead of the array path."""
    if isinstance(blob, memoryview) and not blob.contiguous:
        blob = bytes(blob)      # np.frombuffer refuses non-contiguous views
    if isinstance(blob, (bytes, bytearray, memoryview)):
        return np.frombuffer(blob, np.uint8)
    return np.ascontiguousarray(np.asarray(blob), np.uint8).reshape(-1)


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    st, i, ll = ctypes.c_size_t, ctypes.c_int, ctypes.c_longlong
    u64 = ctypes.c_uint64
    sigs = {
        "entropy_histogram": (None, [u8p, st, u64p]),
        "entropy_build_lengths": (i, [u64p, u8p]),
        "entropy_encode_bound": (st, [st]),
        "entropy_encode": (ll, [u8p, st, u8p, u8p, st]),
        "entropy_decode": (ll, [u8p, st, u8p, st]),
        "entropy_encode4_bound": (st, [st]),
        "entropy_encode4": (ll, [u8p, st, u8p, u8p, st]),
        "entropy_decode4": (ll, [u8p, st, u8p, st]),
        "entropy_encode_g_bound": (st, [st, i]),
        "entropy_encode_g": (ll, [u8p, st, u8p, i, u8p, st]),
        "entropy_decode_g": (ll, [u8p, st, u8p, st]),
        "entropy_encode_rle_g_bound": (st, [st, i]),
        "entropy_encode_rle_g": (ll, [u8p, st, i, u8p, st]),
        "entropy_decode_rle_g": (ll, [u8p, st, u8p, st]),
        "entropy_encode_rle_bound": (st, [st]),
        "entropy_encode_rle": (ll, [u8p, st, u8p, st]),
        "entropy_decode_rle": (ll, [u8p, st, u8p, st]),
        "entropy_encode_nib_bound": (st, [st]),
        "entropy_encode_nib": (ll, [u8p, st, u8p, st, u64]),
        "entropy_encode_nib_parts": (ll, [u8p, u8p, u8p, u64, u64, u8p,
                                          st]),
        "entropy_decode_nib": (ll, [u8p, st, u8p, st]),
        "entropy_encode_nib2_bound": (st, [st]),
        "entropy_encode_nib2": (ll, [u8p, st, u8p, st, u64]),
        "entropy_decode_nib2": (ll, [u8p, st, u8p, st]),
        "entropy_encode_nib2_parts": (ll, [u8p, u8p, u8p, u8p, u64, u64,
                                           u8p, st]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def _load() -> ctypes.CDLL:
    return native.library("entropy", _declare)


_u8p = native.u8p


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# ---------------------------------------------------------------------------
# moving records between the device and the host
# ---------------------------------------------------------------------------

def _device_bytes(records, device=None) -> torch.Tensor:
    """Records -> flat u8 tensor.  A tensor stays on its device; anything
    else goes to ``device``, the card unless it names another."""
    if isinstance(records, torch.Tensor):
        t = records if records.dtype == torch.uint8 \
            else records.to(torch.uint8)
        return t.reshape(-1)
    arr = as_u8_stream(records)
    if not arr.flags.writeable:     # torch warns on read-only buffers
        arr = arr.copy()
    return torch.as_tensor(arr, device=default_device(device))


def _host_bytes(records) -> np.ndarray:
    """Records (a tensor on any device, or host data) -> flat u8 array."""
    if isinstance(records, torch.Tensor):
        return _host(_device_bytes(records))
    return as_u8_stream(records)


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def _packbits(bits: torch.Tensor) -> torch.Tensor:
    """(8k,) bool -> (k,) u8, least significant bit first (numpy's
    ``packbits(bitorder="little")``)."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (bits.reshape(-1, 8).to(torch.uint8) * w).sum(1, dtype=torch.uint8)


def _unpackbits(packed: torch.Tensor) -> torch.Tensor:
    """(k,) u8 -> (8k,) bool, least significant bit first (torch has no
    ``unpackbits``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed.reshape(-1, 1) >> shifts) & 1).reshape(-1).bool()


def _slots(flags: torch.Tensor, cap: int) -> torch.Tensor:
    """Each position's slot among the set flags (their count before it),
    clipped into [0, cap) as the gather needs.  Counted in int64: an int32
    count wraps past 2**31 flags."""
    return (torch.cumsum(flags, 0, dtype=torch.int64) - 1).clamp_(0, cap - 1)


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

def histogram(records, *, device=True) -> np.ndarray:
    """256-bin u64 histogram of u8 records.  ``device=False`` counts host
    bytes with the native loop.  Otherwise the count runs on a device
    (``histogram_tensor``) and only the 256 counts cross to the host: a
    tensor's own device, or for other input the card (``device=True``) or
    the device named."""
    if device is False:
        data = _host_bytes(records)
        out = np.zeros(256, np.uint64)
        _load().entropy_histogram(_u8p(data), data.size, _u64p(out))
        return out
    flat = _device_bytes(records, None if device is True else device)
    return _host(histogram_tensor(flat)).astype(np.uint64)


# bytes sorted at a time by histogram_tensor (its sort's int64 indices
# take 8 bytes a byte)
_HIST_CHUNK = 1 << 28


def histogram_tensor(records: torch.Tensor) -> torch.Tensor:
    """The 256 int64 counts of a u8 tensor as a tensor on its device,
    queued with no host synchronisation (``torch.bincount`` reads the
    maximum back to size its output).  The bytes are sorted and each
    value's count is the step between its end and the previous value's
    (``searchsorted``): record streams are mostly one byte value, which
    serialises the atomic adds of a scatter count (``bincount``,
    ``histc``) on one bin."""
    flat = records.reshape(-1)
    values = torch.arange(256, dtype=torch.uint8, device=flat.device)
    hist = torch.zeros(256, dtype=torch.int64, device=flat.device)
    for part in flat.split(_HIST_CHUNK):
        ends = torch.searchsorted(torch.sort(part)[0], values, right=True)
        hist += torch.diff(ends, prepend=ends.new_zeros(1))
    return hist


def build_lengths(hist) -> np.ndarray:
    """Canonical Huffman code lengths (<= 15 bits) from a histogram."""
    h = np.ascontiguousarray(hist, np.uint64)
    if h.size != 256:
        raise EntropyError("histogram must have 256 bins")
    lengths = np.zeros(256, np.uint8)
    rc = _load().entropy_build_lengths(_u64p(h), _u8p(lengths))
    if rc:
        raise EntropyError(f"build_lengths failed (code {rc})")
    return lengths


# ---------------------------------------------------------------------------
# compress / decompress
# ---------------------------------------------------------------------------

def default_chunks(n_bytes: int) -> int:
    """Stream count for an n-byte input: 4 chains per host core, capped at
    the formats' 128-chunk limit; small inputs stay on the 4-stream
    format."""
    if n_bytes < (1 << 20):
        return 4
    return min(128, max(4, 4 * (os.cpu_count() or 1)))


def _stored(data: np.ndarray) -> np.ndarray:
    """SDE0 stored stream: u32 magic | u64 n | raw bytes, the escape that
    caps a stream's expansion at 12 bytes."""
    out = np.empty(12 + data.size, np.uint8)
    out[:4] = np.frombuffer(np.uint32(_MAGIC0).tobytes(), np.uint8)
    out[4:12] = np.frombuffer(np.uint64(data.size).tobytes(), np.uint8)
    out[12:] = data
    return out


def _pack_header_bytes(streams: int) -> int:
    """Header bytes of the plain Huffman format at this stream count: SDE1
    (magic, n, bit count, lengths), SDE4 (four chunk sizes) or SDEG (K
    chunk sizes)."""
    if streams == 1:
        return 4 + 8 + 8 + 256
    if streams == 4:
        return HEADER_BYTES4
    return 4 + 8 + 4 + 8 * streams + 256


def compress(records, lengths=None, *, streams: int | None = None,
             rle: bool = False, stored_ok: bool = True) -> np.ndarray:
    """u8 records -> self-contained compressed stream (u8 array: header +
    payload).  ``lengths`` (from ``build_lengths``) may be reused across
    frames with matching statistics; by default the table comes from this
    input's own histogram.  Where the coded stream would be no smaller than
    the input, the 12-byte SDE0 stored format is written instead
    (``stored_ok=False`` keeps the requested format).  ``streams``: 1 (SDE1),
    4 (SDE4) or another count in [2, 128] (SDEG, K chunks); by default 4
    below 1 MB and ``default_chunks`` above.

    ``rle=True`` run-length codes the dominant byte before the Huffman pack
    (SDER, or SDGR with an explicit ``streams`` or more than 4 chunks); its
    table always comes from the transformed stream (``lengths`` ignored).

    With its own table, the exact payload size is known from the histogram
    before the pack, so a stream that cannot come out smaller than the
    stored one goes straight to SDE0: the pre-check compares the least
    size of the chosen format (its header at that stream count plus the
    payload bits) with 12 + n, so it picks SDE0 only where the pack would
    come out at least as large."""
    data = as_u8_stream(records)
    lib = _load()
    if rle:
        if data.size == 0:
            raise EntropyError("empty input has no code")
        k = default_chunks(data.size) if streams is None else int(streams)
        if not 1 <= k <= 128:
            raise EntropyError("streams must be in [1, 128]")
        if streams is not None or k > 4:
            out = np.zeros(lib.entropy_encode_rle_g_bound(data.size, k),
                           np.uint8)
            n = lib.entropy_encode_rle_g(_u8p(data), data.size, k,
                                         _u8p(out), out.size)
        else:
            out = np.zeros(lib.entropy_encode_rle_bound(data.size),
                           np.uint8)
            n = lib.entropy_encode_rle(_u8p(data), data.size, _u8p(out),
                                       out.size)
        if n < 0:
            raise EntropyError(f"encode failed (code {n})")
        if stored_ok and n >= 12 + data.size:
            return _stored(data)
        return out[:n].copy()
    if streams is None:
        streams = 4 if data.size < (1 << 20) else default_chunks(data.size)
    if not 1 <= streams <= 128:
        raise EntropyError("streams must be in [1, 128]")
    own_table = lengths is None
    if own_table:
        hist = histogram(data, device=False)
        lengths = build_lengths(hist)
    lengths = np.ascontiguousarray(lengths, np.uint8)
    if stored_ok and own_table:
        bits = int((hist * lengths.astype(np.uint64)).sum())
        if _pack_header_bytes(streams) + bits // 8 >= 12 + data.size:
            return _stored(data)
    if streams == 4:
        out = np.zeros(lib.entropy_encode4_bound(data.size), np.uint8)
        n = lib.entropy_encode4(_u8p(data), data.size, _u8p(lengths),
                                _u8p(out), out.size)
    elif streams == 1:
        out = np.zeros(lib.entropy_encode_bound(data.size), np.uint8)
        n = lib.entropy_encode(_u8p(data), data.size, _u8p(lengths),
                               _u8p(out), out.size)
    else:
        out = np.zeros(lib.entropy_encode_g_bound(data.size, streams),
                       np.uint8)
        n = lib.entropy_encode_g(_u8p(data), data.size, _u8p(lengths),
                                 streams, _u8p(out), out.size)
    if n < 0:
        raise EntropyError(f"encode failed (code {n})")
    if stored_ok and n >= 12 + data.size:
        return _stored(data)
    # a copy: out[:n] would keep the bound-sized scratch alive
    return out[:n].copy()


_MAGIC0 = 0x30454453   # "SDE0" (stored, no entropy coding)
_MAGIC1 = 0x31454453   # "SDE1"
_MAGIC4 = 0x34454453   # "SDE4"
_MAGICR = 0x52454453   # "SDER"
_MAGICG = 0x47454453   # "SDEG" (K chunks)
_MAGICGR = 0x52474453  # "SDGR" (K-chunk RLE)
_MAGICN = 0x314E4453   # "SDN1" (nibble split, 16-value window)
_MAGICN2 = 0x324E4453  # "SDN2" (32-value window)

_NIB_BASE = 119            # window [119, 134]; must match native kNibBase
_NIB2_BASE = 111           # window [111, 142]; must match kNib2Base


def _split_input(records, base: int, device) -> tuple[torch.Tensor, int]:
    """Flat device records padded to a multiple of 8 with the window base
    (delta 0: pad nibbles 0 and pad bits clear, as the native tail)."""
    flat = _device_bytes(records, device)
    n = flat.numel()
    if n == 0:
        raise EntropyError("empty input has no code")
    pad = (-n) % 8
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), base)])
    return flat, n


def nib_split_device(records, *, max_escape_frac: float | None = None,
                     device=None):
    """Records -> the SDN1 parts, made on the device: ``(bitmap,
    packed_nibbles, escapes, n)`` as host arrays, bit for bit the native
    host split's (feed them to ``compress_dense_parts``).  With
    ``max_escape_frac`` set, returns None when more bytes than that escape
    the window (checked before the escapes are gathered)."""
    flat, n = _split_input(records, _NIB_BASE, device)
    d = flat.to(torch.int16) - _NIB_BASE
    esc = (d < 0) | (d > 15)
    count = int(esc.sum())
    if max_escape_frac is not None and count > max_escape_frac * n:
        return None
    nibv = torch.where(esc, 0, d).to(torch.uint8)
    packed = nibv[0::2] | (nibv[1::2] << 4)
    return (_host(_packbits(esc)), _host(packed[: (n + 1) // 2]),
            _host(flat[esc]), n)


def nib2_split_device(records, *, max_escape_frac: float | None = None,
                      device=None):
    """Records -> the SDN2 parts, made on the device: ``(bitmap,
    bit4_plane, packed_nibbles, escapes, n)`` as host arrays; None when
    ``max_escape_frac`` is set and exceeded.  Feed them to
    ``compress_dense_parts2``."""
    flat, n = _split_input(records, _NIB2_BASE, device)
    d = flat.to(torch.int16) - _NIB2_BASE
    esc = (d < 0) | (d > 31)
    count = int(esc.sum())
    if max_escape_frac is not None and count > max_escape_frac * n:
        return None
    dm = torch.where(esc, 0, d)
    nibv = (dm & 15).to(torch.uint8)
    packed = nibv[0::2] | (nibv[1::2] << 4)
    return (_host(_packbits(esc)), _host(_packbits(((dm >> 4) & 1).bool())),
            _host(packed[: (n + 1) // 2]), _host(flat[esc]), n)


def compress_dense_parts2(bitmap, bit4, nibbles, escapes,
                          n: int) -> np.ndarray:
    """Assemble an SDN2 stream from its parts."""
    bm = np.ascontiguousarray(bitmap, np.uint8)
    b4 = np.ascontiguousarray(bit4, np.uint8)
    pk = np.ascontiguousarray(nibbles, np.uint8)
    esc = np.ascontiguousarray(escapes, np.uint8).reshape(-1)
    lib = _load()
    out = np.empty(lib.entropy_encode_nib2_bound(n), np.uint8)
    r = lib.entropy_encode_nib2_parts(_u8p(bm), _u8p(b4), _u8p(pk),
                                      _u8p(esc), n, esc.size,
                                      _u8p(out), out.size)
    if r < 0:
        raise EntropyError(f"encode failed (code {r})")
    out.resize(r, refcheck=False)
    return out


def compress_dense_parts(bitmap, nibbles, escapes, n: int) -> np.ndarray:
    """Assemble an SDN1 stream from its parts: the header, the planes and
    the escapes' Huffman pack, under the native host split's payload
    policy."""
    bm = np.ascontiguousarray(bitmap, np.uint8)
    pk = np.ascontiguousarray(nibbles, np.uint8)
    esc = np.ascontiguousarray(escapes, np.uint8).reshape(-1)
    lib = _load()
    out = np.empty(lib.entropy_encode_nib_bound(n), np.uint8)
    r = lib.entropy_encode_nib_parts(_u8p(bm), _u8p(pk), _u8p(esc),
                                     n, esc.size, _u8p(out), out.size)
    if r < 0:
        raise EntropyError(f"encode failed (code {r})")
    out.resize(r, refcheck=False)
    return out


def _compress_dense_device(records: torch.Tensor,
                           max_escape_frac: float) -> np.ndarray:
    """A tensor -> SDN1 (or SDN2) by the split on its device: the host gets
    the parts and only assembles the stream, byte for byte the host
    split's."""
    parts = nib_split_device(records, max_escape_frac=max_escape_frac)
    if parts is None:
        p2 = nib2_split_device(records, max_escape_frac=max_escape_frac)
        if p2 is None:
            # both windows too narrow: one full fetch and the plain pack
            return compress(_host_bytes(records))
        out2 = compress_dense_parts2(*p2)
        if out2.size >= 12 + p2[-1]:
            return _stored(_host_bytes(records))
        return out2
    out = compress_dense_parts(*parts)
    if out.size >= 12 + parts[-1]:
        return _stored(_host_bytes(records))
    return out


def compress_dense(records, *, max_escape_frac: float = 0.35) -> np.ndarray:
    """u8 records -> SDN1 nibble-split stream, the dense-content fast path:
    each byte becomes a 4-bit delta over the window [119, 134] plus an
    escape bit, and only the escaped bytes go through the Huffman pack.
    When more than ``max_escape_frac`` of the bytes escape, SDN2 (the
    32-value window [111, 142]), then the plain ``compress`` formats.
    Exact recovery by ``decompress``.

    A ``torch.Tensor`` takes the split on its own device: only the bitmap,
    the packed nibbles and the compacted escapes cross to the host.  Other
    input takes the native host split.  Both give the same bytes."""
    if isinstance(records, torch.Tensor):
        return _compress_dense_device(records, max_escape_frac)
    data = as_u8_stream(records)
    if data.size == 0:
        raise EntropyError("empty input has no code")
    lib = _load()
    out = np.empty(lib.entropy_encode_nib_bound(data.size), np.uint8)
    n = lib.entropy_encode_nib(_u8p(data), data.size, _u8p(out), out.size,
                               int(max_escape_frac * data.size))
    if n == -6:        # too many escapes: decide on SDN2 from a histogram
        hist = histogram(data, device=False)
        esc2 = data.size - int(hist[_NIB2_BASE:_NIB2_BASE + 32].sum())
        if esc2 > max_escape_frac * data.size:
            return compress(data)
        out = np.empty(lib.entropy_encode_nib2_bound(data.size), np.uint8)
        n = lib.entropy_encode_nib2(_u8p(data), data.size, _u8p(out),
                                    out.size,
                                    int(max_escape_frac * data.size))
        if n == -6:    # unreachable given the histogram gate
            return compress(data)
    if n < 0:
        raise EntropyError(f"encode failed (code {n})")
    if n >= 12 + data.size:
        return _stored(data)
    out.resize(n, refcheck=False)
    return out


def _u32(data: np.ndarray, at: int) -> int:
    return int(np.frombuffer(data[at:at + 4].tobytes(), np.uint32)[0])


def _u64(data: np.ndarray, at: int) -> int:
    return int(np.frombuffer(data[at:at + 8].tobytes(), np.uint64)[0])


def _u64_sum(data: np.ndarray, lo: int, hi: int) -> int:
    return sum(int(x) for x in np.frombuffer(data[lo:hi].tobytes(),
                                             np.uint64))


def decompress(blob) -> np.ndarray:
    """Compressed stream -> u8 records (the exact inverse of every
    compressor here), by the stream's magic.  Untrusted input: the header is
    checked before any output is allocated."""
    data = as_u8_stream(blob)
    if data.size < 12:
        raise EntropyError("stream too short")
    magic = _u32(data, 0)
    if magic == _MAGICS:
        return _decompress_sparse(data)
    if magic in (_MAGICN, _MAGICN2):
        if data.size < 20:
            raise EntropyError("stream too short")
        n_out = _u64(data, 4)
        # bitmap + nibbles are ~5/8 byte a symbol: a valid stream decodes
        # to at most ~2x its size
        if n_out == 0 or n_out > 2 * data.size:
            raise EntropyError("corrupt stream: implausible symbol count")
        out = np.zeros(n_out, np.uint8)
        lib = _load()
        fn = (lib.entropy_decode_nib if magic == _MAGICN
              else lib.entropy_decode_nib2)
        n = fn(_u8p(data), data.size, _u8p(out), out.size)
        if n != n_out:
            raise EntropyError(f"decode failed (code {n})")
        return out
    if magic not in (_MAGIC0, _MAGIC1, _MAGIC4, _MAGICR, _MAGICG, _MAGICGR):
        raise EntropyError("bad stream magic")
    n_out = _u64(data, 4)
    if magic == _MAGIC0:
        if n_out != data.size - 12:
            raise EntropyError("corrupt stored stream: size mismatch")
        return data[12:].copy()
    # Plain Huffman spends >= 1 bit a symbol and an RLE run symbol covers
    # <= 255 bytes, so a valid stream decodes to at most 8x (2040x with
    # RLE) its payload, and the chunk-size table must fit in the blob.
    if magic == _MAGICR:
        hdr = 4 + 8 + 4 + 32 + 510
        if data.size < hdr:
            raise EntropyError("stream too short")
        comp = _u64_sum(data, 16, 48)
        if hdr + comp > data.size:
            raise EntropyError("corrupt stream: chunk sizes exceed blob")
        limit = 2040 * max(comp, 1)
    elif magic == _MAGIC4:
        if data.size < HEADER_BYTES4:
            raise EntropyError("stream too short")
        comp = _u64_sum(data, 12, 44)
        if HEADER_BYTES4 + comp > data.size:
            raise EntropyError("corrupt stream: chunk sizes exceed blob")
        limit = 8 * max(comp, 1)
    elif magic in (_MAGICG, _MAGICGR):
        if data.size < 16:
            raise EntropyError("stream too short")
        # SDEG: n_chunks at byte 12; SDGR: run byte at 12, n_chunks at 13
        k = int(data[12] if magic == _MAGICG else data[13])
        hdr = 4 + 8 + 4 + 8 * k + (256 if magic == _MAGICG else 510)
        if not 1 <= k <= 128 or data.size < hdr:
            raise EntropyError("stream too short")
        comp = _u64_sum(data, 16, 16 + 8 * k)
        if hdr + comp > data.size:
            raise EntropyError("corrupt stream: chunk sizes exceed blob")
        limit = (8 if magic == _MAGICG else 2040) * max(comp, 1)
    else:
        limit = 8 * data.size
    if n_out > limit:
        raise EntropyError("corrupt stream: implausible symbol count")
    out = np.zeros(max(n_out, 1), np.uint8)
    lib = _load()
    fn = {_MAGIC4: lib.entropy_decode4, _MAGICR: lib.entropy_decode_rle,
          _MAGICG: lib.entropy_decode_g, _MAGICGR: lib.entropy_decode_rle_g,
          _MAGIC1: lib.entropy_decode}[magic]
    n = fn(_u8p(data), data.size, _u8p(out), out.size)
    if n < 0:
        raise EntropyError(f"decode failed (code {n})")
    return out[:n_out]


# ---------------------------------------------------------------------------
# sparse compaction: all-127 64-byte blocks dropped on the device
# ---------------------------------------------------------------------------
#
# At typical quality most record bytes are the +127-biased zero
# coefficient, and the mode32 byte order groups each vertical frequency into
# 64-byte runs, so whole 64-byte blocks of smooth content are 127.  The
# device flags the significant blocks and compacts them; the host packs only
# the kept bytes.

SPARSE_BLOCK = 64
_MAGICS = 0x31534453   # "SDS1" (sparse: bitmap + compacted blocks)
_SPARSE_HDR = 4 + 8 + 4 + 4    # magic | n u64 | nblk u32 | count u32
_SPARSE_UNIT = 8 * SPARSE_BLOCK


def _significant(blocks: torch.Tensor) -> torch.Tensor:
    return (blocks != 127).any(-1)


def _sparse_blocks(records, device=None) -> tuple[torch.Tensor, int]:
    """Records -> (nblk, 64) device blocks padded with 127 to a multiple of
    8 blocks, and the byte count.  Non-tensor input goes to ``device``, the
    card unless it names another."""
    flat = _device_bytes(records, device)
    n = flat.numel()
    if n == 0:
        raise EntropyError("empty input has no code")
    pad = (-n) % _SPARSE_UNIT
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), 127)])
    return flat.reshape(-1, SPARSE_BLOCK), n


def _finish_sparse(blocks: torch.Tensor, n: int, count: int, rle: bool,
                   max_kept_frac: float, fallback=None,
                   dense_fast: bool = True,
                   payload_fast: bool = False) -> np.ndarray:
    """The tail of the sparse pipelines for ONE stream whose significant
    block ``count`` is known: the compaction and the SDS1 header, or the
    dense fallback.  ``fallback``: the original host bytes for the dense
    path (saves a fetch of the records); ``dense_fast``: the dense path
    takes the SDN1 coder instead of the plain pack (rle always takes the
    plain rle pack); ``payload_fast``: SDN1 on the kept blocks (faster,
    at a lower ratio than the plain payload)."""
    nblk = blocks.shape[0]
    if count > max_kept_frac * nblk:
        if dense_fast and not rle:
            if fallback is not None:
                return compress_dense(as_u8_stream(fallback))
            return compress_dense(blocks.reshape(-1)[:n])    # device split
        if fallback is None:
            fallback = _host_bytes(blocks.reshape(-1)[:n])
        return compress(as_u8_stream(fallback), rle=rle)
    flags = _significant(blocks)
    bm = _host(_packbits(flags))
    if count and payload_fast and not rle:
        payload = compress_dense(blocks[flags].reshape(-1))
    elif count:
        payload = compress(_host_bytes(blocks[flags]), rle=rle)
    else:
        payload = np.zeros(0, np.uint8)
    out = np.empty(_SPARSE_HDR + bm.size + payload.size, np.uint8)
    out[:4] = np.frombuffer(np.uint32(_MAGICS).tobytes(), np.uint8)
    out[4:12] = np.frombuffer(np.uint64(n).tobytes(), np.uint8)
    out[12:16] = np.frombuffer(np.uint32(nblk).tobytes(), np.uint8)
    out[16:20] = np.frombuffer(np.uint32(count).tobytes(), np.uint8)
    out[20:20 + bm.size] = bm
    out[20 + bm.size:] = payload
    return out


def compress_sparse(records, *, rle: bool = False,
                    max_kept_frac: float = 0.85, dense_fast: bool = True,
                    payload_fast: bool = False, device=None) -> np.ndarray:
    """u8 records -> compressed stream, with the all-127 64-byte blocks
    dropped on the device before the host pack (SDS1).  Dense input (more
    than ``max_kept_frac`` of the blocks significant) falls back to SDN1
    (``dense_fast``) or the plain formats; every result decodes by
    ``decompress``.  A tensor is compacted where it lies; other input goes
    to ``device``, the card unless it names another."""
    blocks, n = _sparse_blocks(records, device)
    count = int(_significant(blocks).sum())
    if isinstance(records, (bytes, bytearray, memoryview, np.ndarray)):
        fallback = as_u8_stream(records)
    else:
        fallback = None         # a tensor: one fetch either way
    return _finish_sparse(blocks, n, count, rle, max_kept_frac, fallback,
                          dense_fast=dense_fast, payload_fast=payload_fast)


def compress_sparse_batch(records, *, rle: bool = False,
                          max_kept_frac: float = 0.85,
                          dense_fast: bool = True,
                          payload_fast: bool = False,
                          device=None) -> list:
    """(B, N) u8 record batch -> B streams that decode apart, with the
    significant block counts of every frame from one device pass.  A
    tensor batch stays on its device; a dense frame is fetched only if it
    takes the fallback."""
    host = records if isinstance(records, np.ndarray) else None
    if isinstance(records, torch.Tensor):
        dev = records if records.dtype == torch.uint8 \
            else records.to(torch.uint8)
    else:
        arr = np.ascontiguousarray(np.asarray(records), np.uint8)
        dev = torch.as_tensor(arr if arr.flags.writeable else arr.copy(),
                              device=default_device(device))
    if dev.ndim != 2:
        raise EntropyError("compress_sparse_batch expects a (B, N) batch")
    b, n = dev.shape
    if n == 0:
        raise EntropyError("empty input has no code")
    pad = (-n) % _SPARSE_UNIT
    if pad:
        dev = torch.cat([dev, dev.new_full((b, pad), 127)], dim=1)
    blocks = dev.reshape(b, -1, SPARSE_BLOCK)
    counts = _host(_significant(blocks).sum(1))
    return [_finish_sparse(blocks[i], n, int(counts[i]), rle, max_kept_frac,
                           fallback=None if host is None else host[i],
                           dense_fast=dense_fast, payload_fast=payload_fast)
            for i in range(b)]


def _parse_sparse(data: np.ndarray):
    """Checked SDS1 parse -> (n, nblk, count, flags, kept) with the payload
    decoded on the host (shared by the host rebuild and the device
    expansion)."""
    if data.size < _SPARSE_HDR:
        raise EntropyError("stream too short")
    n = _u64(data, 4)
    nblk = _u32(data, 12)
    count = _u32(data, 16)
    if nblk % 8 or nblk == 0 or count > nblk:
        raise EntropyError("corrupt sparse stream: bad block counts")
    if not nblk * SPARSE_BLOCK - _SPARSE_UNIT < max(n, 1) \
            <= nblk * SPARSE_BLOCK:
        raise EntropyError("corrupt sparse stream: size mismatch")
    bm_bytes = nblk // 8
    if data.size < _SPARSE_HDR + bm_bytes:
        raise EntropyError("stream too short")
    bitmap = data[_SPARSE_HDR:_SPARSE_HDR + bm_bytes]
    flags = np.unpackbits(bitmap, bitorder="little").astype(bool)
    if int(flags.sum()) != count:
        raise EntropyError("corrupt sparse stream: bitmap/count mismatch")
    if count:
        payload = data[_SPARSE_HDR + bm_bytes:]
        if payload.size >= 4 and _u32(payload, 0) == _MAGICS:
            # no encoder nests SDS1; a crafted chain would recurse
            raise EntropyError("corrupt sparse stream: nested SDS1")
        kept = decompress(payload)
        if kept.size != count * SPARSE_BLOCK:
            raise EntropyError("corrupt sparse stream: payload size")
    else:
        kept = np.zeros(0, np.uint8)
    return n, nblk, count, flags, kept


def _decompress_sparse(data: np.ndarray) -> np.ndarray:
    n, nblk, count, flags, kept = _parse_sparse(data)
    out = np.full((nblk, SPARSE_BLOCK), 127, np.uint8)
    out[flags] = kept.reshape(count, SPARSE_BLOCK)
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# device expansion: the decode twins of the compaction and the splits
# ---------------------------------------------------------------------------

def expand_sparse_device(bitmap, kept, n_bytes: int, *, device=None):
    """(bitmap bytes, (count, 64) kept blocks) -> flat u8 records on the
    device (``device``, the card unless it names another; a tensor
    ``bitmap`` keeps its own).  ``kept`` may hold rows beyond the count:
    the bitmap decides."""
    bm = _device_bytes(bitmap, device)
    flags = _unpackbits(bm)
    kb = _device_bytes(kept, bm.device).reshape(-1, SPARSE_BLOCK)
    if kb.shape[0] == 0:
        kb = kb.new_full((1, SPARSE_BLOCK), 127)
    out = torch.where(flags[:, None], kb[_slots(flags, kb.shape[0])], 127)
    return out.reshape(-1)[:n_bytes]


def _nibble_base(nibbles: torch.Tensor, base: int, size: int):
    """Packed nibbles -> (size,) u8 window values, low nibble first, zero
    past the nibbles."""
    vals = torch.stack([nibbles & 15, nibbles >> 4], 1).reshape(-1) + base
    if vals.numel() < size:
        vals = torch.cat([vals, vals.new_zeros(size - vals.numel())])
    return vals[:size]


def _escape_values(escapes, dev) -> torch.Tensor:
    esc = _device_bytes(escapes, dev)
    return esc if esc.numel() else esc.new_zeros(1)


def _expand_nib(flags: torch.Tensor, nibbles: torch.Tensor, escapes,
                n_bytes: int, bit4: torch.Tensor | None = None):
    """SDN1 (or, with the fifth-bit flags ``bit4``, SDN2) parts on one
    device -> flat records: the window base plus the nibble, and the
    escapes put back where the flags are set."""
    size = flags.numel()
    base = _nibble_base(nibbles, _NIB_BASE if bit4 is None else _NIB2_BASE,
                        size)
    if bit4 is not None:
        base = base + (bit4[:size].to(torch.uint8) << 4)
    esc = _escape_values(escapes, flags.device)
    out = torch.where(flags, esc[_slots(flags, esc.numel())], base)
    return out[:n_bytes]


def expand_nib_device(bitmap, nibbles, escapes, n_bytes: int, *,
                      device=None):
    """SDN1 parts -> flat u8 records on the device: ~0.625n + escape bytes
    go up, and the window base plus nibble, with the escapes put back by
    the bitmap, is rebuilt there."""
    bm = _device_bytes(bitmap, device)
    return _expand_nib(_unpackbits(bm), _device_bytes(nibbles, bm.device),
                       escapes, n_bytes)


def expand_nib2_device(bitmap, bit4, nibbles, escapes, n_bytes: int, *,
                       device=None):
    """SDN2 parts -> flat u8 records on the device (the SDN2 twin of
    ``expand_nib_device``: the fifth-bit plane added)."""
    bm = _device_bytes(bitmap, device)
    return _expand_nib(_unpackbits(bm), _device_bytes(nibbles, bm.device),
                       escapes, n_bytes,
                       _unpackbits(_device_bytes(bit4, bm.device)))


def decompress_to_device(blob, *, device=None) -> torch.Tensor:
    """Compressed stream -> flat u8 records on ``device`` (the card unless
    it names another).  SDN1 / SDN2 and SDS1 streams upload only their parts
    (planes, nibbles or kept blocks, and the host-decoded escapes) and
    expand on the device; every other format decodes on the host and
    uploads.  The same checks and typed errors as ``decompress``."""
    dev = default_device(device)
    data = as_u8_stream(blob)
    if data.size < 12:
        raise EntropyError("stream too short")
    magic = _u32(data, 0)
    if magic == _MAGICS:
        n, nblk, count, flags, kept = _parse_sparse(data)
        return expand_sparse_device(
            data[_SPARSE_HDR:_SPARSE_HDR + nblk // 8],
            kept.reshape(count, -1) if count
            else np.full((1, SPARSE_BLOCK), 127, np.uint8),
            n, device=dev)
    if magic in (_MAGICN, _MAGICN2):
        two = magic == _MAGICN2            # SDN2 adds the bit4 plane
        hdr = 4 + 8 + 8
        if data.size < hdr:
            raise EntropyError("stream too short")
        n = _u64(data, 4)
        esc_count = _u64(data, 12)
        if n == 0 or n > 2 * data.size or esc_count > n:
            raise EntropyError("corrupt stream: implausible symbol count")
        bm_sz, nib_sz = (n + 7) // 8, (n + 1) // 2
        planes = 2 * bm_sz if two else bm_sz
        if data.size < hdr + planes + nib_sz:
            raise EntropyError("stream too short")
        pay = data[hdr + planes + nib_sz:]
        # the flags go up anyway, so they are counted there; only the bits
        # below n, as the native decoder does: a pad bit must not stand in
        # for a real one
        flags = _unpackbits(_device_bytes(data[hdr:hdr + bm_sz], dev))
        if int(flags[:n].sum()) != esc_count:
            raise EntropyError("corrupt stream: bitmap/count mismatch")
        if esc_count:
            # the native decoder's rule: only stored or SDEG escape payloads
            if pay.size < 4 or _u32(pay, 0) not in (_MAGIC0, _MAGICG):
                raise EntropyError("corrupt stream: bad escape payload")
            esc = decompress(pay)
            if esc.size != esc_count:
                raise EntropyError("corrupt stream: payload size")
        else:
            if pay.size:
                raise EntropyError("corrupt stream: unexpected payload")
            esc = np.zeros(0, np.uint8)
        bit4 = (_unpackbits(_device_bytes(data[hdr + bm_sz:hdr + planes],
                                          dev)) if two else None)
        nib = _device_bytes(data[hdr + planes:hdr + planes + nib_sz], dev)
        return _expand_nib(flags, nib, esc, n, bit4)
    return _device_bytes(decompress(data), dev)


def decompress_on(blob, device=None) -> torch.Tensor:
    """Compressed stream -> flat u8 records as a tensor on ``device`` (the
    card unless it names another): the host ``decompress`` when that is the
    CPU, ``decompress_to_device`` otherwise."""
    dev = default_device(device)
    if dev.type == "cpu":
        return torch.from_numpy(decompress(blob))
    return decompress_to_device(blob, device=dev)


# ---------------------------------------------------------------------------
# end to end: encode + compress / decompress + decode
# ---------------------------------------------------------------------------

def compress_records(records, *, rle: bool = False,
                     device=None) -> np.ndarray:
    """Records -> compressed stream.  The plain format takes its table from
    the histogram on the device (a tensor's own; other input goes to
    ``device``, the card unless it names another), then the host packs K
    chunks (``default_chunks``); the RLE format is self-contained.  The
    table policy behind the api, container and facade."""
    if rle:
        return compress(_host_bytes(records), rle=True)
    lengths = build_lengths(
        histogram(records, device=True if device is None else device))
    arr = _host_bytes(records)
    return compress(arr, lengths, streams=default_chunks(arr.size))


def encode_quantize32_compressed(image, lut, *, rle: bool = False,
                                 sparse: bool = False, **kw) -> np.ndarray:
    """The mode32 encode on the device, then the histogram there and the
    host pack (``rle=True``: run-length + Huffman; ``sparse=True``: the
    device compaction first).  ``kw`` goes to ``api.encode_quantize32``."""
    from . import api
    rec = api.encode_quantize32(image, lut, **kw)
    if sparse:
        return compress_sparse(rec, rle=rle)
    return compress_records(rec, rle=rle)


def decode_quantize32_compressed(blob, lut, size_x: int, size_y: int,
                                 **kw) -> torch.Tensor:
    """Inverse: the unpack on the target device (``decompress_on``), then
    the mode32 decode.  ``kw`` goes to ``api.decode_quantize32``."""
    from . import api
    rec = decompress_on(blob, kw.get("device"))
    return api.decode_quantize32(rec, lut, size_x, size_y, **kw)
