"""Encoder configuration (counterpart of ``simd_dct_tpu/config.py``).

The reference's configuration is a CLI bitmask plus mutable global feature
flags (src/main.cpp:194-282); here the same knobs are a frozen dataclass,
and ``Encoder`` binds a config and its LUT to the api, entropy and
container entry points.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.quantize import ROUNDING_MODES, default_quant_lut
from .dispatch.capability import TIERS


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """All encode-path knobs in one place.

    quality: LUT scale factor; None = the unscaled base table.
    rounding: 'rne' (default) / 'scalar' / 'clamp_first'.
    layout: enc-quant byte layout, 'scalar', 'pair' or 'pair_as_written'.
    stereo_layout: enc-quant-stereo records, 'interleaved' (the reference's
        stream, default), 'planar' (views apart) or 'native' (plane rows
        padded to 128-byte multiples).
    backend: a tier of ``TIERS`` ('cuda', 'torch', 'numpy') or None for
        the device rule; 'numpy' runs the golden on the host.
    start_y/end_y: the reference's strip range.
    compat: the strict-IEEE tier, byte-identical to the C++ oracle.
    device: where input that is not a tensor yet goes, as in the api: None
        for the card, or a device such as 'cpu'.
    """
    quality: float | None = None
    rounding: str = "rne"
    layout: str = "scalar"
    backend: str | None = None
    start_y: int = 0
    end_y: int | None = None
    compat: bool = False
    stereo_layout: str = "interleaved"
    device: str | None = None

    def __post_init__(self):
        if self.rounding not in ROUNDING_MODES:
            raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
        if self.layout not in ("scalar", "pair", "pair_as_written"):
            raise ValueError(
                "layout must be 'scalar', 'pair' or 'pair_as_written'")
        if self.stereo_layout not in ("interleaved", "planar", "native"):
            raise ValueError("stereo_layout must be 'interleaved', "
                             "'planar' or 'native'")
        if self.backend is not None and self.backend not in TIERS:
            raise ValueError(f"backend must be one of {TIERS} or None")

    def lut(self) -> np.ndarray:
        return default_quant_lut(self.quality)


class Encoder:
    """Config-bound facade over the entry points.

    >>> enc = Encoder(EncoderConfig(quality=50))
    >>> records = enc.encode_quantize32(image)
    >>> image2 = enc.decode_quantize32(records, w, h)
    """

    def __init__(self, config: EncoderConfig | None = None):
        self.config = config or EncoderConfig()
        self._lut = self.config.lut()

    @property
    def lut(self) -> np.ndarray:
        return self._lut

    def _kw(self):
        return dict(backend=self.config.backend, device=self.config.device)

    def _lut32(self) -> np.ndarray:
        # mode32 quantizes raw 0..255 coefficients (src/simd_dct.cpp:2036):
        # its LUT is 255x the normalized-domain table
        return self._lut * np.float32(255.0)

    def encode_quantize(self, image):
        from . import api
        c = self.config
        return api.encode_quantize(image, self._lut, c.start_y, c.end_y,
                                   rounding=c.rounding, layout=c.layout,
                                   compat=c.compat, **self._kw())

    def encode_quantize32(self, image):
        from . import api
        c = self.config
        return api.encode_quantize32(image, self._lut32(), c.start_y,
                                     c.end_y, rounding=c.rounding,
                                     compat=c.compat, **self._kw())

    def encode_quantize_stereo(self, image):
        from . import api
        c = self.config
        return api.encode_quantize_stereo(image, self._lut, c.start_y,
                                          c.end_y, rounding=c.rounding,
                                          compat=c.compat,
                                          view_layout=c.stereo_layout,
                                          **self._kw())

    def decode_quantize(self, data, size_x: int, size_y: int):
        from . import api
        return api.decode_quantize(data, self._lut, size_x, size_y,
                                   layout=self.config.layout,
                                   compat=self.config.compat, **self._kw())

    def decode_quantize32(self, data, size_x: int, size_y: int):
        from . import api
        return api.decode_quantize32(data, self._lut32(), size_x, size_y,
                                     compat=self.config.compat, **self._kw())

    def decode_quantize_stereo(self, data, size_x: int, size_y: int):
        from . import api
        return api.decode_quantize_stereo(
            data, self._lut, size_x, size_y, compat=self.config.compat,
            view_layout=self.config.stereo_layout, **self._kw())

    def roundtrip_quantize32(self, image):
        from . import api
        return api.roundtrip_quantize32(image, self._lut32(), **self._kw())

    # -- YCbCr colour pipeline -------------------------------------------

    def chroma_lut(self) -> np.ndarray:
        from .layout.color import BASE_CHROMA_QUANT_TABLE
        q = self.config.quality
        return (BASE_CHROMA_QUANT_TABLE * (1.0 if q is None else q)) \
            .astype(np.float32)

    def _chroma32(self) -> np.ndarray:
        return self.chroma_lut() * np.float32(255.0)

    def encode_quantize32_ycbcr(self, planes):
        from . import api
        return api.encode_quantize32_ycbcr(
            planes, self._lut32(), self._chroma32(),
            rounding=self.config.rounding, **self._kw())

    def decode_quantize32_ycbcr(self, data, size_x: int, size_y: int):
        from . import api
        return api.decode_quantize32_ycbcr(
            data, self._lut32(), self._chroma32(), size_x, size_y,
            **self._kw())

    def roundtrip_quantize32_ycbcr(self, planes):
        from . import api
        return api.roundtrip_quantize32_ycbcr(
            planes, self._lut32(), self._chroma32(), **self._kw())

    def encode_quantize32_ycbcr420(self, planes):
        from . import api
        return api.encode_quantize32_ycbcr420(
            planes, self._lut32(), self._chroma32(),
            rounding=self.config.rounding, **self._kw())

    def decode_quantize32_ycbcr420(self, data, size_x: int, size_y: int):
        from . import api
        return api.decode_quantize32_ycbcr420(
            data, self._lut32(), self._chroma32(), size_x, size_y,
            **self._kw())

    # -- entropy-coded stream --------------------------------------------

    def encode_quantize32_compressed(self, image, rle: bool = False,
                                     sparse: bool = False) -> np.ndarray:
        """The mode32 encode, then the histogram on the records' device
        and the host pack (``rle=True``: run-length + Huffman;
        ``sparse=True``: all-127 blocks dropped on the device first, dense
        input through the SDN1 coder); every stream decodes by
        ``entropy.decompress``."""
        from . import entropy
        rec = self.encode_quantize32(image)
        if sparse:
            return entropy.compress_sparse(rec, rle=rle)
        return entropy.compress_records(rec, rle=rle)

    def decode_quantize32_compressed(self, blob, size_x: int, size_y: int):
        """Inverse: the unpack on the config's device, then the mode32
        decode."""
        from . import entropy
        return self.decode_quantize32(
            entropy.decompress_on(blob, self.config.device), size_x, size_y)

    # -- self-describing containers --------------------------------------

    def _container_kw(self, mode: str) -> dict:
        c = self.config
        return dict(quality=c.quality, rounding=c.rounding,
                    backend=c.backend, device=c.device,
                    view_layout=(c.stereo_layout
                                 if mode == "enc-quant-stereo"
                                 else "interleaved"))

    def encode_container(self, image, mode: str = "enc-quant32", *,
                         compress: bool = True, rle: bool = False,
                         sparse: bool = False):
        """Image -> .sdt container under this config (the mode, geometry
        and exact LUTs travel in the header; see ``container``)."""
        from . import container
        c = self.config
        return container.encode(image, mode, compress=compress, rle=rle,
                                sparse=sparse, start_y=c.start_y,
                                end_y=c.end_y, **self._container_kw(mode))

    def decode_container(self, blob):
        """.sdt container -> decoded image (the header's mode and LUTs are
        used, not this config's)."""
        from . import container
        return container.decode(blob, compat=self.config.compat,
                                **self._kw())

    def encode_video_container(self, frames, mode: str = "enc-quant32", *,
                               compress: bool = True, rle: bool = False,
                               sparse: bool = False):
        """Frame batch -> .sdtv container (one batched encode, a payload a
        frame, one Huffman table; ``sparse``: per-frame SDS1)."""
        from . import container
        return container.encode_video(frames, mode, compress=compress,
                                      rle=rle, sparse=sparse,
                                      **self._container_kw(mode))

    def decode_video_container(self, blob):
        from . import container
        return container.decode_video(blob, compat=self.config.compat,
                                      **self._kw())
