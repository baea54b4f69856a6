"""DCT basis and quantization math."""

from .dct import dct8, dct8x8, dct_basis, dct_basis_np, idct8, idct8x8
from .quantize import (BASE_QUANT_TABLE, BIAS, ROUNDING_MODES, VR,
                       default_quant_lut, dequant_scales, dequantize_from_u8,
                       quant_scales, quantize_to_u8)
from . import golden
