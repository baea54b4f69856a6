"""Blocking, the dual-view geometry, the enc-quant scalar / pair-cell
layouts, the mode32 record layout, the stereo plane layouts, the
YCbCr colour planes, the 4:2:0 record stream and the zigzag order."""

from .blocks import blockize, unblockize
from .color import (BASE_CHROMA_QUANT_TABLE, RGB2YCC, YCC2RGB, YCC_BIAS,
                    mix_planes, planar_to_rgb, rgb_to_planar, rgb_to_ycbcr,
                    ycbcr_to_rgb)
from .color420 import (pack_records, pool2x2, record_bytes_420, replicate2x2,
                       unpack_records)
from .reorder import (block_contiguous, block_contiguous_inverse,
                      buffer_to_coeffs, coeffs_to_buffer, group8,
                      group8_inverse, pair_as_written, pair_as_written_masked,
                      pair_cell_permutation, pair_cells, pair_cells_inverse,
                      planar_stereo, planar_stereo_inverse,
                      stereo_interleaved_to_views, stereo_views_to_interleaved,
                      stereo_views_to_native)
from .stereo import native_stereo_bwp, split_views, stack_views, top_view
from .zigzag import (from_zigzag, to_zigzag, zigzag_inverse_order,
                     zigzag_order)
