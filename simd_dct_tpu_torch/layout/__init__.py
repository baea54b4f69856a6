"""Blocking, the enc-quant scalar / pair-cell layouts and the mode32
record layout."""

from .blocks import blockize, unblockize
from .reorder import (block_contiguous, block_contiguous_inverse,
                      buffer_to_coeffs, coeffs_to_buffer, group8,
                      group8_inverse, pair_as_written, pair_as_written_masked,
                      pair_cell_permutation, pair_cells, pair_cells_inverse)
