"""Blocking and the mode32 record layout."""

from .blocks import blockize, unblockize
from .reorder import buffer_to_coeffs, coeffs_to_buffer, group8, group8_inverse
