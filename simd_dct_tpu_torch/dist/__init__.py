"""Strip- and frame-sharded encode and decode over a device mesh
(counterpart of ``simd_dct_tpu/dist``; the CPU reference's startY/endY
hook): ``mesh`` builds meshes and sharded values, ``sharding`` holds the
sharded entry points, ``collectives`` the plane all-gather."""

from .mesh import (
    DATA_AXIS, make_mesh, make_mesh_2d, strip_sharding, replicated,
    initialize_distributed, Mesh, Sharded,
)
from . import collectives
from .sharding import (
    encode_quantize32_sharded, decode_quantize32_sharded,
    encode_quantize32_ycbcr_sharded, decode_quantize32_ycbcr_sharded,
    encode_quantize32_ycbcr420_sharded, decode_quantize32_ycbcr420_sharded,
    encode_quantize_stereo_sharded, decode_quantize_stereo_sharded,
    encode_quantize32_batch, encode_quantize32_batch_2d,
    roundtrip_quantize32_batch,
)

__all__ = [
    "collectives", "DATA_AXIS", "make_mesh", "make_mesh_2d",
    "strip_sharding", "replicated", "initialize_distributed",
    "encode_quantize32_sharded", "decode_quantize32_sharded",
    "encode_quantize32_ycbcr_sharded", "decode_quantize32_ycbcr_sharded",
    "encode_quantize32_ycbcr420_sharded",
    "decode_quantize32_ycbcr420_sharded",
    "encode_quantize_stereo_sharded", "decode_quantize_stereo_sharded",
    "encode_quantize32_batch", "encode_quantize32_batch_2d",
    "roundtrip_quantize32_batch",
]
