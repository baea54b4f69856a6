"""simd_dct_tpu_torch -- the enc-quant, mode32, stereo and YCbCr 4:4:4 and
4:2:0 colour engines of ``simd_dct_tpu`` in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The JAX package ``simd_dct_tpu`` is the reference this package is held
against; this package never imports jax.  Layer map:

* ``core``     -- DCT basis and quantization math
* ``layout``   -- blockize, the dual-view geometry, the enc-quant scalar /
  pair-cell layouts, the mode32 group-of-8 record layout, the stereo
  interleaved / planar / native plane layouts, the BT.601 colour mix and
  the 4:2:0 record stream
* ``kernels``  -- plain PyTorch version (``torch_path``), CUDA kernel
  wrappers (``cuda_dct``) and the nvcc build (``_build``)
* ``dispatch`` -- tiers ``cuda`` / ``torch`` and the capability probe
* ``api``      -- validated public entry points
* ``dist``     -- meshes of devices, strip- and frame-sharded entry points
  and the plane all-gather kernel (``csrc/collectives.cu``)
* ``convert``  -- LUT scales and record streams shared with the JAX package
* ``entropy``  -- the compressed stream: host Huffman / RLE / nibble coders
  (``native/entropy.cpp``) and their device passes (histogram, splits,
  sparse compaction, expansions) as PyTorch ops on the records' device
* ``container`` -- the self-describing ``.sdt`` / ``.sdtv`` containers
* ``config``   -- ``EncoderConfig`` and the ``Encoder`` facade
* ``native``   -- the ``g++`` + ctypes loader of ``native/*.cpp`` and the
  strict-IEEE oracle's API
* ``utils``    -- profiling and roofline reports (``utils.profiling``), the
  pipelined frame feed on CUDA streams and page-locked buffers
  (``utils.feed``), verification aids and metrics
* ``bench``    -- the harness's run statistics (``bench.stats``) and the
  rate-distortion sweep (``bench.rd``, ``python -m
  simd_dct_tpu_torch.bench.rd``)
* ``cli``      -- the reference harness's command line (``python -m
  simd_dct_tpu_torch.cli``); ``python -m simd_dct_tpu_torch.container``
  prints or decodes a container

``utils``, ``bench`` and ``cli`` load on first use, as the JAX package's
``bench`` does.
"""

__version__ = "0.1.0"

from . import core
from . import layout
from . import dispatch
from . import api
from . import dist
from . import entropy
from . import container
from .api import (
    SimdDctResult, SimdDctError, InvalidParameterError, NotSupportedError,
    encode_quantize, decode_quantize, try_encode_quantize,
    encode_quantize32, decode_quantize32, roundtrip_quantize32,
    encode_quantize_stereo, decode_quantize_stereo,
    try_encode_quantize_stereo,
    encode_quantize32_ycbcr, decode_quantize32_ycbcr,
    roundtrip_quantize32_ycbcr,
    encode_quantize32_ycbcr420, decode_quantize32_ycbcr420,
)
from .config import EncoderConfig, Encoder
from .core.quantize import default_quant_lut

__all__ = [
    "core", "layout", "dispatch", "api", "dist", "entropy", "container",
    "EncoderConfig", "Encoder", "__version__",
    "SimdDctResult", "SimdDctError", "InvalidParameterError",
    "NotSupportedError",
    "encode_quantize", "decode_quantize", "try_encode_quantize",
    "encode_quantize32", "decode_quantize32", "roundtrip_quantize32",
    "encode_quantize_stereo", "decode_quantize_stereo",
    "try_encode_quantize_stereo",
    "encode_quantize32_ycbcr", "decode_quantize32_ycbcr",
    "roundtrip_quantize32_ycbcr",
    "encode_quantize32_ycbcr420", "decode_quantize32_ycbcr420",
    "default_quant_lut",
]
