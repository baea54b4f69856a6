// Device functions shared by every kernel of simd_dct_tpu_torch/csrc: the
// f32 DCT basis as a constant table, the quantizer in its three rounding
// modes, the padded stride of staged mode32 group records, the mode32
// geometry rule, and the BT.601 colour mix.  mode32 (dct32.cu), enc-quant
// (encq.cu), stereo (stereo.cu), colour (color32.cu, color420.cu) and the
// tiles (tiles.cu) all include this file, so the modes cannot differ in
// their arithmetic.
//
// Every product and sum is an explicit __fmaf_rn / __fmul_rn, so no
// contraction choice of the compiler can differ between kernels.  Build
// without --use_fast_math: the 'scalar' rounding mode needs an IEEE
// division by 255.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// D[k][n], the orthonormal DCT-II basis assembled from the reference
// butterfly's f32 constants (bit-identical to core/dct.py dct_basis_np).
__constant__ float kD[64] = {
    0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.f6297ep-2f, 0x1.a9b660p-2f, 0x1.1c73b4p-2f, 0x1.8f8b84p-4f,
    -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b660p-2f, -0x1.f6297ep-2f,
    0x1.d906bep-2f, 0x1.87de2ap-3f, -0x1.87de2ap-3f, -0x1.d906bep-2f,
    -0x1.d906bep-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f, 0x1.d906bep-2f,
    0x1.a9b660p-2f, -0x1.8f8b84p-4f, -0x1.f6297ep-2f, -0x1.1c73b4p-2f,
    0x1.1c73b4p-2f, 0x1.f6297ep-2f, 0x1.8f8b84p-4f, -0x1.a9b660p-2f,
    0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.6a09e6p-2f, -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,
    0x1.1c73b4p-2f, -0x1.f6297ep-2f, 0x1.8f8b84p-4f, 0x1.a9b660p-2f,
    -0x1.a9b660p-2f, -0x1.8f8b84p-4f, 0x1.f6297ep-2f, -0x1.1c73b4p-2f,
    0x1.87de2ap-3f, -0x1.d906bep-2f, 0x1.d906bep-2f, -0x1.87de2ap-3f,
    -0x1.87de2ap-3f, 0x1.d906bep-2f, -0x1.d906bep-2f, 0x1.87de2ap-3f,
    0x1.8f8b84p-4f, -0x1.1c73b4p-2f, 0x1.a9b660p-2f, -0x1.f6297ep-2f,
    0x1.f6297ep-2f, -0x1.a9b660p-2f, 0x1.1c73b4p-2f, -0x1.8f8b84p-4f,
};

// 64 per-coefficient scales, passed by value (kernel parameter space).
struct Scales {
  float v[64];
};

enum Rounding { kRne = 0, kScalar = 1, kClampFirst = 2 };

// f32(1/255), the pixel scale of the 1/255 domain (enc-quant and stereo),
// as core/golden.py:184
constexpr float kInv255 = 0x1.010102p-8f;

// Shared-memory bytes per staged 512-byte mode32 group record (dct32.cu,
// color32.cu, color420.cu): 16 bytes of padding put the four groups of a
// warp on different banks for the stride-8 record bytes (measured on an
// H100: the thread-per-block dec32 about 5% faster than a 512-byte
// stride).
constexpr int kGroupStride = 528;

// rint(x) clamped to the biased byte grid [-127, 128].  Equal to the
// reference's int clamp(rint(x) + 127, 0, 255) - 127 for every finite x.
__device__ __forceinline__ float quant_level(float x) {
  return fminf(fmaxf(rintf(x), -127.0f), 128.0f);
}

// One coefficient times its scale -> biased u8, per rounding mode
// (core/quantize.py quantize_to_u8; src/simd_dct.cpp:245,1020,1245).
template <int R>
__device__ __forceinline__ uint8_t quantize(float c, float q) {
  const float x = __fmul_rn(c, q);
  if (R == kRne) return (uint8_t)(int)(quant_level(x) + 127.0f);
  if (R == kClampFirst)
    return (uint8_t)(int)rintf(fminf(fmaxf(__fadd_rn(x, 127.0f), 0.0f), 255.0f));
  // kScalar: /255 domain, clamp [0, 1], *255, round half away (v >= 0).
  const float bias = 127.0f / 255.0f;  // f32(127) / f32(255), rounded once
  float v = fminf(fmaxf(__fadd_rn(__fdiv_rn(x, 255.0f), bias), 0.0f), 1.0f);
  return (uint8_t)(int)floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f));
}

// The geometry every mode32-family launch takes: whole 8-block groups
// (W % 64 == 0), whole strips (H2 % 8 == 0), a batch on one grid axis.
inline bool mode32_geometry_ok(int batch, int h2, int w) {
  return batch > 0 && batch <= 65535 && h2 > 0 && w > 0 && h2 % 8 == 0 && w % 64 == 0;
}

inline Scales to_scales(const float* host) {
  Scales s;
  memcpy(s.v, host, sizeof(s.v));
  return s;
}

// -- colour (color32.cu, color420.cu) ----------------------------------------

// The BT.601 mix: RGB -> YCbCr and back, row-major, and the bias added to
// Y, Cb and Cr after the forward mix (layout/color.py).
struct ColorMix {
  float fwd[9];
  float inv[9];
  float bias[3];
};

__device__ __forceinline__ float pick(int c, float a, float b, float d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

// (m0*x0 + m1*x1) + m2*x2, every step rounded (layout/color.py mix_planes).
__device__ __forceinline__ float mix3(float m0, float m1, float m2, float x0, float x1,
                                      float x2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, m0), __fmul_rn(x1, m1)), __fmul_rn(x2, m2));
}

inline ColorMix to_mix(const float* host) {
  ColorMix m;
  memcpy(&m, host, sizeof(m));
  return m;
}

}  // namespace
