// Device functions shared by every kernel of simd_dct_tpu_torch/csrc: the
// f32 DCT basis, the 8x8 forward and inverse transforms, the quantizer in
// its three rounding modes, 8x8 pixel-block loads and stores, and the
// staging of mode32 group records in shared memory, and the BT.601 colour
// mix.  mode32 (dct32.cu), enc-quant (encq.cu), stereo (stereo.cu) and
// colour (color32.cu, color420.cu) all include this file, so the modes
// cannot differ in their arithmetic.
//
// Every product and sum of the transforms is an explicit __fmaf_rn /
// __fmul_rn, so no contraction choice of the compiler can differ between
// kernels.  Build without --use_fast_math: the 'scalar' rounding mode needs
// an IEEE division by 255.

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

// 8x8 blocks (one thread each) per CUDA block of the mode32 and enc-quant
// kernels.
constexpr int kThreads = 128;
// Shared-memory bytes per staged 512-byte mode32 group record (dct32.cu,
// color32.cu): 16 bytes of padding put the four groups of a warp on
// different banks for the stride-8 record bytes (measured on an H100: dec32
// about 5% faster than a 512-byte stride).
constexpr int kGroupStride = 528;

// The i-th 16-byte piece of a contiguous span of group records, as an index
// into its padded shared-memory copy (32 pieces per record).
__device__ __forceinline__ int smem_piece(int i) {
  return (i >> 5) * (kGroupStride / 16) + (i & 31);
}

// X (8x8, row-major, in place) -> D X D^T.  Column pass first, then rows,
// the association order of the golden model (core/golden.py _dct2d).
__device__ __forceinline__ void dct2d(float (&x)[64]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // t[u][k] = sum_j D[u][j] x[j][k]
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float acc = __fmul_rn(kD[u * 8], x[k]);
#pragma unroll
      for (int j = 1; j < 8; ++j) acc = __fmaf_rn(kD[u * 8 + j], x[j * 8 + k], acc);
      t[u] = acc;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u * 8 + k] = t[u];
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {  // c[u][v] = sum_k t[u][k] D[v][k]
    float c[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float acc = __fmul_rn(x[u * 8], kD[v * 8]);
#pragma unroll
      for (int k = 1; k < 8; ++k) acc = __fmaf_rn(x[u * 8 + k], kD[v * 8 + k], acc);
      c[v] = acc;
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) x[u * 8 + v] = c[v];
  }
}

// C (8x8, in place) -> D^T C D, the inverse (core/golden.py _idct2d order).
__device__ __forceinline__ void idct2d(float (&c)[64]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {  // t[j][v] = sum_u D[u][j] c[u][v]
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(kD[j], c[v]);
#pragma unroll
      for (int u = 1; u < 8; ++u) acc = __fmaf_rn(kD[u * 8 + j], c[u * 8 + v], acc);
      t[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j * 8 + v] = t[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // x[j][k] = sum_v t[j][v] D[v][k]
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float acc = __fmul_rn(c[j * 8], kD[k]);
#pragma unroll
      for (int v = 1; v < 8; ++v) acc = __fmaf_rn(c[j * 8 + v], kD[v * 8 + k], acc);
      r[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) c[j * 8 + k] = r[k];
  }
}

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

__device__ __forceinline__ void load_block(const uint8_t* __restrict__ p, int w,
                                           float (&x)[64]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + (size_t)r * w));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[r * 8 + i] = (float)((v.x >> (8 * i)) & 0xffu);
      x[r * 8 + 4 + i] = (float)((v.y >> (8 * i)) & 0xffu);
    }
  }
}

__device__ __forceinline__ uint32_t pack4(const float* px) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = fminf(fmaxf(rintf(px[i]), 0.0f), 255.0f);
    out |= ((uint32_t)(int)v) << (8 * i);
  }
  return out;
}

__device__ __forceinline__ void store_block(uint8_t* __restrict__ p, int w,
                                            const float (&x)[64]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint2 v;
    v.x = pack4(&x[r * 8]);
    v.y = pack4(&x[r * 8 + 4]);
    *reinterpret_cast<uint2*>(p + (size_t)r * w) = v;
  }
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
