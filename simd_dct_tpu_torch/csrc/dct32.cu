// Mode32 kernels for Hopper (sm_90a): encode, decode, fused round trip, and
// the tier probe.  Plain C entry points, loaded with ctypes by
// simd_dct_tpu_torch/kernels/_build.py and wrapped by kernels/cuda_dct.py.
//
// Mode32 (simdDCT_EncodeQuantize32ReorderBuffer): raw 0..255 pixels of the
// top view, 2-D DCT C = D X D^T per 8x8 block, q = 255 / (lut * 0.95),
// +127 bias, u8.  Each group of 8 horizontally adjacent blocks of a strip
// stores one 512-byte coefficient-major record: byte p*8 + b is coefficient
// p = u*8 + v of block b.  Records are laid out strip by strip, group by
// group, so for a frame with BW = W/8 blocks per row the record of block
// number n = s*BW + bx (strip s, block column bx) starts at byte
// (n/8)*512 and its coefficient p sits at (n/8)*512 + p*8 + n%8.
//
// Design shared by the three kernels (replacing the TPU's (128,128)
// permuted-basis matmuls, which existed only because Mosaic cannot reshape
// u8 -- on this card the record permutation is index arithmetic):
//   * one thread per 8x8 block holds its 64 values in f32 registers and runs
//     the two 8-term passes against D in __constant__ memory;
//   * 8 consecutive threads are one 8-block group; a CUDA block of kThreads
//     threads covers kThreads consecutive block numbers, which own one
//     contiguous span of kThreads*64 record bytes.  That span goes through
//     shared memory, so records are read and written with 16-byte accesses.
//     Groups sit kGroupStride = 512 + 16 bytes apart there: the four groups
//     of a warp then hit different banks on the stride-8 record bytes
//     (measured on an H100: dec32 about 5% faster than a 512-byte stride);
//   * pixel rows are read and written as 8-byte accesses, neighbouring
//     threads on neighbouring addresses;
//   * grid = (ceil(blocks per frame / kThreads), batch): one launch covers
//     a whole (B, H, W) batch, and any W % 64 == 0, H2 % 8 == 0 geometry
//     runs directly (no pad or slice pass).
// Arithmetic is f32 on the CUDA cores.  Every product and sum of the
// transforms is an explicit __fmaf_rn / __fmul_rn, so no contraction choice
// of the compiler can differ between kernels: the fused round trip equals
// decode(encode(x)) byte for byte.  Build without --use_fast_math: the
// 'scalar' rounding mode needs an IEEE division by 255.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;      // 8x8 blocks per CUDA block (16 groups)
constexpr int kGroupStride = 528;  // shared-memory bytes per 512-byte record
constexpr int kRecSmem = (kThreads / 8) * kGroupStride;

// The i-th 16-byte piece of a CUDA block's contiguous record span, as an
// index into its padded shared-memory copy (32 pieces per record).
__device__ __forceinline__ int smem_piece(int i) {
  return (i >> 5) * (kGroupStride / 16) + (i & 31);
}

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

// Replaces simd_dct_tpu/kernels/pallas_dct.py _enc32_kernel.
// Bound: memory, 1 byte read + 1 byte written per pixel; 16 f32 FMAs per
// pixel are far below the CUDA cores' rate.  Design: records are staged in
// shared memory and leave in 16-byte stores, so the coefficient-major
// scatter costs no extra device-memory traffic.
template <int R>
__global__ void __launch_bounds__(kThreads)
enc32_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out,
             Scales q, int h2, int w, long long frame_stride, int start_y,
             int end_y) {
  __shared__ __align__(16) uint8_t rec[kRecSmem];
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kThreads;
  const long long blk = blk0 + threadIdx.x;
  const uint8_t* src = img + (long long)blockIdx.y * frame_stride;
  uint8_t* dst = out + (long long)blockIdx.y * h2 * w;
  uint8_t* slot = rec + (threadIdx.x >> 3) * kGroupStride + (threadIdx.x & 7);
  if (blk < nblk) {
    const long long s = blk / bw;
    const int bx = (int)(blk - s * bw);
    const long long y2 = 16 * s;
    if (y2 >= start_y && y2 <= end_y) {
      float x[64];
      load_block(src + 8 * s * w + 8 * bx, w, x);
      dct2d(x);
#pragma unroll
      for (int p = 0; p < 64; ++p) slot[p * 8] = quantize<R>(x[p], q.v[p]);
    } else {
#pragma unroll
      for (int p = 0; p < 64; ++p) slot[p * 8] = 0;
    }
  }
  __syncthreads();
  const long long nvalid = nblk - blk0 < kThreads ? nblk - blk0 : kThreads;
  const uint4* s4 = reinterpret_cast<const uint4*>(rec);
  uint4* d4 = reinterpret_cast<uint4*>(dst + blk0 * 64);
  for (int i = threadIdx.x; i < nvalid * 4; i += kThreads) d4[i] = s4[smem_piece(i)];
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _dec32_kernel.
// Bound: memory, as enc32.  Design: the CUDA block's contiguous record
// span is loaded with 16-byte loads into shared memory; each thread then
// gathers its block's 64 bytes at stride 8 from there.
__global__ void __launch_bounds__(kThreads)
dec32_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out,
             Scales qi, int h2, int w) {
  __shared__ __align__(16) uint8_t rec[kRecSmem];
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kThreads;
  const long long blk = blk0 + threadIdx.x;
  const long long frame = (long long)blockIdx.y * h2 * w;
  const long long nvalid = nblk - blk0 < kThreads ? nblk - blk0 : kThreads;
  const uint4* s4 = reinterpret_cast<const uint4*>(records + frame + blk0 * 64);
  uint4* d4 = reinterpret_cast<uint4*>(rec);
  for (int i = threadIdx.x; i < nvalid * 4; i += kThreads) d4[smem_piece(i)] = __ldg(s4 + i);
  __syncthreads();
  if (blk >= nblk) return;
  const uint8_t* slot = rec + (threadIdx.x >> 3) * kGroupStride + (threadIdx.x & 7);
  float c[64];
#pragma unroll
  for (int p = 0; p < 64; ++p) c[p] = __fmul_rn((float)slot[p * 8] - 127.0f, qi.v[p]);
  idct2d(c);
  const long long s = blk / bw;
  const int bx = (int)(blk - s * bw);
  store_block(out + frame + 8 * s * w + 8 * bx, w, c);
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _roundtrip_kernel.
// Bound: 32 f32 FMAs per pixel against 2 bytes of traffic; on an H100 SXM
// (about 33.5 T FMA/s, 3.35 TB/s) the two bounds are within a factor of
// two, so the FMA count is the first lever (the even/odd butterfly of the
// reference, simd_dct_tpu/core/butterfly.py, does the same transform in
// fewer operations).  Design: the records
// never leave registers, and the quantize step is the identity
// clip(rint(z*q), -127, 128) of pallas_dct.py:422, written with the same
// functions as enc32 and dec32.
__global__ void __launch_bounds__(kThreads)
roundtrip32_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out,
                   Scales q, Scales qi, int h2, int w, long long frame_stride) {
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blk >= nblk) return;
  const long long s = blk / bw;
  const int bx = (int)(blk - s * bw);
  float x[64];
  load_block(img + (long long)blockIdx.y * frame_stride + 8 * s * w + 8 * bx, w, x);
  dct2d(x);
#pragma unroll
  for (int p = 0; p < 64; ++p) x[p] = __fmul_rn(quant_level(__fmul_rn(x[p], q.v[p])), qi.v[p]);
  idct2d(x);
  store_block(out + (long long)blockIdx.y * h2 * w + 8 * s * w + 8 * bx, w, x);
}

// Replaces simd_dct_tpu/dispatch/capability.py _pallas_functional.k, the
// trial kernel of the tier probe: u8 load, +1 in int32, clip, u8 store.
__global__ void probe_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int v = (int)in[i] + 1;
    out[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

bool geometry_ok(int batch, int h2, int w) {
  return batch > 0 && batch <= 65535 && h2 > 0 && w > 0 && h2 % 8 == 0 && w % 64 == 0;
}

unsigned grid_x(int h2, int w) {
  const long long nblk = (long long)(h2 / 8) * (w / 8);
  return (unsigned)((nblk + kThreads - 1) / kThreads);
}

Scales to_scales(const float* host) {
  Scales s;
  memcpy(s.v, host, sizeof(s.v));
  return s;
}

}  // namespace

extern "C" {

// img: (batch, >= h2 rows, w) u8 frames, frame_stride bytes apart; only the
// first h2 rows are read.  out: (batch, h2*w) u8 records.  q: 64 host f32.
int sdct_enc32(const void* img, void* out, const float* q, int batch, int h2, int w,
               long long frame_stride, int start_y, int end_y, int rounding,
               void* stream) {
  if (!geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  const Scales s = to_scales(q);
  switch (rounding) {
    case kRne:
      enc32_kernel<kRne><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride, start_y, end_y);
      break;
    case kScalar:
      enc32_kernel<kScalar><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride, start_y, end_y);
      break;
    case kClampFirst:
      enc32_kernel<kClampFirst><<<grid, kThreads, 0, st>>>(in, o, s, h2, w, frame_stride, start_y,
                                                          end_y);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// records: (batch, h2*w) u8.  out: (batch, h2, w) u8.  qi: 64 host f32.
int sdct_dec32(const void* records, void* out, const float* qi, int batch, int h2, int w,
               void* stream) {
  if (!geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  dec32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)records, (uint8_t*)out, to_scales(qi), h2, w);
  return (int)cudaGetLastError();
}

// img as for sdct_enc32; out: (batch, h2, w) u8.
int sdct_roundtrip32(const void* img, void* out, const float* q, const float* qi, int batch,
                     int h2, int w, long long frame_stride, void* stream) {
  if (!geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  roundtrip32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (uint8_t*)out, to_scales(q), to_scales(qi), h2, w, frame_stride);
  return (int)cudaGetLastError();
}

int sdct_probe(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const uint8_t*)in,
                                                                 (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* sdct_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
