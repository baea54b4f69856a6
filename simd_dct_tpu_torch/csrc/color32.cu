// YCbCr 4:4:4 colour kernels for Hopper (sm_90a): encode, decode and fused
// round trip of planar RGB through per-channel mode32 records.  Plain C
// entry points, loaded with ctypes by simd_dct_tpu_torch/kernels/_build.py
// and wrapped by kernels/cuda_dct.py.
//
// Colour mode32: a (3, H, W) u8 planar RGB dual view, of which the top
// H2 = H/2 rows are encoded.  Per pixel the BT.601 mix in f32,
//   Y  = ((m00*r + m01*g) + m02*b) + 0,  Cb, Cr the same with rows 1, 2 and
//   bias 128 (every step rounded, the order of layout/color.py mix_planes),
// with no u8 step; then per channel the mode32 encode of dct32.cu in the
// raw 0..255 domain, Y with the luma scales and Cb, Cr with the chroma
// scales.  Channel c of a frame's records is the mode32 record stream of
// that channel's plane: (3, H2*W) u8.  The decode dequantizes, runs the
// IDCT, subtracts the bias and applies the inverse mix in f32 (the YCbCr
// values are not rounded), then rounds half to even and clips to u8.
//
// Design.  One thread per (8x8 block, channel).  A CUDA block of
// kColorThreads = 96 threads covers kColorBlocks = 32 consecutive block
// numbers, one warp per channel, so every choice by channel is uniform in a
// warp and a thread holds 64 f32 values, as in dct32.cu:
//   * encode: each thread reads its block's three 8x8 RGB pieces (the two
//     sibling warps read the same bytes, from L1), mixes its channel,
//     transforms and quantizes.  The three channels' 32-block record spans
//     are staged in shared memory as in enc32_kernel (groups kGroupStride
//     apart) and leave in 16-byte stores;
//   * decode: the three record spans come in with 16-byte loads; each
//     thread gathers its channel's bytes, runs the IDCT and writes its 64
//     YCbCr values, bias removed, to shared memory (96 slabs of 65 floats:
//     the odd pitch puts a warp's 32 accesses on 32 banks).  After a
//     barrier each thread reads the three channels of its block and stores
//     the inverse mix of its own output channel;
//   * the round trip does both without records: the quantized level stays
//     in registers, quant_level times the dequant scale, the identity of
//     roundtrip32_kernel, so it equals decode(encode(x)) byte for byte.
// This keeps the decode and the round trip at one 64-float array a thread,
// where holding a block's three channels in one thread would need 192.
// grid = (ceil(blocks per plane / 32), batch): one launch covers a
// (B, 3, H, W) batch; any W % 64 == 0, H2 % 8 == 0 runs directly.  The mix
// matrices and the bias (ColorMix, dct_common.cuh) come by value from the
// host constants of layout/color.py, like the scales.

#include "dct_common.cuh"

namespace {

constexpr int kColorBlocks = 32;                 // 8x8 blocks a CUDA block: one warp
constexpr int kColorThreads = 3 * kColorBlocks;  // a warp per channel
constexpr int kColorGroups = kColorBlocks / 8;   // 8-block record groups a channel
constexpr int kRecSmem = 3 * kColorGroups * kGroupStride;
constexpr int kYccPitch = 65;                    // floats per (channel, block) slab
constexpr int kYccPlane = kColorBlocks * kYccPitch;

// Channel c of the forward mix of one 8x8 RGB block; p points at its R
// piece, the G and B pieces lie plane_stride and 2*plane_stride further.
__device__ __forceinline__ void load_mixed_block(const uint8_t* __restrict__ p,
                                                 long long plane_stride, int w, int c,
                                                 const ColorMix& mix, float (&x)[64]) {
  const float m0 = pick(c, mix.fwd[0], mix.fwd[3], mix.fwd[6]);
  const float m1 = pick(c, mix.fwd[1], mix.fwd[4], mix.fwd[7]);
  const float m2 = pick(c, mix.fwd[2], mix.fwd[5], mix.fwd[8]);
  const float bias = pick(c, mix.bias[0], mix.bias[1], mix.bias[2]);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = p + (size_t)r * w;
    const uint2 vr = __ldg(reinterpret_cast<const uint2*>(row));
    const uint2 vg = __ldg(reinterpret_cast<const uint2*>(row + plane_stride));
    const uint2 vb = __ldg(reinterpret_cast<const uint2*>(row + 2 * plane_stride));
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[r * 8 + i] = __fadd_rn(mix3(m0, m1, m2, byte_of(vr, i), byte_of(vg, i), byte_of(vb, i)),
                               bias);
  }
}

// A thread's IDCT output, bias removed, into its shared-memory slab.
__device__ __forceinline__ void put_ycc(float* __restrict__ slab, int c, const ColorMix& mix,
                                       const float (&x)[64]) {
  const float bias = pick(c, mix.bias[0], mix.bias[1], mix.bias[2]);
#pragma unroll
  for (int p = 0; p < 64; ++p) slab[p] = __fsub_rn(x[p], bias);
}

// Output channel c of the inverse mix of block b's three YCbCr slabs, as an
// 8x8 u8 block at p (round half to even, clip).
__device__ __forceinline__ void store_unmixed(uint8_t* __restrict__ p, int w, int c,
                                              const ColorMix& mix,
                                              const float* __restrict__ slab_y) {
  const float m0 = pick(c, mix.inv[0], mix.inv[3], mix.inv[6]);
  const float m1 = pick(c, mix.inv[1], mix.inv[4], mix.inv[7]);
  const float m2 = pick(c, mix.inv[2], mix.inv[5], mix.inv[8]);
  float x[64];
#pragma unroll
  for (int q = 0; q < 64; ++q)
    x[q] = mix3(m0, m1, m2, slab_y[q], slab_y[kYccPlane + q], slab_y[2 * kYccPlane + q]);
  store_block(p, w, x);
}

// Replaces simd_dct_tpu/kernels/color32.py _enc32_rgb_kernel.
// Bound: memory, 3 bytes read + 3 bytes written per pixel position; the
// f32 work (3 x (8.25 + 3) FMAs per pixel position, butterfly transform and
// mix) is below the CUDA cores' rate.  Design: see the head of this file;
// the records leave through shared memory in 16-byte stores as enc32's do.
template <int R>
__global__ void __launch_bounds__(kColorThreads)
enc32_rgb_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales ql,
                 Scales qc, ColorMix mix, int h2, int w, long long plane_stride) {
  __shared__ __align__(16) uint8_t rec[kRecSmem];
  const int c = threadIdx.x / kColorBlocks;  // uniform in a warp
  const int b = threadIdx.x % kColorBlocks;
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kColorBlocks;
  const long long blk = blk0 + b;
  const long long plane_out = (long long)h2 * w;
  if (blk < nblk) {
    const long long s = blk / bw;
    const int bx = (int)(blk - s * bw);
    float x[64];
    load_mixed_block(img + (long long)blockIdx.y * 3 * plane_stride + 8 * s * w + 8 * bx,
                     plane_stride, w, c, mix, x);
    dct2d(x);
    uint8_t* slot = rec + (c * kColorGroups + (b >> 3)) * kGroupStride + (b & 7);
#pragma unroll
    for (int p = 0; p < 64; ++p) slot[p * 8] = quantize<R>(x[p], c == 0 ? ql.v[p] : qc.v[p]);
  }
  __syncthreads();
  const int pieces = 4 * (int)(nblk - blk0 < kColorBlocks ? nblk - blk0 : kColorBlocks);
  const uint4* s4 = reinterpret_cast<const uint4*>(rec);
  uint8_t* dst = out + (long long)blockIdx.y * 3 * plane_out + blk0 * 64;
  for (int i = threadIdx.x; i < 3 * pieces; i += kColorThreads) {
    const int ch = i / pieces, j = i - ch * pieces;
    reinterpret_cast<uint4*>(dst + ch * plane_out)[j] = s4[smem_piece(ch * kColorGroups * 32 + j)];
  }
}

// Replaces simd_dct_tpu/kernels/color32.py _dec32_rgb_kernel.
// Bound: memory, as enc32_rgb; 3 x (8.25 + 3) FMAs per pixel position.
// Design: the records come in through shared memory with 16-byte loads as
// dec32's do; the three channels meet in shared memory for the inverse mix.
__global__ void __launch_bounds__(kColorThreads)
dec32_rgb_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out, Scales qil,
                 Scales qic, ColorMix mix, int h2, int w) {
  __shared__ __align__(16) uint8_t rec[kRecSmem];
  __shared__ float ycc[3 * kYccPlane];
  const int c = threadIdx.x / kColorBlocks;
  const int b = threadIdx.x % kColorBlocks;
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk0 = (long long)blockIdx.x * kColorBlocks;
  const long long blk = blk0 + b;
  const long long plane = (long long)h2 * w;
  const long long frame = (long long)blockIdx.y * 3 * plane;
  const int pieces = 4 * (int)(nblk - blk0 < kColorBlocks ? nblk - blk0 : kColorBlocks);
  const uint8_t* src = records + frame + blk0 * 64;
  uint4* r4 = reinterpret_cast<uint4*>(rec);
  for (int i = threadIdx.x; i < 3 * pieces; i += kColorThreads) {
    const int ch = i / pieces, j = i - ch * pieces;
    r4[smem_piece(ch * kColorGroups * 32 + j)] =
        __ldg(reinterpret_cast<const uint4*>(src + ch * plane) + j);
  }
  __syncthreads();
  const bool live = blk < nblk;
  if (live) {
    const uint8_t* slot = rec + (c * kColorGroups + (b >> 3)) * kGroupStride + (b & 7);
    float x[64];
#pragma unroll
    for (int p = 0; p < 64; ++p)
      x[p] = __fmul_rn((float)slot[p * 8] - 127.0f, c == 0 ? qil.v[p] : qic.v[p]);
    idct2d(x);
    put_ycc(ycc + threadIdx.x * kYccPitch, c, mix, x);
  }
  __syncthreads();
  if (!live) return;
  const long long s = blk / bw;
  const int bx = (int)(blk - s * bw);
  store_unmixed(out + frame + c * plane + 8 * s * w + 8 * bx, w, c, mix, ycc + b * kYccPitch);
}

// Replaces simd_dct_tpu/kernels/color32.py _roundtrip_rgb_kernel.
// Bound: operations, 3 x (16.5 + 3 + 3) FMAs per pixel position against 6
// bytes (at 3.35 TB/s and 33.5 T FMA/s the FMAs take longer).  Design: the
// quantized levels never leave registers (quantize clip(rint(z*q)) on
// [-127, 128], then times the dequant scale, color32.py:229-231), the same
// device functions as enc32_rgb and dec32_rgb.
__global__ void __launch_bounds__(kColorThreads)
roundtrip32_rgb_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales ql,
                       Scales qc, Scales qil, Scales qic, ColorMix mix, int h2, int w,
                       long long plane_stride) {
  __shared__ float ycc[3 * kYccPlane];
  const int c = threadIdx.x / kColorBlocks;
  const int b = threadIdx.x % kColorBlocks;
  const int bw = w >> 3;
  const long long nblk = (long long)(h2 >> 3) * bw;
  const long long blk = (long long)blockIdx.x * kColorBlocks + b;
  const bool live = blk < nblk;
  const long long s = live ? blk / bw : 0;
  const int bx = (int)(blk - s * bw);
  if (live) {
    float x[64];
    load_mixed_block(img + (long long)blockIdx.y * 3 * plane_stride + 8 * s * w + 8 * bx,
                     plane_stride, w, c, mix, x);
    dct2d(x);
#pragma unroll
    for (int p = 0; p < 64; ++p)
      x[p] = __fmul_rn(quant_level(__fmul_rn(x[p], c == 0 ? ql.v[p] : qc.v[p])),
                       c == 0 ? qil.v[p] : qic.v[p]);
    idct2d(x);
    put_ycc(ycc + threadIdx.x * kYccPitch, c, mix, x);
  }
  __syncthreads();
  if (!live) return;
  const long long plane = (long long)h2 * w;
  store_unmixed(out + (long long)blockIdx.y * 3 * plane + c * plane + 8 * s * w + 8 * bx, w, c,
                mix, ycc + b * kYccPitch);
}

unsigned color_grid_x(int h2, int w) {
  const long long nblk = (long long)(h2 / 8) * (w / 8);
  return (unsigned)((nblk + kColorBlocks - 1) / kColorBlocks);
}

}  // namespace

extern "C" {

// img: (batch, 3, >= h2 rows, w) u8 planar RGB, planes plane_stride bytes
// apart and frames 3*plane_stride; only the first h2 rows of each plane are
// read.  out: (batch, 3, h2*w) u8 records.  ql, qc: 64 host f32 quant
// scales of the luma and chroma LUTs; mix: 21 host f32, the ColorMix.
int sdct_enc32_rgb(const void* img, void* out, const float* ql, const float* qc,
                   const float* mix, int batch, int h2, int w, long long plane_stride,
                   int rounding, void* stream) {
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(color_grid_x(h2, w), batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  const Scales sl = to_scales(ql), sc = to_scales(qc);
  const ColorMix m = to_mix(mix);
  switch (rounding) {
    case kRne:
      enc32_rgb_kernel<kRne><<<grid, kColorThreads, 0, st>>>(in, o, sl, sc, m, h2, w,
                                                             plane_stride);
      break;
    case kScalar:
      enc32_rgb_kernel<kScalar><<<grid, kColorThreads, 0, st>>>(in, o, sl, sc, m, h2, w,
                                                                plane_stride);
      break;
    case kClampFirst:
      enc32_rgb_kernel<kClampFirst><<<grid, kColorThreads, 0, st>>>(in, o, sl, sc, m, h2, w,
                                                                    plane_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// records: (batch, 3, h2*w) u8.  out: (batch, 3, h2, w) u8.  qil, qic: 64
// host f32 dequant scales each; mix as for sdct_enc32_rgb.
int sdct_dec32_rgb(const void* records, void* out, const float* qil, const float* qic,
                   const float* mix, int batch, int h2, int w, void* stream) {
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(color_grid_x(h2, w), batch);
  dec32_rgb_kernel<<<grid, kColorThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)records, (uint8_t*)out, to_scales(qil), to_scales(qic), to_mix(mix), h2,
      w);
  return (int)cudaGetLastError();
}

// img as for sdct_enc32_rgb; out: (batch, 3, h2, w) u8.
int sdct_roundtrip32_rgb(const void* img, void* out, const float* ql, const float* qc,
                         const float* qil, const float* qic, const float* mix, int batch,
                         int h2, int w, long long plane_stride, void* stream) {
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(color_grid_x(h2, w), batch);
  roundtrip32_rgb_kernel<<<grid, kColorThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (uint8_t*)out, to_scales(ql), to_scales(qc), to_scales(qil),
      to_scales(qic), to_mix(mix), h2, w, plane_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
