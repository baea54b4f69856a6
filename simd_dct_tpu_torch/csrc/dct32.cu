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
// Arithmetic is f32 on the CUDA cores, in the device functions of
// dct_common.cuh (shared with the other sources): the fused round trip equals
// decode(encode(x)) byte for byte.

#include "dct_common.cuh"

namespace {

// kThreads (16 groups), kGroupStride and smem_piece: dct_common.cuh
constexpr int kRecSmem = (kThreads / 8) * kGroupStride;

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
// Bound: memory, 2 bytes a pixel as enc32.  This form does 32 f32 FMAs per
// pixel, which on an H100 SXM (about 33.5 T FMA/s, 3.35 TB/s) take longer
// than the bytes; the even/odd butterfly of the reference
// (simd_dct_tpu/core/butterfly.py) needs about half as many, so the FMA
// count is the first lever.  Design: the records
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

unsigned grid_x(int h2, int w) {
  const long long nblk = (long long)(h2 / 8) * (w / 8);
  return (unsigned)((nblk + kThreads - 1) / kThreads);
}


}  // namespace

extern "C" {

// img: (batch, >= h2 rows, w) u8 frames, frame_stride bytes apart; only the
// first h2 rows are read.  out: (batch, h2*w) u8 records.  q: 64 host f32.
int sdct_enc32(const void* img, void* out, const float* q, int batch, int h2, int w,
               long long frame_stride, int start_y, int end_y, int rounding,
               void* stream) {
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
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
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x(h2, w), batch);
  dec32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)records, (uint8_t*)out, to_scales(qi), h2, w);
  return (int)cudaGetLastError();
}

// img as for sdct_enc32; out: (batch, h2, w) u8.
int sdct_roundtrip32(const void* img, void* out, const float* q, const float* qi, int batch,
                     int h2, int w, long long frame_stride, void* stream) {
  if (!mode32_geometry_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
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
