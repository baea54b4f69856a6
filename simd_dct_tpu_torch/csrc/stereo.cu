// Stereo kernels for Hopper (sm_90a): encode and decode of
// simdDCT_EncodeQuantizeReorderStereoBuffer, both views, in its three view
// layouts.  Plain C entry points, loaded with ctypes by
// simd_dct_tpu_torch/kernels/_build.py and wrapped by kernels/cuda_dct.py.
//
// Stereo: the (H, W) buffer holds two views of H/2 rows, left on top.  For
// each 8x8 block of view v (rows v*H/2 + 8s .. +8, columns 8bx .. +8):
// pixels times f32(1/255), C = D X D^T, q = 255 / (lut * 0.95), +127 bias,
// u8.  The 64-byte buffer is fy-major, byte p = u*8 + v holds C[u][v] with
// scale q[p] (the mode32 order, not enc-quant's fx order).  Byte p of every
// block goes to coefficient plane p; with S = H/16 strips and BW = W/8 block
// columns, block (v, s, bx) stores its byte p at
//   * interleaved (the reference's H*W stream):  p*(S*2*BW) + s*2*BW + v*BW + bx;
//   * planar (2, 64, S, BW):                     v*(64*S*BW) + p*(S*BW) + s*BW + bx;
//   * native (2, 64, S, BWP):                    v*(64*S*BWP) + p*(S*BWP) + s*BWP + bx,
//     whose columns [BW, BWP) hold 127.
// Strip s is kept iff start_y <= 16*s <= end_y; every byte of an excluded
// strip is 0 in every form, native pad included.
//
// Design.  The output is plane-major: one 8x8 block scatters its 64 bytes
// over 64 planes, S*2*BW bytes apart (245,760 at 4K interleaved), so a
// thread per block storing its own bytes would make every warp store touch
// 32 bytes of one plane row.  Instead a CUDA block of kRun threads owns a
// run of kRun consecutive block columns of one (frame, strip, view) row:
//   * thread t computes block column bx0 + t in f32 registers with the
//     device functions of dct_common.cuh (the same arithmetic as mode32 and
//     enc-quant);
//   * the threads transpose their 64-byte buffers through shared memory
//     into 64 plane-row segments of up to kRun bytes (byte p of thread t at
//     row p, column t: a warp writes 32 consecutive bytes of one row, no
//     bank conflict);
//   * the segments leave with 16-byte stores, eight threads a segment, when
//     every segment starts on a 16-byte boundary: BW % 16 == 0 (W % 128 ==
//     0, true at 3840 and 1920) or the native form (BWP % 128 == 0, and its
//     runs cover whole 128-column rows).  Any other W % 8 == 0 (e.g. W = 200,
//     BW = 25) takes byte stores, consecutive threads on consecutive bytes;
//   * in native form the runs cover [0, BWP): the run that holds a row's
//     pad columns writes them, 127 or 0 by the strip's inclusion, and
//     nothing else does.  Every output byte has exactly one writer.
// Decode is the mirror: 64 plane-row segments come in with 16-byte loads
// (byte loads when BW % 16 != 0; the native pad is never read), thread t
// gathers column t from shared memory, dequantizes (b - 127) * qi[p], runs
// the IDCT, times 255, rounds half to even, clips and stores its 8x8 block.
// grid = (ceil(row / kRun), 2*S, batch): one launch covers a (B, H, W)
// batch, any H % 16 == 0 and W % 8 == 0, with no pad or slice pass.

#include "dct_common.cuh"

namespace {

constexpr int kRun = 128;  // block columns (threads) of one CUDA block

enum ViewLayout { kInterleaved = 0, kPlanar = 1, kNative = 2 };

// Offset, within one frame's records, of block column 0 of plane p in
// strip s of view v.
template <int V>
__device__ __forceinline__ long long plane_row(int p, long long s, int v, int s_n, int bw,
                                               int bwp) {
  if (V == kInterleaved) return ((long long)p * s_n + s) * 2 * bw + (long long)v * bw;
  const long long pitch = V == kNative ? bwp : bw;
  return (((long long)v * 64 + p) * s_n + s) * pitch;
}

template <int V>
__device__ __forceinline__ long long frame_bytes(int h, int w, int bwp) {
  return V == kNative ? 2LL * 64 * (h >> 4) * bwp : (long long)h * w;
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _enc_stereo_ilv_kernel
// (interleaved) and _enc_stereo_kernel (planar, native): on this card the
// three view layouts differ only in plane_row.
// Bound: memory, each pixel read once and each record byte written once
// (2 bytes per pixel; native writes BWP/BW times the records); 8.25 f32
// FMAs per pixel are below the CUDA cores' rate.
template <int R, int V>
__global__ void __launch_bounds__(kRun)
enc_stereo_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales q, int h,
                  int w, int bwp, int start_y, int end_y, long long view_stride) {
  __shared__ __align__(16) uint8_t planes[64 * kRun];  // row p: plane p's segment
  const int bw = w >> 3, s_n = h >> 4;
  const int row_len = V == kNative ? bwp : bw;  // block columns a plane row stores
  const long long s = blockIdx.y >> 1;
  const int v = blockIdx.y & 1;
  const int bx0 = blockIdx.x * kRun;
  const int bx = bx0 + threadIdx.x;
  const long long frame = blockIdx.z;
  const bool inc = 16 * s >= start_y && 16 * s <= end_y;
  uint32_t wd[16];
  if (inc && bx < bw) {
    float x[64];
    load_block(img + frame * h * w + v * view_stride + 8 * s * w + 8 * bx, w, x);
#pragma unroll
    for (int p = 0; p < 64; ++p) x[p] = __fmul_rn(x[p], kInv255);
    dct2d(x);  // x[u*8 + v] = C[u][v], the fy buffer order
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        word |= (uint32_t)quantize<R>(x[4 * i + k], q.v[4 * i + k]) << (8 * k);
      wd[i] = word;
    }
  } else {
    // an excluded strip is 0; an included strip's native pad column is 127
    // (a column past row_len is never stored)
    const uint32_t fill = inc ? 0x7f7f7f7fu : 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i) wd[i] = fill;
  }
#pragma unroll
  for (int p = 0; p < 64; ++p)
    planes[p * kRun + threadIdx.x] = (uint8_t)(wd[p >> 2] >> (8 * (p & 3)));
  __syncthreads();
  const int n = row_len - bx0 < kRun ? row_len - bx0 : kRun;  // columns of this run
  uint8_t* dst = out + frame * frame_bytes<V>(h, w, bwp) + bx0;
  if (V == kNative || (bw & 15) == 0) {
    const int pieces = n >> 4;  // n % 16 == 0 here
    for (int i = threadIdx.x; i < 64 * pieces; i += kRun) {
      const int p = i / pieces, k = i - p * pieces;
      *reinterpret_cast<uint4*>(dst + plane_row<V>(p, s, v, s_n, bw, bwp) + 16 * k) =
          *reinterpret_cast<const uint4*>(planes + p * kRun + 16 * k);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * n; i += kRun) {
      const int p = i / n, c = i - p * n;
      dst[plane_row<V>(p, s, v, s_n, bw, bwp) + c] = planes[p * kRun + c];
    }
  }
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _dec_stereo_kernel (all three
// input forms).  Bound: memory, as enc_stereo_kernel.  Design: the mirror of
// the encode -- plane-row segments in, a column gather from shared memory,
// then a thread per 8x8 block.
template <int V>
__global__ void __launch_bounds__(kRun)
dec_stereo_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out, Scales qi,
                  int h, int w, int bwp) {
  __shared__ __align__(16) uint8_t planes[64 * kRun];
  const int bw = w >> 3, s_n = h >> 4;
  const long long s = blockIdx.y >> 1;
  const int v = blockIdx.y & 1;
  const int bx0 = blockIdx.x * kRun;
  const int bx = bx0 + threadIdx.x;
  const long long frame = blockIdx.z;
  const int n = bw - bx0 < kRun ? bw - bx0 : kRun;  // never the native pad
  const uint8_t* src = records + frame * frame_bytes<V>(h, w, bwp) + bx0;
  if ((bw & 15) == 0) {
    const int pieces = n >> 4;
    for (int i = threadIdx.x; i < 64 * pieces; i += kRun) {
      const int p = i / pieces, k = i - p * pieces;
      *reinterpret_cast<uint4*>(planes + p * kRun + 16 * k) = __ldg(
          reinterpret_cast<const uint4*>(src + plane_row<V>(p, s, v, s_n, bw, bwp) + 16 * k));
    }
  } else {
    for (int i = threadIdx.x; i < 64 * n; i += kRun) {
      const int p = i / n, c = i - p * n;
      planes[p * kRun + c] = __ldg(src + plane_row<V>(p, s, v, s_n, bw, bwp) + c);
    }
  }
  __syncthreads();
  if (bx >= bw) return;
  float c[64];
#pragma unroll
  for (int p = 0; p < 64; ++p)
    c[p] = __fmul_rn((float)planes[p * kRun + threadIdx.x] - 127.0f, qi.v[p]);
  idct2d(c);
#pragma unroll
  for (int p = 0; p < 64; ++p) c[p] = __fmul_rn(c[p], 255.0f);
  store_block(out + frame * h * w + ((long long)v * (h >> 1) + 8 * s) * w + 8 * bx, w, c);
}

// bwp is the native plane-row length (layout/stereo.py native_stereo_bwp),
// read only by the native form.
bool geometry_ok(int batch, int h, int w, int bwp, int layout) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || h % 16 || w % 8) return false;
  if (h / 16 * 2 > 65535) return false;  // grid.y
  return layout != kNative || (bwp >= w / 8 && bwp % 128 == 0);
}

template <int R>
int launch_enc(int layout, cudaStream_t st, const uint8_t* in, uint8_t* o, const Scales& q,
               int batch, int h, int w, int bwp, int start_y, int end_y,
               long long view_stride) {
  const int row = layout == kNative ? bwp : w / 8;
  const dim3 grid((row + kRun - 1) / kRun, h / 16 * 2, batch);
  switch (layout) {
    case kInterleaved:
      enc_stereo_kernel<R, kInterleaved><<<grid, kRun, 0, st>>>(in, o, q, h, w, bwp, start_y,
                                                                end_y, view_stride);
      break;
    case kPlanar:
      enc_stereo_kernel<R, kPlanar><<<grid, kRun, 0, st>>>(in, o, q, h, w, bwp, start_y, end_y,
                                                           view_stride);
      break;
    case kNative:
      enc_stereo_kernel<R, kNative><<<grid, kRun, 0, st>>>(in, o, q, h, w, bwp, start_y, end_y,
                                                           view_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img: (batch, h, w) u8 dual-view frames, each view's h/2 rows contiguous,
// the bottom view view_stride bytes after the top one (h/2*w in a whole
// image; more for a shard's row range of both views, then batch == 1),
// frames h*w bytes apart.  out: batch frames of records in the layout's form
// (h*w bytes each, or 2*64*(h/16)*bwp native).  q: 64 host f32 in buffer
// order.  layout: 0 interleaved, 1 planar, 2 native.
int sdct_enc_stereo(const void* img, void* out, const float* q, int batch, int h, int w,
                    int bwp, int start_y, int end_y, int rounding, int layout,
                    long long view_stride, void* stream) {
  if (!geometry_ok(batch, h, w, bwp, layout) || view_stride < (long long)(h / 2) * w ||
      view_stride % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  const Scales s = to_scales(q);
  switch (rounding) {
    case kRne:
      return launch_enc<kRne>(layout, st, in, o, s, batch, h, w, bwp, start_y, end_y,
                                view_stride);
    case kScalar:
      return launch_enc<kScalar>(layout, st, in, o, s, batch, h, w, bwp, start_y, end_y,
                                view_stride);
    case kClampFirst:
      return launch_enc<kClampFirst>(layout, st, in, o, s, batch, h, w, bwp, start_y, end_y,
                                view_stride);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// records: batch frames in the layout's form.  out: (batch, h, w) u8.
// qi: 64 host f32 in buffer order.
int sdct_dec_stereo(const void* records, void* out, const float* qi, int batch, int h, int w,
                    int bwp, int layout, void* stream) {
  if (!geometry_ok(batch, h, w, bwp, layout)) return (int)cudaErrorInvalidValue;
  const dim3 grid((w / 8 + kRun - 1) / kRun, h / 16 * 2, batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)records;
  uint8_t* o = (uint8_t*)out;
  const Scales s = to_scales(qi);
  switch (layout) {
    case kInterleaved:
      dec_stereo_kernel<kInterleaved><<<grid, kRun, 0, st>>>(in, o, s, h, w, bwp);
      break;
    case kPlanar:
      dec_stereo_kernel<kPlanar><<<grid, kRun, 0, st>>>(in, o, s, h, w, bwp);
      break;
    case kNative:
      dec_stereo_kernel<kNative><<<grid, kRun, 0, st>>>(in, o, s, h, w, bwp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
