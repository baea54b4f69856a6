// YCbCr 4:2:0 colour kernels for Hopper (sm_90a): encode and decode of
// planar RGB through a luma record stream and two half-resolution chroma
// record streams.  Plain C entry points, loaded with ctypes by
// simd_dct_tpu_torch/kernels/_build.py and wrapped by kernels/cuda_dct.py.
//
// Colour 4:2:0: a (3, H, W) u8 planar RGB dual view, of which the top
// H2 = H/2 rows are encoded (W % 128 == 0, H2 % 16 == 0).  Per pixel the
// BT.601 mix in f32 as in color32.cu (mix3, then the bias; no u8 step).  Cb
// and Cr are pooled over each 2x2 pixel square, ((x00 + x01) + (x10 + x11))
// * 0.25 with every step rounded (layout/color420.py pool2x2), to
// (H2/2, W/2) planes.  Each plane then gets the mode32 encode of dct32.cu
// in the raw 0..255 domain, Y with the luma scales and Cb, Cr with the
// chroma scales.  A frame's stream is 1.5*H2*W bytes,
//   [ Y records (H2*W) | Cb records (H2*W/4) | Cr records (H2*W/4) ],
// each segment the mode32 record stream of its plane.  The decode
// dequantizes, runs the IDCT per plane, subtracts the bias, gives each
// chroma value to its 2x2 pixel square and applies the inverse mix in f32
// (the YCbCr values are not rounded), then rounds half to even and clips.
//
// Design.  The unit is a 16x16 macroblock: 4 Y blocks, 1 Cb block and 1 Cr
// block.  A CUDA block of k420Threads = 192 threads covers kMacro = 32
// consecutive macroblocks, in six warps whose roles are uniform: warps 0-3
// hold Y blocks, warp 0 and 1 the top 8 rows of macroblocks 0-15 and 16-31
// (two neighbouring lanes per macroblock, left and right block), warps 2
// and 3 the bottom 8 rows; warp 4 holds the Cb blocks and warp 5 the Cr
// blocks, a lane per macroblock.  Every thread holds one 64-float block.
//   * encode: each Y thread reads its 8x8 piece of R, G and B once, mixes
//     its Y values and pools its quadrant's 4x4 Cb and Cr values into the
//     chroma slabs in shared memory (65-float pitch, so a chroma warp's 32
//     reads fall on 32 banks).  After a barrier the Y warps transform and
//     quantize their blocks while the chroma warps load their 64 pooled
//     values and do the same.  The records are staged in shared memory as
//     in enc32_kernel and leave in 16-byte stores;
//   * decode: the records come in through shared memory with 16-byte loads;
//     the chroma warps run the IDCT and write their values, bias removed,
//     to the chroma slabs; after a barrier each Y thread reads its
//     quadrant's 4x4 Cb and Cr values, gives each to 2x2 pixels and stores
//     the three RGB channels of its 64 pixels.
// Records: 8 macroblocks in a row are 16 Y blocks of each block row (two
// 512-byte groups) and 8 chroma blocks (one group per chroma plane).  W/16
// is a multiple of 8, so such a unit of 8 never crosses a macroblock row,
// and a CUDA block's 32 macroblocks are 4 units, each whole or past the end
// of the plane (the tail mask).  grid = (ceil(macroblocks / 32), batch): one
// launch covers a (B, 3, H, W) batch.

#include "dct_common.cuh"

namespace {

constexpr int kMacro = 32;                          // 16x16 macroblocks a CUDA block
constexpr int k420Threads = 6 * 32;                 // 4 Y warps, a Cb warp, a Cr warp
constexpr int kUnits = kMacro / 8;                  // 8-macroblock record units
constexpr int kYGroups = 4 * kUnits;                // Y groups: 2 block rows x 2 a unit
constexpr int k420Groups = kYGroups + 2 * kUnits;  // then the Cb groups, then Cr
constexpr int k420RecSmem = k420Groups * kGroupStride;
constexpr int kChromaPitch = 65;                    // floats per chroma block slab
constexpr int kChromaPlane = kMacro * kChromaPitch;

// The role of a thread of a 192-thread CUDA block.
struct Role {
  int m;       // macroblock in the CUDA block, 0..31
  int c;       // plane: 0 Y, 1 Cb, 2 Cr (uniform in a warp)
  int dy, dx;  // Y: the block's quadrant of its macroblock
};

__device__ __forceinline__ Role role_of(int t) {
  const int warp = t >> 5, lane = t & 31;
  Role r;
  if (warp < 4) {
    r.m = 16 * (warp & 1) + (lane >> 1);
    r.c = 0;
    r.dy = warp >> 1;
    r.dx = lane & 1;
  } else {
    r.m = lane;
    r.c = warp - 3;
    r.dy = r.dx = 0;
  }
  return r;
}

// This thread's block slot in the record staging: its 512-byte group and
// its byte within each 8-byte coefficient row of the group.
__device__ __forceinline__ uint8_t* staged_slot(uint8_t* rec, const Role& r) {
  const int u = r.m >> 3;
  if (r.c == 0) {
    const int k = 2 * (r.m & 7) + r.dx;  // Y block of the unit's block row
    return rec + ((u * 2 + r.dy) * 2 + (k >> 3)) * kGroupStride + (k & 7);
  }
  return rec + (kYGroups + (r.c - 1) * kUnits + u) * kGroupStride + (r.m & 7);
}

// Thread t's 16-byte piece of record unit u, whose first macroblock is mb:
// returns its byte offset in the frame's stream and sets its index among
// the staging's pieces (smem_piece order).  Threads 0-127 move the unit's
// 1024 Y bytes of each block row, 128-159 its 512 Cb bytes, 160-191 its
// 512 Cr bytes.
__device__ __forceinline__ long long unit_piece(int t, int u, long long mb, int mbw, int h2,
                                                int w, int& piece) {
  if (t < 128) {
    const int dy = t >> 6, j = t & 63;
    const long long my = mb / mbw, mx = mb - my * mbw;
    piece = (u * 2 + dy) * 64 + j;
    return ((2 * my + dy) * (w >> 3) + 2 * mx) * 64 + 16 * j;
  }
  const int c = (t - 128) >> 5, j = t & 31;
  const long long y_plane = (long long)h2 * w;
  piece = (kYGroups + c * kUnits + u) * 32 + j;
  return y_plane + c * (y_plane >> 2) + mb * 64 + 16 * j;
}

// Replaces simd_dct_tpu/kernels/color420.py _enc420_kernel.
// Bound: memory, 3 bytes read and 1.5 written per pixel position; the f32
// work (Y: 8.25 + 3, Cb and Cr: 3 each for the mix, 0.75 for the pool and a
// quarter of 8.25 for the transform: about 23 FMAs per pixel position) is
// below the CUDA cores' rate.  Design: see the head of this file; each RGB
// byte is read once, by the Y thread whose block holds it.  ptxas takes
// 167-168 registers (two CUDA blocks an SM); capped to three blocks (96
// registers) it spilled 56-472 bytes and ran 31% slower on an H100.
template <int R>
__global__ void __launch_bounds__(k420Threads)
enc420_rgb_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales ql,
                  Scales qc, ColorMix mix, int h2, int w, long long plane_stride) {
  __shared__ __align__(16) uint8_t rec[k420RecSmem];
  __shared__ float chroma[2 * kChromaPlane];
  const Role r = role_of(threadIdx.x);
  const int mbw = w >> 4;
  const long long nmb = (long long)(h2 >> 4) * mbw;
  const long long mb0 = (long long)blockIdx.x * kMacro;
  const long long mb = mb0 + r.m;
  const bool live = mb < nmb;
  float x[64];
  if (live && r.c == 0) {
    const long long my = mb / mbw, mx = mb - my * mbw;
    const uint8_t* p = img + (long long)blockIdx.y * 3 * plane_stride +
                       (16 * my + 8 * r.dy) * w + 16 * mx + 8 * r.dx;
    float* cb = chroma + r.m * kChromaPitch + 32 * r.dy + 4 * r.dx;
#pragma unroll
    for (int rp = 0; rp < 4; ++rp) {  // a pair of pixel rows
      uint2 v[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          v[h][ch] = __ldg(reinterpret_cast<const uint2*>(p + (size_t)(2 * rp + h) * w +
                                                          ch * plane_stride));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          x[(2 * rp + h) * 8 + i] =
              __fadd_rn(mix3(mix.fwd[0], mix.fwd[1], mix.fwd[2], byte_of(v[h][0], i),
                             byte_of(v[h][1], i), byte_of(v[h][2], i)),
                        mix.bias[0]);
#pragma unroll
      for (int c = 1; c < 3; ++c) {
        const float m0 = mix.fwd[3 * c], m1 = mix.fwd[3 * c + 1], m2 = mix.fwd[3 * c + 2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              a[h][e] = __fadd_rn(mix3(m0, m1, m2, byte_of(v[h][0], 2 * j + e),
                                       byte_of(v[h][1], 2 * j + e), byte_of(v[h][2], 2 * j + e)),
                                  mix.bias[c]);
          cb[(c - 1) * kChromaPlane + 8 * rp + j] =
              __fmul_rn(__fadd_rn(__fadd_rn(a[0][0], a[0][1]), __fadd_rn(a[1][0], a[1][1])),
                        0.25f);
        }
      }
    }
  }
  __syncthreads();
  if (live) {
    if (r.c != 0) {
      const float* slab = chroma + (r.c - 1) * kChromaPlane + r.m * kChromaPitch;
#pragma unroll
      for (int p = 0; p < 64; ++p) x[p] = slab[p];
    }
    dct2d(x);
    uint8_t* slot = staged_slot(rec, r);
#pragma unroll
    for (int p = 0; p < 64; ++p) slot[p * 8] = quantize<R>(x[p], r.c == 0 ? ql.v[p] : qc.v[p]);
  }
  __syncthreads();
  uint8_t* frame = out + (long long)blockIdx.y * (3LL * h2 * w / 2);
  const uint4* s4 = reinterpret_cast<const uint4*>(rec);
#pragma unroll
  for (int u = 0; u < kUnits && mb0 + 8 * u < nmb; ++u) {
    int piece;
    const long long off = unit_piece(threadIdx.x, u, mb0 + 8 * u, mbw, h2, w, piece);
    *reinterpret_cast<uint4*>(frame + off) = s4[smem_piece(piece)];
  }
}

// Replaces simd_dct_tpu/kernels/color420.py _dec420_kernel.
// Bound: memory, 1.5 bytes read and 3 written per pixel position; about 21
// FMAs per pixel position (the transforms, dequantization and the inverse
// mix).  Design: the records come in through shared memory; the chroma
// warps' IDCT output meets the Y threads in the chroma slabs.  Three CUDA
// blocks an SM: uncapped, ptxas takes 126 registers, which fit two; the cap
// (96 registers, 24 bytes of spills) ran 10% faster on an H100 (PERF.md).
__global__ void __launch_bounds__(k420Threads, 3)
dec420_rgb_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out,
                  Scales qil, Scales qic, ColorMix mix, int h2, int w) {
  __shared__ __align__(16) uint8_t rec[k420RecSmem];
  __shared__ float chroma[2 * kChromaPlane];
  const Role r = role_of(threadIdx.x);
  const int mbw = w >> 4;
  const long long nmb = (long long)(h2 >> 4) * mbw;
  const long long mb0 = (long long)blockIdx.x * kMacro;
  const long long mb = mb0 + r.m;
  const bool live = mb < nmb;
  const uint8_t* frame = records + (long long)blockIdx.y * (3LL * h2 * w / 2);
  uint4* r4 = reinterpret_cast<uint4*>(rec);
#pragma unroll
  for (int u = 0; u < kUnits && mb0 + 8 * u < nmb; ++u) {
    int piece;
    const long long off = unit_piece(threadIdx.x, u, mb0 + 8 * u, mbw, h2, w, piece);
    r4[smem_piece(piece)] = __ldg(reinterpret_cast<const uint4*>(frame + off));
  }
  __syncthreads();
  float x[64];
  if (live) {
    const uint8_t* slot = staged_slot(rec, r);
#pragma unroll
    for (int p = 0; p < 64; ++p)
      x[p] = __fmul_rn((float)slot[p * 8] - 127.0f, r.c == 0 ? qil.v[p] : qic.v[p]);
    idct2d(x);
    const float bias = pick(r.c, mix.bias[0], mix.bias[1], mix.bias[2]);
    if (r.c != 0) {
      float* slab = chroma + (r.c - 1) * kChromaPlane + r.m * kChromaPitch;
#pragma unroll
      for (int p = 0; p < 64; ++p) slab[p] = __fsub_rn(x[p], bias);
    } else {
#pragma unroll
      for (int p = 0; p < 64; ++p) x[p] = __fsub_rn(x[p], bias);
    }
  }
  __syncthreads();
  if (!live || r.c != 0) return;
  const long long my = mb / mbw, mx = mb - my * mbw;
  const long long plane = (long long)h2 * w;
  uint8_t* o = out + (long long)blockIdx.y * 3 * plane + (16 * my + 8 * r.dy) * w + 16 * mx +
               8 * r.dx;
  const float* cb = chroma + r.m * kChromaPitch + 32 * r.dy + 4 * r.dx;
#pragma unroll
  for (int row = 0; row < 8; ++row) {
    float b[4], d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = cb[8 * (row >> 1) + j];
      d[j] = cb[kChromaPlane + 8 * (row >> 1) + j];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float px[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        px[i] = mix3(mix.inv[3 * ch], mix.inv[3 * ch + 1], mix.inv[3 * ch + 2], x[row * 8 + i],
                     b[i >> 1], d[i >> 1]);
      uint2 v;
      v.x = pack4(px);
      v.y = pack4(px + 4);
      *reinterpret_cast<uint2*>(o + ch * plane + (size_t)row * w) = v;
    }
  }
}

inline bool geometry420_ok(int batch, int h2, int w) {
  return batch > 0 && batch <= 65535 && h2 > 0 && w > 0 && h2 % 16 == 0 && w % 128 == 0;
}

unsigned grid420_x(int h2, int w) {
  const long long nmb = (long long)(h2 / 16) * (w / 16);
  return (unsigned)((nmb + kMacro - 1) / kMacro);
}

}  // namespace

extern "C" {

// img: (batch, 3, >= h2 rows, w) u8 planar RGB, planes plane_stride bytes
// apart and frames 3*plane_stride; only the first h2 rows of each plane are
// read.  out: (batch, 1.5*h2*w) u8 streams.  ql, qc: 64 host f32 quant
// scales of the luma and chroma LUTs; mix: 21 host f32, the ColorMix.
int sdct_enc420_rgb(const void* img, void* out, const float* ql, const float* qc,
                    const float* mix, int batch, int h2, int w, long long plane_stride,
                    int rounding, void* stream) {
  if (!geometry420_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid420_x(h2, w), batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  const Scales sl = to_scales(ql), sc = to_scales(qc);
  const ColorMix m = to_mix(mix);
  switch (rounding) {
    case kRne:
      enc420_rgb_kernel<kRne><<<grid, k420Threads, 0, st>>>(in, o, sl, sc, m, h2, w,
                                                            plane_stride);
      break;
    case kScalar:
      enc420_rgb_kernel<kScalar><<<grid, k420Threads, 0, st>>>(in, o, sl, sc, m, h2, w,
                                                               plane_stride);
      break;
    case kClampFirst:
      enc420_rgb_kernel<kClampFirst><<<grid, k420Threads, 0, st>>>(in, o, sl, sc, m, h2, w,
                                                                   plane_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// records: (batch, 1.5*h2*w) u8 streams.  out: (batch, 3, h2, w) u8.  qil,
// qic: 64 host f32 dequant scales each; mix as for sdct_enc420_rgb.
int sdct_dec420_rgb(const void* records, void* out, const float* qil, const float* qic,
                    const float* mix, int batch, int h2, int w, void* stream) {
  if (!geometry420_ok(batch, h2, w)) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid420_x(h2, w), batch);
  dec420_rgb_kernel<<<grid, k420Threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)records, (uint8_t*)out, to_scales(qil), to_scales(qic), to_mix(mix), h2,
      w);
  return (int)cudaGetLastError();
}

}  // extern "C"
