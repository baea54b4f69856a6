// Tile kernels for Hopper (sm_90a): the panel engine's quantized
// coefficient tiles and their inverse.  Plain C entry points, loaded with
// ctypes by simd_dct_tpu_torch/kernels/_build.py and wrapped by
// kernels/cuda_dct.py (tiles_panels, detile_panels).
//
// A (H2, W) u8 view (H2 % 128 == 0, W % 128 == 0) is cut into 128x128
// tiles; tile (p, j) covers rows 128p .. +128 and columns 128j .. +128.
// The tile tensor (P, 128, NJ, 128) u8 puts tile (p, j) on the same bytes
// as the view (row r of the tile at (128p + r) * W + 128j), and holds in
// it the natural Z layout of kernels/panel.py: at row u*16 + m, column
// g*64 + v*8 + b, coefficient C[u][v] of the 8x8 block (m, 8g + b) of the
// tile, quantized with scale q[u*8 + v] ('fy', mode32 and stereo) or
// q[v*8 + u] ('fx', enc-quant), and biased by 127.  With ``normalize`` the
// pixels are first multiplied by f32(1/255) (the enc-quant and stereo
// domain) and the inverse multiplies by 255 after the IDCT.  The mode
// records are permutes of these tiles (kernels/panel.py tiles_to_*).
//
// Design.  The TPU kernels compute Z with two (128,128) matmuls against
// permuted block-diagonal bases only because Mosaic cannot reshape u8
// (simd_dct_tpu/kernels/pallas_dct.py:12-19); on this card the permutation
// is index arithmetic:
//   * one CUDA block per tile, grid = (NJ, P, frames); 256 threads, one per
//     8x8 block (m = thread / 16, n = thread % 16), each holding its 64
//     values in f32 registers and running the transform and quantizer of
//     dct_common.cuh -- the arithmetic of enc32, encq and enc_stereo, so
//     the converted tiles equal their records byte for byte;
//   * the quantized tile is staged in shared memory, rows kTilePitch = 144
//     bytes apart: a warp's two block rows m then write their stride-8
//     bytes to disjoint banks, and the tile leaves as 128 rows of 128
//     contiguous bytes in 16-byte stores, eight threads a row;
//   * pixel rows are read as 8-byte loads, 16 threads on 128 contiguous
//     bytes.  The detile kernel is the mirror: 16-byte loads of the tile
//     into shared memory, a gather of each block's 64 bytes, -127, x the
//     inverse scale, the IDCT, x 255 when normalized, rint, clip, 8-byte
//     stores.
// Bound: memory, 1 byte read and 1 written per pixel; 8.25 f32 FMAs per
// pixel are below the CUDA cores' rate.  No --use_fast_math: the 'scalar'
// rounding divides by 255.

#include "dct_common.cuh"

namespace {

constexpr int kTile = 128;                // pixels a tile side
constexpr int kTileThreads = 256;         // one per 8x8 block of a tile
constexpr int kTilePitch = kTile + 16;    // shared-memory bytes a staged row

enum Orientation { kFy = 0, kFx = 1 };

// Shared-memory offset of coefficient (u, v) of block (m, n) of the staged
// tile: row u*16 + m, column (n / 8)*64 + v*8 + n % 8.
__device__ __forceinline__ int z_offset(int u, int v, int m, int n) {
  return (u * 16 + m) * kTilePitch + (n >> 3) * 64 + v * 8 + (n & 7);
}

// The LUT index of coefficient (u, v): buffer order of the orientation.
template <int O>
__device__ __forceinline__ int scale_index(int u, int v) {
  return O == kFy ? u * 8 + v : v * 8 + u;
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _tiles_kernel.
template <int R, int O, bool N>
__global__ void __launch_bounds__(kTileThreads)
tiles_kernel(const uint8_t* __restrict__ view, uint8_t* __restrict__ out, Scales q, int h2,
             int w) {
  __shared__ __align__(16) uint8_t tile[kTile * kTilePitch];
  const long long origin = (long long)blockIdx.z * h2 * w +
                           (long long)blockIdx.y * kTile * w + (long long)blockIdx.x * kTile;
  const int m = threadIdx.x >> 4;
  const int n = threadIdx.x & 15;
  float x[64];
  load_block(view + origin + (long long)(8 * m) * w + 8 * n, w, x);
  if (N) {
#pragma unroll
    for (int p = 0; p < 64; ++p) x[p] = __fmul_rn(x[p], kInv255);
  }
  dct2d(x);  // x[u*8 + v] = C[u][v]
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int v = 0; v < 8; ++v)
      tile[z_offset(u, v, m, n)] = quantize<R>(x[u * 8 + v], q.v[scale_index<O>(u, v)]);
  }
  __syncthreads();
  const int piece = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < kTile; r += kTileThreads / 8)
    *reinterpret_cast<uint4*>(out + origin + (long long)r * w + 16 * piece) =
        *reinterpret_cast<const uint4*>(tile + r * kTilePitch + 16 * piece);
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _detile_kernel.
template <int O, bool N>
__global__ void __launch_bounds__(kTileThreads)
detile_kernel(const uint8_t* __restrict__ tiles, uint8_t* __restrict__ out, Scales qi, int h2,
              int w) {
  __shared__ __align__(16) uint8_t tile[kTile * kTilePitch];
  const long long origin = (long long)blockIdx.z * h2 * w +
                           (long long)blockIdx.y * kTile * w + (long long)blockIdx.x * kTile;
  const int piece = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < kTile; r += kTileThreads / 8)
    *reinterpret_cast<uint4*>(tile + r * kTilePitch + 16 * piece) =
        __ldg(reinterpret_cast<const uint4*>(tiles + origin + (long long)r * w + 16 * piece));
  __syncthreads();
  const int m = threadIdx.x >> 4;
  const int n = threadIdx.x & 15;
  float c[64];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int v = 0; v < 8; ++v)
      c[u * 8 + v] =
          __fmul_rn((float)tile[z_offset(u, v, m, n)] - 127.0f, qi.v[scale_index<O>(u, v)]);
  }
  idct2d(c);
  if (N) {
#pragma unroll
    for (int p = 0; p < 64; ++p) c[p] = __fmul_rn(c[p], 255.0f);
  }
  store_block(out + origin + (long long)(8 * m) * w + 8 * n, w, c);
}

bool tile_geometry_ok(int batch, int h2, int w, int normalize, int orientation) {
  return batch > 0 && batch <= 65535 && h2 > 0 && w > 0 && h2 % kTile == 0 && w % kTile == 0 &&
         h2 / kTile <= 65535 && (normalize == 0 || normalize == 1) &&
         (orientation == kFy || orientation == kFx);
}

template <int R, int O>
void tiles_by_normalize(int normalize, dim3 grid, cudaStream_t st, const uint8_t* in,
                        uint8_t* o, const Scales& q, int h2, int w) {
  if (normalize)
    tiles_kernel<R, O, true><<<grid, kTileThreads, 0, st>>>(in, o, q, h2, w);
  else
    tiles_kernel<R, O, false><<<grid, kTileThreads, 0, st>>>(in, o, q, h2, w);
}

template <int R>
void tiles_by_orientation(int orientation, int normalize, dim3 grid, cudaStream_t st,
                          const uint8_t* in, uint8_t* o, const Scales& q, int h2, int w) {
  if (orientation == kFy)
    tiles_by_normalize<R, kFy>(normalize, grid, st, in, o, q, h2, w);
  else
    tiles_by_normalize<R, kFx>(normalize, grid, st, in, o, q, h2, w);
}

template <int O>
void detile_by_normalize(int normalize, dim3 grid, cudaStream_t st, const uint8_t* in,
                         uint8_t* o, const Scales& qi, int h2, int w) {
  if (normalize)
    detile_kernel<O, true><<<grid, kTileThreads, 0, st>>>(in, o, qi, h2, w);
  else
    detile_kernel<O, false><<<grid, kTileThreads, 0, st>>>(in, o, qi, h2, w);
}

}  // namespace

extern "C" {

// view: (batch, h2, w) u8, contiguous.  out: (batch, h2/128, 128, w/128,
// 128) u8 tiles, h2*w bytes a frame.  q: 64 host f32 in the orientation's
// buffer order.  orientation: 0 fy, 1 fx.  normalize: 0 or 1.
int sdct_tiles(const void* view, void* out, const float* q, int batch, int h2, int w,
               int normalize, int orientation, int rounding, void* stream) {
  if (!tile_geometry_ok(batch, h2, w, normalize, orientation)) return (int)cudaErrorInvalidValue;
  const dim3 grid(w / kTile, h2 / kTile, batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)view;
  uint8_t* o = (uint8_t*)out;
  const Scales s = to_scales(q);
  switch (rounding) {
    case kRne:
      tiles_by_orientation<kRne>(orientation, normalize, grid, st, in, o, s, h2, w);
      break;
    case kScalar:
      tiles_by_orientation<kScalar>(orientation, normalize, grid, st, in, o, s, h2, w);
      break;
    case kClampFirst:
      tiles_by_orientation<kClampFirst>(orientation, normalize, grid, st, in, o, s, h2, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tiles: (batch, h2/128, 128, w/128, 128) u8.  out: (batch, h2, w) u8.
// qi: 64 host f32 in the orientation's buffer order.
int sdct_detile(const void* tiles, void* out, const float* qi, int batch, int h2, int w,
                int normalize, int orientation, void* stream) {
  if (!tile_geometry_ok(batch, h2, w, normalize, orientation)) return (int)cudaErrorInvalidValue;
  const dim3 grid(w / kTile, h2 / kTile, batch);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)tiles;
  uint8_t* o = (uint8_t*)out;
  const Scales s = to_scales(qi);
  if (orientation == kFy)
    detile_by_normalize<kFy>(normalize, grid, st, in, o, s, h2, w);
  else
    detile_by_normalize<kFx>(normalize, grid, st, in, o, s, h2, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
