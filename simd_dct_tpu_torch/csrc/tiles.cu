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
// is index arithmetic.
// The tile kernel (tiles_kernel):
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
//     bytes.
// The tile inverse (detile_kernel): dec_stereo_kernel's decode on the Z
// layout, strip tiles, a persistent grid.
//   * A strip tile is block rows 2q and 2q + 1 of one 128x128 tile: 32
//     blocks.  Its coefficients are the 16 Z rows u*16 + 2q + m' (u < 8,
//     m' < 2) of 128 bytes: one 4-D tensor copy, box {128, 2, 8, 1} over
//     the view read as (W, 16 [m], 8 [u], B*P), 2 KB, into shared memory
//     as [u][m'][128].  Its pixels are 16 rows of 128 bytes: one 3-D
//     tensor store, box {128, 16, 1} over (W, 128, B*P).  W % 128 == 0
//     and H2 % 128 == 0: no tile is short.
//   * CTA i takes tiles i, i + grid, ..., numbered over (frame * P + p,
//     q, j), j fastest.  Thread 0 brings each tile in on an mbarrier
//     kDetileStages tiles ahead: with one buffer, as soon as the tile
//     before has been read, under its row pass.  The pixels leave
//     kDetileOutBuffers buffers, each reused only after
//     cp.async.bulk.wait_group.read.
//   * kDetileBlockThreads = 4 threads an 8x8 block: lane l of warp w' holds
//     block (m', n) = (w' & 1, l & 15) and index w = 2(w' >> 1) + (l >> 4);
//     it dequantizes coefficient columns v = w + T*h ((b - 127) exactly,
//     times the scale; the scales sit in shared memory transposed for
//     'fy', as they are for 'fx', so row_scales serves both) and runs
//     idct2d's first pass; t[j][v] crosses through cross_at (the block
//     row as its channel, free of bank conflicts) to the thread of rows
//     j = w + T*h, which runs the second pass, times 255 when normalized,
//     rounds half to even, clips and packs 8 pixels (tile_common.cuh, the
//     code dec_stereo_kernel runs).  The byte reads of a warp (16 blocks
//     x two neighbouring columns) touch 8 distinct words.
//   * Every product and sum of idct2d is kept in its order and every
//     conversion is exact: the bytes equal the thread-per-block form, and
//     the detile of each mode's converted records equals its decode.
// Bound: memory, 1 byte read and 1 written per pixel; 8.25 f32 FMAs per
// pixel are below the CUDA cores' rate, but the matrix form the identities
// fix sets an arithmetic floor above the bytes (PERF.md).  No
// --use_fast_math: the 'scalar' rounding divides by 255.

#include "tile_common.cuh"

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

// -- the tile inverse: strip tiles of 32 blocks --------------------------------

// Threads an 8x8 block (2 or 4; each takes 8 / that many columns, then
// rows), the input tiles in flight and the pixel buffers.  Four threads and
// one buffer of each ran 9% faster at 4K than two threads and two of each
// (12,544 shared bytes, 12 CTAs of 128 threads an SM; tiles_variants.py,
// PERF.md).
constexpr int kDetileBlockThreads = 4;
constexpr int kDetileLines = 8 / kDetileBlockThreads;
constexpr int kDetileThreads = 32 * kDetileBlockThreads;  // 32 blocks a tile
constexpr int kDetileStages = 1;
constexpr int kDetileOutBuffers = 1;
constexpr int kDetileBytes = 16 * kTile;  // 16 Z rows in, or 16 pixel rows out
static_assert(kDetileLines == 2 || kDetileLines == 4, "4 or 2 threads a block");
// Shared bytes of a launch: the scales, the pixel buffers, the input
// tiles, the crossing buffer.  The host's plan (cuda_dct.detile_smem)
// computes the same and the entry point compares.
constexpr int kDetileSmem =
    64 * 4 + (kDetileOutBuffers + kDetileStages) * kDetileBytes + 4 * 64 * 32;

struct DetileGeom {
  unsigned nj;     // 128x128 tiles a row of the view: W / 128
  unsigned tiles;  // strip tiles of the launch, 8 a 128x128 tile (below 2^31)
};

struct DetileTile {
  int bp;  // 128-row band of the launch: frame * P + p
  int q;   // block rows 2q, 2q + 1 of the band
  int j;   // its 128x128 tile of the band
};

// Strip tile t, numbered over (bp, q, j), j fastest.
__device__ __forceinline__ DetileTile detile_at(const DetileGeom& g, unsigned t) {
  const unsigned row = t / g.nj;
  DetileTile a;
  a.j = (int)(t - row * g.nj);
  a.q = (int)(row & 7);
  a.bp = (int)(row >> 3);
  return a;
}

// Thread 0: strip tile t (if the launch has it) into `stage` by one 4-D
// tensor copy: Z rows u*16 + 2q + m' of its 128x128 tile, as [u][m'][128].
__device__ __forceinline__ void load_z(const CUtensorMap* m, const DetileGeom& g, unsigned t,
                                       uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const DetileTile a = detile_at(g, t);
  arrive_expect(bar, kDetileBytes);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(stage)),
      "l"(m), "r"(kTile * a.j), "r"(2 * a.q), "r"(0), "r"(a.bp), "r"(saddr(bar))
      : "memory");
}

// The storing thread: strip tile t's 16 pixel rows by one 3-D tensor store.
__device__ __forceinline__ void store_rows16(const CUtensorMap* m, const DetileGeom& g,
                                             unsigned t, const uint8_t* pix) {
  const DetileTile a = detile_at(g, t);
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(
          m),
      "r"(kTile * a.j), "r"(16 * a.q), "r"(a.bp), "r"(saddr(pix))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _detile_kernel.  Design: see
// the head of this file.
template <int O, bool N>
__global__ void __launch_bounds__(kDetileThreads)
detile_kernel(DetileGeom g, Scales qi, const __grid_constant__ CUtensorMap tin,
              const __grid_constant__ CUtensorMap tout) {
  constexpr int T = kDetileBlockThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kDetileStages];
  float* sq = reinterpret_cast<float*>(smem);  // sq[v*8 + u]: the scale of (u, v)
  uint8_t* pixs = smem + 64 * 4;               // 128-byte aligned, as the tensor copies want
  uint8_t* stages = pixs + kDetileOutBuffers * kDetileBytes;
  float* cross = reinterpret_cast<float*>(stages + kDetileStages * kDetileBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // block (mr, n) of the strip tile; columns, then rows, w + T*h
  const int mr = warp & 1, n = lane & 15, w = 2 * (warp >> 1) + (lane >> 4);
  const bool storer = threadIdx.x == 32;  // lane 0 of warp 1
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sq[O == kFy ? (i & 7) * 8 + (i >> 3) : i] = qi.v[i];
#pragma unroll
    for (int s = 0; s < kDetileStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDetileStages; ++s)
      load_z(&tin, g, blockIdx.x + s * gridDim.x, stages + s * kDetileBytes, &full[s]);
  }
  // this thread's block in a staged Z row: (u, v) at + u*2*128 + v*8
  const int zcol = mr * kTile + (n >> 3) * 64 + (n & 7);
  unsigned i = 0, half = 0;  // the CTA's tile count; the pixel buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % kDetileStages;
    wait_full(&full[s], (i / kDetileStages) & 1);
    const uint8_t* z = stages + s * kDetileBytes + zcol;
#pragma unroll
    for (int h = 0; h < kDetileLines; ++h) {
      // column v of block (mr, n): c[u][v] = (b - 127) * qi exactly, then
      // t[j][v] = sum_u D[u][j] c[u][v]
      const int v = w + T * h;
      float qv[8], c[8], tt[8];
      row_scales(sq, v, qv);
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = dequant_byte(z[u * 2 * kTile + v * 8], qv[u]);
      idct_column(c, tt);
#pragma unroll
      for (int j = 0; j < 8; ++j) cross[cross_at(mr, j, v, n)] = tt[j];
    }
    // the store of the tile kDetileOutBuffers back has read its buffer
    if (storer) bulk_wait_read<kDetileOutBuffers - 1>();
    __syncthreads();
    // the Z rows are read: the tile kDetileStages ahead comes into their buffer
    if (threadIdx.x == 0)
      load_z(&tin, g, t + kDetileStages * gridDim.x, stages + s * kDetileBytes, &full[s]);
    uint8_t* pix = pixs + half * kDetileBytes;
#pragma unroll
    for (int h = 0; h < kDetileLines; ++h) {
      // row j of block (mr, n): x[j][k] = sum_v t[j][v] D[v][k], times 255
      // when normalized, rounded, clipped and packed into pixel row 8mr + j
      const int j = w + T * h;
      float tv[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tv[v] = cross[cross_at(mr, j, v, n)];
      *reinterpret_cast<uint2*>(pix + (8 * mr + j) * kTile + 8 * n) = idct_row_pixels<N>(tv);
    }
    fence_async_shared();
    __syncthreads();
    if (storer) store_rows16(&tout, g, t, pix);
    half = (half + 1) % kDetileOutBuffers;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// The instantiation of the tile inverse for these options, or null.
const void* detile_fn(int normalize, int orientation) {
  if (orientation == kFy)
    return normalize == 1   ? (const void*)detile_kernel<kFy, true>
           : normalize == 0 ? (const void*)detile_kernel<kFy, false>
                            : nullptr;
  if (orientation == kFx)
    return normalize == 1   ? (const void*)detile_kernel<kFx, true>
           : normalize == 0 ? (const void*)detile_kernel<kFx, false>
                            : nullptr;
  return nullptr;
}

// The tile inverse's tensor maps: the input (B*P bands of 128 rows) as
// (W, 16 [m], 8 [u], B*P) with box {128, 2, 8, 1}, the output as
// (W, 128, B*P) with box {128, 16, 1}.
bool detile_maps(CUtensorMap* tin, CUtensorMap* tout, const void* tiles, void* out,
                 long long bands, int w) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t W = (cuuint64_t)w, B = (cuuint64_t)bands;
  const cuuint64_t in_dims[4] = {W, 16, 8, B};
  const cuuint64_t in_strides[3] = {W, 16 * W, 128 * W};
  const cuuint32_t in_box[4] = {kTile, 2, 8, 1};
  const cuuint64_t out_dims[3] = {W, 128, B};
  const cuuint64_t out_strides[2] = {W, 128 * W};
  const cuuint32_t out_box[3] = {kTile, 16, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(tin, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(tiles), in_dims,
            in_strides, in_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(tout, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, out, out_dims, out_strides, out_box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// The launch of the tile inverse (the `normalize` and `orientation`
// instantiation): the shared bytes a CTA takes and how many such CTAs an
// SM holds, and the SMs of the current card.
int sdct_detile_capacity(int normalize, int orientation, int* smem, int* per_sm, int* sms) {
  const void* fn = detile_fn(normalize, orientation);
  if (!fn) return (int)cudaErrorInvalidValue;
  *smem = kDetileSmem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kDetileThreads, *smem);
  return (int)e;
}

// tiles: (batch, h2/128, 128, w/128, 128) u8, 16-byte aligned.  out:
// (batch, h2, w) u8, 16-byte aligned.  qi: 64 host f32 in the
// orientation's buffer order.  grid and smem: the host's launch plan
// (cuda_dct.detile_plan); smem must equal what the kernel lays out.
int sdct_detile(const void* tiles, void* out, const float* qi, int batch, int h2, int w,
                int normalize, int orientation, int grid, int smem, void* stream) {
  if (!tile_geometry_ok(batch, h2, w, normalize, orientation) || grid <= 0 ||
      smem != kDetileSmem || (((uintptr_t)tiles | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  const long long bands = (long long)batch * (h2 / kTile);
  const long long strips = bands * (w / kTile) * 8;
  if (strips >= (1ll << 31) || grid > strips) return (int)cudaErrorInvalidValue;
  const void* fn = detile_fn(normalize, orientation);
  CUtensorMap tin = {}, tout = {};
  if (!detile_maps(&tin, &tout, tiles, out, bands, w)) return (int)cudaErrorInvalidValue;
  DetileGeom g;
  g.nj = (unsigned)(w / kTile);
  g.tiles = (unsigned)strips;
  Scales s = to_scales(qi);
  void* args[] = {&g, &s, &tin, &tout};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kDetileThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

}  // extern "C"
