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
// is index arithmetic.  Both kernels walk strip tiles on a persistent grid.
//   * A strip tile is block rows 2q and 2q + 1 of one 128x128 tile: 32
//     blocks.  Its pixels are 16 rows of 128 bytes: one 3-D tensor copy,
//     box {128, 16, 1} over the view read as (W, 128, B*P).  Its
//     coefficients are the 16 Z rows u*16 + 2q + m' (u < 8, m' < 2) of 128
//     bytes: one 4-D tensor copy, box {128, 2, 8, 1} over the tiles read as
//     (W, 16 [m], 8 [u], B*P), 2 KB, in shared memory as [u][m'][128].  W %
//     128 == 0 and H2 % 128 == 0: no tile is short.
//   * CTA i takes tiles i, i + grid, ..., numbered over (frame * P + p, q,
//     j), j fastest (strip_at).  Thread 0 brings each tile in on an
//     mbarrier `Stages` tiles ahead: with one buffer, as soon as the tile
//     before has been read, under its second pass.  The results leave
//     `OutBuffers` buffers, each reused only after
//     cp.async.bulk.wait_group.read.
//   * Four threads an 8x8 block (128 a CTA): lane l of warp w' holds block
//     (m', n) = (w' & 1, l & 15) and index w = 2(w' >> 1) + (l >> 4); it
//     takes columns, then rows, w + 4h.  Values cross between the passes
//     through cross_at (the block row as its channel, free of bank
//     conflicts).
// The tile kernel (tiles_kernel): a thread reads the 8 bytes of each pixel
// row of its block (the warp's 16 blocks are one 128-byte line), takes the
// bytes of its two columns to f32 exactly (byte_f32), times f32(1/255)
// when normalized, and runs dct2d's column pass (dct_column); the thread of
// rows u runs the row pass (dct_row) and quantizes each coefficient with
// the orientation's scale (quantize_byte, off the conversion unit; 'scalar'
// keeps quantize<>), staged at [u][m'][(n >> 3)*64 + v*8 + (n & 7)]; the
// Z rows leave by one tensor store.  The arithmetic of enc32, encq and
// enc_stereo, so the converted tiles equal their records byte for byte.
// The tile inverse (detile_kernel), the mirror: a thread dequantizes
// coefficient columns v ((b - 127) exactly, times the scale; the scales
// sit in shared memory transposed for 'fy', as they are for 'fx', so
// row_scales serves both) and runs idct2d's first pass; the thread of rows
// j runs the second, times 255 when normalized, rounds half to even, clips
// and packs 8 pixels (tile_common.cuh, the code dec_stereo_kernel runs);
// the pixel rows leave by one tensor store.  The byte reads of a warp (16
// blocks x two neighbouring columns) touch 8 distinct words.
// Every product and sum of dct2d / idct2d is kept in its order and every
// conversion is exact: the bytes equal the thread-per-block form, and the
// detile of each mode's converted records equals its decode.
// Bound: memory, 1 byte read and 1 written per pixel; 8.25 f32 FMAs per
// pixel are below the CUDA cores' rate, but the matrix form the identities
// fix sets an arithmetic floor above the bytes (PERF.md).  No
// --use_fast_math: the 'scalar' rounding divides by 255.

#include "tile_common.cuh"

namespace {

constexpr int kTile = 128;                 // pixels a tile side
constexpr int kStripBytes = 16 * kTile;    // a strip tile's 16 pixel rows, or 16 Z rows
constexpr int kCrossBytes = 4 * 64 * 32;   // the f32 crossing buffer of 32 blocks

enum Orientation { kFy = 0, kFx = 1 };

// The tile kernel: threads an 8x8 block (2 or 4; each takes 8 / that many
// columns, then rows), the pixel tiles in flight and the Z buffers.
constexpr int kTilesBlockThreads = 4;
constexpr int kTilesLines = 8 / kTilesBlockThreads;
constexpr int kTilesThreads = 32 * kTilesBlockThreads;  // 32 blocks a tile
constexpr int kTilesStages = 1;
constexpr int kTilesOutBuffers = 1;
static_assert(kTilesLines == 2 || kTilesLines == 4, "4 or 2 threads a block");
// Shared bytes of a launch: the scales, the Z buffers, the pixel tiles, the
// crossing buffer.  The host's plan (cuda_dct.tiles_smem) computes the same
// and the entry point compares.
constexpr int kTilesSmem =
    64 * 4 + (kTilesOutBuffers + kTilesStages) * kStripBytes + kCrossBytes;

// The tile inverse's: four threads and one buffer of each ran 9% faster at
// 4K than two threads and two of each (12,544 shared bytes, 12 CTAs of 128
// threads an SM; tiles_variants.py, PERF.md).
constexpr int kDetileBlockThreads = 4;
constexpr int kDetileLines = 8 / kDetileBlockThreads;
constexpr int kDetileThreads = 32 * kDetileBlockThreads;  // 32 blocks a tile
constexpr int kDetileStages = 1;
constexpr int kDetileOutBuffers = 1;
static_assert(kDetileLines == 2 || kDetileLines == 4, "4 or 2 threads a block");
// Shared bytes of a launch: the scales, the pixel buffers, the input
// tiles, the crossing buffer.  The host's plan (cuda_dct.detile_smem)
// computes the same and the entry point compares.
constexpr int kDetileSmem =
    64 * 4 + (kDetileOutBuffers + kDetileStages) * kStripBytes + kCrossBytes;

struct StripGeom {
  unsigned nj;     // 128x128 tiles a row of the view: W / 128
  unsigned tiles;  // strip tiles of the launch, 8 a 128x128 tile (below 2^31)
};

struct StripTile {
  int bp;  // 128-row band of the launch: frame * P + p
  int q;   // block rows 2q, 2q + 1 of the band
  int j;   // its 128x128 tile of the band
};

// Strip tile t, numbered over (bp, q, j), j fastest.
__device__ __forceinline__ StripTile strip_at(const StripGeom& g, unsigned t) {
  const unsigned row = t / g.nj;
  StripTile a;
  a.j = (int)(t - row * g.nj);
  a.q = (int)(row & 7);
  a.bp = (int)(row >> 3);
  return a;
}

// Thread 0: strip tile t (if the launch has it) into `stage` by one 4-D
// tensor copy: Z rows u*16 + 2q + m' of its 128x128 tile, as [u][m'][128].
__device__ __forceinline__ void load_z(const CUtensorMap* m, const StripGeom& g, unsigned t,
                                       uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const StripTile a = strip_at(g, t);
  arrive_expect(bar, kStripBytes);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(stage)),
      "l"(m), "r"(kTile * a.j), "r"(2 * a.q), "r"(0), "r"(a.bp), "r"(saddr(bar))
      : "memory");
}

// Thread 0: strip tile t's 16 pixel rows (if the launch has it) into
// `stage` by one 3-D tensor copy.
__device__ __forceinline__ void load_rows16(const CUtensorMap* m, const StripGeom& g, unsigned t,
                                            uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const StripTile a = strip_at(g, t);
  arrive_expect(bar, kStripBytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(saddr(stage)),
      "l"(m), "r"(kTile * a.j), "r"(16 * a.q), "r"(a.bp), "r"(saddr(bar))
      : "memory");
}

// The storing thread: strip tile t's 16 Z rows by one 4-D tensor store.
__device__ __forceinline__ void store_z(const CUtensorMap* m, const StripGeom& g, unsigned t,
                                        const uint8_t* z) {
  const StripTile a = strip_at(g, t);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], "
      "[%5];" ::"l"(m),
      "r"(kTile * a.j), "r"(2 * a.q), "r"(0), "r"(a.bp), "r"(saddr(z))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The storing thread: strip tile t's 16 pixel rows by one 3-D tensor store.
__device__ __forceinline__ void store_rows16(const CUtensorMap* m, const StripGeom& g,
                                             unsigned t, const uint8_t* pix) {
  const StripTile a = strip_at(g, t);
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(
          m),
      "r"(kTile * a.j), "r"(16 * a.q), "r"(a.bp), "r"(saddr(pix))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Thread 0: the mbarriers of the input tiles, then a barrier.
template <int S>
__device__ __forceinline__ void init_stages(uint64_t (&full)[S]) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _tiles_kernel.  Design: see
// the head of this file.
template <int R, int O, bool N>
__global__ void __launch_bounds__(kTilesThreads)
tiles_kernel(StripGeom g, Scales q, const __grid_constant__ CUtensorMap tin,
             const __grid_constant__ CUtensorMap tout) {
  constexpr int T = kTilesBlockThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kTilesStages];
  float* sq = reinterpret_cast<float*>(smem);  // sq[u*8 + v]: the scale of (u, v)
  uint8_t* zs = smem + 64 * 4;                 // 128-byte aligned, as the tensor copies want
  uint8_t* stages = zs + kTilesOutBuffers * kStripBytes;
  float* cross = reinterpret_cast<float*>(stages + kTilesStages * kStripBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // block (mr, n) of the strip tile; columns, then rows, w + T*h
  const int mr = warp & 1, n = lane & 15, w = 2 * (warp >> 1) + (lane >> 4);
  const bool storer = threadIdx.x == 32;  // lane 0 of warp 1
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sq[O == kFy ? i : (i & 7) * 8 + (i >> 3)] = q.v[i];
  }
  init_stages(full);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kTilesStages; ++s)
      load_rows16(&tin, g, blockIdx.x + s * gridDim.x, stages + s * kStripBytes, &full[s]);
  }
  // this thread's block in a staged Z row: (u, v) at + u*2*128 + v*8
  const int zcol = mr * kTile + (n >> 3) * 64 + (n & 7);
  unsigned i = 0, half = 0;  // the CTA's tile count; the Z buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % kTilesStages;
    wait_full(&full[s], (i / kTilesStages) & 1);
    // column k = w + T*h of block (mr, n): byte (T*h & 3) + w of word
    // (T*h) >> 2 of each of its rows, exactly as f32
    const uint8_t* px = stages + s * kStripBytes + 8 * mr * kTile + 8 * n;
    float x[kTilesLines][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint2 r = *reinterpret_cast<const uint2*>(px + j * kTile);
#pragma unroll
      for (int h = 0; h < kTilesLines; ++h) {
        const float b = byte_f32((T * h) >> 2 ? r.y : r.x, ((T * h) & 3) + w);
        x[h][j] = N ? __fmul_rn(b, kInv255) : b;
      }
    }
#pragma unroll
    for (int h = 0; h < kTilesLines; ++h) {
      // t[u][k] = sum_j D[u][j] x[j][k]
      float tc[8];
      dct_column(x[h], tc);
#pragma unroll
      for (int u = 0; u < 8; ++u) cross[cross_at(mr, u, w + T * h, n)] = tc[u];
    }
    // the store of the tile kTilesOutBuffers back has read its buffer
    if (storer) bulk_wait_read<kTilesOutBuffers - 1>();
    __syncthreads();
    // the pixels are read: the tile kTilesStages ahead comes into their buffer
    if (threadIdx.x == 0)
      load_rows16(&tin, g, t + kTilesStages * gridDim.x, stages + s * kStripBytes, &full[s]);
    uint8_t* z = zs + half * kStripBytes;
#pragma unroll
    for (int h = 0; h < kTilesLines; ++h) {
      // row u of block (mr, n): c[u][v] = sum_k t[u][k] D[v][k], quantized
      // into Z row u*16 + mr, column (n >> 3)*64 + v*8 + (n & 7)
      const int u = w + T * h;
      float tr[8], c[8], qv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) tr[k] = cross[cross_at(mr, u, k, n)];
      dct_row(tr, c);
      row_scales(sq, u, qv);
#pragma unroll
      for (int v = 0; v < 8; ++v) z[u * 2 * kTile + zcol + v * 8] = quantize_byte<R>(c[v], qv[v]);
    }
    fence_async_shared();
    __syncthreads();
    if (storer) store_z(&tout, g, t, z);
    half = (half + 1) % kTilesOutBuffers;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _detile_kernel.  Design: see
// the head of this file.
template <int O, bool N>
__global__ void __launch_bounds__(kDetileThreads)
detile_kernel(StripGeom g, Scales qi, const __grid_constant__ CUtensorMap tin,
              const __grid_constant__ CUtensorMap tout) {
  constexpr int T = kDetileBlockThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kDetileStages];
  float* sq = reinterpret_cast<float*>(smem);  // sq[v*8 + u]: the scale of (u, v)
  uint8_t* pixs = smem + 64 * 4;               // 128-byte aligned, as the tensor copies want
  uint8_t* stages = pixs + kDetileOutBuffers * kStripBytes;
  float* cross = reinterpret_cast<float*>(stages + kDetileStages * kStripBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // block (mr, n) of the strip tile; columns, then rows, w + T*h
  const int mr = warp & 1, n = lane & 15, w = 2 * (warp >> 1) + (lane >> 4);
  const bool storer = threadIdx.x == 32;  // lane 0 of warp 1
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sq[O == kFy ? (i & 7) * 8 + (i >> 3) : i] = qi.v[i];
  }
  init_stages(full);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDetileStages; ++s)
      load_z(&tin, g, blockIdx.x + s * gridDim.x, stages + s * kStripBytes, &full[s]);
  }
  // this thread's block in a staged Z row: (u, v) at + u*2*128 + v*8
  const int zcol = mr * kTile + (n >> 3) * 64 + (n & 7);
  unsigned i = 0, half = 0;  // the CTA's tile count; the pixel buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % kDetileStages;
    wait_full(&full[s], (i / kDetileStages) & 1);
    const uint8_t* z = stages + s * kStripBytes + zcol;
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
      load_z(&tin, g, t + kDetileStages * gridDim.x, stages + s * kStripBytes, &full[s]);
    uint8_t* pix = pixs + half * kStripBytes;
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
  return batch > 0 && h2 > 0 && w > 0 && h2 % kTile == 0 && w % kTile == 0 &&
         (normalize == 0 || normalize == 1) && (orientation == kFy || orientation == kFx);
}

template <int R>
const void* tiles_fn_of(int normalize, int orientation) {
  if (orientation == kFy)
    return normalize ? (const void*)tiles_kernel<R, kFy, true>
                     : (const void*)tiles_kernel<R, kFy, false>;
  return normalize ? (const void*)tiles_kernel<R, kFx, true>
                   : (const void*)tiles_kernel<R, kFx, false>;
}

// The instantiation of the tile kernel for these options, or null.
const void* tiles_fn(int rounding, int normalize, int orientation) {
  if ((normalize != 0 && normalize != 1) || (orientation != kFy && orientation != kFx))
    return nullptr;
  switch (rounding) {
    case kRne:
      return tiles_fn_of<kRne>(normalize, orientation);
    case kScalar:
      return tiles_fn_of<kScalar>(normalize, orientation);
    case kClampFirst:
      return tiles_fn_of<kClampFirst>(normalize, orientation);
    default:
      return nullptr;
  }
}

// The instantiation of the tile inverse for these options, or null.
const void* detile_fn(int normalize, int orientation) {
  if ((normalize != 0 && normalize != 1) || (orientation != kFy && orientation != kFx))
    return nullptr;
  if (orientation == kFy)
    return normalize ? (const void*)detile_kernel<kFy, true> : (const void*)detile_kernel<kFy, false>;
  return normalize ? (const void*)detile_kernel<kFx, true> : (const void*)detile_kernel<kFx, false>;
}

const cuuint32_t kUnit[4] = {1, 1, 1, 1};

// The tiles (B*P bands of 128 Z rows) as (W, 16 [m], 8 [u], B*P) with box
// {128, 2, 8, 1}: a strip tile's Z rows.
bool z_map(CUtensorMap* m, const void* tiles, long long bands, int w) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t W = (cuuint64_t)w;
  const cuuint64_t dims[4] = {W, 16, 8, (cuuint64_t)bands};
  const cuuint64_t strides[3] = {W, 16 * W, 128 * W};
  const cuuint32_t box[4] = {kTile, 2, 8, 1};
  return fn && fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(tiles), dims, strides,
                  box, kUnit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The pixels (B*P bands of 128 rows) as (W, 128, B*P) with box {128, 16,
// 1}: a strip tile's pixel rows.
bool rows_map(CUtensorMap* m, const void* pixels, long long bands, int w) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t W = (cuuint64_t)w;
  const cuuint64_t dims[3] = {W, 128, (cuuint64_t)bands};
  const cuuint64_t strides[2] = {W, 128 * W};
  const cuuint32_t box[3] = {kTile, 16, 1};
  return fn && fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(pixels), dims, strides,
                  box, kUnit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch of a tile kernel `fn` of `threads` threads and `smem` shared
// bytes on (batch, h2, w) frames: its maps over `z` and `pixels` (16-byte
// aligned), in the order `z_first` gives, and the plan's grid, which the
// strip tiles must cover (fewer than 2^31 of them).
int launch_strips(const void* fn, int threads, const void* pixels, const void* z, bool z_first,
                  const float* q, int batch, int h2, int w, int grid, int smem, void* stream) {
  if (!fn || grid <= 0 || (((uintptr_t)pixels | (uintptr_t)z) & 15))
    return (int)cudaErrorInvalidValue;
  const long long bands = (long long)batch * (h2 / kTile);
  const long long strips = bands * (w / kTile) * 8;
  if (strips >= (1ll << 31) || grid > strips) return (int)cudaErrorInvalidValue;
  CUtensorMap tz = {}, tpix = {};
  if (!z_map(&tz, z, bands, w) || !rows_map(&tpix, pixels, bands, w))
    return (int)cudaErrorInvalidValue;
  StripGeom g;
  g.nj = (unsigned)(w / kTile);
  g.tiles = (unsigned)strips;
  Scales s = to_scales(q);
  void* args[] = {&g, &s, z_first ? &tz : &tpix, z_first ? &tpix : &tz};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// The CTAs of `fn` (of `threads` threads and `smem` shared bytes) an SM
// holds, and the SMs of the current card.
int capacity_of(const void* fn, int threads, int smem, int* per_sm, int* sms) {
  if (!fn) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, smem);
  return (int)e;
}

}  // namespace

extern "C" {

// The launch of the tile kernel (the rounding, `normalize` and
// `orientation` instantiation): the shared bytes a CTA takes and how many
// such CTAs an SM holds, and the SMs of the current card.
int sdct_tiles_capacity(int rounding, int normalize, int orientation, int* smem, int* per_sm,
                        int* sms) {
  *smem = kTilesSmem;
  return capacity_of(tiles_fn(rounding, normalize, orientation), kTilesThreads, *smem, per_sm,
                     sms);
}

// view: (batch, h2, w) u8, contiguous, 16-byte aligned.  out: (batch,
// h2/128, 128, w/128, 128) u8 tiles, h2*w bytes a frame, 16-byte aligned.
// q: 64 host f32 in the orientation's buffer order.  orientation: 0 fy, 1
// fx.  normalize: 0 or 1.  grid and smem: the host's launch plan
// (cuda_dct.tiles_plan); smem must equal what the kernel lays out.
int sdct_tiles(const void* view, void* out, const float* q, int batch, int h2, int w,
               int normalize, int orientation, int rounding, int grid, int smem, void* stream) {
  if (!tile_geometry_ok(batch, h2, w, normalize, orientation) || smem != kTilesSmem)
    return (int)cudaErrorInvalidValue;
  return launch_strips(tiles_fn(rounding, normalize, orientation), kTilesThreads, view, out,
                       false, q, batch, h2, w, grid, smem, stream);
}

// The launch of the tile inverse (the `normalize` and `orientation`
// instantiation): the shared bytes a CTA takes and how many such CTAs an
// SM holds, and the SMs of the current card.
int sdct_detile_capacity(int normalize, int orientation, int* smem, int* per_sm, int* sms) {
  *smem = kDetileSmem;
  return capacity_of(detile_fn(normalize, orientation), kDetileThreads, *smem, per_sm, sms);
}

// tiles: (batch, h2/128, 128, w/128, 128) u8, 16-byte aligned.  out:
// (batch, h2, w) u8, 16-byte aligned.  qi: 64 host f32 in the
// orientation's buffer order.  grid and smem: the host's launch plan
// (cuda_dct.detile_plan); smem must equal what the kernel lays out.
int sdct_detile(const void* tiles, void* out, const float* qi, int batch, int h2, int w,
                int normalize, int orientation, int grid, int smem, void* stream) {
  if (!tile_geometry_ok(batch, h2, w, normalize, orientation) || smem != kDetileSmem)
    return (int)cudaErrorInvalidValue;
  return launch_strips(detile_fn(normalize, orientation), kDetileThreads, out, tiles, true, qi,
                       batch, h2, w, grid, smem, stream);
}

}  // extern "C"
