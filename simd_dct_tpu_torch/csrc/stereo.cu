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
// Design: strip tiles, two threads a block, a persistent grid.
//   * A tile is kTileBlocks = nb = 32 consecutive block columns of one
//     (frame, strip, view) row: 8 rows x 256 pixels in, 64 plane-row
//     segments of 32 bytes out (a whole sector each).  Tiles never cross a
//     strip or a view; the last tile of a row is short where 32 does not
//     divide the row.  CTA i takes tiles i, i + grid, ..., numbered over
//     (frame, strip, view, tile of the row) and walked without divisions
//     (tile_common.cuh TileWalk, shared with encq.cu).
//   * kTensor variant (W % 128 == 0, 16-byte bases and view stride): lane 0
//     brings a tile in by one tensor copy completing on an mbarrier, and
//     the CTA's next tile as soon as this one's input is read, under its
//     second pass.  Results leave a two-buffer stage by one tensor store a
//     tile: the encode's 64 segments as one 5-D box {nb, 1, 1, 64, 1}
//     (interleaved {BW, 2, S, 64, B}; planar and native {row, S, 64, 2, B}),
//     the decode's pixels as one 4-D box {8nb, 8, 1, 1} of {W, H/2, 2, B}.
//     A buffer is reused only after cp.async.bulk.wait_group.read.
//   * kPlain variant (any other W % 8 == 0, 8-byte bases): the same kernel,
//     the threads' own 8-byte pixel loads (tile_common.cuh
//     load_rows_plain) and stores and 16-byte (BW % 16 == 0 or native) or
//     byte record loads and stores.
//   * Two threads a block, 64 a CTA.  Encode: a thread reads four columns
//     of a block (each byte once, to f32 without the conversion unit),
//     scales them by 1/255 and runs dct2d's column pass; t[u][k] crosses
//     through shared memory to the thread of rows u, which runs the row
//     pass, quantizes and writes byte u*8+v into plane row u*8+v, column
//     b (tile_common.cuh dct_column and dct_row, shared with the tile
//     kernel of tiles.cu and the fused round trip of dct32.cu).  Decode is
//     the mirror: a thread dequantizes four columns c[u][v] ((b - 127)
//     exactly, times the scale) and runs idct2d's first pass; the thread of
//     rows j the second, times 255, then rounds half to even, clips and
//     packs 8 pixels a row (tile_common.cuh dequant_byte, idct_column and
//     idct_row_pixels, shared with the tile inverse of tiles.cu).  The DCT
//     basis is compiled into the FMAs as immediates (tile_common.cuh
//     basis).
//   * In native form the encode's tiles cover [0, BWP): a column past BW is
//     written explicitly, 127 in an included strip and 0 in an excluded
//     one, so every output byte has one writer.  A tile of an excluded
//     strip, or one past BW, loads nothing and stores its fill.
//   * Every product and sum of dct2d / idct2d and of the quantizer is kept
//     in its order, and every conversion is exact, so the bytes equal the
//     thread-per-block form that dct_common.cuh's functions give.
// Bound: memory, each pixel read once and each record byte written once (2
// bytes a pixel; native writes BWP/BW times the records).  The matrix form
// the identities fix sets an arithmetic floor above it (PERF.md); the
// kernels are bound by their instructions (stereo_variants.py).

#include "tile_common.cuh"

namespace {

constexpr int kTileBlocks = 32;                   // nb: block columns a tile
constexpr int kBlockThreads = 2;                  // threads an 8x8 block
constexpr int kLines = 8 / kBlockThreads;         // columns, then rows, a thread
constexpr int kStereoThreads = kBlockThreads * kTileBlocks;
constexpr int kRowBytes = 8 * kTileBlocks;        // a pixel row of a tile
constexpr int kTileBytes = 64 * kTileBlocks;      // 8 pixel rows, or 64 segments
constexpr int kCrossFloats = 64 * kTileBlocks;
static_assert(kTileBlocks == 32, "a warp holds the 32 blocks of a tile");
static_assert(kLines == 2 || kLines == 4, "2 or 4 columns a thread");

enum ViewLayout { kInterleaved = 0, kPlanar = 1, kNative = 2 };

// Shared bytes of a launch: the scales, the input tile, two output tiles,
// the crossing buffer.  The host's plan (cuda_dct.stereo_smem) computes the
// same and the entry points compare.
constexpr int kStereoSmem = 64 * 4 + 3 * kTileBytes + 4 * kCrossFloats;

struct StereoGeom {
  int w, bw;              // W, block columns a view row
  int row_len;            // block columns a plane row stores: BWP (native encode), else BW
  int s_n;                // strips a view
  int layout;             // ViewLayout
  int start_y, end_y;     // the encode's strip range
  unsigned tpr;           // tiles a (frame, strip, view) row
  unsigned tiles;         // of the launch (the host keeps it below 2^31)
  long long view_stride;  // bytes from a frame's top view to its bottom view
  long long frame_px;     // pixel bytes a frame: 2 * view_stride
  long long pitch;        // a record plane row: BW, or BWP native
  long long frame_rec;    // record bytes a frame
};

struct Tile {
  long long frame;
  int s, v;
  int bx0, n;  // first block column, columns of the row it covers
};

// The tiles are numbered over (frame, strip, view, tile of the row): a
// TileWalk (tile_common.cuh) whose rows are a frame's 2*S (strip, view)
// pairs.
typedef TileWalk<kTileBlocks> StereoWalk;

__device__ __forceinline__ StereoWalk walk_of(const StereoGeom& g) {
  return StereoWalk(blockIdx.x, gridDim.x, g.tpr, 2 * g.s_n);
}

__device__ __forceinline__ Tile tile_of(const StereoGeom& g, const StereoWalk& w) {
  Tile a;
  a.frame = w.f;
  a.s = (int)(w.r >> 1);
  a.v = (int)(w.r & 1);
  a.bx0 = w.bx0();
  a.n = w.blocks(g.row_len);
  return a;
}

__device__ __forceinline__ bool included(const StereoGeom& g, const Tile& a) {
  return 16 * a.s >= g.start_y && 16 * a.s <= g.end_y;
}

// Whether the encode loads and computes tile a: an included strip, and
// columns before BW.
__device__ __forceinline__ bool enc_live(const StereoGeom& g, const Tile& a) {
  return included(g, a) && a.bx0 < g.bw;
}

// Offset, within one frame's records, of block column 0 of plane p in
// strip s of view v.
__device__ __forceinline__ long long plane_row(const StereoGeom& g, int p, int s, int v) {
  if (g.layout == kInterleaved) return ((long long)p * g.s_n + s) * 2 * g.bw + (long long)v * g.bw;
  return (((long long)v * 64 + p) * g.s_n + s) * g.pitch;
}

// The records box's coordinates: interleaved {bx, v, s, p, frame}, planar
// and native {bx, s, p, v, frame}.
__device__ __forceinline__ void rec_coords(const StereoGeom& g, const Tile& a, int (&c)[5]) {
  const bool ilv = g.layout == kInterleaved;
  c[0] = a.bx0;
  c[1] = ilv ? a.v : a.s;
  c[2] = ilv ? a.s : 0;
  c[3] = ilv ? 0 : a.v;
  c[4] = (int)a.frame;
}

__device__ __forceinline__ void expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// Lane 0 of warp 0: the pixel tile of tile a by one 4-D tensor copy.
__device__ __forceinline__ void load_pixels(const CUtensorMap* m, const Tile& a, uint8_t* stage,
                                            uint64_t* bar) {
  expect_tx(bar, kTileBytes);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(stage)),
      "l"(m), "r"(8 * a.bx0), "r"(8 * a.s), "r"(a.v), "r"((int)a.frame), "r"(saddr(bar))
      : "memory");
}

// Lane 0 of warp 0: the 64 record segments of tile a by one 5-D tensor copy.
__device__ __forceinline__ void load_records(const CUtensorMap* m, const StereoGeom& g,
                                             const Tile& a, uint8_t* stage, uint64_t* bar) {
  int c[5];
  rec_coords(g, a, c);
  expect_tx(bar, kTileBytes);
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(saddr(stage)),
      "l"(m), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(saddr(bar))
      : "memory");
}

// The storing thread: the tile's 64 segments by one 5-D tensor store
// (columns past the map's row are not written).
__device__ __forceinline__ void store_records(const CUtensorMap* m, const StereoGeom& g,
                                              const Tile& a, const uint8_t* rec) {
  int c[5];
  rec_coords(g, a, c);
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4, %5}], "
      "[%6];" ::"l"(m),
      "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(saddr(rec))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The storing thread: the tile's pixel rows by one 4-D tensor store.
__device__ __forceinline__ void store_pixels(const CUtensorMap* m, const Tile& a,
                                             const uint8_t* pix) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], "
      "[%5];" ::"l"(m),
      "r"(8 * a.bx0), "r"(8 * a.s), "r"(a.v), "r"((int)a.frame), "r"(saddr(pix))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ const uint8_t* pixel_row(const uint8_t* base, const StereoGeom& g,
                                                    const Tile& a, int r) {
  return base + a.frame * g.frame_px + a.v * g.view_stride + (8LL * a.s + r) * g.w + 8 * a.bx0;
}

// Record segments move 16 bytes at a time where every one starts on a
// 16-byte boundary and covers whole pieces: BW % 16 == 0, or the encode's
// native rows (BWP % 128 == 0; a segment covers [bx0, bx0 + n) of BWP).
__device__ __forceinline__ bool wide_segments(const StereoGeom& g) {
  return (g.row_len & 15) == 0 && (g.layout == kNative || (g.bw & 15) == 0);
}

// All threads: the tile's 64 segments, row p of `rec` (nb bytes apart) to
// or from plane row p.
template <bool kStore>
__device__ __forceinline__ void move_records_plain(uint8_t* rec, uint8_t* records,
                                                   const StereoGeom& g, const Tile& a) {
  uint8_t* seg = records + a.frame * g.frame_rec + a.bx0;
  if (wide_segments(g)) {
    const int pieces = a.n >> 4;
    for (int i = threadIdx.x; i < 64 * pieces; i += kStereoThreads) {
      const int p = i / pieces, k = i - p * pieces;
      uint4* gl = reinterpret_cast<uint4*>(seg + plane_row(g, p, a.s, a.v) + 16 * k);
      uint4* sh = reinterpret_cast<uint4*>(rec + p * kTileBlocks + 16 * k);
      if (kStore) *gl = *sh;
      else *sh = __ldg(gl);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * a.n; i += kStereoThreads) {
      const int p = i / a.n, c = i - p * a.n;
      uint8_t* gl = seg + plane_row(g, p, a.s, a.v) + c;
      if (kStore) *gl = rec[p * kTileBlocks + c];
      else rec[p * kTileBlocks + c] = __ldg(gl);
    }
  }
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _enc_stereo_ilv_kernel
// (interleaved) and _enc_stereo_kernel (planar, native): on this card the
// three view layouts differ only in where a segment goes.  Design: see the
// head of this file.
template <int R, int V>
__global__ void __launch_bounds__(kStereoThreads)
enc_stereo_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales q,
                  StereoGeom g, const __grid_constant__ CUtensorMap tin,
                  const __grid_constant__ CUtensorMap tout) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full;
  float* sq = reinterpret_cast<float*>(smem);
  uint8_t* stage = smem + 64 * 4;
  uint8_t* recs = stage + kTileBytes;
  float* cross = reinterpret_cast<float*>(recs + 2 * kTileBytes);
  // kLines columns from kLines*cq of block cb (a warp: 32 / kBlockThreads
  // blocks); then kLines rows from kLines*w of block b (a warp: 32 blocks)
  const int cb = threadIdx.x / kBlockThreads, cq = threadIdx.x % kBlockThreads;
  const int b = threadIdx.x % kTileBlocks, w = threadIdx.x / kTileBlocks;
  const bool storer = threadIdx.x == 32;  // lane 0 of warp 1
  put_scales(sq, q);
  tile_prologue(&full);
  StereoWalk walk = walk_of(g);
  Tile a = tile_of(g, walk);
  if (V == kTensor && threadIdx.x == 0 && enc_live(g, a)) load_pixels(&tin, a, stage, &full);
  unsigned phase = 0, half = 0;  // the input's parity; the output buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const bool live = enc_live(g, a);
    if (live) {
      if (V == kTensor) {
        wait_full(&full, phase);
        phase ^= 1;
      } else {
        load_rows_plain<kTileBlocks, kStereoThreads>(pixel_row(img, g, a, 0), g.w, g.bw - a.bx0,
                                                     stage);
      }
      // columns k = kLines*cq + h of block cb: t[u][k] = sum_j D[u][j] x[j][k]
      float x[kLines][8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint8_t* p = stage + r * kRowBytes + cb * 8 + kLines * cq;
        const uint32_t bytes = kLines == 4 ? *reinterpret_cast<const uint32_t*>(p)
                                           : *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
        for (int h = 0; h < kLines; ++h) x[h][r] = __fmul_rn(byte_f32(bytes, h), kInv255);
      }
      float tc[kLines][8];
#pragma unroll
      for (int h = 0; h < kLines; ++h) dct_column(x[h], tc[h]);
#pragma unroll
      for (int uu = 0; uu < 8; ++uu) {
        float* dst = cross + enc_cross(uu, kLines * cq, cb, kTileBlocks);
        if (kLines == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(tc[0][uu], tc[1][uu], tc[2 % kLines][uu],
                                                        tc[3 % kLines][uu]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(tc[0][uu], tc[1][uu]);
      }
    }
    walk.advance(g.tpr, 2 * g.s_n);
    const Tile next = tile_of(g, walk);
    if (V == kTensor && storer) bulk_wait_read<1>();  // tile t - 2 grid has left its buffer
    __syncthreads();
    // the input is read: the CTA's next tile comes in under the rows
    if (V == kTensor && threadIdx.x == 0 && t + gridDim.x < g.tiles && enc_live(g, next))
      load_pixels(&tin, next, stage, &full);
    uint8_t* rec = recs + half * kTileBytes;
    if (live) {
      // rows u = kLines*w + h of block b: c[u][v] = sum_k t[u][k] D[v][k],
      // quantized into byte u*8+v of plane row u*8+v, column b
      const int lo = ((b >> 2) & 1) << 2;
#pragma unroll
      for (int h = 0; h < kLines; ++h) {
        const int u = kLines * w + h;
        const float* line = cross + u * 8 * kTileBlocks + b * 8;
        const float4 t0 = *reinterpret_cast<const float4*>(line + lo);
        const float4 t1 = *reinterpret_cast<const float4*>(line + (lo ^ 4));
        const float tr[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
        float qv[8], c[8];
        row_scales(sq, u, qv);
        dct_row(tr, c);
        uint8_t* dst = rec + u * 8 * kTileBlocks + b;
#pragma unroll
        for (int v = 0; v < 8; ++v) dst[v * kTileBlocks] = quantize_byte<R>(c[v], qv[v]);
      }
      // a native pad column of an included strip (after the stores, so the
      // chains above stay free of branches)
      if (a.bx0 + b >= g.bw) {
#pragma unroll
        for (int v = 0; v < 8 * kLines; ++v) rec[(8 * kLines * w + v) * kTileBlocks + b] = 127;
      }
    } else {
      // an excluded strip is 0; an included strip's native pad is 127
      const uint32_t fill = included(g, a) ? 0x7f7f7f7fu : 0u;
#pragma unroll
      for (int i = 0; i < kTileBytes / 16 / kStereoThreads; ++i)
        reinterpret_cast<uint4*>(rec)[i * kStereoThreads + threadIdx.x] =
            make_uint4(fill, fill, fill, fill);
    }
    if (V == kTensor) fence_async_shared();
    __syncthreads();
    if (V == kTensor) {
      if (storer) store_records(&tout, g, a, rec);
    } else {
      move_records_plain<true>(rec, out, g, a);
    }
    half ^= 1;
    a = next;
  }
  if (V == kTensor && storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/pallas_dct.py _dec_stereo_kernel (all three
// input forms).  Design: see the head of this file.
template <int V>
__global__ void __launch_bounds__(kStereoThreads)
dec_stereo_kernel(const uint8_t* __restrict__ records, uint8_t* __restrict__ out, Scales qi,
                  StereoGeom g, const __grid_constant__ CUtensorMap trec,
                  const __grid_constant__ CUtensorMap tpix) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full;
  float* sq = reinterpret_cast<float*>(smem);  // transposed: sq[v*8 + u] = qi[u*8 + v]
  uint8_t* stage = smem + 64 * 4;
  uint8_t* pixs = stage + kTileBytes;
  float* cross = reinterpret_cast<float*>(pixs + 2 * kTileBytes);
  // block b, kLines columns from kLines*w, then kLines rows from kLines*w
  const int b = threadIdx.x % kTileBlocks, w = threadIdx.x / kTileBlocks;
  const bool storer = threadIdx.x == 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sq[(i & 7) * 8 + (i >> 3)] = qi.v[i];
  }
  tile_prologue(&full);
  StereoWalk walk = walk_of(g);
  Tile a = tile_of(g, walk);
  if (V == kTensor && threadIdx.x == 0) load_records(&trec, g, a, stage, &full);
  unsigned phase = 0, half = 0;
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    if (V == kTensor) {
      wait_full(&full, phase);
      phase ^= 1;
    } else {
      move_records_plain<false>(stage, const_cast<uint8_t*>(records), g, a);
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < kLines; ++h) {
      // column v = kLines*w + h of block b: (b - 127) * qi exactly, then
      // t[j][v] = sum_u D[u][j] c[u][v] (tile_common.cuh)
      const int v = kLines * w + h;
      float c[8], qv[8], t8[8];
      row_scales(sq, v, qv);
#pragma unroll
      for (int uu = 0; uu < 8; ++uu)
        c[uu] = dequant_byte(stage[(uu * 8 + v) * kTileBlocks + b], qv[uu]);
      idct_column(c, t8);
#pragma unroll
      for (int j = 0; j < 8; ++j) cross[dec_cross(j, v, b, kTileBlocks)] = t8[j];
    }
    walk.advance(g.tpr, 2 * g.s_n);
    const Tile next = tile_of(g, walk);
    if (V == kTensor && storer) bulk_wait_read<1>();
    __syncthreads();
    if (V == kTensor && threadIdx.x == 0 && t + gridDim.x < g.tiles)
      load_records(&trec, g, next, stage, &full);
    uint8_t* pix = pixs + half * kTileBytes;
#pragma unroll
    for (int h = 0; h < kLines; ++h) {
      // row j = kLines*w + h of block b: x[j][k] = sum_v t[j][v] D[v][k],
      // times 255, clipped, rounded half to even and packed
      // (tile_common.cuh idct_row_pixels)
      const int j = kLines * w + h;
      float tv[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tv[v] = cross[dec_cross(j, v, b, kTileBlocks)];
      const uint2 row = idct_row_pixels<true>(tv);
      if (V == kTensor)
        *reinterpret_cast<uint2*>(pix + j * kRowBytes + 8 * b) = row;
      else if (a.bx0 + b < g.bw)
        *(reinterpret_cast<uint2*>(const_cast<uint8_t*>(pixel_row(out, g, a, j))) + b) = row;
    }
    if (V == kTensor) {
      fence_async_shared();
      __syncthreads();
      if (storer) store_pixels(&tpix, a, pix);
    }
    half ^= 1;
    a = next;
  }
  if (V == kTensor && storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// bwp is the native plane-row length (layout/stereo.py native_stereo_bwp),
// read only by the native form.  A frame's bottom view lies view_stride
// bytes after its top view: H/2*W in a whole image (and a batch); more for
// a shard's row range of both views, then batch == 1.
bool geometry_ok(int batch, int h, int w, int bwp, int layout, long long view_stride) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || h % 16 || w % 8) return false;
  if (layout < kInterleaved || layout > kNative) return false;
  if (layout == kNative && (bwp < w / 8 || bwp % 128)) return false;
  const long long view = (long long)(h / 2) * w;
  return view_stride == view || (batch == 1 && view_stride > view);
}

// The geometry of a launch, or false where the plan does not fit it:
// grid, tile width and shared bytes as the kernel lays them out, at most
// one CTA a tile, and kTensor only for W % 128 == 0 on 16-byte addresses
// and view strides (every address the plain variant moves is a multiple
// of 8, the records of 16).
bool launch_ok(const void* in, const void* out, int batch, int h, int w, int bwp, int layout,
               int start_y, int end_y, long long view_stride, bool encode, int grid, int nb,
               int variant, int smem, StereoGeom* g) {
  if (!geometry_ok(batch, h, w, bwp, layout, view_stride) || grid <= 0 || nb != kTileBlocks ||
      smem != kStereoSmem || (variant != kPlain && variant != kTensor))
    return false;
  const uintptr_t pix = (uintptr_t)(encode ? in : out) | (uintptr_t)view_stride;
  const uintptr_t rec = (uintptr_t)(encode ? out : in);
  if ((pix & 7) || (rec & 15)) return false;
  if (variant == kTensor && ((pix & 15) || w % 128)) return false;
  g->w = w;
  g->bw = w / 8;
  g->s_n = h / 16;
  g->layout = layout;
  g->row_len = encode && layout == kNative ? bwp : w / 8;
  g->pitch = layout == kNative ? bwp : w / 8;
  g->start_y = start_y;
  g->end_y = end_y;
  g->tpr = (unsigned)((g->row_len + kTileBlocks - 1) / kTileBlocks);
  const long long tiles = (long long)batch * g->s_n * 2 * g->tpr;
  if (tiles >= (1ll << 31) || grid > tiles) return false;
  g->tiles = (unsigned)tiles;
  g->view_stride = view_stride;
  g->frame_px = 2 * view_stride;
  g->frame_rec = layout == kNative ? 2LL * 64 * g->s_n * bwp : (long long)h * w;
  return true;
}

// The (batch, 2, H/2, W) u8 views at `base` (rows W bytes apart, views
// view_stride, frames 2*view_stride) as a tensor map whose box is one
// tile's pixels: 8*nb columns, 8 rows, 1 view, 1 frame.
bool pixels_map(CUtensorMap* m, const void* base, int batch, const StereoGeom& g) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)g.w, (cuuint64_t)g.s_n * 8, 2, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)g.w, (cuuint64_t)g.view_stride,
                                 (cuuint64_t)g.frame_px};
  const cuuint32_t box[4] = {kRowBytes, 8, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch's records as a tensor map whose box is one tile's 64 segments
// (nb columns of one strip and view, 64 planes): interleaved
// {row, 2, S, 64, B}, planar and native {row, S, 64, 2, B}.  row: the
// columns the map holds (the encode's g.row_len; the decode reads BW).
bool records_map(CUtensorMap* m, const void* base, int batch, const StereoGeom& g, int row) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t s_n = (cuuint64_t)g.s_n, pitch = (cuuint64_t)g.pitch;
  const bool ilv = g.layout == kInterleaved;
  const cuuint64_t two = 2, planes = 64;
  const cuuint64_t dims[5] = {(cuuint64_t)row, ilv ? two : s_n, ilv ? s_n : planes,
                              ilv ? planes : two, (cuuint64_t)batch};
  const cuuint64_t strides[4] = {pitch, ilv ? 2 * pitch : s_n * pitch,
                                 ilv ? 2 * s_n * pitch : 64 * s_n * pitch,
                                 (cuuint64_t)g.frame_rec};
  const cuuint32_t box[5] = {kTileBlocks, 1, ilv ? 1u : 64u, ilv ? 64u : 1u, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R>
const void* enc_fn(int variant) {
  return variant == kTensor ? (const void*)enc_stereo_kernel<R, kTensor>
                            : (const void*)enc_stereo_kernel<R, kPlain>;
}

const void* kernel_of(int kind, int rounding, int variant) {
  if (variant != kPlain && variant != kTensor) return nullptr;
  if (kind == 1)
    return variant == kTensor ? (const void*)dec_stereo_kernel<kTensor>
                              : (const void*)dec_stereo_kernel<kPlain>;
  if (kind != 0) return nullptr;
  switch (rounding) {
    case kRne: return enc_fn<kRne>(variant);
    case kScalar: return enc_fn<kScalar>(variant);
    case kClampFirst: return enc_fn<kClampFirst>(variant);
    default: return nullptr;
  }
}

// Dynamic shared memory above the 48 KB default needs the attribute.
cudaError_t prepare(const void* fn, int smem) {
  return smem > 48 * 1024 ? allow_smem(fn, smem) : cudaSuccess;
}

}  // namespace

extern "C" {

// The launch of a stereo kernel: the tile width, the shared bytes a CTA
// takes and how many such CTAs an SM holds, and the SMs of the current
// card.  kind 0 is the encode (`rounding` and `variant` pick its
// instantiation), 1 the decode.
int sdct_stereo_capacity(int kind, int rounding, int variant, int* nb, int* smem, int* per_sm,
                         int* sms) {
  const void* fn = kernel_of(kind, rounding, variant);
  if (!fn) return (int)cudaErrorInvalidValue;
  *nb = kTileBlocks;
  *smem = kStereoSmem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = prepare(fn, *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kStereoThreads, *smem);
  return (int)e;
}

// img: (batch, h, w) u8 dual-view frames, each view's h/2 rows contiguous,
// the bottom view view_stride bytes after the top one (h/2*w in a whole
// image; more for a shard's row range of both views, then batch == 1),
// frames h*w bytes apart; 8-byte address and view stride.  out: batch
// frames of records in the layout's form (h*w bytes each, or
// 2*64*(h/16)*bwp native), 16-byte aligned.  q: 64 host f32 in buffer
// order.  layout: 0 interleaved, 1 planar, 2 native.  grid, nb, variant
// (0 plain, 1 tensor) and smem: the host's launch plan
// (cuda_dct.stereo_plan); nb and smem must equal what the kernel lays out.
int sdct_enc_stereo(const void* img, void* out, const float* q, int batch, int h, int w,
                    int bwp, int start_y, int end_y, int rounding, int layout,
                    long long view_stride, int grid, int nb, int variant, int smem,
                    void* stream) {
  StereoGeom g;
  if (!launch_ok(img, out, batch, h, w, bwp, layout, start_y, end_y, view_stride, true, grid,
                 nb, variant, smem, &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(0, rounding, variant);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tin = {}, tout = {};
  if (variant == kTensor &&
      (!pixels_map(&tin, img, batch, g) || !records_map(&tout, out, batch, g, g.row_len)))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  Scales s = to_scales(q);
  void* args[] = {(void*)&in, (void*)&o, &s, &g, &tin, &tout};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kStereoThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// records: batch frames in the layout's form, 16-byte aligned.  out:
// (batch, h, w) u8.  qi: 64 host f32 in buffer order.  grid, nb, variant
// and smem as for sdct_enc_stereo.
int sdct_dec_stereo(const void* records, void* out, const float* qi, int batch, int h, int w,
                    int bwp, int layout, int grid, int nb, int variant, int smem, void* stream) {
  StereoGeom g;
  if (!launch_ok(records, out, batch, h, w, bwp, layout, 0, 0, (long long)(h / 2) * w, false,
                 grid, nb, variant, smem, &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(1, 0, variant);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap trec = {}, tpix = {};
  if (variant == kTensor &&
      (!records_map(&trec, records, batch, g, g.bw) || !pixels_map(&tpix, out, batch, g)))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)records;
  uint8_t* o = (uint8_t*)out;
  Scales s = to_scales(qi);
  void* args[] = {(void*)&in, (void*)&o, &s, &g, &trec, &tpix};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kStereoThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

}  // extern "C"
