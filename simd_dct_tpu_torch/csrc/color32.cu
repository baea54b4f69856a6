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
// Strip tiles, a persistent grid, eight threads a block (the decode's
// threads a block are kDecBlockThreads).
//   * A tile is kTileBlocks = 16 consecutive 8x8 blocks of one strip (8
//     rows x 128 pixels of each plane); the last tile of a strip is short
//     where 16 does not divide W/8.  Its records are one span of 64 bytes a
//     block per channel, at block number s*bw + bx0 of the group-record
//     layout (byte (u*8+v)*8 + (b & 7) of group b >> 3).
//   * A persistent grid: CTA i takes tiles i, i + grid, ..., numbered over
//     (frame, strip, tile of the strip).  Thread 0 brings a tile's 24 rows
//     (8 a plane) into shared memory by one 4-D tensor copy (box 128
//     columns x 8 rows x 3 planes x 1 frame) completing on an mbarrier,
//     and brings the CTA's next tile in as soon as this one's columns are
//     read, under its row pass.  Warp 1 sends the results, staged in two
//     buffers, out of shared memory by bulk stores (the records a 512-byte
//     group at a time, the round trip's pixels by one tensor store); a
//     buffer is reused only after cp.async.bulk.wait_group.read.  The
//     encode of a
//     view whose base or plane stride is not a multiple of 16 takes the
//     plain-load variant: the threads load the tile with 8-byte loads.
//   * 128 threads, eight a block: lane l of warp w holds block b = l & 15
//     and index x = 2w + (l >> 4).  As column k = x, a thread reads column k
//     of block b of the three planes (each byte once, to f32 without the
//     conversion unit), mixes Y, Cb, Cr and runs the column pass of dct2d
//     for each; as row u = x, it runs a row pass.  Values cross between the
//     two through a shared buffer (cross_at) in which every access of either
//     form is free of bank conflicts.  The encode quantizes its row and
//     stages the bytes in padded records (kGroupStride apart, as enc32).
//     The round trip dequantizes in registers, crosses to the columns for
//     the first pass of idct2d and back to the rows for the second; the
//     thread of row j then holds all three channels: bias, inverse mix,
//     rounding and packing happen in registers.
//   * Every product and sum of dct2d / idct2d, the mix and the quantizer is
//     kept in its order, so the bytes equal the one-thread-per-block form
//     (and dec32_rgb(enc32_rgb(x)) for the round trip).  Rounding to an
//     integer is x + 1.5*2^23 on clipped x (ties to even; clip(rint(x)) ==
//     rint(clip(x)) since the limits are integers); rne's +127 is added to
//     the integer bits, after the rounding (127 is odd: rint(x + 127) is
//     not rint(x) + 127 at ties).  The 'scalar' rounding keeps quantize<>.
//   * The decode takes the same tiles the other way, with kDecBlockThreads
//     = 4 threads a block (64 a CTA): thread (b, q) takes columns, then
//     rows, q and q + 4 of block b.  Thread 0 brings a tile's records, each
//     channel's span a 512-byte group at a time, into padded groups in
//     shared memory by 1-D bulk copies completing on one mbarrier, two
//     tiles ahead (kDecStages buffers; a tensor box cannot carry the spans:
//     a box dimension holds at most 256 elements).  The thread of
//     coefficient column v reads its column straight out of the
//     staged records (byte (u*8+v)*8 + (b & 7) holds (u, v)), dequantizes it
//     exactly ((2^23 + b) - (2^23 + 127), times the scale) and runs idct2d's
//     column pass; one crossing reaches the row pass, after which the
//     thread of row j holds the three channels: bias, inverse mix, rounding
//     and packing in registers, as in the round trip, and one tensor store
//     a tile.  The DCT basis is compiled into its FMAs (tile_common.cuh
//     basis).

#include "tile_common.cuh"

namespace {

// -- encode and round trip: strip tiles --------------------------------------

constexpr int kTileBlocks = 16;                       // 8x8 blocks a tile
constexpr int kTileThreads = 8 * kTileBlocks;         // eight a block: 4 warps
constexpr int kTileRow = 8 * kTileBlocks;             // bytes of a tile row of a plane
constexpr int kTileIn = 24 * kTileRow;                // 3 planes x 8 rows
constexpr int kTileGroups = kTileBlocks / 8;          // record groups a channel
constexpr int kTileRec = 3 * kTileGroups * kGroupStride;
constexpr int kCrossBytes = 3 * 64 * kTileBlocks * 4;  // f32 of the crossing buffer
// CTAs an SM the round trip is built for: a cap of 72 registers (uncapped
// it takes 79, six CTAs an SM, and ran 0.8-2% slower on a 4K view)
constexpr int kRoundtripCtas = 7;
// The decode: threads an 8x8 block (8, 4 or 2; each takes 8 / that many
// columns, then rows; four ran 4% faster than eight, PERF.md), the record
// buffers it keeps in flight and its pixel tile buffers.
constexpr int kDecBlockThreads = 4;
constexpr int kDecLines = 8 / kDecBlockThreads;
constexpr int kDecThreads = kDecBlockThreads * kTileBlocks;
constexpr int kDecStages = 2;
constexpr int kDecOutBuffers = 2;
static_assert(kDecLines == 1 || kDecLines == 2 || kDecLines == 4, "8, 4 or 2 threads a block");
// Input loads (Variant, tile_common.cuh): kTensor one 4-D tensor copy a
// tile (box 128 columns x 8 rows x 3 planes x 1 frame), kPlain the threads'
// own 8-byte loads (the encode of a view that is not aligned to 16 bytes).

// Shared bytes of a launch: scales (2 tables, 4 for the round trip), the
// input tile, two output buffers, the crossing buffer.  The host's plan
// (cuda_dct.color_smem) computes the same and the entry points compare.
inline int tile_smem(bool roundtrip) {
  return (roundtrip ? 4 : 2) * 64 * 4 + kTileIn + 2 * (roundtrip ? kTileIn : kTileRec) +
         kCrossBytes;
}

// The decode's: 2 scale tables, kDecOutBuffers pixel tiles, kDecStages
// record buffers, the crossing buffer.
constexpr int kDecSmem =
    2 * 64 * 4 + kDecOutBuffers * kTileIn + kDecStages * kTileRec + kCrossBytes;

struct TileGeom {
  int w, bw;           // W, blocks a row
  unsigned tps;        // tiles a strip
  unsigned strips;     // strips a frame
  unsigned tiles;      // of the launch (the host keeps it below 2^31)
  long long ps;        // plane stride of the input, bytes
  long long plane;     // H2*W: a channel's records or output plane
};

struct Tile {
  long long frame, strip;
  int bx0, nb;  // first block of the strip, blocks (a multiple of 8)
};

// Tile t, numbered over (frame, strip, tile of the strip): 32-bit divisions.
__device__ __forceinline__ Tile tile_at(const TileGeom& g, unsigned t) {
  const unsigned fs = t / g.tps, x = t - fs * g.tps;
  const unsigned frame = fs / g.strips;
  Tile a;
  a.frame = frame;
  a.strip = fs - frame * g.strips;
  a.bx0 = (int)x * kTileBlocks;
  a.nb = min(kTileBlocks, g.bw - a.bx0);
  return a;
}

// Lane 0 of warp 0: tile t (if the launch has it) into `stage` by one
// tensor copy, completing on `bar` with the whole box (a short tile's
// columns past W come in as zeros).
__device__ __forceinline__ void load_tile(const CUtensorMap* tin, const TileGeom& g, unsigned t,
                                          uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const Tile a = tile_at(g, t);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(kTileIn)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(stage)),
      "l"(tin), "r"(8 * a.bx0), "r"((int)(8 * a.strip)), "r"(0), "r"((int)a.frame),
      "r"(saddr(bar))
      : "memory");
}

// All threads: the tile's rows into `stage` with 8-byte loads, then a
// barrier.
__device__ __forceinline__ void load_tile_plain(const uint8_t* img, const TileGeom& g,
                                                unsigned t, uint8_t* stage) {
  const Tile a = tile_at(g, t);
  for (int i = threadIdx.x; i < 24 * a.nb; i += kTileThreads) {
    const int pr = i / a.nb, b = i - pr * a.nb;
    const uint8_t* row =
        img + (a.frame * 3 + (pr >> 3)) * g.ps + (8 * a.strip + (pr & 7)) * g.w + 8 * a.bx0;
    *reinterpret_cast<uint2*>(stage + pr * kTileRow + 8 * b) =
        __ldg(reinterpret_cast<const uint2*>(row + 8 * b));
  }
  __syncthreads();
}

// As column k, thread (b, k): column k of block b of the three planes
// (tile rows kTileRow apart), mixed, bias added, column pass of dct2d:
// t[u][k] = sum_j D[u][j] x[j][k] into the crossing buffer.
__device__ __forceinline__ void mix_columns(const uint8_t* __restrict__ stage,
                                            float* __restrict__ cross, const ColorMix& mix, int b,
                                            int k) {
  float rgb[3][8];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int r = 0; r < 8; ++r) rgb[p][r] = u8f(stage[(p * 8 + r) * kTileRow + b * 8 + k]);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float x[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      x[r] = __fadd_rn(mix3(mix.fwd[ch * 3], mix.fwd[ch * 3 + 1], mix.fwd[ch * 3 + 2], rgb[0][r],
                            rgb[1][r], rgb[2][r]),
                       mix.bias[ch]);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float acc = __fmul_rn(kD[u * 8], x[0]);
#pragma unroll
      for (int j = 1; j < 8; ++j) acc = __fmaf_rn(kD[u * 8 + j], x[j], acc);
      cross[cross_at(ch, u, k, b)] = acc;
    }
  }
}

// As row u, thread (b, u): row u of channel ch's t, row pass of dct2d:
// c[u][v] = sum_k t[u][k] D[v][k].
__device__ __forceinline__ void row_pass(const float* __restrict__ cross, int ch, int u, int b,
                                         float (&c)[8]) {
  float t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = cross[cross_at(ch, u, k, b)];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float acc = __fmul_rn(t[0], kD[v * 8]);
#pragma unroll
    for (int k = 1; k < 8; ++k) acc = __fmaf_rn(t[k], kD[v * 8 + k], acc);
    c[v] = acc;
  }
}

// Warp 1 of the encode: the tile's records, a 512-byte group a store.
__device__ __forceinline__ void store_records(uint8_t* out, const TileGeom& g, unsigned t,
                                              const uint8_t* rec, int lane) {
  const Tile a = tile_at(g, t);
  const int groups = a.nb >> 3;
  if (lane < 3 * groups) {
    const int ch = lane / groups, gi = lane - ch * groups;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], 512;" ::"l"(
                     out + (a.frame * 3 + ch) * g.plane + (a.strip * g.bw + a.bx0 + 8 * gi) * 64),
                 "r"(saddr(rec + (ch * kTileGroups + gi) * kGroupStride))
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Lane 0 of warp 1 of the round trip: the tile's pixel rows as one tensor
// store (columns past W are not written).
__device__ __forceinline__ void store_rows(const CUtensorMap* tout, const TileGeom& g,
                                           unsigned t, const uint8_t* pix) {
  const Tile a = tile_at(g, t);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], "
      "[%5];" ::"l"(tout),
      "r"(8 * a.bx0), "r"((int)(8 * a.strip)), "r"(0), "r"((int)a.frame), "r"(saddr(pix))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/color32.py _enc32_rgb_kernel.
// Bound: memory, 3 bytes read + 3 bytes written per pixel position; the
// matrix-form arithmetic these bytes need sets a floor above it (PERF.md).
// Design: see the head of this file.
template <int R, int V>
__global__ void __launch_bounds__(kTileThreads)
enc32_rgb_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales ql,
                 Scales qc, ColorMix mix, TileGeom g, const __grid_constant__ CUtensorMap tin) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full;
  float* sq = reinterpret_cast<float*>(smem);
  uint8_t* stage = smem + 2 * 64 * 4;
  uint8_t* recs = stage + kTileIn;
  float* cross = reinterpret_cast<float*>(recs + 2 * kTileRec);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = lane & 15, x = 2 * warp + (lane >> 4);  // block; column, then row
  put_scales(sq, ql);
  put_scales(sq + 64, qc);
  tile_prologue(&full);
  if (V == kTensor && threadIdx.x == 0) load_tile(&tin, g, blockIdx.x, stage, &full);
  unsigned phase = 0, half = 0;  // the input's parity; the output buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    if (V == kTensor) wait_full(&full, phase);
    else load_tile_plain(img, g, t, stage);
    mix_columns(stage, cross, mix, b, x);
    if (warp == 1) bulk_wait_read<1>();  // the stores of tile t - 2 grid have read its buffer
    __syncthreads();
    // the columns are read: the CTA's next tile comes in under the rows
    if (V == kTensor && threadIdx.x == 0) load_tile(&tin, g, t + gridDim.x, stage, &full);
    uint8_t* rec = recs + half * kTileRec;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float c[8], q[8];
      row_pass(cross, ch, x, b, c);
      row_scales(sq + (ch == 0 ? 0 : 64), x, q);
      uint8_t* slot = rec + (ch * kTileGroups + (b >> 3)) * kGroupStride + x * 64 + (b & 7);
#pragma unroll
      for (int v = 0; v < 8; ++v) slot[v * 8] = quantize_byte<R>(c[v], q[v]);
    }
    fence_async_shared();
    __syncthreads();
    if (warp == 1) store_records(out, g, t, rec, lane);
    phase ^= 1;
    half ^= 1;
  }
  if (warp == 1) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/color32.py _roundtrip_rgb_kernel.
// Bound: operations, 3 x (16.5 + 3 + 3) FMAs per pixel position against 6
// bytes; the matrix form the identities require sets a floor above it
// (PERF.md).  Design: see the head of this file.  The quantized level never
// leaves registers (clip(rint(z*q)) on [-127, 128], then times the dequant
// scale, color32.py:229-231).  One crossing buffer serves the three
// crossings: a barrier before each write keeps the last one's readers safe.
__global__ void __launch_bounds__(kTileThreads, kRoundtripCtas)
roundtrip32_rgb_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out, Scales ql,
                       Scales qc, Scales qil, Scales qic, ColorMix mix, TileGeom g,
                       const __grid_constant__ CUtensorMap tin,
                       const __grid_constant__ CUtensorMap tout) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full;
  float* sq = reinterpret_cast<float*>(smem);
  uint8_t* stage = smem + 4 * 64 * 4;
  uint8_t* pixs = stage + kTileIn;
  float* cross = reinterpret_cast<float*>(pixs + 2 * kTileIn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = lane & 15, x = 2 * warp + (lane >> 4);  // block; column or row
  put_scales(sq, ql);
  put_scales(sq + 64, qc);
  put_scales(sq + 128, qil);
  put_scales(sq + 192, qic);
  tile_prologue(&full);
  if (threadIdx.x == 0) load_tile(&tin, g, blockIdx.x, stage, &full);
  unsigned phase = 0, half = 0;  // the input's parity; the output buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    wait_full(&full, phase);
    // columns: mix, dct2d's column pass
    mix_columns(stage, cross, mix, b, x);
    if (warp == 1) bulk_wait_read<1>();  // the stores of tile t - 2 grid have read its buffer
    __syncthreads();
    if (threadIdx.x == 0) load_tile(&tin, g, t + gridDim.x, stage, &full);
    // rows: dct2d's row pass, quantize, dequantize (c[u][v] at u = x)
    float c[3][8];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float q[8], qi[8];
      row_pass(cross, ch, x, b, c[ch]);
      row_scales(sq + (ch == 0 ? 0 : 64), x, q);
      row_scales(sq + (ch == 0 ? 128 : 192), x, qi);
#pragma unroll
      for (int v = 0; v < 8; ++v)
        c[ch][v] = __fmul_rn(rint_small(fminf(fmaxf(__fmul_rn(c[ch][v], q[v]), -127.0f), 128.0f)),
                             qi[v]);
    }
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int v = 0; v < 8; ++v) cross[cross_at(ch, x, v, b)] = c[ch][v];
    __syncthreads();
    // columns: idct2d's column pass, t[j][v] = sum_u D[u][j] c[u][v] at v = x
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float cu[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) cu[u] = cross[cross_at(ch, u, x, b)];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float acc = __fmul_rn(kD[r], cu[0]);
#pragma unroll
        for (int u = 1; u < 8; ++u) acc = __fmaf_rn(kD[u * 8 + r], cu[u], acc);
        c[ch][r] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int r = 0; r < 8; ++r) cross[cross_at(ch, r, x, b)] = c[ch][r];
    __syncthreads();
    // rows: idct2d's row pass x[j][k] = sum_v t[j][v] D[v][k] at j = x,
    // bias off, inverse mix, round and clip into the pixel tile
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float tv[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tv[v] = cross[cross_at(ch, x, v, b)];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float acc = __fmul_rn(tv[0], kD[k]);
#pragma unroll
        for (int v = 1; v < 8; ++v) acc = __fmaf_rn(tv[v], kD[v * 8 + k], acc);
        c[ch][k] = __fsub_rn(acc, mix.bias[ch]);
      }
    }
    uint8_t* pix = pixs + half * kTileIn;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      uint32_t px[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        px[k] = rint_bits(fminf(fmaxf(mix3(mix.inv[p * 3], mix.inv[p * 3 + 1], mix.inv[p * 3 + 2],
                                           c[0][k], c[1][k], c[2][k]),
                                      0.0f),
                                255.0f));
      uint2 v;
      v.x = __byte_perm(__byte_perm(px[0], px[1], 0x0040), __byte_perm(px[2], px[3], 0x0040),
                        0x5410);
      v.y = __byte_perm(__byte_perm(px[4], px[5], 0x0040), __byte_perm(px[6], px[7], 0x0040),
                        0x5410);
      *reinterpret_cast<uint2*>(pix + (p * 8 + x) * kTileRow + b * 8) = v;
    }
    fence_async_shared();
    __syncthreads();
    if (warp == 1 && lane == 0) store_rows(&tout, g, t, pix);
    phase ^= 1;
    half ^= 1;
  }
  if (warp == 1 && lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Thread 0: tile t's records (if the launch has it), each channel's span
// of nb*64 bytes a 512-byte group at a time, into `stage` (padded groups,
// kGroupStride apart, channel-major), completing on `bar`.
__device__ __forceinline__ void load_records(const uint8_t* records, const TileGeom& g,
                                             unsigned t, uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const Tile a = tile_at(g, t);
  const int groups = a.nb >> 3;
  arrive_expect(bar, 3 * 512 * groups);
  const uint8_t* src = records + a.frame * 3 * g.plane + (a.strip * g.bw + a.bx0) * 64;
  for (int ch = 0; ch < 3; ++ch)
    for (int gi = 0; gi < groups; ++gi)
      bulk_load(stage + (ch * kTileGroups + gi) * kGroupStride, src + ch * g.plane + gi * 512,
                512, bar);
}

// Replaces simd_dct_tpu/kernels/color32.py _dec32_rgb_kernel.
// Bound: memory, 3 bytes read + 3 bytes written per pixel position; the
// matrix-form arithmetic its bytes need (roundtrip32_rgb == dec32_rgb of
// enc32_rgb, byte for byte) sets a floor above it (PERF.md).  Design: see
// the head of this file.  A short tile's blocks past W compute on stale
// bytes, and the tensor store drops their columns.
__global__ void __launch_bounds__(kDecThreads)
dec32_rgb_kernel(const uint8_t* __restrict__ records, Scales qil, Scales qic, ColorMix mix,
                 TileGeom g, const __grid_constant__ CUtensorMap tout) {
  constexpr int T = kDecBlockThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kDecStages];
  float* sq = reinterpret_cast<float*>(smem);  // transposed: sq[v*8 + u] = qi[u*8 + v]
  uint8_t* pixs = smem + 2 * 64 * 4;  // 128-byte aligned, as the tensor store wants
  uint8_t* stages = pixs + kDecOutBuffers * kTileIn;
  float* cross = reinterpret_cast<float*>(stages + kDecStages * kTileRec);
  // block b; columns, then rows, q + T*h: a warp's two threads of a block
  // take neighbouring ones, as cross_at wants
  const int b = threadIdx.x % kTileBlocks, q = threadIdx.x / kTileBlocks;
  const bool storer = threadIdx.x == (kDecThreads > 32 ? 32 : 0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sq[(i & 7) * 8 + (i >> 3)] = qil.v[i];
      sq[64 + (i & 7) * 8 + (i >> 3)] = qic.v[i];
    }
#pragma unroll
    for (int s = 0; s < kDecStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDecStages; ++s)
      load_records(records, g, blockIdx.x + s * gridDim.x, stages + s * kTileRec, &full[s]);
  }
  unsigned i = 0, half = 0;  // the CTA's tile count; the output buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % kDecStages;
    wait_full(&full[s], (i / kDecStages) & 1);
    const uint8_t* rec = stages + s * kTileRec;
#pragma unroll
    for (int h = 0; h < kDecLines; ++h) {
      // column v of block b, each channel: c[u][v] = (b - 127) * qi exactly,
      // then t[j][v] = sum_u D[u][j] c[u][v]
      const int v = q + T * h;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float qv[8], c[8];
        row_scales(sq + (ch == 0 ? 0 : 64), v, qv);
        const uint8_t* slot = rec + (ch * kTileGroups + (b >> 3)) * kGroupStride + v * 8 + (b & 7);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          c[u] = __fmul_rn(__fsub_rn(__int_as_float(0x4B000000u | slot[u * 64]), kTwo23 + 127.0f),
                           qv[u]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float acc = __fmul_rn(basis(j), c[0]);
#pragma unroll
          for (int u = 1; u < 8; ++u) acc = __fmaf_rn(basis(u * 8 + j), c[u], acc);
          cross[cross_at(ch, j, v, b)] = acc;
        }
      }
    }
    // the store of the tile kDecOutBuffers back has read its buffer
    if (storer) bulk_wait_read<kDecOutBuffers - 1>();
    __syncthreads();
    // the records are read: the tile kDecStages ahead comes into their buffer
    if (threadIdx.x == 0)
      load_records(records, g, t + kDecStages * gridDim.x, stages + s * kTileRec, &full[s]);
    uint8_t* pix = pixs + half * kTileIn;
#pragma unroll
    for (int h = 0; h < kDecLines; ++h) {
      // row j of block b: x[j][k] = sum_v t[j][v] D[v][k], bias off, for the
      // three channels; then the inverse mix, clipped and rounded half to
      // even, packed 8 pixels a plane row
      const int j = q + T * h;
      float y[3][8];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float tv[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) tv[v] = cross[cross_at(ch, j, v, b)];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float acc = __fmul_rn(tv[0], basis(k));
#pragma unroll
          for (int v = 1; v < 8; ++v) acc = __fmaf_rn(tv[v], basis(v * 8 + k), acc);
          y[ch][k] = __fsub_rn(acc, mix.bias[ch]);
        }
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint32_t px[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          px[k] = rint_bits(fminf(fmaxf(mix3(mix.inv[p * 3], mix.inv[p * 3 + 1], mix.inv[p * 3 + 2],
                                             y[0][k], y[1][k], y[2][k]),
                                        0.0f),
                                  255.0f));
        uint2 row;
        row.x = __byte_perm(__byte_perm(px[0], px[1], 0x0040), __byte_perm(px[2], px[3], 0x0040),
                            0x5410);
        row.y = __byte_perm(__byte_perm(px[4], px[5], 0x0040), __byte_perm(px[6], px[7], 0x0040),
                            0x5410);
        *reinterpret_cast<uint2*>(pix + (p * 8 + j) * kTileRow + b * 8) = row;
      }
    }
    fence_async_shared();
    __syncthreads();
    if (storer) store_rows(&tout, g, t, pix);
    half = (half + 1) % kDecOutBuffers;
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The tile geometry of a launch, or false where the plan does not fit it:
// grid, the shared bytes the host computed, and kTensor only on 16-byte
// addresses and plane strides.
bool tile_launch_ok(const void* img, int batch, int h2, int w, long long plane_stride, int grid,
                    int variant, int smem, int want_smem, TileGeom* g) {
  if (!mode32_geometry_ok(batch, h2, w) || grid <= 0 || smem != want_smem ||
      (variant != kPlain && variant != kTensor))
    return false;
  const uintptr_t align = (uintptr_t)img | (uintptr_t)plane_stride;
  if ((align & 7) || (variant == kTensor && (align & 15))) return false;
  const unsigned tps = (w / 8 + kTileBlocks - 1) / kTileBlocks;
  const long long tiles = (long long)batch * (h2 / 8) * tps;
  if (tiles >= (1ll << 31) || grid > tiles) return false;
  g->w = w;
  g->bw = w / 8;
  g->tps = tps;
  g->strips = (unsigned)(h2 / 8);
  g->tiles = (unsigned)tiles;
  g->ps = plane_stride;
  g->plane = (long long)h2 * w;
  return true;
}

template <int R>
const void* enc_fn(int variant) {
  return variant == kTensor ? (const void*)enc32_rgb_kernel<R, kTensor>
                            : (const void*)enc32_rgb_kernel<R, kPlain>;
}

const void* enc_kernel_of(int rounding, int variant) {
  if (variant != kPlain && variant != kTensor) return nullptr;
  switch (rounding) {
    case kRne: return enc_fn<kRne>(variant);
    case kScalar: return enc_fn<kScalar>(variant);
    case kClampFirst: return enc_fn<kClampFirst>(variant);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The launch of a tile kernel: the shared bytes a CTA of it takes and how
// many such CTAs an SM holds, and the SMs of the current card.  kind 0 is
// the encode (`rounding` and `variant` pick its instantiation), 1 the
// round trip, 2 the decode.
int sdct_color_capacity(int kind, int rounding, int variant, int* smem, int* per_sm, int* sms) {
  const void* fn = kind == 0   ? enc_kernel_of(rounding, variant)
                   : kind == 1 ? (const void*)roundtrip32_rgb_kernel
                   : kind == 2 ? (const void*)dec32_rgb_kernel
                               : nullptr;
  if (!fn) return (int)cudaErrorInvalidValue;
  *smem = kind == 2 ? kDecSmem : tile_smem(kind == 1);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(fn, *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn,
                                                      kind == 2 ? kDecThreads : kTileThreads,
                                                      *smem);
  return (int)e;
}

// img: (batch, 3, >= h2 rows, w) u8 planar RGB, planes plane_stride bytes
// apart and frames 3*plane_stride; only the first h2 rows of each plane are
// read.  out: (batch, 3, h2*w) u8 records.  ql, qc: 64 host f32 quant
// scales of the luma and chroma LUTs; mix: 21 host f32, the ColorMix.
// grid, variant (Variant) and smem: the host's launch plan
// (cuda_dct.color_plan); smem must equal what the kernel lays out.
int sdct_enc32_rgb(const void* img, void* out, const float* ql, const float* qc,
                   const float* mix, int batch, int h2, int w, long long plane_stride,
                   int rounding, int grid, int variant, int smem, void* stream) {
  TileGeom g;
  if (!tile_launch_ok(img, batch, h2, w, plane_stride, grid, variant, smem, tile_smem(false),
                      &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = enc_kernel_of(rounding, variant);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tin = {};
  if (variant == kTensor && !planes_map(&tin, img, batch, h2, w, plane_stride, 8))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  Scales sl = to_scales(ql), sc = to_scales(qc);
  ColorMix m = to_mix(mix);
  void* args[] = {(void*)&in, (void*)&o, &sl, &sc, &m, &g, &tin};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kTileThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// records: (batch, 3, h2*w) u8 on a 16-byte address.  out: (batch, 3, h2,
// w) u8, 16-byte aligned.  qil, qic: 64 host f32 dequant scales each; mix
// as for sdct_enc32_rgb.  grid and smem: the host's plan.
int sdct_dec32_rgb(const void* records, void* out, const float* qil, const float* qic,
                   const float* mix, int batch, int h2, int w, int grid, int smem,
                   void* stream) {
  TileGeom g;
  if (!tile_launch_ok(records, batch, h2, w, (long long)h2 * w, grid, kTensor, smem, kDecSmem,
                      &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)dec32_rgb_kernel;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tout = {};
  if (!planes_map(&tout, out, batch, h2, w, (long long)h2 * w, 8))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)records;
  Scales sil = to_scales(qil), sic = to_scales(qic);
  ColorMix m = to_mix(mix);
  void* args[] = {(void*)&in, &sil, &sic, &m, &g, &tout};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kDecThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// img as for sdct_enc32_rgb, on 16-byte addresses and plane strides;
// out: (batch, 3, h2, w) u8.  grid and smem: the host's plan.
int sdct_roundtrip32_rgb(const void* img, void* out, const float* ql, const float* qc,
                         const float* qil, const float* qic, const float* mix, int batch,
                         int h2, int w, long long plane_stride, int grid, int smem,
                         void* stream) {
  TileGeom g;
  if (!tile_launch_ok(img, batch, h2, w, plane_stride, grid, kTensor, smem, tile_smem(true),
                      &g))
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)roundtrip32_rgb_kernel;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tin = {}, tout = {};
  if (!planes_map(&tin, img, batch, h2, w, plane_stride, 8) ||
      !planes_map(&tout, out, batch, h2, w, (long long)h2 * w, 8))
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)img;
  uint8_t* o = (uint8_t*)out;
  Scales sl = to_scales(ql), sc = to_scales(qc), sil = to_scales(qil), sic = to_scales(qic);
  ColorMix m = to_mix(mix);
  void* args[] = {(void*)&in, (void*)&o, &sl, &sc, &sil, &sic, &m, &g, &tin, &tout};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(kTileThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

}  // extern "C"
