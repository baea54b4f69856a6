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
// Encode: strip tiles of 8 macroblocks (16 rows x 128 columns x 3 planes;
// W % 128 == 0, so a macroblock row is a whole number of tiles), a
// persistent grid walking tiles numbered over (frame, macroblock row, tile
// of the row), 128 threads a CTA.
//   * Thread 0 brings a tile in by one 4-D tensor copy (box 128 columns x
//     16 rows x 3 planes x 1 frame) completing on an mbarrier, and the
//     CTA's next one as soon as this one's columns are read; the plane
//     stride is the tensor map's, so a shard's rows of a larger image go in
//     as they are.
//   * As columns, thread (Y block b of the tile's 32, column pair cp) reads
//     its two columns of the three planes (each byte once, a 2-byte load a
//     row and plane, to f32 without the conversion unit), mixes Y and runs
//     dct2d's column pass on both columns, and mixes Cb and Cr and pools
//     each 2x2 square in registers (bias before the pool, the pool's
//     order): four pooled values of one column of a chroma block each.
//   * Then, after a barrier, each thread runs two Y row passes (rows cp and
//     cp + 4 of its block) and quantizes them, and one chroma column pass
//     (the 16 chroma blocks, 8 threads each, as the 4:4:4 encode); after a
//     second barrier one chroma row pass.  Values cross through shared
//     buffers free of bank conflicts (ycross for Y, swizzled for the column
//     pairs; pooled_at, the block index XORed on the column's bit 2;
//     cross_at for the chroma).  The basis is compiled into the FMAs
//     (tile_common.cuh).
//   * The records are staged in padded groups (kGroupStride) and leave by
//     six 512-byte bulk stores a tile (the two Y spans of block rows 2my
//     and 2my+1, the Cb and the Cr span); the buffer is reused only after
//     cp.async.bulk.wait_group.read.  One input buffer
//     and one record buffer (k420Stages, k420RecBuffers: 26 KB, 8 CTAs an
//     SM) ran 1-3% faster than two of either (PERF.md).
//   * Every product and sum of the mix, the pool, dct2d and the quantizer
//     is kept in its order: the Y segment equals enc32_rgb's channel 0 and
//     the whole stream the thread-per-block form, byte for byte.
// Decode.  The unit is a 16x16 macroblock: 4 Y blocks, 1 Cb block and 1 Cr
// block.  A CUDA block of k420Threads = 192 threads covers kMacro = 32
// consecutive macroblocks, in six warps whose roles are uniform: warps 0-3
// hold Y blocks, warp 0 and 1 the top 8 rows of macroblocks 0-15 and 16-31
// (two neighbouring lanes per macroblock, left and right block), warps 2
// and 3 the bottom 8 rows; warp 4 holds the Cb blocks and warp 5 the Cr
// blocks, a lane per macroblock.  Every thread holds one 64-float block.
// The records come in through shared memory with 16-byte loads;
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

#include "tile_common.cuh"

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

// -- encode: strip tiles of 8 macroblocks -------------------------------------

constexpr int k420TileRow = 128;                     // columns a tile
constexpr int k420TileIn = 3 * 16 * k420TileRow;     // 3 planes x 16 rows
constexpr int k420EncThreads = 128;                  // Y: 4 a block; chroma: 8 a block
constexpr int k420Stages = 1;                        // input tiles in flight
constexpr int k420RecBuffers = 1;                    // record staging buffers
constexpr int k420TileRec = 6 * kGroupStride;        // Y 2 rows x 2 groups, Cb, Cr
constexpr int kYCross = 2 * 64 * 16;                 // f32: 32 Y blocks
constexpr int kChromaCross = 64 * 16;                // f32: 16 chroma blocks
// Shared bytes of a launch: luma and chroma scales, the input tiles, the
// record buffers, the Y crossing, the pooled chroma and the chroma
// crossing.  The host's plan (cuda_dct.color420_smem) computes the same
// and the entry point compares.
constexpr int k420Smem = 2 * 64 * 4 + k420Stages * k420TileIn + k420RecBuffers * k420TileRec +
                         4 * (kYCross + 2 * kChromaCross);

struct Geom420 {
  int bw, mbw;        // 8x8 blocks, macroblocks a row
  unsigned tpr;       // tiles a macroblock row: W / 128
  unsigned rows;      // macroblock rows a frame: H2 / 16
  unsigned tiles;     // of the launch (the host keeps it below 2^31)
  long long y_plane;  // H2*W: the Y segment of a frame's stream
};

struct Tile420 {
  long long frame;
  int my, x;  // macroblock row; tile of the row (macroblocks 8x .. 8x+7)
};

__device__ __forceinline__ Tile420 tile420_at(const Geom420& g, unsigned t) {
  const unsigned fr = t / g.tpr, frame = fr / g.rows;
  Tile420 a;
  a.frame = frame;
  a.my = (int)(fr - frame * g.rows);
  a.x = (int)(t - fr * g.tpr);
  return a;
}

// Thread 0: tile t (if the launch has it) into `stage` by one tensor copy.
__device__ __forceinline__ void load_tile420(const CUtensorMap* tin, const Geom420& g,
                                             unsigned t, uint8_t* stage, uint64_t* bar) {
  if (t >= g.tiles) return;
  const Tile420 a = tile420_at(g, t);
  arrive_expect(bar, k420TileIn);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(stage)),
      "l"(tin), "r"(k420TileRow * a.x), "r"(16 * a.my), "r"(0), "r"((int)a.frame),
      "r"(saddr(bar))
      : "memory");
}

// The Y crossing: t[r][c] of Y block (br, bc), r the row index.  The column
// pass writes columns c in {4i + e, 4i + 2 + e} (a warp's two column
// pairs) at one r; the row pass reads rows r in {2i + h', 2i + 1 + h'} at
// one c.  Lines of 32 floats hold the columns c and c ^ 2 of one r, in
// halves chosen by bit 0 of r ^ (c >> 1): both accesses touch 32 banks.
__device__ __forceinline__ int ycross(int br, int r, int c, int bc) {
  return (((br * 8 + r) * 4 + (((c >> 2) << 1) | (c & 1))) * 2 + ((r ^ (c >> 1)) & 1)) * 16 + bc;
}

// The pooled chroma: value (row j, column k) of chroma block cb' (Cb 0-7,
// Cr 8-15).  The pool writes, at one j, columns 4(bc & 1) + cp of blocks
// bc >> 1; the column pass reads, at one j, columns {2i, 2i+1} of the 16
// blocks.  Bit 3 of the block swaps on k >= 4: both touch 32 banks.
__device__ __forceinline__ int pooled_at(int j, int k, int cb) {
  return (j * 8 + k) * 16 + (cb ^ ((k >> 2) << 3));
}

// Lanes 0-5 of warp 1: the tile's six record groups, one bulk store each.
__device__ __forceinline__ void store420(uint8_t* out, const Geom420& g, unsigned t,
                                         const uint8_t* rec, int lane) {
  if (lane < 6) {
    const Tile420 a = tile420_at(g, t);
    uint8_t* frame = out + a.frame * 3 * (g.y_plane >> 1);
    uint8_t* dst;
    if (lane < 4) {  // Y block row 2my + (lane >> 1), group lane & 1
      dst = frame + ((2LL * a.my + (lane >> 1)) * g.bw + 16 * a.x + 8 * (lane & 1)) * 64;
    } else {  // Cb, then Cr
      dst = frame + g.y_plane + (lane - 4) * (g.y_plane >> 2) +
            ((long long)a.my * g.mbw + 8 * a.x) * 64;
    }
    bulk_store(dst, rec + lane * kGroupStride, 512);
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Replaces simd_dct_tpu/kernels/color420.py _enc420_kernel.
// Bound: memory, 3 bytes read and 1.5 written per pixel position; the
// matrix-form arithmetic its bytes need (the Y segment == enc32_rgb's
// channel 0) sets a floor above it (PERF.md).  Design: see the head of this
// file.
template <int R>
__global__ void __launch_bounds__(k420EncThreads)
enc420_rgb_kernel(uint8_t* __restrict__ out, Scales ql, Scales qc, ColorMix mix, Geom420 g,
                  const __grid_constant__ CUtensorMap tin) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[k420Stages];
  float* sq = reinterpret_cast<float*>(smem);
  uint8_t* stages = smem + 2 * 64 * 4;
  uint8_t* recs = stages + k420Stages * k420TileIn;
  float* yx = reinterpret_cast<float*>(recs + k420RecBuffers * k420TileRec);
  float* pooled = yx + kYCross;
  float* cx = pooled + kChromaCross;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // columns and Y rows: Y block (br, bc), column pair cp
  const int br = warp >> 1, bc = lane & 15, cp = 2 * (warp & 1) + (lane >> 4);
  // chroma: block cb (Cb 0-7, Cr 8-15), column, then row, x
  const int cb = lane & 15, x = 2 * warp + (lane >> 4);
  put_scales(sq, ql);
  put_scales(sq + 64, qc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < k420Stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < k420Stages; ++s)
      load_tile420(&tin, g, blockIdx.x + s * gridDim.x, stages + s * k420TileIn, &full[s]);
  }
  unsigned i = 0, half = 0;  // the CTA's tile count; the record buffer
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % k420Stages;
    wait_full(&full[s], (i / k420Stages) & 1);
    {
      // columns 8bc + 2cp + e of rows 8br .. 8br + 7: Y, and the pooled Cb
      // and Cr of the 2x2 squares (rows 2rp, 2rp + 1)
      const uint8_t* px = stages + s * k420TileIn + 8 * br * k420TileRow + 8 * bc + 2 * cp;
      float y[2][8];
#pragma unroll
      for (int rp = 0; rp < 4; ++rp) {
        float a[2][2][2];  // chroma, row of the pair, column
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 2 * rp + hh;
          uint32_t w3[3];
#pragma unroll
          for (int p = 0; p < 3; ++p)
            w3[p] = *reinterpret_cast<const uint16_t*>(px + (p * 16 + r) * k420TileRow);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float rr = byte_f32(w3[0], e), gg = byte_f32(w3[1], e), bb = byte_f32(w3[2], e);
            y[e][r] = __fadd_rn(mix3(mix.fwd[0], mix.fwd[1], mix.fwd[2], rr, gg, bb), mix.bias[0]);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              a[c][hh][e] = __fadd_rn(
                  mix3(mix.fwd[3 * c + 3], mix.fwd[3 * c + 4], mix.fwd[3 * c + 5], rr, gg, bb),
                  mix.bias[c + 1]);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
          pooled[pooled_at(4 * br + rp, 4 * (bc & 1) + cp, 8 * c + (bc >> 1))] = __fmul_rn(
              __fadd_rn(__fadd_rn(a[c][0][0], a[c][0][1]), __fadd_rn(a[c][1][0], a[c][1][1])),
              0.25f);
      }
      // dct2d's column pass of both Y columns: t[u][k] = sum_j D[u][j] x[j][k]
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float acc = __fmul_rn(basis(u * 8), y[e][0]);
#pragma unroll
          for (int j = 1; j < 8; ++j) acc = __fmaf_rn(basis(u * 8 + j), y[e][j], acc);
          yx[ycross(br, u, 2 * cp + e, bc)] = acc;
        }
    }
    // the stores of the tile k420RecBuffers back have read its buffer
    if (warp == 1) bulk_wait_read<k420RecBuffers - 1>();
    __syncthreads();
    // the input is read: the tile k420Stages ahead comes into its buffer
    if (threadIdx.x == 0)
      load_tile420(&tin, g, t + k420Stages * gridDim.x, stages + s * k420TileIn, &full[s]);
    uint8_t* rec = recs + half * k420TileRec;
    // Y rows u = cp + 4h: c[u][v] = sum_k t[u][k] D[v][k], quantized
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = cp + 4 * h;
      float tr[8], q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) tr[k] = yx[ycross(br, u, k, bc)];
      row_scales(sq, u, q);
      uint8_t* slot = rec + (2 * br + (bc >> 3)) * kGroupStride + u * 64 + (bc & 7);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = __fmul_rn(tr[0], basis(v * 8));
#pragma unroll
        for (int k = 1; k < 8; ++k) acc = __fmaf_rn(tr[k], basis(v * 8 + k), acc);
        slot[v * 8] = quantize_byte<R>(acc, q[v]);
      }
    }
    // chroma column x of block cb: t[u][x] = sum_j D[u][j] x[j][x]
    {
      float xc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) xc[j] = pooled[pooled_at(j, x, cb)];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float acc = __fmul_rn(basis(u * 8), xc[0]);
#pragma unroll
        for (int j = 1; j < 8; ++j) acc = __fmaf_rn(basis(u * 8 + j), xc[j], acc);
        cx[cross_at(0, u, x, cb)] = acc;
      }
    }
    __syncthreads();
    // chroma row u = x of block cb, quantized with the chroma scales
    {
      float tr[8], q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) tr[k] = cx[cross_at(0, x, k, cb)];
      row_scales(sq + 64, x, q);
      uint8_t* slot = rec + (4 + (cb >> 3)) * kGroupStride + x * 64 + (cb & 7);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = __fmul_rn(tr[0], basis(v * 8));
#pragma unroll
        for (int k = 1; k < 8; ++k) acc = __fmaf_rn(tr[k], basis(v * 8 + k), acc);
        slot[v * 8] = quantize_byte<R>(acc, q[v]);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (warp == 1) store420(out, g, t, rec, lane);
    half = (half + 1) % k420RecBuffers;
  }
  if (warp == 1) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

const void* enc420_kernel_of(int rounding) {
  switch (rounding) {
    case kRne: return (const void*)enc420_rgb_kernel<kRne>;
    case kScalar: return (const void*)enc420_rgb_kernel<kScalar>;
    case kClampFirst: return (const void*)enc420_rgb_kernel<kClampFirst>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The launch of the encode: the shared bytes a CTA takes and how many such
// CTAs an SM holds (the `rounding` instantiation), and the SMs of the
// current card.
int sdct_color420_capacity(int rounding, int* smem, int* per_sm, int* sms) {
  const void* fn = enc420_kernel_of(rounding);
  if (!fn) return (int)cudaErrorInvalidValue;
  *smem = k420Smem;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(fn, *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, k420EncThreads, *smem);
  return (int)e;
}

// img: (batch, 3, >= h2 rows, w) u8 planar RGB, planes plane_stride bytes
// apart and frames 3*plane_stride (16-byte address and plane stride); only
// the first h2 rows of each plane are read.  out: (batch, 1.5*h2*w) u8
// streams, 16-byte aligned.  ql, qc: 64 host f32 quant scales of the luma
// and chroma LUTs; mix: 21 host f32, the ColorMix.  grid and smem: the
// host's launch plan (cuda_dct.color420_plan); smem must equal what the
// kernel lays out.
int sdct_enc420_rgb(const void* img, void* out, const float* ql, const float* qc,
                    const float* mix, int batch, int h2, int w, long long plane_stride,
                    int rounding, int grid, int smem, void* stream) {
  if (!geometry420_ok(batch, h2, w) || grid <= 0 || smem != k420Smem ||
      (((uintptr_t)img | (uintptr_t)plane_stride | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)batch * (h2 / 16) * (w / k420TileRow);
  if (tiles >= (1ll << 31) || grid > tiles) return (int)cudaErrorInvalidValue;
  const void* fn = enc420_kernel_of(rounding);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tin = {};
  if (!planes_map(&tin, img, batch, h2, w, plane_stride, 16)) return (int)cudaErrorInvalidValue;
  Geom420 g;
  g.bw = w / 8;
  g.mbw = w / 16;
  g.tpr = (unsigned)(w / k420TileRow);
  g.rows = (unsigned)(h2 / 16);
  g.tiles = (unsigned)tiles;
  g.y_plane = (long long)h2 * w;
  uint8_t* o = (uint8_t*)out;
  Scales sl = to_scales(ql), sc = to_scales(qc);
  ColorMix m = to_mix(mix);
  void* args[] = {(void*)&o, &sl, &sc, &m, &g, &tin};
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(k420EncThreads), args, (size_t)smem,
                               (cudaStream_t)stream);
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
