// The plane all-gather of the dist path and its one-card preflight, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
// simd_dct_tpu_torch/kernels/_build.py and wrapped by
// simd_dct_tpu_torch/dist/collectives.py.
//
// ring_gather_kernel replaces simd_dct_tpu/dist/collectives.py:215 (the
// kernel of gather_planes_remote): each of the n ranks of a ring holds an
// (outer, chunk, inner) u8 segment; every rank ends with the (outer,
// n*chunk, inner) planes, rank k's segment in slot k.  The TPU kernel
// forwards the newest slot n-1 times around the ICI ring by remote DMA.
// The cards of an H100 host are linked all to all (NVSwitch), so this one
// pushes to all: the CTAs of a rank read its segment once and store it into
// slot my_id of its own output and of every peer's, through the peer's
// pointer.  The bytes are the contract, not the route.
//
// selfring_kernel replaces simd_dct_tpu/dist/collectives.py:310 (the kernel
// of remote_dma_selfring_smoke): the same device code on a one-rank ring
// whose peer is the card itself, on one CTA -- the barrier signalled twice
// to itself and waited for, the segment loaded into shared memory, stored
// into slot 0 and, through the peer-pointer path, into slot `chunk` of the
// same buffer, its arrival signalled and waited for.
//
// Bound: bytes.  A call reads each segment once and writes it n times (the
// 4K dual view's stereo segments over four ranks: 15.7 MB in, 62.9 MB out,
// 23.5 us at 3.35 TB/s); there is no arithmetic.
//
// The copy.  A segment is cut into tiles: as many whole rows as fit in
// kMaxTile (16 KB), or, for a longer row, the row cut into the fewest
// pieces of at most kMaxTile bytes, rounded up to 16, the last piece taking
// what is left (a 4K row of 61,440 bytes: four tiles of 15,360).  A tile is
// contiguous in the source, so one bulk load (the TMA's
// cp.async.bulk...mbarrier::complete_tx) brings it into shared memory; each
// of its rows then leaves in one bulk store (cp.async.bulk.global.shared
// ::cta.bulk_group) per replica.  Thread 0 of a CTA walks its tiles (tile
// blockIdx.x, then every gridDim.x-th) through a ring of `stages` (2 to 4)
// shared buffers: the first `stages` loads are issued at once, before the
// barrier; after a tile's stores are committed, the buffer of the tile
// before is refilled as soon as its stores have read it out
// (wait_group.read 1).  No register
// holds a byte and no index is computed per byte.  The host gives each rank
// one CTA per 32 KB of its segment, at most two CTAs per SM for the whole
// launch (the card's ranks share them) and never more than a cooperative
// launch holds: the 4K segments take 66 CTAs a rank on four ranks of one
// H100, the self-ring's 8 KB one.
//   The design this one replaced had every thread load 16 bytes and store
// them n times: each unit found its row by a 64-bit division, and since a
// store might alias the source, the next load waited for the n stores, so
// few bytes were in flight; and it ran 1,056 CTAs of 256 threads, each
// fencing at system scope and adding to n-1 counters.  It ran at 0.46 of
// the bound, level with four torch.cats that move twice the bytes.
//   Rows that are not 16-byte multiples, or a pointer that is not 16-byte
// aligned, take the kernel's byte variant (kBulk = false; the host picks it
// from the alignment): the same tiles, each walked a row at a time by the
// CTA's 256 threads, a byte each, with no division per byte.
//
// Synchronisation.  Each rank owns, in a flag workspace on its card that is
// allocated once per mesh, one barrier slot for each rank of its ring and
// one arrival counter; its card owns one error word in pinned host memory
// mapped into every card's address space.  The host passes this gather's
// generation (one more than the last on the mesh) and the value the
// arrival counter must reach, so nothing is ever reset.  Comparisons are on
// the signed difference, so generations and counters wrap at 2^32 without
// harm as long as none lags its target by 2^31.
//   * Scope (kSys): when every rank of the launch and every destination are
//     on one card (one card in the mesh; always for the self-ring) the
//     fences, releases, acquires and reductions are at .gpu scope, which
//     orders them as well there; across cards at .sys scope.  The error
//     word is host memory: its store is followed by a system fence, on the
//     error path only.
//   * Barrier: CTA 0 of a rank stores the generation into its slot of every
//     rank it will store into (release); every CTA waits until each peer's
//     slot of its own rank holds this generation or a later one (acquire).
//     A rank's kernel running means the work queued before it on that
//     card's stream is done, so no peer writes into an output that the
//     caching allocator handed out while an earlier kernel still used the
//     memory.  A slot only moves forward when its peer enters a gather, so a
//     rank that timed out in an earlier gather never lets a later one pass
//     before every peer has entered it.  A CTA's first loads (of its own
//     segment, which no peer writes) are issued before it waits, so their
//     latency overlaps the barrier's; after the barrier, thread 0 issues a
//     proxy fence (fence.proxy.async.global), so the bulk stores, which are
//     the async proxy's, come after the acquires.
//   * Arrival: the order is (1) cp.async.bulk.wait_group 0 -- every bulk
//     store of the CTA complete, not only read out of shared memory; (2)
//     fence.proxy.async.global -- those writes visible to the generic proxy;
//     (3) __syncthreads and one release reduction of 1 (red.release at the
//     scope) on the arrival counter of each peer the CTA stored into.  The
//     byte variant's stores are its 256 threads', so there thread 0 fences
//     at the scope between (3)'s two steps; the bulk variant's stores are
//     thread 0's own, which its release orders (a fence there cost 0.3 us
//     of the self-ring's 4.9 on an H100).  CTA 0 of a rank returns only once
//     its own counter has reached the target, so the kernel ends after
//     every byte of its output has landed.  A peer can add to it only after
//     it has passed this gather's barrier, so the counter can lag its
//     target (a timed-out gather) but never pass it early.
//   * Every spin is bounded by %globaltimer (nanoseconds), the wait for a
//     bulk load's mbarrier too: when it runs out the CTA writes an error
//     code into the card's error word and returns.
//     The host reads that word without waiting on a stream; a hang becomes
//     an error.
//   * Spinning CTAs need the CTAs they wait for to be resident: one
//     cooperative launch per card covers all that card's ranks
//     (blockIdx.y = local rank), its grid no larger than the card holds.
//
// A store into a peer card's memory is a bulk store too: the peer's memory
// is mapped into this card's address space (peer access), and the TMA
// takes any global address there.
//
// Across processes the same kernel stores into the other processes'
// outputs through CUDA IPC: sdct_ipc_handle exports the allocation that
// holds a pointer (its 64-byte handle and the pointer's offset from the
// allocation's base), sdct_ipc_open maps a peer process's allocation into
// this one (cudaIpcMemLazyEnablePeerAccess; on the same card or another),
// and the host puts the mapped base plus the offset into the descriptor.
// dist/collectives.py orders the ranks on the host: the descriptor holds
// no barrier slots and no arrival counter, so the kernel never waits for
// another process.

#include <cuda.h>  // CUdeviceptr; cuMemGetAddressRange comes from cudaGetDriverEntryPoint
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBulkThreads = 32;   // one warp: the barrier's lanes, thread 0 copies
constexpr int kByteThreads = 256;
constexpr int kMaxTile = 16384;    // bytes of a tile, at most
constexpr int kMaxStages = 4;      // shared buffers of a CTA, at most
constexpr int kMaxDst = 8;         // ranks of a ring (destinations of a rank)
constexpr int kMaxLocal = 8;       // ranks of one launch (on one card)
// int64 words of a rank's descriptor as the host packs it
constexpr int kDescWords = 7 + 4 * kMaxDst;

enum GatherError : unsigned { kErrNone = 0, kErrBarrier = 1, kErrArrival = 2, kErrLoad = 3 };

struct RankDesc {
  const uint8_t* src;              // (outer, row_bytes) contiguous
  unsigned* arr;                   // this rank's arrival counter
  int ndst, nsig, nwait;
  unsigned gen;                    // this gather's generation
  unsigned arr_target;             // the arrival counter's value at the end
  uint8_t* dst[kMaxDst];           // where the segment goes in each output
  unsigned* dst_flag[kMaxDst];     // the owner's arrival counter; null: local
  unsigned* signal[kMaxDst];       // this rank's slot in each peer's barrier
  unsigned* wait[kMaxDst];         // each peer's slot in this rank's barrier
};

struct GatherParams {
  RankDesc rank[kMaxLocal];
  long long outer;                 // rows of a segment
  long long row_bytes;             // bytes of a segment row (chunk * inner)
  long long dst_stride;            // bytes of an output row (n * row_bytes)
  long long tile;                  // bytes of a tile (the last may be short)
  long long rows_per_tile;         // whole rows a tile (1 when pieces > 1)
  long long pieces;                // tiles a row (1 when rows_per_tile > 1)
  long long n_tiles;               // tiles of a segment
  int stages;                      // shared buffers of a CTA (bulk variant)
  unsigned* err;                   // this card's error word (host-mapped)
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kSys>
__device__ __forceinline__ void fence_scope() {
  if constexpr (kSys) asm volatile("fence.acq_rel.sys;" ::: "memory");
  else asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

template <bool kSys>
__device__ __forceinline__ void add_release(unsigned* flag) {
  if constexpr (kSys)
    asm volatile("red.release.sys.add.u32 [%0], %1;" ::"l"(flag), "r"(1u) : "memory");
  else
    asm volatile("red.release.gpu.add.u32 [%0], %1;" ::"l"(flag), "r"(1u) : "memory");
}

template <bool kSys>
__device__ __forceinline__ void store_release(unsigned* flag, unsigned v) {
  if constexpr (kSys)
    asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
  else
    asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

template <bool kSys>
__device__ __forceinline__ unsigned load_acquire(const unsigned* flag) {
  unsigned v;
  if constexpr (kSys)
    asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  else
    asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// Spin until *flag has reached target (wrap-safe); false on timeout.
template <bool kSys>
__device__ bool wait_for(const unsigned* flag, unsigned target, unsigned long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  while ((int)(load_acquire<kSys>(flag) - target) < 0) {
    if (now_ns() - t0 > timeout_ns) return false;
    __nanosleep(64);
  }
  return true;
}

__device__ void report(unsigned* err, unsigned code) {
  *reinterpret_cast<volatile unsigned*>(err) = code;
  __threadfence_system();
}

// Rows [row, row + nrows) of a segment from byte `off` of each, `len` bytes
// a row: contiguous in the source (nrows > 1 only with off 0 and len a row).
struct Tile {
  long long row, off;
  int nrows;
  unsigned len;
};

__device__ __forceinline__ Tile tile_at(const GatherParams& p, long long t) {
  Tile x;
  if (p.pieces > 1) {
    x.row = t / p.pieces;
    x.off = (t - x.row * p.pieces) * p.tile;
    x.nrows = 1;
    const long long left = p.row_bytes - x.off;
    x.len = (unsigned)(left < p.tile ? left : p.tile);
  } else {
    x.row = t * p.rows_per_tile;
    x.off = 0;
    const long long left = p.outer - x.row;
    x.nrows = (int)(left < p.rows_per_tile ? left : p.rows_per_tile);
    x.len = (unsigned)p.row_bytes;
  }
  return x;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// One bulk load of `bytes` into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, unsigned src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete; false on
// timeout.
__device__ bool wait_parity(unsigned bar, unsigned parity, unsigned long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return true;
    if (now_ns() - t0 > timeout_ns) return false;
  }
}

// The bulk copy of one CTA's tiles (tile blockIdx.x, then every
// gridDim.x-th), run by its thread 0 through a ring of p.stages shared
// buffers: each tile one bulk load and, for each of its rows, one bulk
// store per replica.
struct BulkCopy {
  const GatherParams& p;
  const RankDesc& r;
  unsigned base;               // shared address of the buffers
  unsigned long long* full;    // an mbarrier for each buffer
  long long count;             // tiles of this CTA

  __device__ unsigned bar(long long i) const { return smem_addr(&full[i % p.stages]); }

  __device__ unsigned at(long long i) const {
    return base + (unsigned)(i % p.stages) * (unsigned)p.tile;
  }

  __device__ Tile tile(long long i) const {
    return tile_at(p, blockIdx.x + i * (long long)gridDim.x);
  }

  __device__ void load(long long i) const {
    const Tile x = tile(i);
    bulk_load(at(i), r.src + x.row * p.row_bytes + x.off, (unsigned)x.nrows * x.len, bar(i));
  }

  // Before the barrier: the first loads (of the rank's own segment, which
  // no peer writes), so their latency overlaps the barrier's.
  __device__ void begin() const {
    for (int s = 0; s < p.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long i = 0; i < count && i < p.stages; ++i) load(i);
  }

  // After the barrier: the stores, each buffer refilled once its stores
  // have read it out.  Returns with every store complete and visible to
  // the generic proxy; false if a load did not complete within the spin
  // bound.
  __device__ bool finish() const {
    // the async proxy's stores come after the barrier's acquires
    asm volatile("fence.proxy.async.global;" ::: "memory");
    for (long long i = 0; i < count; ++i) {
      if (!wait_parity(bar(i), (unsigned)((i / p.stages) & 1), p.timeout_ns)) return false;
      const Tile x = tile(i);
      for (int k = 0; k < x.nrows; ++k) {
        const long long o = (x.row + k) * p.dst_stride + x.off;
        for (int d = 0; d < r.ndst; ++d) bulk_store(r.dst[d] + o, at(i) + k * x.len, x.len);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // refill the buffer of the tile before, once its stores (the group
      // before this one) have read it out
      if (i >= 1 && i - 1 + p.stages < count) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(i - 1 + p.stages);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    asm volatile("fence.proxy.async.global;" ::: "memory");
    return true;
  }

  // After a barrier that failed: the first loads land before the CTA
  // leaves its shared memory.
  __device__ void drain() const {
    for (long long i = 0; i < count && i < p.stages; ++i) wait_parity(bar(i), 0, p.timeout_ns);
  }
};

__device__ BulkCopy bulk_copy(const GatherParams& p, const RankDesc& r) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  const long long step = gridDim.x;
  return BulkCopy{p, r, smem_addr(buf), full, (p.n_tiles - blockIdx.x + step - 1) / step};
}

// The byte variant: the CTA's tiles a row at a time, a byte a thread.
__device__ void copy_bytes(const GatherParams& p, const RankDesc& r) {
  for (long long t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const Tile x = tile_at(p, t);
    for (int k = 0; k < x.nrows; ++k) {
      const uint8_t* s = r.src + (x.row + k) * p.row_bytes + x.off;
      const long long o = (x.row + k) * p.dst_stride + x.off;
      for (unsigned c = threadIdx.x; c < x.len; c += blockDim.x) {
        const uint8_t v = s[c];
        for (int d = 0; d < r.ndst; ++d) r.dst[d][o + c] = v;
      }
    }
  }
}

// The barrier: false, for every thread of the CTA, if a peer never entered.
template <bool kSys>
__device__ bool enter(const GatherParams& p, const RankDesc& r) {
  if (blockIdx.x == 0 && threadIdx.x < r.nsig) store_release<kSys>(r.signal[threadIdx.x], r.gen);
  const bool entered =
      threadIdx.x >= r.nwait || wait_for<kSys>(r.wait[threadIdx.x], r.gen, p.timeout_ns);
  if (!entered) report(p.err, kErrBarrier);
  return __syncthreads_and(entered);
}

// The arrival, once the CTA's stores are done (`copied`: thread 0's word).
template <bool kBulk, bool kSys>
__device__ void arrive(const GatherParams& p, const RankDesc& r, bool copied) {
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (!copied) {   // no arrival: the peers waiting for it report too
    report(p.err, kErrLoad);
    return;
  }
  // the byte variant's stores are the CTA's 256 threads': a fence at the
  // scope makes them part of thread 0's release (the bulk variant's are
  // thread 0's own, which the release orders by itself)
  if constexpr (!kBulk) fence_scope<kSys>();
  for (int d = 0; d < r.ndst; ++d)
    if (r.dst_flag[d] != nullptr) add_release<kSys>(r.dst_flag[d]);
  // no arrival counter (across processes): the host orders the ranks
  if (blockIdx.x == 0 && r.arr != nullptr && !wait_for<kSys>(r.arr, r.arr_target, p.timeout_ns))
    report(p.err, kErrArrival);
}

// One CTA's share of one rank's gather: barrier, stores, arrival.
template <bool kBulk, bool kSys>
__device__ void gather_rank(const GatherParams& p, const RankDesc& r) {
  if constexpr (kBulk) {
    const BulkCopy bulk = bulk_copy(p, r);
    if (threadIdx.x == 0) bulk.begin();
    if (!enter<kSys>(p, r)) {
      if (threadIdx.x == 0) bulk.drain();
      return;
    }
    arrive<kBulk, kSys>(p, r, threadIdx.x != 0 || bulk.finish());
  } else {
    if (!enter<kSys>(p, r)) return;
    copy_bytes(p, r);
    arrive<kBulk, kSys>(p, r, true);
  }
}

// Replaces simd_dct_tpu/dist/collectives.py:215 (gather_planes_remote).
template <bool kBulk, bool kSys>
__global__ void __launch_bounds__(kBulk ? kBulkThreads : kByteThreads)
ring_gather_kernel(const __grid_constant__ GatherParams p) {
  gather_rank<kBulk, kSys>(p, p.rank[blockIdx.y]);
}

// Replaces simd_dct_tpu/dist/collectives.py:310 (remote_dma_selfring_smoke).
template <bool kBulk>
__global__ void __launch_bounds__(kBulk ? kBulkThreads : kByteThreads)
selfring_kernel(const __grid_constant__ GatherParams p) {
  gather_rank<kBulk, false>(p, p.rank[blockIdx.y]);
}

bool unpack(const long long* desc, int local_ranks, GatherParams* p) {
  for (int k = 0; k < local_ranks; ++k) {
    const long long* w = desc + (long long)k * kDescWords;
    RankDesc& r = p->rank[k];
    r.src = reinterpret_cast<const uint8_t*>(w[0]);
    r.arr = reinterpret_cast<unsigned*>(w[1]);
    r.ndst = (int)w[2];
    r.nsig = (int)w[3];
    r.nwait = (int)w[4];
    r.gen = (unsigned)w[5];
    r.arr_target = (unsigned)w[6];
    if (r.ndst < 1 || r.ndst > kMaxDst || r.nsig < 0 || r.nsig > kMaxDst || r.nwait < 0 ||
        r.nwait > kMaxDst)
      return false;
    for (int d = 0; d < kMaxDst; ++d) {
      r.dst[d] = reinterpret_cast<uint8_t*>(w[7 + d]);
      r.dst_flag[d] = reinterpret_cast<unsigned*>(w[7 + kMaxDst + d]);
      r.signal[d] = reinterpret_cast<unsigned*>(w[7 + 2 * kMaxDst + d]);
      r.wait[d] = reinterpret_cast<unsigned*>(w[7 + 3 * kMaxDst + d]);
    }
  }
  return true;
}

const void* kernel_of(int selfring, int bulk, int sys) {
  if (selfring)
    return bulk ? (const void*)&selfring_kernel<true> : (const void*)&selfring_kernel<false>;
  if (bulk)
    return sys ? (const void*)&ring_gather_kernel<true, true>
               : (const void*)&ring_gather_kernel<true, false>;
  return sys ? (const void*)&ring_gather_kernel<false, true>
             : (const void*)&ring_gather_kernel<false, false>;
}

// The bulk variant's dynamic shared memory may reach kMaxStages tiles,
// above the 48 KB a launch gets without asking.
cudaError_t allow_smem(const void* fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxStages * kMaxTile);
}

int launch(int selfring, const long long* desc, int local_ranks, int blocks, long long outer,
           long long row_bytes, long long dst_stride, int vec, int sys, long long tile,
           int stages, void* err, unsigned long long timeout_ns, void* stream) {
  if (local_ranks < 1 || local_ranks > kMaxLocal || blocks < 1 || outer < 1 || row_bytes < 1 ||
      dst_stride < row_bytes || tile < 1 || tile > kMaxTile ||
      (tile > row_bytes && tile % row_bytes) ||
      (vec && (row_bytes % 16 || dst_stride % 16 || tile % 16 || stages < 2 ||
               stages > kMaxStages)))
    return (int)cudaErrorInvalidValue;
  GatherParams p = {};
  if (!unpack(desc, local_ranks, &p)) return (int)cudaErrorInvalidValue;
  p.outer = outer;
  p.row_bytes = row_bytes;
  p.dst_stride = dst_stride;
  p.tile = tile;
  if (tile >= row_bytes) {
    p.rows_per_tile = tile / row_bytes;
    p.pieces = 1;
    p.n_tiles = (outer + p.rows_per_tile - 1) / p.rows_per_tile;
  } else {
    p.rows_per_tile = 1;
    p.pieces = (row_bytes + tile - 1) / tile;
    p.n_tiles = outer * p.pieces;
  }
  p.stages = vec ? stages : 0;
  p.err = reinterpret_cast<unsigned*>(err);
  p.timeout_ns = timeout_ns;
  void* args[] = {&p};
  const void* fn = kernel_of(selfring, vec, sys);
  size_t smem = 0;
  if (vec) {
    const cudaError_t e = allow_smem(fn);
    if (e != cudaSuccess) return (int)e;
    smem = (size_t)stages * (size_t)tile;
  }
  // cooperative: every CTA of the grid is resident at once, or the launch
  // is refused, so no spinning CTA waits for one that cannot start
  return (int)cudaLaunchCooperativeKernel(fn, dim3(blocks, local_ranks),
                                          dim3(vec ? kBulkThreads : kByteThreads), args, smem,
                                          (cudaStream_t)stream);
}

typedef CUresult (*AddressRange)(CUdeviceptr*, size_t*, CUdeviceptr);

// cuMemGetAddressRange through cudaGetDriverEntryPoint (no link to
// libcuda); null where the CUDA installation has none.
AddressRange address_range() {
  static AddressRange fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuMemGetAddressRange", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuMemGetAddressRange", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (AddressRange)p;
  }
  return fn;
}

}  // namespace

extern "C" {

// The IPC handle (CUDA_IPC_HANDLE_SIZE = 64 bytes, into `handle`) of the
// device allocation that holds `ptr`, and ptr's byte offset from that
// allocation's base (a handle names a whole allocation; the caching
// allocator hands out pieces of larger ones).
int sdct_ipc_handle(const void* ptr, void* handle, long long* offset) {
  const AddressRange range = address_range();
  if (!range) return (int)cudaErrorSymbolNotFound;
  CUdeviceptr base = 0;
  size_t size = 0;
  if (range(&base, &size, (CUdeviceptr)ptr) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidDevicePointer;
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, (void*)base);
  if (e != cudaSuccess) return (int)e;
  memcpy(handle, &h, sizeof h);
  *offset = (long long)((CUdeviceptr)ptr - base);
  return 0;
}

// Map another process's allocation (its handle from sdct_ipc_handle) into
// this process on the current card; its base into *ptr.  A process cannot
// open its own handle, nor one allocation twice.
int sdct_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// Unmap a base that sdct_ipc_open returned (no kernel may still use it).
int sdct_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// desc: local_ranks descriptors of kDescWords int64 each, as
// dist/collectives.py packs them.  blocks: CTAs per rank (the same for
// every rank of a ring, since arrival targets count them).  err: the
// card's error word, from sdct_host_words.  vec: the bulk variant
// (row_bytes, dst_stride, tile and every pointer 16-byte aligned).  sys:
// system scope (ranks or destinations on several cards).  tile: bytes of a
// tile, whole rows or a piece of one row; stages: shared buffers of a CTA
// (bulk variant, 2 to 4).
int sdct_ring_gather(const long long* desc, int local_ranks, int blocks, long long outer,
                     long long row_bytes, long long dst_stride, int vec, int sys, long long tile,
                     int stages, void* err, unsigned long long timeout_ns, void* stream) {
  return launch(0, desc, local_ranks, blocks, outer, row_bytes, dst_stride, vec, sys, tile,
                stages, err, timeout_ns, stream);
}

// The self-ring: one rank, card scope.
int sdct_selfring(const long long* desc, int blocks, long long outer, long long row_bytes,
                  long long dst_stride, int vec, long long tile, int stages, void* err,
                  unsigned long long timeout_ns, void* stream) {
  return launch(1, desc, 1, blocks, outer, row_bytes, dst_stride, vec, 0, tile, stages, err,
                timeout_ns, stream);
}

// n zeroed u32 words of pinned host memory that every card can store into
// through the same pointer (mapped, portable; unified addressing makes the
// host pointer the device pointer), into *words.  Never freed: a kernel
// may report into a word after its host objects are gone.
int sdct_host_words(int n, void** words) {
  void* host = nullptr;
  void* dev = nullptr;
  cudaError_t e = cudaHostAlloc(&host, (size_t)n * 4, cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e == cudaSuccess && dev != host) e = cudaErrorNotSupported;
  if (e != cudaSuccess) {
    cudaFreeHost(host);
    return (int)e;
  }
  for (int i = 0; i < n; ++i) static_cast<volatile unsigned*>(host)[i] = 0;
  *words = host;
  return 0;
}

// For the current card and one variant of the kernels (bulk: at its most
// shared memory), the CTAs an SM holds at once (the least over the
// kernels of the variant) into *per_sm, and the SMs into *sms: a
// cooperative launch takes at most their product.
int sdct_gather_capacity(int bulk, int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const void* fns[] = {kernel_of(0, bulk, 0), kernel_of(0, bulk, 1), kernel_of(1, bulk, 0)};
  const size_t smem = bulk ? (size_t)kMaxStages * kMaxTile : 0;
  int least = 1 << 30;
  for (const void* fn : fns) {
    int n = 0;
    if (bulk) e = allow_smem(fn);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, bulk ? kBulkThreads : kByteThreads,
                                                        smem);
    if (e != cudaSuccess) return (int)e;
    least = n < least ? n : least;
  }
  *per_sm = least;
  return 0;
}

// Let `device` store into `peer`'s memory (a mesh over several cards).
// Already enabled counts as success; a pair that cannot is an error.  The
// calling thread's current card is left as it was.
int sdct_enable_peer(int device, int peer) {
  int can = 0, prev = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
