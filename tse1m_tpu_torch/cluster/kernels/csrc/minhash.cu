// Fused MinHash + interleaved FNV band keys for Hopper (sm_90a).
//
// Replaces two TPU kernels with one template over the input reader:
//   - tse1m_tpu/cluster/minhash_pallas.py:_kernel (minhash_and_keys_pallas),
//     which reads [N, S] uint32 ids;
//   - tse1m_tpu/cluster/minhash_pallas.py:_kernel_packed
//     (_minhash_packed_pallas), which reads k little-endian bytes per id
//     straight from the wire payload, plus the chunk's offset.
//
//   sig[n, h] = min_s (x[n, s] * a[h] + b[h]) mod 2^32
//   key[n, k] = FNV_OFFSET + k, then key = (key ^ sig[n, j*B + k]) * FNV_PRIME
//               for j < H/B (interleaved banding, as minhash.band_keys)
//
// What bounds it on an H100 SXM: operations.  Every (row, id, hash) needs
// one IMAD (x * a + b), which issues on the FMA pipe at 64 lanes a clock an
// SM, and a min on the ALU pipe: at 250,368 x 64 x 128 that is 2.05e9 IMADs,
// 0.12 ms over 132 SMs at 1.98 GHz, against 0.04-0.05 ms for the bytes.  So
// the design spends the FMA pipe on those IMADs and keeps it busy:
//   - a thread owns one band's hashes (j * B + band, j < H/B, in register
//     groups of up to 8) over 4 rows: one 16-byte shared load of a row's 4
//     ids feeds 4 x 8 multiply-adds, and the thread carries 32 independent
//     min chains.  The minimum runs as Hopper's three-way min
//     (__vimin3_u32: one ALU instruction for two multiply-adds);
//   - the FNV band fold is sequential in j, so it runs in registers as each
//     group finishes, and signatures go from registers to device memory:
//     no signature tile in shared memory, no fold pass;
//   - every warp runs its own pipeline, with no block barrier after the
//     prologue: it hashes units of 8 rows (16 bands x 2 rows side by side,
//     4 rows a thread), each unit one contiguous run of the input (8 x S x 4
//     bytes, or x k wire bytes) that lane 0 brings into the warp's ring of
//     shared-memory stages with one 1-D bulk copy (cp.async.bulk,
//     completion on an mbarrier) a ring ahead, so copies overlap hashing;
//   - uint32 rows that start on 16-byte boundaries (the main path's) are
//     hashed straight from the stage; otherwise the warp first turns the
//     stage into its id buffer (wire bytes combined and the offset added;
//     rows padded to a multiple of 4 ids by repeating id 0, which leaves
//     every min unchanged, and to a row stride that puts neighbouring rows
//     on different banks).  No warp waits for another, so the warps on an
//     SM drift apart instead of converting in step;
//   - blocks are persistent; a warp takes its units one at a time from a
//     counter (its first two at fixed places), so warps that run faster
//     take more and the last units end close together.
// Bulk copies need 16-byte aligned addresses and sizes: a unit's copy runs
// from the 16-byte floor of its first byte to the ceiling of its last (the
// same granules, so no page is crossed), and the conversion skips the
// lead-in.  A block has 4 warps, or 2 or 1 where S is so wide that 4 warps'
// stages do not fit in shared memory (minhash_warps).  The kernel masks the
// ragged last unit itself.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "sm90_async.cuh"

namespace {

constexpr int kMaxWarps = 4;
constexpr int kRowsPerThread = 4;
constexpr int kHalves = 2;  // rows a warp hashes side by side
constexpr int kUnitRows = kHalves * kRowsPerThread;
constexpr int kGroup = 8;  // hashes a thread keeps in registers at once
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kFnvOffset = 2166136261u;

__host__ __device__ constexpr int align16(long long v) {
  return static_cast<int>((v + 15) & ~15LL);
}

// Words between two rows of an id buffer: S rounded up to 4, plus 4 where
// that is a multiple of 8, so neighbouring rows start on different banks.
__host__ __device__ constexpr int tile_stride(int s) {
  return ((s + 3) & ~3) + (((s + 3) & ~3) % 8 == 0 ? 4 : 0);
}

// One ring stage: a unit's bytes from the 16-byte floor of the first.
__host__ __device__ constexpr int stage_bytes(int s, int e) {
  return align16(static_cast<long long>(kUnitRows) * s * e + 15);
}

// A warp's shared memory: per stage an mbarrier and its unit number (16
// bytes), the stages, the id buffer.  e = bytes an id in device memory.
__host__ __device__ constexpr long long warp_smem(int s, int e) {
  return kStages * (16LL + stage_bytes(s, e)) +
         4LL * kUnitRows * tile_stride(s);
}

// A block's dynamic shared memory: a and b, then each warp's.
__host__ __device__ constexpr long long minhash_smem(int s, int h, int e,
                                                     int warps) {
  return align16(8LL * h) + warps * warp_smem(s, e);
}

// Warps a block: 4, or the most of 2, 1 that fit; 0 if none does.
__host__ __device__ constexpr int minhash_warps(int s, int h, int e) {
  for (int w = kMaxWarps; w >= 1; w /= 2)
    if (minhash_smem(s, h, e, w) <= kMaxSmem) return w;
  return 0;
}

__device__ __forceinline__ uint32_t hash_min4(uint32_t m, const uint4 v,
                                              uint32_t a, uint32_t b) {
  m = __vimin3_u32(m, v.x * a + b, v.y * a + b);
  return __vimin3_u32(m, v.z * a + b, v.w * a + b);
}

// The hashes j0 * B + band .. (j0 + G - 1) * B + band of rows half + 2i
// (i < 4) of the unit: their signatures stored, their values folded into
// the rows' band keys.
template <int G>
__device__ __forceinline__ void band_group(
    const uint32_t* __restrict__ ids, int stride, int q4, int half,
    const uint32_t* __restrict__ ab, int h, int hash0, int n_bands,
    uint32_t (&key)[kRowsPerThread], uint32_t* __restrict__ sig,
    long long row0, int rows) {
  uint32_t av[G], bv[G];
#pragma unroll
  for (int jj = 0; jj < G; ++jj) {
    av[jj] = ab[hash0 + jj * n_bands];
    bv[jj] = ab[h + hash0 + jj * n_bands];
  }
  uint32_t m[kRowsPerThread][G];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int jj = 0; jj < G; ++jj) m[i][jj] = 0xFFFFFFFFu;
  const uint4* t4 = reinterpret_cast<const uint4*>(ids);
  const int st4 = stride / 4;
#pragma unroll 2
  for (int q = 0; q < q4; ++q) {
    uint4 v[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      v[i] = t4[(half + i * kHalves) * st4 + q];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
        m[i][jj] = hash_min4(m[i][jj], v[i], av[jj], bv[jj]);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = half + i * kHalves;
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
      key[i] = (key[i] ^ m[i][jj]) * kFnvPrime;
    if (r < rows) {
      uint32_t* out = sig + (row0 + r) * h + hash0;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) out[jj * n_bands] = m[i][jj];
    }
  }
}

// Four consecutive ids from the K little-endian words that hold them
// (K bytes an id), plus the offset.
template <int K>
__device__ __forceinline__ uint4 ids4(const uint32_t* w, uint32_t offset) {
  uint32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    constexpr int kBits = 8 * K;
    const int wi = kBits * j / 32;
    const int sh = kBits * j % 32;
    uint32_t v = sh + kBits <= 32 ? w[wi] >> sh
                                  : __funnelshift_r(w[wi], w[wi + 1], sh);
    if (K < 4) v &= (1u << kBits) - 1u;
    x[j] = v + offset;
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// Stage -> id buffer, by one warp, where S is a multiple of 4 and every row
// starts on a 4-byte boundary: a lane turns K words into 4 ids and stores
// them as one 16-byte store.  Rows past the ragged end repeat the last.
template <int K>
__device__ __forceinline__ void convert_words(
    const unsigned char* __restrict__ raw, uint32_t* __restrict__ ids, int s,
    int stride, int rows, uint32_t offset, int lane) {
  const uint32_t* __restrict__ rw = reinterpret_cast<const uint32_t*>(raw);
  const int q4 = s / 4;
#pragma unroll 4
  for (int e = lane; e < kUnitRows * q4; e += 32) {
    const int r = e / q4;
    const int g = e - r * q4;
    const uint32_t* w = rw + (min(r, rows - 1) * q4 + g) * K;
    uint32_t v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = w[i];
    *reinterpret_cast<uint4*>(ids + r * stride + 4 * g) = ids4<K>(v, offset);
  }
}

// Copy rows row0 .. row0 + rows - 1 into `stage`.
__device__ __forceinline__ void load_rows(const unsigned char* items, int s,
                                          int e, long long row0, int rows,
                                          unsigned char* stage,
                                          uint64_t* bar) {
  const long long row_bytes = static_cast<long long>(s) * e;
  const uintptr_t beg = reinterpret_cast<uintptr_t>(items) + row0 * row_bytes;
  const uintptr_t end = beg + rows * row_bytes;
  const uintptr_t lo = beg & ~uintptr_t{15};
  const uint32_t bytes =
      static_cast<uint32_t>(((end + 15) & ~uintptr_t{15}) - lo);
  if (bytes)
    bulk_load(stage, reinterpret_cast<const void*>(lo), bytes, bar);
  else
    bar_arrive(bar);  // S = 0: nothing to copy
}

// kPacked = false: `items` is [n, s] uint32.  kPacked = true: `items` is the
// [n, s * k] byte payload, id = little-endian k bytes + offset (mod 2^32).
// `next_unit` is zero at launch.
template <bool kPacked>
__global__ void __launch_bounds__(kMaxWarps * 32, 4)
minhash_keys_kernel(const unsigned char* __restrict__ items, int n, int s,
                    int k, uint32_t offset, const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int h, int n_bands,
                    uint32_t* __restrict__ sig, uint32_t* __restrict__ keys,
                    int* __restrict__ next_unit) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = kPacked ? k : 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int stride = tile_stride(s);
  const int s4 = (s + 3) & ~3;
  const int sb = stage_bytes(s, e);
  uint32_t* ab = reinterpret_cast<uint32_t*>(smem);
  unsigned char* mine = smem + align16(8LL * h) + warp * warp_smem(s, e);
  uint64_t* full = reinterpret_cast<uint64_t*>(mine);
  int* unit_of = reinterpret_cast<int*>(full + kStages);
  unsigned char* ring = mine + 16 * kStages;
  uint32_t* ids = reinterpret_cast<uint32_t*>(ring + kStages * sb);
  const int n_units = (n + kUnitRows - 1) / kUnitRows;
  const int n_warps = gridDim.x * warps;

  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    ab[i] = a[i];
    ab[h + i] = b[i];
  }
  // Lane 0 walks the warp's units: units g and g + n_warps first (g =
  // blockIdx.x * warps + warp), then units from the counter (which hands
  // out 2 * n_warps on), each asked for at the fill before the one that
  // takes it: a fill later, so its answer is not waited for, and no
  // sooner, so a warp holds at most one unit it has not started when the
  // counter runs out.  It fills a stage with the unit's number (-1 past
  // the last, a plain arrival then) and bytes.
  int unit = blockIdx.x * warps + warp, fills = 0;
  const auto take = [&]() -> int {
    if (unit >= n_units) return -1;
    const int u = unit;
    unit = fills++ ? 2 * n_warps + atomicAdd(next_unit, 1) : u + n_warps;
    return u;
  };
  const auto fill = [&](int st) {
    const int u = take();
    unit_of[st] = u;
    if (u >= 0) {
      const long long row0 = static_cast<long long>(u) * kUnitRows;
      load_rows(items, s, e, row0,
                min(kUnitRows, n - static_cast<int>(row0)), ring + st * sb,
                &full[st]);
    } else {
      bar_arrive(&full[st]);
    }
  };
  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) bar_init(&full[st], 1);
    bar_init_fence();
    for (int st = 0; st < kStages; ++st) fill(st);
  }
  __syncthreads();

  const int per_band = h / n_bands;
  // Rows of every stage start on 4-byte boundaries and hold whole groups
  // of 4 ids: the word-wise conversion applies.
  const bool words =
      s % 4 == 0 && reinterpret_cast<uintptr_t>(items) % 4 == 0;
  // uint32 rows that start on 16-byte boundaries are hashed straight from
  // the stage.
  const bool direct =
      !kPacked && s % 4 == 0 && reinterpret_cast<uintptr_t>(items) % 16 == 0;
  for (int it = 0;; ++it) {
    const int st = it % kStages;
    bar_wait(&full[st], (it / kStages) & 1);
    const int u = unit_of[st];
    if (u < 0) break;
    const long long row0 = static_cast<long long>(u) * kUnitRows;
    const int rows = min(kUnitRows, n - static_cast<int>(row0));

    // The stage into the id buffer (but for uint32 ids read in place).
    // Where S is not a multiple of 4, id 0 pads each row to one.
    const unsigned char* raw =
        ring + st * sb +
        ((reinterpret_cast<uintptr_t>(items) + row0 * s * e) & 15);
    if (words && !direct) {
      if constexpr (kPacked) {
        switch (k) {
          case 1: convert_words<1>(raw, ids, s, stride, rows, offset, lane);
                  break;
          case 2: convert_words<2>(raw, ids, s, stride, rows, offset, lane);
                  break;
          case 3: convert_words<3>(raw, ids, s, stride, rows, offset, lane);
                  break;
          default:
            convert_words<4>(raw, ids, s, stride, rows, offset, lane);
        }
      } else {
        convert_words<4>(raw, ids, s, stride, rows, 0u, lane);
      }
    } else if (!words) {
      // Any S, any alignment: id by id, byte by byte.
      for (int r = 0; r < kUnitRows; ++r) {
        const int src_row = min(r, rows - 1) * s;
        for (int c = lane; c < s4; c += 32) {
          const int idx = src_row + (c < s ? c : 0);
          uint32_t x;
          if constexpr (kPacked) {
            const unsigned char* p = raw + idx * k;
            x = p[0];
#pragma unroll
            for (int tt = 1; tt < 4; ++tt)
              if (tt < k) x |= static_cast<uint32_t>(p[tt]) << (8 * tt);
            x += offset;
          } else {
            x = reinterpret_cast<const uint32_t*>(raw)[idx];
          }
          ids[r * stride + c] = x;
        }
      }
    }
    __syncwarp();
    // The warp has read the stage: refill it a ring ahead (a stage read in
    // place, after the hashing).
    if (!direct && lane == 0) fill(st);
    const uint32_t* src =
        direct ? reinterpret_cast<const uint32_t*>(raw) : ids;
    const int src_stride = direct ? s : stride;

    for (int w = lane; w < n_bands * kHalves; w += 32) {
      const int band = w % n_bands;
      const int half = w / n_bands;
      uint32_t key[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        key[i] = kFnvOffset + static_cast<uint32_t>(band);
      int j = 0;
      for (; j + kGroup <= per_band; j += kGroup)
        band_group<kGroup>(src, src_stride, s4 / 4, half, ab, h,
                           j * n_bands + band, n_bands, key, sig, row0,
                           rows);
      // The rest of the band in groups of 4, 2, 1 (kGroup = 8).
      if (j + 4 <= per_band) {
        band_group<4>(src, src_stride, s4 / 4, half, ab, h,
                      j * n_bands + band, n_bands, key, sig, row0, rows);
        j += 4;
      }
      if (j + 2 <= per_band) {
        band_group<2>(src, src_stride, s4 / 4, half, ab, h,
                      j * n_bands + band, n_bands, key, sig, row0, rows);
        j += 2;
      }
      if (j < per_band)
        band_group<1>(src, src_stride, s4 / 4, half, ab, h,
                      j * n_bands + band, n_bands, key, sig, row0, rows);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = half + i * kHalves;
        if (r < rows) keys[(row0 + r) * n_bands + band] = key[i];
      }
    }
    // Every lane is done with the id buffer (or the stage read in place)
    // before the next unit's conversion (or copy) overwrites it.
    __syncwarp();
    if (direct && lane == 0) fill(st);
  }
}

template <bool kPacked>
cudaError_t launch(const void* items, int n, int s, int k, uint32_t offset,
                   const uint32_t* a, const uint32_t* b, int h, int n_bands,
                   uint32_t* sig, uint32_t* keys, int* next_unit,
                   cudaStream_t stream) {
  const int e = kPacked ? k : 4;
  const int warps = minhash_warps(s, h, e);
  if (!warps) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(minhash_smem(s, h, e, warps));
  // Persistent blocks: as many as fit on the card at once, at most a unit
  // a warp.  The shared-memory opt-in is the process's, per function: every
  // thread sets it to the most any launch takes, once per device it sees,
  // so no thread's setting undoes another's.  The SM count is read once per
  // device, the blocks an SM fit once per block shape.
  static thread_local int cached_dev = -1, cached_sms, cached_smem = -1,
                          cached_warps, cached_blocks;
  auto kernel = minhash_keys_kernel<kPacked>;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kMaxSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&cached_sms,
                                      cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return err;
    cached_dev = dev;
    cached_smem = -1;
  }
  if (smem != cached_smem || warps != cached_warps) {
    int per_sm;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, warps * 32, smem)) != cudaSuccess)
      return err;
    cached_smem = smem;
    cached_warps = warps;
    cached_blocks = cached_sms * std::max(per_sm, 1);
  }
  const int n_units = (n + kUnitRows - 1) / kUnitRows;
  const int grid = std::min((n_units + warps - 1) / warps, cached_blocks);
  if ((err = cudaMemsetAsync(next_unit, 0, sizeof(int), stream)) !=
      cudaSuccess)
    return err;
  minhash_keys_kernel<kPacked><<<grid, warps * 32, smem, stream>>>(
      static_cast<const unsigned char*>(items), n, s, k, offset, a, b, h,
      n_bands, sig, keys, next_unit);
  return cudaGetLastError();
}

}  // namespace

// Plain C++ entry points for the binding; each enqueues, on `stream`, the
// zeroing of `next_unit` (one int of scratch, the kernel's unit counter)
// and one launch, and returns without synchronising, with the launch's
// error.
cudaError_t tse1m_launch_minhash_u32(const uint32_t* items, int n, int s,
                                     const uint32_t* a, const uint32_t* b,
                                     int h, int n_bands, uint32_t* sig,
                                     uint32_t* keys, int* next_unit,
                                     cudaStream_t stream) {
  return launch<false>(items, n, s, 4, 0u, a, b, h, n_bands, sig, keys,
                       next_unit, stream);
}

cudaError_t tse1m_launch_minhash_packed(const uint8_t* payload, int n, int s,
                                        int k, uint32_t offset,
                                        const uint32_t* a, const uint32_t* b,
                                        int h, int n_bands, uint32_t* sig,
                                        uint32_t* keys, int* next_unit,
                                        cudaStream_t stream) {
  return launch<true>(payload, n, s, k, offset, a, b, h, n_bands, sig, keys,
                      next_unit, stream);
}
