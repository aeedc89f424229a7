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
// What bounds it on an H100 SXM: the hash loop is two 32-bit integer ops
// (IMAD + IMNMX) per (row, id, hash).  Each issues at 64 lanes a clock an SM
// (16.7 T/s over 132 SMs at 1.98 GHz), IMAD on the FMA pipe and IMNMX on the
// ALU pipe, which can overlap; at 1M x 64 x 128 that is 8.4e9 of each, about
// 0.5 ms.  The bytes are smaller: ids in (256 MB as uint32, 192 MB as 24-bit
// wire bytes) and signatures plus keys out (576 MB), 0.23-0.25 ms at
// 3.35 TB/s.  So the design keeps the integer pipes busy and the bytes at
// their floor:
//   - a block stages its tile of rows in shared memory once (each id is read
//     from device memory once; wire bytes are combined and the offset added
//     in registers), and the hash loop reads the tile back as 16-byte
//     broadcasts: one LDS.128 feeds four IMAD + IMNMX pairs;
//   - native uint32 wraparound and unsigned min: the TPU kernels' XOR-by-2^31
//     bias (Mosaic has no unsigned vector min) is not needed;
//   - the signature tile stays in shared memory for the band fold, so
//     signatures are written to device memory once and never read back;
//   - the kernel masks the ragged last tile itself: the host pads nothing.
// Simple and right first; the tile shape is not tuned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileRows = 32;
constexpr int kThreads = 128;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kFnvOffset = 2166136261u;

__device__ __forceinline__ uint32_t hash_min4(uint32_t m, const uint4 v,
                                              uint32_t a, uint32_t b) {
  m = min(m, v.x * a + b);
  m = min(m, v.y * a + b);
  m = min(m, v.z * a + b);
  return min(m, v.w * a + b);
}

// kPacked = false: `items` is [n, s] uint32.  kPacked = true: `items` is the
// [n, s * k] byte payload, id = little-endian k bytes + offset (mod 2^32).
// Shared memory: the id tile [kTileRows][s4] (s rounded up to 4, the pad
// columns repeat column 0, which leaves every min unchanged), then the
// signature tile [kTileRows][h].
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
minhash_keys_kernel(const void* __restrict__ items, int n, int s, int k,
                    uint32_t offset, const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int h, int n_bands,
                    uint32_t* __restrict__ sig, uint32_t* __restrict__ keys) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int s4 = (s + 3) & ~3;
  uint32_t* tile = smem;
  uint32_t* sig_tile = smem + kTileRows * s4;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, n - row0);

  // Stage the tile's ids: its rows are one contiguous run of the input.
  const int count = rows * s;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / s;
    uint32_t x;
    if constexpr (kPacked) {
      const uint8_t* p = static_cast<const uint8_t*>(items) +
                         (static_cast<size_t>(row0) * s + e) * k;
      x = 0;
      for (int t = 0; t < k; ++t) x |= static_cast<uint32_t>(p[t]) << (8 * t);
      x += offset;
    } else {
      x = static_cast<const uint32_t*>(
          items)[static_cast<size_t>(row0) * s + e];
    }
    tile[r * s4 + (e - r * s)] = x;
  }
  __syncthreads();
  if (s4 != s) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      for (int c = s; c < s4; ++c) tile[r * s4 + c] = tile[r * s4];
    __syncthreads();
  }

  // One thread per hash function; its (a, b) stay in registers over the tile.
  for (int hh = threadIdx.x; hh < h; hh += blockDim.x) {
    const uint32_t ah = a[hh];
    const uint32_t bh = b[hh];
    for (int r = 0; r < rows; ++r) {
      const uint4* row = reinterpret_cast<const uint4*>(tile + r * s4);
      uint32_t m = 0xFFFFFFFFu;
#pragma unroll 4
      for (int q = 0; q < s4 / 4; ++q) m = hash_min4(m, row[q], ah, bh);
      sig_tile[r * h + hh] = m;
      sig[static_cast<size_t>(row0 + r) * h + hh] = m;
    }
  }
  __syncthreads();

  // Band fold from the resident signature tile.
  const int per_band = h / n_bands;
  for (int t = threadIdx.x; t < rows * n_bands; t += blockDim.x) {
    const int r = t / n_bands;
    const int kb = t - r * n_bands;
    const uint32_t* srow = sig_tile + r * h;
    uint32_t key = kFnvOffset + static_cast<uint32_t>(kb);
    for (int j = 0; j < per_band; ++j)
      key = (key ^ srow[j * n_bands + kb]) * kFnvPrime;
    keys[static_cast<size_t>(row0 + r) * n_bands + kb] = key;
  }
}

template <bool kPacked>
void launch(const void* items, int n, int s, int k, uint32_t offset,
            const uint32_t* a, const uint32_t* b, int h, int n_bands,
            uint32_t* sig, uint32_t* keys, cudaStream_t stream) {
  const int s4 = (s + 3) & ~3;
  const size_t smem = sizeof(uint32_t) * kTileRows * (s4 + h);
  if (smem > 48 * 1024) {
    // Above 48 KB only as opted-in dynamic shared memory; a refusal here
    // surfaces through the launch check that follows.
    cudaFuncSetAttribute(minhash_keys_kernel<kPacked>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const unsigned grid = static_cast<unsigned>((n + kTileRows - 1) / kTileRows);
  minhash_keys_kernel<kPacked><<<grid, kThreads, smem, stream>>>(
      items, n, s, k, offset, a, b, h, n_bands, sig, keys);
}

}  // namespace

// Plain C++ entry points for the binding; each enqueues one launch on
// `stream` and returns without synchronising.  The caller checks the launch.
void tse1m_launch_minhash_u32(const uint32_t* items, int n, int s,
                              const uint32_t* a, const uint32_t* b, int h,
                              int n_bands, uint32_t* sig, uint32_t* keys,
                              cudaStream_t stream) {
  launch<false>(items, n, s, 4, 0u, a, b, h, n_bands, sig, keys, stream);
}

void tse1m_launch_minhash_packed(const uint8_t* payload, int n, int s, int k,
                                 uint32_t offset, const uint32_t* a,
                                 const uint32_t* b, int h, int n_bands,
                                 uint32_t* sig, uint32_t* keys,
                                 cudaStream_t stream) {
  launch<true>(payload, n, s, k, offset, a, b, h, n_bands, sig, keys, stream);
}
