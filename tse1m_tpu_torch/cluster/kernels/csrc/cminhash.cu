// One-permutation (C-MinHash) bin minima for Hopper (sm_90a).
//
// Replaces tse1m_tpu/cluster/minhash_pallas.py:_cminhash_binmin_kernel
// (_cminhash_binmin_pallas):
//   u[n, s]      = x[n, s] * a0 + b0 (mod 2^32)          (the one permutation)
//   binmin[n, h] = min { u[n, s] : u[n, s] mod H == h }, UMAX where none
//   rowmin[n]    = min_s u[n, s]
//
// What bounds it on an H100 SXM: bytes.  Per id one IMAD, one unsigned
// remainder (about a dozen integer ops), one shared-memory atomic min and
// one min; per row H words out.  At 250,368 rows x 64 ids, H = 128, that is
// 64.1 MB read and 129.2 MB written, 0.058 ms at 3.35 TB/s, while the 16M
// remainders are about 0.01 ms of the integer pipes.  So the design keeps
// the bytes at their floor:
//   - one warp a row: the lanes read the row's ids coalesced (each id is
//     read once), permute them in registers and atomicMin (unsigned) into
//     the row's H bins in shared memory, initialised to UMAX;
//   - the row min is a warp reduction (__reduce_min_sync);
//   - the same warp writes the H bins out as consecutive words.
// The TPU kernel's one-hot compare against a bin iota (Mosaic has no
// scatter) and its XOR-by-2^31 bias (no unsigned vector min) are not
// needed: shared-memory atomics scatter, and uint32 min is native.  The
// sentinel algebra is the TPU kernel's: a bin holding a genuine UMAX and a
// bin never touched are both UMAX.  The kernel masks the ragged last tile
// itself: the host pads nothing.  Densification and the band fold stay
// outside (torch ops), as they stay outside the TPU kernel.
// Simple and right first; rows a block and the remainder are not tuned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

// Shared memory: kRowsPerBlock rows of H bins, one row per warp.
__global__ void __launch_bounds__(kThreads)
cminhash_binmin_kernel(const uint32_t* __restrict__ items, int n, int s,
                       const uint32_t* __restrict__ a0p,
                       const uint32_t* __restrict__ b0p, int h,
                       uint32_t* __restrict__ binmin,
                       uint32_t* __restrict__ rowmin) {
  extern __shared__ uint32_t bins_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  // The ragged last tile: a warp past the end leaves whole (only warp-level
  // synchronisation follows).
  if (row >= n) return;
  uint32_t* bins = bins_smem + warp * h;
  for (int j = lane; j < h; j += 32) bins[j] = 0xFFFFFFFFu;
  __syncwarp();
  const uint32_t a0 = *a0p;
  const uint32_t b0 = *b0p;
  const uint32_t hu = static_cast<uint32_t>(h);
  const uint32_t* x = items + static_cast<size_t>(row) * s;
  uint32_t m = 0xFFFFFFFFu;
  for (int j = lane; j < s; j += 32) {
    const uint32_t u = x[j] * a0 + b0;
    atomicMin(&bins[u % hu], u);
    m = min(m, u);
  }
  m = __reduce_min_sync(0xFFFFFFFFu, m);
  __syncwarp();
  uint32_t* out = binmin + static_cast<size_t>(row) * h;
  for (int j = lane; j < h; j += 32) out[j] = bins[j];
  if (lane == 0) rowmin[row] = m;
}

}  // namespace

// Plain C++ entry point for the binding; enqueues one launch on `stream`
// and returns without synchronising.  The caller checks the launch.
void tse1m_launch_cminhash_binmin(const uint32_t* items, int n, int s,
                                  const uint32_t* a0, const uint32_t* b0,
                                  int h, uint32_t* binmin, uint32_t* rowmin,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * kRowsPerBlock * h;
  if (smem > 48 * 1024) {
    // Above 48 KB only as opted-in dynamic shared memory; a refusal here
    // surfaces through the launch check that follows.
    cudaFuncSetAttribute(cminhash_binmin_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const unsigned grid =
      static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  cminhash_binmin_kernel<<<grid, kThreads, smem, stream>>>(
      items, n, s, a0, b0, h, binmin, rowmin);
}
