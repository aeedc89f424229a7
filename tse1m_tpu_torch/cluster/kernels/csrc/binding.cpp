// PyTorch binding of the kernels in minhash.cu, cminhash.cu, rans.cu and
// score.cu.  The only source that includes torch/extension.h: the kernels'
// files stay plain CUDA so nvcc never parses PyTorch's headers.
//
// Each function takes int32 tensors that carry uint32 bit patterns (int16
// for uint16 words and frequencies, uint8 for the wire payload; plain int32
// for row ids and top-k state), with the outputs and scratch already
// allocated by the Python wrapper, enqueues its launches on PyTorch's
// current stream, and checks them.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <cstdint>
#include <vector>

cudaError_t tse1m_launch_minhash_u32(const uint32_t* items, int n, int s,
                                     const uint32_t* a, const uint32_t* b,
                                     int h, int n_bands, uint32_t* sig,
                                     uint32_t* keys, int* next_tile,
                                     cudaStream_t stream);
cudaError_t tse1m_launch_minhash_packed(const uint8_t* payload, int n, int s,
                                        int k, uint32_t offset,
                                        const uint32_t* a, const uint32_t* b,
                                        int h, int n_bands, uint32_t* sig,
                                        uint32_t* keys, int* next_tile,
                                        cudaStream_t stream);
void tse1m_launch_cminhash_binmin(const uint32_t* items, int n, int s,
                                  const uint32_t* a0, const uint32_t* b0,
                                  int h, uint32_t* binmin, uint32_t* rowmin,
                                  cudaStream_t stream);
cudaError_t tse1m_launch_topk_chunk(const uint32_t* q, int qp, int h,
                                    const uint32_t* s_t, const int* rowids,
                                    int np, const int* topc_in,
                                    const int* topr_in, int k,
                                    int16_t* counts, int* hist, int* topc_out,
                                    int* topr_out, int passes,
                                    cudaStream_t stream);
cudaError_t tse1m_launch_rans_decode_lanes(
    int n_lanes, const int* n_planes, const uint16_t* const* const* words,
    const int* const* n_words, const uint32_t* const* const* x0,
    const uint16_t* const* const* freqs, const int* alphabet, const int* n,
    const int* byte_planes, uint32_t* const* out, cudaStream_t stream);

namespace {

void check(const torch::Tensor& t, at::ScalarType dtype, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has dtype ", t.scalar_type(),
              ", expected ", dtype);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

template <typename T>
T* u32(const torch::Tensor& t) {
  return reinterpret_cast<T*>(t.data_ptr<int32_t>());
}

void check_outputs(const torch::Tensor& a, const torch::Tensor& b,
                   const torch::Tensor& sig, const torch::Tensor& keys,
                   const torch::Tensor& scratch, int64_t n) {
  check(scratch, at::kInt, "scratch");
  TORCH_CHECK(scratch.numel() >= 1, "scratch: [1]");
  check(a, at::kInt, "a");
  check(b, at::kInt, "b");
  check(sig, at::kInt, "sig");
  check(keys, at::kInt, "keys");
  const int64_t h = a.size(0);
  TORCH_CHECK(a.dim() == 1 && b.dim() == 1 && b.size(0) == h, "a, b: [H]");
  TORCH_CHECK(sig.dim() == 2 && sig.size(0) == n && sig.size(1) == h,
              "sig: [N, H]");
  TORCH_CHECK(keys.dim() == 2 && keys.size(0) == n && keys.size(1) > 0 &&
                  h % keys.size(1) == 0,
              "keys: [N, B] with B dividing H");
}

}  // namespace

void minhash_u32(const torch::Tensor& items, const torch::Tensor& a,
                 const torch::Tensor& b, const torch::Tensor& sig,
                 const torch::Tensor& keys, const torch::Tensor& scratch) {
  check(items, at::kInt, "items");
  TORCH_CHECK(items.dim() == 2, "items: [N, S]");
  const int64_t n = items.size(0);
  check_outputs(a, b, sig, keys, scratch, n);
  const c10::cuda::CUDAGuard guard(items.device());
  const cudaError_t err = tse1m_launch_minhash_u32(
      u32<const uint32_t>(items), static_cast<int>(n),
      static_cast<int>(items.size(1)), u32<const uint32_t>(a),
      u32<const uint32_t>(b), static_cast<int>(a.size(0)),
      static_cast<int>(keys.size(1)), u32<uint32_t>(sig), u32<uint32_t>(keys),
      scratch.data_ptr<int32_t>(), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "minhash_u32 launch: ",
              cudaGetErrorString(err));
}

void minhash_packed(const torch::Tensor& payload, int64_t n, int64_t s,
                    int64_t k, int64_t offset, const torch::Tensor& a,
                    const torch::Tensor& b, const torch::Tensor& sig,
                    const torch::Tensor& keys, const torch::Tensor& scratch) {
  check(payload, at::kByte, "payload");
  TORCH_CHECK(k >= 1 && k <= 4, "k must be 1..4 bytes per id");
  TORCH_CHECK(payload.numel() >= n * s * k, "payload shorter than N*S*k");
  TORCH_CHECK(offset >= 0 && offset <= 0xFFFFFFFFLL, "offset must be uint32");
  check_outputs(a, b, sig, keys, scratch, n);
  const c10::cuda::CUDAGuard guard(payload.device());
  const cudaError_t err = tse1m_launch_minhash_packed(
      payload.data_ptr<uint8_t>(), static_cast<int>(n), static_cast<int>(s),
      static_cast<int>(k), static_cast<uint32_t>(offset),
      u32<const uint32_t>(a), u32<const uint32_t>(b),
      static_cast<int>(a.size(0)), static_cast<int>(keys.size(1)),
      u32<uint32_t>(sig), u32<uint32_t>(keys), scratch.data_ptr<int32_t>(),
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "minhash_packed launch: ",
              cudaGetErrorString(err));
}

void cminhash_binmin(const torch::Tensor& items, const torch::Tensor& a0,
                     const torch::Tensor& b0, const torch::Tensor& binmin,
                     const torch::Tensor& rowmin) {
  check(items, at::kInt, "items");
  check(a0, at::kInt, "a0");
  check(b0, at::kInt, "b0");
  check(binmin, at::kInt, "binmin");
  check(rowmin, at::kInt, "rowmin");
  TORCH_CHECK(items.dim() == 2 && items.size(1) >= 1, "items: [N, S], S >= 1");
  const int64_t n = items.size(0);
  TORCH_CHECK(a0.numel() == 1 && b0.numel() == 1, "a0, b0: [1]");
  TORCH_CHECK(binmin.dim() == 2 && binmin.size(0) == n && binmin.size(1) >= 1,
              "binmin: [N, H]");
  TORCH_CHECK(rowmin.dim() == 1 && rowmin.size(0) == n, "rowmin: [N]");
  const c10::cuda::CUDAGuard guard(items.device());
  tse1m_launch_cminhash_binmin(
      u32<const uint32_t>(items), static_cast<int>(n),
      static_cast<int>(items.size(1)), u32<const uint32_t>(a0),
      u32<const uint32_t>(b0), static_cast<int>(binmin.size(1)),
      u32<uint32_t>(binmin), u32<uint32_t>(rowmin),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void topk_chunk(const torch::Tensor& q, const torch::Tensor& s_t,
                const torch::Tensor& rowids, const torch::Tensor& topc,
                const torch::Tensor& topr, int64_t k,
                const torch::Tensor& counts, const torch::Tensor& hist,
                const torch::Tensor& topc_out, const torch::Tensor& topr_out,
                int64_t passes) {
  check(q, at::kInt, "q");
  check(s_t, at::kInt, "s_t");
  check(rowids, at::kInt, "rowids");
  check(topc, at::kInt, "topc");
  check(topr, at::kInt, "topr");
  check(counts, at::kShort, "counts");
  check(hist, at::kInt, "hist");
  check(topc_out, at::kInt, "topc_out");
  check(topr_out, at::kInt, "topr_out");
  TORCH_CHECK(q.dim() == 2 && q.size(0) >= 1 && q.size(1) >= 1 &&
                  q.size(1) < 32767,
              "q: [Qp, H], 1 <= H < 32767");
  const int64_t qp = q.size(0), h = q.size(1);
  TORCH_CHECK(s_t.dim() == 2 && s_t.size(0) == h, "s_t: [H, Np]");
  const int64_t np = s_t.size(1);
  TORCH_CHECK(rowids.numel() == np, "rowids: [1, Np]");
  TORCH_CHECK(k >= 1 && k <= 128, "k must be 1..128");
  for (const auto* t : {&topc, &topr, &topc_out, &topr_out})
    TORCH_CHECK(t->dim() == 2 && t->size(0) == qp && t->size(1) == 128,
                "state: [Qp, 128]");
  TORCH_CHECK(counts.numel() == qp * np, "counts: [Qp, Np]");
  TORCH_CHECK(hist.numel() == qp * (h + 1), "hist: [Qp, H + 1]");
  TORCH_CHECK(np % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(s_t.data_ptr()) % 16 == 0,
              "s_t: 16-byte aligned, Np a multiple of 4");
  TORCH_CHECK(passes >= 1 && passes <= 3, "passes: 1 count, 2 select, 3");
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaError_t err = tse1m_launch_topk_chunk(
      u32<const uint32_t>(q), static_cast<int>(qp), static_cast<int>(h),
      u32<const uint32_t>(s_t), rowids.data_ptr<int32_t>(),
      static_cast<int>(np), topc.data_ptr<int32_t>(),
      topr.data_ptr<int32_t>(), static_cast<int>(k),
      counts.data_ptr<int16_t>(), hist.data_ptr<int32_t>(),
      topc_out.data_ptr<int32_t>(), topr_out.data_ptr<int32_t>(),
      static_cast<int>(passes), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "topk_chunk launch: ",
              cudaGetErrorString(err));
}

void rans_decode_lanes(const std::vector<std::vector<torch::Tensor>>& words,
                       const std::vector<std::vector<torch::Tensor>>& x0,
                       const std::vector<std::vector<torch::Tensor>>& freqs,
                       const std::vector<int64_t>& n,
                       const std::vector<torch::Tensor>& out) {
  constexpr size_t kMaxLanes = 8, kMaxPlanes = 4;
  const size_t n_lanes = words.size();
  TORCH_CHECK(n_lanes >= 1 && n_lanes <= kMaxLanes, "need 1..8 lanes");
  TORCH_CHECK(x0.size() == n_lanes && freqs.size() == n_lanes &&
                  n.size() == n_lanes && out.size() == n_lanes,
              "lane arguments differ in length");
  const uint16_t* words_p[kMaxLanes][kMaxPlanes] = {};
  const uint32_t* x0_p[kMaxLanes][kMaxPlanes] = {};
  const uint16_t* freqs_p[kMaxLanes][kMaxPlanes] = {};
  int n_words[kMaxLanes][kMaxPlanes] = {};
  const uint16_t* const* words_l[kMaxLanes];
  const uint32_t* const* x0_l[kMaxLanes];
  const uint16_t* const* freqs_l[kMaxLanes];
  const int* n_words_l[kMaxLanes];
  int n_planes[kMaxLanes], alphabet[kMaxLanes], n_i[kMaxLanes],
      byte_i[kMaxLanes];
  uint32_t* out_p[kMaxLanes];
  for (size_t l = 0; l < n_lanes; ++l) {
    const size_t planes = words[l].size();
    TORCH_CHECK(planes >= 1 && planes <= kMaxPlanes &&
                    x0[l].size() == planes && freqs[l].size() == planes,
                "need 1..4 planes of (words, x0, freqs) a lane");
    check(out[l], at::kInt, "out");
    TORCH_CHECK(n[l] >= 1 && out[l].dim() == 1 && out[l].size(0) == n[l],
                "out: [n], n >= 1");
    TORCH_CHECK(out[l].device() == out[0].device(), "lanes on two devices");
    const int64_t a = freqs[l][0].numel();
    TORCH_CHECK(a >= 1 && a <= 4096, "alphabet must be 1..4096");
    TORCH_CHECK(planes == 1 || a <= 256,
                "several planes must be byte planes of <= 256 symbols");
    for (size_t p = 0; p < planes; ++p) {
      check(words[l][p], at::kShort, "words");
      check(x0[l][p], at::kInt, "x0");
      check(freqs[l][p], at::kShort, "freqs");
      TORCH_CHECK(words[l][p].device() == out[l].device() &&
                      x0[l][p].device() == out[l].device() &&
                      freqs[l][p].device() == out[l].device(),
                  "a lane's tensors lie on two devices");
      TORCH_CHECK(x0[l][p].numel() == 32, "x0: [32]");
      TORCH_CHECK(freqs[l][p].numel() == a, "planes differ in alphabet");
      TORCH_CHECK(words[l][p].numel() < (int64_t{1} << 30), "too many words");
      words_p[l][p] =
          reinterpret_cast<const uint16_t*>(words[l][p].data_ptr<int16_t>());
      freqs_p[l][p] =
          reinterpret_cast<const uint16_t*>(freqs[l][p].data_ptr<int16_t>());
      x0_p[l][p] = u32<const uint32_t>(x0[l][p]);
      n_words[l][p] = static_cast<int>(words[l][p].numel());
    }
    words_l[l] = words_p[l];
    x0_l[l] = x0_p[l];
    freqs_l[l] = freqs_p[l];
    n_words_l[l] = n_words[l];
    n_planes[l] = static_cast<int>(planes);
    alphabet[l] = static_cast<int>(a);
    n_i[l] = static_cast<int>(n[l]);
    byte_i[l] = planes > 1 ? 1 : 0;
    out_p[l] = u32<uint32_t>(out[l]);
  }
  const c10::cuda::CUDAGuard guard(out[0].device());
  const cudaError_t err = tse1m_launch_rans_decode_lanes(
      static_cast<int>(n_lanes), n_planes, words_l, n_words_l, x0_l, freqs_l,
      alphabet, n_i, byte_i, out_p, at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "rans_decode_lanes launch: ",
              cudaGetErrorString(err));
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("minhash_u32", &minhash_u32,
        "Fused MinHash + band keys over [N, S] uint32 ids");
  m.def("minhash_packed", &minhash_packed,
        "Fused MinHash + band keys over a k-byte little-endian wire payload");
  m.def("cminhash_binmin", &cminhash_binmin,
        "One-permutation bin minima and row minima over [N, S] uint32 ids");
  m.def("topk_chunk", &topk_chunk,
        "Exact agreement-count top-k of queries over one transposed chunk, "
        "merged with the incoming state (passes: 1 count, 2 select, 3 "
        "both)");
  m.def("rans_decode_lanes", &rans_decode_lanes,
        "Interleaved rANS decode of up to 8 coded lanes in one launch, one "
        "block a lane");
}
