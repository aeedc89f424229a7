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

void tse1m_launch_minhash_u32(const uint32_t* items, int n, int s,
                              const uint32_t* a, const uint32_t* b, int h,
                              int n_bands, uint32_t* sig, uint32_t* keys,
                              cudaStream_t stream);
void tse1m_launch_minhash_packed(const uint8_t* payload, int n, int s, int k,
                                 uint32_t offset, const uint32_t* a,
                                 const uint32_t* b, int h, int n_bands,
                                 uint32_t* sig, uint32_t* keys,
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
                                    int* topr_out, cudaStream_t stream);
void tse1m_launch_rans_decode(int n_planes, const uint16_t* const* words,
                              const int* n_words, const uint32_t* const* x0,
                              const uint16_t* const* freqs, int alphabet,
                              int n, int shift_step, uint32_t* out,
                              cudaStream_t stream);

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
                   int64_t n) {
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
                 const torch::Tensor& keys) {
  check(items, at::kInt, "items");
  TORCH_CHECK(items.dim() == 2, "items: [N, S]");
  const int64_t n = items.size(0);
  check_outputs(a, b, sig, keys, n);
  const c10::cuda::CUDAGuard guard(items.device());
  tse1m_launch_minhash_u32(u32<const uint32_t>(items), static_cast<int>(n),
                           static_cast<int>(items.size(1)),
                           u32<const uint32_t>(a), u32<const uint32_t>(b),
                           static_cast<int>(a.size(0)),
                           static_cast<int>(keys.size(1)), u32<uint32_t>(sig),
                           u32<uint32_t>(keys),
                           at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void minhash_packed(const torch::Tensor& payload, int64_t n, int64_t s,
                    int64_t k, int64_t offset, const torch::Tensor& a,
                    const torch::Tensor& b, const torch::Tensor& sig,
                    const torch::Tensor& keys) {
  check(payload, at::kByte, "payload");
  TORCH_CHECK(k >= 1 && k <= 4, "k must be 1..4 bytes per id");
  TORCH_CHECK(payload.numel() >= n * s * k, "payload shorter than N*S*k");
  TORCH_CHECK(offset >= 0 && offset <= 0xFFFFFFFFLL, "offset must be uint32");
  check_outputs(a, b, sig, keys, n);
  const c10::cuda::CUDAGuard guard(payload.device());
  tse1m_launch_minhash_packed(
      payload.data_ptr<uint8_t>(), static_cast<int>(n), static_cast<int>(s),
      static_cast<int>(k), static_cast<uint32_t>(offset),
      u32<const uint32_t>(a), u32<const uint32_t>(b),
      static_cast<int>(a.size(0)), static_cast<int>(keys.size(1)),
      u32<uint32_t>(sig), u32<uint32_t>(keys),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
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
                const torch::Tensor& topc_out, const torch::Tensor& topr_out) {
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
  const c10::cuda::CUDAGuard guard(q.device());
  const cudaError_t err = tse1m_launch_topk_chunk(
      u32<const uint32_t>(q), static_cast<int>(qp), static_cast<int>(h),
      u32<const uint32_t>(s_t), rowids.data_ptr<int32_t>(),
      static_cast<int>(np), topc.data_ptr<int32_t>(),
      topr.data_ptr<int32_t>(), static_cast<int>(k),
      counts.data_ptr<int16_t>(), hist.data_ptr<int32_t>(),
      topc_out.data_ptr<int32_t>(), topr_out.data_ptr<int32_t>(),
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "topk_chunk launch: ",
              cudaGetErrorString(err));
}

void rans_decode(const std::vector<torch::Tensor>& words,
                 const std::vector<torch::Tensor>& x0,
                 const std::vector<torch::Tensor>& freqs, int64_t n,
                 int64_t shift_step, const torch::Tensor& out) {
  const size_t n_planes = words.size();
  TORCH_CHECK(n_planes >= 1 && n_planes <= 4 && x0.size() == n_planes &&
                  freqs.size() == n_planes,
              "need 1..4 planes of (words, x0, freqs)");
  check(out, at::kInt, "out");
  TORCH_CHECK(out.dim() == 1 && out.size(0) == n, "out: [n]");
  TORCH_CHECK(shift_step >= 0 && shift_step * (int64_t)(n_planes - 1) < 32,
              "plane shift out of range");
  const int64_t alphabet = freqs[0].numel();
  TORCH_CHECK(alphabet >= 1 && alphabet <= 4096, "alphabet must be 1..4096");
  std::vector<const uint16_t*> words_p, freqs_p;
  std::vector<const uint32_t*> x0_p;
  std::vector<int> n_words;
  for (size_t p = 0; p < n_planes; ++p) {
    check(words[p], at::kShort, "words");
    check(x0[p], at::kInt, "x0");
    check(freqs[p], at::kShort, "freqs");
    TORCH_CHECK(x0[p].numel() == 32, "x0: [32]");
    TORCH_CHECK(freqs[p].numel() == alphabet, "planes differ in alphabet");
    TORCH_CHECK(words[p].numel() < (int64_t{1} << 31), "too many words");
    TORCH_CHECK(reinterpret_cast<uintptr_t>(words[p].data_ptr()) % 8 == 0,
                "words must be 8-byte aligned");
    words_p.push_back(
        reinterpret_cast<const uint16_t*>(words[p].data_ptr<int16_t>()));
    freqs_p.push_back(
        reinterpret_cast<const uint16_t*>(freqs[p].data_ptr<int16_t>()));
    x0_p.push_back(u32<const uint32_t>(x0[p]));
    n_words.push_back(static_cast<int>(words[p].numel()));
  }
  const c10::cuda::CUDAGuard guard(out.device());
  tse1m_launch_rans_decode(static_cast<int>(n_planes), words_p.data(),
                           n_words.data(), x0_p.data(), freqs_p.data(),
                           static_cast<int>(alphabet), static_cast<int>(n),
                           static_cast<int>(shift_step), u32<uint32_t>(out),
                           at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
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
        "merged with the incoming state");
  m.def("rans_decode", &rans_decode,
        "Interleaved rANS decode of one coded lane, one warp per plane");
}
