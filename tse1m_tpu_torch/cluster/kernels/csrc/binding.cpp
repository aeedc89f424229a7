// PyTorch binding of the kernels in minhash.cu and rans.cu.  The only source
// that includes torch/extension.h: the kernels' files stay plain CUDA so
// nvcc never parses PyTorch's headers.
//
// Each function takes int32 tensors that carry uint32 bit patterns (int16
// for uint16 words and frequencies, uint8 for the wire payload), with the
// outputs already allocated by the Python wrapper, enqueues one launch on
// PyTorch's current stream, and checks it.

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
  m.def("rans_decode", &rans_decode,
        "Interleaved rANS decode of one coded lane, one warp per plane");
}
