// PyTorch binding of csrc/ddc_fm.cu's launcher (built together with it by
// torch.utils.cpp_extension.load in ops/cuda_ddc.py).  The .cu file stays
// free of PyTorch headers so that nvcc compiles it in seconds; this file
// only checks the tensors and passes their pointers and the current stream.

#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

extern "C" int ddc_fm_launch(const float* x, const float* tail, const float* taps,
                             float* audio, float* energy, float* edges,
                             long long L, int n, int M, int threads,
                             float cd, float sd, float scale, cudaStream_t stream);

static void check_f32_cuda(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void ddc_fm(const torch::Tensor& x, const torch::Tensor& tail,
            const torch::Tensor& taps, torch::Tensor& audio,
            torch::Tensor& energy, torch::Tensor& edges, int64_t n, int64_t M,
            int64_t threads, double cd, double sd, double scale) {
  check_f32_cuda(x, "x");
  check_f32_cuda(tail, "tail");
  check_f32_cuda(taps, "taps");
  check_f32_cuda(audio, "audio");
  check_f32_cuda(energy, "energy");
  check_f32_cuda(edges, "edges");
  TORCH_CHECK(x.dim() == 2 && x.size(0) == 2, "x must be (2, L)");
  TORCH_CHECK(tail.numel() == 2 * (n - M), "tail must be (2, n - M)");
  TORCH_CHECK(taps.numel() == 2 * n, "taps must be (2, n)");
  TORCH_CHECK(audio.numel() == x.size(1) / M, "audio must be (L / M,)");
  TORCH_CHECK(edges.numel() == 4, "edges must be (4,)");
  const c10::cuda::CUDAGuard guard(x.device());
  const int err = ddc_fm_launch(
      x.data_ptr<float>(), tail.data_ptr<float>(), taps.data_ptr<float>(),
      audio.data_ptr<float>(), energy.data_ptr<float>(), edges.data_ptr<float>(),
      x.size(1), (int)n, (int)M, (int)threads, (float)cd, (float)sd, (float)scale,
      c10::cuda::getCurrentCUDAStream(x.device().index()).stream());
  TORCH_CHECK(err == 0, "ddc_fm kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("ddc_fm", &ddc_fm, "fused DDC + FM discriminator (csrc/ddc_fm.cu)");
}
