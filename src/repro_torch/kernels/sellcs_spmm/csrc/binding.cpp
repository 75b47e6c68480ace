// PyTorch binding of the SELL-C-sigma kernels (sellcs_kernels.cu).
// The only source that includes torch/extension.h: the kernels keep a
// plain C interface so nvcc never compiles PyTorch's headers.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <cstdint>

extern "C" void sellcs_launch(int kind, int is_f64, const int32_t* slice_ptr,
                              const int32_t* slice_w, const int32_t* perm,
                              const int32_t* cols, const void* vals,
                              int64_t v_row, int64_t v_col, const void* X,
                              const void* E, void* Y, int32_t n, int32_t C,
                              int32_t k, double p, double eps,
                              cudaStream_t stream);

namespace {

void check_index(const torch::Tensor& t, const torch::Tensor& X,
                 const char* name) {
  TORCH_CHECK(t.device() == X.device(), name, " must be on ", X.device());
  TORCH_CHECK(t.scalar_type() == torch::kInt32, name, " must be int32");
  TORCH_CHECK(t.dim() == 1 && t.is_contiguous(), name,
              " must be a contiguous 1-D tensor");
}

void check_dense(const torch::Tensor& t, const torch::Tensor& X,
                 const char* name) {
  TORCH_CHECK(t.device() == X.device(), name, " must be on ", X.device());
  TORCH_CHECK(t.scalar_type() == X.scalar_type(), name, " must have dtype ",
              X.scalar_type());
  TORCH_CHECK(t.sizes() == X.sizes() && t.is_contiguous(), name,
              " must be contiguous with X's shape");
}

void run(int kind, const torch::Tensor& slice_ptr,
         const torch::Tensor& slice_w, const torch::Tensor& perm,
         const torch::Tensor& cols, const torch::Tensor& vals,
         const torch::Tensor& X, const torch::Tensor& E, torch::Tensor& Y,
         int64_t C, double p, double eps) {
  TORCH_CHECK(X.is_cuda(), "X must be a CUDA tensor");
  TORCH_CHECK(X.scalar_type() == torch::kFloat32 ||
                  X.scalar_type() == torch::kFloat64,
              "X must be float32 or float64");
  TORCH_CHECK(X.dim() == 2 && X.is_contiguous(),
              "X must be a contiguous (n, k) tensor");
  check_index(slice_ptr, X, "slice_ptr");
  check_index(slice_w, X, "slice_w");
  check_index(perm, X, "perm");
  check_index(cols, X, "cols");
  check_dense(E, X, "E");
  check_dense(Y, X, "Y");
  const int64_t n = perm.size(0);
  const int64_t k = X.size(1);
  TORCH_CHECK(X.size(0) == n, "X has ", X.size(0), " rows, layout has ", n);
  TORCH_CHECK(vals.device() == X.device() &&
                  vals.scalar_type() == X.scalar_type() && vals.is_contiguous(),
              "vals must be contiguous, on X's device, with X's dtype");
  const bool multi = vals.dim() == 2;
  TORCH_CHECK(vals.size(0) == cols.size(0) && (!multi || vals.size(1) == k),
              "vals must be (slots,) or (slots, k)");
  TORCH_CHECK(n * k < (int64_t(1) << 31) * 256, "multivector too large");
  const c10::cuda::CUDAGuard guard(X.device());
  sellcs_launch(kind, X.scalar_type() == torch::kFloat64 ? 1 : 0,
                slice_ptr.data_ptr<int32_t>(), slice_w.data_ptr<int32_t>(),
                perm.data_ptr<int32_t>(), cols.data_ptr<int32_t>(),
                vals.data_ptr(), multi ? k : 1, multi ? 1 : 0, X.data_ptr(),
                E.data_ptr(), Y.data_ptr(), static_cast<int32_t>(n),
                static_cast<int32_t>(C), static_cast<int32_t>(k), p, eps,
                c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("spmm",
        [](torch::Tensor slice_ptr, torch::Tensor slice_w, torch::Tensor perm,
           torch::Tensor cols, torch::Tensor vals, torch::Tensor X,
           torch::Tensor Y, int64_t C) {
          run(0, slice_ptr, slice_w, perm, cols, vals, X, X, Y, C, 0.0, 0.0);
        });
  m.def("plap_apply",
        [](torch::Tensor slice_ptr, torch::Tensor slice_w, torch::Tensor perm,
           torch::Tensor cols, torch::Tensor vals, torch::Tensor X,
           torch::Tensor Y, int64_t C, double p, double eps) {
          run(1, slice_ptr, slice_w, perm, cols, vals, X, X, Y, C, p, eps);
        });
  m.def("plap_hvp",
        [](torch::Tensor slice_ptr, torch::Tensor slice_w, torch::Tensor perm,
           torch::Tensor cols, torch::Tensor vals, torch::Tensor U,
           torch::Tensor E, torch::Tensor Y, int64_t C, double p, double eps) {
          run(2, slice_ptr, slice_w, perm, cols, vals, U, E, Y, C, p, eps);
        });
}
