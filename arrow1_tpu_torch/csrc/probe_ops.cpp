// Host side of the six probes, operators of PyTorch's dispatcher:
// torch.ops.a1t.probe_blocked_1d(x), probe_blocked_2d(x),
// probe_dma_matmul(x), probe_cumsum_1d(x), probe_smem_output(x) and
// probe_dma_in_when(x), and of probe_empty(x), which takes the same path
// to an empty kernel. Each checks its input (the messages are the ones
// kernels/probes.py:run_probe documents), allocates the output, takes the
// current stream, launches one kernel (probe_ops.cu), checks the launch,
// and returns.
//
// This is the only translation unit of the port that includes PyTorch's
// headers; kernels/build.py compiles it with probe_ops.cu into one library
// and loads it with torch.ops.load_library.

#include <cstdint>
#include <sstream>
#include <string>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

extern "C" {
int a1t_probe_ops_sum(const int* x, int64_t n, int* o, void* stream);
int a1t_probe_ops_cumsum(const int* x, int64_t n, int* o, void* stream);
int a1t_probe_ops_double(const int* x, int64_t n, int* o, void* stream);
int a1t_probe_ops_dma_matmul(const int* x, int64_t rows, int* o,
                             void* stream);
int a1t_probe_ops_dma_in_when(const int* x, int64_t rows, int* o,
                              void* stream);
int a1t_probe_ops_empty(void* stream);
}

namespace {

constexpr int64_t kRows = 8;     // a tile is [kRows, kLanes] int32
constexpr int64_t kLanes = 128;
constexpr int64_t kBlock = 1024;   // blocked-1d's block

// x.shape as Python prints a tuple, for messages equal to run_probe's
std::string shape_text(const at::Tensor& x) {
  std::ostringstream s;
  s << "(";
  for (int64_t d = 0; d < x.dim(); ++d) {
    s << (d ? ", " : "") << x.size(d);
  }
  s << (x.dim() == 1 ? ",)" : ")");
  return s.str();
}

// run_probe's checks, in its order: dtype, shape (``shape_ok``), device.
// ``shape_message()`` is called only when the shape is refused: a call
// that passes builds no string.
template <typename Message>
void check_input(const at::Tensor& x, const char* name, bool shape_ok,
                 const Message& shape_message) {
  TORCH_CHECK_TYPE(x.scalar_type() == at::kInt, "probe ", name,
                   ": int32 input expected, got ", x.scalar_type());
  TORCH_CHECK_VALUE(shape_ok, "probe ", name, ": ", shape_message());
  TORCH_CHECK_VALUE(x.numel() > 0, "probe ", name, ": empty input");
  TORCH_CHECK_TYPE(x.is_cuda(), "probe ", name, ": no kernel for device ",
                   x.device());
}

void check_launch(int err, const char* name) {
  TORCH_CHECK(err == 0, "probe ", name, ": kernel launch failed: CUDA error ",
              err, " (", cudaGetErrorString(static_cast<cudaError_t>(err)),
              ")");
}

cudaStream_t stream_of(const at::Tensor& x) {
  return c10::cuda::getCurrentCUDAStream(x.get_device()).stream();
}

at::Tensor probe_smem_output(const at::Tensor& x) {
  constexpr const char* kName = "smem-output";
  check_input(x, kName, x.dim() == 1, [] { return "input must be 1-D"; });
  const c10::cuda::CUDAGuard guard(x.device());
  // any 4-byte alignment: the kernel peels the head before its int4 loads
  const at::Tensor xc = x.contiguous();
  at::Tensor out = at::empty({1}, xc.options());
  check_launch(a1t_probe_ops_sum(xc.data_ptr<int>(), xc.numel(),
                                 out.data_ptr<int>(), stream_of(xc)),
               kName);
  return out;
}

at::Tensor probe_cumsum_1d(const at::Tensor& x) {
  constexpr const char* kName = "cumsum-1d";
  check_input(x, kName, x.dim() == 1, [] { return "input must be 1-D"; });
  const c10::cuda::CUDAGuard guard(x.device());
  // any 4-byte alignment: the kernel takes a misaligned head and tail one
  // value at a time
  const at::Tensor xc = x.contiguous();
  at::Tensor out = at::empty_like(xc);
  check_launch(a1t_probe_ops_cumsum(xc.data_ptr<int>(), xc.numel(),
                                    out.data_ptr<int>(), stream_of(xc)),
               kName);
  return out;
}

// x contiguous and 16-byte aligned (a copy if it is not): the kernels
// of the int4 and tile probes load 16 bytes a thread
at::Tensor aligned16(const at::Tensor& x) {
  at::Tensor xc = x.contiguous();
  if (reinterpret_cast<uintptr_t>(xc.data_ptr()) % 16) {
    xc = xc.clone();
  }
  return xc;
}

// 2 * x through the int4 kernel: numel a multiple of kBlock
at::Tensor double_values(const at::Tensor& x, const char* name) {
  const c10::cuda::CUDAGuard guard(x.device());
  const at::Tensor xc = aligned16(x);
  at::Tensor out = at::empty_like(xc);
  check_launch(a1t_probe_ops_double(xc.data_ptr<int>(), xc.numel(),
                                    out.data_ptr<int>(), stream_of(xc)),
               name);
  return out;
}

bool is_tiles(const at::Tensor& x) {
  return x.dim() == 2 && x.size(1) == kLanes && x.size(0) % kRows == 0;
}

std::string tiles_message(const at::Tensor& x) {
  return "input must be [8k, " + std::to_string(kLanes) + "], got " +
         shape_text(x);
}

// One launch of a [8k, 128] tile kernel, one block a tile; the kernel
// writes every value of the output.
template <typename Launch>
at::Tensor run_tiles(const at::Tensor& x, const char* name,
                     const Launch& launch) {
  check_input(x, name, is_tiles(x), [&] { return tiles_message(x); });
  const c10::cuda::CUDAGuard guard(x.device());
  const at::Tensor xc = aligned16(x);
  at::Tensor out = at::empty_like(xc);
  check_launch(launch(xc.data_ptr<int>(), xc.size(0), out.data_ptr<int>(),
                      stream_of(xc)),
               name);
  return out;
}

at::Tensor probe_blocked_1d(const at::Tensor& x) {
  constexpr const char* kName = "blocked-1d";
  check_input(x, kName, x.dim() == 1 && x.size(0) % kBlock == 0, [&] {
    return "input must be 1-D of a multiple of " + std::to_string(kBlock) +
           " values, got " + shape_text(x);
  });
  return double_values(x, kName);
}

at::Tensor probe_blocked_2d(const at::Tensor& x) {
  constexpr const char* kName = "blocked-2d";
  check_input(x, kName, is_tiles(x), [&] { return tiles_message(x); });
  return double_values(x, kName);
}

at::Tensor probe_dma_matmul(const at::Tensor& x) {
  return run_tiles(x, "manual-dma-matmul", a1t_probe_ops_dma_matmul);
}

at::Tensor probe_dma_in_when(const at::Tensor& x) {
  return run_tiles(x, "dma-in-when", a1t_probe_ops_dma_in_when);
}

// The operator path of a probe with an empty kernel: the same checks, an
// output allocated like x, the current stream and one launch.
at::Tensor probe_empty(const at::Tensor& x) {
  constexpr const char* kName = "empty";
  check_input(x, kName, true, [] { return ""; });
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty_like(x);
  check_launch(a1t_probe_ops_empty(stream_of(x)), kName);
  return out;
}

}  // namespace

TORCH_LIBRARY(a1t, m) {
  m.def("probe_blocked_1d(Tensor x) -> Tensor", &probe_blocked_1d);
  m.def("probe_blocked_2d(Tensor x) -> Tensor", &probe_blocked_2d);
  m.def("probe_cumsum_1d(Tensor x) -> Tensor", &probe_cumsum_1d);
  m.def("probe_smem_output(Tensor x) -> Tensor", &probe_smem_output);
  m.def("probe_dma_matmul(Tensor x) -> Tensor", &probe_dma_matmul);
  m.def("probe_dma_in_when(Tensor x) -> Tensor", &probe_dma_in_when);
  m.def("probe_empty(Tensor x) -> Tensor", &probe_empty);
}
