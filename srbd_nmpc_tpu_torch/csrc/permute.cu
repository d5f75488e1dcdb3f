// K2 · lane gather / scatter for the compaction tiers of the speculative solve.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/permute_pallas.py::_gather_kernel
// (take_lanes) and ::_scatter_kernel (set_lanes). Contract: the plain PyTorch
// versions srbd_nmpc_tpu_torch/ops/permute.py::take_lanes_ref / set_lanes_ref.
//
//   gather   out[r, j] = a[r, idx[j]]                  a [R, B] -> out [R, Bc]
//   scatter  out = orig;  out[r, idx[p]] = src[r, p]   orig [R, B], src [R, Bc]
//
// idx is sorted and unique. Both move bits and do no arithmetic, so the result
// is bitwise the plain version's.
//
// What bounds it on the H100: device-memory bandwidth (each element is read
// and written once; there is no reuse). The TPU kernel expressed the lane
// shuffle as a windowed one-hot matmul on the MXU because lane gathers were
// slow there; on this card a direct indexed load is the natural form.
//
// What this simple design does about it: one thread per output element, laid
// out so that consecutive threads write consecutive addresses (coalesced
// stores). Because idx is increasing, consecutive threads of the gather also
// read nearby, ascending addresses. The scatter first copies orig into out
// with the same one-thread-per-element pattern, then writes the Bc moved
// lanes; both launches are on the caller's stream, so they run in order.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void take_lanes_kernel(const float* __restrict__ a, const int32_t* __restrict__ idx,
                                  float* __restrict__ out, int64_t R, int64_t B, int64_t Bc) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * Bc) return;
  const int64_t r = t / Bc;
  const int64_t j = t - r * Bc;
  out[t] = a[r * B + idx[j]];
}

__global__ void copy_kernel(const float* __restrict__ src, float* __restrict__ dst, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) dst[t] = src[t];
}

__global__ void set_lanes_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                                 float* __restrict__ out, int64_t R, int64_t B, int64_t Bc) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * Bc) return;
  const int64_t r = t / Bc;
  const int64_t p = t - r * Bc;
  out[r * B + idx[p]] = src[t];
}

static inline unsigned int n_blocks(int64_t n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

extern "C" int srbd_take_lanes_launch(const float* a, const int32_t* idx, float* out, int64_t R,
                                      int64_t B, int64_t Bc, int threads, void* stream) {
  const int64_t n = R * Bc;
  if (n == 0) return 0;
  take_lanes_kernel<<<n_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(a, idx, out, R,
                                                                                  B, Bc);
  return (int)cudaGetLastError();
}

extern "C" int srbd_set_lanes_launch(const float* orig, const float* src, const int32_t* idx,
                                     float* out, int64_t R, int64_t B, int64_t Bc, int threads,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_all = R * B;
  if (n_all > 0) {
    copy_kernel<<<n_blocks(n_all, threads), threads, 0, s>>>(orig, out, n_all);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int64_t n = R * Bc;
  if (n == 0) return 0;
  set_lanes_kernel<<<n_blocks(n, threads), threads, 0, s>>>(src, idx, out, R, B, Bc);
  return (int)cudaGetLastError();
}
