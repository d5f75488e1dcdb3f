// K2 · lane gather / scatter for the compaction crossings of the speculative solve.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/permute_pallas.py::_gather_kernel (:48, called
// by take_lanes at :97) and ::_scatter_kernel (:149, called by set_lanes at :233). Contract:
// the plain PyTorch versions srbd_nmpc_tpu_torch/ops/permute.py::take_lanes_ref /
// set_lanes_ref, bitwise:
//
//   gather   out[r, j] = a[r, idx[j]]                  a [R, B] -> out [R, Bc]
//   scatter  out = orig;  out[r, idx[p]] = src[r, p]   orig [R, B], src [R, Bc]
//
// idx is sorted and unique, int32 or int64 as the caller holds it (both bodies are templates
// on the index type, so no cast runs before them); any widths. The kernels move 32-bit words
// (float32 data) and, in their 8-byte form (take_lanes8_kernel, set_lanes8_kernel: float64
// data), 64-bit words, and do no arithmetic, so NaN payloads and -0 come through unchanged.
//
// What bounds them on the H100: device-memory bytes. Nothing is reused and nothing is
// computed; the least traffic reads each needed element once and writes each output once.
//
// What the design does about it:
// - Each thread owns LANES = 4 consecutive output lanes and a chunk of rows (2-D grid:
//   blockIdx.x over lane groups, blockIdx.y over row chunks, rows per block chosen by the
//   wrapper so that every tier fills the SMs). Its lane bookkeeping is done once and reused
//   on every row: the gather loads its 4 indices; the scatter finds which of its 4 lanes idx
//   covers, and from which source position, by one binary search.
// - Per row it issues independent word loads for its 4 lanes, UNROLL rows at a time, so
//   LANES x UNROLL loads are in flight per thread, and 16-byte stores where the output rows
//   are 16-byte aligned (width a multiple of 4; one a row, two in the 8-byte form); word
//   stores otherwise (VEC = false).
// - The scatter is one pass and one launch: a thread reads orig's 16 bytes only where one of
//   its lanes is not overwritten, takes the others from src, and writes every output word
//   once (no copy launch, no second, partial-sector write).
//
// The per-thread bodies (namespace k2) also compile as host C++ (without __CUDACC__); the
// host entries run them over an emulated grid, so the index logic is tested on a CPU.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K2_FN __device__ __forceinline__
#else
#define K2_FN inline
#endif

namespace k2 {

typedef uint32_t word;     // an element of float32 data
typedef uint64_t word8;    // an element of float64 data (the 8-byte form)
constexpr int LANES = 4;          // consecutive output lanes per thread
constexpr int UNROLL = 2;         // rows whose loads are issued together
constexpr int MAX_THREADS = 256;  // threads per block (the kernels' launch bound)

#ifdef __CUDACC__
K2_FN word ld(const word* p) { return __ldg(p); }
K2_FN word8 ld(const word8* p) { return __ldg(reinterpret_cast<const unsigned long long*>(p)); }
K2_FN int64_t ld_idx(const int32_t* p) { return __ldg(p); }
K2_FN int64_t ld_idx(const int64_t* p) { return __ldg(reinterpret_cast<const long long*>(p)); }
K2_FN void ld4(const word* p, word* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
K2_FN void st4(word* p, const word* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
K2_FN void ld4(const word8* p, word8* v) {
  const ulonglong2 q0 = __ldg(reinterpret_cast<const ulonglong2*>(p));
  const ulonglong2 q1 = __ldg(reinterpret_cast<const ulonglong2*>(p) + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
K2_FN void st4(word8* p, const word8* v) {
  reinterpret_cast<ulonglong2*>(p)[0] = make_ulonglong2(v[0], v[1]);
  reinterpret_cast<ulonglong2*>(p)[1] = make_ulonglong2(v[2], v[3]);
}
#else
template <typename Word> K2_FN Word ld(const Word* p) { return *p; }
K2_FN int64_t ld_idx(const int32_t* p) { return *p; }
K2_FN int64_t ld_idx(const int64_t* p) { return *p; }
template <typename Word> K2_FN void ld4(const Word* p, Word* v) {
  for (int k = 0; k < 4; ++k) v[k] = p[k];
}
template <typename Word> K2_FN void st4(Word* p, const Word* v) {
  for (int k = 0; k < 4; ++k) p[k] = v[k];
}
#endif

// the n <= LANES words of one row of a thread's lanes
template <bool VEC, typename Word>
K2_FN void store_lanes(Word* p, const Word* v, int n) {
  if (VEC) {
    st4(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < LANES; ++k)
      if (k < n) p[k] = v[k];
  }
}

// gather: output lanes j0 .. j0 + n - 1 (n = min(LANES, Bc - j0)) of rows [r0, r1)
template <typename IdxT, bool VEC, typename Word>
K2_FN void take_lanes_thread(const Word* a, const IdxT* idx, Word* out, int64_t B, int64_t Bc,
                             int64_t j0, int64_t r0, int64_t r1) {
  const int n = Bc - j0 < LANES ? (int)(Bc - j0) : LANES;
  int64_t col[LANES];
#pragma unroll
  for (int k = 0; k < LANES; ++k) col[k] = ld_idx(idx + j0 + (k < n ? k : 0));
  int64_t r = r0;
  for (; r + UNROLL <= r1; r += UNROLL) {
    Word v[UNROLL][LANES];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const Word* row = a + (r + u) * B;
#pragma unroll
      for (int k = 0; k < LANES; ++k) v[u][k] = ld(row + col[k]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) store_lanes<VEC>(out + (r + u) * Bc + j0, v[u], n);
  }
  for (; r < r1; ++r) {
    Word v[LANES];
    const Word* row = a + r * B;
#pragma unroll
    for (int k = 0; k < LANES; ++k) v[k] = ld(row + col[k]);
    store_lanes<VEC>(out + r * Bc + j0, v, n);
  }
}

// the first p with idx[p] >= l (Bc if none). idx is sorted and unique in [0, B), so
// p <= idx[p] <= p + B - Bc, and the answer lies in [max(0, l - (B - Bc)), min(l, Bc)].
template <typename IdxT>
K2_FN int64_t lower_bound(const IdxT* idx, int64_t B, int64_t Bc, int64_t l) {
  int64_t lo = l - (B - Bc) > 0 ? l - (B - Bc) : 0;
  int64_t hi = l < Bc ? l : Bc;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (ld_idx(idx + mid) < l)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// one row of the scatter: orig's words where sp < 0, src's word sp otherwise
template <bool VEC, typename Word>
K2_FN void scatter_row(const Word* orig_row, const Word* src_row, const int64_t* sp, bool full,
                       int n, Word* v) {
  if (!full) {
    if (VEC) {
      ld4(orig_row, v);
    } else {
#pragma unroll
      for (int k = 0; k < LANES; ++k)
        if (k < n && sp[k] < 0) v[k] = ld(orig_row + k);
    }
  }
#pragma unroll
  for (int k = 0; k < LANES; ++k)
    if (k < n && sp[k] >= 0) v[k] = ld(src_row + sp[k]);
}

// scatter: destination lanes l0 .. l0 + n - 1 (n = min(LANES, B - l0)) of rows [r0, r1)
template <typename IdxT, bool VEC, typename Word>
K2_FN void set_lanes_thread(const Word* orig, const Word* src, const IdxT* idx, Word* out,
                            int64_t B, int64_t Bc, int64_t l0, int64_t r0, int64_t r1) {
  const int n = B - l0 < LANES ? (int)(B - l0) : LANES;
  // sp[k]: the source position that lands on lane l0 + k, or -1 where orig's word stays
  int64_t sp[LANES];
  int64_t p = lower_bound(idx, B, Bc, l0);
  bool full = true;
#pragma unroll
  for (int k = 0; k < LANES; ++k) {
    sp[k] = -1;
    if (k < n && p < Bc && ld_idx(idx + p) == l0 + k) sp[k] = p++;
    if (k < n && sp[k] < 0) full = false;
  }
  int64_t r = r0;
  for (; r + UNROLL <= r1; r += UNROLL) {
    Word v[UNROLL][LANES];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      scatter_row<VEC>(orig + (r + u) * B + l0, src + (r + u) * Bc, sp, full, n, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) store_lanes<VEC>(out + (r + u) * B + l0, v[u], n);
  }
  for (; r < r1; ++r) {
    Word v[LANES];
    scatter_row<VEC>(orig + r * B + l0, src + r * Bc, sp, full, n, v);
    store_lanes<VEC>(out + r * B + l0, v, n);
  }
}

// the grid over `lanes` output lanes and R rows; 0 if the arguments are valid
inline int geometry(int64_t R, int64_t lanes, int64_t rows_per_block, int idx_bytes,
                    int threads, int64_t* nx, int64_t* ny) {
  if (rows_per_block <= 0 || threads <= 0 || threads > MAX_THREADS ||
      (idx_bytes != 4 && idx_bytes != 8))
    return 1;
  const int64_t per_block = (int64_t)LANES * threads;
  *nx = (lanes + per_block - 1) / per_block;
  *ny = (R + rows_per_block - 1) / rows_per_block;
  return *ny > 65535 ? 1 : 0;
}

}  // namespace k2

using k2::word;
using k2::word8;

#ifdef __CUDACC__

template <typename IdxT, bool VEC>
__global__ void __launch_bounds__(k2::MAX_THREADS)
    take_lanes_kernel(const word* __restrict__ a, const IdxT* __restrict__ idx,
                      word* __restrict__ out, int64_t R, int64_t B, int64_t Bc,
                      int64_t rows_per_block) {
  const int64_t j0 = k2::LANES * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (j0 >= Bc) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < R ? r0 + rows_per_block : R;
  k2::take_lanes_thread<IdxT, VEC>(a, idx, out, B, Bc, j0, r0, r1);
}

template <typename IdxT, bool VEC>
__global__ void __launch_bounds__(k2::MAX_THREADS)
    set_lanes_kernel(const word* __restrict__ orig, const word* __restrict__ src,
                     const IdxT* __restrict__ idx, word* __restrict__ out, int64_t R, int64_t B,
                     int64_t Bc, int64_t rows_per_block) {
  const int64_t l0 = k2::LANES * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (l0 >= B) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < R ? r0 + rows_per_block : R;
  k2::set_lanes_thread<IdxT, VEC>(orig, src, idx, out, B, Bc, l0, r0, r1);
}

// the 8-byte forms: the same bodies on 64-bit words
template <typename IdxT, bool VEC>
__global__ void __launch_bounds__(k2::MAX_THREADS)
    take_lanes8_kernel(const word8* __restrict__ a, const IdxT* __restrict__ idx,
                       word8* __restrict__ out, int64_t R, int64_t B, int64_t Bc,
                       int64_t rows_per_block) {
  const int64_t j0 = k2::LANES * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (j0 >= Bc) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < R ? r0 + rows_per_block : R;
  k2::take_lanes_thread<IdxT, VEC>(a, idx, out, B, Bc, j0, r0, r1);
}

template <typename IdxT, bool VEC>
__global__ void __launch_bounds__(k2::MAX_THREADS)
    set_lanes8_kernel(const word8* __restrict__ orig, const word8* __restrict__ src,
                      const IdxT* __restrict__ idx, word8* __restrict__ out, int64_t R,
                      int64_t B, int64_t Bc, int64_t rows_per_block) {
  const int64_t l0 = k2::LANES * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (l0 >= B) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < R ? r0 + rows_per_block : R;
  k2::set_lanes_thread<IdxT, VEC>(orig, src, idx, out, B, Bc, l0, r0, r1);
}

template <typename Word, typename IdxT, bool VEC>
static void take_launch(dim3 grid, int threads, cudaStream_t s, const void* a, const void* idx,
                        void* out, int64_t R, int64_t B, int64_t Bc, int64_t rpb) {
  if constexpr (sizeof(Word) == 8)
    take_lanes8_kernel<IdxT, VEC><<<grid, threads, 0, s>>>(
        (const word8*)a, (const IdxT*)idx, (word8*)out, R, B, Bc, rpb);
  else
    take_lanes_kernel<IdxT, VEC><<<grid, threads, 0, s>>>(
        (const word*)a, (const IdxT*)idx, (word*)out, R, B, Bc, rpb);
}

template <typename Word, typename IdxT, bool VEC>
static void set_launch(dim3 grid, int threads, cudaStream_t s, const void* orig, const void* src,
                       const void* idx, void* out, int64_t R, int64_t B, int64_t Bc,
                       int64_t rpb) {
  if constexpr (sizeof(Word) == 8)
    set_lanes8_kernel<IdxT, VEC><<<grid, threads, 0, s>>>(
        (const word8*)orig, (const word8*)src, (const IdxT*)idx, (word8*)out, R, B, Bc, rpb);
  else
    set_lanes_kernel<IdxT, VEC><<<grid, threads, 0, s>>>(
        (const word*)orig, (const word*)src, (const IdxT*)idx, (word*)out, R, B, Bc, rpb);
}

template <typename Word>
static int take_entry(const void* a, const void* idx, int idx_bytes, void* out, int64_t R,
                      int64_t B, int64_t Bc, int64_t rows_per_block, int vec, int threads,
                      void* stream) {
  int64_t nx, ny;
  if (k2::geometry(R, Bc, rows_per_block, idx_bytes, threads, &nx, &ny))
    return (int)cudaErrorInvalidValue;
  if (R <= 0 || Bc <= 0) return 0;
  const dim3 grid((unsigned)nx, (unsigned)ny);
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 8)
    (vec ? take_launch<Word, int64_t, true>
         : take_launch<Word, int64_t, false>)(grid, threads, s, a, idx, out, R, B, Bc,
                                             rows_per_block);
  else
    (vec ? take_launch<Word, int32_t, true>
         : take_launch<Word, int32_t, false>)(grid, threads, s, a, idx, out, R, B, Bc,
                                             rows_per_block);
  return (int)cudaGetLastError();
}

template <typename Word>
static int set_entry(const void* orig, const void* src, const void* idx, int idx_bytes,
                     void* out, int64_t R, int64_t B, int64_t Bc, int64_t rows_per_block,
                     int vec, int threads, void* stream) {
  int64_t nx, ny;
  if (k2::geometry(R, B, rows_per_block, idx_bytes, threads, &nx, &ny))
    return (int)cudaErrorInvalidValue;
  if (R <= 0 || B <= 0) return 0;
  const dim3 grid((unsigned)nx, (unsigned)ny);
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 8)
    (vec ? set_launch<Word, int64_t, true>
         : set_launch<Word, int64_t, false>)(grid, threads, s, orig, src, idx, out, R, B, Bc,
                                            rows_per_block);
  else
    (vec ? set_launch<Word, int32_t, true>
         : set_launch<Word, int32_t, false>)(grid, threads, s, orig, src, idx, out, R, B, Bc,
                                            rows_per_block);
  return (int)cudaGetLastError();
}

// idx_bytes: 4 (int32 idx) or 8 (int64); vec != 0: out's rows are 16-byte aligned
extern "C" int srbd_take_lanes_launch(const float* a, const void* idx, int idx_bytes, float* out,
                                      int64_t R, int64_t B, int64_t Bc, int64_t rows_per_block,
                                      int vec, int threads, void* stream) {
  return take_entry<word>(a, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec, threads,
                          stream);
}

// vec != 0: orig's and out's rows are 16-byte aligned
extern "C" int srbd_set_lanes_launch(const float* orig, const float* src, const void* idx,
                                     int idx_bytes, float* out, int64_t R, int64_t B, int64_t Bc,
                                     int64_t rows_per_block, int vec, int threads,
                                     void* stream) {
  return set_entry<word>(orig, src, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec,
                         threads, stream);
}

// the 8-byte forms (float64 data), as the two entries above
extern "C" int srbd_take_lanes8_launch(const double* a, const void* idx, int idx_bytes,
                                       double* out, int64_t R, int64_t B, int64_t Bc,
                                       int64_t rows_per_block, int vec, int threads,
                                       void* stream) {
  return take_entry<word8>(a, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec, threads,
                           stream);
}

extern "C" int srbd_set_lanes8_launch(const double* orig, const double* src, const void* idx,
                                      int idx_bytes, double* out, int64_t R, int64_t B,
                                      int64_t Bc, int64_t rows_per_block, int vec, int threads,
                                      void* stream) {
  return set_entry<word8>(orig, src, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec,
                          threads, stream);
}

#else  // host build: the same per-thread bodies over an emulated grid

template <typename Word, typename IdxT, bool VEC>
static void take_host(const Word* a, const void* idx, Word* out, int64_t R, int64_t B,
                      int64_t Bc, int64_t rpb, int threads, int64_t nx, int64_t ny) {
  for (int64_t by = 0; by < ny; ++by)
    for (int64_t bx = 0; bx < nx; ++bx)
      for (int tx = 0; tx < threads; ++tx) {
        const int64_t j0 = k2::LANES * (bx * threads + tx);
        if (j0 >= Bc) continue;
        const int64_t r0 = by * rpb, r1 = r0 + rpb < R ? r0 + rpb : R;
        k2::take_lanes_thread<IdxT, VEC>(a, (const IdxT*)idx, out, B, Bc, j0, r0, r1);
      }
}

template <typename Word, typename IdxT, bool VEC>
static void set_host(const Word* orig, const Word* src, const void* idx, Word* out, int64_t R,
                     int64_t B, int64_t Bc, int64_t rpb, int threads, int64_t nx, int64_t ny) {
  for (int64_t by = 0; by < ny; ++by)
    for (int64_t bx = 0; bx < nx; ++bx)
      for (int tx = 0; tx < threads; ++tx) {
        const int64_t l0 = k2::LANES * (bx * threads + tx);
        if (l0 >= B) continue;
        const int64_t r0 = by * rpb, r1 = r0 + rpb < R ? r0 + rpb : R;
        k2::set_lanes_thread<IdxT, VEC>(orig, src, (const IdxT*)idx, out, B, Bc, l0, r0, r1);
      }
}

template <typename Word>
static int take_host_entry(const void* a, const void* idx, int idx_bytes, void* out, int64_t R,
                           int64_t B, int64_t Bc, int64_t rows_per_block, int vec,
                           int threads) {
  int64_t nx, ny;
  if (k2::geometry(R, Bc, rows_per_block, idx_bytes, threads, &nx, &ny)) return 1;
  const Word* aw = (const Word*)a;
  Word* ow = (Word*)out;
  if (idx_bytes == 8)
    (vec ? take_host<Word, int64_t, true>
         : take_host<Word, int64_t, false>)(aw, idx, ow, R, B, Bc, rows_per_block, threads, nx,
                                           ny);
  else
    (vec ? take_host<Word, int32_t, true>
         : take_host<Word, int32_t, false>)(aw, idx, ow, R, B, Bc, rows_per_block, threads, nx,
                                           ny);
  return 0;
}

template <typename Word>
static int set_host_entry(const void* orig, const void* src, const void* idx, int idx_bytes,
                          void* out, int64_t R, int64_t B, int64_t Bc, int64_t rows_per_block,
                          int vec, int threads) {
  int64_t nx, ny;
  if (k2::geometry(R, B, rows_per_block, idx_bytes, threads, &nx, &ny)) return 1;
  const Word *ow = (const Word*)orig, *sw = (const Word*)src;
  Word* dw = (Word*)out;
  if (idx_bytes == 8)
    (vec ? set_host<Word, int64_t, true>
         : set_host<Word, int64_t, false>)(ow, sw, idx, dw, R, B, Bc, rows_per_block, threads,
                                          nx, ny);
  else
    (vec ? set_host<Word, int32_t, true>
         : set_host<Word, int32_t, false>)(ow, sw, idx, dw, R, B, Bc, rows_per_block, threads,
                                          nx, ny);
  return 0;
}

extern "C" int srbd_take_lanes_host(const float* a, const void* idx, int idx_bytes, float* out,
                                    int64_t R, int64_t B, int64_t Bc, int64_t rows_per_block,
                                    int vec, int threads) {
  return take_host_entry<word>(a, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec, threads);
}

extern "C" int srbd_set_lanes_host(const float* orig, const float* src, const void* idx,
                                   int idx_bytes, float* out, int64_t R, int64_t B, int64_t Bc,
                                   int64_t rows_per_block, int vec, int threads) {
  return set_host_entry<word>(orig, src, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec,
                              threads);
}

// the 8-byte forms
extern "C" int srbd_take_lanes8_host(const double* a, const void* idx, int idx_bytes,
                                     double* out, int64_t R, int64_t B, int64_t Bc,
                                     int64_t rows_per_block, int vec, int threads) {
  return take_host_entry<word8>(a, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec,
                                threads);
}

extern "C" int srbd_set_lanes8_host(const double* orig, const double* src, const void* idx,
                                    int idx_bytes, double* out, int64_t R, int64_t B,
                                    int64_t Bc, int64_t rows_per_block, int vec, int threads) {
  return set_host_entry<word8>(orig, src, idx, idx_bytes, out, R, B, Bc, rows_per_block, vec,
                               threads);
}

#endif
