// Scatter-add of statistics events into int32 count buffers on Hopper
// (sm_90a).
//
// Replaces the XLA scatter-add programs of the statistics reducer,
// cutadapt_tpu/parallel/stats.py:DeviceStatsReducer (_acc :75-129), and
// the binning of cutadapt_tpu/parallel/mesh.py:make_sharded_trim_step:
//   hist2d: buf[rows[i] * C + cols[i]] += valid[i]   (R, C) buffer
//   hist1d: buf[idx[i]] += valid[i]                  (R,) buffer
//   count:  buf[0] += sum(valid)
// Events are (n,) int32 arrays; padding events carry valid 0 and change
// no bin. An event whose index lies outside the buffer is dropped, as
// XLA's scatter drops it (the reducer sizes its buffers so that none
// does).
//
// What bounds it: bytes. An event reads 12 bytes (8 for hist1d, 4 for
// count) and does one int32 read-modify-write in the buffer; there is no
// arithmetic to speak of. The buffers are small (at most a few hundred
// KiB), so the atomics hit L2, and contention is on the popular bins
// (short removed lengths, errors 0).
//
// What the design does about it: one thread per event, coalesced loads of
// the three event arrays, one atomicAdd on global memory where the event
// is valid. count sums in registers (grid-stride), then across the warp
// with shuffles and across the block through shared memory, and makes one
// atomicAdd per block. Privatising the histograms in shared memory is
// left for later: the reducer's launches are a few thousand events each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// count's grid: enough blocks to fill the card, each walking its stride
constexpr int kCountMaxBlocks = 1024;

__global__ void hist2d_kernel(int32_t* __restrict__ buf,
                              const int32_t* __restrict__ rows,
                              const int32_t* __restrict__ cols,
                              const int32_t* __restrict__ valid, long long n,
                              int R, int C) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t v = __ldg(valid + i);
  const int32_t r = __ldg(rows + i);
  const int32_t c = __ldg(cols + i);
  if (v != 0 && r >= 0 && r < R && c >= 0 && c < C)
    atomicAdd(buf + (long long)r * C + c, v);
}

__global__ void hist1d_kernel(int32_t* __restrict__ buf,
                              const int32_t* __restrict__ idx,
                              const int32_t* __restrict__ valid, long long n,
                              int R) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t v = __ldg(valid + i);
  const int32_t r = __ldg(idx + i);
  if (v != 0 && r >= 0 && r < R) atomicAdd(buf + r, v);
}

__global__ void count_kernel(int32_t* __restrict__ buf,
                             const int32_t* __restrict__ valid, long long n) {
  __shared__ int32_t warp_sums[kThreads / 32];
  int32_t s = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    s += __ldg(valid + i);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(~0u, s, off);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(~0u, s, off);
    if (threadIdx.x == 0 && s != 0) atomicAdd(buf, s);
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Threads per block of every entry point.
int stats_scatter_threads() { return kThreads; }

// Each entry point launches on `stream` and returns the CUDA error code of
// the launch (0 on success). n must be at least 1: the wrapper launches
// nothing for an empty batch.
int stats_hist2d_launch(int32_t* buf, const int32_t* rows,
                        const int32_t* cols, const int32_t* valid, long long n,
                        int R, int C, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  hist2d_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(buf, rows, cols, valid,
                                                       n, R, C);
  return (int)cudaGetLastError();
}

int stats_hist1d_launch(int32_t* buf, const int32_t* idx,
                        const int32_t* valid, long long n, int R,
                        void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  hist1d_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(buf, idx, valid, n, R);
  return (int)cudaGetLastError();
}

int stats_count_launch(int32_t* buf, const int32_t* valid, long long n,
                       void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = blocks_for(n) < kCountMaxBlocks ? blocks_for(n)
                                                      : kCountMaxBlocks;
  count_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, valid, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
