// Design variants of the batched scatter kernel, for
// tools/scatter_designs.py: the C interface of
// cutadapt_tpu_torch/csrc/stats_scatter.cu (its 9-field descriptor
// table; the clusters column is replaced by DESIGN_EPC), with the design
// chosen by macros:
//   DESIGN_PRIVATE 0: a buffer's bins split over the cluster's blocks,
//     each event added into its owner block through distributed shared
//     memory (remote atomics); 1: every block bins into its own copy of
//     all the bins with shared-memory atomics, then block r sums slice r
//     over the cluster through distributed shared memory.
//   DESIGN_AGG 0: every event adds itself; 1: the lanes of a warp that
//     hit one bin combine (__match_any_sync, __reduce_add_sync over each
//     group's mask) and one adds; 2: as 1 for unit weights with
//     __popc(peers) in place of the reduction.
//   DESIGN_THREADS, DESIGN_CLUSTER: block and cluster sizes;
//   DESIGN_EPC: events per cluster (clusters per descriptor, at most
//     DESIGN_MAX_CLUSTERS); DESIGN_EPT: events per thread and pass;
//   DESIGN_EMPTY 1: return at once (the launch floor).
// Direct mode (global atomics) for a descriptor with bins per block 0,
// and a count's register sum, as in the shipped kernel. Every variant
// adds its final sums with global atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#ifndef DESIGN_THREADS
#define DESIGN_THREADS 1024
#endif
#ifndef DESIGN_PRIVATE
#define DESIGN_PRIVATE 0
#endif
#ifndef DESIGN_EPC
#define DESIGN_EPC (1LL << 40)
#endif
#ifndef DESIGN_CLUSTER
#define DESIGN_CLUSTER 8
#endif
#ifndef DESIGN_MAX_CLUSTERS
#define DESIGN_MAX_CLUSTERS 16
#endif
#ifndef DESIGN_EMPTY
#define DESIGN_EMPTY 0
#endif
#ifndef DESIGN_AGG
#define DESIGN_AGG 1
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = DESIGN_THREADS;
constexpr int kClusterSize = DESIGN_CLUSTER;
constexpr int kMaxDescriptors = 16;
constexpr int kMaxBinsPerBlock = 12288;
#ifndef DESIGN_EPT
#define DESIGN_EPT 4
#endif
constexpr int kEventsPerThread = DESIGN_EPT;
constexpr int kFields = 9;
constexpr unsigned kFullMask = 0xffffffffu;

struct Descriptor {
  int32_t* buf;
  const int32_t* idx;
  const int32_t* col;
  const int32_t* w;
  long long n;
  int rows;
  int cols;
  int per;  // 0: direct mode
  int first_cluster;
  int clusters;
};

struct Batch {
  Descriptor d[kMaxDescriptors];
  int count;
};

__device__ __forceinline__ void add_to_bin(cg::cluster_group& cluster,
                                           int32_t* slice,
                                           const Descriptor& d,
                                           long long bin, int32_t v) {
  if (d.per == 0) {
    atomicAdd(d.buf + bin, v);
    return;
  }
#if DESIGN_PRIVATE
  atomicAdd(slice + (int)bin, v);
#else
  const int b = (int)bin;
  const int owner = b / d.per;
  atomicAdd(cluster.map_shared_rank(slice, owner) + (b - owner * d.per), v);
#endif
}

__global__ void __launch_bounds__(kThreads)
    design_kernel(const __grid_constant__ Batch batch) {
  extern __shared__ int32_t slice[];
#if DESIGN_EMPTY
  if (batch.count > 0) return;
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int cid = blockIdx.x / kClusterSize;
  int j = 0;
  while (j + 1 < batch.count && cid >= batch.d[j + 1].first_cluster) ++j;
  const Descriptor& d = batch.d[j];
  const int local = cid - d.first_cluster;
  const unsigned rank = cluster.block_rank();
  const int per = d.per;
  const long long bins = (long long)d.rows * d.cols;
#if DESIGN_PRIVATE
  const int held = (int)bins;
#else
  const int held = per;
#endif
  if (per != 0) {
    for (int k = threadIdx.x; k < held; k += kThreads) slice[k] = 0;
#if DESIGN_PRIVATE
    __syncthreads();
#else
    cluster.sync();
#endif
  }
  const int lane = threadIdx.x & 31;
  const long long warp =
      (((long long)local * kClusterSize + rank) * kThreads + threadIdx.x) >> 5;
  constexpr long long kSpan = 32LL * kEventsPerThread;
  const long long stride =
      (long long)d.clusters * kClusterSize * kThreads / 32 * kSpan;
  int32_t one_bin = 0;
  for (long long base = warp * kSpan; base < d.n; base += stride) {
    long long bin[kEventsPerThread];
    int32_t v[kEventsPerThread];
#pragma unroll
    for (int k = 0; k < kEventsPerThread; ++k) {
      const long long i = base + k * 32 + lane;
      bin[k] = -1;
      v[k] = 0;
      if (i < d.n) {
        const int32_t wi = d.w ? __ldg(d.w + i) : 1;
        const int32_t r = d.idx ? __ldg(d.idx + i) : 0;
        const int32_t c = d.col ? __ldg(d.col + i) : 0;
        if (wi != 0 && r >= 0 && r < d.rows && c >= 0 && c < d.cols) {
          bin[k] = (long long)r * d.cols + c;
          v[k] = wi;
        }
      }
    }
    if (bins == 1) {
#pragma unroll
      for (int k = 0; k < kEventsPerThread; ++k) one_bin += v[k];
      continue;
    }
#pragma unroll
    for (int k = 0; k < kEventsPerThread; ++k) {
#if DESIGN_AGG == 0
      if (bin[k] >= 0) add_to_bin(cluster, slice, d, bin[k], v[k]);
#elif DESIGN_AGG == 1
      const unsigned peers = __match_any_sync(kFullMask, bin[k]);
      const int32_t sum = __reduce_add_sync(peers, v[k]);
      if (bin[k] >= 0 && lane == __ffs(peers) - 1)
        add_to_bin(cluster, slice, d, bin[k], sum);
#else
      if (d.w == nullptr) {
        const unsigned peers = __match_any_sync(kFullMask, bin[k]);
        if (bin[k] >= 0 && lane == __ffs(peers) - 1)
          add_to_bin(cluster, slice, d, bin[k], __popc(peers));
      } else if (bin[k] >= 0) {
        add_to_bin(cluster, slice, d, bin[k], v[k]);
      }
#endif
    }
  }
  if (bins == 1) {
    one_bin = __reduce_add_sync(kFullMask, one_bin);
    if (lane == 0 && one_bin != 0) add_to_bin(cluster, slice, d, 0, one_bin);
  }
  if (per != 0) {
    cluster.sync();
    const int own = (int)((bins + kClusterSize - 1) / kClusterSize);
    const long long first = (long long)rank * own;
#if DESIGN_PRIVATE
    for (int k = threadIdx.x; k < own && first + k < bins; k += kThreads) {
      int32_t s = 0;
#pragma unroll
      for (int q = 0; q < kClusterSize; ++q)
        s += cluster.map_shared_rank(slice, q)[first + k];
      if (s != 0) atomicAdd(d.buf + first + k, s);
    }
    cluster.sync();
#else
    for (int k = threadIdx.x; k < per && first + k < bins; k += kThreads) {
      const int32_t s = slice[k];
      if (s != 0) atomicAdd(d.buf + first + k, s);
    }
#endif
  }
}

}  // namespace

extern "C" {

int stats_scatter_threads() { return kThreads; }
int stats_scatter_cluster() { return kClusterSize; }
int stats_scatter_max_descriptors() { return kMaxDescriptors; }
int stats_scatter_max_bins_per_block() { return kMaxBinsPerBlock; }

int stats_scatter_batch_launch(const long long* table, int count,
                               void* stream) {
  if (table == nullptr || count < 1 || count > kMaxDescriptors)
    return (int)cudaErrorInvalidValue;
  Batch batch = {};
  batch.count = count;
  int smem = 1;
  int clusters = 0;
  for (int j = 0; j < count; ++j) {
    const long long* t = table + (long long)kFields * j;
    Descriptor& d = batch.d[j];
    d.buf = reinterpret_cast<int32_t*>(t[0]);
    d.idx = reinterpret_cast<const int32_t*>(t[1]);
    d.col = reinterpret_cast<const int32_t*>(t[2]);
    d.w = reinterpret_cast<const int32_t*>(t[3]);
    d.n = t[4];
    d.rows = (int)t[5];
    d.cols = (int)t[6];
    const long long bins = t[5] * t[6];
    d.per = t[7] == 0 ? 0 : (int)((bins + kClusterSize - 1) / kClusterSize);
    long long c = (d.n + DESIGN_EPC - 1) / DESIGN_EPC;
    if (c > DESIGN_MAX_CLUSTERS) c = DESIGN_MAX_CLUSTERS;
    if (c < 1) c = 1;
    d.first_cluster = clusters;
    d.clusters = (int)c;
    clusters += (int)c;
#if DESIGN_PRIVATE
    const int held = d.per ? (int)bins : 0;
#else
    const int held = d.per;
#endif
    if (held > smem) smem = held;
  }
  if (smem > kMaxBinsPerBlock) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * kClusterSize, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem * sizeof(int32_t);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, design_kernel, batch);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
