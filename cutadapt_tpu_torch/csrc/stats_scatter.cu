// Scatter-add of statistics events into int32 count buffers on Hopper
// (sm_90a): one launch bins a batch of buffers.
//
// Replaces the XLA scatter-add programs of the statistics reducer,
// cutadapt_tpu/parallel/stats.py:DeviceStatsReducer (_acc :75-129), and
// the binning of cutadapt_tpu/parallel/mesh.py:make_sharded_trim_step.
// A launch takes up to kMaxDescriptors descriptors; a descriptor is one
// buffer of R x C int32 bins (C = 1 for a 1-D buffer, R = C = 1 for a
// count) and its n events:
//   buf[idx[i] * C + col[i]] += w[i]
// idx, col and w are (n,) int32 arrays; a null idx or col reads as 0 (a
// count reads only w) and a null w as 1. An event whose index lies
// outside the buffer is dropped, as XLA's scatter drops it. Sums wrap in
// int32, as the JAX reducer's buffers do.
//
// What bounds it: bytes. Each event is read once (4 bytes per array) and
// each buffer read and written once; there is no arithmetic to speak of.
// At the reducer's sizes one launch cannot come near that bound: a flush
// of one flagship chunk (33,000 removal events into 128 x 64 bins,
// 33,000 adjacent bases, about 100 weighted written-length bins, a
// 131,072-entry mask) moves about 1 MB, a third of a microsecond at
// 3.35 TB/s, while an empty launch of this kernel takes about 1.2 us in
// a CUDA graph and the phases of a real one (load, shared-memory add,
// cluster barrier, remote read, global add) each cost a memory latency.
// The aim is one launch per chunk and shard at that floor, in place of
// one launch per buffer.
//
// What the design does about it:
// - Each descriptor gets clusters of kClusterSize blocks (the wrapper's
//   plan: one cluster per kEventsPerCluster events, at most
//   kMaxClustersPerDescriptor), launched with cudaLaunchKernelEx and a
//   cluster-dimension attribute; its threads walk its events
//   grid-stride, one event per thread and pass.
// - Cluster mode (a buffer of at most kMaxBinsPerBlock bins): every
//   block bins its events into its own copy of the bins in shared
//   memory, with shared-memory atomics, which resolve a popular bin's
//   conflicts in the SM. After cluster.sync(), block r sums slice r of
//   the bins over the cluster's blocks through distributed shared memory
//   (cluster.map_shared_rank) and adds each nonzero sum to the buffer
//   with one global atomic, so a bin takes one global atomic per cluster
//   instead of one per event. A second cluster.sync() keeps every block's
//   shared memory alive until the last remote read.
// - A count (no idx: one bin, weights only) sums in registers, then
//   across the warp with a full-mask __reduce_add_sync, and adds once per
//   warp.
// - Direct mode (a larger buffer: long-read removal histograms) bins
//   with global atomicAdd, in the same kernel.
// - The descriptor table goes in by value, a __grid_constant__ kernel
//   parameter: no device memory and no copy for it.
// Measured against this (tools/scatter_designs.py): bins split over the
// cluster's blocks with remote atomics into the owner, and a warp
// combining its lanes' adds to one bin (__match_any_sync, then
// __reduce_add_sync over each group's mask) before adding. Both were
// slower: the remote atomics queue at the owner SM, and the reduction
// over divergent masks serialises the groups, which costs more than the
// shared-memory conflicts it saves.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kClusterSize = 8;  // the portable cluster size
constexpr int kMaxDescriptors = 16;
// int32 bins of one block's copy: 48 KiB of dynamic shared memory, the
// most a block gets without opting in
constexpr int kMaxBinsPerBlock = 12288;
// a cluster's threads take one event each per pass
constexpr int kEventsPerCluster = kClusterSize * kThreads;
constexpr int kMaxClustersPerDescriptor = 16;
// int64 fields per descriptor in the launcher's table
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
  int bins_per_block;  // the slice each block sums; 0: direct mode
  int first_cluster;   // of this descriptor in the grid
  int clusters;
};

struct Batch {
  Descriptor d[kMaxDescriptors];
  int count;
};

__global__ void __launch_bounds__(kThreads)
    scatter_batch_kernel(const __grid_constant__ Batch batch) {
  extern __shared__ int32_t bins_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cid = blockIdx.x / kClusterSize;
  int j = 0;
  while (j + 1 < batch.count && cid >= batch.d[j + 1].first_cluster) ++j;
  const Descriptor& d = batch.d[j];
  const unsigned rank = cluster.block_rank();
  const int per = d.bins_per_block;
  const int bins = per != 0 ? d.rows * d.cols : 0;  // held in shared memory
  for (int k = threadIdx.x; k < bins; k += kThreads) bins_smem[k] = 0;
  __syncthreads();

  const long long stride = (long long)d.clusters * kEventsPerCluster;
  long long i = ((long long)(cid - d.first_cluster) * kClusterSize + rank) *
                    kThreads + threadIdx.x;
  if (d.idx == nullptr) {  // a count: one bin, weights only
    int32_t sum = 0;
    for (; i < d.n; i += stride) sum += __ldg(d.w + i);
    sum = __reduce_add_sync(kFullMask, sum);
    if ((threadIdx.x & 31) == 0 && sum != 0)
      atomicAdd(per != 0 ? bins_smem : d.buf, sum);
  } else {
    for (; i < d.n; i += stride) {
      const int32_t v = d.w ? __ldg(d.w + i) : 1;
      const int32_t r = __ldg(d.idx + i);
      const int32_t c = d.col ? __ldg(d.col + i) : 0;
      if (v == 0 || r < 0 || r >= d.rows || c < 0 || c >= d.cols) continue;
      if (per != 0)
        atomicAdd(bins_smem + r * d.cols + c, v);
      else
        atomicAdd(d.buf + (long long)r * d.cols + c, v);
    }
  }
  if (per == 0) return;  // uniform over the cluster: no barrier to meet

  cluster.sync();  // every block's copy is complete
  const int first = (int)rank * per;
  for (int k = first + threadIdx.x; k < first + per && k < bins;
       k += kThreads) {
    int32_t s = 0;
#pragma unroll
    for (int q = 0; q < kClusterSize; ++q)
      s += cluster.map_shared_rank(bins_smem, q)[k];
    if (s != 0) atomicAdd(d.buf + k, s);
  }
  cluster.sync();  // no block reads another's shared memory after this
}

}  // namespace

extern "C" {

// The kernel's constants, which the wrapper checks when it loads the
// library.
int stats_scatter_threads() { return kThreads; }
int stats_scatter_cluster() { return kClusterSize; }
int stats_scatter_max_descriptors() { return kMaxDescriptors; }
int stats_scatter_max_bins_per_block() { return kMaxBinsPerBlock; }
int stats_scatter_events_per_cluster() { return kEventsPerCluster; }
int stats_scatter_max_clusters_per_descriptor() {
  return kMaxClustersPerDescriptor;
}

// Launches one batch on `stream` and returns the CUDA error code of the
// launch (0 on success). `table` holds `count` rows of kFields int64:
// buf, idx, col, w (device pointers, 0 for null), n, R, C, bins per
// block (0: direct mode) and clusters. A row the kernel cannot take (no
// events, no buffer, a cluster-mode buffer past kMaxBinsPerBlock or
// bins per block that do not cover it, clusters out of range, a null
// idx or col on a buffer that needs it, a count without weights)
// refuses the whole launch.
int stats_scatter_batch_launch(const long long* table, int count,
                               void* stream) {
  if (table == nullptr || count < 1 || count > kMaxDescriptors)
    return (int)cudaErrorInvalidValue;
  Batch batch = {};
  batch.count = count;
  int smem_bins = 1;
  int clusters = 0;
  for (int j = 0; j < count; ++j) {
    const long long* t = table + (long long)kFields * j;
    if (t[0] == 0 || t[4] < 1 || t[5] < 1 || t[5] > INT_MAX || t[6] < 1 ||
        t[6] > INT_MAX || t[7] < 0 || t[8] < 1 ||
        t[8] > kMaxClustersPerDescriptor)
      return (int)cudaErrorInvalidValue;
    Descriptor& d = batch.d[j];
    d.buf = reinterpret_cast<int32_t*>(t[0]);
    d.idx = reinterpret_cast<const int32_t*>(t[1]);
    d.col = reinterpret_cast<const int32_t*>(t[2]);
    d.w = reinterpret_cast<const int32_t*>(t[3]);
    d.n = t[4];
    d.rows = (int)t[5];
    d.cols = (int)t[6];
    d.bins_per_block = (int)t[7];
    d.first_cluster = clusters;
    d.clusters = (int)t[8];
    clusters += d.clusters;
    const long long bins = t[5] * t[6];
    if ((d.idx == nullptr &&
         (d.rows != 1 || d.w == nullptr || d.col != nullptr)) ||
        (d.col == nullptr && d.cols != 1) ||
        (d.bins_per_block != 0 &&
         (bins > kMaxBinsPerBlock ||
          (long long)d.bins_per_block * kClusterSize < bins)))
      return (int)cudaErrorInvalidValue;
    if (d.bins_per_block != 0 && bins > smem_bins) smem_bins = (int)bins;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * kClusterSize, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem_bins * sizeof(int32_t);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, scatter_batch_kernel,
                                             batch);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch never ran
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
