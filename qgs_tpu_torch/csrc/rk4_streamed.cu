// Fused classical RK4 integration of a batch of trajectories of the
// quadratic tendency  f_i = sum_e v_e * xx[j_e] * xx[k_e],  xx = [1, y],
// for tensors whose records do not fit one block's shared memory.
//
// Replaces the TPU kernel make_pallas_rk4_f32
// (qgs_tpu/ops/pallas_kernels.py:210) where the resident kernel
// (rk4_fused.cu) cannot hold the tensor: n_steps RK4 steps of a batch in
// one launch, in float (tendencies built with dtype=torch.float32) or
// double.  The TPU kernel takes any rank-3 tensor that fits VMEM; on the
// H100 the resident kernel's records plus four state rows of 32 lanes
// exceed a block's 232,448 bytes of shared memory from MAOOAM 6x6/6x6
// (ndim 228: 448,000 bytes of records and 233,984 of state in double).
//
// What bounds it on the card: as the resident kernel, the latency of each
// warp's dependent chain of gathers and multiply-adds (4 x nnz entries a
// trajectory-step), with few warps an SM to hide it; device-memory bytes
// are small beside it.  The design keeps the resident kernel's records,
// mapping and arithmetic and moves what does not need to be on chip:
//   * the records stay in device memory, in the flat per-group lists of
//     qgs_tpu_torch.ops.fused_rk4.group_layout padded to tiles of 32
//     (streamed_records).  They are read-only and the same for every block,
//     so they stay in L2 (448 KB at ndim 228 in double).  Each warp streams
//     its own group's list through a ring of 4 tiles in shared memory,
//     refilled ahead of its walk by cp.async (stream_ring.cuh); every lane
//     reads the same record from the ring;
//   * only the two stage inputs xa / xb (n1 rows of 32 lanes), which every
//     warp gathers from at data-dependent rows, stay in shared memory.  y
//     and the RK4 accumulator go to a scratch array in device memory laid
//     out [block][variable][lane]: warp w reads and writes only its own
//     rows there, 32 lanes of one row at a time (coalesced), and reads a
//     row's y / accumulator when the row starts, so the L2 round trip
//     overlaps the row's chunks.  Shared memory is then 2 n1 32
//     sizeof(T) bytes plus the rings: double reaches ndim 421, float 843;
//   * past that, the single-buffer variant (rk4_streamed_kernel_1buf)
//     keeps only xa on chip: a row's next stage input goes to a third slot
//     of the scratch, xn, in the same layout (32 lanes of a row at a time),
//     and after the stage's barrier the block copies xn into xa and syncs
//     again (OneBuffer, OneBufferWarp).  n1 32 sizeof(T) bytes plus the
//     rings: double reaches ndim 843 (the qgs atmosphere's 12x12 channel,
//     ndim 600, takes 170,240 bytes), float 1687.  The copy is n 32
//     sizeof(T) bytes a block a stage (154 KB at ndim 600 in double, from
//     L2), and every row's sum and combine are the two-buffer kernel's, so
//     the two give the same bits wherever both run.  It takes no cluster;
//   * the rest is K1's design (rk4_common.cuh): a block of 32 trajectories
//     with G warps (G in 1, 2, 4, 8), warp w walking group w's rows; chunks
//     of two entries of one row into two partial sums; the row's sum
//     combined at its last chunk into the accumulator and the next stage
//     input (one barrier a stage); the step loop.  The chunk loop issues
//     the current chunk's gathers before the ring's read of the next chunk
//     (which may wait for a tile).  Each row's sum, and the RK4 combine,
//     are the resident kernel's expressions in its order, so the two
//     kernels give the same bits wherever both run.
//
// One block an SM in float64 from ndim 228 (133,632 bytes), so ceil(B / 32)
// blocks leave SMs idle below B = 32 x the card's SMs (B = 1024: 32 blocks
// on the H100's 132 SMs), each as slow as on a full card.  There a launch
// may take C > 1 (rk4_streamed_kernel<T, C>, C in 2 .. 8): a thread-block
// cluster of C blocks a set of 32 trajectories, each block with its G
// warps walking groups rank * G .. rank * G + G - 1 of a layout of C * G
// groups, so each block walks about 1 / C of the entries.  Every block
// keeps its own whole xa / xb, so every gather stays local; a row's next
// stage input goes into all C copies (its own, and the others' through
// distributed shared memory: mapa + st.shared::cluster, 32 lanes of 8 or 4
// bytes), and the stage barrier is the cluster's (release / acquire).  The
// cluster's y and accumulator stay in the scratch as without one, each
// block touching only its own rows' (its initial rows of sy are written
// by the block of the row's rank, before the first barrier); a block
// writes the records and final state of its rank's rows from its xa.
// Each row is still summed by one warp over the same chunks in the same
// order, so every C gives the same bits.  C = 1 is the kernel without a
// cluster (no attribute, OneBlock's hooks).  The wrapper picks C from the
// batch and cudaOccupancyMaxActiveClusters
// (qgs_tpu_torch.ops.fused_rk4.pick_cluster): on an H100 at B = 1024 in
// float64, C = 3 (the card holds 39 clusters of 3 and 30 of 4), 2.93 times
// faster than C = 1 (PERF.md, Findings).
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_streamed_f32 / qgs_rk4_streamed_f64(recs, lengths, groups,
//       width, n1, y, B, dts, n_steps, write_every, records, scratch,
//       cluster, stream) -> cudaError_t
//   recs (groups, width) 16-byte records {j | k << 16, row | last-chunk
//       flag, value} (a float value in the third word, the fourth 0);
//       width a multiple of 32, zero records past each group's length;
//   lengths (groups) int32: records of each group, a multiple of 2, at
//       most width - 2;
//   y (B, n) T, in/out, n = n1 - 1; dts (n_steps) double;
//   records (n_steps / write_every, B, n) T: the state after every
//       write_every steps (none when write_every == 0);
//   scratch (ceil(B / 32), 2, n, 32) T: y and the accumulator;
//   cluster: C, the blocks of a set, each of groups / C warps (1 .. 8).
//   qgs_rk4_streamed_1buf_f32 / qgs_rk4_streamed_1buf_f64(recs, lengths,
//       groups, width, n1, y, B, dts, n_steps, write_every, records,
//       scratch, stream): the single-buffer variant, the same arguments but
//       the cluster; scratch (ceil(B / 32), 3, n, 32) T: y, the
//       accumulator and the next stage input.
//   qgs_rk4_streamed_max_clusters(n1, groups, is_double, cluster): the
//       clusters of C blocks of groups warps the card holds at once.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "rk4_common.cuh"
#include "stream_ring.cuh"

namespace {

using namespace qgs_rk4;
using qgs_ring::Ring;

constexpr int kMaxCluster = 8;      // the portable cluster sizes

// The shared memory of a block: its warps' rings and `inputs` stage inputs
// (2; 1 in the single-buffer variant).
template <typename T>
__host__ __device__ size_t streamed_smem_bytes(int n1, int groups,
                                               int inputs = 2) {
  return qgs_ring::ring_bytes(groups) +
         sizeof(T) * (size_t)inputs * n1 * kLanes;
}

__device__ __forceinline__ void store_cluster(unsigned at, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" :: "r"(at), "d"(v)
               : "memory");
}
__device__ __forceinline__ void store_cluster(unsigned at, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(at), "f"(v)
               : "memory");
}

// The hooks (rk4_common.cuh) of a cluster of C blocks serving one set.
template <int C>
struct Cluster {
  static constexpr int kBlocks = C;
  static constexpr int kInputs = 2;
  static __device__ __forceinline__ int rank() { return blockIdx.x % C; }
  static __device__ __forceinline__ int tile() { return blockIdx.x / C; }
  // Every write before it (shared, remote or device memory) by any block
  // of the cluster is seen by every block after it.
  static __device__ __forceinline__ void sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  template <typename T>
  static __device__ __forceinline__ void put(T* x, int i, T v) {
    const unsigned at = qgs_ring::smem_addr(x + i);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      unsigned peer;
      asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(peer)
          : "r"(at), "r"(r));
      store_cluster(peer, v);
    }
  }
};

// A warp's ring of its group's records, and its set's y and accumulator in
// device memory.
template <typename T, typename B_>
struct Warp {
  using Block = B_;
  Ring& ring;
  int len;
  T* y;
  T* acc;
  int t;

  // One RK4 stage (the resident kernel's, records from the ring and y /
  // acc from device memory): the sums of the warp's rows at the stage input
  // x, each combined at its row's last chunk into acc and the next stage
  // input xo.  pa holds the row's y (STAGE < 3) or acc (STAGE 3), pb its
  // acc (STAGE 1, 2), read when the row starts.
  template <int STAGE>
  __device__ __forceinline__ void stage(const T* __restrict__ x,
                                        T* __restrict__ xo, T c_acc,
                                        T c_x) {
    if (len == 0) return;
    int4 ra, rb;
    ring.read(ra, rb);
    int jka = ra.x, ctla = ra.y, jkb = rb.x;
    T va = rec_value(ra, T(0)), vb = rec_value(rb, T(0));
    int o = (ctla & 0xffff) * kLanes + t;
    T pa = STAGE < 3 ? y[o] : acc[o];
    T pb = (STAGE == 1 || STAGE == 2) ? acc[o] : T(0);
    T s0 = T(0), s1 = T(0);
    for (int e = 0; e < len; e += kChunk) {
      const T xja = x[(jka & 0xffff) * kLanes + t];
      const T xka = x[(jka >> 16) * kLanes + t];
      const T xjb = x[(jkb & 0xffff) * kLanes + t];
      const T xkb = x[(jkb >> 16) * kLanes + t];
      int4 na, nb;                        // the next chunk, read ahead
      ring.read(na, nb);
      s0 += va * xja * xka;
      s1 += vb * xjb * xkb;
      if (ctla & kLast) {                 // the same for the whole warp
        combine<STAGE, Block>(o, s0 + s1, pa, pb, xo, y, acc, c_acc, c_x);
        s0 = T(0);
        s1 = T(0);
        // the next row's y / acc (past the list's end, row 0's: unused)
        o = (na.y & 0xffff) * kLanes + t;
        pa = STAGE < 3 ? y[o] : acc[o];
        pb = (STAGE == 1 || STAGE == 2) ? acc[o] : T(0);
      }
      jka = na.x; ctla = na.y; va = rec_value(na, T(0));
      jkb = nb.x; vb = rec_value(nb, T(0));
    }
    ring.end_walk();
  }
};

// The hooks of the single-buffer variant's block: a block of its own
// (OneBlock's) that keeps one stage input in shared memory.
struct OneBuffer : OneBlock {
  static constexpr int kInputs = 1;
};

// The single-buffer variant's warp: every stage reads the block's one
// stage input xa, and a row's next stage input goes to xn, the set's third
// slot of the scratch in device memory (row i + 1 of the stage input at row
// i of the slot, 32 lanes at a time); after the stage's barrier land()
// copies the slot into xa.  Whatever x and xo the step loop passes.
template <typename T>
struct OneBufferWarp : Warp<T, OneBuffer> {
  T* xa;      // [n1][lane], shared
  T* xn;      // [n][lane], device memory
  int n;

  template <int STAGE>
  __device__ __forceinline__ void stage(const T*, T*, T c_acc, T c_x) {
    // xn - kLanes lies in the accumulator's slot, just before xn: row
    // i + 1 of it is row i of xn
    Warp<T, OneBuffer>::template stage<STAGE>(xa, xn - kLanes, c_acc, c_x);
  }

  __device__ __forceinline__ void land() {
    const int groups = blockDim.x / kLanes;
    for (int i = threadIdx.x / kLanes; i < n; i += groups)
      xa[(i + 1) * kLanes + this->t] = xn[i * kLanes + this->t];
  }
};

// A block of the streamed kernel (Block: OneBlock, Cluster<C> or
// OneBuffer).
template <typename T, typename Block>
__device__ __forceinline__ void streamed(const int4* __restrict__ recs,
                                         const int* __restrict__ lengths,
                                         int width, int n1,
                                         T* __restrict__ y, int B,
                                         const double* __restrict__ dts,
                                         int n_steps, int write_every,
                                         T* __restrict__ records,
                                         T* __restrict__ scratch) {
  constexpr bool kOneBuffer = Block::kInputs == 1;
  constexpr int kScratchSlots = kOneBuffer ? 3 : 2;   // y, acc (, xn)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int n = n1 - 1;
  const int g = Block::rank() * groups + w;                  // its group

  int4* tiles = reinterpret_cast<int4*>(smem_raw);  // [warp][slot][record]
  T* xa = reinterpret_cast<T*>(
      tiles + groups * qgs_ring::kSlots * qgs_ring::kTile);  // [n1][lane]
  T* xb = kOneBuffer ? xa : xa + n1 * kLanes;                // [n1][lane]
  T* sy = scratch +
          (long long)Block::tile() * kScratchSlots * n * kLanes;  // [n][lane]
  T* acc = sy + n * kLanes;                                  // [n][lane]

  const int len = lengths[g];
  Ring ring(recs + (size_t)g * width, len,
            tiles + w * qgs_ring::kSlots * qgs_ring::kTile, t);
  load_state<Block>(y, B, n, sy, xa, xb);
  Block::sync();          // a cluster's: every block runs before any put
  if (len > 0) ring.start();

  Warp<T, Block> warp{ring, len, sy, acc, t};
  if constexpr (kOneBuffer) {
    OneBufferWarp<T> one{warp, xa, acc + n * kLanes, n};
    rk4_steps(one, xa, xb, sy, y, B, n, dts, n_steps, write_every, records);
  } else {
    rk4_steps(warp, xa, xb, sy, y, B, n, dts, n_steps, write_every, records);
  }
  if (len > 0) ring.drain();
  // No put follows the last stage's barrier, so a block of a cluster may
  // leave once past it: nothing writes its shared memory any more.
}

template <typename T, int C>
__global__ void __launch_bounds__(8 * kLanes)
rk4_streamed_kernel(const int4* __restrict__ recs,
                    const int* __restrict__ lengths, int width, int n1,
                    T* __restrict__ y, int B, const double* __restrict__ dts,
                    int n_steps, int write_every, T* __restrict__ records,
                    T* __restrict__ scratch) {
  streamed<T, std::conditional_t<C == 1, OneBlock, Cluster<C>>>(
      recs, lengths, width, n1, y, B, dts, n_steps, write_every, records,
      scratch);
}

// The single-buffer variant, a kernel of its own name in a device trace.
template <typename T>
__global__ void __launch_bounds__(8 * kLanes)
rk4_streamed_kernel_1buf(const int4* __restrict__ recs,
                         const int* __restrict__ lengths, int width, int n1,
                         T* __restrict__ y, int B,
                         const double* __restrict__ dts, int n_steps,
                         int write_every, T* __restrict__ records,
                         T* __restrict__ scratch) {
  streamed<T, OneBuffer>(recs, lengths, width, n1, y, B, dts, n_steps,
                         write_every, records, scratch);
}

// One launch at the cluster size `cluster` (C, from 1 to kMaxCluster).
template <typename T, int C = 1>
cudaError_t launch_streamed(int cluster, const void* recs,
                            const int* lengths, int groups, int width, int n1,
                            T* y, int B, const double* dts, int n_steps,
                            int write_every, T* records, T* scratch,
                            void* stream) {
  if constexpr (C < kMaxCluster) {
    if (cluster != C)
      return launch_streamed<T, C + 1>(cluster, recs, lengths, groups, width,
                                       n1, y, B, dts, n_steps, write_every,
                                       records, scratch, stream);
  }
  const int warps = groups / C;
  const bool valid = cluster == C && groups % C == 0 && warps >= 1 &&
                     warps <= 8 && width >= qgs_ring::kTile &&
                     width % qgs_ring::kTile == 0;
  return launch<C>(valid, rk4_streamed_kernel<T, C>,
                   streamed_smem_bytes<T>(n1, warps), warps, B, stream,
                   static_cast<const int4*>(recs), lengths, width, n1, y, B,
                   dts, n_steps, write_every, records, scratch);
}

// One launch of the single-buffer variant.
template <typename T>
cudaError_t launch_streamed_1buf(const void* recs, const int* lengths,
                                 int groups, int width, int n1, T* y, int B,
                                 const double* dts, int n_steps,
                                 int write_every, T* records, T* scratch,
                                 void* stream) {
  const bool valid = groups >= 1 && groups <= 8 &&
                     width >= qgs_ring::kTile &&
                     width % qgs_ring::kTile == 0;
  return launch(valid, rk4_streamed_kernel_1buf<T>,
                streamed_smem_bytes<T>(n1, groups, 1), groups, B, stream,
                static_cast<const int4*>(recs), lengths, width, n1, y, B,
                dts, n_steps, write_every, records, scratch);
}

// The clusters of C blocks of `groups` warps (their shared memory at n1)
// that the card holds at once (C = 1: the blocks; 0 where a block's shared
// memory is past the card's opt-in limit, which the launch refuses); minus
// the CUDA error.
template <typename T, int C = 1>
int max_clusters(int cluster, int n1, int groups) {
  if constexpr (C < kMaxCluster) {
    if (cluster != C) return max_clusters<T, C + 1>(cluster, n1, groups);
  }
  if (cluster != C || groups < 1 || groups > 8)
    return -(int)cudaErrorInvalidValue;
  const auto kernel = rk4_streamed_kernel<T, C>;
  const size_t smem = streamed_smem_bytes<T>(n1, groups);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  if (smem > (size_t)max_smem) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  if constexpr (C == 1) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &count, kernel, groups * kLanes, smem);
    count *= sms;
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(C);
    config.blockDim = dim3(groups * kLanes);
    config.dynamicSmemBytes = smem;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  }
  return err == cudaSuccess ? count : -(int)err;
}

}  // namespace

extern "C" {

int qgs_rk4_streamed_f32(const void* recs, const int* lengths, int groups,
                         int width, int n1, float* y, int B,
                         const double* dts, int n_steps, int write_every,
                         float* records, float* scratch, int cluster,
                         void* stream) {
  return (int)launch_streamed<float>(cluster, recs, lengths, groups, width,
                                     n1, y, B, dts, n_steps, write_every,
                                     records, scratch, stream);
}

int qgs_rk4_streamed_f64(const void* recs, const int* lengths, int groups,
                         int width, int n1, double* y, int B,
                         const double* dts, int n_steps, int write_every,
                         double* records, double* scratch, int cluster,
                         void* stream) {
  return (int)launch_streamed<double>(cluster, recs, lengths, groups, width,
                                      n1, y, B, dts, n_steps, write_every,
                                      records, scratch, stream);
}

int qgs_rk4_streamed_1buf_f32(const void* recs, const int* lengths,
                              int groups, int width, int n1, float* y, int B,
                              const double* dts, int n_steps,
                              int write_every, float* records,
                              float* scratch, void* stream) {
  return (int)launch_streamed_1buf<float>(recs, lengths, groups, width, n1,
                                          y, B, dts, n_steps, write_every,
                                          records, scratch, stream);
}

int qgs_rk4_streamed_1buf_f64(const void* recs, const int* lengths,
                              int groups, int width, int n1, double* y,
                              int B, const double* dts, int n_steps,
                              int write_every, double* records,
                              double* scratch, void* stream) {
  return (int)launch_streamed_1buf<double>(recs, lengths, groups, width, n1,
                                           y, B, dts, n_steps, write_every,
                                           records, scratch, stream);
}

// The shared memory a launch of the kernel needs (the wrapper's twin of
// this formula decides the route before any launch); the single-buffer
// variant's.
long long qgs_rk4_streamed_smem_bytes(int n1, int groups, int is_double) {
  return (long long)(is_double ? streamed_smem_bytes<double>(n1, groups)
                               : streamed_smem_bytes<float>(n1, groups));
}

long long qgs_rk4_streamed_1buf_smem_bytes(int n1, int groups,
                                           int is_double) {
  return (long long)(is_double ? streamed_smem_bytes<double>(n1, groups, 1)
                               : streamed_smem_bytes<float>(n1, groups, 1));
}

// The clusters of `cluster` blocks of `groups` warps that the card holds
// at once (cudaOccupancyMaxActiveClusters; cluster 1: the blocks; 0 where a
// block does not fit), for the wrapper's choice of C; minus the CUDA error
// on failure.
int qgs_rk4_streamed_max_clusters(int n1, int groups, int is_double,
                                  int cluster) {
  return is_double ? max_clusters<double>(cluster, n1, groups)
                   : max_clusters<float>(cluster, n1, groups);
}

}  // extern "C"
