// Fused classical RK4 integration of a batch of trajectories of a sparse
// polynomial tendency, the whole of a tensor's records and the state in one
// block's shared memory (the resident kernel): one kernel template over the
// entry's term, three instantiations.
//   * K1, the quadratic tendency  f_i = sum_e v_e * xx[j_e] * xx[k_e],
//     xx = [1, y].  Replaces the TPU kernel make_pallas_rk4_f32
//     (qgs_tpu/ops/pallas_kernels.py:210).  An index word holds j | k << 16.
//   * K5, the quartic (rank-5) tendency
//     f_i = sum_e v_e * xx[j_e] * xx[k_e] * xx[l_e] * xx[m_e], the tendency
//     of qgs's dynamic-T and full quartic T4 radiation schemes (MAOOAM with
//     T4: ndim 38, 5,331 entries, 4,935 of them quartic).  Replaces no TPU
//     kernel: the JAX package's Pallas kernels take rank 3 only.  An index
//     word holds j | k << 8 | l << 16 | m << 24 (n1 <= 256), unpacked by
//     __byte_perm, each index one instruction off the record, and the
//     product is formed as (v*a*b)*(c*d), so its dependent chain is three
//     operations deep, not four.
//   * K5 over pair products (the paired layout): the same quartic tendency
//     with each entry's nonzero indices paired, K1's two-index record over
//     the extended stage input xx' = [1, y, p_1..p_P], p_q = x[a_q]*x[b_q]
//     for the P distinct pairs the quartic entries need.  A quartic entry
//     is v * p * p', a cubic one v * x * p, a quadratic one v * x * x (as
//     K1), as (v * a) * b.  After each stage's barrier the block's warps
//     split the pair table, each lane writing its products into the rows
//     n1 .. n1 + P - 1 of the stage input; a second barrier, then the chunk
//     loop as K1's.  An entry then costs one record read and two gathers,
//     not four.  The launch plan picks the layout
//     (qgs_tpu_torch.ops.fused_rk4_quartic.paired_pays).
// n_steps RK4 steps of a batch in one launch, in float (tendencies built
// with dtype=torch.float32) or double (the default float64 tier; the card
// has native f64).
//
// What bounds it on the card: not device-memory bytes -- device memory sees
// only the records, the initial state, the recorded states and the final
// state.  Each RK4 step is 4 x nnz gather-multiply-adds per trajectory
// (MAOOAM: 4 x 351).  One thread that walks all of a trajectory's entries in
// series is bound by the latency of that dependent chain (about 85 cycles
// an entry on the H100), with too few warps on an SM to hide it; K1's design
// (rk4_common.cuh) gives each of G warps 1/G of the chain.  K5's entry costs
// one broadcast record read and four gathers of 32 lanes (256 bytes each in
// float64, two wavefronts), about 9 shared-memory wavefronts of the SM's
// one a clock: on an H100 at B = 4096 T4 takes 122 us a step at G = 16,
// about 1.25 times that floor, and 162 us at G = 8 (more warps hide the
// gathers' latency better).  The paired layout's entry costs about 5 (T4:
// 111 pairs, 27.5k wavefronts a stage against 48.2k): 72 us a step at
// G = 16, 1.30 times its floor.  The design beyond rk4_common.cuh's: the block
// copies the records into shared memory once, and each group's chunk loop
// loads the next chunk's records before the current chunk's terms.
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_fused_f32 / qgs_rk4_fused_f64 (K1), qgs_rk4_quartic_f32 /
//       qgs_rk4_quartic_f64 (K5)(recs, lengths, groups, width, n1, y, B,
//       dts, n_steps, write_every, records, stream) -> cudaError_t
//   qgs_rk4_paired_f32 / qgs_rk4_paired_f64 (K5's paired layout)(the same,
//       then pairs, n_pairs, before stream)
//   recs (groups, width, 4) int32: the 16-byte records of
//       qgs_tpu_torch.ops.fused_rk4.resident_records (K1),
//       qgs_tpu_torch.ops.fused_rk4_quartic.quartic_records (K5) or
//       qgs_tpu_torch.ops.fused_rk4_quartic.paired_records (paired), zero
//       records past each group's length, and at least one chunk of them;
//   pairs (n_pairs) int32: pair q's indices a | b << 16 (1 <= a, b < n1),
//       its product row n1 + q of the extended stage input;
//   lengths (groups) int32: records of each group, a multiple of 2;
//   y (B, n) T, in/out, n = n1 - 1; dts (n_steps) double;
//   records (n_steps / write_every, B, n) T: the state after every
//       write_every steps (none when write_every == 0).

#include <cuda_runtime.h>
#include <cstdint>

#include "rk4_common.cuh"

namespace {

using namespace qgs_rk4;

// v * xx[j] * xx[k] of lane t (xt = x + t).
struct Quadratic {
  static constexpr int kMaxGroups = 8;
  static constexpr int kMaxN1 = 1 << 15;   // j and k in 16 bits
  static constexpr bool kPairs = false;
  template <typename T>
  static __device__ __forceinline__ T term(const T* __restrict__ xt,
                                           unsigned idx, T v) {
    return v * xt[(idx & 0xffff) * kLanes] * xt[(idx >> 16) * kLanes];
  }
};

// v * xx[j] * xx[k] * xx[l] * xx[m] of lane t, as (v*a*b)*(c*d).
struct Quartic {
  static constexpr int kMaxGroups = 16;
  static constexpr int kMaxN1 = 256;       // an index is 8 bits
  static constexpr bool kPairs = false;
  template <typename T>
  static __device__ __forceinline__ T term(const T* __restrict__ xt,
                                           unsigned idx, T v) {
    const T a = xt[__byte_perm(idx, 0, 0x4440) * kLanes];
    const T b = xt[__byte_perm(idx, 0, 0x4441) * kLanes];
    const T c = xt[__byte_perm(idx, 0, 0x4442) * kLanes];
    const T d = xt[__byte_perm(idx, 0, 0x4443) * kLanes];
    return (v * a * b) * (c * d);
  }
};

// v * xx'[a] * xx'[b] of lane t over the extended stage input (K1's term
// under K5's 16 warps), the products of the pair table formed once a stage
// (PairedWarp).
struct Paired : Quadratic {
  static constexpr int kMaxGroups = Quartic::kMaxGroups;
  static constexpr int kMaxN1 = Quartic::kMaxN1;
  static constexpr int kMaxRows = Quadratic::kMaxN1;  // n1 + P, a and b
  static constexpr bool kPairs = true;
};

template <typename T>
__host__ __device__ size_t smem_bytes(int n1, int groups, int width) {
  const int n = n1 - 1;
  return sizeof(int4) * (size_t)groups * width +
         sizeof(T) * (size_t)(2 * n + 2 * n1) * kLanes;
}

// The paired layout's: each stage input n1 + n_pairs rows, then the pair
// table.
template <typename T>
__host__ __device__ size_t paired_smem_bytes(int n1, int n_pairs, int groups,
                                             int width) {
  return smem_bytes<T>(n1, groups, width) +
         sizeof(T) * (size_t)2 * n_pairs * kLanes +
         sizeof(int) * (size_t)n_pairs;
}

// One broadcast LDS.128 of record e: its packed indices, control word and
// value.
template <typename T>
__device__ __forceinline__ void load_rec(const int4* rec, int e,
                                         unsigned& idx, int& ctl, T& v) {
  const int4 raw = rec[e];
  idx = (unsigned)raw.x;
  ctl = raw.y;
  v = rec_value(raw, T(0));
}

// A warp's group of records in shared memory, and the block's y and
// accumulator.
template <typename Term, typename T>
struct Warp {
  using Block = OneBlock;
  const int4* rec;
  int len;
  T* y;
  T* acc;
  int t;

  // One RK4 stage: the sums of the warp's rows at the stage input x, each
  // combined at its row's last chunk into acc and the next stage input xo.
  template <int STAGE>
  __device__ __forceinline__ void stage(const T* __restrict__ x,
                                        T* __restrict__ xo, T c_acc,
                                        T c_x) {
    const T* xt = x + t;
    unsigned ia, ib;
    int ctla, ctlb;
    T va, vb;
    load_rec(rec, 0, ia, ctla, va);
    load_rec(rec, 1, ib, ctlb, vb);
    T s0 = T(0), s1 = T(0);
    for (int e = 0; e < len; e += kChunk) {
      unsigned ian, ibn;                  // the next chunk, read ahead
      int ctlan, ctlbn;
      T van, vbn;
      load_rec(rec, e + kChunk, ian, ctlan, van);
      load_rec(rec, e + kChunk + 1, ibn, ctlbn, vbn);
      s0 += Term::term(xt, ia, va);
      s1 += Term::term(xt, ib, vb);
      if (ctla & kLast) {                 // the same for the whole warp
        const int o = (ctla & 0xffff) * kLanes + t;
        combine<STAGE, Block>(o, s0 + s1, STAGE < 3 ? y[o] : acc[o],
                              (STAGE == 1 || STAGE == 2) ? acc[o] : T(0),
                              xo, y, acc, c_acc, c_x);
        s0 = T(0);
        s1 = T(0);
      }
      ia = ian; ctla = ctlan; va = van;
      ib = ibn; ctlb = ctlbn; vb = vbn;
    }
  }
};

// The paired layout's warp: before each stage's chunk loop the block forms
// the products of the stage input x into its rows n1 + q (warp w the pairs
// q = w, w + G, ...), behind a barrier.  The stage's barrier before it
// (or the state's load) made x complete, and every read of the products
// of the previous stage input is done by then.
template <typename T>
struct PairedWarp : Warp<Paired, T> {
  const int* pair;   // the pair table in shared memory, a | b << 16
  int n_pairs;
  int n1;

  template <int STAGE>
  __device__ __forceinline__ void stage(const T* x, T* __restrict__ xo,
                                        T c_acc, T c_x) {
    const int groups = blockDim.x / kLanes;
    T* xt = const_cast<T*>(x) + this->t;
    T* pt = xt + n1 * kLanes;
#pragma unroll 4
    for (int q = threadIdx.x / kLanes; q < n_pairs; q += groups) {
      const unsigned ab = (unsigned)pair[q];
      pt[q * kLanes] = xt[(ab & 0xffff) * kLanes] * xt[(ab >> 16) * kLanes];
    }
    __syncthreads();
    Warp<Paired, T>::template stage<STAGE>(x, xo, c_acc, c_x);
  }
};

template <typename Term, typename T>
__device__ __forceinline__ void resident(const int4* __restrict__ recs,
                                         const int* __restrict__ lengths,
                                         int width, int n1,
                                         T* __restrict__ y, int B,
                                         const double* __restrict__ dts,
                                         int n_steps, int write_every,
                                         T* __restrict__ records,
                                         const int* __restrict__ pairs =
                                             nullptr,
                                         int n_pairs = 0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int n = n1 - 1;

  int4* rec = reinterpret_cast<int4*>(smem_raw);
  T* sy = reinterpret_cast<T*>(rec + groups * width);   // [n][lane]
  T* acc = sy + n * kLanes;                             // [n][lane]
  T* xa = acc + n * kLanes;                             // [n1][lane]
  T* xb = xa + n1 * kLanes;                             // [n1][lane]
  if constexpr (Term::kPairs) xb += n_pairs * kLanes;   // [n1 + P][lane]

  for (int e = threadIdx.x; e < groups * width; e += blockDim.x)
    rec[e] = recs[e];
  load_state<OneBlock>(y, B, n, sy, xa, xb);

  if constexpr (Term::kPairs) {
    int* pair = reinterpret_cast<int*>(xb + (n1 + n_pairs) * kLanes);
    for (int q = threadIdx.x; q < n_pairs; q += blockDim.x)
      pair[q] = pairs[q];
    __syncthreads();
    PairedWarp<T> warp{{rec + w * width, lengths[w], sy, acc,
                        (int)(threadIdx.x % kLanes)},
                       pair, n_pairs, n1};
    rk4_steps(warp, xa, xb, sy, y, B, n, dts, n_steps, write_every,
              records);
  } else {
    __syncthreads();
    Warp<Term, T> warp{rec + w * width, lengths[w], sy, acc,
                       (int)(threadIdx.x % kLanes)};
    rk4_steps(warp, xa, xb, sy, y, B, n, dts, n_steps, write_every,
              records);
  }
}

// One kernel a term, each with its own register budget (K1's launch bounds
// are its 8 warps, K5's its 16) and its own name in a device trace.
template <typename T>
__global__ void __launch_bounds__(Quadratic::kMaxGroups * kLanes)
rk4_fused_kernel(const int4* __restrict__ recs,
                 const int* __restrict__ lengths, int width, int n1,
                 T* __restrict__ y, int B, const double* __restrict__ dts,
                 int n_steps, int write_every, T* __restrict__ records) {
  resident<Quadratic>(recs, lengths, width, n1, y, B, dts, n_steps,
                      write_every, records);
}

template <typename T>
__global__ void __launch_bounds__(Quartic::kMaxGroups * kLanes)
rk4_quartic_kernel(const int4* __restrict__ recs,
                   const int* __restrict__ lengths, int width, int n1,
                   T* __restrict__ y, int B, const double* __restrict__ dts,
                   int n_steps, int write_every, T* __restrict__ records) {
  resident<Quartic>(recs, lengths, width, n1, y, B, dts, n_steps,
                    write_every, records);
}

template <typename T>
__global__ void __launch_bounds__(Paired::kMaxGroups * kLanes)
rk4_paired_kernel(const int4* __restrict__ recs,
                  const int* __restrict__ lengths, int width, int n1,
                  T* __restrict__ y, int B, const double* __restrict__ dts,
                  int n_steps, int write_every, T* __restrict__ records,
                  const int* __restrict__ pairs, int n_pairs) {
  resident<Paired>(recs, lengths, width, n1, y, B, dts, n_steps,
                   write_every, records, pairs, n_pairs);
}

template <typename Term, typename T>
cudaError_t launch_resident(void (*kernel)(const int4*, const int*, int, int,
                                           T*, int, const double*, int, int,
                                           T*),
                            const void* recs, const int* lengths, int groups,
                            int width, int n1, T* y, int B, const double* dts,
                            int n_steps, int write_every, T* records,
                            void* stream) {
  const bool valid = groups >= 1 && groups <= Term::kMaxGroups &&
                     width >= kChunk && width % kChunk == 0 && n1 >= 2 &&
                     n1 <= Term::kMaxN1 &&
                     reinterpret_cast<uintptr_t>(recs) % sizeof(int4) == 0;
  return launch(valid, kernel, smem_bytes<T>(n1, groups, width), groups, B,
                stream, static_cast<const int4*>(recs), lengths, width, n1,
                y, B, dts, n_steps, write_every, records);
}

template <typename T>
cudaError_t launch_paired(const void* recs, const int* lengths, int groups,
                          int width, int n1, T* y, int B, const double* dts,
                          int n_steps, int write_every, T* records,
                          const int* pairs, int n_pairs, void* stream) {
  const bool valid = groups >= 1 && groups <= Paired::kMaxGroups &&
                     width >= kChunk && width % kChunk == 0 && n1 >= 2 &&
                     n1 <= Paired::kMaxN1 && n_pairs >= 0 &&
                     n1 + n_pairs <= Paired::kMaxRows &&
                     (n_pairs == 0 || pairs != nullptr) &&
                     reinterpret_cast<uintptr_t>(recs) % sizeof(int4) == 0;
  return launch(valid, rk4_paired_kernel<T>,
                paired_smem_bytes<T>(n1, n_pairs, groups, width), groups, B,
                stream, static_cast<const int4*>(recs), lengths, width, n1,
                y, B, dts, n_steps, write_every, records, pairs, n_pairs);
}

}  // namespace

extern "C" {

int qgs_rk4_fused_f32(const void* recs, const int* lengths, int groups,
                      int width, int n1, float* y, int B, const double* dts,
                      int n_steps, int write_every, float* records,
                      void* stream) {
  return (int)launch_resident<Quadratic>(
      rk4_fused_kernel<float>, recs, lengths, groups, width, n1, y, B, dts,
      n_steps, write_every, records, stream);
}

int qgs_rk4_fused_f64(const void* recs, const int* lengths, int groups,
                      int width, int n1, double* y, int B, const double* dts,
                      int n_steps, int write_every, double* records,
                      void* stream) {
  return (int)launch_resident<Quadratic>(
      rk4_fused_kernel<double>, recs, lengths, groups, width, n1, y, B, dts,
      n_steps, write_every, records, stream);
}

int qgs_rk4_quartic_f32(const void* recs, const int* lengths, int groups,
                        int width, int n1, float* y, int B, const double* dts,
                        int n_steps, int write_every, float* records,
                        void* stream) {
  return (int)launch_resident<Quartic>(
      rk4_quartic_kernel<float>, recs, lengths, groups, width, n1, y, B, dts,
      n_steps, write_every, records, stream);
}

int qgs_rk4_quartic_f64(const void* recs, const int* lengths, int groups,
                        int width, int n1, double* y, int B,
                        const double* dts, int n_steps, int write_every,
                        double* records, void* stream) {
  return (int)launch_resident<Quartic>(
      rk4_quartic_kernel<double>, recs, lengths, groups, width, n1, y, B, dts,
      n_steps, write_every, records, stream);
}

int qgs_rk4_paired_f32(const void* recs, const int* lengths, int groups,
                       int width, int n1, float* y, int B, const double* dts,
                       int n_steps, int write_every, float* records,
                       const int* pairs, int n_pairs, void* stream) {
  return (int)launch_paired(recs, lengths, groups, width, n1, y, B, dts,
                            n_steps, write_every, records, pairs, n_pairs,
                            stream);
}

int qgs_rk4_paired_f64(const void* recs, const int* lengths, int groups,
                       int width, int n1, double* y, int B, const double* dts,
                       int n_steps, int write_every, double* records,
                       const int* pairs, int n_pairs, void* stream) {
  return (int)launch_paired(recs, lengths, groups, width, n1, y, B, dts,
                            n_steps, write_every, records, pairs, n_pairs,
                            stream);
}

const char* qgs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The shared memory a launch of the resident kernel needs (the wrapper's
// twin of this formula decides the route before any launch).
long long qgs_rk4_fused_smem_bytes(int n1, int groups, int width,
                                   int is_double) {
  return (long long)(is_double ? smem_bytes<double>(n1, groups, width)
                               : smem_bytes<float>(n1, groups, width));
}

// The same for the paired layout of n_pairs pairs.
long long qgs_rk4_paired_smem_bytes(int n1, int n_pairs, int groups,
                                    int width, int is_double) {
  return (long long)(is_double
                         ? paired_smem_bytes<double>(n1, n_pairs, groups,
                                                     width)
                         : paired_smem_bytes<float>(n1, n_pairs, groups,
                                                    width));
}

// The opt-in shared memory of one block on `device`, the limit every
// launcher holds its layouts to; minus the CUDA error on failure.
int qgs_max_smem_optin(int device) {
  int max_smem = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? max_smem : -(int)err;
}

}  // extern "C"
