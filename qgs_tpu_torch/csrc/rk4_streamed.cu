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
//   * the rest is rk4_fused.cu's: a block of 32 trajectories with G warps
//     (G in 1, 2, 4, 8), warp w walking group w's rows; chunks of two
//     entries of one row into two partial sums, the next chunk's records
//     read before the current chunk's multiply-adds; the row's sum
//     combined at its last chunk into the accumulator and the next stage
//     input (one barrier a stage); lanes past a ragged last block run on a
//     zero state.  Each row's sum, and the RK4 combine, are the resident
//     kernel's expressions in its order, so the two kernels give the same
//     bits wherever both run.
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_streamed_f32 / qgs_rk4_streamed_f64(recs, lengths, groups,
//       width, n1, y, B, dts, n_steps, write_every, records, scratch,
//       stream) -> cudaError_t
//   recs (groups, width) 16-byte records {j | k << 16, row | last-chunk
//       flag, value} (a float value in the third word, the fourth 0);
//       width a multiple of 32, zero records past each group's length;
//   lengths (groups) int32: records of each group, a multiple of 2, at
//       most width - 2;
//   y (B, n) T, in/out, n = n1 - 1; dts (n_steps) double;
//   records (n_steps / write_every, B, n) T: the state after every
//       write_every steps (none when write_every == 0);
//   scratch (ceil(B / 32), 2, n, 32) T: y and the accumulator.

#include <cuda_runtime.h>
#include <cstdint>

#include "stream_ring.cuh"

namespace {

using qgs_ring::Ring;

constexpr int kLanes = 32;        // trajectories a block, one a lane
constexpr int kChunk = 2;         // entries a chunk, one partial sum each
constexpr int kLast = 1 << 16;    // ctl flag: the chunk ends its row

__device__ __forceinline__ double rec_value(int4 raw, double) {
  return __hiloint2double(raw.w, raw.z);
}
__device__ __forceinline__ float rec_value(int4 raw, float) {
  return __int_as_float(raw.z);
}

template <typename T>
__host__ __device__ size_t streamed_smem_bytes(int n1, int groups) {
  return qgs_ring::ring_bytes(groups) + sizeof(T) * (size_t)2 * n1 * kLanes;
}

// One RK4 stage of one warp (rk4_fused.cu's stage, records from the ring
// and y / acc from device memory): the sums k_i of the warp's rows at the
// stage input x, each combined at once into its row of acc and of the
// next stage input xo (row i of the state is row i + 1 of x and xo):
//   STAGE 0: acc = y + c_acc k;  xo = y + c_x k
//   STAGE 1, 2: acc += c_acc k;  xo = y + c_x k
//   STAGE 3: y = acc + c_acc k;  xo = y
// pa holds the row's y (STAGE < 3) or acc (STAGE 3), pb its acc (STAGE 1,
// 2), read when the row starts.
template <int STAGE, typename T>
__device__ __forceinline__ void stage(Ring& ring, int len,
                                      const T* __restrict__ x,
                                      T* __restrict__ xo, T* __restrict__ y,
                                      T* __restrict__ acc, int t, T c_acc,
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
    int4 na, nb;                          // the next chunk, read ahead
    ring.read(na, nb);
    s0 += va * xja * xka;
    s1 += vb * xjb * xkb;
    if (ctla & kLast) {                   // the same for the whole warp
      const T k = s0 + s1;
      if (STAGE == 0) {
        acc[o] = pa + c_acc * k;
        xo[o + kLanes] = pa + c_x * k;
      } else if (STAGE < 3) {
        acc[o] = pb + c_acc * k;
        xo[o + kLanes] = pa + c_x * k;
      } else {
        const T yn = pa + c_acc * k;
        y[o] = yn;
        xo[o + kLanes] = yn;
      }
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

template <typename T>
__global__ void __launch_bounds__(8 * kLanes)
rk4_streamed_kernel(const int4* __restrict__ recs,
                    const int* __restrict__ lengths, int width, int n1,
                    T* __restrict__ y, int B, const double* __restrict__ dts,
                    int n_steps, int write_every, T* __restrict__ records,
                    T* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int n = n1 - 1;

  int4* tiles = reinterpret_cast<int4*>(smem_raw);  // [group][slot][record]
  T* xa = reinterpret_cast<T*>(
      tiles + groups * qgs_ring::kSlots * qgs_ring::kTile);  // [n1][lane]
  T* xb = xa + n1 * kLanes;                                  // [n1][lane]
  T* sy = scratch + (long long)blockIdx.x * 2 * n * kLanes;  // [n][lane]
  T* acc = sy + n * kLanes;                                  // [n][lane]

  const int len = lengths[w];
  Ring ring(recs + (size_t)w * width, len,
            tiles + w * qgs_ring::kSlots * qgs_ring::kTile, t);
  const long long b = (long long)blockIdx.x * kLanes + t;
  const bool live = b < B;
  T* yb = y + b * n;
  for (int i = w; i < n; i += groups) {
    const T v = live ? yb[i] : T(0);
    sy[i * kLanes + t] = v;
    xa[(i + 1) * kLanes + t] = v;
  }
  if (w == 0) {
    xa[t] = T(1);
    xb[t] = T(1);
  }
  __syncthreads();
  if (len > 0) ring.start();

  int rec_i = 0;
  for (int step = 0; step < n_steps; ++step) {
    const T dt = static_cast<T>(dts[step]);
    const T h = dt * T(0.5);                 // dt * a[1,0] = dt * a[2,1]
    const T w1 = dt * T(1.0 / 6.0);          // dt * b[0] = dt * b[3]
    const T w2 = dt * T(1.0 / 3.0);          // dt * b[1] = dt * b[2]

    stage<0>(ring, len, xa, xb, sy, acc, t, w1, h);     // k1
    __syncthreads();
    stage<1>(ring, len, xb, xa, sy, acc, t, w2, h);     // k2
    __syncthreads();
    stage<2>(ring, len, xa, xb, sy, acc, t, w2, dt);    // k3
    __syncthreads();
    stage<3>(ring, len, xb, xa, sy, acc, t, w1, T(0));  // k4 -> y, xa
    __syncthreads();

    if (write_every > 0 && (step + 1) % write_every == 0) {
      if (live) {
        T* out = records + ((long long)rec_i * B + b) * n;
        for (int i = w; i < n; i += groups) out[i] = sy[i * kLanes + t];
      }
      ++rec_i;
    }
  }
  if (live)
    for (int i = w; i < n; i += groups) yb[i] = sy[i * kLanes + t];
  if (len > 0) ring.drain();
}

template <typename T>
cudaError_t launch(const void* recs, const int* lengths, int groups,
                   int width, int n1, T* y, int B, const double* dts,
                   int n_steps, int write_every, T* records, T* scratch,
                   void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (groups < 1 || groups > 8 || width < qgs_ring::kTile ||
      width % qgs_ring::kTile)
    return cudaErrorInvalidValue;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem = streamed_smem_bytes<T>(n1, groups);
  if (smem > (size_t)max_smem) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(rk4_streamed_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + kLanes - 1) / kLanes;
  rk4_streamed_kernel<T><<<grid, groups * kLanes, smem,
                           (cudaStream_t)stream>>>(
      static_cast<const int4*>(recs), lengths, width, n1, y, B, dts, n_steps,
      write_every, records, scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qgs_rk4_streamed_f32(const void* recs, const int* lengths, int groups,
                         int width, int n1, float* y, int B,
                         const double* dts, int n_steps, int write_every,
                         float* records, float* scratch, void* stream) {
  return (int)launch<float>(recs, lengths, groups, width, n1, y, B, dts,
                            n_steps, write_every, records, scratch, stream);
}

int qgs_rk4_streamed_f64(const void* recs, const int* lengths, int groups,
                         int width, int n1, double* y, int B,
                         const double* dts, int n_steps, int write_every,
                         double* records, double* scratch,
                         void* stream) {
  return (int)launch<double>(recs, lengths, groups, width, n1, y, B, dts,
                             n_steps, write_every, records, scratch, stream);
}

// The shared memory a launch of the kernel needs (the wrapper's twin of
// this formula decides the route before any launch).
long long qgs_rk4_streamed_smem_bytes(int n1, int groups, int is_double) {
  return (long long)(is_double ? streamed_smem_bytes<double>(n1, groups)
                               : streamed_smem_bytes<float>(n1, groups));
}

}  // extern "C"
