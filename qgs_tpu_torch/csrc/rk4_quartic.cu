// Fused classical RK4 integration of a batch of trajectories of the
// quartic (rank-5) tendency
//   f_i = sum_e v_e * xx[j_e] * xx[k_e] * xx[l_e] * xx[m_e],  xx = [1, y],
// the tendency of qgs's dynamic-T and full quartic T4 radiation schemes
// (MAOOAM with T4: ndim 38, 5,331 entries, 4,935 of them quartic).
//
// Replaces no TPU kernel: the JAX package's Pallas kernels take rank 3 only,
// and it integrates rank 5 with plain array operations.  It was added
// because the port's plain step loop over the two-level contraction
// (ops/contraction.py) runs 86 device operations a step and moves about
// 12 GB of (B, chunks, C) float64 intermediates through device memory a
// step at B = 4096; this kernel runs n_steps RK4 steps in one launch, with
// the state and every stage's intermediates on chip.
//
// What bounds it on the card: shared-memory wavefronts.  Device memory
// sees only the initial state, the records and the final state.  An entry
// costs one broadcast record read and four gathers of 32 lanes (256 bytes
// each in float64, two wavefronts), about 9 wavefronts of the SM's one a
// clock, against four float64 operations on the SM's 64 float64 lanes: at
// 21,324 entry evaluations a trajectory-step (T4) a block of 32
// trajectories needs about 192k clocks a step.  On an H100 at B = 4096 (one
// block an SM) T4 takes 122 us a step at G = 16, about 1.25 times that
// floor, and 162 us at G = 8: more warps hide the gathers' latency better.
// The design is K1's (csrc/rk4_fused.cu), with its own code:
//   * a block serves 32 trajectories with G warps (G at most 16); lane t of
//     every warp serves trajectory t.  The output rows are split into G
//     groups of about equal entry count (host side, longest row first), and
//     warp w walks only group w's entries;
//   * the state lives in shared memory laid out [variable][lane], so a
//     gather xx[j] of a warp falls on neighbouring banks (no bank
//     conflicts), and every lane of a warp reads the same entry record (a
//     broadcast);
//   * a record is 16 bytes, one LDS.128: {j | k<<8 | l<<16 | m<<24, row |
//     last-chunk flag, value}.  The four 8-bit indices (n1 <= 256) are
//     unpacked by __byte_perm, each one instruction off the record, and the
//     product is formed as (v*a*b)*(c*d), so its dependent chain is three
//     operations deep, not four;
//   * a group's entries are read in chunks of two entries of one row (rows
//     padded with zero entries to whole chunks) into two independent
//     partial sums, with the next chunk's records loaded before the current
//     chunk's gathers are used;
//   * at a row's last chunk its sum goes straight into the RK4 accumulator
//     and the next stage's input (no k_i buffers).  The two stage inputs
//     alternate, so one barrier per stage orders all of it.  Lanes past the
//     end of a ragged last block run on a zero state and reach every
//     barrier; only their loads and stores are skipped.
// The RK4 combine follows qgs_tpu.integrators.rk.make_rk_step term by term:
// stage inputs y + (dt*a)*k, and y_new = (((y + (dt/6)k1) + (dt/3)k2) +
// (dt/3)k3) + (dt/6)k4, with dt = dts[s] cast to the state type; a row's
// entries are summed in another order than the plain version's.
//
// C interface (no PyTorch headers):
//   qgs_rk4_quartic_f32 / qgs_rk4_quartic_f64(recs, lengths, groups, width,
//       n1, y, B, dts, n_steps, write_every, records, stream) -> cudaError_t
//   recs (groups, width, 4) int32: the 16-byte records of
//       qgs_tpu_torch.ops.fused_rk4_quartic.quartic_records (zero records
//       past each group's length, and at least one chunk of them);
//   lengths (groups) int32: records of each group, a multiple of 2;
//   y (B, n) T, in/out, n = n1 - 1; dts (n_steps) double;
//   records (n_steps / write_every, B, n) T: the state after every
//       write_every steps (none when write_every == 0).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 32;        // trajectories a block, one a lane
constexpr int kChunk = 2;         // entries a chunk, one partial sum each
constexpr int kLast = 1 << 16;    // ctl flag: the chunk ends its row
constexpr int kMaxGroups = 16;    // warps a block, at most
constexpr int kMaxN1 = 256;       // an index is 8 bits

__device__ __forceinline__ double value_of(int4 raw, double) {
  return __hiloint2double(raw.w, raw.z);
}
__device__ __forceinline__ float value_of(int4 raw, float) {
  return __int_as_float(raw.z);
}

// One broadcast LDS.128 of record e: its packed indices, control word and
// value.
template <typename T>
__device__ __forceinline__ void load_rec(const int4* rec, int e,
                                         unsigned& idx, int& ctl, T& v) {
  const int4 raw = rec[e];
  idx = (unsigned)raw.x;
  ctl = raw.y;
  v = value_of(raw, T(0));
}

// v * xx[j] * xx[k] * xx[l] * xx[m] of lane t (xt = x + t), as (v*a*b)*(c*d).
template <typename T>
__device__ __forceinline__ T term(const T* __restrict__ xt, unsigned idx,
                                  T v) {
  const T a = xt[__byte_perm(idx, 0, 0x4440) * kLanes];
  const T b = xt[__byte_perm(idx, 0, 0x4441) * kLanes];
  const T c = xt[__byte_perm(idx, 0, 0x4442) * kLanes];
  const T d = xt[__byte_perm(idx, 0, 0x4443) * kLanes];
  return (v * a * b) * (c * d);
}

template <typename T>
__host__ __device__ size_t smem_bytes(int n1, int groups, int width) {
  const int n = n1 - 1;
  return sizeof(int4) * (size_t)groups * width +
         sizeof(T) * (size_t)(2 * n + 2 * n1) * kLanes;
}

// One RK4 stage of one warp: the sums k_i of the warp's rows at the stage
// input x, each combined at once into its row of acc and of the next stage
// input xo (row i of the state is row i + 1 of x and xo):
//   STAGE 0: acc = y + c_acc k;  xo = y + c_x k
//   STAGE 1, 2: acc += c_acc k;  xo = y + c_x k
//   STAGE 3: y = acc + c_acc k;  xo = y
template <int STAGE, typename T>
__device__ __forceinline__ void stage(const int4* __restrict__ rec, int len,
                                      const T* __restrict__ x,
                                      T* __restrict__ xo, T* __restrict__ y,
                                      T* __restrict__ acc, int t, T c_acc,
                                      T c_x) {
  const T* xt = x + t;
  unsigned ia, ib;
  int ctla, ctlb;
  T va, vb;
  load_rec(rec, 0, ia, ctla, va);
  load_rec(rec, 1, ib, ctlb, vb);
  T s0 = T(0), s1 = T(0);
  for (int e = 0; e < len; e += kChunk) {
    unsigned ian, ibn;                    // the next chunk, read ahead
    int ctlan, ctlbn;
    T van, vbn;
    load_rec(rec, e + kChunk, ian, ctlan, van);
    load_rec(rec, e + kChunk + 1, ibn, ctlbn, vbn);
    s0 += term(xt, ia, va);
    s1 += term(xt, ib, vb);
    if (ctla & kLast) {                   // the same for the whole warp
      const int o = (ctla & 0xffff) * kLanes + t;
      const T k = s0 + s1;
      if (STAGE == 0) {
        const T yi = y[o];
        acc[o] = yi + c_acc * k;
        xo[o + kLanes] = yi + c_x * k;
      } else if (STAGE < 3) {
        const T yi = y[o];
        acc[o] += c_acc * k;
        xo[o + kLanes] = yi + c_x * k;
      } else {
        const T yn = acc[o] + c_acc * k;
        y[o] = yn;
        xo[o + kLanes] = yn;
      }
      s0 = T(0);
      s1 = T(0);
    }
    ia = ian; ctla = ctlan; va = van;
    ib = ibn; ctlb = ctlbn; vb = vbn;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxGroups * kLanes)
rk4_quartic_kernel(const int4* __restrict__ recs,
                   const int* __restrict__ lengths, int width, int n1,
                   T* __restrict__ y, int B, const double* __restrict__ dts,
                   int n_steps, int write_every, T* __restrict__ records) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int n = n1 - 1;

  int4* rec = reinterpret_cast<int4*>(smem_raw);
  T* sy = reinterpret_cast<T*>(rec + groups * width);   // [n][lane]
  T* acc = sy + n * kLanes;                             // [n][lane]
  T* xa = acc + n * kLanes;                             // [n1][lane]
  T* xb = xa + n1 * kLanes;                             // [n1][lane]

  for (int e = threadIdx.x; e < groups * width; e += blockDim.x)
    rec[e] = recs[e];
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

  const int4* mine = rec + w * width;
  const int len = lengths[w];
  int rec_i = 0;
  for (int step = 0; step < n_steps; ++step) {
    const T dt = static_cast<T>(dts[step]);
    const T h = dt * T(0.5);                 // dt * a[1,0] = dt * a[2,1]
    const T w1 = dt * T(1.0 / 6.0);          // dt * b[0] = dt * b[3]
    const T w2 = dt * T(1.0 / 3.0);          // dt * b[1] = dt * b[2]

    stage<0>(mine, len, xa, xb, sy, acc, t, w1, h);     // k1
    __syncthreads();
    stage<1>(mine, len, xb, xa, sy, acc, t, w2, h);     // k2
    __syncthreads();
    stage<2>(mine, len, xa, xb, sy, acc, t, w2, dt);    // k3
    __syncthreads();
    stage<3>(mine, len, xb, xa, sy, acc, t, w1, T(0));  // k4 -> y, xa
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
}

template <typename T>
cudaError_t launch(const int* recs, const int* lengths, int groups,
                   int width, int n1, T* y, int B, const double* dts,
                   int n_steps, int write_every, T* records, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (groups < 1 || groups > kMaxGroups || width < kChunk ||
      width % kChunk || n1 < 2 || n1 > kMaxN1 ||
      (reinterpret_cast<uintptr_t>(recs) % sizeof(int4)))
    return cudaErrorInvalidValue;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<T>(n1, groups, width);
  if (smem > (size_t)max_smem) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      rk4_quartic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + kLanes - 1) / kLanes;
  rk4_quartic_kernel<T><<<grid, groups * kLanes, smem,
                          (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(recs), lengths, width, n1, y, B, dts,
      n_steps, write_every, records);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qgs_rk4_quartic_f32(const int* recs, const int* lengths, int groups,
                        int width, int n1, float* y, int B, const double* dts,
                        int n_steps, int write_every, float* records,
                        void* stream) {
  return (int)launch<float>(recs, lengths, groups, width, n1, y, B, dts,
                            n_steps, write_every, records, stream);
}

int qgs_rk4_quartic_f64(const int* recs, const int* lengths, int groups,
                        int width, int n1, double* y, int B,
                        const double* dts, int n_steps, int write_every,
                        double* records, void* stream) {
  return (int)launch<double>(recs, lengths, groups, width, n1, y, B, dts,
                             n_steps, write_every, records, stream);
}

// The shared memory a launch of the kernel needs (the wrapper's twin of
// this formula decides the route before any launch).
long long qgs_rk4_quartic_smem_bytes(int n1, int groups, int width,
                                     int is_double) {
  return (long long)(is_double ? smem_bytes<double>(n1, groups, width)
                               : smem_bytes<float>(n1, groups, width));
}

}  // extern "C"
