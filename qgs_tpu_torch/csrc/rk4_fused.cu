// Fused classical RK4 integration of a batch of trajectories of the
// quadratic tendency  f_i = sum_e v_e * xx[j_e] * xx[k_e],  xx = [1, y].
//
// Replaces the TPU kernel make_pallas_rk4_f32
// (qgs_tpu/ops/pallas_kernels.py:210): n_steps RK4 steps of a batch in one
// launch, with the state kept on chip between steps.  One template serves
// float (tendencies built with dtype=torch.float32) and double (the default
// float64 tier; the card has native f64).
//
// What bounds it on the card: not device-memory bytes -- the state stays in
// shared memory for the whole run, and device memory sees only the initial
// state, the records and the final state.  Each RK4 step is 4 x nnz
// gather-multiply-adds per trajectory (MAOOAM: 4 x 351).  One thread that
// walks all of a trajectory's entries in series is bound by the latency of
// that dependent chain (about 85 cycles an entry on the H100), with too few
// warps on an SM to hide it.  The design:
//   * a block serves 32 trajectories with G warps (G in 1, 2, 4, 8); lane t
//     of every warp serves trajectory t.  The output rows are split into G
//     groups of about equal entry count (host side, longest row first), and
//     warp w walks only group w's entries: G times the warps an SM, each
//     with 1/G of the chain;
//   * the state lives in shared memory laid out [variable][lane], so the
//     data-dependent gathers xx[j], xx[k] of a warp fall on neighbouring
//     banks (no bank conflicts), and every lane of a warp reads the same
//     entry record (a broadcast);
//   * each group's entries are one flat list of 16-byte records {j | k<<16,
//     row | last-chunk flag, value}, one LDS.128 each, read in chunks of two
//     entries of one row (rows padded with zero entries to whole chunks)
//     into two independent partial sums, with the next chunk's records
//     loaded before the current chunk's multiply-adds;
//   * at a row's last chunk its sum goes straight into the RK4 accumulator
//     and the next stage's input (no k_i buffers).  Warp w writes only its
//     own rows; every warp reads all rows of the current stage input.  The
//     two stage inputs alternate (xa -> xb -> xa ...), so one barrier per
//     stage orders all of it: after it, every write of the stage's output
//     is visible, and every read of the buffer the next stage overwrites is
//     done.  Lanes past the end of a ragged last block run on a zero state
//     and reach every barrier; only their loads and stores are skipped.
// The RK4 combine follows qgs_tpu.integrators.rk.make_rk_step term by term:
// stage inputs y + (dt*a)*k, and y_new = (((y + (dt/6)k1) + (dt/3)k2) +
// (dt/3)k3) + (dt/6)k4, with dt = dts[s] cast to the state type; a row's
// entries are summed in another order than the plain version's.
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_fused_f32 / qgs_rk4_fused_f64(jk, ctl, vals, lengths, groups,
//       width, n1, y, B, dts, n_steps, write_every, records, stream)
//       -> cudaError_t
//   jk, ctl (groups, width) int32 and vals (groups, width) T: the group
//       tables of qgs_tpu_torch.ops.fused_rk4.group_layout (zero records
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

template <typename T>
struct __align__(16) Rec {
  int jk;     // j | k << 16
  int ctl;    // state row i (0-based) | kLast on the row's last chunk
  T v;
};
static_assert(sizeof(Rec<double>) == 16 && sizeof(Rec<float>) == 16,
              "an entry record is one 16-byte load");

__device__ __forceinline__ double rec_value(int4 raw, double) {
  return __hiloint2double(raw.w, raw.z);
}
__device__ __forceinline__ float rec_value(int4 raw, float) {
  return __int_as_float(raw.z);
}

// One broadcast LDS.128 of a record.
template <typename T>
__device__ __forceinline__ void load_rec(const Rec<T>* rec, int e, int& jk,
                                         int& ctl, T& v) {
  const int4 raw = reinterpret_cast<const int4*>(rec)[e];
  jk = raw.x;
  ctl = raw.y;
  v = rec_value(raw, T(0));
}

template <typename T>
__host__ __device__ size_t smem_bytes(int n1, int groups, int width) {
  const int n = n1 - 1;
  return sizeof(Rec<T>) * (size_t)groups * width +
         sizeof(T) * (size_t)(2 * n + 2 * n1) * kLanes;
}

// One RK4 stage of one warp: the sums k_i of the warp's rows at the stage
// input x, each combined at once into its row of acc and of the next stage
// input xo (row i of the state is row i + 1 of x and xo):
//   STAGE 0: acc = y + c_acc k;  xo = y + c_x k
//   STAGE 1, 2: acc += c_acc k;  xo = y + c_x k
//   STAGE 3: y = acc + c_acc k;  xo = y
template <int STAGE, typename T>
__device__ __forceinline__ void stage(const Rec<T>* __restrict__ rec,
                                      int len, const T* __restrict__ x,
                                      T* __restrict__ xo, T* __restrict__ y,
                                      T* __restrict__ acc, int t, T c_acc,
                                      T c_x) {
  int jka, ctla, jkb, ctlb;
  T va, vb;
  load_rec(rec, 0, jka, ctla, va);
  load_rec(rec, 1, jkb, ctlb, vb);
  T s0 = T(0), s1 = T(0);
  for (int e = 0; e < len; e += kChunk) {
    const T xja = x[(jka & 0xffff) * kLanes + t];
    const T xka = x[(jka >> 16) * kLanes + t];
    const T xjb = x[(jkb & 0xffff) * kLanes + t];
    const T xkb = x[(jkb >> 16) * kLanes + t];
    int jkan, ctlan, jkbn, ctlbn;         // the next chunk, read ahead
    T van, vbn;
    load_rec(rec, e + kChunk, jkan, ctlan, van);
    load_rec(rec, e + kChunk + 1, jkbn, ctlbn, vbn);
    s0 += va * xja * xka;
    s1 += vb * xjb * xkb;
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
    jka = jkan; ctla = ctlan; va = van;
    jkb = jkbn; ctlb = ctlbn; vb = vbn;
  }
}

template <typename T>
__global__ void __launch_bounds__(8 * kLanes)
rk4_fused_kernel(const int* __restrict__ jk, const int* __restrict__ ctl,
                 const T* __restrict__ vals, const int* __restrict__ lengths,
                 int width, int n1, T* __restrict__ y, int B,
                 const double* __restrict__ dts, int n_steps, int write_every,
                 T* __restrict__ records) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int n = n1 - 1;

  Rec<T>* rec = reinterpret_cast<Rec<T>*>(smem_raw);
  T* sy = reinterpret_cast<T*>(rec + groups * width);   // [n][lane]
  T* acc = sy + n * kLanes;                             // [n][lane]
  T* xa = acc + n * kLanes;                             // [n1][lane]
  T* xb = xa + n1 * kLanes;                             // [n1][lane]

  for (int e = threadIdx.x; e < groups * width; e += blockDim.x) {
    rec[e].jk = jk[e];
    rec[e].ctl = ctl[e];
    rec[e].v = vals[e];
  }
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

  const Rec<T>* mine = rec + w * width;
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
cudaError_t launch(const int* jk, const int* ctl, const T* vals,
                   const int* lengths, int groups, int width, int n1, T* y,
                   int B, const double* dts, int n_steps, int write_every,
                   T* records, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (groups < 1 || groups > 8 || width < kChunk || width % kChunk)
    return cudaErrorInvalidValue;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<T>(n1, groups, width);
  if (smem > (size_t)max_smem) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      rk4_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + kLanes - 1) / kLanes;
  rk4_fused_kernel<T><<<grid, groups * kLanes, smem, (cudaStream_t)stream>>>(
      jk, ctl, vals, lengths, width, n1, y, B, dts, n_steps, write_every,
      records);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qgs_rk4_fused_f32(const int* jk, const int* ctl, const float* vals,
                      const int* lengths, int groups, int width, int n1,
                      float* y, int B, const double* dts, int n_steps,
                      int write_every, float* records, void* stream) {
  return (int)launch<float>(jk, ctl, vals, lengths, groups, width, n1, y, B,
                            dts, n_steps, write_every, records, stream);
}

int qgs_rk4_fused_f64(const int* jk, const int* ctl, const double* vals,
                      const int* lengths, int groups, int width, int n1,
                      double* y, int B, const double* dts, int n_steps,
                      int write_every, double* records, void* stream) {
  return (int)launch<double>(jk, ctl, vals, lengths, groups, width, n1, y, B,
                             dts, n_steps, write_every, records, stream);
}

const char* qgs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The shared memory a launch of the kernel needs (the wrapper's twin of
// this formula decides the route before any launch).
long long qgs_rk4_fused_smem_bytes(int n1, int groups, int width,
                                   int is_double) {
  return (long long)(is_double ? smem_bytes<double>(n1, groups, width)
                               : smem_bytes<float>(n1, groups, width));
}

// The opt-in shared memory of one block on `device`, the limit both
// launchers hold their layouts to; minus the CUDA error on failure.
int qgs_max_smem_optin(int device) {
  int max_smem = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? max_smem : -(int)err;
}

}  // extern "C"
