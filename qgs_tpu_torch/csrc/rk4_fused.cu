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
// gather-multiply-adds per trajectory (MAOOAM: 4 x 351), so the bound is
// the rate at which the SM issues the two shared-memory gathers and the
// dependent (f64) FMA of each entry.  What the design does about it:
//   * one thread per trajectory; every thread of a block walks the same
//     row-sorted entry list, held once per block in shared memory, so each
//     entry read is a broadcast (one wavefront for the warp);
//   * the per-thread state lives in shared memory laid out [variable][thread]
//     so the data-dependent gathers xx[j], xx[k] of a warp fall on
//     neighbouring banks (no bank conflicts);
//   * each row's sum stays in a register and is combined straight into the
//     RK4 accumulator and the next stage's input: no k_i buffers, and the
//     only barrier is the one after the entry load.
// The RK4 combine follows qgs_tpu.integrators.rk.make_rk_step term by term:
// stage inputs y + (dt*a)*k, and y_new = (((y + (dt/6)k1) + (dt/3)k2) +
// (dt/3)k3) + (dt/6)k4, with dt = dts[s] cast to the state type.
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_fused_f32 / qgs_rk4_fused_f64(row_ptr, jk, vals, n1, nnz,
//       y, B, dts, n_steps, write_every, records, stream) -> cudaError_t
//   row_ptr (n1 + 1) int32: CSR offsets of output rows 0..n1-1 (row 0,
//       the dummy, is empty); jk (nnz) int32: j | (k << 16); vals (nnz) T;
//   y (B, n) T, in/out, n = n1 - 1; dts (n_steps) double;
//   records (n_steps / write_every, B, n) T: the state after every
//       write_every steps (none when write_every == 0).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
struct Smem {
  T* vals;     // [nnz]
  T* y;        // [n][bt]   state at the start of the step
  T* acc;      // [n][bt]   RK4 accumulator y_new
  T* xa;       // [n1][bt]  stage input, xx[0] == 1
  T* xb;       // [n1][bt]  the other stage input
  int* jk;     // [nnz]
  int* row_ptr;  // [n1 + 1]
};

template <typename T>
__host__ __device__ size_t smem_bytes(int n1, int nnz, int bt) {
  const int n = n1 - 1;
  return sizeof(T) * ((size_t)nnz + (size_t)(2 * n + 2 * n1) * bt) +
         sizeof(int) * ((size_t)nnz + n1 + 1);
}

// Sum of row r of the tendency at stage input x (column tid of [var][thread]).
template <typename T>
__device__ __forceinline__ T row_sum(const Smem<T>& s, const T* x, int r,
                                     int tid, int bt) {
  T sum = T(0);
  const int e1 = s.row_ptr[r + 1];
  for (int e = s.row_ptr[r]; e < e1; ++e) {
    const int jk = s.jk[e];
    const T xj = x[(jk & 0xffff) * bt + tid];
    const T xk = x[(jk >> 16) * bt + tid];
    sum += s.vals[e] * xj * xk;
  }
  return sum;
}

template <typename T>
__global__ void rk4_fused_kernel(const int* __restrict__ row_ptr,
                                 const int* __restrict__ jk,
                                 const T* __restrict__ vals, int n1, int nnz,
                                 T* __restrict__ y, int B,
                                 const double* __restrict__ dts, int n_steps,
                                 int write_every, T* __restrict__ records) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bt = blockDim.x;
  const int tid = threadIdx.x;
  const int n = n1 - 1;

  Smem<T> s;
  s.vals = reinterpret_cast<T*>(smem_raw);
  s.y = s.vals + nnz;
  s.acc = s.y + n * bt;
  s.xa = s.acc + n * bt;
  s.xb = s.xa + n1 * bt;
  s.jk = reinterpret_cast<int*>(s.xb + n1 * bt);
  s.row_ptr = s.jk + nnz;

  for (int e = tid; e < nnz; e += bt) {
    s.vals[e] = vals[e];
    s.jk[e] = jk[e];
  }
  for (int r = tid; r <= n1; r += bt) s.row_ptr[r] = row_ptr[r];
  // The only barrier: every thread, masked or not, reaches it.  After it each
  // thread touches only its own column of the state arrays.
  __syncthreads();

  const long long b = (long long)blockIdx.x * bt + tid;
  if (b >= B) return;

  T* yb = y + b * n;
  s.xa[tid] = T(1);
  s.xb[tid] = T(1);
  for (int i = 0; i < n; ++i) {
    const T v = yb[i];
    s.y[i * bt + tid] = v;
    s.xa[(i + 1) * bt + tid] = v;
  }

  int rec = 0;
  for (int step = 0; step < n_steps; ++step) {
    const T dt = static_cast<T>(dts[step]);
    const T h = dt * T(0.5);                 // dt * a[1,0] = dt * a[2,1]
    const T w1 = dt * T(1.0 / 6.0);          // dt * b[0] = dt * b[3]
    const T w2 = dt * T(1.0 / 3.0);          // dt * b[1] = dt * b[2]

    // stage 1: k1 = f(xa);  acc = y + w1 k1;  xb = y + h k1
    for (int r = 1; r < n1; ++r) {
      const T k = row_sum(s, s.xa, r, tid, bt);
      const T yi = s.y[(r - 1) * bt + tid];
      s.acc[(r - 1) * bt + tid] = yi + w1 * k;
      s.xb[r * bt + tid] = yi + h * k;
    }
    // stage 2: k2 = f(xb);  acc += w2 k2;  xa = y + h k2
    for (int r = 1; r < n1; ++r) {
      const T k = row_sum(s, s.xb, r, tid, bt);
      const T yi = s.y[(r - 1) * bt + tid];
      s.acc[(r - 1) * bt + tid] += w2 * k;
      s.xa[r * bt + tid] = yi + h * k;
    }
    // stage 3: k3 = f(xa);  acc += w2 k3;  xb = y + dt k3
    for (int r = 1; r < n1; ++r) {
      const T k = row_sum(s, s.xa, r, tid, bt);
      const T yi = s.y[(r - 1) * bt + tid];
      s.acc[(r - 1) * bt + tid] += w2 * k;
      s.xb[r * bt + tid] = yi + dt * k;
    }
    // stage 4: k4 = f(xb);  y = acc + w1 k4;  xa = y (next step's stage 1)
    for (int r = 1; r < n1; ++r) {
      const T k = row_sum(s, s.xb, r, tid, bt);
      const T yn = s.acc[(r - 1) * bt + tid] + w1 * k;
      s.y[(r - 1) * bt + tid] = yn;
      s.xa[r * bt + tid] = yn;
    }

    if (write_every > 0 && (step + 1) % write_every == 0) {
      T* out = records + ((long long)rec * B + b) * n;
      for (int i = 0; i < n; ++i) out[i] = s.y[i * bt + tid];
      ++rec;
    }
  }

  for (int i = 0; i < n; ++i) yb[i] = s.y[i * bt + tid];
}

// Threads per block: the state takes (2 n + 2 n1) values of shared memory per
// thread, so a block is kept small enough to leave several blocks per SM
// (MAOOAM: about 41 KB a block, 5 blocks an SM), and is halved further for
// a large model until it fits the block's shared-memory limit.
template <typename T>
constexpr int block_threads() { return sizeof(T) == 8 ? 32 : 64; }

template <typename T>
cudaError_t launch(const int* row_ptr, const int* jk, const T* vals, int n1,
                   int nnz, T* y, int B, const double* dts, int n_steps,
                   int write_every, T* records, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int bt = block_threads<T>();
  while (bt > 1 && smem_bytes<T>(n1, nnz, bt) > (size_t)max_smem) bt /= 2;
  const size_t smem = smem_bytes<T>(n1, nnz, bt);
  err = cudaFuncSetAttribute(
      rk4_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + bt - 1) / bt;
  rk4_fused_kernel<T><<<grid, bt, smem, (cudaStream_t)stream>>>(
      row_ptr, jk, vals, n1, nnz, y, B, dts, n_steps, write_every, records);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qgs_rk4_fused_f32(const int* row_ptr, const int* jk, const float* vals,
                      int n1, int nnz, float* y, int B, const double* dts,
                      int n_steps, int write_every, float* records,
                      void* stream) {
  return (int)launch<float>(row_ptr, jk, vals, n1, nnz, y, B, dts, n_steps,
                            write_every, records, stream);
}

int qgs_rk4_fused_f64(const int* row_ptr, const int* jk, const double* vals,
                      int n1, int nnz, double* y, int B, const double* dts,
                      int n_steps, int write_every, double* records,
                      void* stream) {
  return (int)launch<double>(row_ptr, jk, vals, n1, nnz, y, B, dts, n_steps,
                             write_every, records, stream);
}

const char* qgs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
