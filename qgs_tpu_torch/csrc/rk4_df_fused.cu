// Fused double-float RK4 integration of a batch of trajectories of the
// quadratic tendency  f_i = sum_e v_e * xx[j_e] * xx[k_e],  xx = [1, y],
// every value an unevaluated sum hi + lo of two floats (about 48 bits of
// mantissa).
//
// Replaces the TPU kernel make_pallas_df_rk4
// (qgs_tpu/ops/pallas_kernels.py:107): n_steps double-float RK4 steps of a
// batch in one launch, with the (hi, lo) state kept on chip between steps.
// It computes the integrator's step (qgs_tpu_torch.ops.twofloat.
// make_df_rk4_step_dynamic, after qgs_tpu/ops/twofloat.py:600-622), not the
// Pallas kernel's: step s takes its own dts[s] (a shorter last step,
// backward runs), split in the kernel into hi = (float)dt, lo = (float)(dt -
// (double)hi); half = 0.5 (hi, lo) exactly, sixth = df_div_scalar(dt, 6);
// y_new = y + sixth ((k1 + k4) + 2 (k2 + k3)).  Records every write_every
// steps.
//
// Arithmetic: strict (renormalized) Knuth two-sum and Dekker product, as
// the plain version's df_add / df_mul, operation by operation.  two_prod is
// p = a*b, e = fma(a, b, -p): exact, so equal to the bitmask-split Dekker
// product.  Every other operation is an __fadd_rn / __fsub_rn / __fmul_rn
// intrinsic, which nvcc neither contracts into an FMA (its default is
// -fmad=true) nor reassociates.  Only the summation order of a row differs
// from the plain version: here the entries of a row are added left to right
// in csr_layout order; there a pairwise tree sums the padded slots.
//
// What bounds it on the card: not device-memory bytes -- the state stays in
// shared memory for the whole run.  Each entry of each stage costs one
// broadcast shared-memory load of the entry (v_hi, v_lo, j | k << 16), two
// gathers of (hi, lo) pairs, two df products and one df add: about 30
// dependent float operations, against K1's one FMA.  One thread per
// trajectory leaves few warps an SM, so the bound is the latency of that
// dependent chain.  What the design does about it:
//   * every thread of a block walks the same row-sorted entry list, held
//     once per block in shared memory as 16-byte records (one broadcast
//     load an entry);
//   * the per-thread state lives in shared memory as float2 (hi, lo) laid
//     out [variable][thread], so the data-dependent gathers of a warp fall
//     on neighbouring banks (one 8-byte load, no bank conflicts);
//   * each row's sum stays in registers and goes straight into k1, k2 + k3
//     and the next stage's input: the only barrier is the one after the
//     entry load.
// The block holds about 52 KB of shared memory at 32 threads (MAOOAM),
// above the 48 KB static limit, so the launcher raises the block's dynamic
// shared-memory limit first.
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_df_fused(row_ptr, jk, vhi, vlo, n1, nnz, y_hi, y_lo, B, dts,
//       n_steps, write_every, rec_hi, rec_lo, stream) -> cudaError_t
//   row_ptr (n1 + 1) int32: CSR offsets of output rows 0..n1-1 (row 0,
//       the dummy, is empty); jk (nnz) int32: j | (k << 16);
//   vhi, vlo (nnz) float: the (hi, lo) split of the values;
//   y_hi, y_lo (B, n) float, in/out, n = n1 - 1; dts (n_steps) double;
//   rec_hi, rec_lo (n_steps / write_every, B, n) float: the state after
//       every write_every steps (none when write_every == 0).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct __align__(16) Entry {
  float vhi, vlo;
  int jk;
  int pad;
};

__host__ __device__ size_t df_smem_bytes(int n1, int nnz, int bt) {
  const int n = n1 - 1;
  return sizeof(Entry) * (size_t)nnz +
         sizeof(float2) * (size_t)(3 * n + 2 * n1) * bt +
         sizeof(int) * (size_t)(n1 + 1);
}

// -- error-free transformations and double-float ops ------------------------

__device__ __forceinline__ float2 two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return make_float2(s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)),
                                  __fsub_rn(b, bb)));
}

__device__ __forceinline__ float2 quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return make_float2(s, __fsub_rn(b, __fsub_rn(s, a)));
}

__device__ __forceinline__ float2 two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return make_float2(p, __fmaf_rn(a, b, -p));
}

__device__ __forceinline__ float2 df_add(float2 x, float2 y) {
  const float2 s = two_sum(x.x, y.x);
  return quick_two_sum(s.x, __fadd_rn(__fadd_rn(s.y, x.y), y.y));
}

__device__ __forceinline__ float2 df_mul(float2 x, float2 y) {
  const float2 p = two_prod(x.x, y.x);
  const float e = __fadd_rn(__fadd_rn(p.y, __fmul_rn(x.x, y.y)),
                            __fmul_rn(x.y, y.x));
  return quick_two_sum(p.x, e);
}

__device__ __forceinline__ float2 df_scale(float2 x, float c) {
  const float2 p = two_prod(x.x, c);
  return quick_two_sum(p.x, __fadd_rn(p.y, __fmul_rn(x.y, c)));
}

__device__ __forceinline__ float2 df_div_scalar(float2 x, float c) {
  const float q = __fdiv_rn(x.x, c);
  const float2 p = two_prod(q, c);
  const float r = __fdiv_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(x.x, p.x), p.y), x.y), c);
  return quick_two_sum(q, r);
}

// y + c * k
__device__ __forceinline__ float2 axpy(float2 y, float2 c, float2 k) {
  return df_add(y, df_mul(k, c));
}

// -- the kernel -------------------------------------------------------------

struct Smem {
  Entry* ent;    // [nnz]
  float2* y;     // [n][bt]   state at the start of the step
  float2* k1;    // [n][bt]
  float2* s23;   // [n][bt]   k2 + k3
  float2* xa;    // [n1][bt]  stage input, xx[0] == (1, 0)
  float2* xb;    // [n1][bt]  the other stage input
  int* row_ptr;  // [n1 + 1]
};

// Sum of row r of the tendency at stage input x (column tid of
// [var][thread]), entries added left to right.
__device__ __forceinline__ float2 row_sum(const Smem& s, const float2* x,
                                         int r, int tid, int bt) {
  float2 sum = make_float2(0.f, 0.f);
  const int e1 = s.row_ptr[r + 1];
  for (int e = s.row_ptr[r]; e < e1; ++e) {
    const Entry en = s.ent[e];
    const float2 xj = x[(en.jk & 0xffff) * bt + tid];
    const float2 xk = x[(en.jk >> 16) * bt + tid];
    sum = df_add(sum, df_mul(df_mul(make_float2(en.vhi, en.vlo), xj), xk));
  }
  return sum;
}

__global__ void rk4_df_fused_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ jk,
    const float* __restrict__ vhi, const float* __restrict__ vlo, int n1,
    int nnz, float* __restrict__ y_hi, float* __restrict__ y_lo, int B,
    const double* __restrict__ dts, int n_steps, int write_every,
    float* __restrict__ rec_hi, float* __restrict__ rec_lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bt = blockDim.x;
  const int tid = threadIdx.x;
  const int n = n1 - 1;

  Smem s;
  s.ent = reinterpret_cast<Entry*>(smem_raw);
  s.y = reinterpret_cast<float2*>(s.ent + nnz);
  s.k1 = s.y + n * bt;
  s.s23 = s.k1 + n * bt;
  s.xa = s.s23 + n * bt;
  s.xb = s.xa + n1 * bt;
  s.row_ptr = reinterpret_cast<int*>(s.xb + n1 * bt);

  for (int e = tid; e < nnz; e += bt) {
    Entry en;
    en.vhi = vhi[e];
    en.vlo = vlo[e];
    en.jk = jk[e];
    en.pad = 0;
    s.ent[e] = en;
  }
  for (int r = tid; r <= n1; r += bt) s.row_ptr[r] = row_ptr[r];
  // The only barrier: every thread, masked or not, reaches it.  After it each
  // thread touches only its own column of the state arrays.
  __syncthreads();

  const long long b = (long long)blockIdx.x * bt + tid;
  if (b >= B) return;

  float* yb_hi = y_hi + b * n;
  float* yb_lo = y_lo + b * n;
  s.xa[tid] = make_float2(1.f, 0.f);
  s.xb[tid] = make_float2(1.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const float2 v = make_float2(yb_hi[i], yb_lo[i]);
    s.y[i * bt + tid] = v;
    s.xa[(i + 1) * bt + tid] = v;
  }

  int rec = 0;
  for (int step = 0; step < n_steps; ++step) {
    const double dt = dts[step];
    const float dt_hi = __double2float_rn(dt);
    const float2 dt_df =
        make_float2(dt_hi, __double2float_rn(__dsub_rn(dt, (double)dt_hi)));
    const float2 half = make_float2(__fmul_rn(0.5f, dt_df.x),
                                    __fmul_rn(0.5f, dt_df.y));
    const float2 sixth = df_div_scalar(dt_df, 6.f);

    // stage 1: k1 = f(xa);  xb = y + half k1
    for (int r = 1; r < n1; ++r) {
      const float2 k = row_sum(s, s.xa, r, tid, bt);
      const int i = (r - 1) * bt + tid;
      s.k1[i] = k;
      s.xb[r * bt + tid] = axpy(s.y[i], half, k);
    }
    // stage 2: k2 = f(xb);  s23 = k2;  xa = y + half k2
    for (int r = 1; r < n1; ++r) {
      const float2 k = row_sum(s, s.xb, r, tid, bt);
      const int i = (r - 1) * bt + tid;
      s.s23[i] = k;
      s.xa[r * bt + tid] = axpy(s.y[i], half, k);
    }
    // stage 3: k3 = f(xa);  s23 = k2 + k3;  xb = y + dt k3
    for (int r = 1; r < n1; ++r) {
      const float2 k = row_sum(s, s.xa, r, tid, bt);
      const int i = (r - 1) * bt + tid;
      s.s23[i] = df_add(s.s23[i], k);
      s.xb[r * bt + tid] = axpy(s.y[i], dt_df, k);
    }
    // stage 4: k4 = f(xb);  y = y + sixth ((k1 + k4) + 2 (k2 + k3));  xa = y
    for (int r = 1; r < n1; ++r) {
      const float2 k = row_sum(s, s.xb, r, tid, bt);
      const int i = (r - 1) * bt + tid;
      const float2 ksum = df_add(df_add(s.k1[i], k), df_scale(s.s23[i], 2.f));
      const float2 yn = axpy(s.y[i], sixth, ksum);
      s.y[i] = yn;
      s.xa[r * bt + tid] = yn;
    }

    if (write_every > 0 && (step + 1) % write_every == 0) {
      const long long off = ((long long)rec * B + b) * n;
      for (int i = 0; i < n; ++i) {
        const float2 v = s.y[i * bt + tid];
        rec_hi[off + i] = v.x;
        rec_lo[off + i] = v.y;
      }
      ++rec;
    }
  }

  for (int i = 0; i < n; ++i) {
    const float2 v = s.y[i * bt + tid];
    yb_hi[i] = v.x;
    yb_lo[i] = v.y;
  }
}

// Threads per block: the state takes (3 n + 2 n1) pairs of shared memory per
// thread (MAOOAM: about 52 KB a block of 32, 4 blocks an SM), halved for a
// large model until it fits the block's shared-memory limit.
constexpr int kBlockThreads = 32;

}  // namespace

extern "C" {

int qgs_rk4_df_fused(const int* row_ptr, const int* jk, const float* vhi,
                     const float* vlo, int n1, int nnz, float* y_hi,
                     float* y_lo, int B, const double* dts, int n_steps,
                     int write_every, float* rec_hi, float* rec_lo,
                     void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int bt = kBlockThreads;
  while (bt > 1 && df_smem_bytes(n1, nnz, bt) > (size_t)max_smem) bt /= 2;
  const size_t smem = df_smem_bytes(n1, nnz, bt);
  err = cudaFuncSetAttribute(rk4_df_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + bt - 1) / bt;
  rk4_df_fused_kernel<<<grid, bt, smem, (cudaStream_t)stream>>>(
      row_ptr, jk, vhi, vlo, n1, nnz, y_hi, y_lo, B, dts, n_steps,
      write_every, rec_hi, rec_lo);
  return (int)cudaGetLastError();
}

}  // extern "C"
