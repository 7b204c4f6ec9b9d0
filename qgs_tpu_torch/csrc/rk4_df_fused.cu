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
// Arithmetic (df_ops.cuh, shared with rk4_df_streamed.cu): strict
// (renormalized) Knuth two-sum and Dekker product, as the plain version's
// df_add / df_mul, operation by operation.  two_prod is
// p = a*b, e = fma(a, b, -p): exact, so equal to the bitmask-split Dekker
// product.  Every other operation is an __fadd_rn / __fsub_rn / __fmul_rn
// intrinsic, which nvcc neither contracts into an FMA (its default is
// -fmad=true) nor reassociates.  A row's entries are summed in the order of
// qgs_tpu_torch.ops.fused_df_rk4.df_group_tendency, not the plain
// version's pairwise tree.
//
// What bounds it on the card: not device-memory bytes -- the state stays in
// shared memory for the whole run.  Each entry of each stage is a chain of
// about 24 dependent float32 operations (two df products at 9 instructions,
// one df add at 11) behind its gathers; one thread that walks all of a
// trajectory's entries in series is bound by that chain's latency.  With
// enough warps an SM the bound is the schedulers' issue rate: about 29
// float32 instructions an entry, almost none of them an FMA, plus the
// loads and address arithmetic.  The design:
//   * K1's mapping (csrc/rk4_fused.cu): a block serves 32 trajectories with
//     G warps (G in 1, 2, 4, 8); lane t of every warp serves trajectory t.
//     The output rows are split into G groups of about equal entry count
//     (host side, longest row first), and warp w walks only group w's
//     entries: G times the warps an SM (32 at G = 8, 4 blocks of about
//     55 KB), each with 1/G of the chain;
//   * the state lives in shared memory as float2 (hi, lo) laid out
//     [variable][lane], so the data-dependent gathers of a warp fall on
//     neighbouring banks (two wavefronts an 8-byte gather, no conflicts);
//   * the entries come as the 16-byte records {j | k << 16, row | last-chunk
//     flag, v_hi, v_lo} of qgs_tpu_torch.ops.fused_rk4.group_layout, read
//     in chunks of two entries of one row (rows padded with zero entries to
//     whole chunks) into two independent double-float partial sums, added
//     at the row's last chunk.  The block keeps its own copy, one 48-byte
//     Chunk a chunk: the four gather offsets in bytes (one add an
//     address), the four values, the control word -- three broadcast loads
//     from one address a chunk;
//   * the chunk loop is software pipelined: while chunk c's terms are added
//     into the partial sums, chunk c + 1's are gathered and multiplied and
//     chunk c + 2's records loaded, all in one basic block;
//   * every product is done, the ones by xx[0] = (1, 0) included (a
//     product of a normalised pair by (1, 0) returns the pair): a
//     warp-uniform branch that skips them costs the schedulers more than
//     the products it saves (PERF.md, Findings);
//   * at a row's last chunk its sum goes straight into k1, s23 = k2 + k3 or
//     the new y, and into the next stage's input.  Warp w writes only its
//     own rows of k1, s23, y and the next input; every warp reads all rows
//     of the current input.  The two stage inputs alternate (xa -> xb -> xa
//     ...), so one barrier per stage orders all of it: after it, every
//     write of the stage's output is visible, and every read of the buffer
//     the next stage overwrites is done; k1, s23 and y are read and written
//     only by the warp that owns the row, between the barriers that order
//     the records and the initial and final copies.  Lanes past the end of
//     a ragged last block run on a zero state and reach every barrier; only
//     their loads and stores are skipped.
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_df_fused(jk, ctl, vhi, vlo, lengths, groups, width, n1, y_hi,
//       y_lo, B, dts, n_steps, write_every, rec_hi, rec_lo, stream)
//       -> cudaError_t
//   jk, ctl (groups, width) int32 and vhi, vlo (groups, width) float: the
//       group tables of qgs_tpu_torch.ops.fused_rk4.group_layout, the
//       values split into (hi, lo) (zero records past each group's length,
//       and at least one chunk of them);
//   lengths (groups) int32: records of each group, a multiple of 2;
//   y_hi, y_lo (B, n) float, in/out, n = n1 - 1; dts (n_steps) double;
//   rec_hi, rec_lo (n_steps / write_every, B, n) float: the state after
//       every write_every steps (none when write_every == 0).

#include <cuda_runtime.h>
#include <cstdint>

#include "df_ops.cuh"
#include "rk4_common.cuh"

namespace {

using qgs_rk4::kChunk;
using qgs_rk4::kLanes;
using qgs_rk4::kLast;
constexpr int kMaxGroups = 8;
constexpr int kRowBytes = kLanes * sizeof(float2);   // a state row, [lane]

// The block's copy of a group's chunks, chunk c of the group at [c]:
//   off  the gather offsets in bytes {j_a, k_a, j_b, k_b} * kRowBytes;
//   val  the values {v_hi, v_lo} of entry a, then of entry b;
//   ctl  state row i (0-based) | kLast on the row's last chunk.
struct __align__(16) Chunk {
  int4 off;
  float4 val;
  int ctl, pad[3];
};

__host__ __device__ size_t df_smem_bytes(int n1, int groups, int width) {
  const int n = n1 - 1;
  const size_t chunks = (size_t)groups * (width / kChunk);
  return sizeof(Chunk) * chunks +
         sizeof(float2) * (size_t)(3 * n + 2 * n1) * kLanes;
}

using namespace qgs_df;

// -- the kernel -------------------------------------------------------------

// Row sum k of state row i = ctl & 0xffff (column t) into the stage's
// outputs (row i of the state is row i + 1 of xo):
//   stage 0: k1 = k;              xo = y + c k   (c = dt / 2)
//   stage 1: s23 = k;             xo = y + c k   (c = dt / 2)
//   stage 2: s23 = s23 + k;       xo = y + c k   (c = dt)
//   stage 3: y = y + c ((k1 + k) + 2 s23);  xo = y   (c = dt / 6)
__device__ __forceinline__ void combine(int st, int ctl, float2 k,
                                        float2* __restrict__ xo,
                                        float2* __restrict__ y,
                                        float2* __restrict__ k1,
                                        float2* __restrict__ s23, int t,
                                        float2 c) {
  const int o = (ctl & 0xffff) * kLanes + t;
  if (st == 0) {
    k1[o] = k;
    xo[o + kLanes] = axpy(y[o], c, k);
  } else if (st == 1) {
    s23[o] = k;
    xo[o + kLanes] = axpy(y[o], c, k);
  } else if (st == 2) {
    s23[o] = df_add(s23[o], k);
    xo[o + kLanes] = axpy(y[o], c, k);
  } else {
    const float2 ksum = df_add(df_add(k1[o], k), df_scale(s23[o], 2.f));
    const float2 yn = axpy(y[o], c, ksum);
    y[o] = yn;
    xo[o + kLanes] = yn;
  }
}

// One RK4 stage of one warp over the nc chunks ch of its group: the sums
// of its rows at the stage input x, each combined at its row's last chunk.
// While chunk c's terms are added, chunk c + 1's are computed and chunk
// c + 2's records loaded (at most the layout's zero chunk past the end).
// The stage and each chunk are the same for the whole warp: no divergence.
__device__ __forceinline__ void stage(int st, const Chunk* __restrict__ ch,
                                      int nc,
                                      const float2* __restrict__ x,
                                      float2* __restrict__ xo,
                                      float2* __restrict__ y,
                                      float2* __restrict__ k1,
                                      float2* __restrict__ s23, int t,
                                      float2 c) {
  if (nc == 0) return;
  const char* xt = reinterpret_cast<const char*>(x + t);
  float2 ta, tb;
  terms(xt, ch[0].off, ch[0].val, ta, tb);
  int cur = ch[0].ctl;
  int4 noff = ch[1].off;
  float4 nval = ch[1].val;
  float2 s0 = make_float2(0.f, 0.f), s1 = s0;
#pragma unroll 2
  for (int ci = 1; ci < nc; ++ci) {
    const int4 nnoff = ch[ci + 1].off;    // chunk c + 2, read ahead
    const float4 nnval = ch[ci + 1].val;
    const int nctl = ch[ci].ctl;
    float2 ua, ub;
    terms(xt, noff, nval, ua, ub);        // chunk c + 1
    s0 = df_add(s0, ta);                  // chunk c
    s1 = df_add(s1, tb);
    ta = ua;
    tb = ub;
    if (cur & kLast) {
      combine(st, cur, df_add(s0, s1), xo, y, k1, s23, t, c);
      s0 = make_float2(0.f, 0.f);
      s1 = s0;
    }
    cur = nctl;
    noff = nnoff;
    nval = nnval;
  }
  s0 = df_add(s0, ta);                    // the last chunk ends its row
  s1 = df_add(s1, tb);
  combine(st, cur, df_add(s0, s1), xo, y, k1, s23, t, c);
}

__global__ void __launch_bounds__(kMaxGroups * kLanes, 4)
rk4_df_fused_kernel(const int* __restrict__ jk, const int* __restrict__ ctl,
                    const float* __restrict__ vhi,
                    const float* __restrict__ vlo,
                    const int* __restrict__ lengths, int width, int n1,
                    float* __restrict__ y_hi, float* __restrict__ y_lo, int B,
                    const double* __restrict__ dts, int n_steps,
                    int write_every, float* __restrict__ rec_hi,
                    float* __restrict__ rec_lo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int n = n1 - 1;
  const int chunks = width / kChunk;      // a group's, zero chunks included

  Chunk* cch = reinterpret_cast<Chunk*>(smem_raw);         // [group][chunk]
  float2* sy = reinterpret_cast<float2*>(cch + groups * chunks);   // [n][lane]
  float2* k1 = sy + n * kLanes;                                    // [n][lane]
  float2* s23 = k1 + n * kLanes;                                   // [n][lane]
  float2* xa = s23 + n * kLanes;                                   // [n1][lane]
  float2* xb = xa + n1 * kLanes;                                   // [n1][lane]

  for (int i = threadIdx.x; i < groups * chunks; i += blockDim.x) {
    const int ea = kChunk * i, eb = ea + 1;     // the chunk's two records
    cch[i].off = make_int4(
        (jk[ea] & 0xffff) * kRowBytes, (jk[ea] >> 16) * kRowBytes,
        (jk[eb] & 0xffff) * kRowBytes, (jk[eb] >> 16) * kRowBytes);
    cch[i].val = make_float4(vhi[ea], vlo[ea], vhi[eb], vlo[eb]);
    cch[i].ctl = ctl[ea];
  }
  const long long b = (long long)blockIdx.x * kLanes + t;
  const bool live = b < B;
  float* yb_hi = y_hi + b * n;
  float* yb_lo = y_lo + b * n;
  for (int i = w; i < n; i += groups) {
    const float2 v = live ? make_float2(yb_hi[i], yb_lo[i])
                          : make_float2(0.f, 0.f);
    sy[i * kLanes + t] = v;
    xa[(i + 1) * kLanes + t] = v;
  }
  if (w == 0) {
    xa[t] = make_float2(1.f, 0.f);
    xb[t] = make_float2(1.f, 0.f);
  }
  __syncthreads();

  const Chunk* cw = cch + w * chunks;
  const int nc = lengths[w] / kChunk;
  int rec_i = 0;
  for (int step = 0; step < n_steps; ++step) {
    const double dt = dts[step];
    const float dt_hi = __double2float_rn(dt);
    const float2 dt_df =
        make_float2(dt_hi, __double2float_rn(__dsub_rn(dt, (double)dt_hi)));
    const float2 half = make_float2(__fmul_rn(0.5f, dt_df.x),
                                    __fmul_rn(0.5f, dt_df.y));
    const float2 sixth = df_div_scalar(dt_df, 6.f);

    stage(0, cw, nc, xa, xb, sy, k1, s23, t, half);    // k1
    __syncthreads();
    stage(1, cw, nc, xb, xa, sy, k1, s23, t, half);    // k2
    __syncthreads();
    stage(2, cw, nc, xa, xb, sy, k1, s23, t, dt_df);   // k3
    __syncthreads();
    stage(3, cw, nc, xb, xa, sy, k1, s23, t, sixth);   // k4 -> y
    __syncthreads();

    if (write_every > 0 && (step + 1) % write_every == 0) {
      if (live) {
        const long long o = ((long long)rec_i * B + b) * n;
        for (int i = w; i < n; i += groups) {
          const float2 v = sy[i * kLanes + t];
          rec_hi[o + i] = v.x;
          rec_lo[o + i] = v.y;
        }
      }
      ++rec_i;
    }
  }
  if (live) {
    for (int i = w; i < n; i += groups) {
      const float2 v = sy[i * kLanes + t];
      yb_hi[i] = v.x;
      yb_lo[i] = v.y;
    }
  }
}

}  // namespace

extern "C" {

int qgs_rk4_df_fused(const int* jk, const int* ctl, const float* vhi,
                     const float* vlo, const int* lengths, int groups,
                     int width, int n1, float* y_hi, float* y_lo, int B,
                     const double* dts, int n_steps, int write_every,
                     float* rec_hi, float* rec_lo, void* stream) {
  const bool valid = groups >= 1 && groups <= kMaxGroups &&
                     width >= 2 * kChunk && width % kChunk == 0;
  return (int)qgs_rk4::launch(valid, rk4_df_fused_kernel,
                              df_smem_bytes(n1, groups, width), groups, B,
                              stream, jk, ctl, vhi, vlo, lengths, width, n1,
                              y_hi, y_lo, B, dts, n_steps, write_every,
                              rec_hi, rec_lo);
}

// The shared memory a launch of the kernel needs (the wrapper's twin of
// this formula decides the route before any launch).
long long qgs_rk4_df_fused_smem_bytes(int n1, int groups, int width) {
  return (long long)df_smem_bytes(n1, groups, width);
}

}  // extern "C"
