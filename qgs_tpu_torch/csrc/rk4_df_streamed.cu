// Fused double-float RK4 integration of a batch of trajectories of the
// quadratic tendency  f_i = sum_e v_e * xx[j_e] * xx[k_e],  xx = [1, y],
// every value an unevaluated sum hi + lo of two floats, for tensors whose
// records do not fit one block's shared memory.
//
// Replaces the TPU kernel make_pallas_df_rk4
// (qgs_tpu/ops/pallas_kernels.py:107) where the resident kernel
// (rk4_df_fused.cu) cannot hold the tensor: n_steps double-float RK4
// steps of a batch in one launch, the integrator's step
// (qgs_tpu_torch.ops.twofloat.make_df_rk4_step_dynamic), each step of its
// own dts[s].  On the H100 the resident kernel's 48-byte chunks plus five
// (hi, lo) state rows of 32 lanes exceed a block's 232,448 bytes of
// shared memory from MAOOAM 4x4/4x4 (ndim 104: 120,576 bytes of chunks and
// 133,632 of state).
//
// What bounds it on the card: as the resident kernel, the schedulers'
// instruction rate (about 29 float32 instructions an entry, almost no FMA)
// where enough warps run, else the latency of each warp's dependent chain;
// device-memory bytes are small beside it.  The design keeps the resident
// kernel's mapping, order and arithmetic and moves what does not need to
// be on chip:
//   * the records stay in device memory: the 16-byte records {j | k << 16,
//     row | last-chunk flag, v_hi, v_lo} of qgs_tpu_torch.ops.fused_rk4.
//     group_layout, in flat per-group lists padded to tiles of 32
//     (qgs_tpu_torch.ops.fused_df_rk4.df_streamed_records).  Every block
//     reads the same lists, so they stay in L2.  Each warp streams its own
//     group's list through a ring of 4 tiles in shared memory, refilled
//     ahead of its walk by cp.async (stream_ring.cuh);
//     every lane reads the same records (two broadcast loads a chunk) and
//     turns the indices into byte offsets of the gathers;
//   * only the two stage inputs xa / xb (n1 rows of 32 (hi, lo) lanes),
//     which every warp gathers from, stay in shared memory.  y, k1 and
//     s23 = k2 + k3 go to a scratch array in device memory laid out
//     [block][variable][lane]: warp w reads and writes only its own rows
//     there, one row of 32 lanes at a time (coalesced), and reads the
//     row's values when the row starts, so the L2 round trip overlaps the
//     row's chunks.  Shared memory is then 2 n1 32 8 bytes plus the rings:
//     it reaches ndim 421;
//   * the rest is rk4_df_fused.cu's: a block of 32 trajectories with G
//     warps, warp w walking group w's rows; the software-pipelined chunk
//     loop (chunk c's terms added while chunk c + 1's are computed and
//     chunk c + 2's records read); every product done, the ones by
//     xx[0] = (1, 0) included; strict Knuth two-sum and Dekker products by
//     __fadd_rn / __fmul_rn / __fmaf_rn intrinsics; the row's sum combined
//     at its last chunk; one barrier a stage.  Each operation is the
//     resident kernel's (the double-float ops and a chunk's terms are
//     df_ops.cuh's, included by both) on the same values in the same
//     order, so the two kernels give the same bits wherever both run.
//
// C interface (no PyTorch headers, so nvcc builds it in seconds):
//   qgs_rk4_df_streamed(recs, lengths, groups, width, n1, y_hi, y_lo, B,
//       dts, n_steps, write_every, rec_hi, rec_lo, scratch, stream)
//       -> cudaError_t
//   recs (groups, width) 16-byte records {jk, ctl, v_hi, v_lo}; width a
//       multiple of 32, zero records past each group's length;
//   lengths (groups) int32: records of each group, a multiple of 2, at
//       most width - 2;
//   y_hi, y_lo (B, n) float, in/out, n = n1 - 1; dts (n_steps) double;
//   rec_hi, rec_lo (n_steps / write_every, B, n) float: the state after
//       every write_every steps (none when write_every == 0);
//   scratch (ceil(B / 32), 3, n, 32) float2: y, k1 and s23.

#include <cuda_runtime.h>
#include <cstdint>

#include "df_ops.cuh"
#include "rk4_common.cuh"
#include "stream_ring.cuh"

namespace {

using qgs_ring::Ring;
using qgs_rk4::kLanes;
using qgs_rk4::kLast;
constexpr int kMaxGroups = 8;
constexpr int kRowBytes = kLanes * sizeof(float2);   // a state row, [lane]

__host__ __device__ size_t df_streamed_smem_bytes(int n1, int groups) {
  return qgs_ring::ring_bytes(groups) +
         sizeof(float2) * (size_t)2 * n1 * kLanes;
}

using namespace qgs_df;

// -- the kernel -------------------------------------------------------------

// A chunk as the resident kernel keeps it: the four gather offsets in
// bytes, the values {v_hi, v_lo} of entry a then of entry b, the control
// word of entry a.
struct ChunkRegs {
  int4 off;
  float4 val;
  int ctl;
};

__device__ __forceinline__ ChunkRegs read_chunk(Ring& ring) {
  int4 a, b;
  ring.read(a, b);
  ChunkRegs c;
  c.off = make_int4((a.x & 0xffff) * kRowBytes, (a.x >> 16) * kRowBytes,
                    (b.x & 0xffff) * kRowBytes, (b.x >> 16) * kRowBytes);
  c.val = make_float4(__int_as_float(a.z), __int_as_float(a.w),
                      __int_as_float(b.z), __int_as_float(b.w));
  c.ctl = a.y;
  return c;
}

// The values of row o that stage ST reads when the row is combined: y
// (every stage), k1 (stage 3) and s23 (stages 2 and 3).
struct RowRegs {
  float2 y, k1, s23;
};

template <int ST>
__device__ __forceinline__ RowRegs load_row(int o,
                                            const float2* __restrict__ y,
                                            const float2* __restrict__ k1,
                                            const float2* __restrict__ s23) {
  RowRegs r;
  const float2 zero = make_float2(0.f, 0.f);
  r.y = y[o];
  r.k1 = ST == 3 ? k1[o] : zero;
  r.s23 = ST >= 2 ? s23[o] : zero;
  return r;
}

// Row sum k of state row o / 32 into the stage's outputs (rk4_df_fused.cu's
// combine, on the row's values p read when it started):
//   stage 0: k1 = k;              xo = y + c k   (c = dt / 2)
//   stage 1: s23 = k;             xo = y + c k   (c = dt / 2)
//   stage 2: s23 = s23 + k;       xo = y + c k   (c = dt)
//   stage 3: y = y + c ((k1 + k) + 2 s23);  xo = y   (c = dt / 6)
template <int ST>
__device__ __forceinline__ void combine(int o, float2 k, const RowRegs& p,
                                        float2* __restrict__ xo,
                                        float2* __restrict__ y,
                                        float2* __restrict__ k1,
                                        float2* __restrict__ s23, float2 c) {
  if (ST == 0) {
    k1[o] = k;
    xo[o + kLanes] = axpy(p.y, c, k);
  } else if (ST == 1) {
    s23[o] = k;
    xo[o + kLanes] = axpy(p.y, c, k);
  } else if (ST == 2) {
    s23[o] = df_add(p.s23, k);
    xo[o + kLanes] = axpy(p.y, c, k);
  } else {
    const float2 ksum = df_add(df_add(p.k1, k), df_scale(p.s23, 2.f));
    const float2 yn = axpy(p.y, c, ksum);
    y[o] = yn;
    xo[o + kLanes] = yn;
  }
}

// One RK4 stage of one warp over the len records of its group: the sums of
// its rows at the stage input x, each combined at its row's last chunk.
// While chunk c's terms are added, chunk c + 1's are computed and chunk
// c + 2's records read (at most the zero chunk past the end).  The stage
// and each chunk are the same for the whole warp: no divergence.
template <int ST>
__device__ __forceinline__ void stage(Ring& ring, int len,
                                      const float2* __restrict__ x,
                                      float2* __restrict__ xo,
                                      float2* __restrict__ y,
                                      float2* __restrict__ k1,
                                      float2* __restrict__ s23, int t,
                                      float2 c) {
  if (len == 0) return;
  const int nc = len / 2;
  const char* xt = reinterpret_cast<const char*>(x + t);
  float2 ta, tb;
  const ChunkRegs first = read_chunk(ring);
  terms(xt, first.off, first.val, ta, tb);
  int cur = first.ctl;
  int o = (cur & 0xffff) * kLanes + t;
  RowRegs row = load_row<ST>(o, y, k1, s23);
  ChunkRegs nx = read_chunk(ring);                 // chunk c + 1
  float2 s0 = make_float2(0.f, 0.f), s1 = s0;
#pragma unroll 2
  for (int ci = 1; ci < nc; ++ci) {
    const ChunkRegs nn = read_chunk(ring);         // chunk c + 2, read ahead
    float2 ua, ub;
    terms(xt, nx.off, nx.val, ua, ub);             // chunk c + 1
    s0 = df_add(s0, ta);                           // chunk c
    s1 = df_add(s1, tb);
    ta = ua;
    tb = ub;
    if (cur & kLast) {
      combine<ST>(o, df_add(s0, s1), row, xo, y, k1, s23, c);
      s0 = make_float2(0.f, 0.f);
      s1 = s0;
      o = (nx.ctl & 0xffff) * kLanes + t;          // the next row
      row = load_row<ST>(o, y, k1, s23);
    }
    cur = nx.ctl;
    nx = nn;
  }
  s0 = df_add(s0, ta);                             // the last chunk ends its row
  s1 = df_add(s1, tb);
  combine<ST>(o, df_add(s0, s1), row, xo, y, k1, s23, c);
  ring.end_walk();
}

__global__ void __launch_bounds__(kMaxGroups * kLanes, 2)
rk4_df_streamed_kernel(const int4* __restrict__ recs,
                       const int* __restrict__ lengths, int width, int n1,
                       float* __restrict__ y_hi, float* __restrict__ y_lo,
                       int B, const double* __restrict__ dts, int n_steps,
                       int write_every, float* __restrict__ rec_hi,
                       float* __restrict__ rec_lo,
                       float2* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int n = n1 - 1;

  int4* tiles = reinterpret_cast<int4*>(smem_raw);  // [group][slot][record]
  float2* xa = reinterpret_cast<float2*>(
      tiles + groups * qgs_ring::kSlots * qgs_ring::kTile);  // [n1][lane]
  float2* xb = xa + n1 * kLanes;                             // [n1][lane]
  float2* sy = scratch + (long long)blockIdx.x * 3 * n * kLanes;  // [n][lane]
  float2* k1 = sy + n * kLanes;                                   // [n][lane]
  float2* s23 = k1 + n * kLanes;                                  // [n][lane]

  const int len = lengths[w];
  Ring ring(recs + (size_t)w * width, len,
            tiles + w * qgs_ring::kSlots * qgs_ring::kTile, t);
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
  if (len > 0) ring.start();

  int rec_i = 0;
  for (int step = 0; step < n_steps; ++step) {
    const double dt = dts[step];
    const float dt_hi = __double2float_rn(dt);
    const float2 dt_df =
        make_float2(dt_hi, __double2float_rn(__dsub_rn(dt, (double)dt_hi)));
    const float2 half = make_float2(__fmul_rn(0.5f, dt_df.x),
                                    __fmul_rn(0.5f, dt_df.y));
    const float2 sixth = df_div_scalar(dt_df, 6.f);

    stage<0>(ring, len, xa, xb, sy, k1, s23, t, half);    // k1
    __syncthreads();
    stage<1>(ring, len, xb, xa, sy, k1, s23, t, half);    // k2
    __syncthreads();
    stage<2>(ring, len, xa, xb, sy, k1, s23, t, dt_df);   // k3
    __syncthreads();
    stage<3>(ring, len, xb, xa, sy, k1, s23, t, sixth);   // k4 -> y
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
  if (len > 0) ring.drain();
}

}  // namespace

extern "C" {

int qgs_rk4_df_streamed(const void* recs, const int* lengths, int groups,
                        int width, int n1, float* y_hi, float* y_lo, int B,
                        const double* dts, int n_steps, int write_every,
                        float* rec_hi, float* rec_lo, void* scratch,
                        void* stream) {
  const bool valid = groups >= 1 && groups <= kMaxGroups &&
                     width >= qgs_ring::kTile && width % qgs_ring::kTile == 0;
  return (int)qgs_rk4::launch(
      valid, rk4_df_streamed_kernel, df_streamed_smem_bytes(n1, groups),
      groups, B, stream, static_cast<const int4*>(recs), lengths, width, n1,
      y_hi, y_lo, B, dts, n_steps, write_every, rec_hi, rec_lo,
      static_cast<float2*>(scratch));
}

// The shared memory a launch of the kernel needs (the wrapper's twin of
// this formula decides the route before any launch).
long long qgs_rk4_df_streamed_smem_bytes(int n1, int groups) {
  return (long long)df_streamed_smem_bytes(n1, groups);
}

}  // extern "C"
