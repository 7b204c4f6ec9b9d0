// What the fused RK4 kernels share.  The kernels of K1's design -- the
// resident K1 and K5 (rk4_fused.cu) and the streamed K1 (rk4_streamed.cu)
// -- share all of this; the double-float K2 kernels only the launch.
//
// K1's design: a block serves kLanes = 32 trajectories with G warps; lane t
// of every warp serves trajectory t.  The output rows are split into G
// groups of about equal entry count (host side, longest row first), and
// warp w walks only group w's entries.  The state lives laid out
// [variable][lane], so a gather x[j] of a warp falls on neighbouring banks
// (no bank conflicts), and every lane of a warp reads the same entry record
// (a broadcast).  A record is 16 bytes, one LDS.128: {packed indices, row
// | kLast on the row's last chunk, value} (a float value in the third
// word, the fourth 0; a double in the third and fourth, low word first).
// A group's entries are read in chunks of kChunk = 2 entries of one row
// (rows padded with zero entries to whole chunks) into two independent
// partial sums.  At a row's last chunk its sum goes straight into the RK4
// accumulator and the next stage's input (combine: no k_i buffers).  Warp
// w writes only its own rows; every warp reads all rows of the current
// stage input.  The two stage inputs alternate (xa -> xb -> xa ...), so one
// barrier per stage orders all of it: after it, every write of the stage's
// output is visible, and every read of the buffer the next stage
// overwrites is done.  Lanes past the end of a ragged last block run on a
// zero state and reach every barrier; only their loads and stores are
// skipped.
//
// What serves a set of 32 trajectories is the Warp type's Block, a type of
// static hooks: kBlocks, the blocks that split the set's rows (1 for a
// block of its own, OneBlock; C for a thread-block cluster of the streamed
// kernel, rk4_streamed.cu); kInputs, the stage inputs a block keeps in
// shared memory (2, xa and xb; 1 for the streamed kernel's single-buffer
// variant, whose warps write a stage's output to device memory and land it
// in xa after the barrier, Warp::land); rank(), this block's place among
// them; tile(), the set's index; sync(), the stage barrier; put(x, i, v), a
// row's next stage input into every block's copy of it.  The state rows a
// block loads into sy and writes out are those of its rank: rows rank * G +
// w + m * kBlocks * G of warp w.
//
// The RK4 combine follows qgs_tpu.integrators.rk.make_rk_step term by term:
// stage inputs y + (dt*a)*k, and y_new = (((y + (dt/6)k1) + (dt/3)k2) +
// (dt/3)k3) + (dt/6)k4, with dt = dts[s] cast to the state type; a row's
// entries are summed in another order than the plain version's.

#pragma once

#include <cuda_runtime.h>

namespace qgs_rk4 {

constexpr int kLanes = 32;        // trajectories a block, one a lane
constexpr int kChunk = 2;         // entries a chunk, one partial sum each
constexpr int kLast = 1 << 16;    // ctl flag: the chunk ends its row

// The value of a 16-byte record.
__device__ __forceinline__ double rec_value(int4 raw, double) {
  return __hiloint2double(raw.w, raw.z);
}
__device__ __forceinline__ float rec_value(int4 raw, float) {
  return __int_as_float(raw.z);
}

// The hooks of a block that serves its 32 trajectories alone (the resident
// kernels, and the streamed one without a cluster).
struct OneBlock {
  static constexpr int kBlocks = 1;
  static constexpr int kInputs = 2;
  static __device__ __forceinline__ int rank() { return 0; }
  static __device__ __forceinline__ int tile() { return blockIdx.x; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
  template <typename T>
  static __device__ __forceinline__ void put(T* x, int i, T v) { x[i] = v; }
};

// A set's state (B, n) into the stage input xa [n1][lane] (row 0 the dummy
// xx[0] = 1, in xb too) and this block's rows of it into sy [n][lane].  No
// barrier.
template <typename Block, typename T>
__device__ __forceinline__ void load_state(const T* y, int B, int n, T* sy,
                                           T* xa, T* xb) {
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const long long b = (long long)Block::tile() * kLanes + t;
  const bool live = b < B;
  const T* yb = y + b * n;
  for (int i = w; i < n; i += groups) {
    const T v = live ? yb[i] : T(0);
    if (i / groups % Block::kBlocks == Block::rank()) sy[i * kLanes + t] = v;
    xa[(i + 1) * kLanes + t] = v;
  }
  if (w == 0) {
    xa[t] = T(1);
    xb[t] = T(1);
  }
}

// A row's sum k at output o = row * kLanes + t into acc and into the next
// stage input xo (row i of the state is row i + 1 of xo); pa is the row's
// y (STAGE < 3) or acc (STAGE 3), pb its acc (STAGE 1, 2):
//   STAGE 0: acc = y + c_acc k;  xo = y + c_x k
//   STAGE 1, 2: acc += c_acc k;  xo = y + c_x k
//   STAGE 3: y = acc + c_acc k;  xo = y
// (xo through Block::put, into every block's copy).
template <int STAGE, typename Block, typename T>
__device__ __forceinline__ void combine(int o, T k, T pa, T pb,
                                        T* __restrict__ xo,
                                        T* __restrict__ y,
                                        T* __restrict__ acc, T c_acc,
                                        T c_x) {
  if (STAGE == 0) {
    acc[o] = pa + c_acc * k;
    Block::put(xo, o + kLanes, pa + c_x * k);
  } else if (STAGE < 3) {
    acc[o] = pb + c_acc * k;
    Block::put(xo, o + kLanes, pa + c_x * k);
  } else {
    const T yn = pa + c_acc * k;
    y[o] = yn;
    Block::put(xo, o + kLanes, yn);
  }
}

// Stage STAGE of a step: warp.template stage<STAGE>(x, xo, c_acc, c_x)
// runs it on this warp's rows, then the block's barrier.  Where the block
// keeps one stage input (Block::kInputs == 1), the warp wrote the stage's
// output to device memory: warp.land() copies it into the stage input,
// behind a second barrier.
template <int STAGE, typename Warp, typename T>
__device__ __forceinline__ void rk4_stage(Warp& warp, const T* x, T* xo,
                                          T c_acc, T c_x) {
  using Block = typename Warp::Block;
  warp.template stage<STAGE>(x, xo, c_acc, c_x);
  Block::sync();
  if constexpr (Block::kInputs == 1) {
    warp.land();
    Block::sync();
  }
}

// n_steps RK4 steps of a block whose state is loaded (load_state) and
// ordered by Block::sync(), each stage by rk4_stage.  Records this block's
// rows every write_every steps, then stores them as the final state into
// y: from sy, or, where blocks share a set, from the stage input xa (after
// stage 3 it holds the new state of every row in every block).
template <typename T, typename Warp>
__device__ __forceinline__ void rk4_steps(Warp& warp, T* xa, T* xb,
                                          const T* sy, T* y, int B, int n,
                                          const double* dts, int n_steps,
                                          int write_every, T* records) {
  const int groups = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  using Block = typename Warp::Block;
  const long long b = (long long)Block::tile() * kLanes + t;
  const bool live = b < B;
  const int first = Block::rank() * groups + w;   // this warp's rows out
  const int stride = Block::kBlocks * groups;
  const T* out_rows = Block::kBlocks == 1 ? sy : xa + kLanes;
  int rec_i = 0;
  for (int step = 0; step < n_steps; ++step) {
    const T dt = static_cast<T>(dts[step]);
    const T h = dt * T(0.5);                 // dt * a[1,0] = dt * a[2,1]
    const T w1 = dt * T(1.0 / 6.0);          // dt * b[0] = dt * b[3]
    const T w2 = dt * T(1.0 / 3.0);          // dt * b[1] = dt * b[2]

    rk4_stage<0>(warp, xa, xb, w1, h);          // k1
    rk4_stage<1>(warp, xb, xa, w2, h);          // k2
    rk4_stage<2>(warp, xa, xb, w2, dt);         // k3
    rk4_stage<3>(warp, xb, xa, w1, T(0));       // k4 -> y, xa

    if (write_every > 0 && (step + 1) % write_every == 0) {
      if (live) {
        T* out = records + ((long long)rec_i * B + b) * n;
        for (int i = first; i < n; i += stride)
          out[i] = out_rows[i * kLanes + t];
      }
      ++rec_i;
    }
  }
  if (live) {
    T* yb = y + b * n;
    for (int i = first; i < n; i += stride) yb[i] = out_rows[i * kLanes + t];
  }
}

// One launch of `kernel` over ceil(B / 32) sets of C blocks (C > 1: one
// thread-block cluster a set) of `groups` warps with `smem` bytes of
// dynamic shared memory, `valid` false for arguments the kernel cannot
// take: clears an earlier, unrelated error, then checks the arguments and
// the shared memory against the card's opt-in limit a block.
template <int C = 1, typename... Params, typename... Args>
cudaError_t launch(bool valid, void (*kernel)(Params...), size_t smem,
                   int groups, int B, void* stream, Args... args) {
  cudaGetLastError();
  if (!valid) return cudaErrorInvalidValue;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + kLanes - 1) / kLanes;
  if constexpr (C == 1) {
    kernel<<<grid, groups * kLanes, smem, (cudaStream_t)stream>>>(args...);
    return cudaGetLastError();
  } else {
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = C;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid * C);
    config.blockDim = dim3(groups * kLanes);
    config.dynamicSmemBytes = smem;
    config.stream = (cudaStream_t)stream;
    config.attrs = cluster;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

}  // namespace qgs_rk4
