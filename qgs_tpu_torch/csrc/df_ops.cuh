// Double-float arithmetic of the twofloat RK4 kernels, resident
// (rk4_df_fused.cu) and streamed (rk4_df_streamed.cu): a value is an
// unevaluated sum hi + lo of two floats, a float2 {hi, lo}.  two_prod is
// p = a*b, e = fma(a, b, -p), exact; every other operation is an
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn intrinsic, which nvcc
// neither contracts into an FMA nor reassociates.  The two kernels include
// this one copy, so the same values in the same order give the same bits
// in both.

#pragma once

#include <cuda_runtime.h>

namespace qgs_df {

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

// -- a chunk's terms ---------------------------------------------------------

// The lane's value of the state row at byte offset off from its column xt.
__device__ __forceinline__ float2 gather(const char* __restrict__ xt,
                                         int off) {
  return *reinterpret_cast<const float2*>(xt + off);
}

// The two terms (v * xx[j]) * xx[k] of a chunk.
__device__ __forceinline__ void terms(const char* __restrict__ xt, int4 off,
                                      float4 val, float2& ta, float2& tb) {
  ta = df_mul(df_mul(make_float2(val.x, val.y), gather(xt, off.x)),
              gather(xt, off.y));
  tb = df_mul(df_mul(make_float2(val.z, val.w), gather(xt, off.z)),
              gather(xt, off.w));
}

}  // namespace qgs_df
