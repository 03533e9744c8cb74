// Bitwidth-split LUT ConSmax for Hopper (sm_90a), CUDA C++: the paper's
// Eq. 4 for int8 scores.
//
// Replaces the TPU kernel consmax_lut (_kernel) of
// src/repro/kernels/consmax_lut/kernel.py. An int8 score s maps to
//   out = (C * msb_lut[msb]) * lsb_lut[lsb],  msb = (s >> 4) + 8,  lsb = s & 15
// with msb_lut[i] = exp(scale * 16 * (i - 8)) and lsb_lut[j] =
// exp(scale * j) (ops.make_luts), so out = C * exp(scale * s) up to the
// fp32 rounding of the two tables and two products. s is the sign-extended
// int, so >> is arithmetic for negative codes (s = 16 * (s >> 4) + (s & 15)
// holds for all 256 codes). The TPU kernel reads its tables through one-hot
// (block, 16) x (16,) matmuls, the MXU's idiom for a lookup; here the two
// 16-entry tables sit in shared memory and are indexed directly (32
// distinct words in 32 banks: no bank conflict).
//
// Bound on an H100 SXM: one byte in and four out per code, no reuse, so
// memory-bound at 3.35 TB/s (201,326,592 codes, one qwen2-1.5b layer's
// scores at a 4096 prompt: 1.007 GB, ~300 us). A block takes 4,096 codes:
// each thread reads 16 with one 16-byte load into shared memory, then
// writes 4 x 4 results as 16-byte stores on which neighbouring threads
// write neighbouring addresses (storing a thread's own 16 codes straight
// from registers strides the warp's stores by 64 bytes, and the first
// version so ran at half the memory rate). The last, partial block (n not
// a multiple of 4,096) goes code by code, and so does every block when the
// codes do not start on a 16-byte boundary (a slice of a score matrix):
// such input is right, only slower.
// C comes from a device pointer when given (a 0-d fp32 tensor: no host
// sync), else from the argument c.
#include <cuda_runtime.h>
#include <stdint.h>

#include "consmax_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // codes per thread: one 16-byte load
constexpr int kPerBlock = kThreads * kPerThread;

__device__ __forceinline__ float lut_value(int s, float c, const float* tm,
                                           const float* tl) {
  return __fmul_rn(__fmul_rn(c, tm[(s >> 4) + 8]), tl[s & 15]);
}

__global__ void __launch_bounds__(kThreads)
    lut_kernel(const int8_t* __restrict__ codes,  // (n,)
               const float* __restrict__ msb_lut,  // (16,)
               const float* __restrict__ lsb_lut,  // (16,)
               const float* __restrict__ c_ptr,    // 0-d, or null
               float c_val, float* __restrict__ out,  // (n,), 16-byte aligned
               long long n, bool vec,  // vec: codes 16-byte aligned
               unsigned long long* launches) {
  count_launch(launches);
  __shared__ float tm[16], tl[16];
  __shared__ __align__(16) int8_t codes_s[kPerBlock];
  if (threadIdx.x < 16) {
    tm[threadIdx.x] = msb_lut[threadIdx.x];
  } else if (threadIdx.x < 32) {
    tl[threadIdx.x - 16] = lsb_lut[threadIdx.x - 16];
  }
  const long long base = static_cast<long long>(blockIdx.x) * kPerBlock;
  const bool full = vec && base + kPerBlock <= n;  // uniform in the block
  if (full) {
    reinterpret_cast<uint4*>(codes_s)[threadIdx.x] =
        reinterpret_cast<const uint4*>(codes + base)[threadIdx.x];
  }
  __syncthreads();
  const float c = c_ptr ? *c_ptr : c_val;
  if (full) {
    float4* o = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int j = 0; j < kPerThread / 4; ++j) {
      const int at = threadIdx.x + kThreads * j;  // a group of 4 codes
      const char4 s4 = reinterpret_cast<const char4*>(codes_s)[at];
      o[at] = make_float4(lut_value(s4.x, c, tm, tl),
                          lut_value(s4.y, c, tm, tl),
                          lut_value(s4.z, c, tm, tl),
                          lut_value(s4.w, c, tm, tl));
    }
  } else {
    for (long long i = base + threadIdx.x; i < n; i += kThreads) {
      out[i] = lut_value(codes[i], c, tm, tl);
    }
  }
}

}  // namespace

// codes (n,) int8, at any address; msb_lut, lsb_lut (16,) fp32; c_ptr a
// 0-d fp32 device tensor or null (then c_val); out (n,) fp32, 16-byte
// aligned; launches a uint64 device counter the kernel adds one to (null:
// not counted). n >= 1.
extern "C" int consmax_lut_launch(const void* codes, const void* msb_lut,
                                  const void* lsb_lut, const void* c_ptr,
                                  float c_val, void* out, long long n,
                                  void* stream, void* launches) {
  const long long blocks = (n + kPerBlock - 1) / kPerBlock;
  if (n < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lut_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(msb_lut),
      static_cast<const float*>(lsb_lut), static_cast<const float*>(c_ptr),
      c_val, static_cast<float*>(out), n,
      reinterpret_cast<uintptr_t>(codes) % 16 == 0,
      static_cast<unsigned long long*>(launches));
  return static_cast<int>(cudaGetLastError());
}
