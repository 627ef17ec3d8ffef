// Uniform (optionally dithered) quantization (K6) for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
//   K6 (quantize_forward) replaces
//     src/repro/kernels/quantize/quantize.py: _quantize_kernel
//     x (R, C) float32 or bfloat16 -> q int32 and recon float32, (R, C).
//
// What it computes, bit for bit as the reference's kernel does in interpret
// mode, for element e (its flat index i * C + j in the (R, C) input):
//   d     = x - lo
//   val   = d * inv                         without dither
//   val   = fmaf(d, inv, u(e))              with dither: one rounding
//   q     = clip(floor(val), 0, n_levels - 1)
//   recon = fmaf(q + 0.5, step, lo)         one rounding
// inv is the float32 reciprocal of the float32 step (the reference's
// `/ step` divides by a compile-time constant, which XLA turns into a
// product with its reciprocal and fuses with the dither's add).
// The dither hashes z = uint32(e) + uint32(seed) (wrapping): z *= 2654435761,
// z ^= z >> 16, z *= 2246822519, z ^= z >> 13, u = float(z) / 2^32 - 0.5
// with float(z) rounded to nearest.  Every step is spelled with an
// explicitly rounded intrinsic or fmaf, so the compiler fuses nothing on
// its own: the codes must be exact at bin edges, which is also why this
// kernel is CUDA and not Triton (whose compiler picks its contractions).
//
// What bounds it: one streaming pass, 2 (bf16) or 4 (float32) bytes read
// and 8 written per element, a few dozen operations per element: bytes,
// at 3.35 TB/s (0.40 ms for the served rwkv6-1.6b's 134 M-element bf16
// embedding).  What the design does about it, simply: a CTA of 256
// threads takes `block` rows (the reference's row tile), each thread four
// consecutive elements at a time, with 16-byte float4 loads and stores
// (8-byte for bf16) where the element count allows, else scalar ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  float lo;
  float step;
  float inv;  // float32 reciprocal of step
  float top;  // n_levels - 1
  int dither;
  uint32_t seed;
};

__device__ __forceinline__ void quantize_one(float xv, long long e,
                                             const Params& p, int* q,
                                             float* rc) {
  const float d = __fsub_rn(xv, p.lo);
  float val;
  if (p.dither) {
    uint32_t z = static_cast<uint32_t>(e) + p.seed;
    z *= 2654435761u;
    z ^= z >> 16;
    z *= 2246822519u;
    z ^= z >> 13;
    const float u = __fsub_rn(__fmul_rn(__uint2float_rn(z), 0x1p-32f), 0.5f);
    val = fmaf(d, p.inv, u);
  } else {
    val = __fmul_rn(d, p.inv);
  }
  const float qf = fminf(fmaxf(floorf(val), 0.f), p.top);
  *q = static_cast<int>(qf);
  *rc = fmaf(__fadd_rn(qf, 0.5f), p.step, p.lo);
}

__device__ __forceinline__ float4 load4(const float* x) {
  return __ldg(reinterpret_cast<const float4*>(x));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(x));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* x) { return __ldg(x); }

__device__ __forceinline__ float load1(const __nv_bfloat16* x) {
  return __bfloat162float(x[0]);
}

// kVec: the tile and the element count are multiples of 4, so every group
// of four lies inside the tile and is 16-byte aligned (8 for bf16).
template <class T, bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int* __restrict__ q,
                float* __restrict__ recon, long long n, long long tile,
                Params p) {
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long end = min(start + tile, n);
  for (long long e = start + 4LL * threadIdx.x; e < end;
       e += 4LL * kThreads) {
    if constexpr (kVec) {
      const float4 xv = load4(x + e);
      int4 qv;
      float4 rv;
      quantize_one(xv.x, e, p, &qv.x, &rv.x);
      quantize_one(xv.y, e + 1, p, &qv.y, &rv.y);
      quantize_one(xv.z, e + 2, p, &qv.z, &rv.z);
      quantize_one(xv.w, e + 3, p, &qv.w, &rv.w);
      *reinterpret_cast<int4*>(q + e) = qv;
      *reinterpret_cast<float4*>(recon + e) = rv;
    } else {
      for (long long a = e; a < e + 4 && a < end; ++a)
        quantize_one(load1(x + a), a, p, q + a, recon + a);
    }
  }
}

template <class T>
int launch(const void* x, void* q, void* recon, long long rows,
           long long cols, long long block, const Params& p,
           cudaStream_t stream) {
  const long long n = rows * cols;
  const long long tile = block * cols;
  const unsigned grid = static_cast<unsigned>((rows + block - 1) / block);
  const T* xt = static_cast<const T*>(x);
  int* qt = static_cast<int*>(q);
  float* rt = static_cast<float*>(recon);
  if (n % 4 == 0 && tile % 4 == 0)
    quantize_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, qt, rt, n,
                                                            tile, p);
  else
    quantize_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, qt, rt, n,
                                                             tile, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6.  x (rows, cols) float32 (dtype 0) or bfloat16 (dtype 1); q int32 and
// recon float32 (rows, cols); contiguous, 16-byte aligned; block rows per
// CTA (1 <= block <= rows); inv = float32(1 / step); n_levels - 1 exact in
// float32.
int quantize_forward(const void* x, void* q, void* recon, long long rows,
                     long long cols, long long block, float lo, float step,
                     float inv, int n_levels, int dither, unsigned seed,
                     int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || block <= 0 || block > rows || n_levels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{lo, step, inv, static_cast<float>(n_levels - 1), dither,
                 static_cast<uint32_t>(seed)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, q, recon, rows, cols, block, p, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, q, recon, rows, cols, block, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
