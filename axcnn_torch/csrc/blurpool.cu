// BlurPool 3x3 / stride 2 forward for NVIDIA Hopper (sm_90a), NHWC.
//
// Replaces the TPU kernel axcnn/pallas/blurpool.py: _blur3_s2_kernel /
// blur_pool_pallas (the pallas_call at line 73).
//
//   out[n,i,j,c] = sum_{a,b in 0..2} w[a] w[b] x[n, 2i-1+a, 2j-1+b, c],
//   w = [1,2,1]/4, taps outside the image read as zero (TF fixed padding
//   (1,1)); the output is ceil(H/2) x ceil(W/2), so odd extents are handled
//   by bounds checks instead of the Pallas version's even-extent gate.
//
// What bounds it: bandwidth only. Each output element costs 9 multiply-adds
// and reads a 3x3 window of which the neighbouring outputs share a part; each
// input element is read about 2.25 times (mostly from L1/L2), each output
// written once. The design is the simple one: one thread per output pixel
// (n, i, j) and a 16-byte run of channels (8 bf16 or 4 fp32), so every load
// and store is a 128-bit access along the contiguous C axis and neighbouring
// threads touch neighbouring addresses. A smem halo tile, TMA, or fusing the
// preceding BN-affine + ReLU are later work.
//
// Arithmetic matches the plain PyTorch version (blur_pool_reference) term for
// term: rows first, t = ((x[2i-1] + 2 x[2i]) + x[2i+1]) * 0.25, then the
// same along columns, in fp32, rounded once to the output dtype. The
// multiplies by 2 and 0.25 are exact, so fp32 results agree bit for bit.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void blur3_s2_kernel(const T* __restrict__ x, T* __restrict__ y,
                                int h, int w, int c, int ho, int wo,
                                long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cvecs = c / VEC;
  const int c0 = (int)(idx % cvecs) * VEC;
  long long r = idx / cvecs;
  const int j = (int)(r % wo);
  r /= wo;
  const int i = (int)(r % ho);
  const long long n = r / ho;
  const T* xn = x + n * h * w * (long long)c;

  float t[3][VEC];  // row-blurred values at columns 2j-1, 2j, 2j+1
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int q = 2 * j - 1 + b;
    float rows[3][VEC];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int p = 2 * i - 1 + a;
      if (p >= 0 && p < h && q >= 0 && q < w) {
        const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(
            xn + ((long long)p * w + q) * c + c0);
#pragma unroll
        for (int v = 0; v < VEC; ++v) rows[a][v] = to_f32(pk.v[v]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) rows[a][v] = 0.0f;
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      t[b][v] = (rows[0][v] + 2.0f * rows[1][v] + rows[2][v]) * 0.25f;
  }

  Pack<T, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    out.v[v] = from_f32<T>((t[0][v] + 2.0f * t[1][v] + t[2][v]) * 0.25f);
  *reinterpret_cast<Pack<T, VEC>*>(
      y + ((n * ho + i) * (long long)wo + j) * c + c0) = out;
}

constexpr int kThreads = 256;

template <typename T, int VEC>
int launch(const void* x, void* y, int h, int w, int c, int ho, int wo,
           long long n, cudaStream_t stream) {
  const long long total = n * ho * wo * (c / VEC);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  blur3_s2_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), h, w, c, ho, wo, total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (n, h, w, c) contiguous, y is
// (n, ceil(h/2), ceil(w/2), c) contiguous. 16-byte vectors when C and both
// pointers allow them, one channel per thread otherwise.
extern "C" int axcnn_blur_pool3_s2(const void* x, void* y, int dtype,
                                   long long n, long long h, long long w,
                                   long long c, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || h > INT_MAX || w > INT_MAX ||
      c > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int ho = (int)((h + 1) / 2), wo = (int)((w + 1) / 2);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (aligned && c % 4 == 0)
      return launch<float, 4>(x, y, (int)h, (int)w, (int)c, ho, wo, n, s);
    return launch<float, 1>(x, y, (int)h, (int)w, (int)c, ho, wo, n, s);
  }
  if (dtype == 1) {
    if (aligned && c % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, y, (int)h, (int)w, (int)c, ho, wo, n, s);
    return launch<__nv_bfloat16, 1>(x, y, (int)h, (int)w, (int)c, ho, wo, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
