// DropBlock keep-mask for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel axcnn/pallas/dropblock.py: _make_kernel /
// dropblock_mask_pallas (the pallas_call at line 100). Per sample n:
//
//   bits[p]  = fmix32(fmix32(seed[n]) ^ p)     p = pixel index r*W + c
//   u[p]     = (bits[p] >> 8) * 2^-24          top 24 bits, as the TPU kernel
//   centre   = u < gamma  and  half0 <= r < H - half1, same for c
//   hit      = separable bs-tap max of the centres over offsets
//              -half1..half0 (rows, then columns), half0 = (bs-1)/2,
//              half1 = bs/2 (a window centred as reduce_window's)
//   mask     = 1 - hit (fp32),  count[n] = sum of mask over the sample
//
// fmix32 is MurmurHash3's 32-bit finalizer (Appleby, public domain): a
// stateless counter-based hash, so the bits depend on (seed, pixel) alone and
// the plain version (dropblock_mask_reference) computes the same ones with
// torch integer ops. The TPU drew from its core PRNG instead; the streams
// differ, the distribution is the same.
//
// What bounds it: nothing much. The maps are small (14x14 and 7x7 on the
// assembled R50), so the cost is one launch plus writing N*H*W floats. One
// CTA per sample; the H x W centre and row-max maps live in shared memory as
// bytes (at most kMaxHW pixels each); the count is a block reduction over
// integers, so it is exact. The apply x * mask * scale stays in PyTorch.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHW = 16384;  // bytes per map in shared memory (2 maps)
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__global__ void dropblock_mask_kernel(const int32_t* __restrict__ seeds,
                                      float gamma, float* __restrict__ mask,
                                      float* __restrict__ counts, int h, int w,
                                      int bs) {
  __shared__ unsigned char centre[kMaxHW];
  __shared__ unsigned char rowhit[kMaxHW];
  __shared__ int warp_sums[kThreads / 32];
  const int n = blockIdx.x;
  const int hw = h * w;
  const int half0 = (bs - 1) / 2, half1 = bs / 2;
  const uint32_t key = fmix32((uint32_t)seeds[n]);

  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int r = p / w, c = p % w;
    const uint32_t bits = fmix32(key ^ (uint32_t)p);
    const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
    const bool valid = r >= half0 && r < h - half1 && c >= half0 && c < w - half1;
    centre[p] = (valid && u < gamma) ? 1 : 0;
  }
  __syncthreads();
  // rows: hit[r] = max over centre[r - d], d in -half1..half0
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int r = p / w, c = p % w;
    unsigned char acc = 0;
    for (int d = -half1; d <= half0; ++d) {
      const int rr = r - d;
      if (rr >= 0 && rr < h) acc |= centre[rr * w + c];
    }
    rowhit[p] = acc;
  }
  __syncthreads();
  // columns, then the keep-mask and this thread's share of the count
  int kept = 0;
  float* mask_n = mask + (long long)n * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int r = p / w, c = p % w;
    unsigned char acc = 0;
    for (int d = -half1; d <= half0; ++d) {
      const int cc = c - d;
      if (cc >= 0 && cc < w) acc |= rowhit[r * w + cc];
    }
    mask_n[p] = acc ? 0.0f : 1.0f;
    kept += acc ? 0 : 1;
  }
  for (int off = 16; off > 0; off >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += warp_sums[i];
    counts[n] = (float)total;
  }
}

}  // namespace

// seeds: (n,) int32 on the device; mask: (n, h, w) fp32; counts: (n,) fp32.
// Requires h * w <= kMaxHW and 1 <= bs <= min(h, w).
extern "C" int axcnn_dropblock_mask(const void* seeds, float gamma, void* mask,
                                    void* counts, long long n, long long h,
                                    long long w, long long bs, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h * w > kMaxHW || bs < 1 || bs > h ||
      bs > w || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dropblock_mask_kernel<<<(unsigned)n, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), gamma, static_cast<float*>(mask),
      static_cast<float*>(counts), (int)h, (int)w, (int)bs);
  return (int)cudaGetLastError();
}
