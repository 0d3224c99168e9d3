// DropBlock for NVIDIA Hopper (sm_90a): the keep-mask and the rescaled apply.
//
// dropblock_mask_kernel and dropblock_mask_tiled_kernel replace the TPU
// kernel axcnn/pallas/dropblock.py: _make_kernel / dropblock_mask_pallas (the
// pallas_call at line 100). Per sample n:
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
// What bounds the mask: nothing much. The maps are small (14x14 and 7x7 on
// the assembled R50), so the cost is one launch plus writing N*H*W floats.
// One CTA per sample. A map of up to kWholeMapHW pixels (the presets')
// takes dropblock_mask_kernel: its centre and row-max maps live whole
// in shared memory as bytes, one hash per pixel. A larger map takes
// dropblock_mask_tiled_kernel, which walks it in tiles of R rows by Wt
// columns: a row band, and column tiles only where W + bs - 1 exceeds the
// shared buffer. A tile's row-max map, with its bs - 1 columns of halo,
// lives in shared memory (at most kRowhitBytes, whatever H*W); the rows of
// halo are not stored: the hash is stateless, so each row-max recomputes
// the bs centres above and below it. Either way the count is a block
// reduction over integers, so it is exact, and the two kernels compute the
// same mask.
//
// A window of rows (spatial partitioning: a rank holds rows [row0, row0 + h)
// of a map of h_global rows): the pixel index is the global one,
// (row0 + r) * W + c, and the centre region is tested in global rows, so the
// window's mask is the global mask's rows, bit for bit. Such a window takes
// the tiled kernel, which recomputes the centres of the rows above and below
// it from the stateless hash: no halo exchange. Its counts are the window's;
// the caller sums them over the spatial row. That is the route of a global
// map past kWholeMapHW only: a spatial site within it takes
// dropblock_fused_kernel with a window (below), which needs no sum over ranks.
//
// dropblock_apply_kernel replaces the apply that dropblock_pallas
// (axcnn/pallas/dropblock.py:133-135) left to XLA, forward and backward:
//
//   scale = numel / (max(sum(counts), 1) * C)          fp32, in this order
//
// where numel and the counts may be the global batch's (spatial
// partitioning: the counts of every data shard, the element count of the
// whole batch), not only this tensor's n samples.
//   y     = (x * mask[n, h, w]) * scale                forward
//   dx    = (g * scale) * mask[n, h, w]                backward (autograd's order)
//
// each product rounded once in fp32 (__fmul_rn: no contraction), the result
// cast once to the tensor's type, so it is bit-identical to the plain
// version (dropblock_apply_reference and autograd through it), infinities
// and NaNs included. What bounds it: bytes, 2 * itemsize per element (read
// x, write y) plus 4 per pixel of mask; two fp32 multiplies per element are
// far below the card's rate. The design streams: a grid-stride loop over
// dense NHWC in 16-byte vectors (8 bf16 or 4 fp32 channels of one pixel),
// each thread issuing kApplyUnroll independent loads before its stores, the
// pixel's mask value loaded once per vector, streaming loads and stores.
// Each CTA forms the scale itself (one warp sums the N counts from L2 while
// the CTA's first loads are in flight), so no eager op and no cross-CTA
// reduction sits between the mask kernel and the apply. The counts are
// integers; the warp sums them in 64-bit integers, exactly in any order, and
// rounds the total to fp32 once, as the plain version does. Widths whose
// C * itemsize is not a multiple of 16 bytes, or a tensor that is not
// 16-byte aligned, take the same loop one element at a time.
//
// dropblock_fused_kernel draws the mask and applies it forward in one
// cooperative launch (cudaLaunchCooperativeKernel), for maps whose two byte
// maps fit shared memory (h * w <= kWholeMapHW, the presets' 14x14 and 7x7
// far inside). The mask kernel's work is tiny (a few hundred hashes a
// sample); what it cost was its own launch, and the apply's launch waiting
// on it. The fused grid is the apply's persistent grid, sized to what can be
// resident at once (the runtime refuses a cooperative grid that cannot be,
// so the grid-wide barrier cannot deadlock):
//
//   phase 0  each thread issues its first kApplyUnroll streaming loads of x,
//            which do not depend on the mask: they are in flight across
//            phase 1 and the barrier (a CTA that draws a mask issues them
//            after drawing it: its seed loads and mask stores would
//            otherwise queue behind the grid's first loads, 13 MB at the
//            presets' sites);
//   phase 1  CTA b draws samples b, b + grid, ... exactly as
//            dropblock_mask_kernel does (the same device function, on byte
//            maps in dynamic shared memory), writing the mask and counts;
//   barrier  cooperative_groups::this_grid().sync();
//   phase 2  the forward apply, reading the mask and counts written in this
//            launch through L2 (__ldcg): the non-coherent path (__ldg) is
//            only for data written before the launch.
//
// So its mask, counts and output are bit-identical to the two launches'.
// What bounds it: the apply's bytes, and before its first store the mask
// phase's serial latency and the barrier, which on an H100 cost about what
// the saved launch did. Larger maps take the mask kernel (whole-map or
// tiled), then the apply.
//
// The same launch serves a spatial site (a rank holds rows [row0, row0 + h)
// of its n samples first .. first + n - 1 of a global batch of n_global,
// whose maps have h_global rows), for global maps within kWholeMapHW; the
// main path's site is its trivial window (row0 = 0, h = h_global, first = 0,
// n_global = n). The scale needs every global sample's count over its whole
// map. The TPU program got it from a sum that GSPMD inserted; the windowed
// route above sums the window counts over the ranks between its two
// launches. But every rank has the global batch's seeds, and the hash is
// stateless in (seed, global pixel): so in phase 1 CTA b draws global
// samples b, b + grid, ... over the whole global map (a 448^2 step's sites
// are 28x28 and 14x14), writes each one's count, and for this rank's
// samples the window's rows of its mask. The counts are integers, so they
// equal the windows' sum over ranks exactly, and mask, counts and output are
// bit-identical to the windowed mask, the counts' sum and the apply. It
// costs n_global whole-map draws instead of n windows, a few hundred hashes
// a sample, and saves the mask's launch and the counts' collective.
//
// Plain C interface, loaded with ctypes; each entry returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWholeMapHW = 16384;       // whole-map kernel: two byte maps in shared memory
constexpr int kRowhitBytes = 47 * 1024;  // tiled kernel: one tile's row-max map, halo included

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

struct MaskGeom {
  int h, w, bs, half0, half1;  // h: the global map's rows
  int row0;                    // the window's first global row
  float gamma;
  uint32_t key;
};

// the block centre at the window's row r (global row row0 + r) and column
// c: drawn at rate gamma in the valid region, 0 elsewhere and outside the map
__device__ __forceinline__ bool centre_at(const MaskGeom& g, int r, int c) {
  r += g.row0;
  if (r < g.half0 || r >= g.h - g.half1 || c < g.half0 || c >= g.w - g.half1) return false;
  const uint32_t bits = fmix32(g.key ^ (uint32_t)(r * g.w + c));
  return (float)(bits >> 8) * (1.0f / 16777216.0f) < g.gamma;
}

// counts[n] = the sum over the block of each thread's ``kept``
__device__ __forceinline__ void store_count(int kept, float* __restrict__ counts, int n) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += warp_sums[i];
    counts[n] = (float)total;
  }
}

// one sample's keep-mask, its whole map in shared memory: ``centre`` and
// ``rowhit`` hold h * w bytes each; writes counts[n], the whole map's, and
// rows row0 .. row0 + rows - 1 of the mask into mask_n, unless it is null
__device__ __forceinline__ void mask_whole_map(uint32_t key, float gamma, float* mask_n,
                                               float* counts, int n, int h, int w, int bs,
                                               unsigned char* centre, unsigned char* rowhit,
                                               int row0, int rows) {
  const int hw = h * w;
  const int half0 = (bs - 1) / 2, half1 = bs / 2;
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
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int r = p / w, c = p % w;
    unsigned char acc = 0;
    for (int d = -half1; d <= half0; ++d) {
      const int cc = c - d;
      if (cc >= 0 && cc < w) acc |= rowhit[r * w + cc];
    }
    if (mask_n != nullptr && r >= row0 && r < row0 + rows)
      mask_n[p - row0 * w] = acc ? 0.0f : 1.0f;
    kept += acc ? 0 : 1;
  }
  store_count(kept, counts, n);
}

// h * w <= kWholeMapHW
__global__ void dropblock_mask_kernel(const int32_t* __restrict__ seeds,
                                      float gamma, float* __restrict__ mask,
                                      float* __restrict__ counts, int h, int w,
                                      int bs) {
  __shared__ unsigned char centre[kWholeMapHW];
  __shared__ unsigned char rowhit[kWholeMapHW];
  const int n = blockIdx.x;
  mask_whole_map(fmix32((uint32_t)seeds[n]), gamma, mask + (long long)n * h * w, counts, n, h,
                 w, bs, centre, rowhit, 0, h);
}

// tiles: rows [r0, r0 + rows) by columns [c0, c0 + cols) of the window's h
// rows (global rows row0 .. row0 + h - 1 of h_global); the row-max map holds
// columns c0 - half0 .. c0 + cols - 1 + half1
__global__ void dropblock_mask_tiled_kernel(const int32_t* __restrict__ seeds,
                                            float gamma, float* __restrict__ mask,
                                            float* __restrict__ counts, int h, int w,
                                            int bs, int tile_rows, int tile_cols, int row0,
                                            int h_global) {
  __shared__ unsigned char rowhit[kRowhitBytes];
  const int n = blockIdx.x;
  const MaskGeom g{h_global, w, bs, (bs - 1) / 2, bs / 2, row0, gamma,
                   fmix32((uint32_t)seeds[n])};
  float* mask_n = mask + (long long)n * h * w;
  int kept = 0;
  for (int r0 = 0; r0 < h; r0 += tile_rows) {
    const int rows = min(tile_rows, h - r0);
    for (int c0 = 0; c0 < w; c0 += tile_cols) {
      const int cols = min(tile_cols, w - c0);
      const int ext = cols + bs - 1;
      // rows: hit[r] = max over centre[r - d], d in -half1..half0
      for (int p = threadIdx.x; p < rows * ext; p += blockDim.x) {
        const int r = r0 + p / ext, c = c0 - g.half0 + p % ext;
        unsigned char acc = 0;
        if (c >= 0 && c < w)
          for (int d = -g.half1; d <= g.half0; ++d) acc |= centre_at(g, r - d, c) ? 1 : 0;
        rowhit[p] = acc;
      }
      __syncthreads();
      // columns, then the keep-mask and this thread's share of the count
      for (int p = threadIdx.x; p < rows * cols; p += blockDim.x) {
        const int i = p / cols, j = p % cols;
        unsigned char acc = 0;
        // column c0 + j - d sits at j - d + half0 in the tile's row
        for (int d = -g.half1; d <= g.half0; ++d) acc |= rowhit[i * ext + j - d + g.half0];
        mask_n[(long long)(r0 + i) * w + c0 + j] = acc ? 0.0f : 1.0f;
        kept += acc ? 0 : 1;
      }
      __syncthreads();
    }
  }
  store_count(kept, counts, n);
}

constexpr int kApplyThreads = 256;
constexpr int kApplyUnroll = 4;     // independent 16-byte loads in flight per thread
constexpr int kApplyCtasPerSm = 8;  // 8 x 256 threads: a full SM

struct ApplyArgs {
  const void* src;
  const float* mask;
  const float* counts;
  void* dst;
  float numel;           // the element count as the plain version's fp32 value
  int n, c;
  int n_counts;          // the counts' length (n, or the global batch's)
  long long units;       // vectors (or elements) in the tensor
  long long per_pixel;   // vectors (or elements) per pixel: C / (16 / itemsize), or C
  bool backward;
};

// (v * a) * b, each product rounded once
__device__ __forceinline__ float mul2(float v, float a, float b) {
  return __fmul_rn(__fmul_rn(v, a), b);
}

__device__ __forceinline__ float apply_unit(float v, float a, float b) { return mul2(v, a, b); }

__device__ __forceinline__ __nv_bfloat16 apply_unit(__nv_bfloat16 v, float a, float b) {
  return __float2bfloat16_rn(mul2(__bfloat162float(v), a, b));
}

__device__ __forceinline__ float4 apply_unit(float4 v, float a, float b) {
  return make_float4(mul2(v.x, a, b), mul2(v.y, a, b), mul2(v.z, a, b), mul2(v.w, a, b));
}

__device__ __forceinline__ uint32_t apply_bf16x2(uint32_t bits, float a, float b) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&bits);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(mul2(f.x, a, b), mul2(f.y, a, b));
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 bf16 channels of one pixel
__device__ __forceinline__ uint4 apply_unit(uint4 v, float a, float b) {
  return make_uint4(apply_bf16x2(v.x, a, b), apply_bf16x2(v.y, a, b),
                    apply_bf16x2(v.z, a, b), apply_bf16x2(v.w, a, b));
}

// the unit a thread moves: 16 bytes of channels, or one element
template <typename T, bool kVec> struct UnitOf { using type = T; };
template <> struct UnitOf<float, true> { using type = float4; };
template <> struct UnitOf<__nv_bfloat16, true> { using type = uint4; };

// a mask or count value: written before this launch, through the
// non-coherent cache; written by this launch (the fused kernel), through L2
template <bool kSameLaunch>
__device__ __forceinline__ float load_mask(const float* p) {
  return kSameLaunch ? __ldcg(p) : __ldg(p);
}

// the scale every thread of the CTA applies: warp 0 sums the counts (they
// are integers, summed exactly in 64 bits), then rounds to fp32 once
template <bool kSameLaunch>
__device__ __forceinline__ float cta_scale(const ApplyArgs& args) {
  __shared__ float s_scale;
  if (threadIdx.x < 32) {
    long long sum = 0;
    for (int k = threadIdx.x; k < args.n_counts; k += 32)
      sum += (long long)load_mask<kSameLaunch>(args.counts + k);
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (threadIdx.x == 0)
      s_scale = __fdiv_rn(args.numel, __fmul_rn(fmaxf(__ll2float_rn(sum), 1.0f), (float)args.c));
  }
  __syncthreads();
  return s_scale;
}

// the grid-stride loop from unit i on, its first round's units and mask
// values already loaded into v and m
template <bool kSameLaunch, typename Unit, typename Index>
__device__ __forceinline__ void apply_stream(const ApplyArgs& args, Unit (&v)[kApplyUnroll],
                                             float (&m)[kApplyUnroll], Index i, float s) {
  const Unit* __restrict__ in = static_cast<const Unit*>(args.src);
  Unit* __restrict__ out = static_cast<Unit*>(args.dst);
  const Index units = (Index)args.units, per_pixel = (Index)args.per_pixel;
  const Index stride = (Index)gridDim.x * kApplyThreads;
  for (; i < units; i += kApplyUnroll * stride) {
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const Index j = i + u * stride;
      if (j < units) {
        // forward (x * m) * s; backward (g * s) * m
        const float a = args.backward ? s : m[u], b = args.backward ? m[u] : s;
        __stcs(out + j, apply_unit(v[u], a, b));
      }
    }
    const Index next = i + kApplyUnroll * stride;
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const Index j = next + u * stride;
      if (j < units) {
        v[u] = __ldcs(in + j);
        m[u] = load_mask<kSameLaunch>(args.mask + j / per_pixel);
      }
    }
  }
}

// v[u] = in[i + u * stride] for the units below ``units``
template <typename Unit, typename Index>
__device__ __forceinline__ void load_units(const Unit* __restrict__ in, Unit (&v)[kApplyUnroll],
                                           Index i, Index stride, Index units) {
#pragma unroll
  for (int u = 0; u < kApplyUnroll; ++u) {
    const Index j = i + u * stride;
    if (j < units) v[u] = __ldcs(in + j);
  }
}

template <typename T, bool kVec, typename Index>
__global__ void __launch_bounds__(kApplyThreads) dropblock_apply_kernel(ApplyArgs args) {
  using Unit = typename UnitOf<T, kVec>::type;
  const Unit* __restrict__ in = static_cast<const Unit*>(args.src);
  const Index units = (Index)args.units, per_pixel = (Index)args.per_pixel;
  const Index stride = (Index)gridDim.x * kApplyThreads;
  Unit v[kApplyUnroll];
  float m[kApplyUnroll];
  const Index i = (Index)blockIdx.x * kApplyThreads + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kApplyUnroll; ++u) {
    const Index j = i + u * stride;
    if (j < units) {
      v[u] = __ldcs(in + j);
      m[u] = __ldg(args.mask + j / per_pixel);
    }
  }
  // warp 0 forms the scale while the first loads are in flight
  const float s = cta_scale<false>(args);
  apply_stream<false>(args, v, m, i, s);
}

struct FusedArgs {
  ApplyArgs apply;        // mask: this rank's window, (n, h, w), and counts: the global
                          // batch's, n_counts of them, both written by phase 1
  const int32_t* seeds;   // the global batch's, n_counts of them
  float gamma;
  int h_global, w, bs;
  int row0, h;            // the window: global rows row0 .. row0 + h - 1
  int first;              // this rank's first sample in the global batch
};

// forward only; h_global * w <= kWholeMapHW; dynamic shared memory
// 2 * h_global * w bytes
template <typename T, bool kVec, typename Index>
__global__ void __launch_bounds__(kApplyThreads) dropblock_fused_kernel(FusedArgs args) {
  using Unit = typename UnitOf<T, kVec>::type;
  extern __shared__ unsigned char maps[];  // centre, then rowhit, of the global map
  const ApplyArgs& ap = args.apply;
  const Unit* __restrict__ in = static_cast<const Unit*>(ap.src);
  const Index units = (Index)ap.units, per_pixel = (Index)ap.per_pixel;
  const Index stride = (Index)gridDim.x * kApplyThreads;
  Unit v[kApplyUnroll];
  float m[kApplyUnroll];
  const Index i = (Index)blockIdx.x * kApplyThreads + threadIdx.x;
  const int n_global = ap.n_counts;
  // phase 0: the first loads of x, in flight across the mask and the barrier;
  // a CTA that draws a mask issues its own after drawing, so that its seed
  // loads and mask stores do not queue behind the grid's loads (on an H100
  // this order took less time a launch than every CTA loading first)
  const bool draws = blockIdx.x < (unsigned)n_global;
  if (!draws) load_units<Unit>(in, v, i, stride, units);
  // phase 1: every sample of the global batch over the whole global map,
  // one at a time per CTA; its count always, its window's rows only for
  // this rank's samples
  const int hw = args.h_global * args.w;
  float* mask = const_cast<float*>(ap.mask);
  float* counts = const_cast<float*>(ap.counts);
  for (int g = blockIdx.x; g < n_global; g += gridDim.x) {
    const int local = g - args.first;
    float* mask_n = local >= 0 && local < ap.n
                        ? mask + (long long)local * args.h * args.w : nullptr;
    mask_whole_map(fmix32((uint32_t)args.seeds[g]), args.gamma, mask_n, counts, g,
                   args.h_global, args.w, args.bs, maps, maps + hw, args.row0, args.h);
  }
  if (draws) load_units<Unit>(in, v, i, stride, units);
  // every sample's mask and count is written and visible to the whole grid
  cooperative_groups::this_grid().sync();
  // phase 2: the forward apply
#pragma unroll
  for (int u = 0; u < kApplyUnroll; ++u) {
    const Index j = i + u * stride;
    if (j < units) m[u] = __ldcg(ap.mask + j / per_pixel);
  }
  const float s = cta_scale<true>(ap);
  apply_stream<true>(ap, v, m, i, s);
}

template <typename T, bool kVec>
int launch_apply(const ApplyArgs& args, unsigned grid, bool narrow, cudaStream_t stream) {
  if (narrow)
    dropblock_apply_kernel<T, kVec, uint32_t><<<grid, kApplyThreads, 0, stream>>>(args);
  else
    dropblock_apply_kernel<T, kVec, unsigned long long><<<grid, kApplyThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

// the device's SM count, or a negative CUDA error code
int sm_count() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? sms : -(int)err;
}

// the apply's unit: 16 bytes of channels where C * itemsize and both
// pointers allow, else one element
bool vector_units(const void* src, const void* dst, long long c, long long item) {
  return c * item % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dst) % 16 == 0;
}

// 32-bit indices when no index the loop forms (below units + 2 * grid *
// per_cta: the next round's loads) reaches 2^32
bool narrow_index(long long units, long long grid) {
  return units + 2 * grid * (long long)kApplyThreads * kApplyUnroll <= 0xffffffffLL;
}

// a cooperative launch of grid min(want, sms * min(kApplyCtasPerSm, the
// CTAs of this kernel an SM holds with ``smem`` bytes)), the occupancy
// asked of the runtime on every call
template <typename T, bool kVec, typename Index>
int launch_fused_as(FusedArgs args, long long want, int sms, size_t smem, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&dropblock_fused_kernel<T, kVec, Index>);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  kApplyThreads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  if (err == cudaSuccess) {
    const long long cap = (long long)sms * (per_sm < kApplyCtasPerSm ? per_sm : kApplyCtasPerSm);
    const dim3 grid((unsigned)(want < cap ? want : cap));
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel(kernel, grid, dim3(kApplyThreads), params, smem, stream);
  }
  // a refused launch leaves its error as the last one: clear it so that no
  // later launch reports it
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

template <typename T, bool kVec>
int launch_fused(const FusedArgs& args, long long want, int sms, size_t smem,
                 cudaStream_t stream) {
  // the index width from the largest grid the launch may take
  if (narrow_index(args.apply.units, (long long)sms * kApplyCtasPerSm))
    return launch_fused_as<T, kVec, uint32_t>(args, want, sms, smem, stream);
  return launch_fused_as<T, kVec, unsigned long long>(args, want, sms, smem, stream);
}

}  // namespace

// seeds: (n,) int32 on the device; mask: (n, h, w) fp32, rows row0 ..
// row0 + h - 1 of a map of h_global rows (row0 = 0, h_global = h: the whole
// map); counts: (n,) fp32, the window's. Requires 1 <= bs <= min(h_global, w)
// and h_global * w < 2^31 (the pixel index is an int and a 32-bit hash
// input).
extern "C" int axcnn_dropblock_mask(const void* seeds, float gamma, void* mask,
                                    void* counts, long long n, long long h,
                                    long long w, long long bs, long long row0,
                                    long long h_global, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || row0 < 0 || row0 + h > h_global ||
      h_global * w > 0x7fffffffLL || bs < 1 || bs > h_global || bs > w || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int32_t* sd = static_cast<const int32_t*>(seeds);
  float* m = static_cast<float*>(mask);
  float* cn = static_cast<float*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row0 == 0 && h == h_global && h * w <= kWholeMapHW) {
    dropblock_mask_kernel<<<(unsigned)n, kThreads, 0, st>>>(sd, gamma, m, cn, (int)h,
                                                                 (int)w, (int)bs);
    return (int)cudaGetLastError();
  }
  // the widest tile whose row with its halo fits, then as many rows as fit;
  // bs <= min(h_global, w) <= 46340 < kRowhitBytes, so a tile is never empty
  const long long ext = (w + bs - 1 < kRowhitBytes) ? w + bs - 1 : kRowhitBytes;
  const long long rows = (kRowhitBytes / ext < h) ? kRowhitBytes / ext : h;
  dropblock_mask_tiled_kernel<<<(unsigned)n, kThreads, 0, st>>>(
      sd, gamma, m, cn, (int)h, (int)w, (int)bs, (int)rows, (int)(ext - (bs - 1)), (int)row0,
      (int)h_global);
  return (int)cudaGetLastError();
}

// src, dst: dense NHWC (channels_last) fp32 (dtype 0) or bf16 (dtype 1);
// mask: (n, h*w) fp32; counts: (n_counts,) fp32; numel: the element count
// the scale takes (n*h*w*c, or the global batch's) as fp32. backward 0
// computes (src * mask) * scale, 1 computes (src * scale) * mask.
// Requires n, n_counts and c < 2^31 (ints in the kernel).
extern "C" int axcnn_dropblock_apply(const void* src, const void* mask, const void* counts,
                                     void* dst, int dtype, float numel, long long n,
                                     long long hw, long long c, long long n_counts,
                                     int backward, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || n_counts <= 0 || n > 0x7fffffffLL || c > 0x7fffffffLL ||
      n_counts > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long item = dtype == 1 ? 2 : 4;
  const bool vec = vector_units(src, dst, c, item);
  const long long per_pixel = vec ? c * item / 16 : c;
  const ApplyArgs args{src, static_cast<const float*>(mask), static_cast<const float*>(counts),
                       dst, numel, (int)n, (int)c, (int)n_counts, n * hw * per_pixel, per_pixel,
                       backward != 0};
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const long long per_cta = (long long)kApplyThreads * kApplyUnroll;
  long long grid = (args.units + per_cta - 1) / per_cta;
  if (grid > (long long)sms * kApplyCtasPerSm) grid = (long long)sms * kApplyCtasPerSm;
  const bool narrow = narrow_index(args.units, grid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vec ? launch_apply<__nv_bfloat16, true>(args, (unsigned)grid, narrow, st)
               : launch_apply<__nv_bfloat16, false>(args, (unsigned)grid, narrow, st);
  return vec ? launch_apply<float, true>(args, (unsigned)grid, narrow, st)
             : launch_apply<float, false>(args, (unsigned)grid, narrow, st);
}

// The forward apply of a fresh mask in one cooperative launch, for a rank
// that holds rows row0 .. row0 + h - 1 of samples first .. first + n - 1 of
// a global batch of n_global samples whose maps have h_global rows (the
// whole batch: row0 = 0, h_global = h, first = 0, n_global = n): src, dst
// this rank's dense NHWC fp32 (dtype 0) or bf16 (dtype 1), (n, h, w, c);
// seeds (n_global,) int32, the global batch's; writes mask (n, h, w) fp32,
// the window's rows of the global mask of this rank's samples (what
// axcnn_dropblock_mask gives for the window), counts (n_global,) fp32, every
// global sample's count over its whole map (the window counts' sum over the
// ranks), and dst = (src * mask) * scale with the scale of those counts, as
// axcnn_dropblock_apply does. numel: n_global*h_global*w*c as fp32.
// Requires h_global * w <= kWholeMapHW, 1 <= bs <= min(h_global, w),
// 0 <= first, first + n <= n_global < 2^31, c < 2^31. A launch the runtime
// refuses (cudaErrorCooperativeLaunchTooLarge or any other) returns its
// code; nothing else is tried.
extern "C" int axcnn_dropblock_fused(const void* src, const void* seeds, float gamma, void* dst,
                                     void* mask, void* counts, int dtype, float numel,
                                     long long n, long long h, long long w, long long c,
                                     long long bs, long long row0, long long h_global,
                                     long long first, long long n_global, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c < 0 || row0 < 0 || row0 + h > h_global ||
      h_global * w > kWholeMapHW || bs < 1 || bs > h_global || bs > w || first < 0 ||
      first + n > n_global || n_global > 0x7fffffffLL || c > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long item = dtype == 1 ? 2 : 4;
  const bool vec = vector_units(src, dst, c, item);
  const long long per_pixel = vec ? c * item / 16 : c;
  const FusedArgs args{
      {src, static_cast<const float*>(mask), static_cast<const float*>(counts), dst, numel,
       (int)n, (int)c, (int)n_global, n * h * w * per_pixel, per_pixel, false},
      static_cast<const int32_t*>(seeds), gamma, (int)h_global, (int)w, (int)bs, (int)row0,
      (int)h, (int)first};
  const int sms = sm_count();
  if (sms < 0) return -sms;
  // one CTA a sample to draw, or one a kApplyUnroll rounds of units,
  // whichever is more; the launch caps it at what can be resident
  const long long per_cta = (long long)kApplyThreads * kApplyUnroll;
  const long long units_grid = (args.apply.units + per_cta - 1) / per_cta;
  const long long want = units_grid > n_global ? units_grid : n_global;
  const size_t smem = (size_t)(2 * h_global * w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vec ? launch_fused<__nv_bfloat16, true>(args, want, sms, smem, st)
               : launch_fused<__nv_bfloat16, false>(args, want, sms, smem, st);
  return vec ? launch_fused<float, true>(args, want, sms, smem, st)
             : launch_fused<float, false>(args, want, sms, smem, st);
}
