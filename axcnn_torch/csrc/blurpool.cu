// BlurPool 3x3 / stride 2, forward and backward, for NVIDIA Hopper (sm_90a),
// NHWC.
//
// The forward replaces the TPU kernel axcnn/pallas/blurpool.py:
// _blur3_s2_kernel / blur_pool_pallas (the pallas_call at line 73); the
// backward replaces _blur3_s2_bwd_kernel / blur_pool_pallas_bwd (the
// pallas_call at line 123).
//
//   out[n,i,j,c] = sum_{a,b in 0..2} w[a] w[b] x[n, 2i-1+a, 2j-1+b, c],
//   w = [1,2,1]/4, taps outside the image read as zero (TF fixed padding
//   (1,1)); the output is ceil(H/2) x ceil(W/2).
//
// Backward: dx = D^T g for the linear map D = blur3 o subsample2. Per axis
// (w = [1,2,1]/4, pad (1,1), stride 2), input position p receives
//   even p = 2i:    dx[p] = 0.5 * g[i]
//   odd  p = 2i+1:  dx[p] = 0.25 * (g[i] + g[i+1]),  g[Ho] == 0,
// columns first, then rows, as the Pallas kernel and blur_pool_bwd_reference
// do. With an odd extent the forward read a zero pad at x[H]; the transpose
// never writes that position.
//
// Top padding 0 (pad_top, for a spatially partitioned shard whose first row
// is the halo row the rank above sent): output row i reads input rows 2i,
// 2i+1, 2i+2 and there are (H - 1) / 2 of them; W keeps its padding (1,1).
// That is the padding-1 map one row further down, so both directions run
// the padding-1 code on shifted rows: the forward's rows start at 2i - pad_top
// (0 instead of -1), and the backward is the padding-1 transpose over a
// virtual input of H + 1 rows whose gradient has a zero row on top, with
// the virtual first dx row not written (blur_pool_bwd_reference does the
// same). Each output row is then the unsharded kernel's, bit for bit.
//
// What bounds both: device-memory bytes. The forward reads x once and writes
// a quarter of that (16 fp32 operations per output element); the backward
// reads g and writes four times as much (3 operations per dx element). At
// the main path's shapes the bytes take ~10x longer than the operations at
// the card's fp32 rate.
//
// Arithmetic matches the plain PyTorch versions (blur_pool_reference,
// blur_pool_bwd_reference) term for term, in fp32, rounded once to the
// output dtype: forward rows first, t = ((x[2i-1] + 2 x[2i]) + x[2i+1]) *
// 0.25, then the same along columns; backward as above. Multiplies by 2,
// 0.5 and 0.25 are exact, so results agree bit for bit in fp32 and bf16.
//
// Two routes, chosen per call by the C entry points below (tma_route):
//
// 1. TMA tiles (the main path). Taken when the input and output pointers
//    are 16-byte aligned and C * itemsize is a multiple of 16 bytes -- what
//    a TMA tensor map over dense NHWC can describe -- and a tile's offsets
//    fit in 32 bits. A 4-D CUtensorMap over the
//    NHWC input (dims C, W, H, N) loads one tile per TMA instruction into
//    shared memory:
//      forward:  a halo box of (2*TH+1) rows x (2*TW+1) cols x CB channels
//                starting at input row 2*i0-1, col 2*j0-1, for TH x TW
//                outputs; TMA's out-of-bounds zero fill supplies the
//                padding (1,1) and odd extents, so the inner loop has no
//                bounds checks;
//      backward: a box of (TH+1) x (TW+1) x CB gradients from g[i0, j0],
//                for the 2TH x 2TW dx block; the zero fill supplies
//                g[Ho] = 0 and g[.., Wo] = 0.
//    CB is a run of channels: 512 bytes for the forward (256 bf16 or 128
//    fp32: the longest box row TMA takes, so a box row is long contiguous
//    runs of memory) and 128 bytes for the backward (64 bf16, 32 fp32), or
//    all of C when C is narrower. Each thread computes 16 bytes of channels
//    (8 bf16 / 4 fp32) of two neighbouring output pixels of a row, which
//    share a column sum (forward), or of a 2x2 block of dx pixels
//    (backward) from shared memory and stores them with 16-byte streaming
//    (evict-first) vector stores along C: eight neighbouring threads write
//    one 128-byte run. Every DRAM byte of the input is fetched once; a
//    forward tile's first halo row is the previous row band's last,
//    fetched by a neighbouring CTA at about the same time, so it comes
//    from L2.
//    Tile sizes (tile_plan): TW = all output (gradient) columns, split into
//    equal bands only when a box would exceed its byte budget; TH = the
//    most rows whose box fits the budget, 45 KB for the forward and 32 KB
//    for the backward, then evened out over the row bands. At b128 bf16
//    that gives: forward 56x56x128 -> TH 1, TW 28, box 3x57x128 (42.8 KB);
//    28x28x256 -> TH 1, TW 14, 3x29x256 (43.5 KB); 14x14x512 -> TH 2,
//    TW 7, 5x15x256 (37.5 KB). Backward gradients 28x28x128 -> TH 7, TW
//    28, box 8x29x64 (29.0 KB); 14x14x256 -> TH 14, TW 14, 15x15x64
//    (28.1 KB); 7x7x512 -> TH 7, TW 7, 8x8x64 (8 KB). The budgets, the
//    channel runs, the stage count, the threads per CTA and the store hint
//    were chosen by timing variants on the card (PERF.md, Findings).
//    Pipeline: a persistent grid of as many CTAs as the SMs hold (by the
//    occupancy query), each walking tiles blockIdx.x, +gridDim.x, ...;
//    consecutive tile ids are neighbouring channel blocks, then row bands,
//    of one sample, so neighbours run together. kStages shared-memory
//    stages form a ring with a "full" mbarrier (TMA transaction bytes) and
//    an "empty" mbarrier (one arrival per warp) each; thread 0 keeps the
//    next kStages-1 tiles' loads in flight while all threads compute and
//    store the current one. Tile coordinates are decoded once per tile in
//    32-bit integers; a thread's pixel position advances by a constant
//    step, with no division in the inner loop.
//
// 2. One thread per output element (any C or alignment): the route for
//    inputs TMA cannot describe, e.g. C * itemsize not a multiple of 16 or
//    a tensor at a misaligned storage offset. Scalar loads and stores,
//    64-bit index math.
//
// Both routes take dense NHWC tensors. The tensor map is encoded per call
// (it holds the base pointer) through the driver's cuTensorMapEncodeTiled,
// found with dlopen/dlsym, so the library links against the runtime only.
// What stays the same from call to call (the kernel's shared-memory limit,
// its CTAs per SM at a stage size, the SM count) is queried once and kept.
//
// Plain C interface, loaded with ctypes; every entry point returns
// cudaGetLastError() after its launch, or: cudaErrorInvalidValue for
// arguments it does not take, kErrNoDriverEntry when the driver has no
// cuTensorMapEncodeTiled or cuCtxGetCurrent, kErrTensorMap + the CUresult
// when encoding fails.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kErrNoDriverEntry = 9999;
constexpr int kErrTensorMap = 10000;

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

// ---------------------------------------------------------------------------
// Route 2: one thread per output element
// ---------------------------------------------------------------------------

// x is (n, h, w, c), y is (n, ho, wo, c), both contiguous.
template <typename T>
__global__ void blur3_s2_thread_kernel(const T* __restrict__ x, T* __restrict__ y,
                                       int h, int w, int c, int ho, int wo, int pad_top,
                                       long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  long long r = idx / c;
  const int j = (int)(r % wo);
  r /= wo;
  const int i = (int)(r % ho);
  const long long n = r / ho;
  const T* xn = x + n * h * w * (long long)c + ch;
  float t[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int q = 2 * j - 1 + b;
    float rows[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int p = 2 * i - pad_top + a;
      rows[a] = (p >= 0 && p < h && q >= 0 && q < w) ? to_f32(xn[((long long)p * w + q) * c]) : 0.0f;
    }
    t[b] = (rows[0] + 2.0f * rows[1] + rows[2]) * 0.25f;
  }
  y[idx] = from_f32<T>((t[0] + 2.0f * t[1] + t[2]) * 0.25f);
}

// column pass of the backward at gradient row i for input column q; rows
// outside [0, ho) are zeros
template <typename T>
__device__ __forceinline__ float bwd_row_t(const T* gn, int i, int q, int ho, int wo, int c) {
  if (i < 0 || i >= ho) return 0.0f;
  const int j = q >> 1;
  const float a = to_f32(gn[((long long)i * wo + j) * c]);
  if ((q & 1) == 0) return 0.5f * a;
  const float b = (j + 1 < wo) ? to_f32(gn[((long long)i * wo + j + 1) * c]) : 0.0f;
  return 0.25f * (a + b);
}

// g is (n, ho, wo, c), dx is (n, h, w, c), both contiguous; a dx row p is
// row p + 1 - pad_top of the padding-1 transpose, whose gradient row i is
// g's row i - (1 - pad_top).
template <typename T>
__global__ void blur3_s2_bwd_thread_kernel(const T* __restrict__ g, T* __restrict__ dx,
                                           int h, int w, int c, int ho, int wo, int pad_top,
                                           long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  long long r = idx / c;
  const int q = (int)(r % w);
  r /= w;
  const int p = (int)(r % h);
  const long long n = r / h;
  const T* gn = g + n * ho * wo * (long long)c + ch;
  const int sh = 1 - pad_top, v = p + sh, i = (v >> 1) - sh;
  const float t0 = bwd_row_t(gn, i, q, ho, wo, c);
  float out;
  if ((v & 1) == 0) {
    out = 0.5f * t0;
  } else {
    out = 0.25f * (t0 + bwd_row_t(gn, i + 1, q, ho, wo, c));
  }
  dx[idx] = from_f32<T>(out);
}

// ---------------------------------------------------------------------------
// Route 1: TMA tiles in shared memory, mbarrier ring, persistent grid
// ---------------------------------------------------------------------------

// The tuning constants, chosen by timing variants on the card (PERF.md, Findings)
constexpr int kTmaThreads = 256;
constexpr int kStages = 3;
// a TMA box's byte budget; tile_plan keeps every box within it
constexpr int kFwdBoxBytes = 45 * 1024;
constexpr int kBwdBoxBytes = 32 * 1024;
// channels per tile, in bytes (at most 256 elements: a TMA box's limit)
constexpr int kFwdCbBytes = 512;
constexpr int kBwdCbBytes = 128;

// a streaming (evict-first) 16-byte store of an output vector
template <typename P>
__device__ __forceinline__ void store16(void* dst, const P& v) {
  static_assert(sizeof(P) == 16, "16-byte vectors only");
  __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(&v));
}

struct TilePlan {
  int h, w, c;          // the forward's input x; for the backward the virtual dx (h + sh rows)
  int ho, wo;           // the output's rows and ceil(w/2); the backward: ceil(h/2) (virtual)
  int pad_top, sh;      // the top padding, 1 or 0, and sh = 1 - pad_top
  int hr;               // dx's rows (the backward)
  int th, tw;           // a tile's output (forward) or gradient (backward) rows, cols
  int cb;               // channels per tile
  int n_cb, n_wb, n_hb; // tiles along C, columns, rows
  int tiles;            // n * n_hb * n_wb * n_cb
  int box_bytes;        // one TMA box: the mbarrier's transaction bytes
  int stage_bytes;      // box_bytes rounded up to 128
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 4-D tensor-map box (coordinates innermost first: c, w, h, n) into
// shared memory; completion counts the box's bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

struct Tile {
  int n, i0, j0, c0;
};

// tile id -> (sample, first row, first column, first channel); channel
// blocks vary fastest, then column and row bands, then the sample
__device__ __forceinline__ Tile decode_tile(const TilePlan& p, int t) {
  Tile r;
  const int cbk = t % p.n_cb;
  t /= p.n_cb;
  const int wb = t % p.n_wb;
  t /= p.n_wb;
  const int hb = t % p.n_hb;
  r.n = t / p.n_hb;
  r.i0 = hb * p.th;
  r.j0 = wb * p.tw;
  r.c0 = cbk * p.cb;
  return r;
}

template <typename T, int VEC, bool BWD>
__device__ __forceinline__ void tma_tiles(const CUtensorMap* map, T* __restrict__ out,
                                          const TilePlan& p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * p.stage_bytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTmaThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int count = (p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;  // grid <= tiles
  // thread 0 only: load this CTA's k-th tile into stage k % kStages; the
  // forward's halo box starts one row and one column before the tile
  auto issue = [&](int k) {
    const int s = k % kStages;
    const Tile t = decode_tile(p, blockIdx.x + k * gridDim.x);
    mbar_arrive_expect_tx(&full[s], p.box_bytes);
    tma_load_4d(smem + s * p.stage_bytes, map, &full[s], t.c0, BWD ? t.j0 : 2 * t.j0 - 1,
                BWD ? t.i0 - p.sh : 2 * t.i0 - p.pad_top, t.n);
  };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
    for (int k = 0; k < count && k < kStages; ++k) issue(k);
  }

  // this thread's 16-byte channel vector and first position; positions
  // advance by `lanes` through the tile's TH x GW grid, as (dr, dc) in rows
  // and columns. A forward position is a pair of neighbouring outputs in a
  // row (they share a column sum); a backward position is one gradient,
  // whose 2x2 block of dx the thread writes.
  const int vpp = p.cb / VEC;
  const int lanes = kTmaThreads / vpp;
  const int vec = tid % vpp, pix = tid / vpp;
  const int gw = BWD ? p.tw : (p.tw + 1) / 2;
  const int r0 = pix / gw, c0 = pix % gw;
  const int dr = lanes / gw, dc = lanes % gw;
  const int bw = BWD ? p.tw + 1 : 2 * p.tw + 1;  // box columns
  const int brow = bw * p.cb;                      // elements per box row
  using P = Pack<T, VEC>;

  for (int k = 0; k < count; ++k) {
    const int s = k % kStages;
    const uint32_t parity = (k / kStages) & 1;
    const Tile t = decode_tile(p, blockIdx.x + k * gridDim.x);
    const int ch = t.c0 + vec * VEC;
    const int th = min(p.th, p.ho - t.i0), tw = min(p.tw, p.wo - t.j0);
    const int gv = BWD ? tw : (tw + 1) / 2;  // this tile's positions per row
    const T* xs = reinterpret_cast<const T*>(smem + s * p.stage_bytes) + vec * VEC;
    mbar_wait(&full[s], parity);
    if (pix < lanes && ch < p.c) {
      if constexpr (!BWD) {
        T* yt = out + (((long long)t.n * p.ho + t.i0) * p.wo + t.j0) * p.c + ch;
        for (int r = r0, q = c0; r < th;) {
          if (q < gv) {
            // outputs (r, 2q) and (r, 2q+1) from box columns 4q .. 4q+4
            const T* px = xs + (2 * r * bw + 4 * q) * p.cb;
            const bool two = 2 * q + 1 < tw;
            float tb[5][VEC];
#pragma unroll
            for (int b = 0; b < 5; ++b) {
              if (b < 3 || two) {
                const P a0 = *reinterpret_cast<const P*>(px + b * p.cb);
                const P a1 = *reinterpret_cast<const P*>(px + brow + b * p.cb);
                const P a2 = *reinterpret_cast<const P*>(px + 2 * brow + b * p.cb);
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                  tb[b][v] =
                      (to_f32(a0.v[v]) + 2.0f * to_f32(a1.v[v]) + to_f32(a2.v[v])) * 0.25f;
              }
            }
            P o;
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              o.v[v] = from_f32<T>((tb[0][v] + 2.0f * tb[1][v] + tb[2][v]) * 0.25f);
            store16(yt + (r * p.wo + 2 * q) * p.c, o);
            if (two) {
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                o.v[v] = from_f32<T>((tb[2][v] + 2.0f * tb[3][v] + tb[4][v]) * 0.25f);
              store16(yt + (r * p.wo + 2 * q + 1) * p.c, o);
            }
          }
          r += dr;
          q += dc;
          if (q >= gw) {
            q -= gw;
            ++r;
          }
        }
      } else {
        const int pc = p.w * p.c;  // elements per dx row
        // dx row 2 * (i0 + r) - sh; with sh = 1 the tile's first such row
        // may be -1, which is not stored
        T* dt = out + (((long long)t.n * p.hr + 2 * t.i0 - p.sh) * p.w + 2 * t.j0) * p.c + ch;
        for (int r = r0, q = c0; r < th;) {
          if (q < gv) {
            const T* pg = xs + (r * bw + q) * p.cb;
            const P g00 = *reinterpret_cast<const P*>(pg);
            const P g01 = *reinterpret_cast<const P*>(pg + p.cb);
            const P g10 = *reinterpret_cast<const P*>(pg + brow);
            const P g11 = *reinterpret_cast<const P*>(pg + brow + p.cb);
            P o00, o01, o10, o11;
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              // columns first (t at gradient rows i, i+1), then rows
              const float t0e = 0.5f * to_f32(g00.v[v]);
              const float t0o = 0.25f * (to_f32(g00.v[v]) + to_f32(g01.v[v]));
              const float t1e = 0.5f * to_f32(g10.v[v]);
              const float t1o = 0.25f * (to_f32(g10.v[v]) + to_f32(g11.v[v]));
              o00.v[v] = from_f32<T>(0.5f * t0e);
              o01.v[v] = from_f32<T>(0.5f * t0o);
              o10.v[v] = from_f32<T>(0.25f * (t0e + t1e));
              o11.v[v] = from_f32<T>(0.25f * (t0o + t1o));
            }
            T* d = dt + (2 * r * pc + 2 * q * p.c);
            const bool col1 = 2 * (t.j0 + q) + 1 < p.w, row1 = 2 * (t.i0 + r) + 1 < p.h;
            if (2 * (t.i0 + r) >= p.sh) {
              store16(d, o00);
              if (col1) store16(d + p.c, o01);
            }
            if (row1) {
              store16(d + pc, o10);
              if (col1) store16(d + pc + p.c, o11);
            }
          }
          r += dr;
          q += dc;
          if (q >= gw) {
            q -= gw;
            ++r;
          }
        }
      }
    }
    // release the stage: one arrival per warp, then thread 0 refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && k + kStages < count) {
      mbar_wait(&empty[s], parity);
      issue(k + kStages);
    }
  }
}

// BWD = false: the forward (map over x, out = y); true: the backward (map
// over g, out = dx)
template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(kTmaThreads)
    blur3_s2_tma_kernel(const __grid_constant__ CUtensorMap map, T* __restrict__ out,
                        const TilePlan p) {
  tma_tiles<T, VEC, BWD>(&map, out, p);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*CtxGetCurrentFn)(CUcontext*);

// the two driver calls the host side makes, looked up once
struct Driver {
  EncodeTiledFn encode = nullptr;
  CtxGetCurrentFn ctx_get_current = nullptr;
};

const Driver& driver() {
  static const Driver d = [] {
    Driver r;
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) {
      r.encode = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
      r.ctx_get_current = reinterpret_cast<CtxGetCurrentFn>(dlsym(lib, "cuCtxGetCurrent"));
    }
    return r;
  }();
  return d;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The TMA route's rule: 16-byte aligned pointers, a channel run (and so
// every stride of dense NHWC) a multiple of 16 bytes, extents within
// 32-bit tile math.
bool tma_route(const void* in, const void* out, int es, long long n, long long h,
               long long w, long long c) {
  const long long big = 1LL << 30;
  return (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0 && (c * es) % 16 == 0 &&
         n < big && h < big && w < big && c < big;
}

// Tile sizes (see the header): `in_rows(th)` and `in_cols(tw)` are the box's
// extents for th x tw output (forward) or gradient (backward) positions.
bool tile_plan(TilePlan& p, long long n, int h, int w, int c, int es, bool bwd, int pad_top) {
  p.pad_top = pad_top;
  p.sh = 1 - pad_top;
  p.hr = h;
  p.h = bwd ? h + p.sh : h;
  p.w = w;
  p.c = c;
  p.ho = bwd || pad_top ? (p.h + 1) / 2 : (h - 1) / 2;
  p.wo = (w + 1) / 2;
  const int cb_max = (bwd ? kBwdCbBytes : kFwdCbBytes) / es;
  p.cb = c < cb_max ? c : cb_max;
  p.n_cb = ceil_div(c, p.cb);
  const int pix_bytes = p.cb * es;
  const int budget = bwd ? kBwdBoxBytes : kFwdBoxBytes;
  const int min_rows = bwd ? 2 : 3;  // the box for one row of outputs
  // columns: the widest band whose one-row box fits, then even bands
  int tw_max = bwd ? budget / (min_rows * pix_bytes) - 1 : (budget / (min_rows * pix_bytes) - 1) / 2;
  tw_max = tw_max < 1 ? 1 : tw_max > 127 ? 127 : tw_max;
  p.n_wb = ceil_div(p.wo, tw_max);
  p.tw = ceil_div(p.wo, p.n_wb);
  const int box_cols = bwd ? p.tw + 1 : 2 * p.tw + 1;
  const int box_row_bytes = box_cols * pix_bytes;
  int th_max = bwd ? budget / box_row_bytes - 1 : (budget / box_row_bytes - 1) / 2;
  th_max = th_max < 1 ? 1 : th_max > 127 ? 127 : th_max;
  p.n_hb = ceil_div(p.ho, th_max);
  p.th = ceil_div(p.ho, p.n_hb);
  const int box_rows = bwd ? p.th + 1 : 2 * p.th + 1;
  p.box_bytes = box_rows * box_row_bytes;
  p.stage_bytes = (p.box_bytes + 127) / 128 * 128;
  const long long tiles = n * p.n_hb * p.n_wb * p.n_cb;
  // 32-bit offsets inside a tile: forward th*wo*c, backward 2*th*w*c
  const long long span = (long long)(2 * p.th + 2) * (p.w + 2) * c;
  if (tiles >= (1LL << 30) || span >= INT_MAX) return false;
  p.tiles = (int)tiles;
  return true;
}

// a 4-D map (c, w, h, n) over the dense NHWC input
int encode_nhwc(CUtensorMap* map, const void* base, int dtype, long long n, long long h,
                long long w, long long c, int es, const TilePlan& p, bool bwd) {
  const EncodeTiledFn fn = driver().encode;
  if (fn == nullptr) return kErrNoDriverEntry;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)(c * es), (cuuint64_t)(w * c * es),
                                 (cuuint64_t)(h * w * c * es)};
  const cuuint32_t box[4] = {(cuuint32_t)p.cb,
                             (cuuint32_t)(bwd ? p.tw + 1 : 2 * p.tw + 1),
                             (cuuint32_t)(bwd ? p.th + 1 : 2 * p.th + 1), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

constexpr int kMaxDevices = 64;

int sm_count(int dev) {
  static int count[kMaxDevices] = {0};
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

// Per kernel instantiation and device: the shared-memory limit is set once,
// to what the largest plan can ask (tile_plan keeps a box within its
// budget), and the CTAs per SM are queried once per stage size.
template <typename T, int VEC, bool BWD>
int launch_tma(const CUtensorMap& map, void* out, const TilePlan& p, int dev,
               cudaStream_t stream) {
  constexpr int kBarBytes = 2 * kStages * (int)sizeof(uint64_t);
  constexpr int kMaxSmem = kStages * (BWD ? kBwdBoxBytes : kFwdBoxBytes) + kBarBytes;
  static_assert(kFwdBoxBytes % 128 == 0 && kBwdBoxBytes % 128 == 0, "stages are 128-aligned");
  const int smem = kStages * p.stage_bytes + kBarBytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  constexpr int kSizes = 8;  // stage sizes kept per device (the main path has 3)
  struct Occupancy {
    bool limit_set = false;
    int smem[kSizes] = {0}, per_sm[kSizes] = {0}, next = 0;
  };
  static Occupancy occ[kMaxDevices];
  static std::mutex mu;
  int per_sm = 0, sms = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    sms = sm_count(dev);
    Occupancy& o = occ[dev];
    if (!o.limit_set) {
      const cudaError_t e =
          cudaFuncSetAttribute(blur3_s2_tma_kernel<T, VEC, BWD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      o.limit_set = true;
    }
    for (int i = 0; i < kSizes; ++i)
      if (o.smem[i] == smem) per_sm = o.per_sm[i];
    if (per_sm == 0) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, blur3_s2_tma_kernel<T, VEC, BWD>, kTmaThreads, smem);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) per_sm = 1;
      o.smem[o.next] = smem;
      o.per_sm[o.next] = per_sm;
      o.next = (o.next + 1) % kSizes;
    }
  }
  long long grid = (long long)per_sm * sms;
  if (grid > p.tiles) grid = p.tiles;
  blur3_s2_tma_kernel<T, VEC, BWD><<<(unsigned)grid, kTmaThreads, smem, stream>>>(
      map, static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

constexpr int kThreads = 256;

template <typename T>
int launch_thread(bool bwd, const void* in, void* out, int h, int w, int c, int ho, int wo,
                  int pad_top, long long total, cudaStream_t stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  if (bwd)
    blur3_s2_bwd_thread_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, h, w, c, ho, wo, pad_top, total);
  else
    blur3_s2_thread_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, h, w, c, ho, wo, pad_top, total);
  return (int)cudaGetLastError();
}

// The forward (bwd = false: in = x (n, h, w, c), out = y) or the backward
// (bwd = true: in = g (n, ho, ceil(w/2), c), out = dx (n, h, w, c)), both
// dense NHWC, ho = ceil(h/2) for pad_top 1 and (h - 1) / 2 for 0. *route is
// set to 1 for the TMA route, 0 for the per-thread one.
int blur_dispatch(bool bwd, const void* in, void* out, int dtype, long long n, long long h,
                  long long w, long long c, int pad_top, void* stream, int* route) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || h >= INT_MAX || w > INT_MAX || c > INT_MAX ||
      (dtype != 0 && dtype != 1) || (pad_top != 0 && pad_top != 1) || (!pad_top && h < 3))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const int ho = (int)(pad_top ? (h + 1) / 2 : (h - 1) / 2), wo = (int)((w + 1) / 2);
  const long long in_h = bwd ? ho : h, in_w = bwd ? wo : w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TilePlan p;
  if (tma_route(in, out, es, n, in_h, in_w, c) &&
      tile_plan(p, n, (int)h, (int)w, (int)c, es, bwd, pad_top)) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    // the driver's encode needs a current context; a thread that has made
    // no runtime call yet (autograd's backward thread) may have none
    CUcontext ctx = nullptr;
    const CtxGetCurrentFn get = driver().ctx_get_current;
    if (get == nullptr) return kErrNoDriverEntry;
    if (get(&ctx) != CUDA_SUCCESS || ctx == nullptr) {
      e = cudaSetDevice(dev);
      if (e != cudaSuccess) return (int)e;
    }
    CUtensorMap map;
    const int err = encode_nhwc(&map, in, dtype, n, in_h, in_w, c, es, p, bwd);
    if (err != 0) return err;
    *route = 1;
    if (dtype == 0)
      return bwd ? launch_tma<float, 4, true>(map, out, p, dev, s)
                 : launch_tma<float, 4, false>(map, out, p, dev, s);
    return bwd ? launch_tma<__nv_bfloat16, 8, true>(map, out, p, dev, s)
               : launch_tma<__nv_bfloat16, 8, false>(map, out, p, dev, s);
  }
  *route = 0;
  const long long total = n * (bwd ? h * w : (long long)ho * wo) * c;
  if (dtype == 0)
    return launch_thread<float>(bwd, in, out, (int)h, (int)w, (int)c, ho, wo, pad_top, total, s);
  return launch_thread<__nv_bfloat16>(bwd, in, out, (int)h, (int)w, (int)c, ho, wo, pad_top,
                                      total, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (n, h, w, c), y is
// (n, ho, ceil(w/2), c), both contiguous; pad_top 1: ho = ceil(h/2), pad_top
// 0 (h >= 3): ho = (h - 1) / 2.
extern "C" int axcnn_blur_pool3_s2(const void* x, void* y, int dtype, long long n, long long h,
                                   long long w, long long c, int pad_top, void* stream,
                                   int* route) {
  return blur_dispatch(false, x, y, dtype, n, h, w, c, pad_top, stream, route);
}

// The backward. h, w are the forward INPUT's extents; g is
// (n, ho, ceil(w/2), c) with ho as above, dx is (n, h, w, c), both contiguous.
extern "C" int axcnn_blur_pool3_s2_bwd(const void* g, void* dx, int dtype, long long n,
                                       long long h, long long w, long long c, int pad_top,
                                       void* stream, int* route) {
  return blur_dispatch(true, g, dx, dtype, n, h, w, c, pad_top, stream, route);
}
