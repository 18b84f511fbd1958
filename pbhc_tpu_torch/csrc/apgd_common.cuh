// The solver body both APGD contact kernels share: a tile of E neighbouring
// envs whose Delassus matrices A sit in shared memory, P threads per
// (env, contact), each holding the three solver rows of that contact in
// registers and taking every P-th column of the matvec.
//
// Shared-memory plan of a tile (float offsets, see make_tile):
//   A    [n][srow][E]    A[i][j] of env e at (i * srow + j) * E + e. srow >= n
//                        is a multiple of P with srow / P odd: the 32 lanes of
//                        a warp (E envs x P parts x 32 / (E P) contacts) then
//                        read 32 different banks. Filled by the kernel's own
//                        loader with cp.async (no registers; rows padded).
//   y    [2][E*P][sy]    the momentum point, double-buffered (one barrier per
//                        iteration suffices), per env and part: part p holds
//                        columns p, p + P, ... contiguously, so a thread reads
//                        four of its columns with one 16-byte load; sy / 4 is
//                        odd, so up to 8 (env, part) pairs hit distinct banks
//                        and the lanes of one pair read one word (broadcast).
//   act  [R][E]          the active mask, for the Lipschitz bound.
//   lmax [warps][E]      per-warp partial maxima of the Lipschitz bound.
//
// Thread t of the block: env e = t % E, part p = t / E % P, contact
// r = t / (E P); threads with r >= R or env >= N take part in the barriers
// and shuffles only. An iteration is
//   y = x + beta (x - x_prev)  -> shared y (part 0 writes the 3 rows)
//   barrier
//   partial g = A y over the part's columns of the 3 rows (3 independent
//   chains of n / P FMAs), summed over the P parts by warp shuffles;
//   x = P(y - (g + b) / L), computed alike by the P threads
// so the critical path is n / P dependent FMAs, log2 P shuffles and one
// barrier.
//
// Matvec modes (template parameter T of `iterate`, kernel 1 only): float,
// or a reduced type (__nv_bfloat16, __half) in which A and y enter the
// product as JAX's lanes engine computes it (`contact_matvec_dtype`): A is
// rounded to T once, in place in the f32 tile, by the thread that reads each
// entry for the Lipschitz bound right after it has read the f32 value
// (`inv_lipschitz<T>`), and y when it is written to shared memory; x, b, 1/L
// and the projection stay f32. The product of two bfloat16 values is exact
// in f32, so that mode keeps the FMA; in the float16 mode the product is
// rounded to float16 before it is added (`madd`). The sums are in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace apgd {

constexpr int kWarp = 32;
constexpr int kMaxRows = 42;  // n = 3R <= 128 solver rows

struct Tile {
  int n, threads, srow, sy;
  int a_off, y_off, act_off, lmax_off, floats;
};

__host__ __device__ constexpr Tile make_tile(int R, int E, int P) {
  Tile t{};
  t.n = 3 * R;
  t.threads = (E * P * R + kWarp - 1) / kWarp * kWarp;
  t.srow = t.n;
  while (t.srow % P != 0 || (t.srow / P) % 2 == 0) ++t.srow;
  t.sy = ((t.n + P - 1) / P + 3) & ~3;
  if ((t.sy / 4) % 2 == 0) t.sy += 4;
  t.a_off = 0;
  t.y_off = (t.n * t.srow * E + 3) & ~3;  // 16-byte aligned for the float4 reads
  t.act_off = t.y_off + 2 * E * P * t.sy;
  t.lmax_off = t.act_off + R * E;
  t.floats = t.lmax_off + (t.threads / kWarp) * E;
  return t;
}

__host__ __device__ constexpr size_t tile_bytes(int R, int E, int P) {
  return static_cast<size_t>(make_tile(R, E, P).floats) * sizeof(float);
}

// ------------------------------------------------------- choice of the tile
//
// An H100 SM has 228 KB of shared memory, of which the runtime reserves 1 KB
// per resident block; one block may opt into 227 KB.
constexpr size_t kSmSharedBytes = 233472;
constexpr size_t kBlockReservedBytes = 1024;
constexpr size_t kBlockOptinBytes = 232448;
constexpr int kMaxBlockThreads = 1024;
constexpr int kMaxTileThreads = 512;  // the most threads choose_tile gives a block
constexpr int kMaxTileEnvs = 8;
constexpr int kMinPartColumns = 24;

struct Shape {
  int E, P;
};

// (E, P) for a kernel that wants `per_sm` tiles resident on an SM. P, the
// threads per (env, contact), is the largest power of two up to 4 that
// leaves each thread at least kMinPartColumns columns of the matvec and the
// block at most kMaxTileThreads threads: where an env's A is large (R = 38),
// more threads per env keep more warps resident; where it is small (R = 12),
// the shuffles and the repeated projection cost more than the shorter chains
// save. E is then the largest power of two up to kMaxTileEnvs whose
// `per_sm` tiles fit an SM's shared memory.
constexpr Shape choose_tile(int R, int per_sm) {
  for (int P = 4; P >= 1; P /= 2) {
    if (P > 1 && 3 * R < kMinPartColumns * P) continue;
    int E = kMaxTileEnvs;
    while (E > 1 && per_sm * (tile_bytes(R, E, P) + kBlockReservedBytes) > kSmSharedBytes) E /= 2;
    if (P == 1 || make_tile(R, E, P).threads <= kMaxTileThreads) return {E, P};
  }
  return {1, 1};
}

// Whether the solve's shared-memory reads of a tile are free of bank
// conflicts: in every warp the live lanes' reads of A (rows 3r + c, column p
// of their part; a column step moves every lane by P E words alike) hit
// distinct banks, and, where a warp holds at most 8 (env, part) pairs, their
// 16-byte reads of y hit distinct groups of four banks.
constexpr bool reads_hit_distinct_banks(int R, int E, int P) {
  const Tile t = make_tile(R, E, P);
  for (int w = 0; w < t.threads / kWarp; ++w) {
    for (int c = 0; c < 3; ++c) {
      unsigned banks = 0;
      for (int lane = 0; lane < kWarp; ++lane) {
        const int u = w * kWarp + lane, e = u % E, p = u / E % P, r = u / (E * P);
        if (r >= R) continue;
        const unsigned bit = 1u << ((t.a_off + ((3 * r + c) * t.srow + p) * E + e) % kWarp);
        if (banks & bit) return false;
        banks |= bit;
      }
    }
  }
  if (E * P <= 8) {
    for (int k = 0; k + 4 <= t.n / P; k += 4) {
      unsigned groups = 0;
      for (int q = 0; q < E * P; ++q) {
        const unsigned bit = 1u << ((t.y_off + q * t.sy + k) / 4 % 8);
        if (groups & bit) return false;
        groups |= bit;
      }
    }
  }
  return true;
}

// Whether the tile choose_tile gives every R <= kMaxRows launches (its
// threads and shared memory fit a block) and reads without bank conflicts.
constexpr bool chosen_tiles_hold(int per_sm) {
  for (int R = 1; R <= kMaxRows; ++R) {
    const Shape s = choose_tile(R, per_sm);
    const Tile t = make_tile(R, s.E, s.P);
    if (t.threads > kMaxBlockThreads || tile_bytes(R, s.E, s.P) > kBlockOptinBytes ||
        !reads_hit_distinct_banks(R, s.E, s.P))
      return false;
  }
  return true;
}

// Copy `cp_bytes` (4, 8 or 16) from global to shared memory, asynchronously;
// only the first `src_bytes` are read, the rest is zero-filled.
__device__ __forceinline__ void cp_async(float* dst, const float* src, int cp_bytes, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (cp_bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
  } else if (cp_bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// `v` rounded to T (to nearest, ties to even), as a float.
template <class T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__float2half_rn(v));
  } else {
    static_assert(std::is_same_v<T, float>, "matvec modes: float, __nv_bfloat16, __half");
    return v;
  }
}

// g + a y for a and y already rounded to T: exact product (float and
// bfloat16 operands: one rounding, at the sum), or for __half the product
// rounded to float16 first.
template <class T>
__device__ __forceinline__ float madd(float a, float y, float g) {
  if constexpr (std::is_same_v<T, __half>) {
    return g + round_to<__half>(__fmul_rn(a, y));
  } else {
    return fmaf(a, y, g);
  }
}

// Friction-cone projection of one contact; inactive contacts (act = 0) go to 0.
__device__ __forceinline__ void project(const float v[3], float mu, float act, float x[3]) {
  const float ln = fmaxf(v[2], 0.0f);
  const float tn = sqrtf(v[0] * v[0] + v[1] * v[1]);
  const float sc = fminf(1.0f, mu * ln / fmaxf(tn, 1e-9f));
  x[0] = v[0] * sc * act;
  x[1] = v[1] * sc * act;
  x[2] = ln * act;
}

// Sum over the P threads of one (env, contact): lanes e + E p + E P r.
template <int E, int P>
__device__ __forceinline__ float sum_parts(float v) {
#pragma unroll
  for (int off = E; off < E * P; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Per-thread view of a tile of E envs with P threads per contact.
template <int E, int P>
struct Thread {
  Tile t;
  float* sh;
  int e, p, r;
  bool live;

  __device__ Thread(float* shared, int R, int env0, int N)
      : t(make_tile(R, E, P)), sh(shared), e(threadIdx.x % E), p(threadIdx.x / E % P),
        r(threadIdx.x / (E * P)), live(r < R && env0 + e < N) {}
  // A[i][0] of this thread's env; column j at + j * E
  __device__ float* arow(int i) const { return sh + t.a_off + i * t.srow * E + e; }
  __device__ float* act() const { return sh + t.act_off; }
  // columns of this thread's part: p, p + P, ...
  __device__ int columns() const { return (t.n - p + P - 1) / P; }
};

// 1 / L with L = max absolute row sum of A over the active rows of this
// thread's env (no active row gives 1e6), from the f32 entries; each entry
// is read by one thread, which then leaves it rounded to T (the matvec mode;
// no write for float). Ends with a barrier; must follow the one that
// publishes A and act.
template <class T = float, int E, int P>
__device__ inline float inv_lipschitz(const Thread<E, P>& th, float act_r) {
  const Tile& t = th.t;
  float s[3] = {0.0f, 0.0f, 0.0f};
  if (th.live) {
    const float* act = th.act() + th.e;
    const int cols = th.columns();
    for (int c = 0; c < 3; ++c) {
      float* a = th.arow(3 * th.r + c);
      for (int k = 0; k < cols; ++k) {
        const int j = th.p + k * P;
        const float v = a[j * E];
        s[c] += fabsf(v) * act[j / 3 * E];
        if constexpr (!std::is_same_v<T, float>) a[j * E] = round_to<T>(v);
      }
    }
  }
  float lp = 0.0f;
  for (int c = 0; c < 3; ++c) lp = fmaxf(lp, act_r * sum_parts<E, P>(s[c]));
  // then the max over the contacts: lane bits at and above E P
#pragma unroll
  for (int off = E * P; off < kWarp; off <<= 1) lp = fmaxf(lp, __shfl_xor_sync(0xffffffffu, lp, off));
  float* lmax = th.sh + t.lmax_off;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane < E) lmax[warp * E + lane] = lp;
  __syncthreads();
  float L = 0.0f;
  for (int w = 0; w < t.threads / kWarp; ++w) L = fmaxf(L, lmax[w * E + th.e]);
  return 1.0f / fmaxf(L, 1e-6f);
}

// `iters` APGD steps from (x, x_prev); beta(it) gives the momentum of step
// it; the matvec in mode T (A already rounded to T by inv_lipschitz<T>).
template <class T = float, int E, int P, class Beta>
__device__ inline void iterate(const Thread<E, P>& th, float inv_L, float mu, float act_r, const float b[3],
                               float x[3], float xp[3], int iters, Beta beta) {
  constexpr int cs = P * E;  // float distance of a part's neighbouring columns
  const Tile& t = th.t;
  const int cols = th.columns(), cols4 = cols & ~3;
  const float* a0 = th.arow(3 * th.r) + th.p * E;  // column p of rows 3r, 3r+1, 3r+2
  const float* a1 = a0 + t.srow * E;
  const float* a2 = a1 + t.srow * E;
  const int part_floats = E * P * t.sy;
  for (int it = 0; it < iters; ++it) {
    const float bt = beta(it);
    float* ybuf = th.sh + t.y_off + (it & 1) * part_floats;
    float y[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      y[c] = x[c] + bt * (x[c] - xp[c]);
      xp[c] = x[c];
    }
    if (th.live && th.p == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int i = 3 * th.r + c;
        ybuf[(th.e * P + i % P) * t.sy + i / P] = round_to<T>(y[c]);
      }
    }
    __syncthreads();  // every row of y is written (the other buffer is free: see the file note)
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    if (th.live) {
      const float* yp = ybuf + (th.e * P + th.p) * t.sy;
#pragma unroll 2
      for (int k = 0; k < cols4; k += 4) {
        const float4 yy = *reinterpret_cast<const float4*>(yp + k);
        const int o = k * cs;
        g0 = madd<T>(a0[o], yy.x, g0);
        g1 = madd<T>(a1[o], yy.x, g1);
        g2 = madd<T>(a2[o], yy.x, g2);
        g0 = madd<T>(a0[o + cs], yy.y, g0);
        g1 = madd<T>(a1[o + cs], yy.y, g1);
        g2 = madd<T>(a2[o + cs], yy.y, g2);
        g0 = madd<T>(a0[o + 2 * cs], yy.z, g0);
        g1 = madd<T>(a1[o + 2 * cs], yy.z, g1);
        g2 = madd<T>(a2[o + 2 * cs], yy.z, g2);
        g0 = madd<T>(a0[o + 3 * cs], yy.w, g0);
        g1 = madd<T>(a1[o + 3 * cs], yy.w, g1);
        g2 = madd<T>(a2[o + 3 * cs], yy.w, g2);
      }
      for (int k = cols4; k < cols; ++k) {
        const float yk = yp[k];
        g0 = madd<T>(a0[k * cs], yk, g0);
        g1 = madd<T>(a1[k * cs], yk, g1);
        g2 = madd<T>(a2[k * cs], yk, g2);
      }
    }
    g0 = sum_parts<E, P>(g0);
    g1 = sum_parts<E, P>(g1);
    g2 = sum_parts<E, P>(g2);
    if (th.live) {
      const float v[3] = {y[0] - inv_L * (g0 + b[0]), y[1] - inv_L * (g1 + b[1]), y[2] - inv_L * (g2 + b[2])};
      project(v, mu, act_r, x);
    }
  }
}

// Calls f(std::integral_constant<int, E>, std::integral_constant<int, P>)
// for E in {1, 2, 4, 8} and P in {1, 2, 4}: every tile choose_tile gives,
// and the others for sweeps. Returns -1 for any other shape.
template <class F>
inline int with_tile(int E, int P, F&& f) {
  using std::integral_constant;
#define APGD_TILE(e, p) \
  if (E == e && P == p) return f(integral_constant<int, e>{}, integral_constant<int, p>{});
#define APGD_TILES(e) APGD_TILE(e, 1) APGD_TILE(e, 2) APGD_TILE(e, 4)
  APGD_TILES(1) APGD_TILES(2) APGD_TILES(4) APGD_TILES(8)
#undef APGD_TILES
#undef APGD_TILE
  return -1;
}

// What `prepare` learnt about one kernel instance on one device.
struct LaunchCache {
  int max_threads = 0, optin = 0;
  size_t shared = 0;
};

// Let `kernel` take the tile's dynamic shared memory and prefer shared
// memory over L1, so that several tiles fit an SM; the CUDA calls are made
// once per kernel instance and device (`cache`, indexed by device). Returns
// a CUDA error code, or -1 when the tile exceeds the shared memory a block
// may opt into or the threads a block of this kernel may have (its
// registers bound them).
template <class Kernel, int kDevices>
inline int prepare(Kernel kernel, const Tile& t, LaunchCache (&cache)[kDevices]) {
  const size_t bytes = static_cast<size_t>(t.floats) * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices) return -1;
  LaunchCache& c = cache[dev];
  if (c.max_threads == 0) {
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    c.max_threads = fa.maxThreadsPerBlock;
  }
  if (bytes > static_cast<size_t>(c.optin) || t.threads > c.max_threads) return -1;
  if (bytes > c.shared) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    c.shared = bytes;
  }
  return 0;
}

}  // namespace apgd
