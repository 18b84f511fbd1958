// Env-last batched APGD on the friction-cone contact QP.
//
// Replaces the Pallas kernel pbhc_tpu/sim/pallas_contact.py::_apgd_kernel_lanes
// (:112-140) and follows the semantics of its XLA twin LanesEngine._apgd
// (pbhc_tpu/sim/engine_lanes.py:643-682): Lipschitz bound L = max absolute row
// sum over the active rows, projected warm start, `iters` Nesterov steps
// y = x + beta (x - x_prev), x = P(y - (A y + b) / L) with the momentum theta
// carried in f32, P = friction-cone projection that zeroes inactive rows.
// A is taken as given (not assumed symmetric).
//
// Layout (env axis last, as the engine builds it): A [3R,3R,N], b [3R,N],
// mu [N], active [R,N], x0 [3R,N] -> out [3R,N], all float32, contiguous.
//
// Bound on an H100 (N = 4096, 16 iterations): every input read once and the
// output written once is 23.2 MB at R = 12 (6.9 us at 3.35 TB/s) and 219 MB
// at R = 38 (65 us); the f32 work, 0.20 and 1.95 GFLOP, takes 3.0 and 29 us
// at 67 TFLOP/s. So the solve is memory bound, and A (91% of the bytes at
// R = 12, 97% at R = 38) must be read from device memory once.
//
// Design (apgd_common.cuh): a block takes a tile of E neighbouring envs,
// E * 4 bytes contiguous per (i, j), and P threads per (env, contact). It
// stages the [3R,3R,E] slab of A into shared memory once with cp.async in
// chunks of up to 16 bytes (rows padded so that the solve's reads hit 32
// banks), loads b, x0, mu and the mask while the copies fly, and runs every
// iteration from shared memory: one barrier per iteration, a critical path
// of 3R / P FMAs per thread. Dynamic shared memory goes up to the opt-in
// limit, so every R <= 42 (n <= 128) runs: one env's A is 5.3 KB at R = 12
// and 52 KB at R = 38. apgd::choose_tile picks one tile per SM, as wide as
// fits, so that the copies use whole 32-byte sectors where they can (E = 8,
// P = 1 at R = 12; E = 4, P = 2 at R = 38). What remains is the 17 passes over A
// in shared memory per solve (the Lipschitz bound and 16 iterations) and a
// copy of A that no other tile on the SM hides.
//
// Reduced-precision modes (`contact_matvec_dtype` bfloat16 / float16; JAX's
// XLA `_apgd`, engine_lanes.py:662-672): the same kernel, templated on the
// matvec type T. A still arrives in f32 (the einsum's output) and the bound
// is the f32 mode's, since A is read from device memory once in f32 either
// way. The tile stays f32: the thread that reads an entry of A for the
// Lipschitz bound writes it back rounded to T (apgd::inv_lipschitz<T>; no
// extra pass or barrier), y is rounded to T where it is written, and the
// product follows the mode (apgd::madd).
// A tile of 2-byte A would fit twice the envs per block, but needs a loader
// that converts through registers and its own layout and bank check; the
// kernel is memory bound on the f32 read of A, which a 2-byte tile does not
// shorten.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "apgd_common.cuh"

namespace {

template <class T, int E, int P>
__global__ void apgd_lanes_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                  const float* __restrict__ mu, const float* __restrict__ active,
                                  const float* __restrict__ x0, float* __restrict__ out, int R, int N,
                                  int iters, int vec) {
  extern __shared__ __align__(16) float sh[];
  const int e0 = blockIdx.x * E, env = e0 + threadIdx.x % E;
  const apgd::Thread<E, P> th(sh, R, e0, N);
  const int n = th.t.n;
  const size_t sN = static_cast<size_t>(N);

  // A[i][j][e0 : e0 + E] -> shared, `vec` envs per copy
  const int qs = E / vec, chunks = n * n * qs;
  for (int k = threadIdx.x; k < chunks; k += th.t.threads) {
    const int ij = k / qs, q = k - ij * qs;
    const int i = ij / n, j = ij - i * n, ce = e0 + q * vec;
    if (ce >= N) continue;
    const int valid = N - ce < vec ? N - ce : vec;
    apgd::cp_async(sh + th.t.a_off + (i * th.t.srow + j) * E + q * vec, A + ij * sN + ce, 4 * vec,
                   4 * valid);
  }

  float bi[3] = {0.0f, 0.0f, 0.0f}, x[3] = {0.0f, 0.0f, 0.0f}, act_r = 0.0f, mu_e = 0.0f;
  if (th.live) {
    act_r = active[th.r * sN + env];
    mu_e = mu[env];
    float v[3];
    for (int c = 0; c < 3; ++c) {
      bi[c] = b[(3 * th.r + c) * sN + env];
      v[c] = x0[(3 * th.r + c) * sN + env];
    }
    apgd::project(v, mu_e, act_r, x);  // projected warm start
  }
  if (th.r < R && th.p == 0) th.act()[th.r * E + th.e] = act_r;
  apgd::cp_async_wait_all();
  __syncthreads();  // A and the mask are in shared memory

  const float inv_L = apgd::inv_lipschitz<T>(th, act_r);  // and A rounded to T
  float xp[3] = {x[0], x[1], x[2]};
  float theta = 1.0f;
  apgd::iterate<T>(th, inv_L, mu_e, act_r, bi, x, xp, iters, [&theta](int) {
    const float t2 = theta * theta;
    const float theta_new = 0.5f * (sqrtf(t2 * t2 + 4.0f * t2) - t2);
    const float beta = theta * (1.0f - theta) / (t2 + theta_new);
    theta = theta_new;
    return beta;
  });
  if (th.live && th.p == 0) {
    for (int c = 0; c < 3; ++c) out[(3 * th.r + c) * sN + env] = x[c];
  }
}

// One tile per SM, as wide as fits: the copies of the env-last A, E * 4
// contiguous bytes per (i, j), then use whole 32-byte sectors where they can.
constexpr int kTilesPerSm = 1;
static_assert(apgd::chosen_tiles_hold(kTilesPerSm), "a chosen tile does not fit or has bank conflicts");

// Launches the mode-T kernel with E envs per block and P threads per contact.
template <class T>
int launch(const void* A, const void* b, const void* mu, const void* active, const void* x0, void* out, int R,
           int N, int iters, int E, int P, void* stream) {
  return apgd::with_tile(E, P, [&](auto e_, auto p_) {
    constexpr int kE = decltype(e_)::value, kP = decltype(p_)::value;
    static apgd::LaunchCache cache[16];
    const apgd::Tile t = apgd::make_tile(R, kE, kP);
    const int err = apgd::prepare(apgd_lanes_kernel<T, kE, kP>, t, cache);
    if (err != 0) return err;
    // widest copy (envs per cp.async) that keeps every chunk aligned
    int vec = kE < 4 ? kE : 4;
    while (vec > 1 && (N % vec != 0 || reinterpret_cast<uintptr_t>(A) % (4 * vec) != 0)) vec /= 2;
    apgd_lanes_kernel<T, kE, kP><<<(N + kE - 1) / kE, t.threads, static_cast<size_t>(t.floats) * sizeof(float),
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<const float*>(b), static_cast<const float*>(mu),
        static_cast<const float*>(active), static_cast<const float*>(x0), static_cast<float*>(out), R,
        N, iters, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Most contact rows one launch takes (n = 3R <= 128).
extern "C" int apgd_lanes_max_rows() { return apgd::kMaxRows; }

// The tile apgd_lanes_launch takes at R rows: E envs per block, P threads
// per contact (the same in every matvec mode).
extern "C" void apgd_lanes_tile(int R, int* E, int* P) {
  const apgd::Shape s = apgd::choose_tile(R, kTilesPerSm);
  *E = s.E;
  *P = s.P;
}

// Launches on `stream` in matvec mode `mode` (0 float32, 1 bfloat16,
// 2 float16) with E envs per block and P threads per contact, or with the
// tile apgd_lanes_tile gives R where E = P = 0; returns the CUDA error code
// of the launch (0 = cudaSuccess), or -1 for an R, N, mode or tile the
// kernel does not take.
extern "C" int apgd_lanes_launch_mode(const void* A, const void* b, const void* mu, const void* active,
                                      const void* x0, void* out, int R, int N, int iters, int mode, int E, int P,
                                      void* stream) {
  if (R < 1 || R > apgd::kMaxRows || N < 1 || iters < 0) return -1;
  if (E == 0 && P == 0) {
    const apgd::Shape s = apgd::choose_tile(R, kTilesPerSm);
    E = s.E;
    P = s.P;
  }
  switch (mode) {
    case 0:
      return launch<float>(A, b, mu, active, x0, out, R, N, iters, E, P, stream);
    case 1:
      return launch<__nv_bfloat16>(A, b, mu, active, x0, out, R, N, iters, E, P, stream);
    case 2:
      return launch<__half>(A, b, mu, active, x0, out, R, N, iters, E, P, stream);
    default:
      return -1;
  }
}

// The float32 mode with E envs per block and P threads per contact; returns
// as apgd_lanes_launch_mode. (This and apgd_lanes_launch keep the C
// signatures of the earlier designs, which `eval/kernel_bench.py old=`
// times against.)
extern "C" int apgd_lanes_launch_tile(const void* A, const void* b, const void* mu, const void* active,
                                      const void* x0, void* out, int R, int N, int iters, int E, int P,
                                      void* stream) {
  if (E < 1 || P < 1) return -1;
  return apgd_lanes_launch_mode(A, b, mu, active, x0, out, R, N, iters, 0, E, P, stream);
}

// The float32 mode at the tile apgd_lanes_tile gives R; returns as
// apgd_lanes_launch_mode.
extern "C" int apgd_lanes_launch(const void* A, const void* b, const void* mu, const void* active,
                                 const void* x0, void* out, int R, int N, int iters, void* stream) {
  return apgd_lanes_launch_mode(A, b, mu, active, x0, out, R, N, iters, 0, 0, 0, stream);
}
