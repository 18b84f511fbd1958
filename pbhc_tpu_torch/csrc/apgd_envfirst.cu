// Env-first batched APGD on the friction-cone contact QP, from a zero start.
//
// Replaces the Pallas kernel pbhc_tpu/sim/pallas_contact.py::_apgd_kernel
// (:37-74, called by solve_contacts_pallas :143-176) and follows it exactly:
// Lipschitz bound L = max absolute row sum over the active rows, x = x_prev = 0,
// then for each momentum coefficient beta of _beta_schedule (the theta
// recurrence evaluated in double on the host, used as f32 constants)
// y = x + beta (x - x_prev), x = P(y - (A y + b) / L), where P is the
// friction-cone projection that zeroes inactive rows.
//
// Layout (env axis first, as Engine.substep_batched builds it): A [N,n,n],
// b [N,n], mu [N], active [N,R] -> out [N,n] (= impulses [N,R,3]), n = 3R,
// float32, contiguous. A is read in place: no transposed copy.
//
// Bound on an H100 (N = 4096, 16 iterations): the inputs and the output are
// 4 N (n^2 + 2n + 1 + R) = 22.6 MB at R = 12 (6.75 us at 3.35 TB/s) and
// 217 MB at R = 38 (65 us); the f32 work, 0.21 and 1.95 GFLOP, takes 3.2 and
// 29 us at 67 TFLOP/s. The solve is memory bound: A must be read once.
//
// Design: the solver body of kernel 1 (apgd_common.cuh), on a tile of E
// neighbouring envs with P threads per (env, contact). The loader stages
// each env's contiguous A with 4-byte cp.async copies (no registers), the
// threads of one env on consecutive words, transposing into the tile's
// padded [n][srow][E] layout: the writes hit 32 banks and the solve's row
// reads too. The threads balance the rows (3 rows and n / P columns each;
// the previous design's busiest lane walked 2n columns at n = 36), and at
// R = 38 an env's 152 threads span five warps, four tiles to an SM, where
// the previous design gave an env one warp (apgd::choose_tile: E = 8, P = 1
// at R = 12; E = 1, P = 4 at R = 38). The other tiles' solves hide each
// tile's copy.

#include <cuda_runtime.h>

#include <cmath>

#include "apgd_common.cuh"

namespace {

constexpr int kMaxIters = 256;

struct Betas {
  float v[kMaxIters];
};

template <int E, int P>
__global__ void apgd_envfirst_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                     const float* __restrict__ mu, const float* __restrict__ active,
                                     float* __restrict__ out, int R, int N, int iters,
                                     const __grid_constant__ Betas betas) {
  extern __shared__ __align__(16) float sh[];
  const int e0 = blockIdx.x * E, env = e0 + threadIdx.x % E;
  const apgd::Thread<E, P> th(sh, R, e0, N);
  const int n = th.t.n;

  // this env's A[k], k = i n + j, -> shared; the threads of one env
  // (u = t / E = 0, 1, ...) take consecutive words
  if (env < N) {
    const float* Ae = A + static_cast<size_t>(env) * n * n;
    const int step = th.t.threads / E, nn = n * n, u = threadIdx.x / E;
    int i = u / n, j = u - i * n;
    for (int k = u; k < nn; k += step) {
      apgd::cp_async(sh + th.t.a_off + (i * th.t.srow + j) * E + th.e, Ae + k, 4, 4);
      for (j += step; j >= n; j -= n) ++i;
    }
  }

  float bi[3] = {0.0f, 0.0f, 0.0f}, x[3] = {0.0f, 0.0f, 0.0f}, act_r = 0.0f, mu_e = 0.0f;
  if (th.live) {
    act_r = active[static_cast<size_t>(env) * R + th.r];
    mu_e = mu[env];
    for (int c = 0; c < 3; ++c) bi[c] = b[static_cast<size_t>(env) * n + 3 * th.r + c];
  }
  if (th.r < R && th.p == 0) th.act()[th.r * E + th.e] = act_r;
  apgd::cp_async_wait_all();
  __syncthreads();  // A and the mask are in shared memory

  const float inv_L = apgd::inv_lipschitz(th, act_r);
  float xp[3] = {0.0f, 0.0f, 0.0f};
  apgd::iterate(th, inv_L, mu_e, act_r, bi, x, xp, iters, [&betas](int it) { return betas.v[it]; });
  if (th.live && th.p == 0) {
    for (int c = 0; c < 3; ++c) out[static_cast<size_t>(env) * n + 3 * th.r + c] = x[c];
  }
}

// Four tiles per SM, so that the other tiles' solves hide each tile's copy.
constexpr int kTilesPerSm = 4;
static_assert(apgd::chosen_tiles_hold(kTilesPerSm), "a chosen tile does not fit or has bank conflicts");

}  // namespace

extern "C" int apgd_envfirst_max_rows() { return apgd::kMaxRows; }

extern "C" int apgd_envfirst_max_iters() { return kMaxIters; }

// The tile apgd_envfirst_launch takes at R rows: E envs per block, P
// threads per contact.
extern "C" void apgd_envfirst_tile(int R, int* E, int* P) {
  const apgd::Shape s = apgd::choose_tile(R, kTilesPerSm);
  *E = s.E;
  *P = s.P;
}

// Launches on `stream` with E envs per block and P threads per contact;
// returns the CUDA error code of the launch (0 = cudaSuccess), or -1 for an
// R, N, tile or iteration count the kernel does not take. The momentum
// coefficients follow _beta_schedule in double precision.
extern "C" int apgd_envfirst_launch_tile(const void* A, const void* b, const void* mu, const void* active,
                                         void* out, int R, int N, int iters, int E, int P, void* stream) {
  if (R < 1 || R > apgd::kMaxRows || N < 1 || iters < 0 || iters > kMaxIters) return -1;
  Betas betas;
  double theta = 1.0;
  for (int it = 0; it < iters; ++it) {
    const double t2 = theta * theta;
    const double theta_new = 0.5 * (sqrt(t2 * t2 + 4.0 * t2) - t2);
    betas.v[it] = static_cast<float>(theta * (1.0 - theta) / (t2 + theta_new));
    theta = theta_new;
  }
  return apgd::with_tile(E, P, [&](auto e_, auto p_) {
    constexpr int kE = decltype(e_)::value, kP = decltype(p_)::value;
    static apgd::LaunchCache cache[16];
    const apgd::Tile t = apgd::make_tile(R, kE, kP);
    const int err = apgd::prepare(apgd_envfirst_kernel<kE, kP>, t, cache);
    if (err != 0) return err;
    apgd_envfirst_kernel<kE, kP><<<(N + kE - 1) / kE, t.threads, static_cast<size_t>(t.floats) * sizeof(float),
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<const float*>(b), static_cast<const float*>(mu),
        static_cast<const float*>(active), static_cast<float*>(out), R, N, iters, betas);
    return static_cast<int>(cudaGetLastError());
  });
}

// Launches on `stream` with the tile apgd_envfirst_tile gives R; returns as
// apgd_envfirst_launch_tile.
extern "C" int apgd_envfirst_launch(const void* A, const void* b, const void* mu, const void* active,
                                    void* out, int R, int N, int iters, void* stream) {
  if (R < 1 || R > apgd::kMaxRows) return -1;
  const apgd::Shape s = apgd::choose_tile(R, kTilesPerSm);
  return apgd_envfirst_launch_tile(A, b, mu, active, out, R, N, iters, s.E, s.P, stream);
}
