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
// Bound on an H100 at the training shape (R = 12, N = 4096, 16 iterations):
// the inputs and the output are 4 N (n^2 + 2n + 1 + R) = 22.6 MB, 6.75 us at
// 3.35 TB/s; the 214 MFLOP of f32 work take 3.2 us at 67 TFLOP/s. The solve
// is memory bound.
//
// Design: one warp per env, a few envs per block. The env's A (5.2 KB at
// R = 12, 52 KB at R = 38) is staged once into shared memory with coalesced
// loads, its rows padded to an odd stride so that the 32 lanes, each walking
// its own row, hit 32 different banks. Lane l owns solver rows l, l+32, l+64,
// l+96 (n <= 128, so R <= 42): it keeps their x, x_prev and b in registers and
// reads y from shared memory, where every lane reads the same word (a
// broadcast). The cone projection needs the three rows of a contact, which
// may belong to two lanes, so the pre-projection values go through shared
// memory and lane l projects contacts l and l+32. A warp never waits for
// another warp: __syncwarp is the only barrier. A is read from device memory
// once, which is the bound's traffic.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kLanes = 32;
constexpr int kRowSlots = 4;                       // solver rows per lane
constexpr int kMaxRows = kLanes * kRowSlots / 3;   // contacts: n = 3R <= 128
constexpr int kMaxIters = 256;

struct Betas {
  float v[kMaxIters];
};

__host__ __device__ int stride_of(int n) { return n | 1; }             // odd row stride: no bank conflicts

__host__ __device__ size_t warp_floats(int R) {
  const int n = 3 * R;
  return static_cast<size_t>(n) * stride_of(n) + 3 * n + R;
}

__global__ void apgd_envfirst_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                     const float* __restrict__ mu, const float* __restrict__ active,
                                     float* __restrict__ out, int R, int N, int iters, Betas betas) {
  extern __shared__ float sh[];
  const int n = 3 * R, st = stride_of(n);
  const int lane = threadIdx.x, w = threadIdx.y;
  const int e = blockIdx.x * blockDim.y + w;
  if (e >= N) return;                               // whole warp leaves together
  float* As = sh + w * warp_floats(R);              // [n][st]
  float* ys = As + n * st;                          // [n] y
  float* vs = ys + n;                               // [n] y - g / L, before projection
  float* xs = vs + n;                               // [n] x after projection
  float* act = xs + n;                              // [R]

  const float* Ae = A + static_cast<size_t>(e) * n * n;
  for (int k = lane; k < n * n; k += kLanes) {
    const int i = k / n;
    As[i * st + (k - i * n)] = Ae[k];
  }
  for (int r = lane; r < R; r += kLanes) act[r] = active[static_cast<size_t>(e) * R + r];
  __syncwarp();

  // Lipschitz bound over the active rows: per-lane max, then a warp max
  float lp = 0.0f, bi[kRowSlots], x[kRowSlots], xp[kRowSlots];
#pragma unroll
  for (int s = 0; s < kRowSlots; ++s) {
    const int i = lane + s * kLanes;
    x[s] = 0.0f;
    xp[s] = 0.0f;
    bi[s] = 0.0f;
    if (i < n) {
      bi[s] = b[static_cast<size_t>(e) * n + i];
      float sum = 0.0f;
      for (int j = 0; j < n; ++j) sum += fabsf(As[i * st + j]) * act[j / 3];
      lp = fmaxf(lp, act[i / 3] * sum);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) lp = fmaxf(lp, __shfl_xor_sync(0xffffffffu, lp, off));
  const float inv_L = 1.0f / fmaxf(lp, 1e-6f);
  const float mu_e = mu[e];

  for (int it = 0; it < iters; ++it) {
    const float beta = betas.v[it];
    float y[kRowSlots];
#pragma unroll
    for (int s = 0; s < kRowSlots; ++s) {
      const int i = lane + s * kLanes;
      y[s] = x[s] + beta * (x[s] - xp[s]);
      if (i < n) ys[i] = y[s];
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kRowSlots; ++s) {
      const int i = lane + s * kLanes;
      if (i < n) {
        const float* Ai = As + i * st;
        float g = 0.0f;
#pragma unroll 4
        for (int j = 0; j < n; ++j) g += Ai[j] * ys[j];
        vs[i] = y[s] - inv_L * (g + bi[s]);
      }
    }
    __syncwarp();
    for (int r = lane; r < R; r += kLanes) {
      const float v0 = vs[3 * r], v1 = vs[3 * r + 1], v2 = vs[3 * r + 2], a = act[r];
      const float ln = fmaxf(v2, 0.0f);
      const float tn = sqrtf(v0 * v0 + v1 * v1);
      const float sc = fminf(1.0f, mu_e * ln / fmaxf(tn, 1e-9f));
      xs[3 * r] = v0 * sc * a;
      xs[3 * r + 1] = v1 * sc * a;
      xs[3 * r + 2] = ln * a;
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kRowSlots; ++s) {
      const int i = lane + s * kLanes;
      xp[s] = x[s];
      if (i < n) x[s] = xs[i];
    }
  }
#pragma unroll
  for (int s = 0; s < kRowSlots; ++s) {
    const int i = lane + s * kLanes;
    if (i < n) out[static_cast<size_t>(e) * n + i] = x[s];
  }
}

}  // namespace

extern "C" int apgd_envfirst_max_rows() { return kMaxRows; }

extern "C" int apgd_envfirst_max_iters() { return kMaxIters; }

// Launches on `stream`; returns the CUDA error code of the launch
// (0 = cudaSuccess), or -1 for an R, N or iteration count the kernel does not
// take. The momentum coefficients follow _beta_schedule in double precision.
extern "C" int apgd_envfirst_launch(const void* A, const void* b, const void* mu, const void* active,
                                    void* out, int R, int N, int iters, void* stream) {
  if (R < 1 || R > kMaxRows || N < 1 || iters < 0 || iters > kMaxIters) return -1;
  Betas betas;
  double theta = 1.0;
  for (int it = 0; it < iters; ++it) {
    const double t2 = theta * theta;
    const double theta_new = 0.5 * (sqrt(t2 * t2 + 4.0 * t2) - t2);
    betas.v[it] = static_cast<float>(theta * (1.0 - theta) / (t2 + theta_new));
    theta = theta_new;
  }
  // envs per block: 4 while they fit the default 48 KB, else as many as fit
  // the opt-in maximum (one at R = 38)
  const size_t per_warp = warp_floats(R) * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) --warps;
  const size_t bytes = warps * per_warp;
  if (bytes > static_cast<size_t>(optin)) return -1;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        apgd_envfirst_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kLanes, warps);
  const int blocks = (N + warps - 1) / warps;
  apgd_envfirst_kernel<<<blocks, block, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(b), static_cast<const float*>(mu),
      static_cast<const float*>(active), static_cast<float*>(out), R, N, iters, betas);
  return static_cast<int>(cudaGetLastError());
}
