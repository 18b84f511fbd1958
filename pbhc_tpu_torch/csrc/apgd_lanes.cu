// Env-last batched APGD on the friction-cone contact QP.
//
// Replaces the Pallas kernel pbhc_tpu/sim/pallas_contact.py::_apgd_kernel_lanes
// (:112-140) and follows the semantics of its XLA twin LanesEngine._apgd
// (pbhc_tpu/sim/engine_lanes.py:643-682): Lipschitz bound L = max absolute row
// sum over the active rows, projected warm start, `iters` Nesterov steps
// y = x + beta (x - x_prev), x = P(y - (A y + b) / L) with the momentum theta
// carried in f32, P = friction-cone projection that zeroes inactive rows.
//
// Layout (env axis last, as the engine builds it): A [3R,3R,N], b [3R,N],
// mu [N], active [R,N], x0 [3R,N] -> out [3R,N], all float32, contiguous.
//
// Bound on an H100 at the slice's shape (R = 12, N = 4096, 16 iterations):
// A is 36*36*4 B * 4096 = 21.2 MB and must be read at least once, about
// 6.3 us at 3.35 TB/s; the 16*2*36^2*4096 = 170 MFLOP of f32 work take about
// 2.5 us at 67 TFLOP/s. So the solve is memory bound.
//
// Design: a block takes 32 envs (threadIdx.x) and up to 16 contact rows
// (threadIdx.y); a thread owns the 3 solver rows of its contact row(s) for its
// env. A warp is one contact row of 32 neighbouring envs, so every load of A
// and b is coalesced. The iterates live in shared memory as [row][env]
// columns (no bank conflicts); y is shared by the whole block, so each
// iteration has two barriers. A is re-read from L2 every iteration (21 MB
// stays resident in the 50 MB L2): the kernel moves 16x the bytes of its
// bound. Staging A in shared memory, or fusing the energy safeguard and the
// position pass that read A again, is later work. The row count is a runtime
// argument, so one instance serves every R and builds in seconds.

#include <cuda_runtime.h>

namespace {

constexpr int kEnvs = 32;     // envs per block (threadIdx.x)
constexpr int kMaxRowThreads = 16;  // threadIdx.y extent

__device__ __forceinline__ void project_row(float v0, float v1, float v2, float mu, float act,
                                            float* x0, float* x1, float* x2) {
  const float ln = fmaxf(v2, 0.0f);
  const float tn = sqrtf(v0 * v0 + v1 * v1);
  const float sc = fminf(1.0f, mu * ln / fmaxf(tn, 1e-9f));
  *x0 = v0 * sc * act;
  *x1 = v1 * sc * act;
  *x2 = ln * act;
}

int row_threads(int R) { return R < kMaxRowThreads ? R : kMaxRowThreads; }

size_t shared_bytes(int R) {
  return static_cast<size_t>(10 * R + row_threads(R)) * kEnvs * sizeof(float);
}

__global__ void apgd_lanes_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                  const float* __restrict__ mu, const float* __restrict__ active,
                                  const float* __restrict__ x0, float* __restrict__ out, int R,
                                  int N, int iters) {
  extern __shared__ float sh[];
  const int n = 3 * R;
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  const int e = blockIdx.x * kEnvs + tx;
  const bool live = e < N;
  // lanes past N load env N-1 (a valid address), join every barrier, store nothing
  const size_t sN = static_cast<size_t>(N), ec = live ? e : N - 1;
  float* x = sh;                      // [n][kEnvs]
  float* xp = x + n * kEnvs;          // [n][kEnvs]
  float* y = xp + n * kEnvs;          // [n][kEnvs]
  float* act = y + n * kEnvs;         // [R][kEnvs]
  float* lpart = act + R * kEnvs;     // [ny][kEnvs]
#define S(arr, i) arr[(i) * kEnvs + tx]

  for (int r = ty; r < R; r += ny) S(act, r) = active[r * sN + ec];
  __syncthreads();

  // Lipschitz bound over the active rows: per-thread partial max, then block max
  float lp = 0.0f;
  for (int r = ty; r < R; r += ny) {
    for (int c = 0; c < 3; ++c) {
      const float* Ai = A + static_cast<size_t>(3 * r + c) * n * sN + ec;
      float s = 0.0f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) s += fabsf(Ai[j * sN]) * S(act, j / 3);
      lp = fmaxf(lp, S(act, r) * s);
    }
  }
  S(lpart, ty) = lp;
  __syncthreads();
  float L = 0.0f;
  for (int k = 0; k < ny; ++k) L = fmaxf(L, S(lpart, k));
  const float inv_L = 1.0f / fmaxf(L, 1e-6f);
  const float mu_e = mu[ec];

  for (int r = ty; r < R; r += ny) {
    const int i = 3 * r;
    project_row(x0[i * sN + ec], x0[(i + 1) * sN + ec], x0[(i + 2) * sN + ec], mu_e, S(act, r),
                &S(x, i), &S(x, i + 1), &S(x, i + 2));
    for (int c = 0; c < 3; ++c) S(xp, i + c) = S(x, i + c);
  }

  float theta = 1.0f;
  for (int it = 0; it < iters; ++it) {
    const float t2 = theta * theta;
    const float theta_new = 0.5f * (sqrtf(t2 * t2 + 4.0f * t2) - t2);
    const float beta = theta * (1.0f - theta) / (t2 + theta_new);
    theta = theta_new;
    for (int r = ty; r < R; r += ny) {
      for (int c = 0; c < 3; ++c) {
        const int i = 3 * r + c;
        const float xi = S(x, i);
        S(y, i) = xi + beta * (xi - S(xp, i));
        S(xp, i) = xi;
      }
    }
    __syncthreads();  // every row of y is written
    for (int r = ty; r < R; r += ny) {
      float v[3];
      for (int c = 0; c < 3; ++c) {
        const int i = 3 * r + c;
        const float* Ai = A + static_cast<size_t>(i) * n * sN + ec;
        float g = 0.0f;
#pragma unroll 4
        for (int j = 0; j < n; ++j) g += Ai[j * sN] * S(y, j);
        g += b[i * sN + ec];
        v[c] = S(y, i) - inv_L * g;
      }
      project_row(v[0], v[1], v[2], mu_e, S(act, r), &S(x, 3 * r), &S(x, 3 * r + 1),
                  &S(x, 3 * r + 2));
    }
    __syncthreads();  // y is read by all before the next iteration rewrites it
  }
  if (live) {
    for (int r = ty; r < R; r += ny)
      for (int c = 0; c < 3; ++c) out[(3 * r + c) * sN + e] = S(x, 3 * r + c);
  }
#undef S
}

}  // namespace

// Most contact rows one launch takes: the block's iterates, mask and partial
// maxima must fit the default 48 KB of shared memory.
extern "C" int apgd_lanes_max_rows() {
  int R = 1;
  while (shared_bytes(R + 1) <= 48 * 1024) ++R;
  return R;
}

// Launches on `stream`; returns the CUDA error code of the launch
// (0 = cudaSuccess), or -1 for an R or N the kernel does not take.
extern "C" int apgd_lanes_launch(const void* A, const void* b, const void* mu, const void* active,
                                 const void* x0, void* out, int R, int N, int iters, void* stream) {
  if (R < 1 || R > apgd_lanes_max_rows() || N < 1) return -1;
  const dim3 block(kEnvs, row_threads(R));
  const int blocks = (N + kEnvs - 1) / kEnvs;
  apgd_lanes_kernel<<<blocks, block, shared_bytes(R), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(b), static_cast<const float*>(mu),
      static_cast<const float*>(active), static_cast<const float*>(x0), static_cast<float*>(out), R,
      N, iters);
  return static_cast<int>(cudaGetLastError());
}
