// Runs the CUDA kernels of pbhc_tpu_torch/csrc/lanes_dynamics.cu on the
// host, for the CPU tests: each block's threads are std::threads meeting at
// a std::barrier where the kernel calls __syncthreads(), its shared memory a
// vector filled with NaN (so that a read before a write shows in the
// outputs). The exports have the CUDA library's names and signatures; the
// stream is ignored. Build (tests/test_torch_dynamics_kernel.py does):
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -I pbhc_tpu_torch/csrc tests/lanes_dynamics_host.cpp

#include <barrier>
#include <cmath>
#include <limits>
#include <thread>
#include <vector>

#define LANES_DYNAMICS_HOST
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct Dim3 {
  unsigned x = 0, y = 0, z = 0;
};
thread_local Dim3 threadIdx, blockIdx;
thread_local float* host_shared = nullptr;
thread_local std::barrier<>* host_barrier = nullptr;

inline void __syncthreads() { host_barrier->arrive_and_wait(); }
// the host does not fuse a * b + c unless asked to (-ffp-contract with FMA targets)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

#define LD_SHARED(name) float* name = host_shared

#include "lanes_dynamics.cu"

namespace {

template <class Body>
void run_grid(int blocks, int threads, size_t floats, Body body) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<float> shared(floats, std::numeric_limits<float>::quiet_NaN());
    std::barrier<> bar(threads);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        host_shared = shared.data();
        host_barrier = &bar;
        body();
      });
    for (auto& th : pool) th.join();
  }
}

template <int E>
void dynamics(const ld::Model& m, const ld::Inputs& in, const ld::Outputs& out, int N, float dt, int energy) {
  const ld::Layout s = ld::dynamics_layout(m);
  run_grid((N + E - 1) / E, E * ld::kThreadsPerEnv, static_cast<size_t>(E) * s.total,
           [&] { ld::lanes_dynamics_kernel<E>(m, s, in, out, N, dt, energy); });
}

template <int E>
void body_state(const ld::Model& m, const ld::BodyInputs& in, const ld::BodyOutputs& out, int N) {
  const ld::BodyLayout s = ld::body_layout(m);
  run_grid((N + E - 1) / E, E * ld::kThreadsPerEnv, static_cast<size_t>(E) * s.total,
           [&] { ld::lanes_body_state_kernel<E>(m, s, in, out, N); });
}

}  // namespace

extern "C" void lanes_dynamics_caps(int* caps) {
  const int c[6] = {ld::kMaxBodies, ld::kMaxDofs, ld::kMaxContacts, ld::kMaxPairs, ld::kMaxLevels, ld::kMaxGroups};
  for (int i = 0; i < 6; ++i) caps[i] = c[i];
}

extern "C" int lanes_dynamics_envs(ld::Model m, int body) {
  return ld::choose_envs(body ? ld::body_layout(m).total : ld::dynamics_layout(m).total);
}

extern "C" int lanes_dynamics_launch(ld::Model m, ld::Inputs in, ld::Outputs out, int N, float dt, int energy, int E,
                                     void*) {
  if (!ld::within_caps(m) || N < 1) return -1;
  if (E == 0) E = ld::choose_envs(ld::dynamics_layout(m).total);
  switch (E) {
    case 1:
      dynamics<1>(m, in, out, N, dt, energy);
      return 0;
    case 2:
      dynamics<2>(m, in, out, N, dt, energy);
      return 0;
    case 4:
      dynamics<4>(m, in, out, N, dt, energy);
      return 0;
    default:
      return -1;
  }
}

extern "C" int lanes_body_state_launch(ld::Model m, ld::BodyInputs in, ld::BodyOutputs out, int N, int E, void*) {
  if (!ld::within_caps(m) || N < 1) return -1;
  if (E == 0) E = ld::choose_envs(ld::body_layout(m).total);
  switch (E) {
    case 1:
      body_state<1>(m, in, out, N);
      return 0;
    case 2:
      body_state<2>(m, in, out, N);
      return 0;
    case 4:
      body_state<4>(m, in, out, N);
      return 0;
    default:
      return -1;
  }
}
