// Native deploy-time policy inference core.
//
// The reference's real-robot controller runs its exported policies on
// onnxruntime's C++ core at 50 Hz (reference deploy_real/deploy_real.py:31,
// urci.py:97-136). This is the port's native equivalent (a copy of
// pbhc_tpu/deploy/native/mlp_infer.cpp): a small C++ MLP forward pass with
// preallocated scratch (no per-tick allocation, deterministic latency for
// the control loop) for the robot's onboard CPU, driven from Python via
// ctypes (pbhc_tpu_torch/deploy/native/__init__.py).
//
// Layout: dense layers y = x W + b with W stored row-major [in, out]
// (the flax kernel layout, so exported .npz weights upload without
// transposition). Activations: ELU / ReLU / Tanh between layers.
//
// Build: g++ -O3 -shared -fPIC into <repo>/build/native/ at first use (no
// -march=native: a cached library must run on any x86-64 host that reads
// it). The inner dot products auto-vectorize with SSE2.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Layer {
  std::vector<float> w;  // [in * out] row-major
  std::vector<float> b;  // [out]
  int in = 0, out = 0;
};

enum class Act : int32_t { kElu = 0, kRelu = 1, kTanh = 2 };

struct Net {
  std::vector<Layer> layers;
  std::vector<float> scratch_a, scratch_b;
  Act act = Act::kElu;
  int max_dim = 0;
};

inline void dense(const Layer& L, const float* x, float* y) {
  // y[o] = b[o] + sum_i x[i] * W[i, o]; iterate i-major so each pass streams
  // one row of W and the compiler vectorizes over `out`.
  std::memcpy(y, L.b.data(), sizeof(float) * L.out);
  for (int i = 0; i < L.in; ++i) {
    const float xi = x[i];
    if (xi == 0.0f) continue;
    const float* wrow = L.w.data() + static_cast<size_t>(i) * L.out;
    for (int o = 0; o < L.out; ++o) y[o] += xi * wrow[o];
  }
}

inline void activate(Act act, float* y, int n) {
  switch (act) {
    case Act::kElu:
      for (int i = 0; i < n; ++i) y[i] = y[i] > 0.0f ? y[i] : std::expm1(y[i]);
      break;
    case Act::kRelu:
      for (int i = 0; i < n; ++i) y[i] = y[i] > 0.0f ? y[i] : 0.0f;
      break;
    case Act::kTanh:
      for (int i = 0; i < n; ++i) y[i] = std::tanh(y[i]);
      break;
  }
}

}  // namespace

extern "C" {

void* mlp_create(int32_t activation) {
  Net* net = new Net();
  net->act = static_cast<Act>(activation);
  return net;
}

void mlp_add_layer(void* handle, const float* w, const float* b, int32_t in,
                   int32_t out) {
  Net* net = static_cast<Net*>(handle);
  Layer L;
  L.in = in;
  L.out = out;
  L.w.assign(w, w + static_cast<size_t>(in) * out);
  L.b.assign(b, b + out);
  net->layers.push_back(std::move(L));
  net->max_dim = std::max(net->max_dim, std::max(in, out));
  net->scratch_a.assign(net->max_dim, 0.0f);
  net->scratch_b.assign(net->max_dim, 0.0f);
}

// obs [in_dim] -> action [out_dim]; returns out_dim (or -1 on shape mismatch).
int32_t mlp_infer(void* handle, const float* obs, int32_t obs_dim, float* out) {
  Net* net = static_cast<Net*>(handle);
  if (net->layers.empty() || net->layers.front().in != obs_dim) return -1;
  const float* x = obs;
  float* bufs[2] = {net->scratch_a.data(), net->scratch_b.data()};
  int cur = 0;
  const int n = static_cast<int>(net->layers.size());
  for (int li = 0; li < n; ++li) {
    const Layer& L = net->layers[li];
    float* y = (li == n - 1) ? out : bufs[cur];
    dense(L, x, y);
    if (li < n - 1) activate(net->act, y, L.out);
    x = y;
    cur ^= 1;
  }
  return net->layers.back().out;
}

void mlp_destroy(void* handle) { delete static_cast<Net*>(handle); }

}  // extern "C"
