// Native deploy-time executor for the exported ONNX policy graphs.
//
// The reference runs its deployable policies (including the KungfuBot2
// 3-input student: Conv1d motion/history encoders + MLP actor) on
// onnxruntime's C++ core at 50 Hz (reference deploy_real/deploy_real.py:31,
// urci.py:97-136). This is the port's native equivalent (a copy of
// pbhc_tpu/deploy/native/onnx_exec.cpp), host C++ for the robot's onboard
// CPU: a tiny strided-tensor VM. The Python planner (onnx_exec.py) decodes the ONNX
// protobuf, traces the graph once with numpy to fix every shape, and lowers
// it to this instruction set; at run time the control loop only writes the
// input buffers and calls ox_run — no allocation, no shape logic, no Python
// in the hot path.
//
// Instruction set (all shapes/strides static, offsets in elements):
//   COPY          strided view -> contiguous buffer (Transpose/Slice/Concat)
//   BINARY        elementwise +,-,*,/ of two strided views (broadcast via
//                 zero strides), contiguous output
//   UNARY         elu/relu/tanh/sigmoid/sqrt/sin/cos over a contiguous buffer
//   MATMUL        [m,k] x [k,n] + optional bias[n]  (Gemm/MatMul; the planner
//                 pre-transposes/scales weights so alpha/beta/transB vanish)
//   CONV1D        NCW valid-padding 1-D convolution (the ConvEncoder stacks)
//   REDUCEMEAN    mean over the last (contiguous) axis (LayerNorm)
//
// Build: g++ -O3 -shared -fPIC into <repo>/build/native/ at first use (see
// onnx_exec.py; no -march=native, so a cached library runs on any x86-64 host).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxDims = 4;

struct View {
  int32_t buf = -1;
  int64_t off = 0;
  int64_t shape[kMaxDims] = {1, 1, 1, 1};
  int64_t strides[kMaxDims] = {0, 0, 0, 0};
  int32_t ndim = 0;
};

enum class OpKind : int32_t {
  kCopy = 0,
  kBinary = 1,
  kUnary = 2,
  kMatmul = 3,
  kConv1d = 4,
  kReduceMeanLast = 5,
};

enum class BinOp : int32_t { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3 };
enum class UnOp : int32_t {
  kElu = 0, kRelu = 1, kTanh = 2, kSigmoid = 3, kSqrt = 4, kSin = 5, kCos = 6,
};

struct Instr {
  OpKind kind;
  View a, b;           // inputs (b unused for unary/copy)
  int32_t dst = -1;    // output buffer
  int64_t dst_off = 0; // for COPY into a concat slot
  int32_t iop = 0;     // BinOp / UnOp / conv stride
  // matmul: m,k,n, bias buffer (-1 = none); conv1d: C,W,M,kW + stride in iop
  int64_t p0 = 0, p1 = 0, p2 = 0, p3 = -1;
};

struct Program {
  std::vector<std::vector<float>> bufs;
  std::vector<Instr> instrs;
};

inline int64_t view_elems(const View& v) {
  int64_t n = 1;
  for (int i = 0; i < v.ndim; ++i) n *= v.shape[i];
  return n ? n : 1;
}

// iterate a strided view in row-major order of its shape, writing into a
// contiguous destination
void copy_strided(const Program& pg, const View& v, float* dst) {
  const float* src = pg.bufs[v.buf].data() + v.off;
  int64_t sh[kMaxDims] = {1, 1, 1, 1}, st[kMaxDims] = {0, 0, 0, 0};
  // right-align to 4 dims
  for (int i = 0; i < v.ndim; ++i) {
    sh[kMaxDims - v.ndim + i] = v.shape[i];
    st[kMaxDims - v.ndim + i] = v.strides[i];
  }
  int64_t idx = 0;
  for (int64_t i0 = 0; i0 < sh[0]; ++i0)
    for (int64_t i1 = 0; i1 < sh[1]; ++i1)
      for (int64_t i2 = 0; i2 < sh[2]; ++i2) {
        const float* row = src + i0 * st[0] + i1 * st[1] + i2 * st[2];
        const int64_t s3 = st[3];
        for (int64_t i3 = 0; i3 < sh[3]; ++i3) dst[idx++] = row[i3 * s3];
      }
}

void run_binary(const Program& pg, const Instr& in, float* dst) {
  const float* pa = pg.bufs[in.a.buf].data() + in.a.off;
  const float* pb = pg.bufs[in.b.buf].data() + in.b.off;
  // output shape lives in a.shape (planner sets both views to the broadcast
  // shape, with zero strides on broadcast axes)
  int64_t sh[kMaxDims] = {1, 1, 1, 1};
  int64_t sa[kMaxDims] = {0, 0, 0, 0}, sb[kMaxDims] = {0, 0, 0, 0};
  for (int i = 0; i < in.a.ndim; ++i) {
    sh[kMaxDims - in.a.ndim + i] = in.a.shape[i];
    sa[kMaxDims - in.a.ndim + i] = in.a.strides[i];
    sb[kMaxDims - in.a.ndim + i] = in.b.strides[i];
  }
  const BinOp op = static_cast<BinOp>(in.iop);
  int64_t idx = 0;
  for (int64_t i0 = 0; i0 < sh[0]; ++i0)
    for (int64_t i1 = 0; i1 < sh[1]; ++i1)
      for (int64_t i2 = 0; i2 < sh[2]; ++i2) {
        const float* ra = pa + i0 * sa[0] + i1 * sa[1] + i2 * sa[2];
        const float* rb = pb + i0 * sb[0] + i1 * sb[1] + i2 * sb[2];
        const int64_t qa = sa[3], qb = sb[3];
        for (int64_t i3 = 0; i3 < sh[3]; ++i3, ++idx) {
          const float x = ra[i3 * qa], y = rb[i3 * qb];
          switch (op) {
            case BinOp::kAdd: dst[idx] = x + y; break;
            case BinOp::kSub: dst[idx] = x - y; break;
            case BinOp::kMul: dst[idx] = x * y; break;
            case BinOp::kDiv: dst[idx] = x / y; break;
          }
        }
      }
}

void run_unary(UnOp f, const float* x, float* y, int64_t n) {
  switch (f) {
    case UnOp::kElu:
      for (int64_t i = 0; i < n; ++i) y[i] = x[i] > 0.f ? x[i] : std::expm1(x[i]);
      break;
    case UnOp::kRelu:
      for (int64_t i = 0; i < n; ++i) y[i] = x[i] > 0.f ? x[i] : 0.f;
      break;
    case UnOp::kTanh:
      for (int64_t i = 0; i < n; ++i) y[i] = std::tanh(x[i]);
      break;
    case UnOp::kSigmoid:
      for (int64_t i = 0; i < n; ++i) y[i] = 1.f / (1.f + std::exp(-x[i]));
      break;
    case UnOp::kSqrt:
      for (int64_t i = 0; i < n; ++i) y[i] = std::sqrt(x[i]);
      break;
    case UnOp::kSin:
      for (int64_t i = 0; i < n; ++i) y[i] = std::sin(x[i]);
      break;
    case UnOp::kCos:
      for (int64_t i = 0; i < n; ++i) y[i] = std::cos(x[i]);
      break;
  }
}

}  // namespace

extern "C" {

void* ox_create() { return new Program(); }

int32_t ox_alloc(void* h, int64_t n) {
  Program* pg = static_cast<Program*>(h);
  pg->bufs.emplace_back(static_cast<size_t>(n), 0.0f);
  return static_cast<int32_t>(pg->bufs.size() - 1);
}

void ox_write(void* h, int32_t buf, const float* data, int64_t n) {
  Program* pg = static_cast<Program*>(h);
  std::memcpy(pg->bufs[buf].data(), data, sizeof(float) * n);
}

void ox_read(void* h, int32_t buf, float* out, int64_t n) {
  Program* pg = static_cast<Program*>(h);
  std::memcpy(out, pg->bufs[buf].data(), sizeof(float) * n);
}

static void view_from(View* v, int32_t buf, int64_t off, int32_t ndim,
                      const int64_t* shape, const int64_t* strides) {
  v->buf = buf;
  v->off = off;
  v->ndim = ndim;
  for (int i = 0; i < ndim; ++i) {
    v->shape[i] = shape[i];
    v->strides[i] = strides[i];
  }
}

void ox_add_copy(void* h, int32_t src_buf, int64_t src_off, int32_t ndim,
                 const int64_t* shape, const int64_t* strides, int32_t dst,
                 int64_t dst_off) {
  Program* pg = static_cast<Program*>(h);
  Instr in;
  in.kind = OpKind::kCopy;
  view_from(&in.a, src_buf, src_off, ndim, shape, strides);
  in.dst = dst;
  in.dst_off = dst_off;
  pg->instrs.push_back(in);
}

void ox_add_binary(void* h, int32_t op, int32_t a_buf, int64_t a_off,
                   const int64_t* a_strides, int32_t b_buf, int64_t b_off,
                   const int64_t* b_strides, int32_t ndim,
                   const int64_t* oshape, int32_t dst) {
  Program* pg = static_cast<Program*>(h);
  Instr in;
  in.kind = OpKind::kBinary;
  in.iop = op;
  view_from(&in.a, a_buf, a_off, ndim, oshape, a_strides);
  view_from(&in.b, b_buf, b_off, ndim, oshape, b_strides);
  in.dst = dst;
  pg->instrs.push_back(in);
}

void ox_add_unary(void* h, int32_t f, int32_t src, int64_t n, int32_t dst) {
  Program* pg = static_cast<Program*>(h);
  Instr in;
  in.kind = OpKind::kUnary;
  in.iop = f;
  in.a.buf = src;
  in.p0 = n;
  in.dst = dst;
  pg->instrs.push_back(in);
}

void ox_add_matmul(void* h, int32_t a, int64_t m, int64_t k, int32_t b,
                   int64_t n, int32_t bias, int32_t dst) {
  Program* pg = static_cast<Program*>(h);
  Instr in;
  in.kind = OpKind::kMatmul;
  in.a.buf = a;
  in.b.buf = b;
  in.p0 = m;
  in.p1 = k;
  in.p2 = n;
  in.p3 = bias;
  in.dst = dst;
  pg->instrs.push_back(in);
}

void ox_add_conv1d(void* h, int32_t x, int64_t C, int64_t W, int32_t w,
                   int64_t M, int64_t kW, int32_t stride, int32_t bias,
                   int32_t dst) {
  Program* pg = static_cast<Program*>(h);
  Instr in;
  in.kind = OpKind::kConv1d;
  in.a.buf = x;
  in.b.buf = w;
  in.p0 = C;
  in.p1 = W;
  in.p2 = M;
  in.p3 = kW;
  in.iop = stride;
  in.dst_off = bias;  // bias buffer id (-1 = none)
  in.dst = dst;
  pg->instrs.push_back(in);
}

void ox_add_reducemean_last(void* h, int32_t src, int64_t outer, int64_t d,
                            int32_t dst) {
  Program* pg = static_cast<Program*>(h);
  Instr in;
  in.kind = OpKind::kReduceMeanLast;
  in.a.buf = src;
  in.p0 = outer;
  in.p1 = d;
  in.dst = dst;
  pg->instrs.push_back(in);
}

int32_t ox_run(void* h) {
  Program* pg = static_cast<Program*>(h);
  for (const Instr& in : pg->instrs) {
    float* dst = pg->bufs[in.dst].data();
    switch (in.kind) {
      case OpKind::kCopy:
        copy_strided(*pg, in.a, dst + in.dst_off);
        break;
      case OpKind::kBinary:
        run_binary(*pg, in, dst);
        break;
      case OpKind::kUnary:
        run_unary(static_cast<UnOp>(in.iop), pg->bufs[in.a.buf].data(), dst,
                  in.p0);
        break;
      case OpKind::kMatmul: {
        const float* A = pg->bufs[in.a.buf].data();
        const float* B = pg->bufs[in.b.buf].data();
        const int64_t m = in.p0, k = in.p1, n = in.p2;
        if (in.p3 >= 0) {
          const float* bias = pg->bufs[static_cast<int32_t>(in.p3)].data();
          for (int64_t r = 0; r < m; ++r)
            std::memcpy(dst + r * n, bias, sizeof(float) * n);
        } else {
          std::memset(dst, 0, sizeof(float) * m * n);
        }
        for (int64_t r = 0; r < m; ++r) {
          float* yrow = dst + r * n;
          const float* arow = A + r * k;
          for (int64_t i = 0; i < k; ++i) {
            const float ai = arow[i];
            if (ai == 0.0f) continue;
            const float* brow = B + i * n;
            for (int64_t c = 0; c < n; ++c) yrow[c] += ai * brow[c];
          }
        }
        break;
      }
      case OpKind::kConv1d: {
        const float* X = pg->bufs[in.a.buf].data();   // [C,W]
        const float* Wt = pg->bufs[in.b.buf].data();  // [M,C,kW]
        const int64_t C = in.p0, W = in.p1, M = in.p2, kW = in.p3;
        const int64_t s = in.iop;
        const int64_t Wo = (W - kW) / s + 1;
        const int32_t bias = static_cast<int32_t>(in.dst_off);
        for (int64_t m2 = 0; m2 < M; ++m2) {
          const float b0 = bias >= 0 ? pg->bufs[bias][m2] : 0.0f;
          float* yrow = dst + m2 * Wo;
          for (int64_t o = 0; o < Wo; ++o) {
            float acc = b0;
            const int64_t x0 = o * s;
            for (int64_t c = 0; c < C; ++c) {
              const float* xr = X + c * W + x0;
              const float* wr = Wt + (m2 * C + c) * kW;
              for (int64_t t = 0; t < kW; ++t) acc += xr[t] * wr[t];
            }
            yrow[o] = acc;
          }
        }
        break;
      }
      case OpKind::kReduceMeanLast: {
        const float* X = pg->bufs[in.a.buf].data();
        const int64_t outer = in.p0, d = in.p1;
        for (int64_t r = 0; r < outer; ++r) {
          float acc = 0.0f;
          const float* row = X + r * d;
          for (int64_t i = 0; i < d; ++i) acc += row[i];
          dst[r] = acc / static_cast<float>(d);
        }
        break;
      }
    }
  }
  return static_cast<int32_t>(pg->instrs.size());
}

void ox_destroy(void* h) { delete static_cast<Program*>(h); }

}  // extern "C"
