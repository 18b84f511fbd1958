// The lanes engine's rigid-body dynamics up to the contact solve, one launch
// a substep (kernel 3), and the body caches of the derived state (its second
// entry point, lanes_body_state).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA's fusion
// (pbhc_tpu/sim/engine_lanes.py:488-560, 245-283). The port ran it as ~1,250
// small PyTorch ops a substep (kb1's 23-DoF model; ~1,545 for 29 DoF), each a
// pass over [3,3,B,N] or [6,6,B,N] intermediates; this computes the same
// function as LanesEngine._pre_contact_plain and _body_state_plain
// (pbhc_tpu_torch/sim/engine_lanes.py), in float32 (the poses and gaps op for
// op, see mul_rn below):
//   FK level by level; the spatial inertias about the root body's origin
//   (world axes) and the motion subspace Phi_d; the CRBA mass matrix with the
//   dof-ancestry mask and the armature; the RNEA bias forces with qdd = 0;
//   the branch-sparse SPD inverse (a Cholesky of each dof group with the
//   pivot clamped at 1e-12, L^-1 by forward substitution, D^-1 = L^-T L^-1,
//   then the 6x6 root Schur complement the same way); the passive torques
//   and u_plus; the energy projection with the gravity forces; the contact
//   Jacobian with ground rows masked by ancestry; the sphere centres; the
//   self-collision pair frames, gaps and rotated rows.
//
// Layouts (env axis last, as the engine holds them; float32, contiguous):
//   in:  q, qd, tau [nd,N], rq [4,N], rp, rv, rw [3,N], mass [B,N],
//        com [3,B,N], inertia [3,3,B,N], armature, damping, frictionloss [nd,N]
//   out: u_plus [nv,N], M_inv [nv,nv,N], Jf [KT*3,nv,N] (rows k-major),
//        x [3,K,N] (sphere centres, for the ground gap the caller computes),
//        phi_p [P,N], C [3,3,P,N]
//   body state out (env-first, as SimState holds them): pos, lin_vel,
//        ang_vel [N,B,3], quat [N,B,4] (xyzw)
// The model's tables (tree, levels, dof groups, masks, local frames, contact
// spheres, pairs) arrive packed once per engine (sim/dynamics_kernel.py).
//
// Bound on an H100: every input read once and every output written once.
// kb1 (nb 24, nd 23, nv 29, K 21, P 17) at N = 4096: about 4,870 floats an
// env, 79.8 MB, 23.8 us at 3.35 TB/s; kb2 (nb 30, nd 29, nv 35) at N = 2048:
// about 6,060 floats an env, 49.6 MB, 14.8 us. The arithmetic (~60 kFLOP an
// env) is far below the card's rate. What limits a direct design is latency:
// each env's chain is some 80 dependent steps (the tree's levels down and up,
// a Cholesky column at a time), each a few dependent shared-memory reads.
//
// Design: a block takes a tile of E neighbouring envs (env index fastest, as
// apgd_common.cuh does, so every load and store of an [..., N] array is E
// consecutive floats) and spreads each env's work over kThreadsPerEnv
// threads: by body within a tree level, by matrix entry in the CRBA, the
// inverse's products and M_inv, by row within a Cholesky column, by entry of
// the Jacobian. Every intermediate (R_w, p_w, the spatial inertias and their
// composites, Phi_d, the RNEA velocities and forces, M, the Cholesky factors,
// the inverse's blocks) stays in shared memory, entry i of env e at i * E + e
// (the E lanes of one entry hit E banks). Each phase is a strided loop over
// its work items followed by a barrier. FK and the RNEA forward sweep share
// one level loop (level l's poses with level l-1's twists), the composite
// inertias and subtree forces are summed up the parent chain in one loop
// from the deepest level (children summed in a fixed order: no atomics, so
// a CUDA graph's replay equals the eager launch bit for bit). E is the
// largest of 4, 2, 1 whose tile fits two blocks on an SM, so N = 2048 gives
// 512 blocks. No fast-math intrinsics: sinf, cosf, sqrtf, tanhf.
//
// One kernel serves every model up to the caps below: sizes, levels and
// groups are read at run time; the launch returns -1 beyond a cap.

#ifndef LANES_DYNAMICS_HOST
#include <cuda_runtime.h>
#define LD_SHARED(name) extern __shared__ __align__(16) float name[]
#endif

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace ld {

constexpr int kThreadsPerEnv = 64;
constexpr int kMaxBodies = 40;
constexpr int kMaxDofs = 42;
constexpr int kMaxContacts = 32;
constexpr int kMaxPairs = 32;
constexpr int kMaxLevels = 16;
constexpr int kMaxGroups = 8;
constexpr float kGravity = 9.81f;

// The model's tables on the device (sim/dynamics_kernel.py packs them; the
// ctypes mirror there keeps this field order).
struct Model {
  int nb, nd, nv, K, P, levels, groups, max_group;
  const int* parent;        // [nb], -1 at the root (body 0)
  const int* level_start;   // [levels + 1]: level l is level_body[level_start[l] : level_start[l + 1]]
  const int* level_body;    // [nb]: bodies by level, the root (level 0) first
  const int* child_start;   // [nb + 1]: children of b are child[child_start[b] : child_start[b + 1]]
  const int* child;         // [nb - 1]
  const int* body_dof;      // [nb]: the body's dof, -1 for none
  const int* dof_body;      // [nd]
  const int* dof_anc;       // [nd * nd]: 1 where dof i is dof j or an ancestor of it
  const int* group_start;   // [groups + 1]: dof groups (contiguous, M_dd block diagonal over them)
  const int* dof_group;     // [nd]
  const int* contact_body;  // [K]
  const int* contact_anc;   // [K * nd]: 1 where dof d moves sphere k
  const int* pair_i;        // [P]
  const int* pair_j;        // [P]
  const float* R_local;     // [nb * 9], row-major
  const float* local_pos;   // [nb * 3]
  const float* axis;        // [nd * 3]
  const float* contact_pos; // [K * 3]
  const float* pair_rsum;   // [P]
};

struct Inputs {
  const float *q, *qd, *rq, *rp, *rv, *rw, *tau, *mass, *com, *inertia, *armature, *damping, *frictionloss;
};

struct Outputs {
  float *u_plus, *M_inv, *Jf, *x, *phi_p, *C;
};

struct BodyInputs {
  const float *q, *qd, *rq, *rp, *rv, *rw;
};

struct BodyOutputs {
  float *pos, *quat, *lin_vel, *ang_vel;
};

inline bool within_caps(const Model& m) {
  return m.nb >= 1 && m.nb <= kMaxBodies && m.nd >= 1 && m.nd <= kMaxDofs && m.nv == m.nd + 6 && m.K >= 0 &&
         m.K <= kMaxContacts && m.P >= 0 && m.P <= kMaxPairs && m.levels >= 1 && m.levels <= kMaxLevels &&
         m.groups >= 1 && m.groups <= kMaxGroups && m.max_group >= 1 && m.max_group <= m.nd;
}

// Per-env shared-memory plan of the dynamics kernel, in floats.
struct Layout {
  int Rw, pw, Ib, Ic, Phi, F, A, L, v, a, fb, fs, Li, M, arm, invd, piv, Eb, S, Sinv, TR;
  int u, y, up, Mu, Mup, tauf, G, xw, xr, C, q, qd, scal, total;
};

__host__ __device__ inline int take(int& at, int n) {
  const int here = at;
  at += n;
  return here;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout dynamics_layout(const Model& m) {
  Layout s{};
  int at = 0;
  s.Rw = take(at, 9 * m.nb);
  s.pw = take(at, 3 * m.nb);
  s.Ib = take(at, 10 * m.nb);  // spatial inertia: mass, h = m c, I about the origin (xx yy zz xy xz yz)
  s.Ic = take(at, 10 * m.nb);  // the same summed over the subtree
  s.Phi = take(at, 6 * m.nd);
  s.F = take(at, 6 * m.nd);
  // the FK's local rotations, then the Cholesky factors and D^-1 (then the
  // bottom-right block of M^-1) share one region; the RNEA's velocities,
  // accelerations and forces, then L^-1, another
  s.A = s.L = take(at, imax(9 * m.nb, m.nd * m.nd));
  s.v = s.Li = take(at, imax(imax(24 * m.nb, m.nd * m.nd), 72));  // 72: the Schur complement's scratch
  s.a = s.v + 6 * m.nb;
  s.fb = s.v + 12 * m.nb;
  s.fs = s.v + 18 * m.nb;
  s.M = take(at, m.nv * m.nv);
  s.arm = take(at, m.nd);
  s.invd = take(at, imax(m.nd, 6));
  s.piv = take(at, kMaxGroups);
  s.Eb = take(at, 6 * m.nd);
  s.S = take(at, 36);
  s.Sinv = take(at, 36);
  s.TR = take(at, 6 * m.nd);
  s.u = take(at, m.nv);
  s.y = take(at, m.nv);
  s.up = take(at, m.nv);
  s.Mu = take(at, m.nv);
  s.Mup = take(at, m.nv);
  s.tauf = take(at, m.nv);
  s.G = take(at, m.nv);
  s.xw = take(at, 3 * imax(m.K, 1));
  s.xr = take(at, 3 * imax(m.K, 1));
  s.C = take(at, 9 * imax(m.P, 1));
  s.q = take(at, m.nd);
  s.qd = take(at, m.nd);
  s.scal = take(at, 1);
  s.total = at;
  return s;
}

// Per-env shared-memory plan of the body-state kernel, in floats.
struct BodyLayout {
  int Rw, pw, A, v, w, quat, total;
};

__host__ __device__ inline BodyLayout body_layout(const Model& m) {
  BodyLayout s{};
  int at = 0;
  s.Rw = take(at, 9 * m.nb);
  s.pw = take(at, 3 * m.nb);
  s.A = take(at, 9 * m.nb);
  s.v = take(at, 3 * m.nb);
  s.w = take(at, 3 * m.nb);
  s.quat = take(at, 4 * m.nb);
  s.total = at;
  return s;
}

// Entry i of one env's shared memory.
template <int E>
struct Env {
  float* p;
  __device__ __forceinline__ float& operator[](int i) const { return p[i * E]; }
};

// Products and sums rounded one at a time, never fused into a multiply-add:
// the poses (FK, the sphere centres, the pair gaps) follow the plain
// version's PyTorch ops one for one, so that the gaps, which decide the
// contact rows and which of them are active, equal the plain version's bit
// for bit (a gap within an ulp of 0, or two tied gaps, would otherwise pick
// other rows than the plain version in a few envs of a step).
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// a0 b0 + a1 b1 + a2 b2 summed left to right, as `sum(A[:, k] * B[k] for k)`
__device__ __forceinline__ float dot3_rn(float a0, float b0, float a1, float b1, float a2, float b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// xyzw quaternion -> row-major rotation matrix (rotations.quat_to_matrix,
// op for op)
__device__ __forceinline__ void quat_to_matrix(float x, float y, float z, float w, float* R) {
  const float xx = mul_rn(x, x), yy = mul_rn(y, y), zz = mul_rn(z, z);
  const float xy = mul_rn(x, y), xz = mul_rn(x, z), yz = mul_rn(y, z);
  const float wx = mul_rn(w, x), wy = mul_rn(w, y), wz = mul_rn(w, z);
  R[0] = sub_rn(1.0f, mul_rn(2.0f, add_rn(yy, zz)));
  R[1] = mul_rn(2.0f, sub_rn(xy, wz));
  R[2] = mul_rn(2.0f, add_rn(xz, wy));
  R[3] = mul_rn(2.0f, add_rn(xy, wz));
  R[4] = sub_rn(1.0f, mul_rn(2.0f, add_rn(xx, zz)));
  R[5] = mul_rn(2.0f, sub_rn(yz, wx));
  R[6] = mul_rn(2.0f, sub_rn(xz, wy));
  R[7] = mul_rn(2.0f, add_rn(yz, wx));
  R[8] = sub_rn(1.0f, mul_rn(2.0f, add_rn(xx, yy)));
}

// Rj_b, the rotation about the dof's axis a by q, as the plain version forms
// it: (I cos + [a]x sin) + a a^T (1 - cos); the identity for a body without a dof.
template <int E>
__device__ void joint_rotation(const Model& m, Env<E> S, int A, int b, float q) {
  const int d = m.body_dof[b];
  if (d < 0) {
    for (int r = 0; r < 9; ++r) S[A + 9 * b + r] = (r % 4 == 0) ? 1.0f : 0.0f;
    return;
  }
  const float c = cosf(q), s = sinf(q), ax = m.axis[3 * d], ay = m.axis[3 * d + 1], az = m.axis[3 * d + 2];
  const float K[9] = {0.0f, -az, ay, az, 0.0f, -ax, -ay, ax, 0.0f};
  const float a[3] = {ax, ay, az};
  const float one_c = sub_rn(1.0f, c);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      S[A + 9 * b + 3 * i + k] = add_rn(add_rn(mul_rn(i == k ? 1.0f : 0.0f, c), mul_rn(K[3 * i + k], s)),
                                        mul_rn(mul_rn(a[i], a[k]), one_c));
}

// R_b = (R_parent R_local_b) Rj_b, p_b = R_parent local_pos_b + p_parent
template <int E>
__device__ void place_body(const Model& m, Env<E> S, int Rw, int pw, int A, int b) {
  const int p = m.parent[b];
  float Rp[9], T[9];
  for (int r = 0; r < 9; ++r) Rp[r] = S[Rw + 9 * p + r];
  const float* Rl = m.R_local + 9 * b;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      T[3 * i + k] = dot3_rn(Rp[3 * i], Rl[k], Rp[3 * i + 1], Rl[3 + k], Rp[3 * i + 2], Rl[6 + k]);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      S[Rw + 9 * b + 3 * i + k] = dot3_rn(T[3 * i], S[A + 9 * b + k], T[3 * i + 1], S[A + 9 * b + 3 + k],
                                          T[3 * i + 2], S[A + 9 * b + 6 + k]);
  const float* lp = m.local_pos + 3 * b;
  for (int c = 0; c < 3; ++c)
    S[pw + 3 * b + c] =
        add_rn(dot3_rn(Rp[3 * c], lp[0], Rp[3 * c + 1], lp[1], Rp[3 * c + 2], lp[2]), S[pw + 3 * p + c]);
}

// The spatial inertia (m, h, I; I_o = [[I, [h]x], [-[h]x, m 1]]) times a
// spatial vector x = (angular, linear).
__device__ __forceinline__ void inertia_times(const float* I, const float* x, float* out) {
  const float m = I[0], h[3] = {I[1], I[2], I[3]};
  const float Ia[9] = {I[4], I[7], I[8], I[7], I[5], I[9], I[8], I[9], I[6]};
  float hxl[3], hxa[3];
  cross3(h, x + 3, hxl);
  cross3(h, x, hxa);
  for (int c = 0; c < 3; ++c) {
    out[c] = Ia[3 * c] * x[0] + Ia[3 * c + 1] * x[1] + Ia[3 * c + 2] * x[2] + hxl[c];
    out[3 + c] = m * x[3 + c] - hxa[c];
  }
}

// Row i's dof group [g0, g1) and index g; `single` > 0: one block of that size.
__device__ __forceinline__ void block_of(const Model& m, int single, int i, int& g, int& g0, int& g1) {
  if (single) {
    g = 0;
    g0 = 0;
    g1 = single;
  } else {
    g = m.dof_group[i];
    g0 = m.group_start[g];
    g1 = m.group_start[g + 1];
  }
}

// The SPD inverse of the block-diagonal nr x nr matrix read at
// S[A + i * astride + k] (its lower triangle), block by block in parallel,
// as engine_lanes._spd_inverse_lanes computes each block: a left-looking
// Cholesky with the pivot clamped at 1e-12, L^-1 column by column, then
// L^-T L^-1 within each block into `out` (entries outside the blocks are
// not written). L, Li: nr x nr scratch; out may be L. Ends on a barrier.
template <int E>
__device__ void spd_inverse_blocks(const Model& m, Env<E> S, int j, int nr, int single, int maxg, int A,
                                   int astride, int L, int Li, int invd, int piv, int out) {
  for (int c = 0; c < maxg; ++c) {
    for (int i = j; i < nr; i += kThreadsPerEnv) {
      int g, g0, g1;
      block_of(m, single, i, g, g0, g1);
      const int jd = g0 + c;
      if (jd < g1 && i >= jd) {
        float acc = 0.0f;
        for (int k = g0; k < jd; ++k) acc += S[L + i * nr + k] * S[L + jd * nr + k];
        const float s = S[A + i * astride + jd] - acc;
        if (i == jd)
          S[piv + g] = s;
        else
          S[L + i * nr + jd] = s;
      }
    }
    __syncthreads();
    for (int i = j; i < nr; i += kThreadsPerEnv) {
      int g, g0, g1;
      block_of(m, single, i, g, g0, g1);
      const int jd = g0 + c;
      if (jd < g1 && i >= jd) {
        const float d = sqrtf(fmaxf(S[piv + g], 1e-12f));
        const float inv = 1.0f / d;
        if (i == jd) {
          S[L + i * nr + i] = d;
          S[invd + i] = inv;
        } else {
          S[L + i * nr + jd] *= inv;
        }
      }
    }
    __syncthreads();
  }
  for (int c = j; c < nr; c += kThreadsPerEnv) {  // column c of L^-1
    int g, g0, g1;
    block_of(m, single, c, g, g0, g1);
    S[Li + c * nr + c] = S[invd + c];
    for (int i = c + 1; i < g1; ++i) {
      float acc = 0.0f;
      for (int k = c; k < i; ++k) acc += S[L + i * nr + k] * S[Li + k * nr + c];
      S[Li + i * nr + c] = -acc * S[invd + i];
    }
  }
  __syncthreads();
  for (int w = j; w < nr * nr; w += kThreadsPerEnv) {
    const int i = w / nr, k = w - (w / nr) * nr;
    int g, g0, g1;
    block_of(m, single, i, g, g0, g1);
    if (k < g0 || k >= g1) continue;
    float acc = 0.0f;
    for (int r = imax(i, k); r < g1; ++r) acc += S[Li + r * nr + i] * S[Li + r * nr + k];
    S[out + w] = acc;
  }
  __syncthreads();
}

// Column v of sphere k's 3 contact-Jacobian rows (the world linear velocity
// of the sphere centre per generalised velocity v), masked by ancestry. xr:
// the centre relative to the root body's origin.
template <int E>
__device__ __forceinline__ void jacobian(const Model& m, Env<E> S, const Layout& s, int k, int v, float* J) {
  if (v < 3) {
    for (int c = 0; c < 3; ++c) J[c] = c == v ? 1.0f : 0.0f;
    return;
  }
  const float x0 = S[s.xr + 3 * k], x1 = S[s.xr + 3 * k + 1], x2 = S[s.xr + 3 * k + 2];
  if (v < 6) {  // e_w x xr
    const int w = v - 3;
    J[0] = w == 0 ? 0.0f : (w == 1 ? x2 : -x1);
    J[1] = w == 0 ? -x2 : (w == 1 ? 0.0f : x0);
    J[2] = w == 0 ? x1 : (w == 1 ? -x0 : 0.0f);
    return;
  }
  const int d = v - 6;
  if (!m.contact_anc[k * m.nd + d]) {
    J[0] = J[1] = J[2] = 0.0f;
    return;
  }
  const float a0 = S[s.Phi + d], a1 = S[s.Phi + m.nd + d], a2 = S[s.Phi + 2 * m.nd + d];
  J[0] = S[s.Phi + 3 * m.nd + d] + (a1 * x2 - a2 * x1);
  J[1] = S[s.Phi + 4 * m.nd + d] + (a2 * x0 - a0 * x2);
  J[2] = S[s.Phi + 5 * m.nd + d] + (a0 * x1 - a1 * x0);
}

// M^-1 entry (i, k) from its blocks: S^-1, TR, TR^T and the bottom-right
// block (in L's region once the M^-1 phase has run).
template <int E>
__device__ __forceinline__ float minv_at(const Model& m, Env<E> S, const Layout& s, int i, int k) {
  if (i < 6 && k < 6) return S[s.Sinv + 6 * i + k];
  if (i < 6) return S[s.TR + i * m.nd + (k - 6)];
  if (k < 6) return S[s.TR + k * m.nd + (i - 6)];
  return S[s.L + (i - 6) * m.nd + (k - 6)];
}

template <int E>
__global__ void __launch_bounds__(E * kThreadsPerEnv, 8 / E)
    lanes_dynamics_kernel(const Model m, const Layout s, const Inputs in, const Outputs out, const int N,
                          const float dt, const int energy) {
  LD_SHARED(sh);
  const int tid = threadIdx.x, e = tid % E, j = tid / E;
  const int n0 = blockIdx.x * E + e;
  const bool live = n0 < N;
  const size_t n = static_cast<size_t>(live ? n0 : N - 1), sN = static_cast<size_t>(N);
  const Env<E> S{sh + e};
  const int nb = m.nb, nd = m.nd, nv = m.nv, K = m.K, P = m.P;
  constexpr int T = kThreadsPerEnv;

  // ---- the state, the passive torques, the root's pose and motion, Rj_b
  for (int w = j; w < nd + 1 + nb; w += T) {
    if (w < nd) {
      const float q = in.q[w * sN + n], qd = in.qd[w * sN + n];
      S[s.q + w] = q;
      S[s.qd + w] = qd;
      S[s.u + 6 + w] = qd;
      S[s.arm + w] = in.armature[w * sN + n];
      const float passive = -in.damping[w * sN + n] * qd - in.frictionloss[w * sN + n] * tanhf(qd / 0.05f);
      S[s.tauf + 6 + w] = in.tau[w * sN + n] + passive;
    } else if (w == nd) {
      float R[9];
      quat_to_matrix(in.rq[n], in.rq[sN + n], in.rq[2 * sN + n], in.rq[3 * sN + n], R);
      for (int r = 0; r < 9; ++r) S[s.Rw + r] = R[r];
      float rv[3], rw[3];
      for (int c = 0; c < 3; ++c) {
        S[s.pw + c] = in.rp[c * sN + n];
        rv[c] = in.rv[c * sN + n];
        rw[c] = in.rw[c * sN + n];
        S[s.u + c] = rv[c];
        S[s.u + 3 + c] = rw[c];
        S[s.v + c] = rw[c];
        S[s.v + 3 + c] = rv[c];
        S[s.a + c] = 0.0f;
      }
      float g[3];
      cross3(rv, rw, g);
      g[2] += kGravity;
      for (int c = 0; c < 3; ++c) S[s.a + 3 + c] = g[c];
      for (int c = 0; c < 6; ++c) S[s.tauf + c] = 0.0f;
    } else {
      const int b = w - nd - 1;
      if (b > 0) {
        const int d = m.body_dof[b];
        joint_rotation(m, S, s.A, b, d >= 0 ? in.q[d * sN + n] : 0.0f);
      }
    }
  }
  __syncthreads();

  // ---- FK of level l, beside Phi_d and the RNEA twists of level l - 1
  for (int l = 1; l <= m.levels; ++l) {
    const int c1 = l < m.levels ? m.level_start[l + 1] - m.level_start[l] : 0;
    const int c2 = l >= 2 ? m.level_start[l] - m.level_start[l - 1] : 0;
    for (int w = j; w < c1 + c2; w += T) {
      if (w < c1) {
        place_body(m, S, s.Rw, s.pw, s.A, m.level_body[m.level_start[l] + w]);
        continue;
      }
      const int b = m.level_body[m.level_start[l - 1] + w - c1], p = m.parent[b], d = m.body_dof[b];
      float tw[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (d >= 0) {
        float ax[3], prel[3], lin[3];
        for (int c = 0; c < 3; ++c) {
          ax[c] = S[s.Rw + 9 * b + 3 * c] * m.axis[3 * d] + S[s.Rw + 9 * b + 3 * c + 1] * m.axis[3 * d + 1] +
                  S[s.Rw + 9 * b + 3 * c + 2] * m.axis[3 * d + 2];
          prel[c] = S[s.pw + 3 * b + c] - S[s.pw + c];
        }
        cross3(prel, ax, lin);
        const float qd = S[s.qd + d];
        for (int c = 0; c < 3; ++c) {
          S[s.Phi + c * nd + d] = ax[c];
          S[s.Phi + (3 + c) * nd + d] = lin[c];
          tw[c] = ax[c] * qd;
          tw[3 + c] = lin[c] * qd;
        }
      }
      float vb[6], ab[6], x[3];
      for (int c = 0; c < 6; ++c) vb[c] = S[s.v + 6 * p + c] + tw[c];
      cross3(vb, tw, ab);  // cross_motion(v, twist) = (v_a x t_a, v_a x t_l + v_l x t_a)
      cross3(vb, tw + 3, ab + 3);
      cross3(vb + 3, tw, x);
      for (int c = 0; c < 3; ++c) ab[3 + c] += x[c];
      for (int c = 0; c < 6; ++c) {
        S[s.v + 6 * b + c] = vb[c];
        S[s.a + 6 * b + c] = S[s.a + 6 * p + c] + ab[c];
      }
    }
    __syncthreads();
  }

  // ---- spatial inertias and RNEA body forces; the sphere centres
  for (int w = j; w < nb + K; w += T) {
    if (w < nb) {
      const int b = w;
      const float mass = in.mass[b * sN + n];
      float R[9], c[3], I[9], Tm[9];
      for (int r = 0; r < 9; ++r) R[r] = S[s.Rw + 9 * b + r];
      for (int r = 0; r < 9; ++r) I[r] = in.inertia[(r * nb + b) * sN + n];
      for (int i = 0; i < 3; ++i) {
        const float com_i = in.com[(i * nb + b) * sN + n];
        c[i] = com_i;  // body frame until rotated below
      }
      float cw[3];
      for (int i = 0; i < 3; ++i)
        cw[i] = (S[s.pw + 3 * b + i] - S[s.pw + i]) + (R[3 * i] * c[0] + R[3 * i + 1] * c[1] + R[3 * i + 2] * c[2]);
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 3; ++k) Tm[3 * i + k] = R[3 * i] * I[k] + R[3 * i + 1] * I[3 + k] + R[3 * i + 2] * I[6 + k];
      float Icw[9];
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 3; ++k)
          Icw[3 * i + k] = Tm[3 * i] * R[3 * k] + Tm[3 * i + 1] * R[3 * k + 1] + Tm[3 * i + 2] * R[3 * k + 2];
      float Ib[10];
      Ib[0] = mass;
      for (int i = 0; i < 3; ++i) Ib[1 + i] = mass * cw[i];
      Ib[4] = Icw[0] + mass * (cw[1] * cw[1] + cw[2] * cw[2]);
      Ib[5] = Icw[4] + mass * (cw[2] * cw[2] + cw[0] * cw[0]);
      Ib[6] = Icw[8] + mass * (cw[1] * cw[1] + cw[0] * cw[0]);
      Ib[7] = Icw[1] + mass * (-(cw[0] * cw[1]));
      Ib[8] = Icw[2] + mass * (-(cw[0] * cw[2]));
      Ib[9] = Icw[5] + mass * (-(cw[1] * cw[2]));
      for (int r = 0; r < 10; ++r) S[s.Ib + 10 * b + r] = Ib[r];
      // f = I a + v x* (I v), v x* f = (v_a x f_a + v_l x f_l, v_a x f_l)
      float vb[6], ab[6], Iv[6], Ia[6], t0[3], t1[3];
      for (int r = 0; r < 6; ++r) {
        vb[r] = S[s.v + 6 * b + r];
        ab[r] = S[s.a + 6 * b + r];
      }
      inertia_times(Ib, vb, Iv);
      inertia_times(Ib, ab, Ia);
      cross3(vb, Iv, t0);
      cross3(vb + 3, Iv + 3, t1);
      for (int r = 0; r < 3; ++r) S[s.fb + 6 * b + r] = Ia[r] + (t0[r] + t1[r]);
      cross3(vb, Iv + 3, t0);
      for (int r = 0; r < 3; ++r) S[s.fb + 6 * b + 3 + r] = Ia[3 + r] + t0[r];
    } else {
      const int k = w - nb, b = m.contact_body[k];
      const float* cp = m.contact_pos + 3 * k;
      for (int c = 0; c < 3; ++c) {
        const float xw = add_rn(S[s.pw + 3 * b + c], dot3_rn(S[s.Rw + 9 * b + 3 * c], cp[0], S[s.Rw + 9 * b + 3 * c + 1],
                                                             cp[1], S[s.Rw + 9 * b + 3 * c + 2], cp[2]));
        S[s.xw + 3 * k + c] = xw;
        S[s.xr + 3 * k + c] = xw - S[s.pw + c];
        if (live) out.x[(c * K + k) * sN + n] = xw;
      }
    }
  }
  __syncthreads();

  // ---- self-collision pair frames: n from sphere j to i, t1, t2 = n x t1
  for (int p = j; p < P; p += T) {
    const int pi = m.pair_i[p], pj = m.pair_j[p];
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = sub_rn(S[s.xw + 3 * pi + c], S[s.xw + 3 * pj + c]);
    const float dist = sqrtf(add_rn(add_rn(mul_rn(d[0], d[0]), mul_rn(d[1], d[1])), mul_rn(d[2], d[2])));
    const float inv = fmaxf(dist, 1e-9f);
    const float nn[3] = {d[0] / inv, d[1] / inv, d[2] / inv};
    const bool use_z = fabsf(nn[2]) < 0.9f;
    const float ref[3] = {use_z ? 0.0f : 1.0f, 0.0f, use_z ? 1.0f : 0.0f};
    float t1[3], t2[3];
    cross3(ref, nn, t1);
    const float tn = fmaxf(sqrtf(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-9f);
    for (int c = 0; c < 3; ++c) t1[c] = t1[c] / tn;
    cross3(nn, t1, t2);
    for (int c = 0; c < 3; ++c) {
      S[s.C + 9 * p + c] = t1[c];
      S[s.C + 9 * p + 3 + c] = t2[c];
      S[s.C + 9 * p + 6 + c] = nn[c];
    }
    if (live) {
      out.phi_p[p * sN + n] = sub_rn(dist, m.pair_rsum[p]);
      for (int c = 0; c < 3; ++c) {
        out.C[((0 * 3 + c) * P + p) * sN + n] = t1[c];
        out.C[((1 * 3 + c) * P + p) * sN + n] = t2[c];
        out.C[((2 * 3 + c) * P + p) * sN + n] = nn[c];
      }
    }
  }
  __syncthreads();

  // ---- the contact Jacobian: ground rows, then the pair rows C (J_i - J_j);
  // nothing later reads what this writes, so no barrier follows
  for (int w = j; w < (K + P) * nv; w += T) {  // item: one column of a sphere's or a pair's 3 rows
    const int r = w / nv, v = w - r * nv;
    float J[3];
    if (r < K) {
      jacobian(m, S, s, r, v, J);
    } else {
      const int p = r - K;
      float Ji[3], Jj[3];
      jacobian(m, S, s, m.pair_i[p], v, Ji);
      jacobian(m, S, s, m.pair_j[p], v, Jj);
      for (int a = 0; a < 3; ++a) {
        J[a] = 0.0f;
        for (int c = 0; c < 3; ++c) J[a] += S[s.C + 9 * p + 3 * a + c] * (Ji[c] - Jj[c]);
      }
    }
    if (live)
      for (int c = 0; c < 3; ++c) out.Jf[static_cast<size_t>((3 * r + c) * nv + v) * sN + n] = J[c];
  }

  // ---- composite inertias and subtree forces, up the parent chain
  for (int l = m.levels - 1; l >= 0; --l) {
    const int c0 = m.level_start[l], cnt = m.level_start[l + 1] - c0;
    for (int w = j; w < 16 * cnt; w += T) {
      const int b = m.level_body[c0 + w / 16], r = w % 16;
      const int src = r < 10 ? s.Ib + 10 * b + r : s.fb + 6 * b + (r - 10);
      float acc = S[src];
      for (int ci = m.child_start[b]; ci < m.child_start[b + 1]; ++ci) {
        const int c = m.child[ci];
        acc += r < 10 ? S[s.Ic + 10 * c + r] : S[s.fs + 6 * c + (r - 10)];
      }
      if (r < 10)
        S[s.Ic + 10 * b + r] = acc;
      else
        S[s.fs + 6 * b + (r - 10)] = acc;
    }
    __syncthreads();
  }

  // ---- F = I_comp Phi_d, the bias and gravity forces, y = tau_full - bias
  for (int w = j; w <= nd; w += T) {
    if (w < nd) {
      const int b = m.dof_body[w];
      float ph[6], F[6];
      for (int r = 0; r < 6; ++r) ph[r] = S[s.Phi + r * nd + w];
      float Ic[10];
      for (int r = 0; r < 10; ++r) Ic[r] = S[s.Ic + 10 * b + r];
      inertia_times(Ic, ph, F);
      float bias = 0.0f;
      for (int r = 0; r < 6; ++r) {
        S[s.F + r * nd + w] = F[r];
        bias += ph[r] * S[s.fs + 6 * b + r];
      }
      S[s.y + 6 + w] = S[s.tauf + 6 + w] - bias;
      S[s.G + 6 + w] = ph[0] * (kGravity * Ic[2]) + ph[1] * (kGravity * -Ic[1]) + ph[5] * (kGravity * Ic[0]);
    } else {
      for (int r = 0; r < 3; ++r) {
        S[s.y + r] = S[s.tauf + r] - S[s.fs + 3 + r];
        S[s.y + 3 + r] = S[s.tauf + 3 + r] - S[s.fs + r];
      }
      const float Ic0 = S[s.Ic], h0 = S[s.Ic + 1], h1 = S[s.Ic + 2];
      S[s.G] = 0.0f;
      S[s.G + 1] = 0.0f;
      S[s.G + 2] = kGravity * Ic0;
      S[s.G + 3] = kGravity * h1;
      S[s.G + 4] = kGravity * -h0;
      S[s.G + 5] = 0.0f;
    }
  }
  __syncthreads();

  // ---- M = [[m 1, -[h]x, F_l], [[h]x, I, F_a], [., ., Phi^T F masked + armature]]
  for (int w = j; w < nv * nv; w += T) {
    const int i = w / nv, k = w - (w / nv) * nv;
    float val;
    if (i < 6 && k < 6) {
      const float mass = S[s.Ic], h[3] = {S[s.Ic + 1], S[s.Ic + 2], S[s.Ic + 3]};
      if (i < 3 && k < 3) {
        val = i == k ? mass : 0.0f;
      } else if (i >= 3 && k >= 3) {
        const int a = i - 3, b = k - 3;  // I's entries xx yy zz at 4-6, xy xz yz at 7-9
        val = S[s.Ic + (a == b ? 4 + a : 6 + a + b)];
      } else {
        // [h]x entry (a, b); M[0:3, 3:6] = -[h]x, M[3:6, 0:3] = [h]x
        const int a = i < 3 ? i : i - 3, b = k < 3 ? k : k - 3;
        float hx = 0.0f;
        if (a == 0 && b == 1) hx = -h[2];
        if (a == 0 && b == 2) hx = h[1];
        if (a == 1 && b == 0) hx = h[2];
        if (a == 1 && b == 2) hx = -h[0];
        if (a == 2 && b == 0) hx = -h[1];
        if (a == 2 && b == 1) hx = h[0];
        val = i < 3 ? -hx : hx;
      }
    } else if (i < 6) {
      val = S[s.F + ((i + 3) % 6) * nd + (k - 6)];
    } else if (k < 6) {
      val = S[s.F + ((k + 3) % 6) * nd + (i - 6)];
    } else {
      const int a = i - 6, b = k - 6;
      int lo = -1, hi = -1;
      if (m.dof_anc[a * nd + b]) {
        lo = a;
        hi = b;
      } else if (m.dof_anc[b * nd + a]) {
        lo = b;
        hi = a;
      }
      val = 0.0f;
      if (lo >= 0)
        for (int r = 0; r < 6; ++r) val += S[s.Phi + r * nd + lo] * S[s.F + r * nd + hi];
      if (a == b) val += S[s.arm + a];
    }
    S[s.M + w] = val;
  }
  __syncthreads();

  // ---- D^-1 of the dof groups (into L's region), then E = D^-1 B
  spd_inverse_blocks(m, S, j, nd, 0, m.max_group, s.M + 6 * nv + 6, nv, s.L, s.Li, s.invd, s.piv, s.L);
  for (int w = j; w < 6 * nd; w += T) {
    const int i = w / 6, k = w - 6 * (w / 6);
    const int g = m.dof_group[i], g0 = m.group_start[g], g1 = m.group_start[g + 1];
    float acc = 0.0f;
    for (int jj = g0; jj < g1; ++jj) acc += S[s.L + i * nd + jj] * S[s.M + (6 + jj) * nv + k];
    S[s.Eb + w] = acc;
  }
  __syncthreads();
  // ---- the root's Schur complement S = R - B^T E and its inverse
  for (int w = j; w < 36; w += T) {
    const int i = w / 6, k = w - 6 * (w / 6);
    float acc = 0.0f;
    for (int jj = 0; jj < nd; ++jj) acc += S[s.M + (6 + jj) * nv + i] * S[s.Eb + 6 * jj + k];
    S[s.S + w] = S[s.M + i * nv + k] - acc;
  }
  __syncthreads();
  // scratch in L^-1's region (D^-1 no longer needs it) and the dofs' 1/d
  spd_inverse_blocks(m, S, j, 6, 6, 6, s.S, 6, s.Li, s.Li + 36, s.invd, s.piv, s.Sinv);
  // ---- TR = -S^-1 E^T
  for (int w = j; w < 6 * nd; w += T) {
    const int i = w / nd, k = w - nd * (w / nd);
    float acc = 0.0f;
    for (int jj = 0; jj < 6; ++jj) acc += S[s.Sinv + 6 * i + jj] * S[s.Eb + 6 * k + jj];
    S[s.TR + w] = -acc;
  }
  __syncthreads();
  // ---- M^-1 = [[S^-1, TR], [TR^T, D^-1 - E TR]], the last block in place
  for (int w = j; w < nv * nv; w += T) {
    const int i = w / nv, k = w - nv * (w / nv);
    float val;
    if (i >= 6 && k >= 6) {
      const int a = i - 6, b = k - 6;
      const int g = m.dof_group[a];
      const bool same = b >= m.group_start[g] && b < m.group_start[g + 1];
      float acc = 0.0f;
      for (int r = 0; r < 6; ++r) acc += S[s.Eb + 6 * a + r] * S[s.TR + r * nd + b];
      val = (same ? S[s.L + a * nd + b] : 0.0f) - acc;
      S[s.L + a * nd + b] = val;
    } else {
      val = minv_at(m, S, s, i, k);
    }
    if (live) out.M_inv[static_cast<size_t>(w) * sN + n] = val;
  }
  __syncthreads();

  // ---- u_plus = u + dt M^-1 (tau_full - bias); M u for the energy check
  for (int w = j; w < 2 * nv; w += T) {
    if (w < nv) {
      float acc = 0.0f;
      for (int k = 0; k < nv; ++k) acc += minv_at(m, S, s, w, k) * S[s.y + k];
      S[s.up + w] = S[s.u + w] + dt * acc;
    } else if (energy) {
      const int i = w - nv;
      float acc = 0.0f;
      for (int k = 0; k < nv; ++k) acc += S[s.M + i * nv + k] * S[s.u + k];
      S[s.Mu + i] = acc;
    }
  }
  __syncthreads();
  if (energy) {
    for (int i = j; i < nv; i += T) {
      float acc = 0.0f;
      for (int k = 0; k < nv; ++k) acc += S[s.M + i * nv + k] * S[s.up + k];
      S[s.Mup + i] = acc;
    }
    __syncthreads();
    if (j == 0) {  // energy projection: scale u_plus so that KE grows by no more than the external work
      float ke0 = 0.0f, ke1 = 0.0f, pw = 0.0f;
      for (int i = 0; i < nv; ++i) {
        ke0 += S[s.u + i] * S[s.Mu + i];
        ke1 += S[s.up + i] * S[s.Mup + i];
        pw += (S[s.u + i] + S[s.up + i]) * (S[s.tauf + i] - S[s.G + i]);
      }
      ke0 *= 0.5f;
      ke1 *= 0.5f;
      pw *= 0.5f;
      const float target = fmaxf(ke0 + dt * pw, 0.0f);
      S[s.scal] = fminf(sqrtf(target / fmaxf(ke1, 1e-12f)), 1.0f);
    }
    __syncthreads();
  }
  for (int i = j; i < nv; i += T) {
    const float up = energy ? S[s.up + i] * S[s.scal] : S[s.up + i];
    if (live) out.u_plus[i * sN + n] = up;
  }
}

// xyzw from a row-major rotation matrix, rotations.matrix_to_quat's formula:
// the candidate of the largest of (trace, the three diagonal combinations),
// the first on ties, w made non-negative, normalised.
__device__ void matrix_to_quat(const float* R, float* q) {
  const float m00 = R[0], m01 = R[1], m02 = R[2], m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = m00 + m11 + m22;
  const float sc[4] = {tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11};
  int best = 0;
  for (int i = 1; i < 4; ++i)
    if (sc[i] > sc[best]) best = i;
  float c[4], h;
  if (best == 0) {
    h = sqrtf(fmaxf(1.0f + tr, 1e-18f)) / 2.0f;
    c[0] = m21 - m12;
    c[1] = m02 - m20;
    c[2] = m10 - m01;
    c[3] = 4.0f * h * h;
  } else if (best == 1) {
    h = sqrtf(fmaxf(1.0f + m00 - m11 - m22, 1e-18f)) / 2.0f;
    c[0] = 4.0f * h * h;
    c[1] = m01 + m10;
    c[2] = m02 + m20;
    c[3] = m21 - m12;
  } else if (best == 2) {
    h = sqrtf(fmaxf(1.0f - m00 + m11 - m22, 1e-18f)) / 2.0f;
    c[0] = m01 + m10;
    c[1] = 4.0f * h * h;
    c[2] = m12 + m21;
    c[3] = m02 - m20;
  } else {
    h = sqrtf(fmaxf(1.0f - m00 - m11 + m22, 1e-18f)) / 2.0f;
    c[0] = m02 + m20;
    c[1] = m12 + m21;
    c[2] = 4.0f * h * h;
    c[3] = m10 - m01;
  }
  const float den = 4.0f * h;
  for (int i = 0; i < 4; ++i) c[i] = c[i] / den;
  if (c[3] < 0.0f)
    for (int i = 0; i < 4; ++i) c[i] = -c[i];
  const float norm = fmaxf(sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + c[3] * c[3]), 1e-9f);
  for (int i = 0; i < 4; ++i) q[i] = c[i] / norm;
}

template <int E>
__global__ void __launch_bounds__(E * kThreadsPerEnv, 8 / E)
    lanes_body_state_kernel(const Model m, const BodyLayout s, const BodyInputs in, const BodyOutputs out,
                            const int N) {
  LD_SHARED(sh);
  const int tid = threadIdx.x, e = tid % E, j = tid / E;
  const int e0 = blockIdx.x * E, n0 = e0 + e;
  const size_t n = static_cast<size_t>(n0 < N ? n0 : N - 1), sN = static_cast<size_t>(N);
  const Env<E> S{sh + e};
  const int nb = m.nb;
  constexpr int T = kThreadsPerEnv;

  for (int w = j; w < nb; w += T) {
    if (w == 0) {
      float R[9];
      quat_to_matrix(in.rq[n], in.rq[sN + n], in.rq[2 * sN + n], in.rq[3 * sN + n], R);
      for (int r = 0; r < 9; ++r) S[s.Rw + r] = R[r];
      for (int c = 0; c < 3; ++c) {
        S[s.pw + c] = in.rp[c * sN + n];
        S[s.v + c] = in.rv[c * sN + n];
        S[s.w + c] = in.rw[c * sN + n];
      }
    } else {
      const int d = m.body_dof[w];
      joint_rotation(m, S, s.A, w, d >= 0 ? in.q[d * sN + n] : 0.0f);
    }
  }
  __syncthreads();

  // FK of level l beside the velocities of level l - 1:
  // w_b = w_p + R_b axis qd, v_b = v_p + w_p x (p_b - p_p)
  for (int l = 1; l <= m.levels; ++l) {
    const int c1 = l < m.levels ? m.level_start[l + 1] - m.level_start[l] : 0;
    const int c2 = l >= 2 ? m.level_start[l] - m.level_start[l - 1] : 0;
    for (int w = j; w < c1 + c2; w += T) {
      if (w < c1) {
        place_body(m, S, s.Rw, s.pw, s.A, m.level_body[m.level_start[l] + w]);
        continue;
      }
      const int b = m.level_body[m.level_start[l - 1] + w - c1], p = m.parent[b], d = m.body_dof[b];
      float tw[3] = {0.0f, 0.0f, 0.0f}, wp[3], dp[3], vx[3];
      if (d >= 0) {
        const float qd = in.qd[d * sN + n];
        for (int c = 0; c < 3; ++c)
          tw[c] = (S[s.Rw + 9 * b + 3 * c] * m.axis[3 * d] + S[s.Rw + 9 * b + 3 * c + 1] * m.axis[3 * d + 1] +
                   S[s.Rw + 9 * b + 3 * c + 2] * m.axis[3 * d + 2]) *
                  qd;
      }
      for (int c = 0; c < 3; ++c) {
        wp[c] = S[s.w + 3 * p + c];
        dp[c] = S[s.pw + 3 * b + c] - S[s.pw + 3 * p + c];
      }
      cross3(wp, dp, vx);
      for (int c = 0; c < 3; ++c) {
        S[s.w + 3 * b + c] = wp[c] + tw[c];
        S[s.v + 3 * b + c] = S[s.v + 3 * p + c] + vx[c];
      }
    }
    __syncthreads();
  }

  for (int b = j; b < nb; b += T) {
    float R[9], q[4];
    for (int r = 0; r < 9; ++r) R[r] = S[s.Rw + 9 * b + r];
    matrix_to_quat(R, q);
    for (int c = 0; c < 4; ++c) S[s.quat + 4 * b + c] = q[c];
  }
  __syncthreads();

  // env-first outputs: the tile's E envs are one contiguous run of each array
  const int live = N - e0 < E ? N - e0 : E;
  const size_t base3 = static_cast<size_t>(e0) * nb * 3, base4 = static_cast<size_t>(e0) * nb * 4;
  for (int f = tid; f < live * nb * 3; f += E * T) {
    const int ee = f / (nb * 3), r = f - ee * nb * 3;
    out.pos[base3 + f] = sh[(s.pw + r) * E + ee];
    out.lin_vel[base3 + f] = sh[(s.v + r) * E + ee];
    out.ang_vel[base3 + f] = sh[(s.w + r) * E + ee];
  }
  for (int f = tid; f < live * nb * 4; f += E * T) {
    const int ee = f / (nb * 4), r = f - ee * nb * 4;
    out.quat[base4 + f] = sh[(s.quat + r) * E + ee];
  }
}

// The envs a block takes: the largest of 4, 2, 1 whose tile fits two blocks
// on an SM (the runtime keeps 1 KB of an SM's 228 KB per block).
constexpr size_t kSmSharedBytes = 233472;
constexpr size_t kBlockReservedBytes = 1024;

inline int choose_envs(int floats_per_env) {
  for (int E = 4; E > 1; E /= 2)
    if (2 * (static_cast<size_t>(E) * floats_per_env * sizeof(float) + kBlockReservedBytes) <= kSmSharedBytes)
      return E;
  return 1;
}

}  // namespace ld

#ifndef LANES_DYNAMICS_HOST

namespace {

struct LaunchCache {
  int optin = 0;
  size_t shared = 0;
};

// Let `kernel` take `bytes` of dynamic shared memory (the CUDA calls once
// per kernel instance, device and size); -1 beyond the opt-in limit.
template <class Kernel>
int prepare(Kernel kernel, size_t bytes, LaunchCache (&cache)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16) return -1;
  LaunchCache& c = cache[dev];
  if (c.optin == 0) {
    err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bytes > static_cast<size_t>(c.optin)) return -1;
  if (bytes > c.shared) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    c.shared = bytes;
  }
  return 0;
}

template <int E>
int launch_dynamics(const ld::Model& m, const ld::Inputs& in, const ld::Outputs& out, int N, float dt, int energy,
                    cudaStream_t stream) {
  static LaunchCache cache[16];
  const ld::Layout s = ld::dynamics_layout(m);
  const size_t bytes = static_cast<size_t>(E) * s.total * sizeof(float);
  const int err = prepare(ld::lanes_dynamics_kernel<E>, bytes, cache);
  if (err != 0) return err;
  ld::lanes_dynamics_kernel<E><<<(N + E - 1) / E, E * ld::kThreadsPerEnv, bytes, stream>>>(m, s, in, out, N, dt,
                                                                                             energy);
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int launch_body_state(const ld::Model& m, const ld::BodyInputs& in, const ld::BodyOutputs& out, int N,
                      cudaStream_t stream) {
  static LaunchCache cache[16];
  const ld::BodyLayout s = ld::body_layout(m);
  const size_t bytes = static_cast<size_t>(E) * s.total * sizeof(float);
  const int err = prepare(ld::lanes_body_state_kernel<E>, bytes, cache);
  if (err != 0) return err;
  ld::lanes_body_state_kernel<E><<<(N + E - 1) / E, E * ld::kThreadsPerEnv, bytes, stream>>>(m, s, in, out, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caps, in the order bodies, dofs, contacts, pairs, levels, groups.
extern "C" void lanes_dynamics_caps(int* caps) {
  const int c[6] = {ld::kMaxBodies, ld::kMaxDofs, ld::kMaxContacts, ld::kMaxPairs, ld::kMaxLevels, ld::kMaxGroups};
  for (int i = 0; i < 6; ++i) caps[i] = c[i];
}

// The envs a block of the dynamics kernel takes for model `m`, or of the
// body-state kernel where `body` is 1.
extern "C" int lanes_dynamics_envs(ld::Model m, int body) {
  return ld::choose_envs(body ? ld::body_layout(m).total : ld::dynamics_layout(m).total);
}

// Launches the dynamics kernel on `stream` with E envs a block (1, 2, 4 or
// 8; 0: lanes_dynamics_envs); returns the CUDA error code of the launch
// (0 = cudaSuccess), or -1 for a model beyond the caps, N < 1 or another E.
extern "C" int lanes_dynamics_launch(ld::Model m, ld::Inputs in, ld::Outputs out, int N, float dt, int energy, int E,
                                     void* stream) {
  if (!ld::within_caps(m) || N < 1) return -1;
  if (E == 0) E = ld::choose_envs(ld::dynamics_layout(m).total);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 1:
      return launch_dynamics<1>(m, in, out, N, dt, energy, st);
    case 2:
      return launch_dynamics<2>(m, in, out, N, dt, energy, st);
    case 4:
      return launch_dynamics<4>(m, in, out, N, dt, energy, st);
    case 8:
      return launch_dynamics<8>(m, in, out, N, dt, energy, st);
    default:
      return -1;
  }
}

// Launches the body-state kernel; E and the return value as above.
extern "C" int lanes_body_state_launch(ld::Model m, ld::BodyInputs in, ld::BodyOutputs out, int N, int E,
                                       void* stream) {
  if (!ld::within_caps(m) || N < 1) return -1;
  if (E == 0) E = ld::choose_envs(ld::body_layout(m).total);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 1:
      return launch_body_state<1>(m, in, out, N, st);
    case 2:
      return launch_body_state<2>(m, in, out, N, st);
    case 4:
      return launch_body_state<4>(m, in, out, N, st);
    case 8:
      return launch_body_state<8>(m, in, out, N, st);
    default:
      return -1;
  }
}

#endif  // LANES_DYNAMICS_HOST
