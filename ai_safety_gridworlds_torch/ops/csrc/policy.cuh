// Device policy pieces shared by the port's step kernels (K1 and K3 in
// fused_firemaker.cu, K4-K9 in fused_scalar.cu, fused_island_ma.cu and
// fused_savanna.cu).
//
// Counterparts of ai_safety_gridworlds_tpu/ops/fused_base.py::_policy_actions
// (:129, the greedy part of the per-lane linear policy), _mlp_forward_agent
// (:171) and _mlp_policy_actions (:196), and of their plain PyTorch versions
// in ops/fused_base.py, whose accumulation order they share: a logit or a
// hidden unit starts from its bias and adds the features in ascending order,
// an output row adds the hidden units in ascending order, and the softmax
// terms are summed left to right. The libraries are built with
// --fmad=false, so each product and each sum rounds on its own, as in the
// plain version.
#pragma once

#include <cuda_runtime.h>

namespace agw {

// The MLP's weights, in shared memory: w1 [H, F], b1 [H], w2 [A+1, H],
// b2 [A+1]; the last output row is the value head.
struct Mlp {
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  int H;
};

// The first argmax over the A legal actions of b[a] + sum_f W[a*F+f] * x[f],
// accumulated in that order. w is [A*F, stride] and b [A, stride]; stride is
// 1 for a shared policy or B for per-lane policies, read at column `lane`.
template <int F>
__device__ __forceinline__ int linear_greedy(const float* w, const float* b,
                                             int stride, int A, int lane,
                                             const float (&x)[F]) {
  float best_v = 0.f;
  int best_a = 0;
  for (int a = 0; a < A; ++a) {
    float logit = b[a * stride + lane];
#pragma unroll
    for (int f = 0; f < F; ++f) logit = logit + w[(a * F + f) * stride + lane] * x[f];
    if (a == 0 || logit > best_v) {
      best_v = logit;
      best_a = a;
    }
  }
  return best_a;
}

// h_k = relu(b1[k] + sum_f w1[k, f] * x_f), features ascending.
template <int F>
__device__ __forceinline__ float mlp_hidden(const Mlp& m, int k, const float (&x)[F]) {
  float h = m.b1[k];
#pragma unroll
  for (int f = 0; f < F; ++f) h = h + m.w1[k * F + f] * x[f];
  return fmaxf(h, 0.f);
}

// The softmax draw of _mlp_policy_actions on one agent's output rows out[0..A]
// (row A is the value head): the max-shifted logits, the log-normaliser
// (softmax terms summed left to right), the inverse-CDF draw over the first
// A-1 cumulative sums from the uniform u, and the drawn action's logp.
// Returns the drawn action's index in 0..A-1; A <= MAX_A.
template <int MAX_A>
__device__ __forceinline__ int mlp_sample(const float (&out)[MAX_A + 1], int A,
                                          float u, float& logp, float& value) {
  float mx = out[0];
#pragma unroll
  for (int a = 1; a < MAX_A; ++a)
    if (a < A) mx = fmaxf(mx, out[a]);
  float z[MAX_A];
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) z[a] = out[a] - mx;
  float s = expf(z[0]);
#pragma unroll
  for (int a = 1; a < MAX_A; ++a)
    if (a < A) s = s + expf(z[a]);
  const float log_se = logf(s);
  float run = 0.f;
  int idx = 0;
#pragma unroll
  for (int a = 0; a < MAX_A - 1; ++a) {
    if (a < A - 1) {
      run = run + expf(z[a] - log_se);
      idx += run <= u;
    }
  }
  float z_sel = z[0];
  value = out[0];
#pragma unroll
  for (int a = 0; a <= MAX_A; ++a) {
    if (a < MAX_A && a == idx) z_sel = z[a];
    if (a == A) value = out[a];
  }
  logp = z_sel - log_se;
  return idx;
}

// _mlp_forward_agent and _mlp_policy_actions for one agent, by one thread:
// the output rows accumulate bias first, hidden units ascending, with no
// register array of H hidden units; then mlp_sample.
template <int F, int MAX_A>
__device__ __forceinline__ int mlp_draw(const Mlp& m, int A, const float (&x)[F],
                                        float u, float& logp, float& value) {
  float out[MAX_A + 1];
#pragma unroll
  for (int a = 0; a <= MAX_A; ++a) out[a] = a <= A ? m.b2[a] : 0.f;
  for (int k = 0; k < m.H; ++k) {
    const float h = mlp_hidden<F>(m, k, x);
#pragma unroll
    for (int a = 0; a <= MAX_A; ++a)
      if (a <= A) out[a] = out[a] + m.w2[a * m.H + k] * h;
  }
  return mlp_sample<MAX_A>(out, A, u, logp, value);
}

// _mlp_forward_agent for the NJ agents of one lane, by the lane's warp:
// thread t computes hidden units t, t + 32, ... of every agent into the
// warp's buffer hbuf [NJ][H + 1], then thread j * (A + 1) + a forms agent
// j's output row a, bias first, hidden units ascending, as mlp_draw does;
// returns that row (0 on the other threads). Here m.w2's rows lie H + 1
// floats apart, so that the A + 1 row threads read distinct banks.
template <int F, int NJ>
__device__ __forceinline__ float mlp_warp_rows(const Mlp& m, int A,
                                               const float (&x)[NJ][F],
                                               float* hbuf, int lane) {
  const int ld = m.H + 1;
  __syncwarp();  // the previous call's rows have read hbuf
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    for (int k = lane; k < m.H; k += 32) hbuf[j * ld + k] = mlp_hidden<F>(m, k, x[j]);
  __syncwarp();
  float o = 0.f;
  if (lane < NJ * (A + 1)) {
    const int j = lane / (A + 1), a = lane - j * (A + 1);
    const float* h = hbuf + j * ld;
    const float* w = m.w2 + a * ld;
    o = m.b2[a];
    for (int k = 0; k < m.H; ++k) o = o + w[k] * h[k];
  }
  return o;
}

// Agent j's output rows from mlp_warp_rows' threads, to every thread of the
// warp; rows past A are 0, as in mlp_draw.
template <int MAX_A>
__device__ __forceinline__ void mlp_gather_rows(float o, int A, int j,
                                                float (&out)[MAX_A + 1]) {
#pragma unroll
  for (int a = 0; a <= MAX_A; ++a)
    out[a] = a <= A ? __shfl_sync(0xffffffffu, o, j * (A + 1) + a) : 0.f;
}

// _mlp_forward_agent for one agent by a lane group of g threads (a power of
// two, 1..32, whose threads mask names): thread t forms hidden units
// k = t (mod g), bias first and features ascending, and the group passes
// them round in ascending order; thread a mod g sums output row a, bias
// first and hidden units ascending, as mlp_draw does. Every thread of the
// group gets all rows; rows past A are 0.
template <int F, int MAX_A>
__device__ __forceinline__ void mlp_group_rows(const Mlp& m, int A, const float (&x)[F], int t,
                                               int g, unsigned mask, float (&out)[MAX_A + 1]) {
  float o[MAX_A + 1];
#pragma unroll
  for (int a = 0; a <= MAX_A; ++a) o[a] = a <= A ? m.b2[a] : 0.f;
  for (int k0 = 0; k0 < m.H; k0 += g) {
    const int k = k0 + t;
    const float h = k < m.H ? mlp_hidden<F>(m, k, x) : 0.f;
    const int kn = min(g, m.H - k0);
    for (int i = 0; i < kn; ++i) {
      const float hi = __shfl_sync(mask, h, i, g);
#pragma unroll
      for (int a = 0; a <= MAX_A; ++a)
        if (a <= A && (a & (g - 1)) == t) o[a] = o[a] + m.w2[a * m.H + k0 + i] * hi;
    }
  }
#pragma unroll
  for (int a = 0; a <= MAX_A; ++a) out[a] = a <= A ? __shfl_sync(mask, o[a], a & (g - 1), g) : 0.f;
}

// mlp_draw by a lane group: mlp_group_rows, then mlp_sample on every
// thread of the group.
template <int F, int MAX_A>
__device__ __forceinline__ int mlp_group_draw(const Mlp& m, int A, const float (&x)[F], float u,
                                              int t, int g, unsigned mask, float& logp,
                                              float& value) {
  float out[MAX_A + 1];
  mlp_group_rows<F, MAX_A>(m, A, x, t, g, mask, out);
  return mlp_sample<MAX_A>(out, A, u, logp, value);
}

// mlp_value by a lane group.
template <int F, int MAX_A>
__device__ __forceinline__ float mlp_group_value(const Mlp& m, int A, const float (&x)[F], int t,
                                                 int g, unsigned mask) {
  float out[MAX_A + 1];
  mlp_group_rows<F, MAX_A>(m, A, x, t, g, mask, out);
  return out[A];
}

// _mlp_forward_agent for the NJ agents of one lane by its lane group of g
// threads (a power of two, 1..32, whose threads mask names), through the
// lane's buffer buf: hidden units [NJ][H + 1], then output rows
// [NJ][A + 1]. Thread t forms hidden units k = t (mod g) of every agent
// (as mlp_hidden: bias first, features ascending), two units at a time;
// after a sync of the group, thread t
// sums rows r = t (mod g) of the NJ * (A + 1) (agent r / (A + 1), row
// r mod (A + 1)) from the buffer, two rows at a time, each bias first and
// hidden units ascending, as mlp_draw does; after another, every thread
// reads all rows into out (rows past A are 0). Here m.w2's rows lie H + 1
// floats apart, as for mlp_warp_rows: it is this helper at g = 32 with the
// rows read back.
template <int F, int NJ, int MAX_A>
__device__ __forceinline__ void mlp_group_buf_rows(const Mlp& m, int A, const float (&x)[NJ][F],
                                                   float* buf, int t, int g, unsigned mask,
                                                   float (&out)[NJ][MAX_A + 1]) {
  const int ld = m.H + 1, nr = NJ * (A + 1);
  float* obuf = buf + NJ * ld;
  __syncwarp(mask);  // the previous call's rows have been read
  for (int k0 = t; k0 < m.H; k0 += 2 * g) {
    // Units k0 and k0 + g of every agent from one read of their weights,
    // stored after all are formed.
    float hv[2][NJ];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = min(k0 + u * g, m.H - 1);
      float w[F];
#pragma unroll
      for (int f = 0; f < F; ++f) w[f] = m.w1[k * F + f];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float h = m.b1[k];
#pragma unroll
        for (int f = 0; f < F; ++f) h = h + w[f] * x[j][f];
        hv[u][j] = fmaxf(h, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (k0 + u * g < m.H) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) buf[j * ld + k0 + u * g] = hv[u][j];
      }
  }
  __syncwarp(mask);
  for (int r = t; r < nr; r += 2 * g) {
    // Rows r and r + g (r again where r + g is past the last) side by side.
    const int r2 = r + g < nr ? r + g : r;
    const int j = r / (A + 1), a = r - j * (A + 1);
    const int j2 = r2 / (A + 1), a2 = r2 - j2 * (A + 1);
    const float *h = buf + j * ld, *w = m.w2 + a * ld;
    const float *h2 = buf + j2 * ld, *w2 = m.w2 + a2 * ld;
    float o = m.b2[a], o2 = m.b2[a2];
#pragma unroll 8
    for (int k = 0; k < m.H; ++k) {
      o = o + w[k] * h[k];
      o2 = o2 + w2[k] * h2[k];
    }
    obuf[r] = o;
    obuf[r2] = o2;
  }
  __syncwarp(mask);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int a = 0; a <= MAX_A; ++a) out[j][a] = a <= A ? obuf[j * (A + 1) + a] : 0.f;
}

// The value head alone (_bootstrap_value): output row A in mlp_draw's order.
template <int F>
__device__ __forceinline__ float mlp_value(const Mlp& m, int A, const float (&x)[F]) {
  float v = m.b2[A];
  for (int k = 0; k < m.H; ++k) v = v + m.w2[A * m.H + k] * mlp_hidden<F>(m, k, x);
  return v;
}

}  // namespace agw
