// K1 and K3: the fused firemaker_ex_ma rollout and PPO collection, for
// Hopper (sm_90a).
//
// K1 (fused_firemaker_rollout) replaces ai_safety_gridworlds_tpu/ops/
// fused_base.py::FusedMaBase._rollout_pallas_call (:432) running
// ops/fused_firemaker.py::FusedFiremaker._step (:373) with the product-form
// _spread_cum (:328): one launch advances every lane n_steps full
// multi-agent steps -- action draws and Fisher-Yates agent order
// (fused_base.py::_draw_actions_and_order), each agent's sub-step (direction
// modes through the _table_sel tables, move with blocking, quit, visits,
// stop button, workshop, fire spread and continuation, external-fire count,
// trespass, rewards), finalize (fused_base.py::_finalize_types) and
// auto-reset. With per-lane linear policies installed (set_policies), the
// actions come from fused_base.py::_policy_actions (:129) on the features of
// fused_firemaker.py::_policy_feats (:310) and fused_base.py::_pos_dir_feats
// (:262); without them they are uniform draws.
//
// K3 (fused_firemaker_collect) replaces fused_base.py::
// _rollout_collect_pallas (:635) x _collect_step (:594) x _mlp_policy_actions
// (:196) / _mlp_forward_agent (:171) x fused_firemaker.py::_step, and
// _bootstrap_value (:582): the whole PPO collection in one launch. Each step
// runs the policy MLP on every agent's features, draws its action by inverse
// CDF from the site-0 uniform, runs the step, and streams the record
// (features, action, logp, value, reward summed over the reward dims, done)
// to traj[k, row, lane]; after the loop it writes the value head on the
// final state (no auto-reset) to boot.
//
// Design. One thread per batch lane, `tile` lanes per block. The lane's
// scalars (positions, step types, counters, visits, facings, reward sums)
// live in registers; its fire board and the sub-step's source board live in
// shared memory as bytes laid out [cell][tile], so neighbouring lanes touch
// neighbouring bytes. Each thread only touches its own column, so the block
// synchronises once, after loading the static cell bits (and in K3 the MLP's
// weights, about 3.4 KB at H = 64, which every thread then reads as
// broadcasts). Every [rows, B] field is read from device memory once
// (coalesced across lanes) and written once, after all n_steps; K3's records
// are written once per step, coalesced across the lanes of a warp. The static
// board is read by index at an agent's cell: the one-hot compare-and-reduce
// of the TPU kernel was a Mosaic constraint and gives the same value. Both
// kernels share one step body, fm_step<N, MODE>, instantiated for the
// uniform, linear (K1) and MLP (K3) policy modes; the linear policy and the
// MLP come from policy.cuh, which K4 and K5 (fused_scalar.cu) share.
//
// Bound. Per sub-step each lane hashes all 289 cells (one uniform per cell
// serves both the spread and the continuation draw) and evaluates the 24-term
// product stencil at every spreadable, non-burning cell: about 289 * 50
// integer and float operations per lane per sub-step, against a few hundred
// bytes of state per lane per rollout. The kernels are bound by issue and
// shared-memory latency, not by device memory; keeping the boards out of
// device memory for all n_steps is what the design does about it. K3 adds
// about 2 * (H * F + (A + 1) * H) multiply-adds per agent-step for the MLP
// (about 15% more arithmetic than the stencil at H = 64) and writes 88 bytes
// of trajectory per lane-step; the trajectory never round-trips through
// device memory before the learner reads it.
//
// Exactness. The stencil is the product form in the reference's separable
// order: rows of equal dr in ascending dr, each row's (dc, p) terms in
// ascending order, prod = row_0 * row_1 * ..., cum = 1 - prod. Factors
// 1 - p * 0 = 1 are skipped, which leaves every product bit-identical. The
// library is built with --fmad=false so that no product and sum are
// contracted into one FMA; the kernels then do the plain PyTorch version's
// float32 arithmetic. Reward sums add each contribution to its row in the
// reference's order. The linear policy's logits are the same elementwise
// chain as the plain version's, so K1 stays bit-equal with a policy. The MLP
// accumulates bias first, features ascending, hidden units ascending, and
// sums the softmax left to right, as the plain version does; expf/logf may
// differ from PyTorch's in the last bit, which can flip a draw whose uniform
// lies within a few ULP of a cumulative sum.
#include "policy.cuh"
#include "prng.cuh"

#define FM_MAX_N 3
#define FM_MAX_D 8
#define FM_MAX_TERMS 48
#define FM_N_RV 8
#define FM_F 6      // FusedFiremaker.POLICY_FEATURES
#define FM_MAX_A 5  // legal actions amin..amax

// Reward kinds, in the order of FusedFiremaker.REWARD_KINDS.
enum {
  RV_AGENT_MOVE = 0,
  RV_AGENT_WORK = 1,
  RV_AGENT_ENERGY = 2,
  RV_SUP_MOVE = 3,
  RV_SUP_EXT_FIRE = 4,
  RV_SUP_TRESPASS = 5,
  RV_SUP_STOP = 6,
  RV_SUP_WORKSHOP = 7,
};

// Cell bits of the static board.
enum {
  CB_WALL = 1,
  CB_WORKSHOP = 2,
  CB_BUTTON = 4,
  CB_TERRITORY = 8,
  CB_EXTERNAL = 16,
  CB_SPREADABLE = 32,
  CB_FIRE = 64,  // dynamic, in an agent's tile value only
};

enum { FIRST = 0, MID = 1, LAST = 2, DEAD = 3 };
enum { R_NONE = -1, R_QUIT = 3 };
enum { A_NOOP = 0, A_LEFT = 1, A_RIGHT = 2, A_UP = 3, A_DOWN = 4, A_QUIT = 9 };
enum { DIR_UP = 2 };
enum { POL_UNIFORM = 0, POL_LINEAR = 1, POL_MLP = 2 };

// Device pointers of the packed state, in FusedFiremaker.STATE_FIELDS order.
struct FmState {
  float* fire;
  int* pos;
  int* reasons;
  int* step_types;
  int* countdown;
  int* ext_fires;
  int* visits;
  float* at_workshop;
  int* t;
  uint32_t* key;
  uint32_t* draw_ctr;
  float* stats_rewards;
  int* stats_episodes;
  int* act_dir;  // null without direction modes
  int* obs_dir;
};

// K3's outputs: the trajectory records [T, rows, B] and the bootstrap value.
struct FmTraj {
  float* feats;  // [T, n*F, B]
  int* action;   // [T, n, B], -1 for reset lanes and dead agents
  float* logp;   // [T, n, B]
  float* value;  // [T, n, B]
  float* reward; // [T, n, B]
  int* done;     // [T, n, B]
  float* boot;   // [n, B]
};

// Mirrored field for field by ops/fused_firemaker.py::_FmParams.
struct FmParams {
  FmState in;
  FmState out;
  const uint8_t* cell_bits;  // [HW]
  int B, n_steps, D, HW, W;
  int adm, odm, randomize, amin, amax;
  int sup, n_workers, extra_work_row, press_duration, max_iterations;
  int start_pos[FM_MAX_N];
  int n_terms;
  int term_off[FM_MAX_TERMS];        // dr * W + dc
  int term_row_start[FM_MAX_TERMS];  // 1 where a new dr row begins
  float term_q[FM_MAX_TERMS];        // float32(1 - float32(p))
  float cont_p;
  float rv[FM_N_RV][FM_MAX_D];
  int dir_tab[3][10][4];
  int dir_to_action[4];
  // The policy features' reciprocals, float32 as the reference rounds them:
  // 1/W, 1/max(H-1,1), 1/max(W-1,1), 1/max(max_iterations,1).
  float inv_w, inv_hm1, inv_wm1, inv_maxit;
  // Linear policy (K1), null without one: [A*F, pol_lanes], [A, pol_lanes],
  // [1, pol_lanes]; pol_lanes is 1 (shared) or B.
  const float* pol_w;
  const float* pol_b;
  const float* pol_eps;
  int pol_lanes;
  // MLP policy (K3): [H, F], [H, 1], [A+1, H], [A+1, 1]; the last output
  // row is the value head.
  const float* mlp_w1;
  const float* mlp_b1;
  const float* mlp_w2;
  const float* mlp_b2;
  int hidden;
  FmTraj traj;
};

extern "C" int fm_params_size() { return static_cast<int>(sizeof(FmParams)); }

// Register-resident small arrays are read and written through unrolled
// compare loops so that a runtime index never spills them to local memory.
template <int N>
__device__ __forceinline__ int get(const int (&a)[N], int i) {
  int v = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i) v = a[j];
  return v;
}

template <int N>
__device__ __forceinline__ void put(int (&a)[N], int i, int v) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i) a[j] = v;
}

// rew[agent] += rv[kind] * scale, for a runtime agent index.
template <int N>
__device__ __forceinline__ void add_rv(float (&rew)[N][FM_MAX_D],
                                       const FmParams& p, int agent, int kind,
                                       float scale) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j != agent) continue;
#pragma unroll
    for (int d = 0; d < FM_MAX_D; ++d)
      if (d < p.D) rew[j][d] = rew[j][d] + p.rv[kind][d] * scale;
  }
}

// _table_sel: table[action, dir], 0 for a direction outside 0..3.
__device__ __forceinline__ int table_sel(const FmParams& p, int tab, int a_cl,
                                         int dir) {
  return (dir >= 0 && dir < 4) ? p.dir_tab[tab][a_cl][dir] : 0;
}

// One lane's register state.
template <int N>
struct Lane {
  uint32_t key_hi, key_lo, ctr;
  int countdown, ext_fires, t, episodes;
  int pos[N], reasons[N], types[N], adir[N], odir[N], atw[N];
  int visits[N][5];
  float stats[N][FM_MAX_D];
};

template <int N>
__device__ __forceinline__ void load_lane(const FmParams& p, int b, Lane<N>& L,
                                          uint8_t* fire, int tile) {
  const int B = p.B;
  const bool has_dirs = p.adm != 0 || p.odm != 0;
  L.key_hi = p.in.key[b];
  L.key_lo = p.in.key[B + b];
  L.ctr = p.in.draw_ctr[b];
  L.countdown = p.in.countdown[b];
  L.ext_fires = p.in.ext_fires[b];
  L.t = p.in.t[b];
  L.episodes = p.in.stats_episodes[b];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    L.pos[j] = p.in.pos[j * B + b];
    L.reasons[j] = p.in.reasons[j * B + b];
    L.types[j] = p.in.step_types[j * B + b];
    L.atw[j] = p.in.at_workshop[j * B + b] > 0.5f;
    L.adir[j] = has_dirs ? p.in.act_dir[j * B + b] : DIR_UP;
    L.odir[j] = has_dirs ? p.in.obs_dir[j * B + b] : DIR_UP;
#pragma unroll
    for (int k = 0; k < 5; ++k) L.visits[j][k] = p.in.visits[(j * 5 + k) * B + b];
#pragma unroll
    for (int d = 0; d < FM_MAX_D; ++d)
      L.stats[j][d] = d < p.D ? p.in.stats_rewards[(j * p.D + d) * B + b] : 0.f;
  }
  for (int c = 0; c < p.HW; ++c) fire[c * tile] = p.in.fire[c * B + b] > 0.5f;
}

template <int N>
__device__ __forceinline__ void store_lane(const FmParams& p, int b,
                                           const Lane<N>& L,
                                           const uint8_t* fire, int tile) {
  const int B = p.B;
  const bool has_dirs = p.adm != 0 || p.odm != 0;
  for (int c = 0; c < p.HW; ++c) p.out.fire[c * B + b] = fire[c * tile] ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    p.out.pos[j * B + b] = L.pos[j];
    p.out.reasons[j * B + b] = L.reasons[j];
    p.out.step_types[j * B + b] = L.types[j];
    p.out.at_workshop[j * B + b] = L.atw[j] ? 1.f : 0.f;
    if (has_dirs) {
      p.out.act_dir[j * B + b] = L.adir[j];
      p.out.obs_dir[j * B + b] = L.odir[j];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) p.out.visits[(j * 5 + k) * B + b] = L.visits[j][k];
#pragma unroll
    for (int d = 0; d < FM_MAX_D; ++d)
      if (d < p.D) p.out.stats_rewards[(j * p.D + d) * B + b] = L.stats[j][d];
  }
  p.out.countdown[b] = L.countdown;
  p.out.ext_fires[b] = L.ext_fires;
  p.out.t[b] = L.t;
  p.out.key[b] = L.key_hi;
  p.out.key[B + b] = L.key_lo;
  p.out.draw_ctr[b] = L.ctr;
  p.out.stats_episodes[b] = L.episodes;
}

// _policy_feats: per agent, normalised row and column (from _pos_dir_feats),
// the workshop flag, countdown / 10, external fires / 10, t / max_iterations.
template <int N>
__device__ __forceinline__ void policy_feats(const FmParams& p, const Lane<N>& L,
                                             float (&x)[N][FM_F]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float pj = static_cast<float>(L.pos[j]);
    const float row = floorf((pj + 0.5f) * p.inv_w);
    const float col = pj - row * static_cast<float>(p.W);
    x[j][0] = row * p.inv_hm1;
    x[j][1] = col * p.inv_wm1;
    x[j][2] = L.atw[j] ? 1.f : 0.f;
    x[j][3] = static_cast<float>(L.countdown) * 0.1f;
    x[j][4] = static_cast<float>(L.ext_fires) * 0.1f;
    x[j][5] = static_cast<float>(L.t) * p.inv_maxit;
  }
}

// One full multi-agent step of one lane: auto-reset, policy features and
// action draws, agent order, every agent's sub-step, finalize. MODE selects
// the policy; with POL_MLP the step's trajectory record goes to traj[step].
template <int N, int MODE>
__device__ __forceinline__ void fm_step(const FmParams& p, Lane<N>& L,
                                        uint8_t* fire, uint8_t* src,
                                        const uint8_t* bits, int tile, int b,
                                        const agw::Mlp& mlp, int step) {
  const int HW = p.HW;
  const bool has_dirs = p.adm != 0 || p.odm != 0;
  const bool has_sup = p.sup >= 0;
  const size_t sB = static_cast<size_t>(p.B);

  // ---- auto-reset lanes whose episode ended last step
  bool over = true;
#pragma unroll
  for (int j = 0; j < N; ++j) over = over && (L.types[j] == LAST || L.types[j] == DEAD);
  if (over) {
    for (int c = 0; c < HW; ++c) fire[c * tile] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      L.pos[j] = p.start_pos[j];
      L.reasons[j] = R_NONE;
      L.types[j] = FIRST;
      L.adir[j] = DIR_UP;
      L.odir[j] = DIR_UP;
      L.atw[j] = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k) L.visits[j][k] = 0;
    }
    L.countdown = 0;
    L.ext_fires = 0;
    L.t = 0;
  }

  // ---- action draws (site 0), through the policy, and Fisher-Yates agent
  // order (site 1)
  const uint32_t ctr0 = L.ctr * static_cast<uint32_t>(2 + N);
  const int A = p.amax - p.amin + 1;
  float x[N][FM_F];
  if (MODE != POL_UNIFORM) policy_feats<N>(p, L, x);
  int actions[N], order[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr0, j));
    const float uA = u * static_cast<float>(A);
    int a = p.amin + static_cast<int>(floorf(uA));
    a = min(max(a, p.amin), p.amax);
    const bool off = over || L.reasons[j] != R_NONE;
    if (MODE == POL_LINEAR && !off) {
      const int lane = p.pol_lanes == 1 ? 0 : b;
      const int greedy =
          p.amin + agw::linear_greedy<FM_F>(p.pol_w, p.pol_b, p.pol_lanes, A, lane, x[j]);
      if (!(fmodf(uA, 1.f) < p.pol_eps[lane])) a = greedy;
    }
    if (MODE == POL_MLP) {
      float logp, value;
      a = p.amin + agw::mlp_draw<FM_F, FM_MAX_A>(mlp, A, x[j], u, logp, value);
      const size_t r = static_cast<size_t>(step) * N + j;
#pragma unroll
      for (int f = 0; f < FM_F; ++f)
        p.traj.feats[(static_cast<size_t>(step) * (N * FM_F) + j * FM_F + f) * sB + b] = x[j][f];
      p.traj.logp[r * sB + b] = logp;
      p.traj.value[r * sB + b] = value;
      p.traj.action[r * sB + b] = off ? -1 : a;
    }
    actions[j] = off ? -1 : a;
    order[j] = j;
  }
  if (p.randomize && N > 1) {
#pragma unroll
    for (int k = N - 1; k >= 1; --k) {
      float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr0 + 1u, k));
      int jj = min(max(static_cast<int>(floorf(u * static_cast<float>(k + 1))), 0), k);
      int vk = order[k], vj = get(order, jj);
      put(order, jj, vk);
      order[k] = vj;
    }
  }

  float rew[N][FM_MAX_D];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int d = 0; d < FM_MAX_D; ++d) rew[j][d] = 0.f;

#pragma unroll
  for (int slot = 0; slot < N; ++slot) {
    const int i = order[slot];
    const int a = get(actions, i);
    if (a < 0) continue;  // a non-acting sub-step changes nothing
    const bool is_quit = a == A_QUIT, is_noop = a == A_NOOP;
    const bool dead_i = get(L.reasons, i) != R_NONE;
    const bool active = !is_quit && !dead_i;
    L.t += 1;

    // --- direction modes: observation facing before the move, action
    // facing after it, both from the facings at the sub-step's start.
    const bool is_move = a >= 1 && a <= 4;
    int abs_action = a;
    if (has_dirs) {
      const int a_cl = min(max(a, 0), 9);
      const int dir_i = get(L.adir, i), odir_i = get(L.odir, i);
      if (p.odm != 0) {
        const int tab = p.odm == 1 ? ((p.adm == 1 || p.adm == 2) ? 1 : 0) : 2;
        const int nod = table_sel(p, tab, a_cl, odir_i);
        if (active) put(L.odir, i, nod);
      }
      if (p.adm != 0) {
        const int rel = table_sel(p, 1, a_cl, dir_i);
        const int abs_move = p.dir_to_action[(rel >= 1 && rel <= 3) ? rel : 0];
        abs_action = is_move ? abs_move : a;
        const int nad = table_sel(p, p.adm, a_cl, dir_i);
        if (active) put(L.adir, i, nad);
      }
    }

    // --- move, blocked by walls and other agents
    const int pos_i = get(L.pos, i);
    const int delta = (abs_action == A_LEFT ? -1 : 0) + (abs_action == A_RIGHT ? 1 : 0) +
                      (abs_action == A_UP ? -p.W : 0) + (abs_action == A_DOWN ? p.W : 0);
    const int cand = pos_i + delta;
    bool occ = false;
#pragma unroll
    for (int j = 0; j < N; ++j) occ = occ || (j != i && L.pos[j] == cand);
    const bool wall_at = cand >= 0 && cand < HW && (bits[cand] & CB_WALL);
    if (active && is_move && !wall_at && !occ) put(L.pos, i, cand);
    if (is_quit && !dead_i) put(L.reasons, i, R_QUIT);
    if (active && !is_noop)
      add_rv<N>(rew, p, i, (has_sup && i == p.sup) ? RV_SUP_MOVE : RV_AGENT_MOVE, 1.f);

    // --- every agent's tile value at its post-move cell (+ fire bit)
    int v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int pj = L.pos[j];
      v[j] = (pj >= 0 && pj < HW)
                 ? (bits[pj] & (CB_FIRE - 1 - CB_SPREADABLE)) | (fire[pj * tile] ? CB_FIRE : 0)
                 : 0;
    }
    const int v_at = get(v, i);
    if (active) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j != i) continue;
        L.visits[j][0] += (v_at & CB_EXTERNAL) != 0;
        L.visits[j][1] += (v_at & CB_TERRITORY) != 0;
        L.visits[j][2] += (v_at & CB_WORKSHOP) != 0;
        L.visits[j][3] += (v_at & CB_FIRE) != 0;
        L.visits[j][4] += (v_at & CB_BUTTON) != 0;
      }
    }

    // --- stop button
    bool any_btn = false;
#pragma unroll
    for (int j = 0; j < N; ++j) any_btn = any_btn || (v[j] & CB_BUTTON);
    int cd2 = any_btn ? 2 + p.press_duration : L.countdown;
    if (has_sup && (get(v, p.sup) & CB_BUTTON) && L.ext_fires == 0)
      add_rv<N>(rew, p, p.sup, RV_SUP_STOP, 1.f);
    cd2 = max(0, cd2 - 1);

    // --- workshop
    int atw2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool at_w = v[j] & CB_WORKSHOP;
      atw2[j] = at_w;
      bool working = at_w;
      if (has_sup && j == p.sup) {
        if (at_w && L.ext_fires == 0) add_rv<N>(rew, p, j, RV_SUP_WORKSHOP, 1.f);
        working = at_w && L.ext_fires != 0;
      }
      if (working && cd2 == 0) {
        add_rv<N>(rew, p, 0, RV_AGENT_WORK, 1.f);
        if (N > 1 && p.extra_work_row) add_rv<N>(rew, p, 1, RV_AGENT_WORK, 1.f);
        add_rv<N>(rew, p, j, RV_AGENT_ENERGY, 1.f);
      }
    }

    // --- fire: sources are the burning cells without an agent, plus the
    // cells of workers at an active workshop.
    for (int c = 0; c < HW; ++c) src[c * tile] = fire[c * tile];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (L.pos[j] >= 0 && L.pos[j] < HW) src[L.pos[j] * tile] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < p.n_workers && atw2[j] && cd2 == 0) src[L.pos[j] * tile] = 1;

    const uint32_t ctr_fire = ctr0 + 2u + static_cast<uint32_t>(slot);
    int ext2 = 0;
    for (int c = 0; c < HW; ++c) {
      const int cb = bits[c];
      bool on_agent = false;
#pragma unroll
      for (int j = 0; j < N; ++j) on_agent = on_agent || L.pos[j] == c;
      const bool burning = fire[c * tile] && !on_agent;
      float cum = 0.f;
      if (!burning && (cb & CB_SPREADABLE)) {
        float prod = 1.f, y = 1.f;
        for (int k = 0; k < p.n_terms; ++k) {
          if (k > 0 && p.term_row_start[k]) {
            prod = prod * y;
            y = 1.f;
          }
          int s = c - p.term_off[k];
          s += s < 0 ? HW : (s >= HW ? -HW : 0);
          if (src[s * tile]) y = y * p.term_q[k];
        }
        prod = prod * y;
        cum = 1.f - prod;
      }
      const float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr_fire, c));
      const bool f2 = burning ? (u < p.cont_p) : (u < cum);
      fire[c * tile] = f2;
      ext2 += f2 && !(cb & CB_TERRITORY);
    }
    add_rv<N>(rew, p, has_sup ? p.sup : 0, RV_SUP_EXT_FIRE, static_cast<float>(ext2));

    // --- territory
    if (has_sup) {
      const int ps = get(L.pos, p.sup);
      const bool on_terr = ps >= 0 && ps < HW && (bits[ps] & CB_TERRITORY);
      if (on_terr && ext2 == 0) add_rv<N>(rew, p, p.sup, RV_SUP_TRESPASS, 1.f);
    }

    L.countdown = cd2;
    L.ext_fires = ext2;
#pragma unroll
    for (int j = 0; j < N; ++j) L.atw[j] = atw2[j];
  }

  // ---- finalize
  bool all_over = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool game_over = L.t >= p.max_iterations || L.reasons[j] != R_NONE;
    const int nt = game_over ? ((L.types[j] == MID || L.types[j] == FIRST) ? LAST : DEAD) : MID;
    L.types[j] = over ? FIRST : nt;
    all_over = all_over && game_over;
  }
  L.episodes += all_over && !over;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int d = 0; d < FM_MAX_D; ++d) L.stats[j][d] = L.stats[j][d] + rew[j][d];
  L.ctr += 1u;

  if (MODE == POL_MLP) {
    // Each agent's reward summed over the reward dims, in order; done flags.
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float r = rew[j][0];
#pragma unroll
      for (int d = 1; d < FM_MAX_D; ++d)
        if (d < p.D) r = r + rew[j][d];
      const size_t row = static_cast<size_t>(step) * N + j;
      p.traj.reward[row * sB + b] = r;
      p.traj.done[row * sB + b] = L.types[j] == LAST || L.types[j] == DEAD;
    }
  }
}

// K1: n_steps steps of every lane, uniform or linear-policy actions.
template <int N, int MODE>
__global__ void __launch_bounds__(256)
    fm_rollout_kernel(const __grid_constant__ FmParams p) {
  extern __shared__ uint8_t smem[];
  const int tile = blockDim.x;
  const int tx = threadIdx.x;
  const int b = blockIdx.x * tile + tx;
  const int HW = p.HW;
  uint8_t* fire = smem + tx;             // column: fire[c * tile]
  uint8_t* src = smem + HW * tile + tx;  // column: src[c * tile]
  uint8_t* bits = smem + 2 * HW * tile;  // [HW], shared by the block
  for (int c = tx; c < HW; c += tile) bits[c] = p.cell_bits[c];
  __syncthreads();
  if (b >= p.B) return;

  Lane<N> L;
  load_lane<N>(p, b, L, fire, tile);
  const agw::Mlp no_mlp{nullptr, nullptr, nullptr, nullptr, 0};
  for (int step = 0; step < p.n_steps; ++step)
    fm_step<N, MODE>(p, L, fire, src, bits, tile, b, no_mlp, step);
  store_lane<N>(p, b, L, fire, tile);
}

// K3: n_steps MLP-policy steps of every lane with the trajectory streamed
// out, then the bootstrap value of the final state.
template <int N>
__global__ void __launch_bounds__(256)
    fm_collect_kernel(const __grid_constant__ FmParams p) {
  extern __shared__ float smem_f[];
  const int tile = blockDim.x;
  const int tx = threadIdx.x;
  const int b = blockIdx.x * tile + tx;
  const int HW = p.HW, H = p.hidden, A = p.amax - p.amin + 1;
  const int n_w1 = H * FM_F, n_w2 = (A + 1) * H;
  float* w = smem_f;  // w1 [H*F], b1 [H], w2 [(A+1)*H], b2 [A+1]
  for (int i = tx; i < n_w1; i += tile) w[i] = p.mlp_w1[i];
  for (int i = tx; i < H; i += tile) w[n_w1 + i] = p.mlp_b1[i];
  for (int i = tx; i < n_w2; i += tile) w[n_w1 + H + i] = p.mlp_w2[i];
  for (int i = tx; i <= A; i += tile) w[n_w1 + H + n_w2 + i] = p.mlp_b2[i];
  const agw::Mlp mlp{w, w + n_w1, w + n_w1 + H, w + n_w1 + H + n_w2, H};
  uint8_t* boards = reinterpret_cast<uint8_t*>(w + n_w1 + H + n_w2 + A + 1);
  uint8_t* fire = boards + tx;
  uint8_t* src = boards + HW * tile + tx;
  uint8_t* bits = boards + 2 * HW * tile;
  for (int c = tx; c < HW; c += tile) bits[c] = p.cell_bits[c];
  __syncthreads();
  if (b >= p.B) return;

  Lane<N> L;
  load_lane<N>(p, b, L, fire, tile);
  for (int step = 0; step < p.n_steps; ++step)
    fm_step<N, POL_MLP>(p, L, fire, src, bits, tile, b, mlp, step);
  float x[N][FM_F];
  policy_feats<N>(p, L, x);
#pragma unroll
  for (int j = 0; j < N; ++j) p.traj.boot[j * p.B + b] = agw::mlp_value<FM_F>(mlp, A, x[j]);
  store_lane<N>(p, b, L, fire, tile);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, const FmParams& p, int tile,
                          size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + tile - 1) / tile;
  kernel<<<blocks, tile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_rollout(const FmParams& p, int tile, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(p.HW) * tile + p.HW;
  return p.pol_w ? launch(fm_rollout_kernel<N, POL_LINEAR>, p, tile, smem, s)
                 : launch(fm_rollout_kernel<N, POL_UNIFORM>, p, tile, smem, s);
}

template <int N>
static cudaError_t launch_collect(const FmParams& p, int tile, cudaStream_t s) {
  const size_t A = p.amax - p.amin + 1, H = p.hidden;
  const size_t n_w = H * FM_F + H + (A + 1) * H + (A + 1);
  const size_t smem = 4 * n_w + 2 * static_cast<size_t>(p.HW) * tile + p.HW;
  return launch(fm_collect_kernel<N>, p, tile, smem, s);
}

extern "C" int fused_firemaker_rollout(const FmParams* p, int n_agents,
                                       int tile, void* stream) {
  if (p->n_steps <= 0 || p->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_agents) {
    case 1: return static_cast<int>(launch_rollout<1>(*p, tile, s));
    case 2: return static_cast<int>(launch_rollout<2>(*p, tile, s));
    case 3: return static_cast<int>(launch_rollout<3>(*p, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_firemaker_collect(const FmParams* p, int n_agents,
                                       int tile, void* stream) {
  if (p->B <= 0) return 0;
  if (p->amax - p->amin + 1 > FM_MAX_A || p->hidden < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_agents) {
    case 1: return static_cast<int>(launch_collect<1>(*p, tile, s));
    case 2: return static_cast<int>(launch_collect<2>(*p, tile, s));
    case 3: return static_cast<int>(launch_collect<3>(*p, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
