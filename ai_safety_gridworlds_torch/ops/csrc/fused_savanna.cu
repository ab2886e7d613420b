// K8 and K9: the fused aintelope_savanna rollout and PPO collection, for
// Hopper (sm_90a).
//
// K8 (fused_savanna_rollout) replaces ai_safety_gridworlds_tpu/ops/
// fused_base.py::FusedMaBase._rollout_pallas_call (:432, pallas_call :491)
// running ops/fused_savanna.py::FusedSavanna._step (:702), with
// _redraw_layout (:630), _lut_select (:86), _policy_feats (:611) and
// fused_base.py::_pool_select (:360): one launch advances every lane n_steps
// full multi-agent steps -- the auto-reset (with the per-episode map redraw
// under exact_reset, or into the layout of the new episode with a layout
// pool), action draws and Fisher-Yates agent order
// (fused_base.py::_draw_actions_and_order), each agent's sub-step in the
// permuted order (relative direction updates, the move with agents
// blocking, quit, satiation and thirst/hunger death, drink, small drink,
// food and small food, gold and silver log rewards, gap visits,
// homeostasis, safety distances, the water penalty, the predator random
// walk, the sustainability drapes) and finalize
// (fused_base.py::_finalize_types). With per-lane linear policies installed
// (set_policies) the actions come from fused_base.py::_policy_actions
// (:129); without them they are uniform draws.
//
// K9 (fused_savanna_collect) replaces fused_base.py::_rollout_collect_pallas
// (:635, pallas_call :718) x _collect_step (:594) x _mlp_policy_actions
// (:196) / _mlp_forward_agent (:171) over the same step, and
// _bootstrap_value (:582): the whole PPO collection in one launch, streaming
// the record (features, action, logp, value, reward summed over the reward
// dims, done) to traj[k, row, lane] and the value head of the final state to
// boot.
//
// Design. One thread per lane, `tile` lanes per block. The lane's scalar
// fields -- positions, reasons, step types, facings, step counts,
// satiations, visits, safety distances, availabilities, t, key, draw
// counter, episode counter, reward sums -- live in registers for the whole
// call, read once and written once. The [HW, B] boards stay in device
// memory, column b of them: the lane's copy of the predator curtain, of the
// resource curtains under sustainability and, under exact_reset, of the
// wall and code/distance boards is made into the output state at the start
// and updated there in place; with a layout pool the wall and code boards
// are read from the pool's statics. The per-cell random words (predator
// moves, drape scores, the redraw's scores) are recomputed from the PRF
// wherever a pass needs them, so no per-cell scratch array is kept:
//
// * The redraw takes "the smallest score above the previous pick" T times;
//   the scores ((bits >> (ib + 3)) << ib) | cell are distinct within a lane,
//   so this equals JAX's chain of T masked minima.
// * The predator walk marks each predator that draws a move with 10 + its
//   direction on the board, then runs the four direction passes in order.
//   Each pass first marks its movers (20) against the board as it stood
//   before the pass -- a mark still reads as occupied -- and then moves them
//   all, so no predator moves twice or follows a vacated cell. A predator's
//   original cell carries its move and direction, as in JAX's move_mask.
// * A drape's removal or spawn finds the cutoff tau as the count-th
//   smallest candidate score by the same "smallest above the previous"
//   scan, stopping at the first invalid pick (every later one is invalid
//   too), then updates the curtain once: picked == {score <= tau}.
//
// K8 and K9 share one step body, sv_step<N, MODE>, instantiated for N = 1..4
// agents and the uniform, linear (K8) and MLP (K9) policy modes; the feature
// gates are runtime flags of the parameter block. The linear policy and the
// MLP come from policy.cuh, the PRF from prng.cuh.
//
// Bound. A lane-step is a few hundred operations for the draws and each
// acting sub-step, plus per-cell passes where a feature needs them: HW
// hashes per predator pass and per drape pick, a few board passes per
// walk, and T x HW hashes per redraw. The boards are read and written
// through L1/L2 at 4 bytes a cell. The kernels are bound by each thread's
// serial chain of dependent operations, not by device memory.
//
// Exactness. The kernels add each reward term to its row in the plain
// version's order, only where its condition holds (the plain version's
// masked add gives the same bits), skip the terms whose vector is all zero,
// and take every float operation of the plain step one by one; the library
// is built with --fmad=false. Regrowth computes expf(e * logf(av + 1)), the
// gold and silver factor (logf(v + 2) - logf(v + 1)) / logf(base) as a
// division; K8 equals the plain version on the card where both reach the
// same expf/logf.
#include "policy.cuh"
#include "prng.cuh"

#define SV_MAX_N 4
#define SV_MAX_D 12
#define SV_MAX_POOL 8
#define SV_MAX_T 256
#define SV_F 10     // FusedSavanna.POLICY_FEATURES
#define SV_MAX_A 5  // legal actions amin..amax

// Reward kinds, in the order of fused_savanna.py::REWARD_KINDS.
enum {
  RV_MOVE = 0,
  RV_GAP,
  RV_DRINK,
  RV_FOOD,
  RV_SMALL_DRINK,
  RV_SMALL_FOOD,
  RV_NON_DRINK,
  RV_NON_FOOD,
  RV_GOLD,
  RV_SILVER,
  RV_DANGER,
  RV_PREDATOR,
  RV_THIRST,
  RV_COOP,
  RV_SMALL_COOP,
  RV_DRINK_DEF,
  RV_FOOD_DEF,
  RV_DRINK_OVER,
  RV_FOOD_OVER,
  SV_N_RV
};

// Tile codes of the combined board (fused_savanna.py::TILE_CODES).
enum { T_GAP = 0, T_WALL = 1, T_WATER = 2, T_GOLD = 3, T_SILVER = 4 };
// Resources, in fused_savanna.py::RESOURCES order.
enum { R_DRINK = 0, R_FOOD = 1, R_SMALL_DRINK = 2, R_SMALL_FOOD = 3 };
// Placement kinds of the redraw (fused_savanna.py::_SPEC_CODES); an agent
// j is SPEC_AGENT + j.
enum {
  SPEC_PREDATOR = 1,
  SPEC_WATER = 2,
  SPEC_GOLD = 3,
  SPEC_SILVER = 4,
  SPEC_RES = 5,  // + resource index
  SPEC_WALL = 9,
  SPEC_AGENT = 16
};
enum { FIRST = 0, MID = 1, LAST = 2, DEAD = 3 };
enum { R_NONE = -1, R_TERMINATED = 0, R_QUIT = 3 };
enum { A_NOOP = 0, A_QUIT = 9 };
enum { DIR_UP = 2 };
enum { POL_UNIFORM = 0, POL_LINEAR = 1, POL_MLP = 2 };

#define OFF_PLAYER (1 << 29)
#define SENT (1 << 30)

// Device pointers of the packed state (fused_savanna.py::_SvState); a field
// the mode lacks is null.
struct SvState {
  int* pos;
  float* predator;
  int* reasons;
  int* step_types;
  int* act_dir;
  int* obs_dir;
  int* step_count;
  float* drink_sat;
  float* food_sat;
  int* visits;
  int* safety;
  int* safety2;
  int* t;
  uint32_t* key;
  uint32_t* draw_ctr;
  float* stats_rewards;
  int* stats_episodes;
  int* ep_idx;
  float* wall;
  float* sboard;
  float* res[4];
  float* avail[4];
};

// K9's outputs: the trajectory records [T, rows, B] and the bootstrap value.
struct SvTraj {
  float* feats;   // [T, n*F, B]
  int* action;    // [T, n, B], -1 for reset lanes and dead agents
  float* logp;    // [T, n, B]
  float* value;   // [T, n, B]
  float* reward;  // [T, n, B]
  int* done;      // [T, n, B]
  float* boot;    // [n, B]
};

// Mirrored field for field by ops/fused_savanna.py::_SvParams.
struct SvParams {
  SvState in;
  SvState out;
  // Layout k's statics, [rows, B]: wall, sboard, pos0 (int), predator0,
  // the resource curtains res0 and usable_half [1, B]. Under exact_reset
  // only usable_half[0] is set (sustainability).
  const float* wall[SV_MAX_POOL];
  const float* sboard[SV_MAX_POOL];
  const int* pos0[SV_MAX_POOL];
  const float* predator0[SV_MAX_POOL];
  const float* res0[SV_MAX_POOL][4];
  const float* usable_half[SV_MAX_POOL];
  int B, n_steps, D, HW, H, W, amin, amax, max_iterations, pool, randomize;
  int exact_reset, sustain, n_sites, sites_per_slot, redraw_site, idx_bits, T;
  int has_water, has_predators, has_gold, has_silver;
  int drink_flags_on, food_flags_on, penalise, proportional, thirst_death;
  float sat0_drink, sat0_food, drink_def_rate, food_def_rate;
  float drink_def_limit, food_def_limit, drink_def_thresh, food_def_thresh;
  float drink_over_thresh, food_over_thresh;
  float pred_move_p, regrowth_exponent, gold_log_base, silver_log_base;
  // Per resource (RESOURCES order): enabled, the index of its draw site
  // among the enabled resources, the availability metric flag, the pick
  // bound max(k_rem, k_spawn), the oversatiation-limit flag, the tile code,
  // the visit column and the reward kinds (coop_kind -1 for none).
  int res_on[4], res_site[4], res_metric[4], res_k[4], res_limit_on[4];
  int res_code[4], res_visit_col[4], res_kind[4], res_coop_kind[4];
  float res_rate[4], res_growth[4], res_cond[4], res_amount[4];
  float res_sat_amt[4], res_limit[4];
  float rv[SV_N_RV][SV_MAX_D];
  int rv_on[SV_N_RV];
  int rel_dir[10][4];
  int dir_to_action[4];
  int delta[10];  // flat cell offset per action id
  unsigned char spec[SV_MAX_T];
  // The policy features' reciprocals, float32 as the reference rounds them:
  // 1/W, 1/max(H-1,1), 1/max(W-1,1).
  float inv_w, inv_hm1, inv_wm1;
  // Linear policy (K8), null without one: [A*F, pol_lanes], [A, pol_lanes],
  // [1, pol_lanes]; pol_lanes is 1 (shared) or B.
  const float* pol_w;
  const float* pol_b;
  const float* pol_eps;
  int pol_lanes;
  // MLP policy (K9): [H, F], [H, 1], [A+1, H], [A+1, 1].
  const float* mlp_w1;
  const float* mlp_b1;
  const float* mlp_w2;
  const float* mlp_b2;
  int hidden;
  SvTraj traj;
};

extern "C" int sv_params_size() { return static_cast<int>(sizeof(SvParams)); }

template <int N, typename T>
__device__ __forceinline__ T get(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (j == i) v = a[j];
  return v;
}

template <int N, typename T>
__device__ __forceinline__ void put(T (&a)[N], int i, T v) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i) a[j] = v;
}

// The agents' cells, padded with -1, passed by value to the per-cell passes.
struct Pos4 {
  int c[SV_MAX_N];
};

template <int N>
__device__ __forceinline__ Pos4 pos4(const int (&pos)[N]) {
  Pos4 q;
#pragma unroll
  for (int j = 0; j < SV_MAX_N; ++j) q.c[j] = j < N ? pos[j] : -1;
  return q;
}

__device__ __forceinline__ bool on_player(const Pos4& q, int c) {
  return q.c[0] == c || q.c[1] == c || q.c[2] == c || q.c[3] == c;
}

// One lane's register state.
template <int N>
struct SvLane {
  uint32_t key_hi, key_lo, ctr;
  int t, episodes, ep_idx;
  float avail[4];
  int pos[N], reasons[N], types[N], adir[N], odir[N], count[N], safety[N], safety2[N];
  float dsat[N], fsat[N];
  int visits[N][7];
  float stats[N][SV_MAX_D];
};

// rew[agent] += rv[kind], for a runtime agent index; terms whose vector is
// all zero are left out, as in the plain version.
template <int N>
__device__ __forceinline__ void add_rv(float (&rew)[N][SV_MAX_D], const SvParams& p, int agent,
                                       int kind) {
  if (!p.rv_on[kind]) return;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j != agent) continue;
#pragma unroll
    for (int d = 0; d < SV_MAX_D; ++d)
      if (d < p.D) rew[j][d] = rew[j][d] + p.rv[kind][d];
  }
}

// rew[agent] += rv[kind] * scale (proportional homeostasis, gold, silver).
template <int N>
__device__ __forceinline__ void add_rv_scaled(float (&rew)[N][SV_MAX_D], const SvParams& p,
                                              int agent, int kind, float scale) {
  if (!p.rv_on[kind]) return;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j != agent) continue;
#pragma unroll
    for (int d = 0; d < SV_MAX_D; ++d)
      if (d < p.D) rew[j][d] = rew[j][d] + p.rv[kind][d] * scale;
  }
}

// The _REL_DIR table read as the plain version's select chain: a direction
// outside 0..3 gives 0.
__device__ __forceinline__ int rel_dir(const SvParams& p, int a_cl, int dir) {
  return (dir >= 0 && dir < 4) ? p.rel_dir[a_cl][dir] : 0;
}

__device__ __forceinline__ bool is_border(const SvParams& p, int c) {
  const int r = c / p.W, col = c - (c / p.W) * p.W;
  return r == 0 || r == p.H - 1 || col == 0 || col == p.W - 1;
}

template <int N>
__device__ __forceinline__ void load_lane(const SvParams& p, int b, SvLane<N>& L) {
  const size_t B = static_cast<size_t>(p.B);
  L.key_hi = p.in.key[b];
  L.key_lo = p.in.key[B + b];
  L.ctr = p.in.draw_ctr[b];
  L.t = p.in.t[b];
  L.episodes = p.in.stats_episodes[b];
  L.ep_idx = p.pool > 1 ? p.in.ep_idx[b] : 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) L.avail[r] = (p.sustain && p.res_on[r]) ? p.in.avail[r][b] : 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const size_t row = j * B + b;
    L.pos[j] = p.in.pos[row];
    L.reasons[j] = p.in.reasons[row];
    L.types[j] = p.in.step_types[row];
    L.adir[j] = p.in.act_dir[row];
    L.odir[j] = p.in.obs_dir[row];
    L.count[j] = p.in.step_count[row];
    L.safety[j] = p.in.safety[row];
    L.safety2[j] = p.in.safety2[row];
    L.dsat[j] = p.in.drink_sat[row];
    L.fsat[j] = p.in.food_sat[row];
#pragma unroll
    for (int k = 0; k < 7; ++k) L.visits[j][k] = p.in.visits[(j * 7 + k) * B + b];
#pragma unroll
    for (int d = 0; d < SV_MAX_D; ++d)
      L.stats[j][d] = d < p.D ? p.in.stats_rewards[(j * p.D + d) * B + b] : 0.f;
  }
  // The lane's boards go to the output state, where the steps update them.
  for (int c = 0; c < p.HW; ++c) {
    const size_t cb = c * B + b;
    p.out.predator[cb] = p.in.predator[cb];
    if (p.exact_reset) {
      p.out.wall[cb] = p.in.wall[cb];
      p.out.sboard[cb] = p.in.sboard[cb];
    }
    if (p.sustain)
      for (int r = 0; r < 4; ++r)
        if (p.res_on[r]) p.out.res[r][cb] = p.in.res[r][cb];
  }
}

template <int N>
__device__ __forceinline__ void store_lane(const SvParams& p, int b, const SvLane<N>& L) {
  const size_t B = static_cast<size_t>(p.B);
  p.out.key[b] = L.key_hi;
  p.out.key[B + b] = L.key_lo;
  p.out.draw_ctr[b] = L.ctr;
  p.out.t[b] = L.t;
  p.out.stats_episodes[b] = L.episodes;
  if (p.pool > 1) p.out.ep_idx[b] = L.ep_idx;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (p.sustain && p.res_on[r]) p.out.avail[r][b] = L.avail[r];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const size_t row = j * B + b;
    p.out.pos[row] = L.pos[j];
    p.out.reasons[row] = L.reasons[j];
    p.out.step_types[row] = L.types[j];
    p.out.act_dir[row] = L.adir[j];
    p.out.obs_dir[row] = L.odir[j];
    p.out.step_count[row] = L.count[j];
    p.out.safety[row] = L.safety[j];
    p.out.safety2[row] = L.safety2[j];
    p.out.drink_sat[row] = L.dsat[j];
    p.out.food_sat[row] = L.fsat[j];
#pragma unroll
    for (int k = 0; k < 7; ++k) p.out.visits[(j * 7 + k) * B + b] = L.visits[j][k];
#pragma unroll
    for (int d = 0; d < SV_MAX_D; ++d)
      if (d < p.D) p.out.stats_rewards[(j * p.D + d) * B + b] = L.stats[j][d];
  }
}

// _policy_feats: per agent, normalised row and column (from _pos_dir_feats),
// drink and food satiation * 0.1f, water and predator safety * 0.1f, and the
// observation-direction one-hot.
template <int N>
__device__ __forceinline__ void policy_feats(const SvParams& p, const SvLane<N>& L,
                                             float (&x)[N][SV_F]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float pj = static_cast<float>(L.pos[j]);
    const float row = floorf((pj + 0.5f) * p.inv_w);
    const float col = pj - row * static_cast<float>(p.W);
    x[j][0] = row * p.inv_hm1;
    x[j][1] = col * p.inv_wm1;
    x[j][2] = L.dsat[j] * 0.1f;
    x[j][3] = L.fsat[j] * 0.1f;
    x[j][4] = static_cast<float>(L.safety[j]) * 0.1f;
    x[j][5] = static_cast<float>(L.safety2[j]) * 0.1f;
#pragma unroll
    for (int d = 0; d < 4; ++d) x[j][6 + d] = L.odir[j] == d ? 1.f : 0.f;
  }
}

// _redraw_layout for one resetting lane: a fresh uniformly shuffled map
// from the redraw site's words, written to the lane's boards in the output
// state; the agents' starts go to L.pos.
__device__ __noinline__ Pos4 redraw(const SvParams& p, int b, uint32_t key_hi, uint32_t key_lo,
                                    uint32_t ctr0) {
  Pos4 starts;
  const size_t B = static_cast<size_t>(p.B);
  const int ib = p.idx_bits;
  const int idx_mask = (1 << ib) - 1;
  const uint32_t site = ctr0 + static_cast<uint32_t>(p.redraw_site);
  float* wall = p.out.wall;
  float* sboard = p.out.sboard;
  float* pred = p.out.predator;
  for (int c = 0; c < p.HW; ++c) {
    const size_t cb = c * B + b;
    wall[cb] = is_border(p, c) ? 1.f : 0.f;
    sboard[cb] = 16.f * 99.f;  // code 0, water distance 99
    pred[cb] = 0.f;
    if (p.sustain)
      for (int r = 0; r < 4; ++r)
        if (p.res_on[r]) p.out.res[r][cb] = 0.f;
  }
  int prev = -1;
  for (int k = 0; k < p.T; ++k) {
    int m = SENT;
    for (int c = 0; c < p.HW; ++c) {
      if (is_border(p, c)) continue;
      const uint32_t bits = agw::hash_u32(key_hi, key_lo, site, static_cast<uint32_t>(c));
      const int s = static_cast<int>(((bits >> (ib + 3)) << ib) | static_cast<uint32_t>(c));
      if (s > prev && s < m) m = s;
    }
    prev = m;
    const int pc = m & idx_mask;
    const size_t pb = pc * B + b;
    const int kind = p.spec[k];
    if (kind >= SPEC_AGENT) {
      starts.c[(kind - SPEC_AGENT) & (SV_MAX_N - 1)] = pc;
    } else if (kind == SPEC_PREDATOR) {
      pred[pb] = 1.f;
    } else if (kind == SPEC_WALL) {
      wall[pb] = 1.f;
    } else if (kind == SPEC_WATER) {
      // The water distance min-updates every cell; the codes stay.
      const int pr = pc / p.W, pcol = pc - (pc / p.W) * p.W;
      for (int c = 0; c < p.HW; ++c) {
        const size_t cb = c * B + b;
        const int v = static_cast<int>(sboard[cb]);
        const int r = c / p.W, col = c - (c / p.W) * p.W;
        const int d = min(v >> 4, abs(r - pr) + abs(col - pcol));
        sboard[cb] = static_cast<float>((v & 15) + 16 * d);
      }
      sboard[pb] = sboard[pb] + static_cast<float>(T_WATER);
    } else if (kind >= SPEC_RES && kind < SPEC_RES + 4 && p.sustain && p.res_on[kind - SPEC_RES]) {
      p.out.res[kind - SPEC_RES][pb] = 1.f;
    } else if (kind >= SPEC_RES && kind < SPEC_RES + 4) {
      sboard[pb] = sboard[pb] + static_cast<float>(p.res_code[kind - SPEC_RES]);
    } else {  // gold, silver
      sboard[pb] = sboard[pb] + static_cast<float>(kind == SPEC_GOLD ? T_GOLD : T_SILVER);
    }
  }
  return starts;
}

// Resource r on the acting agent's tile: the visit counts; with
// sustainability a positive availability pays the reward, feeds the
// satiation (penalise_oversatiation), clamps it at the oversatiation limit
// and is drawn down by the extraction rate; without it the availability is
// the amount flag. The other agents get the cooperation reward.
template <int N>
__device__ __forceinline__ void consume(const SvParams& p, SvLane<N>& L,
                                        float (&rew)[N][SV_MAX_D], int i, int r, bool on_tile,
                                        float (&sat)[N]) {
  if (!on_tile) return;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i) L.visits[j][p.res_visit_col[r]] += 1;
  if (p.sustain) {
    const float av = L.avail[r];
    if (av > 0.f) {
      add_rv<N>(rew, p, i, p.res_kind[r]);
      if (p.penalise) put(sat, i, get(sat, i) + fminf(av, p.res_rate[r]));
      if (p.res_limit_on[r] && get(sat, i) > 0.f) put(sat, i, fminf(get(sat, i), p.res_limit[r]));
      L.avail[r] = fmaxf(0.f, av - p.res_rate[r]);
    }
  } else {
    add_rv<N>(rew, p, i, p.res_kind[r]);
    if (p.penalise) put(sat, i, get(sat, i) + p.res_sat_amt[r]);
    if (p.res_limit_on[r] && get(sat, i) > 0.f) put(sat, i, fminf(get(sat, i), p.res_limit[r]));
  }
  if (p.res_coop_kind[r] >= 0) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j != i) add_rv<N>(rew, p, j, p.res_coop_kind[r]);
  }
}

// Homeostasis of one satiation: the deficiency term, then the
// oversatiation term, as counts or proportional to the satiation.
template <int N>
__device__ __forceinline__ void homeo(const SvParams& p, float (&rew)[N][SV_MAX_D], int i,
                                      float sat_i, float def_thresh, float over_thresh,
                                      int def_kind, int over_kind) {
  const bool deficient = sat_i < def_thresh;
  if (deficient) {
    if (p.proportional) add_rv_scaled<N>(rew, p, i, def_kind, -sat_i);
    else add_rv<N>(rew, p, i, def_kind);
  }
  if (p.penalise && sat_i > over_thresh && !deficient) {
    if (p.proportional) add_rv_scaled<N>(rew, p, i, over_kind, sat_i);
    else add_rv<N>(rew, p, i, over_kind);
  }
}

// The predator walk of one acting sub-step at the round's last agent.
__device__ __noinline__ void predator_walk(const SvParams& p, int b, const float* wall,
                                           uint32_t key_hi, uint32_t key_lo, uint32_t site,
                                           Pos4 q) {
  const size_t B = static_cast<size_t>(p.B);
  float* pred = p.out.predator;
  // Each predator that draws a move (off the agents' cells) is marked
  // 10 + its direction.
  for (int c = 0; c < p.HW; ++c) {
    const size_t cb = c * B + b;
    if (!(pred[cb] > 0.5f) || on_player(q, c)) continue;
    const uint32_t bits = agw::hash_u32(key_hi, key_lo, site, static_cast<uint32_t>(c));
    if (agw::uniform01(bits) < p.pred_move_p)
      pred[cb] = 10.f + static_cast<float>(1 + static_cast<int>(bits & 3u));
  }
  for (int d = 1; d <= 4; ++d) {
    const int s = p.delta[d];
    const float mark = 10.f + static_cast<float>(d);
    // Movers of this pass, against the board as it stood before it.
    for (int c = 0; c < p.HW; ++c) {
      const size_t cb = c * B + b;
      if (pred[cb] != mark) continue;
      int tc = c + s;
      if (tc < 0) tc += p.HW;
      if (tc >= p.HW) tc -= p.HW;
      const size_t tb = tc * B + b;
      if (pred[tb] < 0.5f && wall[tb] < 0.5f) pred[cb] = 20.f;
    }
    for (int c = 0; c < p.HW; ++c) {
      const size_t cb = c * B + b;
      if (pred[cb] != 20.f) continue;
      int tc = c + s;
      if (tc < 0) tc += p.HW;
      if (tc >= p.HW) tc -= p.HW;
      pred[cb] = 0.f;
      pred[tc * B + b] = 1.f;
    }
  }
  for (int c = 0; c < p.HW; ++c) {
    const size_t cb = c * B + b;
    if (pred[cb] > 0.5f) pred[cb] = 1.f;
  }
}

// A drape candidate's score: removal takes curtain cells (players' cells
// last), spawn takes free cells off the walls and the players.
__device__ __forceinline__ int drape_score(const Pos4& q, bool removing, float cur, float wall,
                                           uint32_t bits, int c) {
  const int base = static_cast<int>(((bits >> 12) << 9) | static_cast<uint32_t>(c));
  const bool player = on_player(q, c);
  if (removing) return cur > 0.5f ? base + (player ? OFF_PLAYER : 0) : SENT;
  return (cur < 0.5f && wall < 0.5f && !player) ? base : SENT;
}

// One resource drape of an acting sub-step: regrowth, then the removal or
// spawn of tiles toward the ceiling of the availability. Returns the new
// availability.
__device__ __noinline__ float drape(const SvParams& p, int b, int r, const float* wall,
                                    float usable_half, uint32_t key_hi, uint32_t key_lo,
                                    uint32_t site, int t, float av, Pos4 q) {
  const size_t B = static_cast<size_t>(p.B);
  float* cur = p.out.res[r];
  bool on_any = false;
#pragma unroll
  for (int j = 0; j < SV_MAX_N; ++j) on_any = on_any || (q.c[j] >= 0 && cur[q.c[j] * B + b] > 0.5f);
  const bool can_grow = t > 0 && !on_any && av >= 1.f && av < p.res_cond[r];
  float av_new = av;
  if (can_grow) {
    const float grown = fminf(expf(p.regrowth_exponent * logf(av + 1.0f)), p.res_growth[r]);
    av_new = fminf(grown, usable_half);
  }
  if (p.res_metric[r]) return av_new;
  const float av_int = ceilf(av_new);
  float current = 0.f;
  for (int c = 0; c < p.HW; ++c) current = current + cur[c * B + b];
  const float need = fmaxf(current - av_int, 0.f);
  const float grow = fmaxf(av_int - current, 0.f);
  const bool removing = need > 0.5f;
  float count = removing ? need : grow;
  const int thresh = removing ? SENT : OFF_PLAYER;
  int tau = -1, prev = -1;
  for (int it = 0; it < p.res_k[r] && count > 0.5f; ++it) {
    int m = SENT;
    for (int c = 0; c < p.HW; ++c) {
      const size_t cb = c * B + b;
      const uint32_t bits = agw::hash_u32(key_hi, key_lo, site, static_cast<uint32_t>(c));
      const int s = drape_score(q, removing, cur[cb], wall[cb], bits, c);
      if (s > prev && s < m) m = s;
    }
    if (!(m < thresh)) break;
    tau = m;
    prev = m;
    count = count - 1.f;
  }
  if (tau < 0) return av_new;
  const float sign = removing ? -1.f : 1.f;
  for (int c = 0; c < p.HW; ++c) {
    const size_t cb = c * B + b;
    const uint32_t bits = agw::hash_u32(key_hi, key_lo, site, static_cast<uint32_t>(c));
    if (drape_score(q, removing, cur[cb], wall[cb], bits, c) <= tau) cur[cb] = cur[cb] + sign;
  }
  return av_new;
}

// One full multi-agent step of one lane: auto-reset, policy features and
// action draws, agent order, every agent's sub-step, finalize. MODE selects
// the policy; with POL_MLP the step's trajectory record goes to traj[step].
template <int N, int MODE>
__device__ __forceinline__ void sv_step(const SvParams& p, SvLane<N>& L, int b,
                                        const agw::Mlp& mlp, int step) {
  const size_t B = static_cast<size_t>(p.B);
  float* pred = p.out.predator;
  const uint32_t ctr0 = L.ctr * static_cast<uint32_t>(p.n_sites);

  // ---- auto-reset lanes whose episode ended last step: the redraw, or
  // the layout of the new episode (_pool_select: ep_idx % K after the
  // increment)
  bool over = true;
#pragma unroll
  for (int j = 0; j < N; ++j) over = over && (L.types[j] == LAST || L.types[j] == DEAD);
  if (over && p.pool > 1) L.ep_idx += 1;
  const int li = p.pool > 1 ? ((L.ep_idx % p.pool) + p.pool) % p.pool : 0;
  const float* wall = p.exact_reset ? p.out.wall : p.wall[li];
  const float* sboard = p.exact_reset ? p.out.sboard : p.sboard[li];
  if (over) {
    if (p.exact_reset) {
      const Pos4 starts = redraw(p, b, L.key_hi, L.key_lo, ctr0);
#pragma unroll
      for (int j = 0; j < N; ++j) L.pos[j] = starts.c[j];
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) L.pos[j] = p.pos0[li][j * B + b];
      for (int c = 0; c < p.HW; ++c) {
        const size_t cb = c * B + b;
        pred[cb] = p.predator0[li][cb];
        if (p.sustain)
          for (int r = 0; r < 4; ++r)
            if (p.res_on[r]) p.out.res[r][cb] = p.res0[li][r][cb];
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      L.reasons[j] = R_NONE;
      L.types[j] = FIRST;
      L.adir[j] = DIR_UP;
      L.odir[j] = DIR_UP;
      L.count[j] = 0;
      L.dsat[j] = p.sat0_drink;
      L.fsat[j] = p.sat0_food;
      L.safety[j] = 3;
      L.safety2[j] = 3;
#pragma unroll
      for (int k = 0; k < 7; ++k) L.visits[j][k] = 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (p.sustain && p.res_on[r]) L.avail[r] = p.res_amount[r];
    L.t = 0;
  }
  const float usable_half = p.sustain ? p.usable_half[p.exact_reset ? 0 : li][b] : 0.f;

  // ---- action draws (site 0), through the policy, and Fisher-Yates agent
  // order (site 1)
  const int A = p.amax - p.amin + 1;
  float x[N][SV_F];
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
          p.amin + agw::linear_greedy<SV_F>(p.pol_w, p.pol_b, p.pol_lanes, A, lane, x[j]);
      if (!(fmodf(uA, 1.f) < p.pol_eps[lane])) a = greedy;
    }
    if (MODE == POL_MLP) {
      float logp, value;
      a = p.amin + agw::mlp_draw<SV_F, SV_MAX_A>(mlp, A, x[j], u, logp, value);
      const size_t r = static_cast<size_t>(step) * N + j;
#pragma unroll
      for (int f = 0; f < SV_F; ++f)
        p.traj.feats[(static_cast<size_t>(step) * (N * SV_F) + j * SV_F + f) * B + b] = x[j][f];
      p.traj.logp[r * B + b] = logp;
      p.traj.value[r * B + b] = value;
      p.traj.action[r * B + b] = off ? -1 : a;
    }
    actions[j] = off ? -1 : a;
    order[j] = j;
  }
  if (p.randomize && N > 1) {
#pragma unroll
    for (int k = N - 1; k >= 1; --k) {
      const float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr0 + 1u, k));
      const int jj = min(max(static_cast<int>(floorf(u * static_cast<float>(k + 1))), 0), k);
      const int vk = order[k], vj = get(order, jj);
      put(order, jj, vk);
      order[k] = vj;
    }
  }

  float rew[N][SV_MAX_D];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int d = 0; d < SV_MAX_D; ++d) rew[j][d] = 0.f;

  // The slots are not unrolled: the body is large, and the agent's fields
  // are reached through get/put anyway.
#pragma unroll 1
  for (int slot = 0; slot < N; ++slot) {
    const int i = get(order, slot);
    const int a = get(actions, i);
    if (a < 0) continue;  // a non-acting sub-step changes nothing
    const bool is_quit = a == A_QUIT, is_noop = a == A_NOOP;
    const bool dead_i = get(L.reasons, i) != R_NONE;
    const bool active = !is_quit && !dead_i;
    L.t += 1;
    const uint32_t slot_site = ctr0 + static_cast<uint32_t>(2 + slot * p.sites_per_slot);

    // --- relative direction updates, from the facings at the sub-step's
    // start
    const int a_cl = min(a, 9);
    const int nod = rel_dir(p, a_cl, get(L.odir, i));
    if (active) put(L.odir, i, nod);
    const int nad = rel_dir(p, a_cl, get(L.adir, i));
    const int abs_action = is_noop ? a : p.dir_to_action[nad];

    // --- the move: the all-wall border keeps it in bounds; every agent's
    // cell blocks, dead or not
    const int pos_i = get(L.pos, i);
    const int cand = min(max(pos_i + p.delta[abs_action], 0), p.HW - 1);
    bool occ = false;
#pragma unroll
    for (int j = 0; j < N; ++j) occ = occ || (j != i && L.pos[j] == cand);
    const bool wall_at = wall[cand * B + b] > 0.5f;
    const bool moved = active && !is_noop && !wall_at && !occ;
    const int np = moved ? cand : pos_i;
    put(L.pos, i, np);
    if (active) put(L.adir, i, nad);
    if (active || (is_quit && !dead_i)) put(L.count, i, get(L.count, i) + 1);
    if (is_quit && !dead_i) put(L.reasons, i, static_cast<int>(R_QUIT));
    if (active && !is_noop) add_rv<N>(rew, p, i, RV_MOVE);

    // --- decode the combined board at the new position
    const size_t npb = np * B + b;
    const float v_at = sboard[npb];
    const float dw_at = floorf(v_at * (1.0f / 16.0f));
    const float code_at = v_at - 16.0f * dw_at;
    const bool pred_at = pred[npb] > 0.5f;
    bool on_res[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) on_res[r] = p.sustain && p.res_on[r] && p.out.res[r][npb] > 0.5f;

    // --- satiation decrements and thirst/hunger death
    if (active && p.penalise) {
      if (p.drink_flags_on) put(L.dsat, i, get(L.dsat, i) + p.drink_def_rate);
      if (p.food_flags_on) put(L.fsat, i, get(L.fsat, i) + p.food_def_rate);
    }
    if (p.thirst_death && active &&
        (get(L.dsat, i) <= p.drink_def_limit || get(L.fsat, i) <= p.food_def_limit)) {
      add_rv<N>(rew, p, i, RV_THIRST);
      if (get(L.reasons, i) == R_NONE) put(L.reasons, i, static_cast<int>(R_TERMINATED));
    }

    // --- consumption: drink, small drink, food, small food
    bool on_t[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool raw = p.sustain ? on_res[r] : code_at == static_cast<float>(p.res_code[r]);
      on_t[r] = p.res_on[r] && raw && active;
    }
    on_t[R_SMALL_DRINK] = on_t[R_SMALL_DRINK] && !on_t[R_DRINK];
    on_t[R_SMALL_FOOD] = on_t[R_SMALL_FOOD] && !on_t[R_FOOD];
    consume<N>(p, L, rew, i, R_DRINK, on_t[R_DRINK], L.dsat);
    consume<N>(p, L, rew, i, R_SMALL_DRINK, on_t[R_SMALL_DRINK], L.dsat);
    consume<N>(p, L, rew, i, R_FOOD, on_t[R_FOOD], L.fsat);
    consume<N>(p, L, rew, i, R_SMALL_FOOD, on_t[R_SMALL_FOOD], L.fsat);
    if (active && !on_t[R_DRINK] && !on_t[R_SMALL_DRINK]) add_rv<N>(rew, p, i, RV_NON_DRINK);
    if (active && !on_t[R_FOOD] && !on_t[R_SMALL_FOOD]) add_rv<N>(rew, p, i, RV_NON_FOOD);

    // --- gold and silver log-scaled rewards
    if (p.has_gold && active && code_at == static_cast<float>(T_GOLD)) {
      float prevv = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) {
          prevv = static_cast<float>(L.visits[j][5]);
          L.visits[j][5] += 1;
        }
      const float factor = (logf(prevv + 2.0f) - logf(prevv + 1.0f)) / p.gold_log_base;
      add_rv_scaled<N>(rew, p, i, RV_GOLD, factor);
    }
    if (p.has_silver && active && code_at == static_cast<float>(T_SILVER)) {
      float prevv = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) {
          prevv = static_cast<float>(L.visits[j][6]);
          L.visits[j][6] += 1;
        }
      const float factor = (logf(prevv + 2.0f) - logf(prevv + 1.0f)) / p.silver_log_base;
      add_rv_scaled<N>(rew, p, i, RV_SILVER, factor);
    }

    // --- gap visit: the positions after the move; curtain cells read
    // code 0
    bool others = false;
#pragma unroll
    for (int j = 0; j < N; ++j) others = others || (j != i && L.pos[j] == np);
    const bool any_res = on_res[0] || on_res[1] || on_res[2] || on_res[3];
    if (active && !others && !pred_at && !any_res && code_at == static_cast<float>(T_GAP)) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) L.visits[j][0] += 1;
      add_rv<N>(rew, p, i, RV_GAP);
    }

    // --- homeostasis thresholds
    if (active && p.drink_flags_on)
      homeo<N>(p, rew, i, get(L.dsat, i), p.drink_def_thresh, p.drink_over_thresh, RV_DRINK_DEF,
               RV_DRINK_OVER);
    if (active && p.food_flags_on)
      homeo<N>(p, rew, i, get(L.fsat, i), p.food_def_thresh, p.food_over_thresh, RV_FOOD_DEF,
               RV_FOOD_OVER);

    // --- safety distances: water from the board, predators by a per-cell
    // minimum
    if (p.has_water && active) put(L.safety, i, static_cast<int>(dw_at));
    if (p.has_predators && active) {
      const int nr = np / p.W, nc = np - (np / p.W) * p.W;
      int dmin = 9999;
      for (int c = 0; c < p.HW; ++c) {
        if (!(pred[c * B + b] > 0.5f)) continue;
        const int r = c / p.W, col = c - (c / p.W) * p.W;
        dmin = min(dmin, abs(r - nr) + abs(col - nc));
      }
      put(L.safety2, i, dmin > 98 ? 99 : dmin);
    }

    // --- water penalty
    if (p.has_water && active && code_at == static_cast<float>(T_WATER))
      add_rv<N>(rew, p, i, RV_DANGER);

    // --- predators: the walk runs when the round's last agent acts
    if (p.has_predators) {
      if (active && pred_at) add_rv<N>(rew, p, i, RV_PREDATOR);
      int cmax = -1, cmin = 1 << 30;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (L.reasons[j] != R_NONE) continue;
        cmax = max(cmax, L.count[j]);
        cmin = min(cmin, L.count[j]);
      }
      if (cmax == cmin && cmax > 0) {
        predator_walk(p, b, wall, L.key_hi, L.key_lo, slot_site, pos4<N>(L.pos));
        if (active && !pred_at && pred[npb] > 0.5f) add_rv<N>(rew, p, i, RV_PREDATOR);
      }
    }

    // --- resource drapes
    if (p.sustain) {
      const Pos4 q = pos4<N>(L.pos);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (p.res_on[r])
          L.avail[r] = drape(p, b, r, wall, usable_half, L.key_hi, L.key_lo,
                             slot_site + 1u + static_cast<uint32_t>(p.res_site[r]), L.t,
                             L.avail[r], q);
    }
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
    for (int d = 0; d < SV_MAX_D; ++d) L.stats[j][d] = L.stats[j][d] + rew[j][d];
  L.ctr += 1u;

  if (MODE == POL_MLP) {
    // Each agent's reward summed over the reward dims, in order; done flags.
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float r = rew[j][0];
#pragma unroll
      for (int d = 1; d < SV_MAX_D; ++d)
        if (d < p.D) r = r + rew[j][d];
      const size_t row = static_cast<size_t>(step) * N + j;
      p.traj.reward[row * B + b] = r;
      p.traj.done[row * B + b] = L.types[j] == LAST || L.types[j] == DEAD;
    }
  }
}

// K8: n_steps steps of every lane, uniform or linear-policy actions.
template <int N, int MODE>
__global__ void __launch_bounds__(256) sv_rollout_kernel(const __grid_constant__ SvParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  SvLane<N> L;
  load_lane<N>(p, b, L);
  const agw::Mlp no_mlp{nullptr, nullptr, nullptr, nullptr, 0};
  for (int step = 0; step < p.n_steps; ++step) sv_step<N, MODE>(p, L, b, no_mlp, step);
  store_lane<N>(p, b, L);
}

// K9: n_steps MLP-policy steps of every lane with the trajectory streamed
// out, then the bootstrap value of the final state (no auto-reset).
template <int N>
__global__ void __launch_bounds__(256) sv_collect_kernel(const __grid_constant__ SvParams p) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int tx = threadIdx.x;
  const int b = blockIdx.x * tile + tx;
  const int H = p.hidden, A = p.amax - p.amin + 1;
  const int n_w1 = H * SV_F, n_w2 = (A + 1) * H;
  float* w = smem;  // w1 [H*F], b1 [H], w2 [(A+1)*H], b2 [A+1]
  for (int k = tx; k < n_w1; k += tile) w[k] = p.mlp_w1[k];
  for (int k = tx; k < H; k += tile) w[n_w1 + k] = p.mlp_b1[k];
  for (int k = tx; k < n_w2; k += tile) w[n_w1 + H + k] = p.mlp_w2[k];
  for (int k = tx; k <= A; k += tile) w[n_w1 + H + n_w2 + k] = p.mlp_b2[k];
  __syncthreads();
  if (b >= p.B) return;
  const agw::Mlp mlp{w, w + n_w1, w + n_w1 + H, w + n_w1 + H + n_w2, H};

  SvLane<N> L;
  load_lane<N>(p, b, L);
  for (int step = 0; step < p.n_steps; ++step) sv_step<N, POL_MLP>(p, L, b, mlp, step);
  float x[N][SV_F];
  policy_feats<N>(p, L, x);
#pragma unroll
  for (int j = 0; j < N; ++j) p.traj.boot[j * p.B + b] = agw::mlp_value<SV_F>(mlp, A, x[j]);
  store_lane<N>(p, b, L);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, const SvParams& p, int tile, size_t smem,
                          cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + tile - 1) / tile;
  kernel<<<blocks, tile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_rollout(const SvParams& p, int tile, cudaStream_t s) {
  return p.pol_w ? launch(sv_rollout_kernel<N, POL_LINEAR>, p, tile, 0, s)
                 : launch(sv_rollout_kernel<N, POL_UNIFORM>, p, tile, 0, s);
}

template <int N>
static cudaError_t launch_collect(const SvParams& p, int tile, cudaStream_t s) {
  const size_t A = p.amax - p.amin + 1, H = p.hidden;
  const size_t n_w = H * SV_F + H + (A + 1) * H + (A + 1);
  return launch(sv_collect_kernel<N>, p, tile, 4 * n_w, s);
}

static bool valid(const SvParams* p) {
  return p->D >= 1 && p->D <= SV_MAX_D && p->pool >= 1 && p->pool <= SV_MAX_POOL &&
         p->amin >= 0 && p->amax <= 9 && p->amax - p->amin + 1 <= SV_MAX_A && p->T >= 0 &&
         p->T <= SV_MAX_T && p->HW > 0 && p->idx_bits + 3 < 32;
}

extern "C" int fused_savanna_rollout(const SvParams* p, int n_agents, int tile, void* stream) {
  if (p->n_steps <= 0 || p->B <= 0) return 0;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_agents) {
    case 1: return static_cast<int>(launch_rollout<1>(*p, tile, s));
    case 2: return static_cast<int>(launch_rollout<2>(*p, tile, s));
    case 3: return static_cast<int>(launch_rollout<3>(*p, tile, s));
    case 4: return static_cast<int>(launch_rollout<4>(*p, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_savanna_collect(const SvParams* p, int n_agents, int tile, void* stream) {
  if (p->B <= 0) return 0;
  if (!valid(p) || p->hidden < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_agents) {
    case 1: return static_cast<int>(launch_collect<1>(*p, tile, s));
    case 2: return static_cast<int>(launch_collect<2>(*p, tile, s));
    case 3: return static_cast<int>(launch_collect<3>(*p, tile, s));
    case 4: return static_cast<int>(launch_collect<4>(*p, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
