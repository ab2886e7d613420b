// K6 and K7: the fused island_navigation_ex_ma rollout and PPO collection,
// for Hopper (sm_90a).
//
// K6 (fused_island_ma_rollout) replaces ai_safety_gridworlds_tpu/ops/
// fused_base.py::FusedMaBase._rollout_pallas_call (:432) running
// ops/fused_island_ma.py::FusedIslandMa._step (:376) with the layout pool's
// fused_base.py::_pool_select (:360): one launch advances every lane n_steps
// full multi-agent steps -- auto-reset into the lane's layout for the new
// episode (ep_idx % K), action draws and Fisher-Yates agent order
// (fused_base.py::_draw_actions_and_order), each agent's sub-step in the
// permuted order (direction tables through _table_sel, the bounded move with
// agents blocking, quit, satiation and thirst/hunger death, goal, drink and
// food from the lane's scalar availability, gold and silver, gap visits,
// homeostasis, the water-death drape over every agent, sustainability
// regrowth or the availability reset) and finalize
// (fused_base.py::_finalize_types). With per-lane linear policies installed
// (set_policies), the actions come from fused_base.py::_policy_actions (:129)
// on the features of fused_island_ma.py::_policy_feats (:357); without them
// they are uniform draws.
//
// K7 (fused_island_ma_collect) replaces fused_base.py::_rollout_collect_pallas
// (:635) x _collect_step (:594) x _mlp_policy_actions (:196) /
// _mlp_forward_agent (:171) over the same step, and _bootstrap_value (:582):
// the whole PPO collection in one launch, streaming the record (features,
// action, logp, value, reward summed over the reward dims, done) to
// traj[k, row, lane] and the value head of the final state to boot.
//
// Design. One thread per lane, `tile` lanes per block. Every dynamic field
// of the lane -- positions and cached tile values, reasons, step types,
// facings, satiations, visits, safety, the availabilities and their
// fractions, t, key, draw counter, episode counter, reward sums -- lives in
// registers for the whole call, read from device memory once and written
// once (coalesced across the lanes of a warp). The static boards (wall, and
// sboard = tile code + 16 * distance to water) stay in device memory:
// [HW, 1] when every lane shares the map, [HW, B] with map randomization,
// and K copies with a layout pool. A sub-step reads two cells of them, the
// wall at the move's candidate and sboard at the new position, so they are
// read at that index (through L1/L2) and never copied. Small per-agent
// arrays are indexed through unrolled compare loops (get/put) so that a
// runtime agent index never spills them. K6 and K7 share one step body,
// im_step<N, MODE>, instantiated for N = 1..4 agents and the uniform, linear
// (K6) and MLP (K7) policy modes; the linear policy and the MLP come from
// policy.cuh, the PRF from prng.cuh.
//
// Bound. A lane-step is a few hundred integer and float operations (two PRF
// hashes per agent for the draws and the order, then per acting sub-step the
// direction tables, the move, two board reads, a dozen tile-code tests and
// the reward rows), against about 150 bytes of state per lane per call plus
// 8 bytes of board reads per sub-step: the kernels are bound by the serial
// latency of each thread's dependent chain, not by device memory. Keeping
// the state in registers for all n_steps is what the design does about it.
//
// Exactness. The kernels add each reward term to its row in the plain
// version's order, skip the terms whose vector is all zero (as the plain
// version does) and take every float operation of the plain step one by
// one; the library is built with --fmad=false, so nothing is contracted
// into an FMA. Regrowth computes expf(e * logf(af + 1)) (never powf or the
// fast intrinsics), then floors it. K6 equals the plain version on the card
// where both reach the same expf/logf.
#include "policy.cuh"
#include "prng.cuh"

#define IM_MAX_N 4
#define IM_MAX_D 12
#define IM_MAX_POOL 8
#define IM_F 10     // FusedIslandMa.POLICY_FEATURES
#define IM_MAX_A 5  // legal actions amin..amax

// Reward kinds, in the order of fused_island_ma.py::REWARD_KINDS.
enum {
  RV_MOVE = 0,
  RV_FINAL,
  RV_DRINK,
  RV_FOOD,
  RV_GOLD,
  RV_SILVER,
  RV_DANGER,
  RV_THIRST,
  RV_DRINK_DEF,
  RV_FOOD_DEF,
  RV_DRINK_OVER,
  RV_FOOD_OVER,
  RV_NON_DRINK,
  RV_NON_FOOD,
  RV_GAP,
  IM_N_RV
};

// Tile codes of the combined static board (fused_island_ma.py::TILE_CODES).
enum { T_GAP = 0, T_WALL = 1, T_WATER = 2, T_GOAL = 3, T_DRINK = 4, T_FOOD = 5, T_GOLD = 6, T_SILVER = 7 };
enum { FIRST = 0, MID = 1, LAST = 2, DEAD = 3 };
enum { R_NONE = -1, R_TERMINATED = 0, R_QUIT = 3 };
enum { A_NOOP = 0, A_QUIT = 9 };
enum { DIR_UP = 2 };
enum { POL_UNIFORM = 0, POL_LINEAR = 1, POL_MLP = 2 };

// Device pointers of the packed state, in fused_island_ma.py::_IM_FIELDS
// order; ep_idx is null without a layout pool.
struct ImState {
  int* pos;
  float* vcode;
  int* reasons;
  int* step_types;
  int* act_dir;
  int* obs_dir;
  float* drink_sat;
  float* food_sat;
  float* drink_avail;
  float* food_avail;
  float* drink_frac;
  float* food_frac;
  int* visits;
  int* safety;
  int* t;
  uint32_t* key;
  uint32_t* draw_ctr;
  float* stats_rewards;
  int* stats_episodes;
  int* ep_idx;
};

// K7's outputs: the trajectory records [T, rows, B] and the bootstrap value.
struct ImTraj {
  float* feats;   // [T, n*F, B]
  int* action;    // [T, n, B], -1 for reset lanes and dead agents
  float* logp;    // [T, n, B]
  float* value;   // [T, n, B]
  float* reward;  // [T, n, B]
  int* done;      // [T, n, B]
  float* boot;    // [n, B]
};

// Mirrored field for field by ops/fused_island_ma.py::_ImParams.
struct ImParams {
  ImState in;
  ImState out;
  // Layout k's boards: wall and sboard [HW, stat_lanes], pos0 (int) and
  // vcode0 [n, stat_lanes]; stat_lanes is 1 (shared) or B (per lane).
  const float* wall[IM_MAX_POOL];
  const float* sboard[IM_MAX_POOL];
  const int* pos0[IM_MAX_POOL];
  const float* vcode0[IM_MAX_POOL];
  int B, n_steps, D, HW, H, W, adm, odm, randomize, amin, amax, max_iterations;
  int pool, stat_lanes;
  int has_goal, has_drink, has_food, has_gold, has_silver, has_water;
  int thirst_death, penalise, proportional, sustainability;
  int drink_limit_on, food_limit_on;
  float sat0_drink, sat0_food, av0_drink, av0_food;
  float drink_rate, food_rate;          // extraction rates
  float drink_def_rate, food_def_rate;  // satiation decrements
  float drink_def_limit, food_def_limit;
  float drink_over_limit, food_over_limit;
  float drink_def_thresh, food_def_thresh;
  float drink_over_thresh, food_over_thresh;
  float drink_cond_limit, food_cond_limit;  // regrowth conditions
  float drink_growth_limit, food_growth_limit;
  float regrowth_exponent;
  float rv[IM_N_RV][IM_MAX_D];
  int rv_on[IM_N_RV];
  int dir_tab[3][10][4];
  int dir_to_action[4];
  int delta_r[10], delta_c[10];
  // The policy features' reciprocals, float32 as the reference rounds them:
  // 1/W, 1/max(H-1,1), 1/max(W-1,1).
  float inv_w, inv_hm1, inv_wm1;
  // Linear policy (K6), null without one: [A*F, pol_lanes], [A, pol_lanes],
  // [1, pol_lanes]; pol_lanes is 1 (shared) or B.
  const float* pol_w;
  const float* pol_b;
  const float* pol_eps;
  int pol_lanes;
  // MLP policy (K7): [H, F], [H, 1], [A+1, H], [A+1, 1].
  const float* mlp_w1;
  const float* mlp_b1;
  const float* mlp_w2;
  const float* mlp_b2;
  int hidden;
  ImTraj traj;
};

extern "C" int im_params_size() { return static_cast<int>(sizeof(ImParams)); }

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

// One lane's register state.
template <int N>
struct ImLane {
  uint32_t key_hi, key_lo, ctr;
  int t, episodes, ep_idx;
  float dav, fav, dfr, ffr;
  int pos[N], reasons[N], types[N], adir[N], odir[N], safety[N];
  float vcode[N], dsat[N], fsat[N];
  int visits[N][5];
  float stats[N][IM_MAX_D];
};

// rew[agent] += rv[kind], for a runtime agent index; terms whose vector is
// all zero are left out, as in the plain version.
template <int N>
__device__ __forceinline__ void add_rv(float (&rew)[N][IM_MAX_D], const ImParams& p,
                                       int agent, int kind) {
  if (!p.rv_on[kind]) return;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j != agent) continue;
#pragma unroll
    for (int d = 0; d < IM_MAX_D; ++d)
      if (d < p.D) rew[j][d] = rew[j][d] + p.rv[kind][d];
  }
}

// rew[agent] += rv[kind] * scale (the proportional homeostasis terms).
template <int N>
__device__ __forceinline__ void add_rv_scaled(float (&rew)[N][IM_MAX_D], const ImParams& p,
                                              int agent, int kind, float scale) {
  if (!p.rv_on[kind]) return;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j != agent) continue;
#pragma unroll
    for (int d = 0; d < IM_MAX_D; ++d)
      if (d < p.D) rew[j][d] = rew[j][d] + p.rv[kind][d] * scale;
  }
}

// _table_sel: table[action, dir], 0 for a direction outside 0..3.
__device__ __forceinline__ int table_sel(const ImParams& p, int tab, int a_cl, int dir) {
  return (dir >= 0 && dir < 4) ? p.dir_tab[tab][a_cl][dir] : 0;
}

// code_of: the tile code and the water distance packed in a board value.
__device__ __forceinline__ float code_of(float v, float& dw) {
  dw = floorf(v * (1.0f / 16.0f));
  return v - 16.0f * dw;
}

template <int N>
__device__ __forceinline__ void load_lane(const ImParams& p, int b, ImLane<N>& L) {
  const int B = p.B;
  L.key_hi = p.in.key[b];
  L.key_lo = p.in.key[B + b];
  L.ctr = p.in.draw_ctr[b];
  L.t = p.in.t[b];
  L.episodes = p.in.stats_episodes[b];
  L.ep_idx = p.pool > 1 ? p.in.ep_idx[b] : 0;
  L.dav = p.in.drink_avail[b];
  L.fav = p.in.food_avail[b];
  L.dfr = p.in.drink_frac[b];
  L.ffr = p.in.food_frac[b];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = j * B + b;
    L.pos[j] = p.in.pos[r];
    L.vcode[j] = p.in.vcode[r];
    L.reasons[j] = p.in.reasons[r];
    L.types[j] = p.in.step_types[r];
    L.adir[j] = p.in.act_dir[r];
    L.odir[j] = p.in.obs_dir[r];
    L.dsat[j] = p.in.drink_sat[r];
    L.fsat[j] = p.in.food_sat[r];
    L.safety[j] = p.in.safety[r];
#pragma unroll
    for (int k = 0; k < 5; ++k) L.visits[j][k] = p.in.visits[(j * 5 + k) * B + b];
#pragma unroll
    for (int d = 0; d < IM_MAX_D; ++d)
      L.stats[j][d] = d < p.D ? p.in.stats_rewards[(j * p.D + d) * B + b] : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void store_lane(const ImParams& p, int b, const ImLane<N>& L) {
  const int B = p.B;
  p.out.key[b] = L.key_hi;
  p.out.key[B + b] = L.key_lo;
  p.out.draw_ctr[b] = L.ctr;
  p.out.t[b] = L.t;
  p.out.stats_episodes[b] = L.episodes;
  if (p.pool > 1) p.out.ep_idx[b] = L.ep_idx;
  p.out.drink_avail[b] = L.dav;
  p.out.food_avail[b] = L.fav;
  p.out.drink_frac[b] = L.dfr;
  p.out.food_frac[b] = L.ffr;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = j * B + b;
    p.out.pos[r] = L.pos[j];
    p.out.vcode[r] = L.vcode[j];
    p.out.reasons[r] = L.reasons[j];
    p.out.step_types[r] = L.types[j];
    p.out.act_dir[r] = L.adir[j];
    p.out.obs_dir[r] = L.odir[j];
    p.out.drink_sat[r] = L.dsat[j];
    p.out.food_sat[r] = L.fsat[j];
    p.out.safety[r] = L.safety[j];
#pragma unroll
    for (int k = 0; k < 5; ++k) p.out.visits[(j * 5 + k) * B + b] = L.visits[j][k];
#pragma unroll
    for (int d = 0; d < IM_MAX_D; ++d)
      if (d < p.D) p.out.stats_rewards[(j * p.D + d) * B + b] = L.stats[j][d];
  }
}

// _policy_feats: per agent, normalised row and column (from _pos_dir_feats),
// drink and food satiation * 0.1f, drink and food availability * 0.05f, and
// the action-direction one-hot.
template <int N>
__device__ __forceinline__ void policy_feats(const ImParams& p, const ImLane<N>& L,
                                             float (&x)[N][IM_F]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float pj = static_cast<float>(L.pos[j]);
    const float row = floorf((pj + 0.5f) * p.inv_w);
    const float col = pj - row * static_cast<float>(p.W);
    x[j][0] = row * p.inv_hm1;
    x[j][1] = col * p.inv_wm1;
    x[j][2] = L.dsat[j] * 0.1f;
    x[j][3] = L.fsat[j] * 0.1f;
    x[j][4] = L.dav * 0.05f;
    x[j][5] = L.fav * 0.05f;
#pragma unroll
    for (int d = 0; d < 4; ++d) x[j][6 + d] = L.adir[j] == d ? 1.f : 0.f;
  }
}

// Drink or food on the acting agent's tile: the visit counts even when the
// availability is 0; a positive availability pays the reward, feeds the
// satiation (penalise_oversatiation), clamps it at the oversatiation limit
// and is depleted by the extraction rate.
template <int N>
__device__ __forceinline__ void consume(const ImParams& p, ImLane<N>& L,
                                        float (&rew)[N][IM_MAX_D], int i, bool on_tile,
                                        float (&sat)[N], float& av, int kind, float rate,
                                        int limit_on, float limit, int visit_col) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i && on_tile) L.visits[j][visit_col] += 1;
  const bool got = on_tile && av > 0.f;
  if (!got) return;
  add_rv<N>(rew, p, i, kind);
  if (p.penalise) put(sat, i, get(sat, i) + fminf(av, rate));
  if (limit_on && get(sat, i) > 0.f) put(sat, i, fminf(limit, get(sat, i)));
  av = fmaxf(0.f, av - rate);
}

// Homeostasis of one satiation: the deficiency term, then the
// oversatiation term, as counts or proportional to the satiation.
template <int N>
__device__ __forceinline__ void homeo(const ImParams& p, float (&rew)[N][IM_MAX_D], int i,
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

// Sustainability regrowth of one availability: where no agent stands on the
// resource and 0 < av < cond_limit, (av + fr + 1)^e by expf/logf, capped at
// limit, splits into its integer part and fraction.
template <int N>
__device__ __forceinline__ void regrow(const ImParams& p, const float (&codes)[N], int tcode,
                                       float& av, float& fr, float cond_limit, float limit) {
  bool on_any = false;
#pragma unroll
  for (int j = 0; j < N; ++j) on_any = on_any || codes[j] == static_cast<float>(tcode);
  if (on_any || !(av > 0.f) || !(av < cond_limit)) return;
  const float af = av + fr;
  const float af2 = fminf(limit, expf(p.regrowth_exponent * logf(af + 1.0f)));
  const float ni = floorf(af2);
  av = ni;
  fr = af2 - ni;
}

// One full multi-agent step of one lane: auto-reset, policy features and
// action draws, agent order, every agent's sub-step, finalize. MODE selects
// the policy; with POL_MLP the step's trajectory record goes to traj[step].
template <int N, int MODE>
__device__ __forceinline__ void im_step(const ImParams& p, ImLane<N>& L, int b,
                                        const agw::Mlp& mlp, int step) {
  const size_t sB = static_cast<size_t>(p.B);
  const int SL = p.stat_lanes;
  const int sl = SL == 1 ? 0 : b;

  // ---- auto-reset lanes whose episode ended last step, into the layout of
  // the new episode (_pool_select: ep_idx % K after the increment)
  bool over = true;
#pragma unroll
  for (int j = 0; j < N; ++j) over = over && (L.types[j] == LAST || L.types[j] == DEAD);
  if (over && p.pool > 1) L.ep_idx += 1;
  const int li = p.pool > 1 ? ((L.ep_idx % p.pool) + p.pool) % p.pool : 0;
  const float* wall = p.wall[li];
  const float* sboard = p.sboard[li];
  if (over) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      L.pos[j] = p.pos0[li][j * SL + sl];
      L.vcode[j] = p.vcode0[li][j * SL + sl];
      L.reasons[j] = R_NONE;
      L.types[j] = FIRST;
      L.adir[j] = DIR_UP;
      L.odir[j] = DIR_UP;
      L.dsat[j] = p.sat0_drink;
      L.fsat[j] = p.sat0_food;
      L.safety[j] = 3;
#pragma unroll
      for (int k = 0; k < 5; ++k) L.visits[j][k] = 0;
    }
    L.dav = p.av0_drink;
    L.fav = p.av0_food;
    L.dfr = 0.f;
    L.ffr = 0.f;
    L.t = 0;
  }

  // ---- action draws (site 0), through the policy, and Fisher-Yates agent
  // order (site 1)
  const uint32_t ctr0 = L.ctr * 2u;
  const int A = p.amax - p.amin + 1;
  float x[N][IM_F];
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
          p.amin + agw::linear_greedy<IM_F>(p.pol_w, p.pol_b, p.pol_lanes, A, lane, x[j]);
      if (!(fmodf(uA, 1.f) < p.pol_eps[lane])) a = greedy;
    }
    if (MODE == POL_MLP) {
      float logp, value;
      a = p.amin + agw::mlp_draw<IM_F, IM_MAX_A>(mlp, A, x[j], u, logp, value);
      const size_t r = static_cast<size_t>(step) * N + j;
#pragma unroll
      for (int f = 0; f < IM_F; ++f)
        p.traj.feats[(static_cast<size_t>(step) * (N * IM_F) + j * IM_F + f) * sB + b] = x[j][f];
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
      const float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr0 + 1u, k));
      const int jj = min(max(static_cast<int>(floorf(u * static_cast<float>(k + 1))), 0), k);
      const int vk = order[k], vj = get(order, jj);
      put(order, jj, vk);
      order[k] = vj;
    }
  }

  float rew[N][IM_MAX_D];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int d = 0; d < IM_MAX_D; ++d) rew[j][d] = 0.f;

#pragma unroll
  for (int slot = 0; slot < N; ++slot) {
    const int i = order[slot];
    const int a = get(actions, i);
    if (a < 0) {
      // A non-acting sub-step only refreshes the agent's cached tile value.
      put(L.vcode, i, sboard[get(L.pos, i) * SL + sl]);
      continue;
    }
    const bool is_quit = a == A_QUIT, is_noop = a == A_NOOP;
    const bool dead_i = get(L.reasons, i) != R_NONE;
    const bool active = !is_quit && !dead_i;
    L.t += 1;

    // --- direction updates, from the facings at the sub-step's start
    const int a_cl = min(a, 9);
    const int dir_i = get(L.adir, i), odir_i = get(L.odir, i);
    if (p.odm != 0) {
      const int tab = p.odm == 1 ? ((p.adm == 1 || p.adm == 2) ? 1 : 0) : 2;
      const int nod = table_sel(p, tab, a_cl, odir_i);
      if (active) put(L.odir, i, nod);
    }
    int abs_action = a;
    if (p.adm != 0) {
      const int rel = table_sel(p, 1, a_cl, dir_i);
      const int abs_move = p.dir_to_action[(rel >= 1 && rel <= 3) ? rel : 0];
      abs_action = (a >= 1 && a <= 4) ? abs_move : a;
      const int nad = table_sel(p, p.adm, a_cl, dir_i);
      if (active) put(L.adir, i, nad);
    }

    // --- the bounded move: board edges may be water, so the bounds are
    // checked; every agent's cell blocks, dead or not
    const int pos_i = get(L.pos, i);
    const int r_i = pos_i / p.W, c_i = pos_i - (pos_i / p.W) * p.W;
    const int cr = r_i + p.delta_r[abs_action], cc = c_i + p.delta_c[abs_action];
    const bool inb = cr >= 0 && cr < p.H && cc >= 0 && cc < p.W;
    const int cand = min(max(cr, 0), p.H - 1) * p.W + min(max(cc, 0), p.W - 1);
    bool occ = false;
#pragma unroll
    for (int j = 0; j < N; ++j) occ = occ || (j != i && L.pos[j] == cand);
    const bool wall_at = wall[cand * SL + sl] > 0.5f;
    const bool moved = active && inb && !wall_at && !occ;
    const int np = moved ? cand : pos_i;
    put(L.pos, i, np);
    if (is_quit && !dead_i) put(L.reasons, i, static_cast<int>(R_QUIT));

    const float v_at = sboard[np * SL + sl];
    put(L.vcode, i, v_at);
    float dw_at;
    const float code_at = code_of(v_at, dw_at);

    if (active && !is_noop) add_rv<N>(rew, p, i, RV_MOVE);
    if (active) put(L.safety, i, static_cast<int>(dw_at));

    // --- satiation decrements and thirst/hunger death
    if (p.penalise && active) {
      put(L.dsat, i, get(L.dsat, i) + p.drink_def_rate);
      put(L.fsat, i, get(L.fsat, i) + p.food_def_rate);
    }
    if (p.thirst_death && active &&
        (get(L.dsat, i) <= p.drink_def_limit || get(L.fsat, i) <= p.food_def_limit)) {
      add_rv<N>(rew, p, i, RV_THIRST);
      if (get(L.reasons, i) == R_NONE) put(L.reasons, i, static_cast<int>(R_TERMINATED));
    }

    // --- ultimate goal
    if (p.has_goal && active && code_at == static_cast<float>(T_GOAL)) {
      add_rv<N>(rew, p, i, RV_FINAL);
      if (get(L.reasons, i) == R_NONE) put(L.reasons, i, static_cast<int>(R_TERMINATED));
    }

    // --- drink / food with scalar availability
    if (p.has_drink) {
      const bool on_t = active && code_at == static_cast<float>(T_DRINK);
      consume<N>(p, L, rew, i, on_t, L.dsat, L.dav, RV_DRINK, p.drink_rate, p.drink_limit_on,
                 p.drink_over_limit, 1);
      if (active && !on_t) add_rv<N>(rew, p, i, RV_NON_DRINK);
    }
    if (p.has_food) {
      const bool on_t = active && code_at == static_cast<float>(T_FOOD);
      consume<N>(p, L, rew, i, on_t, L.fsat, L.fav, RV_FOOD, p.food_rate, p.food_limit_on,
                 p.food_over_limit, 2);
      if (active && !on_t) add_rv<N>(rew, p, i, RV_NON_FOOD);
    }
    if (p.has_gold && active && code_at == static_cast<float>(T_GOLD)) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) L.visits[j][3] += 1;
      add_rv<N>(rew, p, i, RV_GOLD);
    }
    if (p.has_silver && active && code_at == static_cast<float>(T_SILVER)) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) L.visits[j][4] += 1;
      add_rv<N>(rew, p, i, RV_SILVER);
    }

    // --- gap visit: the positions after the move
    bool others = false;
#pragma unroll
    for (int j = 0; j < N; ++j) others = others || (j != i && L.pos[j] == np);
    if (active && !others && code_at == static_cast<float>(T_GAP)) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) L.visits[j][0] += 1;
      add_rv<N>(rew, p, i, RV_GAP);
    }

    // --- homeostasis thresholds
    if (active && p.has_drink)
      homeo<N>(p, rew, i, get(L.dsat, i), p.drink_def_thresh, p.drink_over_thresh, RV_DRINK_DEF,
               RV_DRINK_OVER);
    if (active && p.has_food)
      homeo<N>(p, rew, i, get(L.fsat, i), p.food_def_thresh, p.food_over_thresh, RV_FOOD_DEF,
               RV_FOOD_OVER);

    // --- the water-death drape: every agent, from the cached tile codes;
    // the sub-step acts, so the penalty applies
    float codes[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float dw;
      codes[j] = code_of(L.vcode[j], dw);
    }
    if (p.has_water) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (codes[j] == static_cast<float>(T_WATER)) {
          add_rv<N>(rew, p, j, RV_DANGER);
          L.reasons[j] = R_TERMINATED;
        }
      }
    }

    // --- sustainability regrowth, or the availability reset
    if (p.sustainability) {
      if (p.has_drink)
        regrow<N>(p, codes, T_DRINK, L.dav, L.dfr, p.drink_cond_limit, p.drink_growth_limit);
      if (p.has_food)
        regrow<N>(p, codes, T_FOOD, L.fav, L.ffr, p.food_cond_limit, p.food_growth_limit);
    } else {
      L.dav = p.av0_drink;
      L.fav = p.av0_food;
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
    for (int d = 0; d < IM_MAX_D; ++d) L.stats[j][d] = L.stats[j][d] + rew[j][d];
  L.ctr += 1u;

  if (MODE == POL_MLP) {
    // Each agent's reward summed over the reward dims, in order; done flags.
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float r = rew[j][0];
#pragma unroll
      for (int d = 1; d < IM_MAX_D; ++d)
        if (d < p.D) r = r + rew[j][d];
      const size_t row = static_cast<size_t>(step) * N + j;
      p.traj.reward[row * sB + b] = r;
      p.traj.done[row * sB + b] = L.types[j] == LAST || L.types[j] == DEAD;
    }
  }
}

// K6: n_steps steps of every lane, uniform or linear-policy actions.
template <int N, int MODE>
__global__ void __launch_bounds__(256) im_rollout_kernel(const __grid_constant__ ImParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  ImLane<N> L;
  load_lane<N>(p, b, L);
  const agw::Mlp no_mlp{nullptr, nullptr, nullptr, nullptr, 0};
  for (int step = 0; step < p.n_steps; ++step) im_step<N, MODE>(p, L, b, no_mlp, step);
  store_lane<N>(p, b, L);
}

// K7: n_steps MLP-policy steps of every lane with the trajectory streamed
// out, then the bootstrap value of the final state (no auto-reset).
template <int N>
__global__ void __launch_bounds__(256) im_collect_kernel(const __grid_constant__ ImParams p) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int tx = threadIdx.x;
  const int b = blockIdx.x * tile + tx;
  const int H = p.hidden, A = p.amax - p.amin + 1;
  const int n_w1 = H * IM_F, n_w2 = (A + 1) * H;
  float* w = smem;  // w1 [H*F], b1 [H], w2 [(A+1)*H], b2 [A+1]
  for (int k = tx; k < n_w1; k += tile) w[k] = p.mlp_w1[k];
  for (int k = tx; k < H; k += tile) w[n_w1 + k] = p.mlp_b1[k];
  for (int k = tx; k < n_w2; k += tile) w[n_w1 + H + k] = p.mlp_w2[k];
  for (int k = tx; k <= A; k += tile) w[n_w1 + H + n_w2 + k] = p.mlp_b2[k];
  __syncthreads();
  if (b >= p.B) return;
  const agw::Mlp mlp{w, w + n_w1, w + n_w1 + H, w + n_w1 + H + n_w2, H};

  ImLane<N> L;
  load_lane<N>(p, b, L);
  for (int step = 0; step < p.n_steps; ++step) im_step<N, POL_MLP>(p, L, b, mlp, step);
  float x[N][IM_F];
  policy_feats<N>(p, L, x);
#pragma unroll
  for (int j = 0; j < N; ++j) p.traj.boot[j * p.B + b] = agw::mlp_value<IM_F>(mlp, A, x[j]);
  store_lane<N>(p, b, L);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, const ImParams& p, int tile, size_t smem,
                          cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + tile - 1) / tile;
  kernel<<<blocks, tile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_rollout(const ImParams& p, int tile, cudaStream_t s) {
  return p.pol_w ? launch(im_rollout_kernel<N, POL_LINEAR>, p, tile, 0, s)
                 : launch(im_rollout_kernel<N, POL_UNIFORM>, p, tile, 0, s);
}

template <int N>
static cudaError_t launch_collect(const ImParams& p, int tile, cudaStream_t s) {
  const size_t A = p.amax - p.amin + 1, H = p.hidden;
  const size_t n_w = H * IM_F + H + (A + 1) * H + (A + 1);
  return launch(im_collect_kernel<N>, p, tile, 4 * n_w, s);
}

static bool valid(const ImParams* p) {
  return p->D >= 1 && p->D <= IM_MAX_D && p->pool >= 1 && p->pool <= IM_MAX_POOL &&
         p->amin >= 0 && p->amax <= 9 && p->amax - p->amin + 1 <= IM_MAX_A &&
         (p->stat_lanes == 1 || p->stat_lanes == p->B);
}

extern "C" int fused_island_ma_rollout(const ImParams* p, int n_agents, int tile,
                                       void* stream) {
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

extern "C" int fused_island_ma_collect(const ImParams* p, int n_agents, int tile,
                                       void* stream) {
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
