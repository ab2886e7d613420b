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
// Bound. A lane-step is a few hundred integer and float operations against
// about 150 bytes of state per lane per call: at the batches the main paths
// run (B = 4096) the card is far from either limit, and the time is the
// latency of each lane's serial chain of dependent operations. The design
// shortens that chain and runs more of the card beside it:
// * A lane group of g threads runs each lane (g = p.group, a power of two
//   from 1 to 32, chosen by fused_island_ma.py::_lanes_per_group from the
//   batch and the mode; 32 / g groups a warp). Positions, reasons, types,
//   facings, satiations, visits, safety, availabilities and fractions, t,
//   key, counters and the episode index are group-uniform: every thread
//   holds them and runs the scalar chain redundantly, so the group takes
//   every branch together. Thread 0 of the group writes them back.
// * The reward rows split over the group: thread t owns dims d = t + g * s
//   (slot s) of every agent, of the step's rewards and of stats_rewards, so
//   a reward term costs ceil(D / g) adds on the acting agent's row instead
//   of D. Each (agent, dim) sum still takes its terms one by one in the
//   plain version's order on one thread. K7's record sums each agent's
//   dims in ascending order on one thread, from a per-lane buffer the
//   owners write.
// * The move is one shared-memory word: the step table holds, for each
//   cell and move (stay, LEFT, RIGHT, UP, DOWN), the clamped candidate
//   cell, whether it is in bounds and no wall, and the candidate's static
//   board value (tile code + 16 * distance to water); the stay column gives
//   the board value of the cell itself. The direction tables are composed
//   into one word per (action, facing): the move, the new action facing
//   and the new observation facing. Both tables come from the host
//   (fused_island_ma.py::_step_words, _dir_words). Shared layouts copy into
//   the block's shared memory once; per-lane layouts (map randomization)
//   copy the lane's table into its own region at load and at each reset of
//   a layout pool.
// * A group of at least 2N - 1 threads hashes the step's 2N - 1 PRF words
//   (the action draws and the agent order) on different threads and passes
//   them round by shuffle.
// * K7's MLP runs through a per-lane buffer (policy.cuh,
//   mlp_group_buf_rows): thread t forms hidden units t, t + g, ... of every
//   agent into shared memory, then each output row is summed by one thread
//   from there; the record stores spread over the group.
// The threads of a group need not run in step, so every write to shared
// memory that other threads of the group read sits between two
// __syncwarp()s of the group's mask, and the shuffles name the group's own
// mask and width. g is a runtime field, so the 12 instantiations (N = 1..4
// agents x uniform, linear, MLP) serve every g.
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

#define IM_MAX_D 12
#define IM_MAX_POOL 8
#define IM_MAX_HW 4096  // the step word's candidate field: 12 bits
#define IM_F 10         // FusedIslandMa.POLICY_FEATURES
#define IM_MAX_A 5      // legal actions amin..amax
#define IM_MOVES 5      // step-table columns: stay, LEFT, RIGHT, UP, DOWN
#define IM_FACINGS 5    // direction-word columns: facings 0..3, then any other
#define IM_ACTIONS 10   // action ids 0..9

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
  // Layout k's step table [stat_lanes, HW * IM_MOVES] (words as
  // fused_island_ma.py::_step_words packs them), pos0 (int) and vcode0
  // [n, stat_lanes]; stat_lanes is 1 (shared) or B (per lane).
  const uint32_t* steps[IM_MAX_POOL];
  const int* pos0[IM_MAX_POOL];
  const float* vcode0[IM_MAX_POOL];
  int B, n_steps, D, HW, W, adm, odm, randomize, amin, amax, max_iterations;
  int pool, stat_lanes;
  int has_goal, has_drink, has_food, has_gold, has_silver, has_water;
  int thirst_death, penalise, proportional, sustainability;
  int drink_limit_on, food_limit_on;
  // The lane group: threads per lane, a power of two from 1 to 32.
  int group;
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
  // The composed direction word of (action, facing column), as
  // fused_island_ma.py::_dir_words packs it.
  uint32_t dir_word[IM_ACTIONS][IM_FACINGS];
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

// Step-word fields: the candidate cell, the move bit (in bounds and no
// wall), the candidate's static board value.
constexpr uint32_t SW_CELL = 0xFFFu;
constexpr int SW_OK_BIT = 12;
constexpr int SW_BOARD_SHIFT = 16;
// Direction-word fields: the move column, the new action facing, the new
// observation facing, a byte each.
constexpr int DW_ADIR_SHIFT = 8;
constexpr int DW_ODIR_SHIFT = 16;

// Shared memory, in 4-byte words (ops/fused_island_ma.py::_smem_bytes
// mirrors it). The block's part: the reward vectors [IM_N_RV][IM_MAX_D],
// the direction words, the step tables (the pool's shared tables, or one
// table a lane with per-lane layouts) and K7's MLP weights (w1 [H, F], b1
// [H], w2 [A+1, H] with rows H + 1 apart, b2 [A+1]); then each lane's part:
// its stats_rewards [N][D] and K7's buffers, hidden units [N][H + 1],
// output rows [N][A + 1] and the step's rewards [N][D]. Lanes' parts lie an
// odd number of words apart.
struct ImSmem {
  int rv, dirw, tables, weights, lanes, per_lane, words;
};

__host__ __device__ inline bool im_per_lane(const ImParams& p) { return p.stat_lanes != 1; }

// The words between two lanes' step tables with per-lane layouts: odd, so
// that the lanes of a warp reading the same entry hit different banks.
__host__ __device__ inline int im_lane_table(const ImParams& p) { return p.HW * IM_MOVES | 1; }

__host__ __device__ inline ImSmem im_smem(const ImParams& p, int n_agents, int lanes,
                                          int hidden) {
  ImSmem s;
  const int A = p.amax - p.amin + 1;
  s.rv = 0;
  s.dirw = s.rv + IM_N_RV * IM_MAX_D;
  s.tables = s.dirw + IM_ACTIONS * IM_FACINGS;
  s.weights = s.tables + (im_per_lane(p) ? lanes * im_lane_table(p) : p.pool * p.HW * IM_MOVES);
  s.lanes = s.weights + (hidden ? hidden * IM_F + hidden + (A + 1) * (hidden + 1) + A + 1 : 0);
  s.per_lane = (n_agents * p.D + (hidden ? n_agents * (hidden + 1 + A + 1 + p.D) : 0)) | 1;
  s.words = s.lanes + lanes * s.per_lane;
  return s;
}

extern "C" int im_smem_bytes(const ImParams* p, int n_agents, int tile, int hidden) {
  return 4 * im_smem(*p, n_agents, tile / p->group, hidden).words;
}

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

// A lane group: this thread's index t in it, its size g, its threads' mask
// in the warp, and the reward slots ceil(D / g) of its threads (from the
// parameters alone, so the compiler sees loops bounded by it as uniform).
// Its shuffles name only its own threads, so the groups of a warp may take
// different branches.
struct Grp {
  int t, g, slots;
  unsigned mask;
};

// Whether this thread owns reward slot s: dim d = t + g * s < D.
__device__ __forceinline__ bool owns(const ImParams& p, const Grp& G, int s) {
  return G.t + G.g * s < p.D;
}

// The block's shared tables and this lane's step table and K7 buffers.
struct ImView {
  const float* rv;          // [IM_N_RV][IM_MAX_D]
  const uint32_t* dirw;     // [IM_ACTIONS][IM_FACINGS]
  const uint32_t* tables;   // the pool's shared tables, [pool][HW * IM_MOVES]
  uint32_t* own;            // the lane's table with per-lane layouts
  float* stats;             // the lane's stats_rewards [N][D], each dim by its owner
  float* hbuf;              // K7: [N][H + 1] hidden units, then [N][A + 1] rows
  float* rbuf;              // K7: the step's rewards [N][D], for the record sums
  agw::Mlp mlp;             // K7, in the block's shared memory
};

// One lane's register state (its stats_rewards are in shared memory).
template <int N>
struct ImLane {
  uint32_t key_hi, key_lo, ctr;
  int t, episodes, ep_idx;
  float dav, fav, dfr, ffr;
  int pos[N], reasons[N], types[N], adir[N], odir[N], safety[N];
  float vcode[N], dsat[N], fsat[N];
  int visits[N][5];
};

// row += rv[kind] (* scale with SCALED, the proportional homeostasis
// terms) on this thread's dims of one agent's reward row; terms whose
// vector is all zero are left out, as in the plain version. A lone thread
// (g = 1) reads the vector from the parameter block at compile-time dims; a
// group's thread (g >= 2, so at most IM_MAX_D / 2 slots) reads its dims
// d = t + g * s from shared memory.
template <bool SCALED>
__device__ __forceinline__ void add_term(float (&row)[IM_MAX_D], const ImParams& p, const Grp& G,
                                         const float* rv, int kind, float scale) {
  if (!p.rv_on[kind]) return;
  if (p.group == 1) {
#pragma unroll
    for (int d = 0; d < IM_MAX_D; ++d)
      if (d < p.D) row[d] = row[d] + (SCALED ? p.rv[kind][d] * scale : p.rv[kind][d]);
    return;
  }
  const float* v = rv + kind * IM_MAX_D + G.t;
#pragma unroll
  for (int s = 0; s < IM_MAX_D / 2; ++s) {
    if (s >= G.slots) break;
    if (owns(p, G, s)) row[s] = row[s] + (SCALED ? v[G.g * s] * scale : v[G.g * s]);
  }
}

__device__ __forceinline__ void add_rv(float (&row)[IM_MAX_D], const ImParams& p, const Grp& G,
                                       const float* rv, int kind) {
  add_term<false>(row, p, G, rv, kind, 1.f);
}

__device__ __forceinline__ void add_rv_scaled(float (&row)[IM_MAX_D], const ImParams& p,
                                              const Grp& G, const float* rv, int kind,
                                              float scale) {
  add_term<true>(row, p, G, rv, kind, scale);
}

// code_of: the tile code and the water distance packed in a board value.
__device__ __forceinline__ float code_of(float v, float& dw) {
  dw = floorf(v * (1.0f / 16.0f));
  return v - 16.0f * dw;
}

// The static board value at a step word's candidate cell.
__device__ __forceinline__ float board_of(uint32_t w) {
  return static_cast<float>(w >> SW_BOARD_SHIFT);
}

// The direction-word column of a facing: 0..3, or 4 for any other value.
__device__ __forceinline__ int facing_col(int dir) {
  return static_cast<unsigned>(dir) < 4u ? dir : 4;
}

// The lane's layout under a layout pool (_pool_select: ep_idx % K).
__device__ __forceinline__ int layout_of(const ImParams& p, int ep_idx) {
  return p.pool > 1 ? ((ep_idx % p.pool) + p.pool) % p.pool : 0;
}

// Layout li's step table for lane b into the lane's own region, by its
// group, between two syncs of the group.
__device__ __forceinline__ void copy_table(const ImParams& p, const Grp& G, uint32_t* own, int li,
                                           int b) {
  const int tw = p.HW * IM_MOVES;
  const uint32_t* src = p.steps[li] + static_cast<size_t>(b) * tw;
  __syncwarp(G.mask);  // the group has read the old table
  for (int e = G.t; e < tw; e += G.g) own[e] = src[e];
  __syncwarp(G.mask);
}

// The step table of the lane's layout li.
__device__ __forceinline__ const uint32_t* table_of(const ImParams& p, const ImView& V, int li) {
  return im_per_lane(p) ? V.own : V.tables + li * p.HW * IM_MOVES;
}

// The step's PRF uniforms: the action draws (site 0, index j) and the
// Fisher-Yates order (site 1, index k >= 1). A group of at least 2N - 1
// threads hashes the 2N - 1 words on different threads (thread t hashes
// word t mod (2N - 1)) and passes them round; a smaller one hashes all of
// them on every thread.
template <int N>
__device__ __forceinline__ void step_draws(const ImParams& p, const Grp& G, uint32_t key_hi,
                                           uint32_t key_lo, uint32_t ctr, float (&ua)[N],
                                           float (&uo)[N]) {
  const uint32_t ctr0 = ctr * 2u;
  uo[0] = 0.f;
  if (G.g >= 2 * N - 1) {
    const int w = G.t % (2 * N - 1);
    const uint32_t bits = agw::hash_u32(key_hi, key_lo, ctr0 + (w < N ? 0u : 1u),
                                        w < N ? w : w - N + 1);
#pragma unroll
    for (int j = 0; j < N; ++j) ua[j] = agw::uniform01(__shfl_sync(G.mask, bits, j, G.g));
#pragma unroll
    for (int k = 1; k < N; ++k)
      uo[k] = agw::uniform01(__shfl_sync(G.mask, bits, N + k - 1, G.g));
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) ua[j] = agw::uniform01(agw::hash_u32(key_hi, key_lo, ctr0, j));
#pragma unroll
  for (int k = 1; k < N; ++k)
    uo[k] = p.randomize ? agw::uniform01(agw::hash_u32(key_hi, key_lo, ctr0 + 1u, k)) : 0.f;
}

// The lane's state, on every thread of its group; stats_rewards on the
// owners of its dims.
template <int N>
__device__ __forceinline__ void load_lane(const ImParams& p, const Grp& G, const ImView& V, int b,
                                          ImLane<N>& L) {
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
    for (int d = G.t; d < p.D; d += G.g) V.stats[j * p.D + d] = p.in.stats_rewards[(j * p.D + d) * B + b];
  }
}

// The lane's state by thread 0 of its group; stats_rewards by the owners.
template <int N>
__device__ __forceinline__ void store_lane(const ImParams& p, const Grp& G, const ImView& V, int b,
                                           const ImLane<N>& L) {
  const int B = p.B;
#pragma unroll
  for (int j = 0; j < N; ++j)
    for (int d = G.t; d < p.D; d += G.g) p.out.stats_rewards[(j * p.D + d) * B + b] = V.stats[j * p.D + d];
  if (G.t != 0) return;
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
__device__ __forceinline__ void consume(const ImParams& p, const Grp& G, const float* rv,
                                        ImLane<N>& L, float (&cur)[IM_MAX_D], int i,
                                        bool on_tile, float (&sat)[N], float& av, int kind,
                                        float rate, int limit_on, float limit, int visit_col) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i && on_tile) L.visits[j][visit_col] += 1;
  const bool got = on_tile && av > 0.f;
  if (!got) return;
  add_rv(cur, p, G, rv, kind);
  if (p.penalise) put(sat, i, get(sat, i) + fminf(av, rate));
  if (limit_on && get(sat, i) > 0.f) put(sat, i, fminf(limit, get(sat, i)));
  av = fmaxf(0.f, av - rate);
}

// Homeostasis of one satiation: the deficiency term, then the
// oversatiation term, as counts or proportional to the satiation.
__device__ __forceinline__ void homeo(const ImParams& p, const Grp& G, const float* rv,
                                      float (&cur)[IM_MAX_D], float sat_i, float def_thresh,
                                      float over_thresh, int def_kind, int over_kind) {
  const bool deficient = sat_i < def_thresh;
  if (deficient) {
    if (p.proportional) add_rv_scaled(cur, p, G, rv, def_kind, -sat_i);
    else add_rv(cur, p, G, rv, def_kind);
  }
  if (p.penalise && sat_i > over_thresh && !deficient) {
    if (p.proportional) add_rv_scaled(cur, p, G, rv, over_kind, sat_i);
    else add_rv(cur, p, G, rv, over_kind);
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

// Whether this thread of the group stores record element e.
__device__ __forceinline__ bool stores(const Grp& G, int e) { return (e & (G.g - 1)) == G.t; }

// One full multi-agent step of one lane by its group: auto-reset, policy
// features and action draws, agent order, every agent's sub-step,
// finalize. MODE selects the policy; with POL_MLP the step's trajectory
// record goes to traj[step].
template <int N, int MODE>
__device__ __forceinline__ void im_step(const ImParams& p, const Grp& G, const ImView& V,
                                        ImLane<N>& L, int b, int step) {
  const size_t sB = static_cast<size_t>(p.B);
  const int SL = p.stat_lanes;
  const int sl = SL == 1 ? 0 : b;
  const float* rv = V.rv;

  float u_act[N], u_ord[N];
  step_draws<N>(p, G, L.key_hi, L.key_lo, L.ctr, u_act, u_ord);

  // ---- auto-reset lanes whose episode ended last step, into the layout of
  // the new episode (_pool_select: ep_idx % K after the increment)
  bool over = true;
#pragma unroll
  for (int j = 0; j < N; ++j) over = over && (L.types[j] == LAST || L.types[j] == DEAD);
  if (over && p.pool > 1) L.ep_idx += 1;
  const int li = layout_of(p, L.ep_idx);
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
    if (im_per_lane(p) && p.pool > 1) copy_table(p, G, V.own, li, b);
  }
  const uint32_t* tab = table_of(p, V, li);

  // ---- action draws (site 0), through the policy, and Fisher-Yates agent
  // order (site 1)
  const int A = p.amax - p.amin + 1;
  float x[N][IM_F];
  if (MODE != POL_UNIFORM) policy_feats<N>(p, L, x);
  float out[N][IM_MAX_A + 1];
  if (MODE == POL_MLP) {
    // The features' records first: x is then dead after the MLP.
#pragma unroll
    for (int e = 0; e < N * IM_F; ++e)
      if (stores(G, e))
        p.traj.feats[(static_cast<size_t>(step) * (N * IM_F) + e) * sB + b] = x[e / IM_F][e % IM_F];
    agw::mlp_group_buf_rows<IM_F, N, IM_MAX_A>(V.mlp, A, x, V.hbuf, G.t, G.g, G.mask, out);
  }
  int actions[N], order[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float u = u_act[j];
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
      a = p.amin + agw::mlp_sample<IM_MAX_A>(out[j], A, u, logp, value);
      if (stores(G, j)) {
        const size_t r = static_cast<size_t>(step) * N + j;
        p.traj.logp[r * sB + b] = logp;
        p.traj.value[r * sB + b] = value;
        p.traj.action[r * sB + b] = off ? -1 : a;
      }
    }
    actions[j] = off ? -1 : a;
    order[j] = j;
  }
  if (p.randomize && N > 1) {
#pragma unroll
    for (int k = N - 1; k >= 1; --k) {
      const float u = u_ord[k];
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
    for (int s = 0; s < IM_MAX_D; ++s) rew[j][s] = 0.f;

  // The sub-steps, one after another: the loop stays rolled (a sub-step's
  // code once, not N times), and the acting agent's reward row is copied
  // out of rew, takes its terms in order and goes back before the drape.
#pragma unroll 1
  for (int slot = 0; slot < N; ++slot) {
    const int i = get(order, slot);
    const int a = get(actions, i);
    if (a < 0) {
      // A non-acting sub-step only refreshes the agent's cached tile value.
      put(L.vcode, i, board_of(tab[get(L.pos, i) * IM_MOVES]));
      continue;
    }
    const bool is_quit = a == A_QUIT, is_noop = a == A_NOOP;
    const bool dead_i = get(L.reasons, i) != R_NONE;
    const bool active = !is_quit && !dead_i;
    L.t += 1;
    float cur[IM_MAX_D];
#pragma unroll
    for (int s = 0; s < IM_MAX_D; ++s) {
      cur[s] = rew[0][s];
#pragma unroll
      for (int j = 1; j < N; ++j)
        if (j == i) cur[s] = rew[j][s];
    }

    // --- direction updates, from the facings at the sub-step's start, and
    // the move's column: one composed word per (action, facing)
    const int a_cl = min(a, 9);
    const uint32_t wa = V.dirw[a_cl * IM_FACINGS + facing_col(get(L.adir, i))];
    if (p.odm != 0) {
      const uint32_t wo = V.dirw[a_cl * IM_FACINGS + facing_col(get(L.odir, i))];
      if (active) put(L.odir, i, static_cast<int>((wo >> DW_ODIR_SHIFT) & 0xFFu));
    }
    if (p.adm != 0 && active) put(L.adir, i, static_cast<int>((wa >> DW_ADIR_SHIFT) & 0xFFu));

    // --- the bounded move from the step table: the candidate, whether it
    // is in bounds and no wall, and the board values of the candidate and
    // of the cell itself; every agent's cell blocks, dead or not
    const int pos_i = get(L.pos, i);
    const uint32_t w = tab[pos_i * IM_MOVES + (wa & 0xFFu)];
    const uint32_t w_stay = tab[pos_i * IM_MOVES];
    const int cand = static_cast<int>(w & SW_CELL);
    bool occ = false;
#pragma unroll
    for (int j = 0; j < N; ++j) occ = occ || (j != i && L.pos[j] == cand);
    const bool moved = active && ((w >> SW_OK_BIT) & 1u) && !occ;
    const int np = moved ? cand : pos_i;
    put(L.pos, i, np);
    if (is_quit && !dead_i) put(L.reasons, i, static_cast<int>(R_QUIT));

    const float v_at = board_of(moved ? w : w_stay);
    put(L.vcode, i, v_at);
    float dw_at;
    const float code_at = code_of(v_at, dw_at);

    if (active && !is_noop) add_rv(cur, p, G, rv, RV_MOVE);
    if (active) put(L.safety, i, static_cast<int>(dw_at));

    // --- satiation decrements and thirst/hunger death
    if (p.penalise && active) {
      put(L.dsat, i, get(L.dsat, i) + p.drink_def_rate);
      put(L.fsat, i, get(L.fsat, i) + p.food_def_rate);
    }
    if (p.thirst_death && active &&
        (get(L.dsat, i) <= p.drink_def_limit || get(L.fsat, i) <= p.food_def_limit)) {
      add_rv(cur, p, G, rv, RV_THIRST);
      if (get(L.reasons, i) == R_NONE) put(L.reasons, i, static_cast<int>(R_TERMINATED));
    }

    // --- ultimate goal
    if (p.has_goal && active && code_at == static_cast<float>(T_GOAL)) {
      add_rv(cur, p, G, rv, RV_FINAL);
      if (get(L.reasons, i) == R_NONE) put(L.reasons, i, static_cast<int>(R_TERMINATED));
    }

    // --- drink / food with scalar availability
    if (p.has_drink) {
      const bool on_t = active && code_at == static_cast<float>(T_DRINK);
      consume<N>(p, G, rv, L, cur, i, on_t, L.dsat, L.dav, RV_DRINK, p.drink_rate,
                 p.drink_limit_on, p.drink_over_limit, 1);
      if (active && !on_t) add_rv(cur, p, G, rv, RV_NON_DRINK);
    }
    if (p.has_food) {
      const bool on_t = active && code_at == static_cast<float>(T_FOOD);
      consume<N>(p, G, rv, L, cur, i, on_t, L.fsat, L.fav, RV_FOOD, p.food_rate,
                 p.food_limit_on, p.food_over_limit, 2);
      if (active && !on_t) add_rv(cur, p, G, rv, RV_NON_FOOD);
    }
    if (p.has_gold && active && code_at == static_cast<float>(T_GOLD)) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) L.visits[j][3] += 1;
      add_rv(cur, p, G, rv, RV_GOLD);
    }
    if (p.has_silver && active && code_at == static_cast<float>(T_SILVER)) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) L.visits[j][4] += 1;
      add_rv(cur, p, G, rv, RV_SILVER);
    }

    // --- gap visit: the positions after the move
    bool others = false;
#pragma unroll
    for (int j = 0; j < N; ++j) others = others || (j != i && L.pos[j] == np);
    if (active && !others && code_at == static_cast<float>(T_GAP)) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == i) L.visits[j][0] += 1;
      add_rv(cur, p, G, rv, RV_GAP);
    }

    // --- homeostasis thresholds
    if (active && p.has_drink)
      homeo(p, G, rv, cur, get(L.dsat, i), p.drink_def_thresh, p.drink_over_thresh,
            RV_DRINK_DEF, RV_DRINK_OVER);
    if (active && p.has_food)
      homeo(p, G, rv, cur, get(L.fsat, i), p.food_def_thresh, p.food_over_thresh, RV_FOOD_DEF,
            RV_FOOD_OVER);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j == i) {
#pragma unroll
        for (int s = 0; s < IM_MAX_D; ++s) rew[j][s] = cur[s];
      }

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
          add_rv(rew[j], p, G, rv, RV_DANGER);
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
    for (int s = 0; s < IM_MAX_D; ++s) {
      if (s >= G.slots) break;
      if (owns(p, G, s)) {
        float* st = V.stats + j * p.D + G.t + G.g * s;
        *st = *st + rew[j][s];
      }
    }
  L.ctr += 1u;

  if (MODE == POL_MLP) {
    // Each agent's reward summed over the reward dims in ascending order;
    // a group's owners first write their dims to the lane's buffer (read
    // before the next step's MLP syncs the group); done flags.
    if (p.group > 1) {
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int s = 0; s < IM_MAX_D / 2; ++s) {
          if (s >= G.slots) break;
          if (owns(p, G, s)) V.rbuf[j * p.D + G.t + G.g * s] = rew[j][s];
        }
      __syncwarp(G.mask);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float r = rew[j][0];
      if (p.group == 1) {
#pragma unroll
        for (int d = 1; d < IM_MAX_D; ++d)
          if (d < p.D) r = r + rew[j][d];
      } else if (stores(G, j)) {
        r = V.rbuf[j * p.D];
        for (int d = 1; d < p.D; ++d) r = r + V.rbuf[j * p.D + d];
      }
      if (stores(G, j)) {
        const size_t row = static_cast<size_t>(step) * N + j;
        p.traj.reward[row * sB + b] = r;
        p.traj.done[row * sB + b] = L.types[j] == LAST || L.types[j] == DEAD;
      }
    }
  }
}

// Where a thread sits: thread G.t of its lane group, which is group
// (tx mod 32) / g of its warp; a block of blockDim.x threads runs
// blockDim.x / g lanes. Sets the group, the lane's index in its block and
// its batch index, and returns whether the thread has a lane.
__device__ __forceinline__ bool seat(const ImParams& p, Grp& G, int& lane_blk, int& b) {
  const int wl = threadIdx.x & 31, g = p.group;
  const int grp = wl / g;
  G.t = wl & (g - 1);
  G.g = g;
  G.slots = (p.D + g - 1) / g;
  G.mask = g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (grp * g);
  lane_blk = threadIdx.x / g;
  b = blockIdx.x * (blockDim.x / g) + lane_blk;
  return b < p.B;
}

// The block's shared tables, by all its threads: the reward vectors, the
// direction words, the pool's shared step tables and K7's MLP weights.
__device__ __forceinline__ void block_setup(const ImParams& p, const ImSmem& s, uint32_t* sm,
                                            int hidden) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* f = reinterpret_cast<float*>(sm);
  for (int i = tid; i < IM_N_RV * IM_MAX_D; i += nt) f[s.rv + i] = p.rv[i / IM_MAX_D][i % IM_MAX_D];
  for (int i = tid; i < IM_ACTIONS * IM_FACINGS; i += nt)
    sm[s.dirw + i] = p.dir_word[i / IM_FACINGS][i % IM_FACINGS];
  if (!im_per_lane(p)) {
    const int tw = p.HW * IM_MOVES;
    for (int k = 0; k < p.pool; ++k)
      for (int i = tid; i < tw; i += nt) sm[s.tables + k * tw + i] = p.steps[k][i];
  }
  if (hidden) {
    const int H = hidden, A = p.amax - p.amin + 1, n_w1 = H * IM_F;
    float* w = f + s.weights;
    for (int i = tid; i < n_w1; i += nt) w[i] = p.mlp_w1[i];
    for (int i = tid; i < H; i += nt) w[n_w1 + i] = p.mlp_b1[i];
    for (int i = tid; i < (A + 1) * H; i += nt)
      w[n_w1 + H + (i / H) * (H + 1) + i % H] = p.mlp_w2[i];
    for (int i = tid; i <= A; i += nt) w[n_w1 + H + (A + 1) * (H + 1) + i] = p.mlp_b2[i];
  }
  __syncthreads();
}

// The lane's view of shared memory.
template <int N>
__device__ __forceinline__ ImView lane_view(const ImParams& p, const ImSmem& s, uint32_t* sm,
                                            int lane_blk, int hidden) {
  ImView V;
  float* f = reinterpret_cast<float*>(sm);
  const int H = hidden, A = p.amax - p.amin + 1;
  V.rv = f + s.rv;
  V.dirw = sm + s.dirw;
  V.tables = sm + s.tables;
  V.own = sm + s.tables + lane_blk * im_lane_table(p);
  V.stats = f + s.lanes + lane_blk * s.per_lane;
  V.hbuf = V.stats + N * p.D;
  V.rbuf = V.hbuf + N * (H + 1 + A + 1);
  const float* w = f + s.weights;
  V.mlp = agw::Mlp{w, w + H * IM_F, w + H * IM_F + H, w + H * IM_F + H + (A + 1) * (H + 1), H};
  return V;
}

// K6: n_steps steps of every lane, uniform or linear-policy actions.
template <int N, int MODE>
__global__ void __launch_bounds__(256) im_rollout_kernel(const __grid_constant__ ImParams p) {
  extern __shared__ uint32_t sm[];
  const ImSmem s = im_smem(p, N, blockDim.x / p.group, 0);
  block_setup(p, s, sm, 0);
  Grp G;
  int lane_blk, b;
  if (!seat(p, G, lane_blk, b)) return;
  const ImView V = lane_view<N>(p, s, sm, lane_blk, 0);
  ImLane<N> L;
  load_lane<N>(p, G, V, b, L);
  if (im_per_lane(p)) copy_table(p, G, V.own, layout_of(p, L.ep_idx), b);
  for (int step = 0; step < p.n_steps; ++step) im_step<N, MODE>(p, G, V, L, b, step);
  store_lane<N>(p, G, V, b, L);
}

// K7: n_steps MLP-policy steps of every lane with the trajectory streamed
// out, then the bootstrap value of the final state (no auto-reset).
template <int N>
__global__ void __launch_bounds__(256) im_collect_kernel(const __grid_constant__ ImParams p) {
  extern __shared__ uint32_t sm[];
  const ImSmem s = im_smem(p, N, blockDim.x / p.group, p.hidden);
  block_setup(p, s, sm, p.hidden);
  Grp G;
  int lane_blk, b;
  if (!seat(p, G, lane_blk, b)) return;
  const ImView V = lane_view<N>(p, s, sm, lane_blk, p.hidden);
  ImLane<N> L;
  load_lane<N>(p, G, V, b, L);
  if (im_per_lane(p)) copy_table(p, G, V.own, layout_of(p, L.ep_idx), b);
  for (int step = 0; step < p.n_steps; ++step) im_step<N, POL_MLP>(p, G, V, L, b, step);
  const int A = p.amax - p.amin + 1;
  float x[N][IM_F], out[N][IM_MAX_A + 1];
  policy_feats<N>(p, L, x);
  agw::mlp_group_buf_rows<IM_F, N, IM_MAX_A>(V.mlp, A, x, V.hbuf, G.t, G.g, G.mask, out);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float v = out[j][0];
#pragma unroll
    for (int a = 1; a <= IM_MAX_A; ++a)
      if (a == A) v = out[j][a];
    if (stores(G, j)) p.traj.boot[j * p.B + b] = v;
  }
  store_lane<N>(p, G, V, b, L);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, const ImParams& p, int tile, size_t smem,
                          cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int lanes = tile / p.group;
  const int blocks = (p.B + lanes - 1) / lanes;
  kernel<<<blocks, tile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_rollout(const ImParams& p, int tile, cudaStream_t s) {
  const size_t smem = 4 * static_cast<size_t>(im_smem(p, N, tile / p.group, 0).words);
  return p.pol_w ? launch(im_rollout_kernel<N, POL_LINEAR>, p, tile, smem, s)
                 : launch(im_rollout_kernel<N, POL_UNIFORM>, p, tile, smem, s);
}

template <int N>
static cudaError_t launch_collect(const ImParams& p, int tile, cudaStream_t s) {
  const size_t smem = 4 * static_cast<size_t>(im_smem(p, N, tile / p.group, p.hidden).words);
  return launch(im_collect_kernel<N>, p, tile, smem, s);
}

// The shape limits, and the block: tile threads, a multiple of 32 in
// [32, 256], in lane groups of a power of two threads.
static bool valid(const ImParams* p, int tile) {
  const int g = p->group;
  return p->D >= 1 && p->D <= IM_MAX_D && p->pool >= 1 && p->pool <= IM_MAX_POOL &&
         p->amin >= 0 && p->amax <= 9 && p->amax - p->amin + 1 <= IM_MAX_A && p->HW >= 1 &&
         p->HW <= IM_MAX_HW && (p->stat_lanes == 1 || p->stat_lanes == p->B) && g >= 1 &&
         g <= 32 && (g & (g - 1)) == 0 && tile % 32 == 0 && tile >= 32 && tile <= 256;
}

extern "C" int fused_island_ma_rollout(const ImParams* p, int n_agents, int tile,
                                       void* stream) {
  if (p->n_steps <= 0 || p->B <= 0) return 0;
  if (!valid(p, tile)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (!valid(p, tile) || p->hidden < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_agents) {
    case 1: return static_cast<int>(launch_collect<1>(*p, tile, s));
    case 2: return static_cast<int>(launch_collect<2>(*p, tile, s));
    case 3: return static_cast<int>(launch_collect<3>(*p, tile, s));
    case 4: return static_cast<int>(launch_collect<4>(*p, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
