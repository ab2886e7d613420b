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
// Design. A lane group of g threads runs each lane (g = p.group, a power of
// two from 1 to 32; p.lanes_per_warp groups in each warp, at most 32 / g, the
// other threads idle), `tile` threads per block.
// * The lane's scalar fields -- positions, reasons, step types, facings,
//   step counts, satiations, visits, safety distances, availabilities, t,
//   key, draw counter, episode counter, reward sums -- live in registers for
//   the whole call and are group-uniform: every thread of the group holds
//   them and runs the scalar part of the step redundantly, so the group
//   takes every branch together. Thread 0 of the group writes them back and
//   writes K9's records. Each reward sum is formed by one thread (every
//   thread forms the same one) in the plain version's order.
// * The lane's boards live in the block's shared memory for the whole call,
//   loaded from column b of the state (or of the layout's statics) at the
//   start and stored once at the end: the predator curtain, the wall board
//   and the resource curtains under sustainability as bytes, the
//   code/distance board as 16-bit integers (code + 16 * distance, at most
//   8 + 16 * 99), and a score word per cell for the drapes. Every value a
//   state can hold there is an exact small integer (the CPU tests check
//   every state the plain version reaches), so the bytes store and load it
//   exactly. The per-episode reset copies the layout's boards group-parallel.
// * Group thread t owns cells c = t (mod g): each per-cell pass runs over
//   its own cells, and a group minimum or sum (a butterfly of
//   __shfl_xor_sync over the group's own mask, so groups of one warp may
//   diverge) joins the threads. The threads of a group need not run in
//   step, so a pass that writes cells other threads read runs between two
//   __syncwarp of the group's mask (or a group reduction in their place):
//   one after their last reads, one before their next.
// * A drape counts its curtain (a group sum: the curtain holds only 0 and
//   1); where it has tiles to remove or spawn, each thread hashes its own
//   cells once into their removal or spawn scores, each of the at most
//   res_k picks of the cutoff tau is the group minimum of the per-thread
//   minima above the previous pick, stopping at the first invalid pick
//   (every later one is invalid too), and each thread flips its own cells
//   with score <= tau. The scores are distinct integers, so the picked set
//   is the plain version's.
// * The redraw takes "the smallest score above the previous pick" T times,
//   each a group minimum; the scores ((bits >> (ib + 3)) << ib) | cell are
//   distinct within a lane, so this equals JAX's chain of T masked minima.
//   Each pick's cell is written by its owner; a water pick's distance pass
//   runs over every thread's own cells.
// * The predator walk marks each predator that draws a move with 10 + its
//   direction, then runs the four direction passes in order. Each pass
//   first marks its movers (20) against the board as it stood before the
//   pass, then moves them all. Each phase is free of order between cells,
//   so the group's threads run it in parallel: a mover's target was empty
//   before the pass (a mark reads as occupied, so a target read while its
//   owner marks it reads occupied either way), movers of one direction have
//   distinct sources and so distinct targets, and a target, empty before
//   the pass, is no mover. A __syncwarp separates the phases.
// * The predator safety distance is a group minimum of Manhattan
//   distances.
// * K9's MLP runs across the group: thread t forms hidden units k = t
//   (mod g), each bias first and features ascending, and passes them
//   around the group in ascending order by __shfl_sync; thread a mod g sums
//   output row a, bias first and hidden units ascending, as mlp_draw does
//   (policy.cuh, mlp_group_rows).
// The group size is a runtime field, not a template parameter: one
// instantiation per (N, MODE) serves every g, so the build stays at 12
// kernels. fused_savanna.py::_lanes_per_group picks g from the batch and
// from the configuration's per-cell work.
//
// K8 and K9 share one step body, sv_step<N, MODE>, instantiated for N = 1..4
// agents and the uniform, linear (K8) and MLP (K9) policy modes; the feature
// gates are runtime flags of the parameter block. The linear policy and the
// MLP come from policy.cuh, the PRF from prng.cuh.
//
// Bound. A lane-step is a few hundred operations for the draws and each
// acting sub-step, plus per-cell passes where a feature needs them: HW
// hashes per drape, a compare per cell and pick, HW hashes and a few board
// passes per walk, T x HW hashes per redraw. The boards stay on chip, so a
// call moves little more than its state. The kernels are bound by each
// lane's serial chain of dependent operations: the group shortens the
// per-cell part of it by g and runs g times as many warps.
//
// Exactness. The kernels add each reward term to its row in the plain
// version's order, only where its condition holds (the plain version's
// masked add gives the same bits), skip the terms whose vector is all zero,
// and take every float operation of the plain step one by one; the library
// is built with --fmad=false. Every per-cell result is an integer, so the
// order of a group reduction does not matter; the float paths (regrowth,
// gold and silver, the MLP's units and rows) run on one thread in the
// plain version's order. Regrowth computes expf(e * logf(av + 1)), the
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
  // The lane group: threads per lane (a power of two, 1..32) and groups per
  // warp (at most 32 / group).
  int group, lanes_per_warp;
  SvTraj traj;
};

extern "C" int sv_params_size() { return static_cast<int>(sizeof(SvParams)); }

// The lane's boards in the block's shared memory: bytes for the predator
// curtain (and the walk's marks), the wall board and the sustainability
// curtains, 16-bit words for the code/distance board, and with a
// tile-spawning drape a score word per cell. HWP rounds HW up to 4 bytes;
// a lane's share is an odd number of words, so that the lanes of a warp
// reading one cell hit distinct banks.
__host__ __device__ __forceinline__ int sv_hwp(int HW) { return (HW + 3) & ~3; }

__host__ __device__ __forceinline__ int sv_n_curtains(const SvParams& p) {
  int n = 0;
  for (int r = 0; r < 4; ++r) n += p.sustain && p.res_on[r];
  return n;
}

__host__ __device__ __forceinline__ bool sv_drapes(const SvParams& p) {
  bool any = false;
  for (int r = 0; r < 4; ++r) any = any || (p.sustain && p.res_on[r] && !p.res_metric[r]);
  return any;
}

__host__ __device__ __forceinline__ int sv_lane_words(const SvParams& p) {
  const int hwp = sv_hwp(p.HW);
  const int bytes = hwp * (2 + sv_n_curtains(p)) + 2 * hwp + (sv_drapes(p) ? 4 * p.HW : 0);
  return (bytes / 4) | 1;
}

extern "C" int sv_lane_bytes(const SvParams* p) { return 4 * sv_lane_words(*p); }

struct SvBoards {
  unsigned char* pred;    // 0/1; inside the walk also 10 + d and 20
  unsigned char* wall;    // 0/1
  unsigned char* res[4];  // 0/1, null where off
  unsigned short* code;   // code + 16 * water distance
  int* score;             // drape scores, null without a tile-spawning drape
};

__device__ __forceinline__ SvBoards lane_boards(const SvParams& p, uint32_t* base) {
  const int hwp = sv_hwp(p.HW);
  unsigned char* bytes = reinterpret_cast<unsigned char*>(base);
  SvBoards s;
  s.pred = bytes;
  s.wall = bytes + hwp;
  int k = 2;
  for (int r = 0; r < 4; ++r) s.res[r] = (p.sustain && p.res_on[r]) ? bytes + hwp * k++ : nullptr;
  s.code = reinterpret_cast<unsigned short*>(bytes + hwp * k);
  s.score = sv_drapes(p) ? reinterpret_cast<int*>(bytes + hwp * k + 2 * hwp) : nullptr;
  return s;
}

// A lane group: this thread's index t in it, its size g and its threads'
// mask in the warp. Its shuffles name only its own threads, so the groups
// of a warp may take different branches.
struct Grp {
  int t, g;
  unsigned mask;
};

__device__ __forceinline__ int grp_min(const Grp& G, int v) {
  for (int k = 1; k < G.g; k <<= 1) v = min(v, __shfl_xor_sync(G.mask, v, k, G.g));
  return v;
}

__device__ __forceinline__ int grp_sum(const Grp& G, int v) {
  for (int k = 1; k < G.g; k <<= 1) v += __shfl_xor_sync(G.mask, v, k, G.g);
  return v;
}

__device__ __forceinline__ void grp_sync(const Grp& G) { __syncwarp(G.mask); }

// The owner of cell c in its group.
__device__ __forceinline__ bool owns(const Grp& G, int c) { return (c & (G.g - 1)) == G.t; }

// The lane's layout under a layout pool (_pool_select: ep_idx % K).
__device__ __forceinline__ int layout_of(const SvParams& p, int ep_idx) {
  return p.pool > 1 ? ((ep_idx % p.pool) + p.pool) % p.pool : 0;
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

// The lane's scalars, on every thread of its group, and its boards, each
// cell by its owner, into shared memory.
template <int N>
__device__ __forceinline__ void load_lane(const SvParams& p, const Grp& G, const SvBoards& s,
                                          int b, SvLane<N>& L) {
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
  // Under exact_reset the wall and code boards are the lane's own state;
  // otherwise its current layout's statics.
  const int li = layout_of(p, L.ep_idx);
  const float* wall = p.exact_reset ? p.in.wall : p.wall[li];
  const float* sboard = p.exact_reset ? p.in.sboard : p.sboard[li];
  for (int c = G.t; c < p.HW; c += G.g) {
    const size_t cb = c * B + b;
    s.pred[c] = p.in.predator[cb] > 0.5f;
    s.wall[c] = wall[cb] > 0.5f;
    s.code[c] = static_cast<unsigned short>(sboard[cb]);
    for (int r = 0; r < 4; ++r)
      if (s.res[r]) s.res[r][c] = p.in.res[r][cb] > 0.5f;
  }
  grp_sync(G);
}

// The lane's scalars by thread 0 of its group, its boards by their owners.
template <int N>
__device__ __forceinline__ void store_lane(const SvParams& p, const Grp& G, const SvBoards& s,
                                           int b, const SvLane<N>& L) {
  const size_t B = static_cast<size_t>(p.B);
  for (int c = G.t; c < p.HW; c += G.g) {
    const size_t cb = c * B + b;
    p.out.predator[cb] = static_cast<float>(s.pred[c]);
    if (p.exact_reset) {
      p.out.wall[cb] = static_cast<float>(s.wall[c]);
      p.out.sboard[cb] = static_cast<float>(s.code[c]);
    }
    for (int r = 0; r < 4; ++r)
      if (s.res[r]) p.out.res[r][cb] = static_cast<float>(s.res[r][c]);
  }
  if (G.t != 0) return;
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
// from the redraw site's words, written to the lane's boards; returns the
// agents' starts. Each pick is a group minimum over the threads' own
// interior cells.
__device__ __noinline__ Pos4 redraw(const SvParams& p, Grp G, SvBoards s,
                                    uint32_t key_hi, uint32_t key_lo, uint32_t ctr0) {
  Pos4 starts;
  const int ib = p.idx_bits;
  const int idx_mask = (1 << ib) - 1;
  const uint32_t site = ctr0 + static_cast<uint32_t>(p.redraw_site);
  grp_sync(G);  // the last step's reads of other threads' cells are done
  for (int c = G.t; c < p.HW; c += G.g) {
    s.wall[c] = is_border(p, c);
    s.code[c] = 16 * 99;  // code 0, water distance 99
    s.pred[c] = 0;
    for (int r = 0; r < 4; ++r)
      if (s.res[r]) s.res[r][c] = 0;
  }
  int prev = -1;
  for (int k = 0; k < p.T; ++k) {
    int m = SENT;
    for (int c = G.t; c < p.HW; c += G.g) {
      if (is_border(p, c)) continue;
      const uint32_t bits = agw::hash_u32(key_hi, key_lo, site, static_cast<uint32_t>(c));
      const int sc = static_cast<int>(((bits >> (ib + 3)) << ib) | static_cast<uint32_t>(c));
      if (sc > prev && sc < m) m = sc;
    }
    m = grp_min(G, m);
    prev = m;
    const int pc = m & idx_mask;
    const bool mine = owns(G, pc);
    const int kind = p.spec[k];
    if (kind >= SPEC_AGENT) {
      starts.c[(kind - SPEC_AGENT) & (SV_MAX_N - 1)] = pc;
    } else if (kind == SPEC_WATER) {
      // The water distance min-updates every cell; the codes stay.
      const int pr = pc / p.W, pcol = pc - (pc / p.W) * p.W;
      for (int c = G.t; c < p.HW; c += G.g) {
        const int v = s.code[c];
        const int r = c / p.W, col = c - (c / p.W) * p.W;
        const int d = min(v >> 4, abs(r - pr) + abs(col - pcol));
        s.code[c] = static_cast<unsigned short>((v & 15) + 16 * d);
      }
      if (mine) s.code[pc] = static_cast<unsigned short>(s.code[pc] + T_WATER);
    } else if (mine) {
      const bool res = kind >= SPEC_RES && kind < SPEC_RES + 4;
      if (kind == SPEC_PREDATOR) {
        s.pred[pc] = 1;
      } else if (kind == SPEC_WALL) {
        s.wall[pc] = 1;
      } else if (res && s.res[kind - SPEC_RES]) {
        s.res[kind - SPEC_RES][pc] = 1;
      } else {  // the static resource codes, gold, silver
        const int code = res ? p.res_code[kind - SPEC_RES] : kind == SPEC_GOLD ? T_GOLD : T_SILVER;
        s.code[pc] = static_cast<unsigned short>(s.code[pc] + code);
      }
    }
  }
  grp_sync(G);
  return starts;
}

// The per-episode reset into layout li (no redraw): the layout's boards,
// group-parallel.
__device__ __noinline__ void reset_boards(const SvParams& p, Grp G, SvBoards s, int b, int li) {
  const size_t B = static_cast<size_t>(p.B);
  grp_sync(G);  // the last step's reads of other threads' cells are done
  for (int c = G.t; c < p.HW; c += G.g) {
    const size_t cb = c * B + b;
    s.pred[c] = p.predator0[li][cb] > 0.5f;
    s.wall[c] = p.wall[li][cb] > 0.5f;
    s.code[c] = static_cast<unsigned short>(p.sboard[li][cb]);
    for (int r = 0; r < 4; ++r)
      if (s.res[r]) s.res[r][c] = p.res0[li][r][cb] > 0.5f;
  }
  grp_sync(G);
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

// The predator walk of one acting sub-step at the round's last agent, each
// phase over the threads' own cells (the design note above says why each
// phase is free of order between cells).
__device__ __noinline__ void predator_walk(const SvParams& p, Grp G, SvBoards s, uint32_t key_hi,
                                           uint32_t key_lo, uint32_t site, Pos4 q) {
  unsigned char* pred = s.pred;
  grp_sync(G);  // the sub-step's reads of other threads' cells are done
  // Each predator that draws a move (off the agents' cells) is marked
  // 10 + its direction.
  for (int c = G.t; c < p.HW; c += G.g) {
    if (!pred[c] || on_player(q, c)) continue;
    const uint32_t bits = agw::hash_u32(key_hi, key_lo, site, static_cast<uint32_t>(c));
    if (agw::uniform01(bits) < p.pred_move_p)
      pred[c] = static_cast<unsigned char>(10 + 1 + (bits & 3u));
  }
  grp_sync(G);
  for (int d = 1; d <= 4; ++d) {
    const int sh = p.delta[d];
    const unsigned char mark = static_cast<unsigned char>(10 + d);
    // Movers of this pass, against the board as it stood before it. The
    // target's owner may be marking it 20 meanwhile: it reads occupied
    // either way.
    for (int c = G.t; c < p.HW; c += G.g) {
      if (pred[c] != mark) continue;
      int tc = c + sh;
      if (tc < 0) tc += p.HW;
      if (tc >= p.HW) tc -= p.HW;
      const unsigned char at = *static_cast<volatile unsigned char*>(pred + tc);
      if (!at && !s.wall[tc]) pred[c] = 20;
    }
    grp_sync(G);
    for (int c = G.t; c < p.HW; c += G.g) {
      if (pred[c] != 20) continue;
      int tc = c + sh;
      if (tc < 0) tc += p.HW;
      if (tc >= p.HW) tc -= p.HW;
      pred[c] = 0;
      pred[tc] = 1;
    }
    grp_sync(G);
  }
  for (int c = G.t; c < p.HW; c += G.g)
    if (pred[c]) pred[c] = 1;
  grp_sync(G);
}

// A drape candidate's score from its rank part: removal takes curtain cells
// (players' cells last), spawn takes free cells off the walls and the
// players.
__device__ __forceinline__ int drape_score(const Pos4& q, bool removing, bool cur, bool wall,
                                           int base, int c) {
  const bool player = on_player(q, c);
  if (removing) return cur ? base + (player ? OFF_PLAYER : 0) : SENT;
  return (!cur && !wall && !player) ? base : SENT;
}

// One resource drape of an acting sub-step: regrowth, then the removal or
// spawn of tiles toward the ceiling of the availability. Returns the new
// availability.
__device__ __noinline__ float drape(const SvParams& p, Grp G, SvBoards s, int r,
                                    float usable_half, uint32_t key_hi, uint32_t key_lo,
                                    uint32_t site, int t, float av, Pos4 q) {
  unsigned char* cur = s.res[r];
  bool on_any = false;
#pragma unroll
  for (int j = 0; j < SV_MAX_N; ++j) on_any = on_any || (q.c[j] >= 0 && cur[q.c[j]]);
  const bool can_grow = t > 0 && !on_any && av >= 1.f && av < p.res_cond[r];
  float av_new = av;
  if (can_grow) {
    const float grown = fminf(expf(p.regrowth_exponent * logf(av + 1.0f)), p.res_growth[r]);
    av_new = fminf(grown, usable_half);
  }
  if (p.res_metric[r]) return av_new;
  const float av_int = ceilf(av_new);
  // The curtain's count: a group sum, as it holds only 0 and 1.
  int n_on = 0;
  for (int c = G.t; c < p.HW; c += G.g) n_on += cur[c];
  const float current = static_cast<float>(grp_sum(G, n_on));
  const float need = fmaxf(current - av_int, 0.f);
  const float grow = fmaxf(av_int - current, 0.f);
  const bool removing = need > 0.5f;
  float count = removing ? need : grow;
  if (!(count > 0.5f)) return av_new;
  const int thresh = removing ? SENT : OFF_PLAYER;
  // Each cell hashed once, into its score.
  int* sc = s.score;
  for (int c = G.t; c < p.HW; c += G.g) {
    const uint32_t bits = agw::hash_u32(key_hi, key_lo, site, static_cast<uint32_t>(c));
    const int rank = static_cast<int>(((bits >> 12) << 9) | static_cast<uint32_t>(c));
    sc[c] = drape_score(q, removing, cur[c], s.wall[c], rank, c);
  }
  int tau = -1, prev = -1;
  for (int it = 0; it < p.res_k[r] && count > 0.5f; ++it) {
    int m = SENT;
    for (int c = G.t; c < p.HW; c += G.g) {
      const int v = sc[c];
      if (v > prev && v < m) m = v;
    }
    m = grp_min(G, m);
    if (!(m < thresh)) break;
    tau = m;
    prev = m;
    count = count - 1.f;
  }
  if (tau < 0) return av_new;
  const unsigned char now = removing ? 0 : 1;
  for (int c = G.t; c < p.HW; c += G.g)
    if (sc[c] <= tau) cur[c] = now;
  grp_sync(G);
  return av_new;
}

// One full multi-agent step of one lane: auto-reset, policy features and
// action draws, agent order, every agent's sub-step, finalize. MODE selects
// the policy; with POL_MLP the step's trajectory record goes to traj[step].
template <int N, int MODE>
__device__ __forceinline__ void sv_step(const SvParams& p, const Grp& G, const SvBoards& s,
                                        SvLane<N>& L, int b, const agw::Mlp& mlp, int step) {
  const size_t B = static_cast<size_t>(p.B);
  const uint32_t ctr0 = L.ctr * static_cast<uint32_t>(p.n_sites);

  // ---- auto-reset lanes whose episode ended last step: the redraw, or
  // the layout of the new episode (_pool_select: ep_idx % K after the
  // increment)
  bool over = true;
#pragma unroll
  for (int j = 0; j < N; ++j) over = over && (L.types[j] == LAST || L.types[j] == DEAD);
  if (over && p.pool > 1) L.ep_idx += 1;
  const int li = layout_of(p, L.ep_idx);
  if (over) {
    if (p.exact_reset) {
      const Pos4 starts = redraw(p, G, s, L.key_hi, L.key_lo, ctr0);
#pragma unroll
      for (int j = 0; j < N; ++j) L.pos[j] = starts.c[j];
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) L.pos[j] = p.pos0[li][j * B + b];
      reset_boards(p, G, s, b, li);
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
      a = p.amin + agw::mlp_group_draw<SV_F, SV_MAX_A>(mlp, A, x[j], u, G.t, G.g, G.mask, logp,
                                                        value);
      if (G.t == 0) {
        const size_t r = static_cast<size_t>(step) * N + j;
#pragma unroll
        for (int f = 0; f < SV_F; ++f)
          p.traj.feats[(static_cast<size_t>(step) * (N * SV_F) + j * SV_F + f) * B + b] = x[j][f];
        p.traj.logp[r * B + b] = logp;
        p.traj.value[r * B + b] = value;
        p.traj.action[r * B + b] = off ? -1 : a;
      }
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
    const bool wall_at = s.wall[cand];
    const bool moved = active && !is_noop && !wall_at && !occ;
    const int np = moved ? cand : pos_i;
    put(L.pos, i, np);
    if (active) put(L.adir, i, nad);
    if (active || (is_quit && !dead_i)) put(L.count, i, get(L.count, i) + 1);
    if (is_quit && !dead_i) put(L.reasons, i, static_cast<int>(R_QUIT));
    if (active && !is_noop) add_rv<N>(rew, p, i, RV_MOVE);

    // --- decode the combined board at the new position
    const float v_at = static_cast<float>(s.code[np]);
    const float dw_at = floorf(v_at * (1.0f / 16.0f));
    const float code_at = v_at - 16.0f * dw_at;
    const bool pred_at = s.pred[np];
    bool on_res[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) on_res[r] = s.res[r] && s.res[r][np];

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

    // --- safety distances: water from the board, predators by a group
    // minimum
    if (p.has_water && active) put(L.safety, i, static_cast<int>(dw_at));
    if (p.has_predators && active) {
      const int nr = np / p.W, nc = np - (np / p.W) * p.W;
      int dmin = 9999;
      for (int c = G.t; c < p.HW; c += G.g) {
        if (!s.pred[c]) continue;
        const int r = c / p.W, col = c - (c / p.W) * p.W;
        dmin = min(dmin, abs(r - nr) + abs(col - nc));
      }
      dmin = grp_min(G, dmin);
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
        predator_walk(p, G, s, L.key_hi, L.key_lo, slot_site, pos4<N>(L.pos));
        if (active && !pred_at && s.pred[np]) add_rv<N>(rew, p, i, RV_PREDATOR);
      }
    }

    // --- resource drapes
    if (p.sustain) {
      const Pos4 q = pos4<N>(L.pos);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (p.res_on[r])
          L.avail[r] = drape(p, G, s, r, usable_half, L.key_hi, L.key_lo,
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

  if (MODE == POL_MLP && G.t == 0) {
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

// Where a thread sits: thread G.t of its lane group, which is group
// (tx mod 32) / g of its warp; lanes_per_warp groups of each warp run a
// lane, so a block of tile threads runs tile / 32 * lanes_per_warp lanes.
// Sets the group, the lane's index in its block and its batch index, and
// returns whether the thread has a lane.
__device__ __forceinline__ bool seat(const SvParams& p, Grp& G, int& lane_blk, int& b) {
  const int wl = threadIdx.x & 31, g = p.group;
  const int grp = wl / g;
  G.t = wl & (g - 1);
  G.g = g;
  G.mask = g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (grp * g);
  lane_blk = (threadIdx.x >> 5) * p.lanes_per_warp + grp;
  b = blockIdx.x * ((blockDim.x >> 5) * p.lanes_per_warp) + lane_blk;
  return grp < p.lanes_per_warp && b < p.B;
}

// K8: n_steps steps of every lane, uniform or linear-policy actions.
template <int N, int MODE>
__global__ void __launch_bounds__(256) sv_rollout_kernel(const __grid_constant__ SvParams p) {
  extern __shared__ float smem[];
  Grp G;
  int lane_blk, b;
  if (!seat(p, G, lane_blk, b)) return;
  const SvBoards s =
      lane_boards(p, reinterpret_cast<uint32_t*>(smem) + lane_blk * sv_lane_words(p));
  SvLane<N> L;
  load_lane<N>(p, G, s, b, L);
  const agw::Mlp no_mlp{nullptr, nullptr, nullptr, nullptr, 0};
  for (int step = 0; step < p.n_steps; ++step) sv_step<N, MODE>(p, G, s, L, b, no_mlp, step);
  store_lane<N>(p, G, s, b, L);
}

// K9: n_steps MLP-policy steps of every lane with the trajectory streamed
// out, then the bootstrap value of the final state (no auto-reset).
template <int N>
__global__ void __launch_bounds__(256) sv_collect_kernel(const __grid_constant__ SvParams p) {
  extern __shared__ float smem[];
  const int n_threads = blockDim.x;
  const int tx = threadIdx.x;
  const int H = p.hidden, A = p.amax - p.amin + 1;
  const int n_w1 = H * SV_F, n_w2 = (A + 1) * H;
  float* w = smem;  // w1 [H*F], b1 [H], w2 [(A+1)*H], b2 [A+1], then the lanes' boards
  for (int k = tx; k < n_w1; k += n_threads) w[k] = p.mlp_w1[k];
  for (int k = tx; k < H; k += n_threads) w[n_w1 + k] = p.mlp_b1[k];
  for (int k = tx; k < n_w2; k += n_threads) w[n_w1 + H + k] = p.mlp_w2[k];
  for (int k = tx; k <= A; k += n_threads) w[n_w1 + H + n_w2 + k] = p.mlp_b2[k];
  __syncthreads();
  Grp G;
  int lane_blk, b;
  if (!seat(p, G, lane_blk, b)) return;
  const agw::Mlp mlp{w, w + n_w1, w + n_w1 + H, w + n_w1 + H + n_w2, H};
  const SvBoards s = lane_boards(
      p, reinterpret_cast<uint32_t*>(w + n_w1 + H + n_w2 + A + 1) + lane_blk * sv_lane_words(p));

  SvLane<N> L;
  load_lane<N>(p, G, s, b, L);
  for (int step = 0; step < p.n_steps; ++step) sv_step<N, POL_MLP>(p, G, s, L, b, mlp, step);
  float x[N][SV_F];
  policy_feats<N>(p, L, x);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float v = agw::mlp_group_value<SV_F, SV_MAX_A>(mlp, A, x[j], G.t, G.g, G.mask);
    if (G.t == 0) p.traj.boot[j * p.B + b] = v;
  }
  store_lane<N>(p, G, s, b, L);
}

// The lanes' boards of a block of tile threads.
static size_t board_bytes(const SvParams& p, int tile) {
  return 4 * static_cast<size_t>(sv_lane_words(p)) * (tile / 32 * p.lanes_per_warp);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, const SvParams& p, int tile, size_t smem,
                          cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int lanes = tile / 32 * p.lanes_per_warp;
  const int blocks = (p.B + lanes - 1) / lanes;
  kernel<<<blocks, tile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_rollout(const SvParams& p, int tile, cudaStream_t s) {
  const size_t smem = board_bytes(p, tile);
  return p.pol_w ? launch(sv_rollout_kernel<N, POL_LINEAR>, p, tile, smem, s)
                 : launch(sv_rollout_kernel<N, POL_UNIFORM>, p, tile, smem, s);
}

template <int N>
static cudaError_t launch_collect(const SvParams& p, int tile, cudaStream_t s) {
  const size_t A = p.amax - p.amin + 1, H = p.hidden;
  const size_t n_w = H * SV_F + H + (A + 1) * H + (A + 1);
  return launch(sv_collect_kernel<N>, p, tile, 4 * n_w + board_bytes(p, tile), s);
}

// The shape limits, and the block: tile threads, a multiple of 32 in
// [32, 256], in lane groups of a power of two threads, lanes_per_warp of
// them a warp.
static bool valid(const SvParams* p, int tile) {
  const int g = p->group;
  return p->D >= 1 && p->D <= SV_MAX_D && p->pool >= 1 && p->pool <= SV_MAX_POOL &&
         p->amin >= 0 && p->amax <= 9 && p->amax - p->amin + 1 <= SV_MAX_A && p->T >= 0 &&
         p->T <= SV_MAX_T && p->HW > 0 && p->idx_bits + 3 < 32 && g >= 1 && g <= 32 &&
         (g & (g - 1)) == 0 && p->lanes_per_warp >= 1 && p->lanes_per_warp * g <= 32 &&
         tile % 32 == 0 && tile >= 32 && tile <= 256;
}

extern "C" int fused_savanna_rollout(const SvParams* p, int n_agents, int tile, void* stream) {
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

extern "C" int fused_savanna_collect(const SvParams* p, int n_agents, int tile, void* stream) {
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
