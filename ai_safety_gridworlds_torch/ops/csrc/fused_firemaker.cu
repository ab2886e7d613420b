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
// Bound. Per acting sub-step a lane hashes all 289 cells (one uniform per
// cell serves both the spread and the continuation draw) and evaluates the
// stencil at every spreadable, non-burning cell, against a few hundred bytes
// of state per lane per rollout: the kernels are bound by operations
// (chip_smoke.py::step_ops, mlp_ops), not by device memory. The boards stay
// on chip for all n_steps.
//
// Design: one warp per lane, `tile` threads (tile / 32 lanes) per block.
// * The lane's scalars (positions, step types, counters, facings, the
//   draws, the agent order) are warp-uniform: all 32 threads hold them and
//   run the scalar part of the step redundantly, without divergence or
//   synchronisation. The accumulators are spread over the lanes instead:
//   thread j * D + d holds agent j's reward and stats in dim d, thread
//   j * 5 + k agent j's visit count k.
// * The boards are bitmasks in the warp's shared memory: the fire board is
//   ceil(HW / 32) words, built by __ballot_sync; thread t owns cells
//   32 w + t. The source board (burning cells without an agent, plus the
//   cells of workers at an active workshop) is rebuilt each sub-step as an
//   extended, wrapped copy, so that a cell reads the sources of one stencil
//   row as one window of bits, without bounds tests.
// * The stencil is a table lookup per row: the block holds, for each row of
//   equal dr and each pattern of its window's bits, the row's product of
//   factors 1 - p taken in the reference's order, so a cell's cum is 1 minus
//   the product of its rows' entries (5 lookups and multiplies instead of
//   24 tests).
// * Each thread hashes and draws its own cells; the new fire word is a
//   ballot and the external-fire count a popcount of ballots.
// * K3's MLP runs across the warp: one thread per hidden unit, written to
//   the warp's shared memory, then one thread per output row of each agent.
// Compared with one thread per lane (the earlier design), the board work
// of a lane runs on 32 threads, and B = 4096 lanes fill the SMs with about
// 30 resident warps each instead of one.
//
// Exactness. The stencil keeps the product form's order: rows of equal dr
// in ascending dr, each row's (dc, p) terms in ascending order, factors with
// a 0 source skipped (1 - p * 0 = 1 leaves a product's bits unchanged), prod
// = row_0 * row_1 * ..., cum = 1 - prod; each table entry is its row's
// product in that order. The library is built with --fmad=false so that no
// product and sum are contracted into one FMA; the kernels then do the plain
// PyTorch version's float32 arithmetic. Each cell's draw and each reward sum
// is formed by one thread in the reference's order. The linear policy's
// logits are the same elementwise chain as the plain version's, so K1 stays
// bit-equal with a policy. The MLP accumulates bias first, features
// ascending, hidden units ascending, and sums the softmax left to right, as
// the plain version does; expf/logf may differ from PyTorch's in the last
// bit, which can flip a draw whose uniform lies within a few ULP of a
// cumulative sum.
#include "policy.cuh"
#include "prng.cuh"

#define FM_MAX_N 3
#define FM_MAX_D 8
#define FM_MAX_TERMS 48
#define FM_MAX_ROWS 8   // stencil rows (distinct dr)
#define FM_MAX_WIN 8    // bits of a row's window
#define FM_MAX_HW 1024  // one word of own-cell bits per thread
#define FM_N_RV 8
#define FM_F 6      // FusedFiremaker.POLICY_FEATURES
#define FM_MAX_A 5  // legal actions amin..amax
#define FM_FULL 0xffffffffu

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
  // The stencil (ops/fused_firemaker.py::_stencil): terms in the
  // reference's product order, each with its row and its bit in the row's
  // window; window bit 0 of row r at cell c is bit c - row_base[r] of the
  // extended source board, whose bit e holds cell (e + ext_lo) mod HW.
  int n_terms, n_rows, win_bits, ext_lo, n_ext;
  int term_row[FM_MAX_TERMS];
  int term_bit[FM_MAX_TERMS];
  float term_q[FM_MAX_TERMS];  // float32(1 - float32(p))
  int row_base[FM_MAX_ROWS];
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

// Shared memory, in 4-byte words (ops/fused_firemaker.py::_smem_bytes
// mirrors it). The block's part: K3's MLP weights (w1 [H, F], b1 [H], w2
// [A+1, H] with rows H + 1 apart, b2 [A+1]), the reward vectors, the stencil
// table [n_rows][2^win_bits] and the cell bits [HW] bytes. Then each warp's
// part: the fire board, the extended source board (one spare word for the
// two-word window reads) and K3's hidden units [N][H + 1].
struct FmSmem {
  int rv, table, bits, warps, ext, hbuf, per_warp, words;
};

__host__ __device__ inline FmSmem fm_smem(const FmParams& p, int n_agents,
                                          int lanes, int hidden) {
  FmSmem s;
  const int A = p.amax - p.amin + 1;
  s.rv = hidden ? hidden * FM_F + hidden + (A + 1) * (hidden + 1) + A + 1 : 0;
  s.table = s.rv + FM_N_RV * FM_MAX_D;
  s.bits = s.table + (p.n_rows << p.win_bits);
  s.warps = s.bits + (p.HW + 3) / 4;
  s.ext = (p.HW + 31) / 32;
  s.hbuf = s.ext + (p.n_ext + 31) / 32 + 1;
  s.per_warp = s.hbuf + (hidden ? n_agents * (hidden + 1) : 0);
  s.words = s.warps + lanes * s.per_warp;
  return s;
}

extern "C" int fm_smem_bytes(const FmParams* p, int n_agents, int tile,
                             int hidden) {
  return 4 * fm_smem(*p, n_agents, tile / 32, hidden).words;
}

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

// _table_sel: table[action, dir], 0 for a direction outside 0..3.
__device__ __forceinline__ int table_sel(const FmParams& p, int tab, int a_cl,
                                         int dir) {
  return (dir >= 0 && dir < 4) ? p.dir_tab[tab][a_cl][dir] : 0;
}

// One warp's view of shared memory and its thread's fixed roles.
struct FmWarp {
  const float* rv;      // [FM_N_RV][FM_MAX_D], the block's
  const float* table;   // [n_rows << win_bits], the block's
  const uint8_t* bits;  // [HW], the block's
  uint32_t* fire;       // [nw] words, the warp's
  uint32_t* ext;        // [ne] words, the warp's
  float* hbuf;          // [N][H + 1], the warp's (K3)
  agw::Mlp mlp;         // in the block's shared memory (K3)
  int lane, b, nw, ne;
  uint32_t spread_m, terr_m;  // own cells 32 w + lane: bit w
  int sj, sd;   // reward and stats slot: agent, dim (sj = -1: none)
  int vj;       // visit slot: agent (-1: none), counting cell bit vmask
  int vmask;
};

// One lane's warp-uniform state, plus this thread's accumulator slots.
template <int N>
struct Lane {
  uint32_t key_hi, key_lo, ctr;
  int countdown, ext_fires, t, episodes;
  int pos[N], reasons[N], types[N], adir[N], odir[N], atw[N];
  float stats;  // agent sj, dim sd
  int visits;   // agent vj, count lane % 5
};

// rew[agent][d] += rv[kind][d] * scale, on the thread holding (agent, d).
__device__ __forceinline__ void add_rv(float& rew, const FmWarp& w, int agent,
                                       int kind, float scale) {
  if (w.sj == agent) rew = rew + w.rv[kind * FM_MAX_D + w.sd] * scale;
}

template <int N>
__device__ __forceinline__ void load_lane(const FmParams& p, const FmWarp& w,
                                          Lane<N>& L) {
  const size_t B = p.B, b = w.b;
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
  }
  L.stats = w.sj >= 0 ? p.in.stats_rewards[w.lane * B + b] : 0.f;
  L.visits = w.vj >= 0 ? p.in.visits[w.lane * B + b] : 0;
  for (int i = 0; i < w.nw; ++i) {
    const size_t c = 32 * i + w.lane;
    const uint32_t word =
        __ballot_sync(FM_FULL, c < static_cast<size_t>(p.HW) && p.in.fire[c * B + b] > 0.5f);
    if (w.lane == 0) w.fire[i] = word;
  }
  __syncwarp();
}

template <int N>
__device__ __forceinline__ void store_lane(const FmParams& p, const FmWarp& w,
                                           const Lane<N>& L) {
  const size_t B = p.B, b = w.b;
  for (int i = 0; i < w.nw; ++i) {
    const int c = 32 * i + w.lane;
    if (c < p.HW) p.out.fire[c * B + b] = (w.fire[i] >> w.lane) & 1u ? 1.f : 0.f;
  }
  if (w.sj >= 0) p.out.stats_rewards[w.lane * B + b] = L.stats;
  if (w.vj >= 0) p.out.visits[w.lane * B + b] = L.visits;
  if (w.lane != 0) return;
  const bool has_dirs = p.adm != 0 || p.odm != 0;
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

// The fire spread and continuation of one sub-step: rebuild the extended
// source board, then draw every cell; returns the burning cells outside the
// territory afterwards (ext2). wk[j]: agent j sparks its cell.
template <int N>
__device__ __forceinline__ int fire_pass(const FmParams& p, const FmWarp& w,
                                         const Lane<N>& L, const bool (&wk)[N],
                                         uint32_t ctr_fire) {
  const int HW = p.HW;
  for (int i = 0; i < w.ne; ++i) {
    const int e = 32 * i + w.lane;
    bool src = false;
    if (e < p.n_ext) {
      int s = e + p.ext_lo;
      s += s < 0 ? HW : (s >= HW ? -HW : 0);
      bool on_agent = false, spark = false;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const bool here = L.pos[j] == s;
        on_agent = on_agent || here;
        spark = spark || (here && wk[j]);
      }
      src = (((w.fire[s >> 5] >> (s & 31)) & 1u) && !on_agent) || spark;
    }
    const uint32_t word = __ballot_sync(FM_FULL, src);
    if (w.lane == 0) w.ext[i] = word;
  }
  __syncwarp();

  const uint32_t wmask = (1u << p.win_bits) - 1u;
  int ext2 = 0;
  for (int i = 0; i < w.nw; ++i) {
    const int c = 32 * i + w.lane;
    const bool valid = c < HW;
    bool on_agent = false;
#pragma unroll
    for (int j = 0; j < N; ++j) on_agent = on_agent || L.pos[j] == c;
    const bool burning = valid && ((w.fire[i] >> w.lane) & 1u) && !on_agent;
    float cum = 0.f;
    if (valid && !burning && ((w.spread_m >> i) & 1u)) {
      float prod = 1.f;
#pragma unroll
      for (int r = 0; r < FM_MAX_ROWS; ++r) {
        if (r >= p.n_rows) break;
        const int st = c - p.row_base[r];
        const uint32_t win =
            __funnelshift_r(w.ext[st >> 5], w.ext[(st >> 5) + 1], st & 31) & wmask;
        prod = prod * w.table[(r << p.win_bits) | win];
      }
      cum = 1.f - prod;
    }
    const float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr_fire, c));
    const bool f2 = valid && (burning ? (u < p.cont_p) : (u < cum));
    const uint32_t word = __ballot_sync(FM_FULL, f2);
    ext2 += __popc(__ballot_sync(FM_FULL, f2 && !((w.terr_m >> i) & 1u)));
    if (w.lane == 0) w.fire[i] = word;
  }
  __syncwarp();
  return ext2;
}

// One full multi-agent step of one lane, by its warp: auto-reset, policy
// features and action draws, agent order, every agent's sub-step, finalize.
// MODE selects the policy; with POL_MLP the step's record goes to traj[step].
template <int N, int MODE>
__device__ __forceinline__ void fm_step(const FmParams& p, const FmWarp& w,
                                        Lane<N>& L, int step) {
  const int HW = p.HW;
  const bool has_dirs = p.adm != 0 || p.odm != 0;
  const bool has_sup = p.sup >= 0;
  const size_t sB = static_cast<size_t>(p.B), b = w.b;

  // ---- auto-reset lanes whose episode ended last step
  bool over = true;
#pragma unroll
  for (int j = 0; j < N; ++j) over = over && (L.types[j] == LAST || L.types[j] == DEAD);
  if (over) {
    for (int i = w.lane; i < w.nw; i += 32) w.fire[i] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      L.pos[j] = p.start_pos[j];
      L.reasons[j] = R_NONE;
      L.types[j] = FIRST;
      L.adir[j] = DIR_UP;
      L.odir[j] = DIR_UP;
      L.atw[j] = 0;
    }
    L.visits = 0;
    L.countdown = 0;
    L.ext_fires = 0;
    L.t = 0;
    __syncwarp();
  }

  // ---- action draws (site 0), through the policy, and Fisher-Yates agent
  // order (site 1)
  const uint32_t ctr0 = L.ctr * static_cast<uint32_t>(2 + N);
  const int A = p.amax - p.amin + 1;
  float x[N][FM_F];
  if (MODE != POL_UNIFORM) policy_feats<N>(p, L, x);
  float row_out = 0.f;
  if (MODE == POL_MLP)
    row_out = agw::mlp_warp_rows<FM_F, N>(w.mlp, A, x, w.hbuf, w.lane);
  int actions[N], order[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr0, j));
    const float uA = u * static_cast<float>(A);
    int a = p.amin + static_cast<int>(floorf(uA));
    a = min(max(a, p.amin), p.amax);
    const bool off = over || L.reasons[j] != R_NONE;
    if (MODE == POL_LINEAR && !off) {
      const int lane = p.pol_lanes == 1 ? 0 : w.b;
      const int greedy =
          p.amin + agw::linear_greedy<FM_F>(p.pol_w, p.pol_b, p.pol_lanes, A, lane, x[j]);
      if (!(fmodf(uA, 1.f) < p.pol_eps[lane])) a = greedy;
    }
    if (MODE == POL_MLP) {
      float out[FM_MAX_A + 1], logp, value;
      agw::mlp_gather_rows<FM_MAX_A>(row_out, A, j, out);
      a = p.amin + agw::mlp_sample<FM_MAX_A>(out, A, u, logp, value);
      if (w.lane == 0) {
        const size_t r = static_cast<size_t>(step) * N + j;
#pragma unroll
        for (int f = 0; f < FM_F; ++f)
          p.traj.feats[(static_cast<size_t>(step) * (N * FM_F) + j * FM_F + f) * sB + b] = x[j][f];
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
      float u = agw::uniform01(agw::hash_u32(L.key_hi, L.key_lo, ctr0 + 1u, k));
      int jj = min(max(static_cast<int>(floorf(u * static_cast<float>(k + 1))), 0), k);
      int vk = order[k], vj = get(order, jj);
      put(order, jj, vk);
      order[k] = vj;
    }
  }

  float rew = 0.f;  // agent w.sj, dim w.sd
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
    const bool wall_at = cand >= 0 && cand < HW && (w.bits[cand] & CB_WALL);
    if (active && is_move && !wall_at && !occ) put(L.pos, i, cand);
    if (is_quit && !dead_i) put(L.reasons, i, R_QUIT);
    if (active && !is_noop)
      add_rv(rew, w, i, (has_sup && i == p.sup) ? RV_SUP_MOVE : RV_AGENT_MOVE, 1.f);

    // --- every agent's tile value at its post-move cell (+ fire bit)
    int v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int pj = L.pos[j];
      v[j] = (pj >= 0 && pj < HW)
                 ? (w.bits[pj] & (CB_FIRE - 1 - CB_SPREADABLE)) |
                       (((w.fire[pj >> 5] >> (pj & 31)) & 1u) ? CB_FIRE : 0)
                 : 0;
    }
    const int v_at = get(v, i);
    if (active && w.vj == i) L.visits += (v_at & w.vmask) != 0;

    // --- stop button
    bool any_btn = false;
#pragma unroll
    for (int j = 0; j < N; ++j) any_btn = any_btn || (v[j] & CB_BUTTON);
    int cd2 = any_btn ? 2 + p.press_duration : L.countdown;
    if (has_sup && (get(v, p.sup) & CB_BUTTON) && L.ext_fires == 0)
      add_rv(rew, w, p.sup, RV_SUP_STOP, 1.f);
    cd2 = max(0, cd2 - 1);

    // --- workshop
    int atw2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool at_w = v[j] & CB_WORKSHOP;
      atw2[j] = at_w;
      bool working = at_w;
      if (has_sup && j == p.sup) {
        if (at_w && L.ext_fires == 0) add_rv(rew, w, j, RV_SUP_WORKSHOP, 1.f);
        working = at_w && L.ext_fires != 0;
      }
      if (working && cd2 == 0) {
        add_rv(rew, w, 0, RV_AGENT_WORK, 1.f);
        if (N > 1 && p.extra_work_row) add_rv(rew, w, 1, RV_AGENT_WORK, 1.f);
        add_rv(rew, w, j, RV_AGENT_ENERGY, 1.f);
      }
    }

    // --- fire: sources are the burning cells without an agent, plus the
    // cells of workers at an active workshop.
    bool wk[N];
#pragma unroll
    for (int j = 0; j < N; ++j) wk[j] = j < p.n_workers && atw2[j] && cd2 == 0;
    const int ext2 = fire_pass<N>(p, w, L, wk, ctr0 + 2u + static_cast<uint32_t>(slot));
    add_rv(rew, w, has_sup ? p.sup : 0, RV_SUP_EXT_FIRE, static_cast<float>(ext2));

    // --- territory
    if (has_sup) {
      const int ps = get(L.pos, p.sup);
      const bool on_terr = ps >= 0 && ps < HW && (w.bits[ps] & CB_TERRITORY);
      if (on_terr && ext2 == 0) add_rv(rew, w, p.sup, RV_SUP_TRESPASS, 1.f);
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
  L.stats = L.stats + rew;
  L.ctr += 1u;

  if (MODE == POL_MLP) {
    // Each agent's reward summed over the reward dims, in order; done flags.
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float r = __shfl_sync(FM_FULL, rew, j * p.D);
      for (int d = 1; d < p.D; ++d) r = r + __shfl_sync(FM_FULL, rew, j * p.D + d);
      if (w.lane == 0) {
        const size_t row = static_cast<size_t>(step) * N + j;
        p.traj.reward[row * sB + b] = r;
        p.traj.done[row * sB + b] = L.types[j] == LAST || L.types[j] == DEAD;
      }
    }
  }
}

// The block's shared memory: K3's weights, the reward vectors, the stencil
// table and the cell bits. Each table entry is its row's product of the
// factors q of the terms whose window bit is set, in the terms' order.
__device__ __forceinline__ void block_setup(const FmParams& p, const FmSmem& s,
                                            uint32_t* sm, int hidden) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* f = reinterpret_cast<float*>(sm);
  if (hidden) {
    const int H = hidden, A = p.amax - p.amin + 1, n_w1 = H * FM_F;
    for (int i = tid; i < n_w1; i += nt) f[i] = p.mlp_w1[i];
    for (int i = tid; i < H; i += nt) f[n_w1 + i] = p.mlp_b1[i];
    for (int i = tid; i < (A + 1) * H; i += nt)
      f[n_w1 + H + (i / H) * (H + 1) + i % H] = p.mlp_w2[i];
    for (int i = tid; i <= A; i += nt) f[n_w1 + H + (A + 1) * (H + 1) + i] = p.mlp_b2[i];
  }
  for (int i = tid; i < FM_N_RV * FM_MAX_D; i += nt)
    f[s.rv + i] = p.rv[i / FM_MAX_D][i % FM_MAX_D];
  for (int i = tid; i < (p.n_rows << p.win_bits); i += nt) {
    const int r = i >> p.win_bits, pattern = i & ((1 << p.win_bits) - 1);
    float y = 1.f;
    for (int k = 0; k < p.n_terms; ++k)
      if (p.term_row[k] == r && ((pattern >> p.term_bit[k]) & 1)) y = y * p.term_q[k];
    f[s.table + i] = y;
  }
  uint8_t* bits = reinterpret_cast<uint8_t*>(sm + s.bits);
  for (int c = tid; c < p.HW; c += nt) bits[c] = p.cell_bits[c];
  __syncthreads();
}

// The warp's view of shared memory and the roles of its thread; b is the
// warp's lane of the batch.
template <int N>
__device__ __forceinline__ FmWarp warp_setup(const FmParams& p, const FmSmem& s,
                                             uint32_t* sm, int hidden, int b) {
  FmWarp w;
  const float* f = reinterpret_cast<const float*>(sm);
  uint32_t* mine = sm + s.warps + (threadIdx.x >> 5) * s.per_warp;
  const int H = hidden, A = p.amax - p.amin + 1;
  w.rv = f + s.rv;
  w.table = f + s.table;
  w.bits = reinterpret_cast<const uint8_t*>(sm + s.bits);
  w.fire = mine;
  w.ext = mine + s.ext;
  w.hbuf = reinterpret_cast<float*>(mine + s.hbuf);
  w.mlp = agw::Mlp{f, f + H * FM_F, f + H * FM_F + H, f + H * FM_F + H + (A + 1) * (H + 1), H};
  w.lane = threadIdx.x & 31;
  w.b = b;
  w.nw = (p.HW + 31) / 32;
  w.ne = (p.n_ext + 31) / 32 + 1;
  w.spread_m = w.terr_m = 0;
  for (int i = 0; i < w.nw; ++i) {
    const int c = 32 * i + w.lane;
    if (c >= p.HW) continue;
    const int cb = w.bits[c];
    w.spread_m |= (cb & CB_SPREADABLE ? 1u : 0u) << i;
    w.terr_m |= (cb & CB_TERRITORY ? 1u : 0u) << i;
  }
  const bool has_s = w.lane < N * p.D, has_v = w.lane < N * 5;
  w.sj = has_s ? w.lane / p.D : -1;
  w.sd = has_s ? w.lane % p.D : 0;
  w.vj = has_v ? w.lane / 5 : -1;
  // Visit counts 0..4 count the external, territory, workshop, fire and
  // button cells.
  const int vmasks[5] = {CB_EXTERNAL, CB_TERRITORY, CB_WORKSHOP, CB_FIRE, CB_BUTTON};
  w.vmask = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k)
    if (has_v && k == w.lane % 5) w.vmask = vmasks[k];
  return w;
}

// K1: n_steps steps of every lane, uniform or linear-policy actions.
template <int N, int MODE>
__global__ void __launch_bounds__(256)
    fm_rollout_kernel(const __grid_constant__ FmParams p) {
  extern __shared__ uint32_t fm_sm[];
  const FmSmem s = fm_smem(p, N, blockDim.x >> 5, 0);
  block_setup(p, s, fm_sm, 0);
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp: b is the warp's

  const FmWarp w = warp_setup<N>(p, s, fm_sm, 0, b);
  Lane<N> L;
  load_lane<N>(p, w, L);
  for (int step = 0; step < p.n_steps; ++step) fm_step<N, MODE>(p, w, L, step);
  store_lane<N>(p, w, L);
}

// K3: n_steps MLP-policy steps of every lane with the trajectory streamed
// out, then the bootstrap value of the final state.
template <int N>
__global__ void __launch_bounds__(256)
    fm_collect_kernel(const __grid_constant__ FmParams p) {
  extern __shared__ uint32_t fm_sm[];
  const FmSmem s = fm_smem(p, N, blockDim.x >> 5, p.hidden);
  block_setup(p, s, fm_sm, p.hidden);
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp: b is the warp's

  const FmWarp w = warp_setup<N>(p, s, fm_sm, p.hidden, b);
  const int A = p.amax - p.amin + 1;
  Lane<N> L;
  load_lane<N>(p, w, L);
  for (int step = 0; step < p.n_steps; ++step) fm_step<N, POL_MLP>(p, w, L, step);
  float x[N][FM_F];
  policy_feats<N>(p, L, x);
  const float row_out = agw::mlp_warp_rows<FM_F, N>(w.mlp, A, x, w.hbuf, w.lane);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float value = __shfl_sync(FM_FULL, row_out, j * (A + 1) + A);
    if (w.lane == 0) p.traj.boot[j * p.B + b] = value;
  }
  store_lane<N>(p, w, L);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, const FmParams& p, int tile,
                          size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int lanes = tile / 32;
  const int blocks = (p.B + lanes - 1) / lanes;
  kernel<<<blocks, tile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_rollout(const FmParams& p, int tile, cudaStream_t s) {
  const size_t smem = 4 * static_cast<size_t>(fm_smem(p, N, tile / 32, 0).words);
  return p.pol_w ? launch(fm_rollout_kernel<N, POL_LINEAR>, p, tile, smem, s)
                 : launch(fm_rollout_kernel<N, POL_UNIFORM>, p, tile, smem, s);
}

template <int N>
static cudaError_t launch_collect(const FmParams& p, int tile, cudaStream_t s) {
  const size_t smem = 4 * static_cast<size_t>(fm_smem(p, N, tile / 32, p.hidden).words);
  return launch(fm_collect_kernel<N>, p, tile, smem, s);
}

// The launch geometry both entries take: tile threads (tile / 32 lanes) per
// block, a board of at most FM_MAX_HW cells and a stencil that fits the
// parameter block's tables.
static bool fm_fits(const FmParams& p, int tile) {
  return tile % 32 == 0 && tile >= 32 && tile <= 256 && p.HW >= 1 &&
         p.HW <= FM_MAX_HW && p.n_terms <= FM_MAX_TERMS &&
         p.n_rows <= FM_MAX_ROWS && p.win_bits <= FM_MAX_WIN && p.D <= FM_MAX_D;
}

extern "C" int fused_firemaker_rollout(const FmParams* p, int n_agents,
                                       int tile, void* stream) {
  if (p->n_steps <= 0 || p->B <= 0) return 0;
  if (!fm_fits(*p, tile)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (!fm_fits(*p, tile) || p->amax - p->amin + 1 > FM_MAX_A || p->hidden < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_agents) {
    case 1: return static_cast<int>(launch_collect<1>(*p, tile, s));
    case 2: return static_cast<int>(launch_collect<2>(*p, tile, s));
    case 3: return static_cast<int>(launch_collect<3>(*p, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
