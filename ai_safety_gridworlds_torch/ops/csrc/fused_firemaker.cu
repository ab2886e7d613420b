// K1: the fused firemaker_ex_ma rollout, for Hopper (sm_90a).
//
// Replaces ai_safety_gridworlds_tpu/ops/fused_base.py::
// FusedMaBase._rollout_pallas_call (:432) running ops/fused_firemaker.py::
// FusedFiremaker._step (:373) with the product-form _spread_cum (:328): one
// launch advances every lane n_steps full multi-agent steps -- uniform action
// draws and Fisher-Yates agent order (fused_base.py::_draw_actions_and_order),
// each agent's sub-step (direction modes through the _table_sel tables, move
// with blocking, quit, visits, stop button, workshop, fire spread and
// continuation, external-fire count, trespass, rewards), finalize
// (fused_base.py::_finalize_types) and auto-reset.
//
// Design. One thread per batch lane, `tile` lanes per block. The lane's
// scalars (positions, step types, counters, visits, facings, reward sums)
// live in registers; its fire board and the sub-step's source board live in
// shared memory as bytes laid out [cell][tile], so neighbouring lanes touch
// neighbouring bytes. Each thread only touches its own column, so the block
// synchronises once, after loading the static cell bits. Every [rows, B]
// field is read from device memory once (coalesced across lanes) and written
// once, after all n_steps. The static board is read by index at an agent's
// cell: the one-hot compare-and-reduce of the TPU kernel was a Mosaic
// constraint and gives the same value.
//
// Bound. Per sub-step each lane hashes all 289 cells (one uniform per cell
// serves both the spread and the continuation draw) and evaluates the 24-term
// product stencil at every spreadable, non-burning cell: about 289 * 50
// integer and float operations per lane per sub-step, against a few hundred
// bytes of state per lane per rollout. The kernel is bound by issue and
// shared-memory latency, not by device memory; keeping the boards out of
// device memory for all n_steps is what the design does about it.
//
// Exactness. The stencil is the product form in the reference's separable
// order: rows of equal dr in ascending dr, each row's (dc, p) terms in
// ascending order, prod = row_0 * row_1 * ..., cum = 1 - prod. Factors
// 1 - p * 0 = 1 are skipped, which leaves every product bit-identical. The
// library is built with --fmad=false so the last product and 1 - prod are
// never contracted into one FMA; the kernel is then bit-equal to the plain
// PyTorch version. Reward sums add each contribution to its row in the
// reference's order.
#include "prng.cuh"

#define FM_MAX_N 3
#define FM_MAX_D 8
#define FM_MAX_TERMS 48
#define FM_N_RV 8

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

template <int N>
__global__ void __launch_bounds__(256)
    fm_rollout_kernel(const __grid_constant__ FmParams p) {
  extern __shared__ uint8_t smem[];
  const int tile = blockDim.x;
  const int tx = threadIdx.x;
  const int b = blockIdx.x * tile + tx;
  const int HW = p.HW, B = p.B;
  uint8_t* fire = smem + tx;                // column: fire[c * tile]
  uint8_t* src = smem + HW * tile + tx;     // column: src[c * tile]
  uint8_t* bits = smem + 2 * HW * tile;     // [HW], shared by the block
  for (int c = tx; c < HW; c += tile) bits[c] = p.cell_bits[c];
  __syncthreads();
  if (b >= B) return;

  const bool has_dirs = p.adm != 0 || p.odm != 0;
  const bool has_sup = p.sup >= 0;
  const uint32_t key_hi = p.in.key[b], key_lo = p.in.key[B + b];
  uint32_t ctr = p.in.draw_ctr[b];
  int countdown = p.in.countdown[b], ext_fires = p.in.ext_fires[b];
  int t = p.in.t[b], episodes = p.in.stats_episodes[b];
  int pos[N], reasons[N], types[N], adir[N], odir[N], atw[N];
  int visits[N][5];
  float stats[N][FM_MAX_D];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    pos[j] = p.in.pos[j * B + b];
    reasons[j] = p.in.reasons[j * B + b];
    types[j] = p.in.step_types[j * B + b];
    atw[j] = p.in.at_workshop[j * B + b] > 0.5f;
    adir[j] = has_dirs ? p.in.act_dir[j * B + b] : DIR_UP;
    odir[j] = has_dirs ? p.in.obs_dir[j * B + b] : DIR_UP;
#pragma unroll
    for (int k = 0; k < 5; ++k) visits[j][k] = p.in.visits[(j * 5 + k) * B + b];
#pragma unroll
    for (int d = 0; d < FM_MAX_D; ++d)
      stats[j][d] = d < p.D ? p.in.stats_rewards[(j * p.D + d) * B + b] : 0.f;
  }
  for (int c = 0; c < HW; ++c) fire[c * tile] = p.in.fire[c * B + b] > 0.5f;

  for (int step = 0; step < p.n_steps; ++step) {
    // ---- auto-reset lanes whose episode ended last step
    bool over = true;
#pragma unroll
    for (int j = 0; j < N; ++j) over = over && (types[j] == LAST || types[j] == DEAD);
    if (over) {
      for (int c = 0; c < HW; ++c) fire[c * tile] = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        pos[j] = p.start_pos[j];
        reasons[j] = R_NONE;
        types[j] = FIRST;
        adir[j] = DIR_UP;
        odir[j] = DIR_UP;
        atw[j] = 0;
#pragma unroll
        for (int k = 0; k < 5; ++k) visits[j][k] = 0;
      }
      countdown = 0;
      ext_fires = 0;
      t = 0;
    }

    // ---- action draws (site 0) and Fisher-Yates agent order (site 1)
    const uint32_t ctr0 = ctr * static_cast<uint32_t>(2 + N);
    int actions[N], order[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float u = agw::uniform01(agw::hash_u32(key_hi, key_lo, ctr0, j));
      int a = p.amin + static_cast<int>(floorf(u * static_cast<float>(p.amax - p.amin + 1)));
      a = min(max(a, p.amin), p.amax);
      actions[j] = (over || reasons[j] != R_NONE) ? -1 : a;
      order[j] = j;
    }
    if (p.randomize && N > 1) {
#pragma unroll
      for (int k = N - 1; k >= 1; --k) {
        float u = agw::uniform01(agw::hash_u32(key_hi, key_lo, ctr0 + 1u, k));
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
      const bool dead_i = get(reasons, i) != R_NONE;
      const bool active = !is_quit && !dead_i;
      t += 1;

      // --- direction modes: observation facing before the move, action
      // facing after it, both from the facings at the sub-step's start.
      const bool is_move = a >= 1 && a <= 4;
      int abs_action = a;
      if (has_dirs) {
        const int a_cl = min(max(a, 0), 9);
        const int dir_i = get(adir, i), odir_i = get(odir, i);
        if (p.odm != 0) {
          const int tab = p.odm == 1 ? ((p.adm == 1 || p.adm == 2) ? 1 : 0) : 2;
          const int nod = table_sel(p, tab, a_cl, odir_i);
          if (active) put(odir, i, nod);
        }
        if (p.adm != 0) {
          const int rel = table_sel(p, 1, a_cl, dir_i);
          const int abs_move = p.dir_to_action[(rel >= 1 && rel <= 3) ? rel : 0];
          abs_action = is_move ? abs_move : a;
          const int nad = table_sel(p, p.adm, a_cl, dir_i);
          if (active) put(adir, i, nad);
        }
      }

      // --- move, blocked by walls and other agents
      const int pos_i = get(pos, i);
      const int delta = (abs_action == A_LEFT ? -1 : 0) + (abs_action == A_RIGHT ? 1 : 0) +
                        (abs_action == A_UP ? -p.W : 0) + (abs_action == A_DOWN ? p.W : 0);
      const int cand = pos_i + delta;
      bool occ = false;
#pragma unroll
      for (int j = 0; j < N; ++j) occ = occ || (j != i && pos[j] == cand);
      const bool wall_at = cand >= 0 && cand < HW && (bits[cand] & CB_WALL);
      if (active && is_move && !wall_at && !occ) put(pos, i, cand);
      if (is_quit && !dead_i) put(reasons, i, R_QUIT);
      if (active && !is_noop)
        add_rv<N>(rew, p, i, (has_sup && i == p.sup) ? RV_SUP_MOVE : RV_AGENT_MOVE, 1.f);

      // --- every agent's tile value at its post-move cell (+ fire bit)
      int v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int pj = pos[j];
        v[j] = (pj >= 0 && pj < HW)
                   ? (bits[pj] & (CB_FIRE - 1 - CB_SPREADABLE)) | (fire[pj * tile] ? CB_FIRE : 0)
                   : 0;
      }
      const int v_at = get(v, i);
      if (active) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j != i) continue;
          visits[j][0] += (v_at & CB_EXTERNAL) != 0;
          visits[j][1] += (v_at & CB_TERRITORY) != 0;
          visits[j][2] += (v_at & CB_WORKSHOP) != 0;
          visits[j][3] += (v_at & CB_FIRE) != 0;
          visits[j][4] += (v_at & CB_BUTTON) != 0;
        }
      }

      // --- stop button
      bool any_btn = false;
#pragma unroll
      for (int j = 0; j < N; ++j) any_btn = any_btn || (v[j] & CB_BUTTON);
      int cd2 = any_btn ? 2 + p.press_duration : countdown;
      if (has_sup && (get(v, p.sup) & CB_BUTTON) && ext_fires == 0)
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
          if (at_w && ext_fires == 0) add_rv<N>(rew, p, j, RV_SUP_WORKSHOP, 1.f);
          working = at_w && ext_fires != 0;
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
        if (pos[j] >= 0 && pos[j] < HW) src[pos[j] * tile] = 0;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < p.n_workers && atw2[j] && cd2 == 0) src[pos[j] * tile] = 1;

      const uint32_t ctr_fire = ctr0 + 2u + static_cast<uint32_t>(slot);
      int ext2 = 0;
      for (int c = 0; c < HW; ++c) {
        const int cb = bits[c];
        bool on_agent = false;
#pragma unroll
        for (int j = 0; j < N; ++j) on_agent = on_agent || pos[j] == c;
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
        const float u = agw::uniform01(agw::hash_u32(key_hi, key_lo, ctr_fire, c));
        const bool f2 = burning ? (u < p.cont_p) : (u < cum);
        fire[c * tile] = f2;
        ext2 += f2 && !(cb & CB_TERRITORY);
      }
      add_rv<N>(rew, p, has_sup ? p.sup : 0, RV_SUP_EXT_FIRE, static_cast<float>(ext2));

      // --- territory
      if (has_sup) {
        const int ps = get(pos, p.sup);
        const bool on_terr = ps >= 0 && ps < HW && (bits[ps] & CB_TERRITORY);
        if (on_terr && ext2 == 0) add_rv<N>(rew, p, p.sup, RV_SUP_TRESPASS, 1.f);
      }

      countdown = cd2;
      ext_fires = ext2;
#pragma unroll
      for (int j = 0; j < N; ++j) atw[j] = atw2[j];
    }

    // ---- finalize
    bool all_over = true;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool game_over = t >= p.max_iterations || reasons[j] != R_NONE;
      const int nt = game_over ? ((types[j] == MID || types[j] == FIRST) ? LAST : DEAD) : MID;
      types[j] = over ? FIRST : nt;
      all_over = all_over && game_over;
    }
    episodes += all_over && !over;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int d = 0; d < FM_MAX_D; ++d) stats[j][d] = stats[j][d] + rew[j][d];
    ctr += 1u;
  }

  // ---- write the state back once
  for (int c = 0; c < HW; ++c) p.out.fire[c * B + b] = fire[c * tile] ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    p.out.pos[j * B + b] = pos[j];
    p.out.reasons[j * B + b] = reasons[j];
    p.out.step_types[j * B + b] = types[j];
    p.out.at_workshop[j * B + b] = atw[j] ? 1.f : 0.f;
    if (has_dirs) {
      p.out.act_dir[j * B + b] = adir[j];
      p.out.obs_dir[j * B + b] = odir[j];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) p.out.visits[(j * 5 + k) * B + b] = visits[j][k];
#pragma unroll
    for (int d = 0; d < FM_MAX_D; ++d)
      if (d < p.D) p.out.stats_rewards[(j * p.D + d) * B + b] = stats[j][d];
  }
  p.out.countdown[b] = countdown;
  p.out.ext_fires[b] = ext_fires;
  p.out.t[b] = t;
  p.out.key[b] = key_hi;
  p.out.key[B + b] = key_lo;
  p.out.draw_ctr[b] = ctr;
  p.out.stats_episodes[b] = episodes;
}

template <int N>
static cudaError_t launch(const FmParams& p, int tile, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(p.HW) * tile + p.HW;
  cudaError_t e = cudaFuncSetAttribute(
      fm_rollout_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (p.B + tile - 1) / tile;
  fm_rollout_kernel<N><<<blocks, tile, smem, stream>>>(p);
  return cudaGetLastError();
}

extern "C" int fused_firemaker_rollout(const FmParams* p, int n_agents,
                                       int tile, void* stream) {
  if (p->n_steps <= 0 || p->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_agents) {
    case 1: return static_cast<int>(launch<1>(*p, tile, s));
    case 2: return static_cast<int>(launch<2>(*p, tile, s));
    case 3: return static_cast<int>(launch<3>(*p, tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
