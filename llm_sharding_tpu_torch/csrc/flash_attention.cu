// Dense causal flash attention over a KV cache, position-masked: the port
// of llm_sharding_tpu/ops/flash_attention.py:124 (flash_attention, body
// _flash_kernel at :63).
//
// Three routes, chosen from shapes alone (ops/flash_attention.flash_route
// mirrors the rule, never a failure):
//
// - "heads" (bf16, otherwise): one CTA = 128 query rows of ONE query head
//   (two consumer warpgroups of 64 rows), so a CTA's rows are contiguous
//   positions and the causal walk stays tight; the G heads of a KV head
//   re-read its K/V tiles from L2.
// - "fold" (bf16, G*S <= 64 over a cache of more than min_tiles tiles:
//   speculative verify at S = K + 1, short prompts): one CTA holds all G*S
//   folded rows of a KV head (row s*G + g is query head kh*G + g at index
//   s; the TMA loads them as one box of G heads by S positions), padded
//   only to the warpgroup's 64 rows, so each K/V tile is read once per KV
//   head.
// - "f32": f32 queries on the tensor cores by 3xTF32 (each operand split
//   into a TF32 pair big + small, products big*big + big*small +
//   small*big, f32 accumulation: ~2^-22 relative per product, the f32
//   limits of the tests), mma.sync m16n8k8. Plain TF32 would keep ~3
//   digits, and the CUDA cores' f32 rate (67 TFLOP/s) lost to SDPA.
//
// What bounds them on the H100. At S = C = 2048 a query head does ~4*S*C/2*D
// flops against ~S*D bytes, far above the ~295 flops/byte ridge: bound by
// operations. At a verify (S = 5) or a one-shot prefix (S = 256 past 1024
// keys) the work is a few key tiles per row over few rows: bound by bytes,
// and by how many of the 132 SMs the grid keeps busy. So:
//
// - The visible tiles are found in parallel. Every CTA first reads its
//   batch row's kv_positions once, coalesced (a warp per 64-key tile, the
//   least by a warp reduction), and its rows' q_positions. Tile t is
//   visible to a row tile when its least key position is <= the rows'
//   greatest query position; every tile is visible when some row sees no
//   key at all (that row is the uniform average, as on the plain path).
//   Leaving an invisible tile out is exact: its keys would add
//   exp(-1e30 - m) = 0, or garbage that the first visible key's correction
//   factor multiplies by 0; the producer also leaves out a tile no row
//   sees once every row has seen a key in an issued tile. A tile whose keys
//   all exist and are visible to every row skips the per-element mask. A
//   cache of at most min_tiles tiles (8, 4 at D = 256) is not scanned (nor
//   split): its heaviest row tile walks every tile anyway.
// - A KV split with the merge fused into the launch. The grid is fixed by
//   shapes (ops/flash_attention.plan_flash): `pieces` CTAs per (batch row,
//   head) unit, from the SM count, when the row tiles alone leave SMs idle.
//   Each CTA computes the same plan from the positions: the least run
//   length L (at least min_tiles) with which every row tile's visible tiles
//   fit `pieces` runs, each row tile cut into ceil(n / L) runs of near-equal
//   length that never cross it. CTA j takes run j. A run that covers a row
//   tile's every tile writes the output itself; otherwise it writes an f32
//   partial (acc, m, l) into its slot, and the last run of the row tile to
//   finish (attn::last_run's ticket) merges the slots in column order
//   (merge_slots, the combine_attn_stats recurrence) and resets the ticket.
//   One launch per call, deterministic, and the host reads nothing from the
//   device.
// - bf16 tiles stream through a TMA ring (4 stages at D <= 128 per head, 2
//   folded, so two folded CTAs share an SM, and 2 at D = 256) of 64-key K
//   and V boxes (128-byte swizzled; the maps are 4-D [B, C, Nkv, D], so keys
//   past C are zero-filled and scored -inf) filled by a producer warp; the
//   consumers run wgattn::consume (wgmma, wgmma_attn.cuh's note).
// - Head dim 256 per head runs without a producer warp: with one, the CTA's
//   9 warps round up to 3 per SM sub-partition and ptxas has 168 registers
//   a thread, fewer than the 128-float O accumulator and a 32-float score
//   tile need (the build spilled ~600 bytes a thread). With 8 warps it has
//   255; warp 0 refills the ring at the top of each tile's turn (the hook of
//   wgattn::consume).
// - f32: 128 rows a CTA (64 at D = 256), a warp owns 16 rows; K/V tiles of
//   64 keys (32 at D = 256) double-buffered by cp.async in padded rows
//   (conflict-free fragment loads); a fragment pairs head-dim columns 2t,
//   2t + 1 (one 8-byte load) and the score fragment is P's A fragment with
//   keys 2t, 2t + 1 paired the same way, so P never leaves the registers.
//
// The contract (attn_tile.cuh's note): f32 acc/m/l, masked scores -1e30 and
// the running max starting there, p rounded to the V dtype before P V,
// out = acc / max(l, 1e-30); the softmax runs in the log2 domain (scores
// times scale * log2 e, then ex2).

#include <climits>

#include "attn_tile.cuh"
#include "hopper.cuh"
#include "wgmma_attn.cuh"

namespace {

using attn::kNegInf;
using wgattn::kBM;
using wgattn::kBN;
using wgattn::kBox;

constexpr int kMaxTiles = 1024;    // key tiles whose position range a CTA holds
constexpr int kMaxRowTiles = 256;  // row tiles a split plan spans
constexpr int kFoldRows = 64;      // folded rows of the "fold" route
constexpr int kMaxParts = 128;     // CTAs per unit of a split
constexpr int kBar = 1;            // the consumers' named barrier
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------- the plan, on card

// Shared memory of the plan: per held tile its least key position, the
// row tile's visible tiles in order, per row tile its
// (least, greatest) query position and visible count, and words: the row's
// least key position, the held list's length, the merge flag, the run's
// row tile, run count and first run.
struct PlanSmem {
  static constexpr int TMIN = 0;
  static constexpr int LIST = TMIN + kMaxTiles * 4;
  static constexpr int RQ = LIST + kMaxTiles * 4;     // int2 [kMaxRowTiles]
  static constexpr int RN = RQ + kMaxRowTiles * 8;    // int [kMaxRowTiles]
  static constexpr int MISC = RN + kMaxRowTiles * 4;  // int [8]
  static constexpr int BYTES = MISC + 32;
};

struct PlanPtrs {
  int *tmin, *list;
  int2* rq;
  int *rn, *misc;
  __device__ explicit PlanPtrs(char* p)
      : tmin(reinterpret_cast<int*>(p + PlanSmem::TMIN)),
        list(reinterpret_cast<int*>(p + PlanSmem::LIST)),
        rq(reinterpret_cast<int2*>(p + PlanSmem::RQ)),
        rn(reinterpret_cast<int*>(p + PlanSmem::RN)),
        misc(reinterpret_cast<int*>(p + PlanSmem::MISC)) {}
};

// Least key position of each TC-key tile of one batch row's kv_positions
// (kp, C columns) into tmin (tiles < kMaxTiles), and
// the row's least position into *kvmin (atomicMin; set to INT_MAX before).
// A warp per tile, each lane TC / 32 columns: coalesced; warp `warp` of the
// nw warps that share the pass, eight tiles' loads in flight at once.
template <int TC>
__device__ void tile_ranges(const int* kp, int C, int* tmin, int* kvmin, int warp, int nw) {
  constexpr int U = 8, CPL = TC / 32;  // tiles a warp loads at once, columns a lane
  const int lane = threadIdx.x % 32;
  const int ntiles = (C + TC - 1) / TC;
  int lo = INT_MAX;
  for (int t0 = warp; t0 < ntiles; t0 += U * nw) {
    int p[U][CPL];  // every load of the round in flight before any reduction
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = (t0 + u * nw) * TC + 32 * i + lane;
        p[u][i] = c < C ? kp[c] : INT_MAX;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * nw;
      int mn = p[u][0];
#pragma unroll
      for (int i = 1; i < CPL; ++i) mn = min(mn, p[u][i]);
      mn = __reduce_min_sync(0xffffffffu, mn);
      if (lane == 0 && t < min(ntiles, kMaxTiles)) tmin[t] = mn;
      lo = min(lo, mn);
    }
  }
  if (lane == 0 && lo != INT_MAX) atomicMin(kvmin, lo);
}

// (least, greatest) of pos_of(i), i < n, by one warp.
template <typename PosOf>
__device__ int2 warp_qrange(int n, PosOf pos_of) {
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll 4
  for (int i = threadIdx.x % 32; i < n; i += 32) {
    const int p = pos_of(i);
    mn = min(mn, p);
    mx = max(mx, p);
  }
  return make_int2(__reduce_min_sync(0xffffffffu, mn), __reduce_max_sync(0xffffffffu, mx));
}

// Which tiles a row tile walks: all of them when one of its rows sees no
// key (seeded false), else those whose least position is <= its greatest
// query position; tiles past the held ones count as visible.
struct Vis {
  const int* tmin;
  int held, ntiles;
  bool seeded;
  int qmax;
  __device__ bool operator()(int t) const { return !seeded || t >= held || tmin[t] <= qmax; }
};

// Visible tiles of a row tile, by one warp.
__device__ int warp_count(const Vis& v) {
  const int lane = threadIdx.x % 32;
  int n = 0;
  for (int t0 = 0; t0 < v.held; t0 += 32) {
    const int t = t0 + lane;
    n += __popc(__ballot_sync(0xffffffffu, t < v.held && v(t)));
  }
  return n + (v.ntiles - v.held);
}

// The held visible tiles of a row tile, in order, into list, by one warp;
// returns how many there are (tile i of the walk is list[i] below that,
// then held + (i - count)).
__device__ int warp_list(const Vis& v, int* list) {
  const int lane = threadIdx.x % 32;
  int n = 0;
  for (int t0 = 0; t0 < v.held; t0 += 32) {
    const int t = t0 + lane;
    const bool on = t < v.held && v(t);
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (on) list[n + __popc(bal & ((1u << lane) - 1u))] = t;
    n += __popc(bal);
  }
  __syncwarp();
  return n;
}

// One CTA's run: row tile r, walk tiles [k_lo, k_hi), run `first + i` of
// the row tile's nparts (its runs are CTAs first .. first + nparts - 1).
struct Piece {
  int r, k_lo, k_hi, nparts, first;
};

// The split plan from the row tiles' visible counts rn[0, R): the least L
// >= min_tiles with sum ceil(rn[r] / L) <= X; row tile r is cut into p =
// ceil(rn[r] / L) runs of as equal length as whole tiles allow (run i:
// [i rn / p, (i + 1) rn / p)), numbered row tile by row tile; false for a
// CTA j past the last run (idle). ops/flash_attention.flash_unit_pieces is
// the same plan on the host.
__device__ bool find_piece(const int* rn, int R, int X, int min_tiles, int j, Piece& pc) {
  int ntot = 0, nmax = 1;
  for (int r = 0; r < R; ++r) {
    ntot += rn[r];
    nmax = max(nmax, rn[r]);
  }
  auto runs = [&](int L) {
    int n = 0;
    for (int r = 0; r < R; ++r) n += (rn[r] + L - 1) / L;
    return n;
  };
  int L = max(min_tiles, (ntot + X - 1) / X);
  if (L < nmax && runs(L) > X) {
    int lo = L, hi = nmax;  // runs(lo) > X >= runs(hi) = R
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (runs(mid) <= X)
        hi = mid;
      else
        lo = mid;
    }
    L = hi;
  }
  int pre = 0;
  for (int r = 0; r < R; ++r) {
    const int p = (rn[r] + L - 1) / L;
    if (j < pre + p) {
      const int i = j - pre;
      pc = Piece{r, i * rn[r] / p, (i + 1) * rn[r] / p, p, pre};
      return true;
    }
    pre += p;
  }
  return false;
}

// Fold the nparts f32 partials of rows [0, rows) of a row tile (slot i at
// base + i * slot: acc [BM][D], then (m, l) [BM][2], m in the log2 domain)
// with the recurrence of combine_attn_stats (m = max m_i, l = sum 2^(m_i -
// m) l_i, acc likewise; a run in which a row saw no key weighs 0 against
// one in which it did) and write acc / max(l, 1e-30) of row r, head dim d,
// through out_at(r, d), in slot (= column) order. The n threads of named
// barrier kBar (thread tid of them) first put each row's weights 2^(m_i -
// m) / l into w [nparts][BM] (shared memory), then stream the partials as
// float4s, every thread a 16-byte column of one row at a time. Partials
// are read past L1 (other CTAs wrote them).
template <int D, int BM, typename OutAt>
__device__ void merge_slots(const float* __restrict__ base, size_t slot, int nparts, int rows,
                            OutAt out_at, float* __restrict__ w, int tid, int n) {
  for (int r = tid; r < rows; r += n) {
    float M = kNegInf, Ls = 0.f;
#pragma unroll 4
    for (int i = 0; i < nparts; ++i) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(base + i * slot + size_t(BM) * D) + r);
      const float mn = fmaxf(M, x.x);
      Ls = Ls * attn::ex2(M - mn) + x.y * attn::ex2(x.x - mn);
      M = mn;
    }
    const float inv = 1.f / fmaxf(Ls, 1e-30f);
#pragma unroll 4
    for (int i = 0; i < nparts; ++i)
      w[i * BM + r] = attn::ex2(__ldcg(base + i * slot + size_t(BM) * D + 2 * r) - M) * inv;
  }
  attn::named_bar(kBar, n);
  // U items a thread at a time, all their loads in flight before any store
  constexpr int C4 = D / 4, U = 8;
  const int total = rows * C4;
  for (int idx0 = tid; idx0 < total; idx0 += U * n) {
    float4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < nparts; ++i) {
      float4 x[U];
      float wi[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = min(idx0 + u * n, total - 1), r = idx / C4;
        x[u] = __ldcg(reinterpret_cast<const float4*>(base + i * slot + size_t(r) * D) + idx % C4);
        wi[u] = w[i * BM + r];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        a[u].x = fmaf(wi[u], x[u].x, a[u].x);
        a[u].y = fmaf(wi[u], x[u].y, a[u].y);
        a[u].z = fmaf(wi[u], x[u].z, a[u].z);
        a[u].w = fmaf(wi[u], x[u].w, a[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = idx0 + u * n;
      if (idx >= total) continue;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_at(idx / C4, 4 * (idx % C4)));
      dst[0] = __floats2bfloat162_rn(a[u].x, a[u].y);
      dst[1] = __floats2bfloat162_rn(a[u].z, a[u].w);
    }
  }
}

// ---------------------------------------------- bf16: wgmma + TMA kernel

template <int D, bool kFold>
struct WL {
  static constexpr int NB = D / 64;         // 64-column boxes across a row
  static constexpr int kWG = kFold ? 1 : 2;  // consumer warpgroups
  static constexpr int BM = kBM * kWG;       // rows of a CTA
  static constexpr bool kInline = !kFold && D == 256;  // no producer warp
  static constexpr int kThreads = 128 * kWG + (kInline ? 0 : 32);
  static constexpr int kStages = (!kFold && D <= 128) ? 4 : 2;
  static constexpr int kCtasPerSm = (kFold && D <= 128) ? 2 : 1;
  static constexpr int Q = 0;  // [kWG][NB] boxes
  static constexpr int K = Q + kWG * NB * kBox;
  static constexpr int V = K + kStages * NB * kBox;
  static constexpr int POS = V + kStages * NB * kBox;  // int [kStages][kBN]
  static constexpr int C0 = POS + kStages * kBN * 4;   // int [kStages], -1 = end
  static constexpr int ALL = C0 + kStages * 4;         // int [kStages], 1 = unmasked tile
  static constexpr int PLAN = (ALL + kStages * 4 + 15) / 16 * 16;
  static constexpr int BAR = (PLAN + PlanSmem::BYTES + 7) / 8 * 8;
  static constexpr size_t BYTES = BAR + (2 * kStages + 1) * 8 + 1024;  // + base alignment
  static_assert(BYTES * kCtasPerSm + 1024 * kCtasPerSm <= 233472, "shared memory");
  // the merge's weights of up to kMaxParts runs reuse the K/V ring
  static_assert(POS - K >= kMaxParts * BM * 4, "merge weights");
};

// The ring's producer: fills the next stage with the run's next tile (K
// and V boxes by TMA, the tile's key positions, its first column and its
// unmasked flag: every key exists and is visible to every row), or with the
// end marker after the last. A tile whose keys no row sees is left out once
// every row has seen a key in a tile already issued (seen <= qmin): it
// would add exactly zero (the rule of a walk without the scan; after the
// scan it leaves out nothing the scan kept but tiles past the held ones).
// Warp-collective.
template <class L>
struct Feed {
  uint32_t sb;
  char* smem;
  const CUtensorMap *tk, *tv;
  const int *kp, *list;
  int C, kh, b, k, k_hi, nheld, held, qmin, qmax;
  int stage, seen;
  uint32_t parity;
  bool ended;

  __device__ int tile_at(int i) const { return i < nheld ? list[i] : held + (i - nheld); }

  __device__ void next(int lane) {
    if (ended) return;
    int c0 = -1, p0 = 0, p1 = 0, tmx = 0;
    while (k < k_hi) {
      const int c = tile_at(k++) * kBN;
      p0 = c + lane < C ? kp[c + lane] : INT_MAX;
      p1 = c + 32 + lane < C ? kp[c + 32 + lane] : INT_MAX;
      const int tmn = __reduce_min_sync(0xffffffffu, min(p0, p1));
      if (tmn > qmax && seen <= qmin) continue;  // adds exactly zero to every row
      seen = min(seen, tmn);
      tmx = __reduce_max_sync(0xffffffffu, max(p0, p1));
      c0 = c;
      break;
    }
    const uint32_t full = sb + L::BAR + 8 * stage;
    const uint32_t empty = sb + L::BAR + 8 * (L::kStages + stage);
    if (lane == 0) hopper::mbar_wait(empty, parity);
    __syncwarp();
    int* sc0 = reinterpret_cast<int*>(smem + L::C0);
    if (c0 >= 0) {
      int* sp = reinterpret_cast<int*>(smem + L::POS) + stage * kBN;
      sp[lane] = p0;
      sp[32 + lane] = p1;
      if (lane == 0) {
        sc0[stage] = c0;
        reinterpret_cast<int*>(smem + L::ALL)[stage] = c0 + kBN <= C && tmx <= qmin;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_expect_tx(full, 2 * L::NB * kBox);
        for (int nb = 0; nb < L::NB; ++nb) {
          const uint32_t off = (stage * L::NB + nb) * kBox;
          hopper::tma_load_4d(sb + L::K + off, tk, nb * 64, kh, c0, b, full);
          hopper::tma_load_4d(sb + L::V + off, tv, nb * 64, kh, c0, b, full);
        }
      }
    } else {
      if (lane == 0) {
        sc0[stage] = -1;
        hopper::mbar_arrive(full);
      }
      ended = true;
    }
    if (++stage == L::kStages) {
      stage = 0;
      parity ^= 1;
    }
  }
};

template <int D, bool kFold>
__global__ void __launch_bounds__(WL<D, kFold>::kThreads, WL<D, kFold>::kCtasPerSm)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const int* qpos, const int* kvpos,
                   __nv_bfloat16* out, float* part, int* tickets, int S, int C, int Nh, int Nkv,
                   int min_tiles, float scale) {
  using L = WL<D, kFold>;
  constexpr int NB = L::NB, kStages = L::kStages, kWG = L::kWG, BM = L::BM;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sb = hopper::smem_u32(smem);
  const PlanPtrs pl(smem + L::PLAN);
  auto full = [&](int st) { return sb + L::BAR + 8 * st; };
  auto empty = [&](int st) { return sb + L::BAR + 8 * (kStages + st); };
  const uint32_t qbar = sb + L::BAR + 16 * kStages;

  const int j = blockIdx.x, head = blockIdx.y, b = blockIdx.z, X = gridDim.x;
  const int G = Nh / Nkv, GS = G * S;
  const int kh = kFold ? head : head / G;
  const int R = kFold ? 1 : (S + BM - 1) / BM;
  const bool split = X > R;
  const int ntiles = (C + kBN - 1) / kBN;
  // a cache of at most min_tiles tiles is walked whole: no split can pay for
  // its merge there, and the heaviest row tile sees every tile anyway
  const bool scan = split || ntiles > min_tiles;
  const int held = scan ? min(ntiles, kMaxTiles) : 0;
  const int* kp = kvpos + size_t(b) * C;
  const int* qrow = qpos + size_t(b) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int nw = L::kThreads / 32;

  const bool producer = L::kInline ? warp == 0 : warp == 4 * kWG;
  // Q of row tile r (s0 its first position) by TMA
  auto load_q = [&](int s0) {
    if constexpr (kFold) {
      // the G*S folded rows as one box of G heads by S positions
      hopper::mbar_expect_tx(qbar, NB * GS * 128);
      for (int nb = 0; nb < NB; ++nb)
        hopper::tma_load_4d(sb + L::Q + nb * kBox, &tm_q, nb * 64, kh * G, 0, b, qbar);
    } else {
      hopper::mbar_expect_tx(qbar, kWG * NB * kBox);
      for (int w = 0; w < kWG; ++w)
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_4d(sb + L::Q + (w * NB + nb) * kBox, &tm_q, nb * 64, head,
                              s0 + w * kBM, b, qbar);
    }
  };
  const int r_own = R - 1 - j;  // without a split: row tiles heaviest first
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), 128 * kWG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
    pl.misc[0] = INT_MAX;
  }
  __syncthreads();
  // without a split the row tile is known: its Q loads during the plan
  if (!split && producer && lane == 0) load_q(r_own * BM);
  // query ranges: every row tile of a split plan, else this CTA's (slot 0,
  // by the producer while the other warps take the key positions)
  auto qrange = [&](int i) {
    const int r = split ? i : r_own;
    const int s_lo = kFold ? 0 : r * BM, n = kFold ? S : min(BM, S - s_lo);
    const int2 q = warp_qrange(n, [&](int x) { return qrow[s_lo + x]; });
    if (lane == 0) pl.rq[i] = q;
    __syncwarp();
  };
  if (split) {
    for (int i = warp; i < R; i += nw) qrange(i);
    tile_ranges<kBN>(kp, C, pl.tmin, pl.misc, warp, nw);
  } else if (producer) {
    qrange(0);
  } else if (scan) {
    tile_ranges<kBN>(kp, C, pl.tmin, pl.misc, L::kInline ? warp - 1 : warp, nw - 1);
  }
  // without the scan only the producer reads the plan: no CTA barrier
  if (scan) __syncthreads();
  const int kvmin = pl.misc[0];
  auto vis_of = [&](int i) {
    const int2 q = pl.rq[i];
    return Vis{pl.tmin, held, ntiles, q.x >= kvmin, q.y};
  };
  Piece pc{r_own, 0, 0, 1, 0};
  if (split) {
    for (int i = warp; i < R; i += nw) {
      const int n = warp_count(vis_of(i));
      if (lane == 0) pl.rn[i] = n;
    }
    __syncthreads();
    if (!find_piece(pl.rn, R, X, min_tiles, j, pc)) return;  // an idle CTA
  }
  // a split's run, for the consumers' epilogue (read back after the walk,
  // so it holds no register through it)
  if (split && threadIdx.x == 0) {
    pl.misc[4] = pc.r;
    pl.misc[5] = pc.nparts;
    pl.misc[6] = pc.first;
  }
  auto row_range = [&](int r, int& s0, int& rows) {
    s0 = kFold ? 0 : r * BM;
    rows = kFold ? GS : min(BM, S - s0);
  };

  // ------------------------------------------------------------ producer
  // (a fresh empty barrier passes parity 1)
  auto make_feed = [&]() {
    const int2 q = pl.rq[split ? pc.r : 0];
    return Feed<L>{sb, smem, &tm_k, &tm_v, kp, pl.list, C, kh, b, pc.k_lo, pc.k_hi,
                   0, held, q.x, q.y, 0, INT_MAX, 1u, false};
  };
  auto start_feed = [&](Feed<L>& feed) {
    feed.nheld = warp_list(vis_of(split ? pc.r : 0), pl.list);
    if (!split) feed.k_hi = feed.nheld + (ntiles - held);
    if (split && lane == 0) load_q(pc.r * BM);
  };
  if constexpr (!L::kInline) {
    if (producer) {
      Feed<L> feed = make_feed();
      start_feed(feed);
      while (!feed.ended) feed.next(lane);
      return;
    }
  }
  Feed<L> feed = make_feed();  // the inline producer's (warp 0)
  if constexpr (L::kInline) {
    if (producer) {
      start_feed(feed);
      for (int i = 0; i < kStages - 1; ++i) feed.next(lane);
    }
  }

  // -------------------------------------------------------------- consumers
  const float sl2 = scale * kLog2e;
  const int tid = threadIdx.x, wg = tid / 128, quad = lane % 4;
  const int row = wg * kBM + (warp % 4) * 16 + lane / 4;  // this thread's rows: row, row + 8
  int qp[2];
  {
    int s0, rows;
    row_range(pc.r, s0, rows);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int rr = row + 8 * t;
      qp[t] = rr < rows ? qrow[kFold ? rr / G : s0 + rr] : INT_MIN;
    }
  }
  float o[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(qbar, 0);
  const wgattn::Ring ring{sb + L::K, sb + L::V, full(0), empty(0),
                          reinterpret_cast<int*>(smem + L::POS), reinterpret_cast<int*>(smem + L::C0),
                          reinterpret_cast<int*>(smem + L::ALL)};
  if constexpr (L::kInline) {
    auto refill = [&]() {
      if (warp == 0) feed.next(lane);
    };
    wgattn::consume<D, kStages>(ring, sb + L::Q + wg * NB * kBox, C, qp, sl2, o, m, l, kNegInf,
                                refill);
  } else {
    wgattn::consume<D, kStages>(ring, sb + L::Q + wg * NB * kBox, C, qp, sl2, o, m, l);
  }

  int run_r = r_own, nparts = 1, first = 0;
  if (split) {
    attn::named_bar(kBar, 128 * kWG);  // thread 0's record of the run is visible
    run_r = pl.misc[4];
    nparts = pl.misc[5];
    first = pl.misc[6];
  }
  int s0, rows;
  row_range(run_r, s0, rows);
  // row rr of the CTA -> its output row (head dim 0)
  auto out_row = [&](int rr) {
    const size_t orow = kFold ? (size_t(b) * S + rr / G) * Nh + size_t(kh) * G + rr % G
                              : (size_t(b) * S + s0 + rr) * Nh + head;
    return out + orow * D;
  };
  float ls[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    ls[t] = l[t];
    ls[t] += __shfl_xor_sync(0xffffffffu, ls[t], 1);
    ls[t] += __shfl_xor_sync(0xffffffffu, ls[t], 2);
  }
  if (nparts == 1) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int rr = row + 8 * t;
      if (rr >= rows) continue;
      const float den = fmaxf(ls[t], 1e-30f);
      __nv_bfloat16* dst = out_row(rr) + 2 * quad;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * nb + 8 * jj) = __floats2bfloat162_rn(
              o[32 * nb + 4 * jj + 2 * t] / den, o[32 * nb + 4 * jj + 2 * t + 1] / den);
    }
    return;
  }
  // this run's partial: acc [BM][D], then (m, l) [BM][2], in slot j of the
  // unit's scratch
  const size_t slot = size_t(BM) * (D + 2);
  float* base = part + ((size_t(b) * gridDim.y + head) * X + first) * slot;
  float* pacc = base + size_t(j - first) * slot;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int rr = row + 8 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(pacc + size_t(rr) * D + 64 * nb + 8 * jj + 2 * quad) =
            make_float2(o[32 * nb + 4 * jj + 2 * t], o[32 * nb + 4 * jj + 2 * t + 1]);
    if (quad == 0)
      *reinterpret_cast<float2*>(pacc + size_t(BM) * D + 2 * rr) = make_float2(m[t], ls[t]);
  }
  int* ticket = tickets + (size_t(b) * gridDim.y + head) * R + run_r;
  if (attn::last_run(ticket, nparts, pl.misc + 2, kBar, 128 * kWG, tid)) {
    auto out_at = [&](int r, int d) { return out_row(r) + d; };
    merge_slots<D, BM>(base, slot, nparts, rows, out_at, reinterpret_cast<float*>(smem + L::K),
                       tid, 128 * kWG);
    if (tid == 0) *ticket = 0;
  }
}

// -------------------------------------------- f32: 3xTF32 on mma.sync

template <int D>
struct FL32 {
  static constexpr int NW = D == 256 ? 4 : 8;  // warps, 16 rows each
  static constexpr int BM = 16 * NW;
  static constexpr int BN = D == 256 ? 32 : 64;  // keys per tile
  // row strides (floats): 8 mod 32 for the 8-byte Q / K fragment loads, 4
  // mod 32 for V's column reads: conflict-free across a warp
  static constexpr int LDQ = D + 8, LDK = D + 8, LDV = D + 4;
  static constexpr int kThreads = 32 * NW;
  static constexpr int Q = 0;
  static constexpr int K = Q + BM * LDQ * 4;
  static constexpr int V = K + 2 * BN * LDK * 4;
  static constexpr int POS = V + 2 * BN * LDV * 4;  // int [2][BN]
  static constexpr int PLAN = POS + 2 * BN * 4;
  static constexpr size_t BYTES = PLAN + PlanSmem::BYTES;
  static_assert(BYTES <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(FL32<D>::kThreads, 1)
flash_f32_kernel(const float* q, const float* k, const float* v, const int* qpos,
                 const int* kvpos, float* out, int S, int C, int Nh, int Nkv, int min_tiles,
                 float scale) {
  using L = FL32<D>;
  constexpr int BM = L::BM, BN = L::BN, LDQ = L::LDQ, LDK = L::LDK, LDV = L::LDV;
  constexpr int CH = D / 4;  // 16-byte chunks of a row
  extern __shared__ __align__(16) char smem[];
  float* sq = reinterpret_cast<float*>(smem + L::Q);
  float* sk = reinterpret_cast<float*>(smem + L::K);
  float* sv = reinterpret_cast<float*>(smem + L::V);
  int* spos = reinterpret_cast<int*>(smem + L::POS);
  const PlanPtrs pl(smem + L::PLAN);
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = Nh / Nkv, GS = G * S;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int ntiles = (C + BN - 1) / BN;
  const bool scan = ntiles > min_tiles;  // else every tile is walked
  const int held = scan ? min(ntiles, kMaxTiles) : 0;
  const int* kp = kvpos + size_t(b) * C;
  const int* qrow = qpos + size_t(b) * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // folded row fr = g * S + s -> element offset of its head dim 0 in q / out
  auto row_off = [&](int fr) { return ((size_t(b) * S + fr % S) * Nh + size_t(kh) * G + fr / S) * D; };

  if (tid == 0) pl.misc[0] = INT_MAX;
  __syncthreads();
  if (scan && warp == L::NW - 1) {
    const int2 r = warp_qrange(min(BM, GS - r0), [&](int x) { return qrow[(r0 + x) % S]; });
    if (lane == 0) pl.rq[0] = r;
  } else if (scan) {
    tile_ranges<BN>(kp, C, pl.tmin, pl.misc, warp, L::NW - 1);
  }
  for (int idx = tid; idx < BM * CH; idx += L::kThreads) {
    const int r = idx / CH, ch = idx % CH, fr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (fr < GS) x = *reinterpret_cast<const float4*>(q + row_off(fr) + 4 * ch);
    *reinterpret_cast<float4*>(sq + r * LDQ + 4 * ch) = x;
  }
  __syncthreads();
  if (warp == 0) {
    const int n = warp_list(Vis{pl.tmin, held, ntiles, pl.rq[0].x >= pl.misc[0], pl.rq[0].y},
                            pl.list);
    if (lane == 0) pl.misc[1] = n;
  }
  __syncthreads();
  const int nheld = pl.misc[1], N = nheld + (ntiles - held);
  auto tile_at = [&](int i) { return i < nheld ? pl.list[i] : held + (i - nheld); };
  // tile i of the walk into stage st: K and V rows (zeros past C), positions
  auto load = [&](int i, int st) {
    const int c0 = tile_at(i) * BN;
    for (int idx = tid; idx < BN * CH; idx += L::kThreads) {
      const int r = idx / CH, ch = idx % CH, c = c0 + r;
      const bool ok = c < C;
      const size_t off = ((size_t(b) * C + (ok ? c : 0)) * Nkv + kh) * D + 4 * ch;
      hopper::cp_async16(hopper::smem_u32(sk + (st * BN + r) * LDK + 4 * ch), k + off, ok ? 16 : 0);
      hopper::cp_async16(hopper::smem_u32(sv + (st * BN + r) * LDV + 4 * ch), v + off, ok ? 16 : 0);
    }
    if (tid < BN) {
      const int c = c0 + tid;
      hopper::cp_async4(hopper::smem_u32(spos + st * BN + tid), kp + (c < C ? c : 0), c < C ? 4 : 0);
    }
    hopper::cp_async_commit();
  };

  const float sl2 = scale * kLog2e;
  const int g = lane / 4, t4 = lane % 4;
  const int ra = 16 * warp + g;  // this thread's rows: ra, ra + 8
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = r0 + ra + 8 * h;
    qp[h] = fr < GS ? qrow[fr % S] : INT_MIN;
  }
  // o[dn][e]: row ra + 8 (e / 2), head dim 8 dn + 2 t4 + e % 2
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (N > 0) load(0, 0);
  for (int i = 0; i < N; ++i) {
    const int st = i & 1;
    if (i + 1 < N) {
      load(i + 1, st ^ 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = sk + st * BN * LDK;
    const float* vt = sv + st * BN * LDV;
    const int* sp = spos + st * BN;
    const int c0 = tile_at(i) * BN;
    // S = Q K^T: s[n][e] is row ra + 8 (e / 2), key 8 n + 2 t4 + e % 2;
    // k-index t4 of a step is head dim 8 d8 + 2 t4, k-index t4 + 4 is 2 t4 + 1
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
    for (int d8 = 0; d8 < D / 8; ++d8) {
      const float2 qa = *reinterpret_cast<const float2*>(sq + ra * LDQ + 8 * d8 + 2 * t4);
      const float2 qb = *reinterpret_cast<const float2*>(sq + (ra + 8) * LDQ + 8 * d8 + 2 * t4);
      uint32_t ab[4], az[4];
      hopper::tf32_split(qa.x, ab[0], az[0]);
      hopper::tf32_split(qb.x, ab[1], az[1]);
      hopper::tf32_split(qa.y, ab[2], az[2]);
      hopper::tf32_split(qb.y, ab[3], az[3]);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float2 kx = *reinterpret_cast<const float2*>(kt + (8 * n + g) * LDK + 8 * d8 + 2 * t4);
        uint32_t b0, b0s, b1, b1s;
        hopper::tf32_split(kx.x, b0, b0s);
        hopper::tf32_split(kx.y, b1, b1s);
        hopper::mma_1688_tf32(s[n], az, b0, b1);
        hopper::mma_1688_tf32(s[n], ab, b0s, b1s);
        hopper::mma_1688_tf32(s[n], ab, b0, b1);
      }
    }
    // mask, online softmax (log2 domain) on the fragment; a row spans a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t4 + e;
          float& x = s[n][2 * h + e];
          x = c0 + col >= C ? -INFINITY : sp[col] <= qp[h] ? x * sl2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      const float corr = attn::ex2(m[h] - mn);
      m[h] = mn;
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * h + e];
          x = attn::ex2(x - mn);
          ps += x;
        }
      l[h] = l[h] * corr + ps;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * h] *= corr;
        o[dn][2 * h + 1] *= corr;
      }
    }
    // O += P V: the score fragment of keys 8 j8 .. 8 j8 + 7 is P's A
    // fragment with k-index t4 as key 2 t4 and t4 + 4 as key 2 t4 + 1
#pragma unroll
    for (int j8 = 0; j8 < BN / 8; ++j8) {
      uint32_t pb[4], pz[4];
      hopper::tf32_split(s[j8][0], pb[0], pz[0]);
      hopper::tf32_split(s[j8][2], pb[1], pz[1]);
      hopper::tf32_split(s[j8][1], pb[2], pz[2]);
      hopper::tf32_split(s[j8][3], pb[3], pz[3]);
      const float* v0 = vt + (8 * j8 + 2 * t4) * LDV + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b0, b0s, b1, b1s;
        hopper::tf32_split(v0[8 * dn], b0, b0s);
        hopper::tf32_split(v0[LDV + 8 * dn], b1, b1s);
        hopper::mma_1688_tf32(o[dn], pz, b0, b1);
        hopper::mma_1688_tf32(o[dn], pb, b0s, b1s);
        hopper::mma_1688_tf32(o[dn], pb, b0, b1);
      }
    }
    __syncthreads();  // the stage is free for tile i + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ls = l[h];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const int fr = r0 + ra + 8 * h;
    if (fr >= GS) continue;
    const float den = fmaxf(ls, 1e-30f);
    float* dst = out + row_off(fr) + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + 8 * dn) = make_float2(o[dn][2 * h] / den, o[dn][2 * h + 1] / den);
  }
}

// ------------------------------------------------------------------ host

struct FlashArgs {
  const void *q, *k, *v;
  const int *qpos, *kvpos;
  void* out;
  float* part;
  int* tickets;
  int B, S, C, Nh, Nkv, pieces, min_tiles;
  float scale;
  cudaStream_t stream;
};

template <int D, bool kFold>
int run_wgmma(const FlashArgs& a) {
  using L = WL<D, kFold>;
  const int G = a.Nh / a.Nkv;
  CUtensorMap tq, tk, tv;
  const bool okq = kFold ? hopper::map_bf16_4d(&tq, a.q, D, a.Nh, a.S, a.B, a.S, G)
                         : hopper::map_bf16_4d(&tq, a.q, D, a.Nh, a.S, a.B);
  if (!okq || !hopper::map_bf16_4d(&tk, a.k, D, a.Nkv, a.C, a.B) ||
      !hopper::map_bf16_4d(&tv, a.v, D, a.Nkv, a.C, a.B))
    return attn::kNoTensorMap;
  const dim3 grid(a.pieces, kFold ? a.Nkv : a.Nh, a.B);
  return attn::launch_n(flash_wgmma_kernel<D, kFold>, grid, L::kThreads, L::BYTES, a.stream, tq,
                        tk, tv, a.qpos, a.kvpos, static_cast<__nv_bfloat16*>(a.out), a.part,
                        a.tickets, a.S, a.C, a.Nh, a.Nkv, a.min_tiles, a.scale);
}

template <int D>
int run_f32(const FlashArgs& a) {
  using L = FL32<D>;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const dim3 grid((GS + L::BM - 1) / L::BM, a.Nkv, a.B);
  return attn::launch_n(flash_f32_kernel<D>, grid, L::kThreads, L::BYTES, a.stream,
                        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                        static_cast<const float*>(a.v), a.qpos, a.kvpos, static_cast<float*>(a.out),
                        a.S, a.C, a.Nh, a.Nkv, a.min_tiles, a.scale);
}

// The bf16 route: folded rows when they fit one warpgroup and the cache
// has more than min_tiles tiles (a smaller one costs a few L2 reads per
// query head, and a CTA per head keeps more of them in flight), else per
// head (ops/flash_attention.flash_route).
bool fold_route(int S, int C, int Nh, int Nkv, int min_tiles) {
  return (Nh / Nkv) * S <= kFoldRows && (C + kBN - 1) / kBN > min_tiles;
}

template <int D>
int run(const FlashArgs& a, int dtype) {
  if (dtype == 0) return run_f32<D>(a);
  if (fold_route(a.S, a.C, a.Nh, a.Nkv, a.min_tiles)) return run_wgmma<D, true>(a);
  return run_wgmma<D, false>(a);
}

}  // namespace

// q [B,S,Nh,D], k/v [B,C,Nkv,D], qpos [B,S], kvpos [B,C] int32, out like q;
// all contiguous on the device. dtype 0 = float32 (the "f32" route), 1 =
// bfloat16 ("fold" or "heads", fold_route). pieces: CTAs
// per (batch row, head) unit from ops/flash_attention.plan_flash (the bf16
// routes; more than the unit's row tiles = a split, which needs part, f32
// scratch of plan_flash's size, and tickets, int32 zeros left zero);
// min_tiles: no split and no visibility scan for a cache of at most this
// many tiles, and no run shorter than about half of it. One launch; returns
// 0 or the launch's error code (attn_error_string names it).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const int* qpos,
                                   const int* kvpos, void* out, float* part, int* tickets, int B,
                                   int S, int C, int Nh, int Nkv, int D, int pieces, int min_tiles,
                                   float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || C < 1 || Nkv < 1 || Nh % Nkv != 0 || pieces < 1 || min_tiles < 1 ||
      (dtype != 0 && dtype != 1))
    return attn::kBadArgs;
  if (dtype == 1) {
    const bool fold = fold_route(S, C, Nh, Nkv, min_tiles);
    const int R = fold ? 1 : (S + 2 * kBM - 1) / (2 * kBM);
    if (pieces < R) return attn::kBadArgs;
    if (pieces > R &&
        (R > kMaxRowTiles || pieces > kMaxParts || part == nullptr || tickets == nullptr))
      return attn::kBadArgs;
  }
  const FlashArgs a{q,     k,        v,         qpos, kvpos, out, part, tickets, B, S, C, Nh,
                    Nkv,   pieces,   min_tiles, scale, static_cast<cudaStream_t>(stream)};
  if (D == 64) return run<64>(a, dtype);
  if (D == 128) return run<128>(a, dtype);
  if (D == 256) return run<256>(a, dtype);
  return attn::kBadArgs;
}
