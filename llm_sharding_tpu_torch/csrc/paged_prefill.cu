// Chunked-prefill attention over the pooled KV arena: the port of
// llm_sharding_tpu/ops/paged_attention.py:689 (paged_prefill_tpu, body
// _paged_prefill_kernel at :619), in every KV mode: an arena in the query
// dtype, or int8 / fp8-e4m3 codes with per-(block, KV head) f32 scales.
// The queries are one prompt chunk per row; the KV loop of row b stops at
// its written frontier, min(T, nlive[b]) blocks (the TPU kernel re-named
// dead blocks to block 0 so their DMA was elided, :765-778); inside it a
// key of table entry 0 (the shared trash block, which may hold NaN/Inf)
// is a zero key and a zero value, never read. Causality comes from
// positions alone: the chunk's own KV was written before the call.
//
// What bounds it on the H100: at Sc = 256 over a 2048-token frontier each
// query head does ~4 * D flops per visible query-key pair against a few
// bytes per key, far above the ~295 flops/byte ridge, so it is bound by
// operations, and only the tensor cores reach the card's rate.
//
// Route, chosen by the wrapper (ops/paged_attention.prefill_design) from
// the dtype and the block size before the launch, never by failure:
//
// - bf16 queries with block size 16, 32 or a multiple of 64: the
//   tensor-core kernel below, in all three KV modes;
// - f32 queries (on the tensor cores f32 would be TF32), and bf16 at any
//   other block size: the CUDA-core attn::Tile (attn_tile.cuh), a
//   GQA-folded query tile per CTA, grid (ceil(G*Sc / BQ), Nkv, B).
//
// The tensor-core kernel (hopper.cuh has the primitives, wgmma_attn.cuh
// the consumer loop it shares with flash_attention.cu):
//
// - One CTA = 128 chunk positions of ONE query head (Q is a TMA box, as in
//   flash): two consumer warpgroups of 64 rows, S = Q K^T and O += P V on
//   wgmma, the softmax in the log2 domain on the fragment, P rounded to
//   bf16 in registers, out = O / max(l, 1e-30).
// - The block table as TMA boxes: the arena [NB, BS, Nkv, D] is a 4-D
//   tensor map (column, KV head, slot, block). A 64-key tile is 64/BS boxes
//   of BS slots (BS = 16, 32) or one 64-slot box at slot c0 % BS (BS a
//   multiple of 64; the served BS = 64 is one arena block per tile). The
//   producer warp reads the row's table entries itself (two tiles ahead
//   of the tile it issues) and streams K/V tiles into a 4-stage ring with
//   full/empty mbarriers. A box of table entry 0, or past the walk's end,
//   is never loaded: the producer zero-fills those rows of the stage (a
//   plain store, then a proxy fence, before it arrives), so a trash key
//   scores exactly 0 and adds 0 to O, and a column past the end scores
//   -inf.
// - Exact skip, decided by the producer from positions before the loads:
//   a tile is skipped when none of its keys is visible to any real row of
//   the CTA and every real row has already seen a key; a tile whose every
//   key exists and is visible to every row is flagged, and the consumers
//   skip its mask (at Sc = 256 that is every tile below the chunk).
// - Code arenas: the producer streams the int8 / fp8 codes of each tile (a
//   D-byte row per key, unswizzled) into a 3-stage code ring of its own,
//   so it runs ahead of the consumers; a dequant group of three warps
//   turns each code into f32 exactly (int8 by building 2^23 + x + 128 as
//   f32 and subtracting, no conversion instruction), times its (block, KV
//   head) scale, rounded once to bf16 (the plain version's kv_dequantize),
//   into the next free stage of the 4-stage 128-byte-swizzled bf16 ring
//   that wgmma reads, while the consumers work on earlier tiles. A dead
//   key's row is written as zeros by a select: its codes are never loaded
//   and its scale (Inf on the trash block) is never read. 384 threads in
//   all, 168 registers each (the consumers need no more; handing the
//   producer group's registers over with setmaxnreg measured slower). At
//   head dim 256 the rings are 2 (bf16) and 1 (codes) stages deep (PSmem's
//   note).
// - Filling the card at B = 1: when B * Nh * ceil(Sc/128) CTAs fall short of
//   the SMs, each row's live columns are cut into nsplit runs
//   (ops/paged_attention.plan_prefill_splits picks nsplit; each CTA sizes
//   its run from its row's nlive with prefill_run_cols' rule). A run
//   writes f32 partials (acc, m, l) that attn::split_merge_kernel folds,
//   launched as a programmatic dependent; a run no row of the CTA can see
//   loads nothing and leaves (0, -1e30, 0). One call is one launch count.
//
// Stats mode (context-parallel serving, attn_tile.cuh's note) runs the same
// kernels with three changes: a key of table entry 0 gets position INT_MAX
// (never visible), a masked score is -inf (it adds exactly zero), and the
// epilogue (or the split merge) writes (acc, m, l) in f32 instead of
// acc / l. A tile no row of the CTA can see is then skipped whatever the
// rows have seen, so a shard's tiles of trash blocks load nothing.

#include <climits>

#include "attn_tile.cuh"
#include "hopper.cuh"
#include "wgmma_attn.cuh"

namespace {

// ------------------------------------------------ f32 (and other BS): Tile

template <typename T, int D, int RI, typename KT>
__global__ void __launch_bounds__(attn::kThreads)
paged_prefill_kernel(const T* q, const KT* k_arena, const KT* v_arena, const float* k_scale,
                     const float* v_scale, const int* tbl, const int* qpos, const int* kvpos,
                     const int* nlive, T* out, float* sacc, float* sm, float* sl, int S, int Nh,
                     int Nkv, int BS, int T_blocks, float scale) {
  extern __shared__ __align__(16) char smem[];
  attn::Tile<T, D, RI, KT> t(smem);
  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * attn::Tile<T, D, RI, KT>::BQ;
  const int G = Nh / Nkv;
  const attn::QGeom g{S, G, Nh, G * S};
  const bool stats = sm != nullptr;
  if (stats) t.masked = -INFINITY;
  t.load_q(q, qpos, b, kh, r0, g);
  const int live_blocks = min(T_blocks, max(nlive[b], 0));
  const attn::PagedCols cols{tbl + size_t(b) * T_blocks, kvpos + size_t(b) * T_blocks * BS, BS,
                             static_cast<long long>(Nkv) * D, static_cast<long long>(kh) * D,
                             k_scale, v_scale, Nkv, kh, stats};
  attn::attend(t, k_arena, v_arena, live_blocks * BS, cols, scale, r0, g.GS);
  if (stats)
    t.store_stats(sacc, sm, sl, b, kh, r0, g);
  else
    t.store(out, b, kh, r0, g);
}

struct PrefillArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *tbl, *qpos, *kvpos, *nlive;
  void* out;
  float *sacc, *sm, *sl;  // stats mode (null otherwise)
  float *part_acc, *part_ml;
  int B, S, Nh, Nkv, BS, Tb, NBk, nsplit, kv;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int RI, typename KT>
int run_kv(const PrefillArgs& a) {
  using Tl = attn::Tile<T, D, RI, KT>;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const dim3 grid((GS + Tl::BQ - 1) / Tl::BQ, a.Nkv, a.B);
  return attn::launch(paged_prefill_kernel<T, D, RI, KT>, grid, Tl::smem_bytes(), a.stream,
                      static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
                      static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.tbl, a.qpos, a.kvpos,
                      a.nlive, static_cast<T*>(a.out), a.sacc, a.sm, a.sl, a.S, a.Nh, a.Nkv, a.BS,
                      a.Tb, a.scale);
}

template <typename T, int D, int RI>
int run(const PrefillArgs& a) {
  KV_DISPATCH(run_kv, T, D, RI, a.kv, a);
}

// ------------------------------------------- bf16: wgmma + TMA over the table

using wgattn::kBM;
using wgattn::kBN;
using wgattn::kBox;
using wgattn::kWG;
constexpr int kDeqThreads = 96;    // the dequant warps of a code arena's producer group
constexpr float kDeadScale = -1.f;  // staged scale of a key that is not loaded (scales are >= 0)

// Shared-memory layout. At head dim 256 a row is four boxes: Q of both
// warpgroups takes 64 KB and one K/V stage 64 KB, so the bf16 ring has 2
// stages (four would need 320 KB of the 227 KB a CTA may have) and the
// code ring 1 (32 KB: 226 KB in all).
template <int D, bool kQuant>
struct PSmem {
  static constexpr int NB = D / 64;                  // bf16 boxes across a row
  static constexpr int kStages = D <= 128 ? 4 : 2;   // bf16 K/V ring the consumers read
  // code ring the dequant warps read
  static constexpr int kCodeStages = kQuant ? (D <= 128 ? 3 : 1) : 0;
  // the producer warp's ring: the bf16 one, or the code one for a code arena
  static constexpr int kWalk = kQuant ? kCodeStages : kStages;
  static constexpr int kThreads = 128 * kWG + (kQuant ? 128 : 32);
  static constexpr int Q = 0;                        // [kWG][NB] boxes
  static constexpr int K = Q + kWG * NB * kBox;      // [kStages][NB] boxes
  static constexpr int V = K + kStages * NB * kBox;
  static constexpr int CODE = V + kStages * NB * kBox;  // [kCodeStages][K, V][kBN][D] bytes
  static constexpr int POS = CODE + kCodeStages * 2 * kBN * D;  // int [kStages][kBN]
  static constexpr int C0 = POS + kStages * kBN * 4;  // int [kStages], -1 = end
  static constexpr int ALL = C0 + kStages * 4;        // int [kStages], 1 = unmasked tile
  // the code ring's own tile records (positions, first column, flag) and
  // each key's K and V scale, float [kCodeStages][K, V][kBN]
  static constexpr int CPOS = ALL + kStages * 4;
  static constexpr int CC0 = CPOS + kCodeStages * kBN * 4;
  static constexpr int CALL = CC0 + kCodeStages * 4;
  static constexpr int SCL = CALL + kCodeStages * 4;
  static constexpr int BAR = (SCL + kCodeStages * 2 * kBN * 4 + 7) / 8 * 8;
  // barriers: full [kStages], empty [kStages], Q, code full [kCodeStages],
  // code empty [kCodeStages]
  static constexpr size_t BYTES = BAR + (2 * kStages + 1 + 2 * kCodeStages) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory");
};

template <int D, typename KT>
__global__ void __launch_bounds__(PSmem<D, !std::is_same<KT, __nv_bfloat16>::value>::kThreads, 1)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* k_scale,
                     const float* v_scale, const int* tbl, const int* qpos, const int* kvpos,
                     const int* nlive, __nv_bfloat16* out, float* sacc, float* sm, float* sl,
                     float* part_acc, float* part_ml, int S, int Nh, int Nkv, int BS,
                     int T_blocks, int nsplit, float scale) {
  constexpr bool kQuant = !std::is_same<KT, __nv_bfloat16>::value;
  using L = PSmem<D, kQuant>;
  constexpr int NB = L::NB, kStages = L::kStages, kCodeStages = L::kCodeStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem =
      reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sb = hopper::smem_u32(smem);
  int* spos = reinterpret_cast<int*>(smem + L::POS);
  int* sc0 = reinterpret_cast<int*>(smem + L::C0);
  int* sall = reinterpret_cast<int*>(smem + L::ALL);
  int* cpos = reinterpret_cast<int*>(smem + L::CPOS);
  int* cc0 = reinterpret_cast<int*>(smem + L::CC0);
  int* call = reinterpret_cast<int*>(smem + L::CALL);
  float* sscl = reinterpret_cast<float*>(smem + L::SCL);
  auto full = [&](int st) { return sb + L::BAR + 8 * st; };
  auto empty = [&](int st) { return sb + L::BAR + 8 * (kStages + st); };
  const uint32_t qbar = sb + L::BAR + 16 * kStages;
  auto cfull = [&](int st) { return sb + L::BAR + 8 * (2 * kStages + 1 + st); };
  auto cempty = [&](int st) { return sb + L::BAR + 8 * (2 * kStages + 1 + kCodeStages + st); };
  auto k_off = [&](int st, int nb) { return L::K + (st * NB + nb) * kBox; };
  auto v_off = [&](int st, int nb) { return L::V + (st * NB + nb) * kBox; };

  const bool stats = sm != nullptr;
  const int h = blockIdx.y, b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int s0 = (gridDim.x - 1 - blockIdx.x) * (kBM * kWG);  // heaviest tiles first
  const int G = Nh / Nkv, kh = h / G;
  // this CTA's run of the row's live columns: prefill_run_cols' rule
  const int live = min(T_blocks, max(nlive[b], 0)) * BS;
  const int unit = max(kBN, BS);
  const int run = ((live + nsplit - 1) / nsplit + unit - 1) / unit * unit;
  const int c_begin = min(live, split * run), c_end = min(live, c_begin + run);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full(st), kQuant ? kDeqThreads : 1);
      hopper::mbar_init(empty(st), 128 * kWG);
    }
    for (int st = 0; st < kCodeStages; ++st) {
      hopper::mbar_init(cfull(st), 1);
      hopper::mbar_init(cempty(st), kDeqThreads);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {
    const int pw = (threadIdx.x - 128 * kWG) / 32, lane = threadIdx.x % 32;
    if (pw == 0) {
      // ---------------------------------------------------------- producer
      // walks the tiles into its ring: the bf16 K/V ring, or for a code
      // arena the code ring (its tile records and scales beside it)
      int* wpos = kQuant ? cpos : spos;
      int* wc0 = kQuant ? cc0 : sc0;
      int* wall = kQuant ? call : sall;
      auto wfull = [&](int st) { return kQuant ? cfull(st) : full(st); };
      auto wempty = [&](int st) { return kQuant ? cempty(st) : empty(st); };
      const int s_end = min(S, s0 + kBM * kWG);
      int qmin = INT_MAX, qmax = INT_MIN;
      for (int s = s0 + lane; s < s_end; s += 32) {
        const int p = qpos[size_t(b) * S + s];
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
      qmin = __reduce_min_sync(0xffffffffu, qmin);
      qmax = __reduce_max_sync(0xffffffffu, qmax);
      if (lane == 0) {
        hopper::mbar_expect_tx(qbar, kWG * NB * kBox);
        for (int w = 0; w < kWG; ++w)
          for (int nb = 0; nb < NB; ++nb)
            hopper::tma_load_4d(sb + L::Q + (w * NB + nb) * kBox, &tm_q, nb * 64, h,
                                s0 + w * kBM, b, qbar);
      }
      const int* kp = kvpos + size_t(b) * T_blocks * BS;
      const int* tb = tbl + size_t(b) * T_blocks;
      // a run that no row of the CTA can see loads nothing
      int c_walk = c_begin;
      if (nsplit > 1) {
        int rmin = INT_MAX;
        for (int c = c_begin + lane; c < c_end; c += 32) rmin = min(rmin, kp[c]);
        if (__reduce_min_sync(0xffffffffu, rmin) > qmax) c_walk = c_end;
      }
      const int box_rows = min(BS, kBN), nsub = kBN / box_rows;
      // bytes of one box of box_rows keys, K and V: bf16 rows (NB boxes
      // of 128 B) or D-byte code rows
      const uint32_t sub_bytes = 2u * box_rows * (kQuant ? D : NB * 128);
      int stage = 0;
      uint32_t parity = 1;  // a fresh empty barrier passes the flipped parity
      int seen = INT_MAX;   // least key position of the tiles issued so far
      // Loads run two tiles ahead of the tile being issued: its key
      // positions and table entries (lane j holds box j's block, 0 = not
      // loaded: trash, or past the end), then, one tile ahead, the scales
      // of those blocks (code arenas), so no tile waits on a global load.
      // (stats mode: a key of table entry 0 is never visible)
      auto key_pos = [&](int cc) {
        return cc < c_end && !(stats && tb[cc / BS] == 0) ? kp[cc] : INT_MAX;
      };
      auto fetch = [&](int c, int& pos0, int& pos1, int& blk_lane) {
        pos0 = key_pos(c + lane);
        pos1 = key_pos(c + 32 + lane);
        const int cj = c + lane * box_rows;
        blk_lane = lane < nsub && cj < c_end ? tb[cj / BS] : 0;
      };
      auto fetch_scales = [&](int blk_lane, float& kscl, float& vscl) {
        if constexpr (kQuant) {
          const size_t si = size_t(blk_lane) * Nkv + kh;
          kscl = blk_lane != 0 ? k_scale[si] : kDeadScale;
          vscl = blk_lane != 0 ? v_scale[si] : kDeadScale;
        }
      };
      int p0, p1, bj, n0, n1, nbj;
      float ks = 0.f, vs = 0.f, nks = 0.f, nvs = 0.f;
      fetch(c_walk, p0, p1, bj);
      fetch_scales(bj, ks, vs);
      fetch(c_walk + kBN, n0, n1, nbj);
      for (int c0 = c_walk; c0 < c_end; c0 += kBN) {
        int m0, m1, mbj;
        fetch(c0 + 2 * kBN, m0, m1, mbj);
        fetch_scales(nbj, nks, nvs);
        const int tmin = __reduce_min_sync(0xffffffffu, min(p0, p1));
        // a tile that adds exactly zero to every row is skipped
        if (!(tmin > qmax && (stats || seen <= qmin))) {
          seen = min(seen, tmin);
          const int tmax = __reduce_max_sync(0xffffffffu, max(p0, p1));
          const int all = c0 + kBN <= c_end && tmax <= qmin;
          int blk[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) blk[j] = __shfl_sync(0xffffffffu, bj, j);
          if (lane == 0) hopper::mbar_wait(wempty(stage), parity);
          __syncwarp();
          wpos[stage * kBN + lane] = p0;
          wpos[stage * kBN + 32 + lane] = p1;
          if (lane == 0) {
            wc0[stage] = c0;
            wall[stage] = all;
          }
          uint32_t bytes = 0;
          bool zeroed = false;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= nsub) break;
            if (blk[j] != 0) {
              bytes += sub_bytes;
            } else if constexpr (!kQuant) {
              // rows [j * box_rows, +box_rows) of every K and V box read as zeros
              for (int nb = 0; nb < NB; ++nb)
                for (int o = lane * 16; o < box_rows * 128; o += 32 * 16) {
                  *reinterpret_cast<uint4*>(smem + k_off(stage, nb) + j * box_rows * 128 + o) =
                      make_uint4(0u, 0u, 0u, 0u);
                  *reinterpret_cast<uint4*>(smem + v_off(stage, nb) + j * box_rows * 128 + o) =
                      make_uint4(0u, 0u, 0u, 0u);
                }
              zeroed = true;
            }
          }
          if constexpr (kQuant) {
            // each key's K and V scale (its box's); a key that is not loaded
            // dequantizes to 0
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int box = (lane + 32 * i) / box_rows;
              sscl[(stage * 2) * kBN + lane + 32 * i] = __shfl_sync(0xffffffffu, ks, box);
              sscl[(stage * 2 + 1) * kBN + lane + 32 * i] = __shfl_sync(0xffffffffu, vs, box);
            }
          }
          if (zeroed) hopper::fence_proxy_async();
          __threadfence_block();
          __syncwarp();
          if (lane == 0) {
            const uint32_t bar = wfull(stage);
            hopper::mbar_expect_tx(bar, bytes);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= nsub || blk[j] == 0) continue;
              const int slot = (c0 + j * box_rows) % BS;
              if constexpr (kQuant) {
                const uint32_t dst = sb + L::CODE + (stage * 2 * kBN + j * box_rows) * D;
                hopper::tma_load_4d(dst, &tm_k, 0, kh, slot, blk[j], bar);
                hopper::tma_load_4d(dst + kBN * D, &tm_v, 0, kh, slot, blk[j], bar);
              } else {
                for (int nb = 0; nb < NB; ++nb) {
                  hopper::tma_load_4d(sb + k_off(stage, nb) + j * box_rows * 128, &tm_k, nb * 64,
                                      kh, slot, blk[j], bar);
                  hopper::tma_load_4d(sb + v_off(stage, nb) + j * box_rows * 128, &tm_v, nb * 64,
                                      kh, slot, blk[j], bar);
                }
              }
            }
          }
          if (++stage == L::kWalk) {
            stage = 0;
            parity ^= 1;
          }
        }
        p0 = n0, p1 = n1, bj = nbj, ks = nks, vs = nvs;
        n0 = m0, n1 = m1, nbj = mbj;
      }
      if (lane == 0) {
        hopper::mbar_wait(wempty(stage), parity);
        wc0[stage] = -1;
        hopper::mbar_arrive(wfull(stage));
      }
    } else if constexpr (kQuant) {
      // ----------------------------------------------------------- dequant
      // code ring stage -> the next free bf16 stage: code -> f32 exactly,
      // times the key's scale, one rounding to bf16, into the
      // 128-byte-swizzled tile (16-byte chunk j of row r of a box lives at
      // chunk j ^ (r % 8)); the tile's record goes along
      constexpr int CH = D / 16;  // 16-code chunks per row
      const int dt = threadIdx.x - 128 * kWG - 32;
      int cs = 0, bs = 0;
      uint32_t cpar = 0, bpar = 1;
      for (;;) {
        hopper::mbar_wait(cfull(cs), cpar);
        const int c0 = cc0[cs];
        hopper::mbar_wait(empty(bs), bpar);
        if (c0 >= 0) {
          const char* src = smem + L::CODE + cs * 2 * kBN * D;
          const float* scl = sscl + cs * 2 * kBN;
          // one 16-code chunk of one key row, K and V; branch-free: a dead
          // key's staged bytes (stale, or never written) become zero codes
          // and its scale 0, so it dequantizes to +0 by selects
          for (int idx = dt; idx < kBN * CH; idx += kDeqThreads) {
            const int r = idx / CH, ch = idx % CH;
            const int col = ch * 16, j0 = (col % 64) / 8;
#pragma unroll
            for (int kv = 0; kv < 2; ++kv) {
              const float sc = scl[kv * kBN + r];
              const bool live = sc != kDeadScale;
              const float s = live ? sc : 0.f;
              const uint4 u = *reinterpret_cast<const uint4*>(src + (kv * kBN + r) * D + ch * 16);
              const uint32_t x[4] = {live ? u.x : 0u, live ? u.y : 0u, live ? u.z : 0u,
                                     live ? u.w : 0u};
              uint32_t w[8];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float f[4];
                attn::codes4_to_f<KT>(x[i], f);
                w[2 * i] = hopper::pack_bf16(f[0] * s, f[1] * s);
                w[2 * i + 1] = hopper::pack_bf16(f[2] * s, f[3] * s);
              }
              char* row = smem + (kv ? v_off(bs, col / 64) : k_off(bs, col / 64)) + r * 128;
              *reinterpret_cast<uint4*>(row + ((j0 ^ (r & 7)) << 4)) =
                  make_uint4(w[0], w[1], w[2], w[3]);
              *reinterpret_cast<uint4*>(row + (((j0 + 1) ^ (r & 7)) << 4)) =
                  make_uint4(w[4], w[5], w[6], w[7]);
            }
          }
          if (dt < kBN) spos[bs * kBN + dt] = cpos[cs * kBN + dt];
          if (dt == 0) sall[bs] = call[cs];
          hopper::fence_proxy_async();
        }
        if (dt == 0) sc0[bs] = c0;
        hopper::mbar_arrive(cempty(cs));
        hopper::mbar_arrive(full(bs));
        if (c0 < 0) break;
        if (++cs == kCodeStages) {
          cs = 0;
          cpar ^= 1;
        }
        if (++bs == kStages) {
          bs = 0;
          bpar ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const float sl2 = scale * 1.4426950408889634f;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row = wg * kBM + warp * 16 + lane / 4;  // this thread's rows: row, row + 8
  int qp[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int s = s0 + row + 8 * t;
    qp[t] = s < S ? qpos[size_t(b) * S + s] : INT_MIN;
  }
  // o[32 * nb + 4j + 2t + e]: row (row + 8t), head dim 64 nb + 8j + 2 quad + e
  float o[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) o[i] = 0.f;
  float m[2] = {attn::kNegInf, attn::kNegInf}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(qbar, 0);
  const wgattn::Ring ring{sb + L::K, sb + L::V, full(0), empty(0), spos, sc0, sall};
  wgattn::consume<D, kStages>(ring, sb + L::Q + wg * NB * kBox, c_end, qp, sl2, o, m, l,
                              stats ? -INFINITY : attn::kNegInf);

#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float ls = l[t];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const int s = s0 + row + 8 * t;
    if (s >= S) continue;
    if (nsplit == 1 && stats) {
      const size_t orow = (size_t(b) * S + s) * Nh + h;
      float* dst = sacc + orow * D + 2 * quad;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + 64 * nb + 8 * j) =
              make_float2(o[32 * nb + 4 * j + 2 * t], o[32 * nb + 4 * j + 2 * t + 1]);
      if (quad == 0) {
        sm[orow] = attn::stat_m(m[t], ls);
        sl[orow] = ls;
      }
    } else if (nsplit == 1) {
      const float den = fmaxf(ls, 1e-30f);
      __nv_bfloat16* dst = out + ((size_t(b) * S + s) * Nh + h) * D + 2 * quad;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * nb + 8 * j) = __floats2bfloat162_rn(
              o[32 * nb + 4 * j + 2 * t] / den, o[32 * nb + 4 * j + 2 * t + 1] / den);
    } else {
      // partial row of folded row (h % G) * S + s, as split_merge_kernel reads it
      const size_t prow = ((size_t(b) * Nkv + kh) * nsplit + split) * G * S + size_t(h % G) * S + s;
      float* dst = part_acc + prow * D + 2 * quad;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + 64 * nb + 8 * j) =
              make_float2(o[32 * nb + 4 * j + 2 * t], o[32 * nb + 4 * j + 2 * t + 1]);
      if (quad == 0) *reinterpret_cast<float2*>(part_ml + prow * 2) = make_float2(m[t], ls);
    }
  }
}

template <int D, typename KT>
int run_wgmma(const PrefillArgs& a) {
  constexpr bool kQuant = !std::is_same<KT, __nv_bfloat16>::value;
  using L = PSmem<D, kQuant>;
  const uint32_t rows = static_cast<uint32_t>(a.BS < kBN ? a.BS : kBN);
  CUtensorMap tq, tk, tv;
  bool ok = hopper::map_bf16_4d(&tq, a.q, D, a.Nh, a.S, a.B);
  if constexpr (kQuant) {
    ok = ok && hopper::map_u8_4d(&tk, a.k, D, a.Nkv, a.BS, a.NBk, rows) &&
         hopper::map_u8_4d(&tv, a.v, D, a.Nkv, a.BS, a.NBk, rows);
  } else {
    ok = ok && hopper::map_bf16_4d(&tk, a.k, D, a.Nkv, a.BS, a.NBk, rows) &&
         hopper::map_bf16_4d(&tv, a.v, D, a.Nkv, a.BS, a.NBk, rows);
  }
  if (!ok) return attn::kNoTensorMap;
  const dim3 grid((a.S + kBM * kWG - 1) / (kBM * kWG), a.Nh, a.B * a.nsplit);
  auto* out = static_cast<__nv_bfloat16*>(a.out);
  const int le = attn::launch_n(prefill_wgmma_kernel<D, KT>, grid, L::kThreads, L::BYTES,
                                a.stream, tq, tk, tv, a.k_scale, a.v_scale, a.tbl, a.qpos,
                                a.kvpos, a.nlive, out, a.sacc, a.sm, a.sl, a.part_acc, a.part_ml,
                                a.S, a.Nh, a.Nkv, a.BS, a.Tb, a.nsplit, a.scale);
  if (le != 0 || a.nsplit == 1) return le;
  return attn::launch_merge<__nv_bfloat16>(a.part_acc, a.part_ml, a.sm ? a.sacc : a.out, a.sm,
                                           a.sl, a.B, a.S, a.Nh, a.Nkv, D, a.nsplit, a.stream);
}

template <int D>
int run_wgmma_kv(const PrefillArgs& a) {
  if (a.kv == 0) return run_wgmma<D, __nv_bfloat16>(a);
  if (a.kv == 1) return run_wgmma<D, int8_t>(a);
  if (a.kv == 2) return run_wgmma<D, __nv_fp8_e4m3>(a);
  return attn::kBadArgs;
}

}  // namespace

// q [B,Sc,Nh,D], arenas [NB,BS,Nkv,D], scales [NB,Nkv] f32 (null when
// kv_dtype = 0), tbl [B,T] int32, qpos [B,Sc], kvpos [B,T*BS] int32,
// nlive [B] int32, out like q (null in stats mode); sacc [B,Sc,Nh,D], sm
// and sl [B,Sc,Nh] f32, the stats-mode outputs (all null otherwise, when
// out is written); part_acc [B*Nkv*nsplit*G*Sc*D] and part_ml
// [B*Nkv*nsplit*G*Sc*2] f32 scratch (null when nsplit = 1). dtype 0 =
// float32, 1 = bfloat16; kv_dtype 0 = the query dtype, 1 = int8, 2 =
// fp8-e4m3; design 0 = the CUDA-core tile (nsplit 1), 1 = the tensor-core
// kernel (bf16 queries, BS 16, 32 or a multiple of 64).
extern "C" int paged_prefill_fwd(const void* q, const void* k_arena, const void* v_arena,
                                 const float* k_scale, const float* v_scale, const int* tbl,
                                 const int* qpos, const int* kvpos, const int* nlive, void* out,
                                 float* sacc, float* sm, float* sl, float* part_acc,
                                 float* part_ml, int B, int S, int Nh, int Nkv,
                                 int D, int BS, int T, int NBk, int nsplit, float scale,
                                 int dtype, int kv_dtype, int design, void* stream) {
  if ((sm == nullptr) != (sacc == nullptr) || (sm == nullptr) != (sl == nullptr))
    return attn::kBadArgs;
  const PrefillArgs a{q,     k_arena, v_arena, k_scale, v_scale,  tbl,     qpos,   kvpos,
                      nlive, out,     sacc,    sm,      sl,       part_acc, part_ml, B,
                      S,     Nh,      Nkv,     BS,      T,        NBk,     nsplit, kv_dtype,
                      scale, static_cast<cudaStream_t>(stream)};
  if (design == 1) {
    const bool bs_ok = BS == 16 || BS == 32 || (BS > 0 && BS % 64 == 0);
    if (dtype != 1 || !bs_ok || nsplit < 1 || (nsplit > 1 && part_acc == nullptr))
      return attn::kBadArgs;
    if (D == 64) return run_wgmma_kv<64>(a);
    if (D == 128) return run_wgmma_kv<128>(a);
    if (D == 256) return run_wgmma_kv<256>(a);
    return attn::kBadArgs;
  }
  if (design != 0 || nsplit != 1) return attn::kBadArgs;
  ATTN_DISPATCH(run, dtype, D, (Nh / Nkv) * S, a);
}
