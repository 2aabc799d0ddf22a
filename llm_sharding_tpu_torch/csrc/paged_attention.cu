// Paged decode (and speculative verify) attention over the pooled KV
// arena: the port of llm_sharding_tpu/ops/paged_attention.py:484
// (paged_attention_tpu, body _paged_kernel at :404), in both modes: an
// arena in the query dtype, or int8 / fp8-e4m3 codes with per-(block, KV
// head) f32 scales, dequantized on the card.
//
// What bounds it on the H100: each KV byte is read once per (row, KV head)
// for ~4 flops per byte and folded query row (G*S rows: 3 for Llama-3.2-3B
// decode, 15 at its verify S = 5, 40 for gemma-2B's), so it is bound by
// HBM bytes: 3.35 TB/s needs tens of KB in flight on every SM all the time,
// and every SM busy until the last byte. What the design does:
//
// - One CTA holds all G*S folded query rows of its KV head (up to 48; more
//   run as groups along grid.z), so each KV byte is read once per call.
//   bf16 queries score and accumulate them on the tensor cores (mma.sync
//   m16n8k16, rows padded to 16): four consumer warps each score 16 keys
//   of a 64-key tile, meet at a named barrier for the tile's row max and
//   row sums, then each computes P V for a quarter of the head dim. f32
//   queries run the same protocol on the CUDA cores over 32-key tiles (on
//   the tensor cores f32 would be TF32).
// - Split by live length, planned on the card at a fixed grid. Each row's
//   live columns are its written frontier, nlive blocks (the server passes
//   them from its write columns, 0 for a finished row; without nlive, the
//   table's width). Row by row, the live tiles of all B rows form one line
//   per KV head, cut into P equal pieces (P = the SM count over Nkv, from
//   shapes alone: ops/paged_attention.plan_decode; fewer when the rows are
//   short, so a piece's partial never outweighs its KV); CTA (j, kh)
//   attends piece j, which may end one row and start the next. Every CTA
//   computes the same prefix of the rows' tiles from nlive itself, so the
//   host reads nothing and the launch is the same for any lengths
//   (sync-free, capturable). A row with no live column is written as zeros.
// - A producer warp loads each tile of K and V of one KV head with TMA
//   (the arena as a 4-D map: column, KV head, slot, block; a tile is 64/BS
//   boxes of BS slots, or a 64-slot box of a larger block) into a ring of
//   mbarrier stages, its table entries and positions fetched two tiles
//   ahead. A box of table entry 0 (the shared trash block, which may hold
//   NaN/Inf) or past the row's live columns is never loaded: the producer
//   writes zeros there (a select, never a multiply), so a trash key scores
//   exactly 0; columns past the live end score -inf.
// - Code arenas: the producer loads the codes (D bytes a key) into a code
//   ring; three dequant warps turn each code into f32 exactly, times its
//   (block, KV head) scale, rounded once to T, into the tile the consumers
//   read: once per CTA for all the folded rows.
// - The merge is fused: a piece that covers a row's every tile writes the
//   output itself; otherwise each piece writes an f32 partial (acc, m, l)
//   into its slot and the last piece of the (row, KV head) pair to finish
//   (an atomic ticket, attn::last_run) merges the slots in column order
//   with combine_attn_stats' recurrence and resets the ticket. One launch
//   per call.
//
// The contract is the one in attn_tile.cuh's note: f32 scores scaled after
// the dot by scale * log2(e) (softmax in the log2 domain), masked scores
// -1e30 and the running max starts there, l summed from p in f32, p
// rounded to T before P V, out = acc / max(l, 1e-30); a code is
// converted to f32 exactly, times its scale, rounded once to T.
//
// Stats mode (context-parallel serving, attn_tile.cuh's note): the producer
// gives a key of table entry 0 position INT_MAX (never visible), a masked
// score is -inf (it adds exactly zero), and the results are the f32 triple
// (acc, m, l): a piece that covers its row writes it, otherwise the fused
// merge folds the pieces without the final division. A row with no live
// column is (0, -1e30, 0). Tiles of trash blocks are zero-filled by the
// producer, never loaded, so a shard reads only the blocks it owns.

#include <climits>

#include "attn_tile.cuh"
#include "hopper.cuh"

namespace {

using attn::kNegInf;
constexpr int kCWarps = 4;                // consumer warps
constexpr int kCThreads = 32 * kCWarps;
constexpr int kDeqThreads = 96;           // dequant warps of a code arena
constexpr int kMaxRows = 512;             // batch rows the on-card plan holds
constexpr int kPlanThreads = 128;         // threads that compute the plan
constexpr float kDeadScale = -1.f;        // staged scale of a box that is not loaded
constexpr int kBar = 1;                   // the consumers' named barrier

// Shared-memory layout and geometry of one instantiation. A tile row is
// D * sizeof(T) bytes, cut into 128-byte boxes (64 bf16 or 32 f32), each
// box 128-byte swizzled (16-byte chunk j of row r at chunk j ^ (r % 8)).
template <typename T, int D, typename KT, int MT>
struct DL {
  static constexpr bool kQuant = !std::is_same<KT, T>::value;
  static constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ES = int(sizeof(T));
  static constexpr int EPB = 128 / ES;        // elements of a box row
  static constexpr int NBX = D / EPB;         // boxes across a row
  static constexpr int TK = 128 / ES;         // keys per tile: 64 bf16, 32 f32
  static constexpr int BOX = TK * 128;        // bytes of one box column of a tile
  static constexpr int TILE = NBX * BOX;      // bytes of a K (or V) tile
  static constexpr int RG = kTC ? 16 * MT : 16;  // folded rows per CTA
  static constexpr int kStages = kQuant ? 2 : (D <= 128 ? 4 : 2);
  static constexpr int CODE = 2 * TK * D;     // code bytes of a tile, K and V
  static constexpr int kCodeStages = !kQuant ? 0 : (CODE <= 16384 ? 4 : 1);
  static constexpr int kThreads = kCThreads + 32 + (kQuant ? kDeqThreads : 0);
  static constexpr int QLD = D + 16 / ES;     // Q row stride (elements)
  static constexpr int PLD = kTC ? TK + 8 : TK + 1;  // P row stride (elements of P)
  static constexpr int PB = RG * PLD * (kTC ? 2 : 4);  // bytes of one P buffer
  static constexpr int K = 0;
  static constexpr int V = K + kStages * TILE;
  static constexpr int CODE0 = V + kStages * TILE;
  static constexpr int Q = CODE0 + kCodeStages * CODE;
  static constexpr int P = Q + RG * QLD * ES;
  static constexpr int RED = P + 2 * PB;
  // bf16: row max and row sum per warp, double-buffered; f32: m, l, corr[2]
  static constexpr int REDB = kTC ? 2 * 2 * kCWarps * RG * 4 : 4 * RG * 4;
  static constexpr int POS = RED + REDB;                    // int [kStages][TK]
  static constexpr int CPOS = POS + kStages * TK * 4;       // int [kCodeStages][TK]
  static constexpr int SCL = CPOS + kCodeStages * TK * 4;   // float [kCodeStages][2][8]
  static constexpr int PRE = SCL + kCodeStages * 2 * 8 * 4; // int [kMaxRows + 1]
  static constexpr int LIVE = PRE + (kMaxRows + 1) * 4;     // int [kMaxRows]
  static constexpr int FLAG = LIVE + kMaxRows * 4;          // int [4]
  static constexpr int BAR = (FLAG + 16 + 7) / 8 * 8;
  // barriers: full [kStages], empty [kStages], code full, code empty
  static constexpr size_t BYTES = BAR + (2 * kStages + 2 * kCodeStages) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory");
  static_assert(D % EPB == 0 && TILE % 1024 == 0, "geometry");
};

// Byte offset of element (row r, column d) in a 128-byte-swizzled tile of
// T with TK-row box columns (d a multiple of 16 / sizeof(T) for a whole
// 16-byte chunk).
template <typename T, int TK>
__device__ __forceinline__ int swz(int r, int d) {
  constexpr int EPB = 128 / int(sizeof(T)), EPC = 16 / int(sizeof(T));
  return (d / EPB) * (TK * 128) + r * 128 + ((((d % EPB) / EPC) ^ (r & 7)) << 4) +
         (d % EPC) * int(sizeof(T));
}

// Folded row r of the CTA's group -> the output / query element offset of
// head dim 0 (q and out are [B, S, Nh, D]; row r0 + r is g * S + s).
__device__ __forceinline__ size_t qrow(int b, int fr, int S, int Nh, int kh, int G, int D) {
  return ((size_t(b) * S + fr % S) * Nh + size_t(kh) * G + fr / S) * D;
}

template <typename T, int D, typename KT, int MT>
__global__ void __launch_bounds__(DL<T, D, KT, MT>::kThreads, 1)
paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const T* q,
                    const float* k_scale, const float* v_scale, const int* tbl,
                    const int* qpos, const int* kvpos, const int* nlive, T* out, float* st_acc,
                    float* st_m, float* st_l, float* part, int* tickets, int B, int S, int Nh,
                    int Nkv, int BS, int T_blocks, int slots, int min_tiles, float sl2) {
  using L = DL<T, D, KT, MT>;
  constexpr int TK = L::TK, RG = L::RG, kStages = L::kStages, kCodeStages = L::kCodeStages;
  constexpr bool kQuant = L::kQuant;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem =
      reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sb = hopper::smem_u32(smem);
  int* spre = reinterpret_cast<int*>(smem + L::PRE);
  int* slive = reinterpret_cast<int*>(smem + L::LIVE);
  int* sflag = reinterpret_cast<int*>(smem + L::FLAG);
  int* spos = reinterpret_cast<int*>(smem + L::POS);
  int* cpos = reinterpret_cast<int*>(smem + L::CPOS);
  float* sscl = reinterpret_cast<float*>(smem + L::SCL);
  auto full = [&](int st) { return sb + L::BAR + 8 * st; };
  auto empty = [&](int st) { return sb + L::BAR + 8 * (kStages + st); };
  auto cfull = [&](int st) { return sb + L::BAR + 8 * (2 * kStages + st); };
  auto cempty = [&](int st) { return sb + L::BAR + 8 * (2 * kStages + kCodeStages + st); };

  const bool stats = st_m != nullptr;
  const float mk = stats ? -INFINITY : kNegInf;  // the score of a masked key
  const int j = blockIdx.x, kh = blockIdx.y;
  const int G = Nh / Nkv, GS = G * S, r0 = blockIdx.z * RG, GSz = min(RG, GS - r0);
  const int W = T_blocks * BS;
  const int rstride = min(RG, GS);  // partial rows per slot
  const int box_rows = min(BS, TK), nsub = TK / box_rows;

  // ------------------------------------------------------------- the plan
  // each row's live columns, then the prefix of its live tiles
  if (threadIdx.x < kPlanThreads) {
    for (int b = threadIdx.x; b < B; b += kPlanThreads)
      slive[b] = nlive != nullptr ? min(T_blocks, max(nlive[b], 0)) * BS : W;
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full(st), kQuant ? kDeqThreads : 1);
      hopper::mbar_init(empty(st), kCThreads);
    }
    for (int st = 0; st < kCodeStages; ++st) {
      hopper::mbar_init(cfull(st), 1);
      hopper::mbar_init(cempty(st), kDeqThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int run = 0;
    if (threadIdx.x == 0) spre[0] = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + threadIdx.x;
      int v = b < B ? (slive[b] + TK - 1) / TK : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (int(threadIdx.x) >= o) v += u;
      }
      if (b < B) spre[b + 1] = run + v;
      run += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  // P = min(grid, ceil(N / min_tiles)) pieces, none empty (a row's pieces
  // are then consecutive runs); CTAs past P are idle
  const int N = spre[B], P = min(int(gridDim.x), (N + min_tiles - 1) / min_tiles);
  const int lo = j < P ? int(int64_t(j) * N / P) : 0;
  const int hi = j < P ? int(int64_t(j + 1) * N / P) : 0;
  // the piece holding flattened tile u: the least i with hi_i > u
  auto piece_of = [&](int u) { return int((int64_t(u + 1) * P + N - 1) / N) - 1; };
  auto row_at = [&](int u, int b) {
    while (spre[b + 1] <= u) ++b;
    return b;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kCWarps) {
    if (warp == kCWarps) {
      // ---------------------------------------------------------- producer
      // walks the piece's tiles into its ring (the K/V ring, or the code
      // ring with its scales for a code arena), fetching each tile's
      // positions and table entries two tiles ahead and its scales one
      const uint32_t ring0 = kQuant ? sb + L::CODE0 : sb + L::K;
      int* wpos = kQuant ? cpos : spos;
      auto wfull = [&](int st) { return kQuant ? cfull(st) : full(st); };
      auto wempty = [&](int st) { return kQuant ? cempty(st) : empty(st); };
      constexpr int kWalk = kQuant ? kCodeStages : kStages;
      struct Fetch {
        int b, c0, pos0, pos1, blk;  // blk: lane i < nsub, box i's block, 0 = not loaded
      };
      int fb = lo < hi ? row_at(lo, 0) : 0;
      auto fetch = [&](int u) {
        Fetch f{0, 0, 0, 0, 0};
        if (u >= hi) return f;
        fb = row_at(u, fb);
        f.b = fb;
        f.c0 = (u - spre[fb]) * TK;
        const int live = slive[fb];
        const int* kp = kvpos + size_t(fb) * W;
        const int* tb = tbl + size_t(fb) * T_blocks;
        // stats mode: a key of table entry 0 is never visible
        auto key_pos = [&](int c) {
          return c < live ? (stats && tb[c / BS] == 0 ? INT_MAX : kp[c]) : 0;
        };
        f.pos0 = key_pos(f.c0 + lane);
        f.pos1 = TK > 32 ? key_pos(f.c0 + 32 + lane) : 0;
        const int cj = f.c0 + lane * box_rows;
        f.blk = lane < nsub && cj < live ? tb[cj / BS] : 0;
        return f;
      };
      auto fetch_scales = [&](const Fetch& f, float& ks, float& vs) {
        if constexpr (kQuant) {
          const size_t si = size_t(f.blk) * Nkv + kh;
          ks = f.blk != 0 ? k_scale[si] : kDeadScale;
          vs = f.blk != 0 ? v_scale[si] : kDeadScale;
        }
      };
      int stage = 0;
      uint32_t parity = 1;  // a fresh empty barrier passes the flipped parity
      Fetch f0 = fetch(lo), f1 = fetch(lo + 1);
      float ks0 = 0.f, vs0 = 0.f, ks1 = 0.f, vs1 = 0.f;
      fetch_scales(f0, ks0, vs0);
      for (int u = lo; u < hi; ++u) {
        const Fetch f2 = fetch(u + 2);
        fetch_scales(f1, ks1, vs1);
        if (lane == 0) hopper::mbar_wait(wempty(stage), parity);
        __syncwarp();
        wpos[stage * TK + lane] = f0.pos0;
        if (TK > 32) wpos[stage * TK + 32 + lane] = f0.pos1;
        uint32_t bytes = 0;
        bool zeroed = false;
        for (int i = 0; i < nsub; ++i) {
          const int blk = __shfl_sync(0xffffffffu, f0.blk, i);
          if (blk != 0) {
            bytes += kQuant ? 2u * box_rows * D : 2u * L::NBX * box_rows * 128;
          } else if constexpr (!kQuant) {
            // rows [i * box_rows, +box_rows) of every K and V box read as zeros
            for (int nb = 0; nb < L::NBX; ++nb)
              for (int o = lane * 16; o < box_rows * 128; o += 32 * 16) {
                const int off = nb * L::BOX + i * box_rows * 128 + o;
                *reinterpret_cast<uint4*>(smem + L::K + stage * L::TILE + off) =
                    make_uint4(0u, 0u, 0u, 0u);
                *reinterpret_cast<uint4*>(smem + L::V + stage * L::TILE + off) =
                    make_uint4(0u, 0u, 0u, 0u);
              }
            zeroed = true;
          }
        }
        if constexpr (kQuant) {
          if (lane < nsub) {
            sscl[(stage * 2) * 8 + lane] = f0.blk != 0 ? ks0 : kDeadScale;
            sscl[(stage * 2 + 1) * 8 + lane] = f0.blk != 0 ? vs0 : kDeadScale;
          }
        }
        if (zeroed) hopper::fence_proxy_async();
        __threadfence_block();
        __syncwarp();
        if (lane == 0) hopper::mbar_expect_tx(wfull(stage), bytes);
        // every lane takes part in the shuffles; lane 0 issues the loads
        for (int i = 0; i < nsub; ++i) {
          const int blk = __shfl_sync(0xffffffffu, f0.blk, i);
          if (lane != 0 || blk == 0) continue;
          const int slot = (f0.c0 + i * box_rows) % BS;
          const uint32_t bar = wfull(stage);
          if constexpr (kQuant) {
            const uint32_t dst = ring0 + stage * L::CODE + i * box_rows * D;
            hopper::tma_load_4d(dst, &tm_k, 0, kh, slot, blk, bar);
            hopper::tma_load_4d(dst + TK * D, &tm_v, 0, kh, slot, blk, bar);
          } else {
            for (int nb = 0; nb < L::NBX; ++nb) {
              const uint32_t off = stage * L::TILE + nb * L::BOX + i * box_rows * 128;
              hopper::tma_load_4d(sb + L::K + off, &tm_k, nb * L::EPB, kh, slot, blk, bar);
              hopper::tma_load_4d(sb + L::V + off, &tm_v, nb * L::EPB, kh, slot, blk, bar);
            }
          }
        }
        if (++stage == kWalk) {
          stage = 0;
          parity ^= 1;
        }
        f0 = f1;
        f1 = f2;
        ks0 = ks1;
        vs0 = vs1;
      }
    } else if constexpr (kQuant) {
      // ----------------------------------------------------------- dequant
      // code stage -> the next free tile of T: code -> f32 exactly, times
      // its box's scale, one rounding to T, into the swizzled tile; a box
      // that was not loaded (scale kDeadScale) becomes zeros by a select
      constexpr int CH = D / 16;  // 16-code chunks per row
      const int dt = threadIdx.x - kCThreads - 32;
      int cs = 0, bs = 0;
      uint32_t cpar = 0, bpar = 1;
      for (int u = lo; u < hi; ++u) {
        hopper::mbar_wait(cfull(cs), cpar);
        hopper::mbar_wait(empty(bs), bpar);
        const char* src = smem + L::CODE0 + cs * L::CODE;
        const float* scl = sscl + cs * 2 * 8;
        for (int idx = dt; idx < TK * CH; idx += kDeqThreads) {
          const int r = idx / CH, ch = idx % CH;
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const float sc = scl[kv * 8 + r / box_rows];
            const bool live = sc != kDeadScale;
            const float s = live ? sc : 0.f;
            const uint4 c = *reinterpret_cast<const uint4*>(src + (kv * TK + r) * D + ch * 16);
            const uint32_t x[4] = {live ? c.x : 0u, live ? c.y : 0u, live ? c.z : 0u,
                                   live ? c.w : 0u};
            char* tile = smem + (kv ? L::V : L::K) + bs * L::TILE;
            float f[16];
#pragma unroll
            for (int i = 0; i < 4; ++i) attn::codes4_to_f<KT>(x[i], f + 4 * i);
            if constexpr (L::kTC) {
              uint32_t w[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) w[i] = hopper::pack_bf16(f[2 * i] * s, f[2 * i + 1] * s);
              *reinterpret_cast<uint4*>(tile + swz<T, TK>(r, ch * 16)) =
                  make_uint4(w[0], w[1], w[2], w[3]);
              *reinterpret_cast<uint4*>(tile + swz<T, TK>(r, ch * 16 + 8)) =
                  make_uint4(w[4], w[5], w[6], w[7]);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                *reinterpret_cast<float4*>(tile + swz<T, TK>(r, ch * 16 + 4 * i)) =
                    make_float4(f[4 * i] * s, f[4 * i + 1] * s, f[4 * i + 2] * s,
                                f[4 * i + 3] * s);
            }
          }
        }
        for (int i = dt; i < TK; i += kDeqThreads) spos[bs * TK + i] = cpos[cs * TK + i];
        hopper::mbar_arrive(cempty(cs));
        hopper::mbar_arrive(full(bs));
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
  const int tid = threadIdx.x;
  // rows with no live column: CTA b % gridDim.x writes them as zeros
  // (stats mode: (0, -1e30, 0))
  for (int b = 0; b < B; ++b) {
    if (spre[b + 1] != spre[b] || b % int(gridDim.x) != j) continue;
    for (int idx = tid; idx < GSz * D; idx += kCThreads) {
      const size_t e = qrow(b, r0 + idx / D, S, Nh, kh, G, D) + idx % D;
      if (stats)
        st_acc[e] = 0.f;
      else
        out[e] = attn::from_f<T>(0.f);
    }
    if (stats)
      for (int r = tid; r < GSz; r += kCThreads) {
        const size_t e = qrow(b, r0 + r, S, Nh, kh, G, D) / D;
        st_m[e] = kNegInf;
        st_l[e] = 0.f;
      }
  }
  T* sq = reinterpret_cast<T*>(smem + L::Q);
  int stage = 0, tcount = 0;
  uint32_t parity = 0;
  int b = lo < hi ? row_at(lo, 0) : 0;
  for (int u = lo; u < hi;) {
    b = row_at(u, b);
    const int t_lo = u - spre[b], t_hi = min(hi, spre[b + 1]) - spre[b];
    const int live = slive[b];
    const int jf = piece_of(spre[b]), jl = piece_of(spre[b + 1] - 1);
    const int nparts = jl - jf + 1, slot = j - jf;
    u = spre[b] + t_hi;
    // the group's folded query rows into shared memory (zeros past GSz)
    constexpr int CPR = D * int(sizeof(T)) / 16;  // 16-byte chunks per row
    for (int idx = tid; idx < RG * CPR; idx += kCThreads) {
      const int r = idx / CPR, cv = idx % CPR;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < GSz) x = *reinterpret_cast<const uint4*>(q + qrow(b, r0 + r, S, Nh, kh, G, D) + cv * 16 / int(sizeof(T)));
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(sq) + r * L::QLD * int(sizeof(T)) + cv * 16) = x;
    }
    auto qpos_of = [&](int r) { return r < GSz ? qpos[size_t(b) * S + (r0 + r) % S] : INT_MIN; };
    const size_t pair = (size_t(blockIdx.z) * B + b) * Nkv + kh;
    // the pair's partials: acc [slots][rstride][D], then (m, l) [slots][rstride]
    // padded to whole float4s, so every acc row is 16-byte aligned
    const size_t mlsz = (size_t(slots) * rstride * 2 + 3) / 4 * 4;
    float* pacc = part + pair * (size_t(slots) * rstride * D + mlsz);
    float* pml = pacc + size_t(slots) * rstride * D;
    auto out_at = [&](int r, int d) { return out + qrow(b, r0 + r, S, Nh, kh, G, D) + d; };
    auto sacc_at = [&](int r, int d) { return st_acc + qrow(b, r0 + r, S, Nh, kh, G, D) + d; };
    auto stat_at = [&](int r, float mv, float lv) {
      const size_t e = qrow(b, r0 + r, S, Nh, kh, G, D) / D;
      st_m[e] = mv;
      st_l[e] = lv;
    };

    if constexpr (L::kTC) {
      // ------------------------------------------- bf16: tensor cores
      const int g = lane / 4, t4 = lane % 4;
      constexpr int NT = D / 32;  // 8-column n-tiles of this warp's quarter of D
      float* redm = reinterpret_cast<float*>(smem + L::RED);  // [2][kCWarps][RG]
      float* reds = redm + 2 * kCWarps * RG;                  // [2][kCWarps][RG]
      int qp[MT][2];
      float m[MT][2], l[MT][2], o[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          qp[mt][h] = qpos_of(mt * 16 + g + 8 * h);
          m[mt][h] = kNegInf;
          l[mt][h] = 0.f;
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
      attn::named_bar(kBar, kCThreads);  // Q staged
      const uint32_t sqa = hopper::smem_u32(sq);
      for (int ti = t_lo; ti < t_hi; ++ti) {
        hopper::mbar_wait(full(stage), parity);
        const int pb = tcount & 1;
        const int c0 = ti * TK;
        const int* sp = spos + stage * TK;
        const uint32_t kt = sb + L::K + stage * L::TILE, vt = sb + L::V + stage * L::TILE;
        // S = Q K^T over this warp's keys [16 warp, +16)
        float s[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t bk[4];
          const int key = 16 * warp + (lane % 8) + (lane / 16) * 8;
          hopper::ldsm_x4(kt + swz<T, TK>(key, ks * 16 + ((lane / 8) % 2) * 8), bk);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            hopper::ldsm_x4(sqa + ((mt * 16 + lane % 16) * L::QLD + ks * 16 + (lane / 16) * 8) * 2, a);
            hopper::mma_16816(s[mt][0], a, bk[0], bk[1]);
            hopper::mma_16816(s[mt][1], a, bk[2], bk[3]);
          }
        }
        // mask and scale; this warp's row max
        float mx[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = kNegInf;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = 16 * warp + 8 * nt + 2 * t4 + e;
                float& v = s[mt][nt][2 * h + e];
                v = c0 + key >= live ? -INFINITY : sp[key] <= qp[mt][h] ? v * sl2 : mk;
                x = fmaxf(x, v);
              }
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
            mx[mt][h] = x;
            if (t4 == 0) redm[(pb * kCWarps + warp) * RG + mt * 16 + g + 8 * h] = x;
          }
        attn::named_bar(kBar, kCThreads);
        // the tile's row max, p, this warp's row sums; P into shared memory
        __nv_bfloat16* pbuf = reinterpret_cast<__nv_bfloat16*>(smem + L::P + pb * L::PB);
        float corr[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + g + 8 * h;
            float tm = mx[mt][h];
#pragma unroll
            for (int w = 0; w < kCWarps; ++w) tm = fmaxf(tm, redm[(pb * kCWarps + w) * RG + row]);
            const float mn = fmaxf(m[mt][h], tm);
            corr[mt][h] = attn::ex2(m[mt][h] - mn);
            m[mt][h] = mn;
            float ps = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float p0 = attn::ex2(s[mt][nt][2 * h] - mn);
              const float p1 = attn::ex2(s[mt][nt][2 * h + 1] - mn);
              ps += p0 + p1;
              *reinterpret_cast<uint32_t*>(pbuf + row * L::PLD + 16 * warp + 8 * nt + 2 * t4) =
                  hopper::pack_bf16(p0, p1);
            }
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            if (t4 == 0) reds[(pb * kCWarps + warp) * RG + row] = ps;
          }
        attn::named_bar(kBar, kCThreads);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + g + 8 * h;
            float ts = 0.f;
#pragma unroll
            for (int w = 0; w < kCWarps; ++w) ts += reds[(pb * kCWarps + w) * RG + row];
            l[mt][h] = l[mt][h] * corr[mt][h] + ts;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              o[mt][nt][2 * h] *= corr[mt][h];
              o[mt][nt][2 * h + 1] *= corr[mt][h];
            }
          }
        // O[:, this warp's quarter of D] += P V
        const uint32_t pa = hopper::smem_u32(pbuf);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            hopper::ldsm_x4(pa + ((mt * 16 + lane % 16) * L::PLD + kk * 16 + (lane / 16) * 8) * 2, a[mt]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bv[4];
            const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
            const int dim = warp * (D / 4) + np * 16 + (lane / 16) * 8;
            hopper::ldsm_x4_t(vt + swz<T, TK>(key, dim), bv);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              hopper::mma_16816(o[mt][2 * np], a[mt], bv[0], bv[1]);
              hopper::mma_16816(o[mt][2 * np + 1], a[mt], bv[2], bv[3]);
            }
          }
        }
        hopper::mbar_arrive(empty(stage));
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
        ++tcount;
      }
      // the segment's result: the output, or this piece's partial
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + g + 8 * h;
          if (row >= GSz) continue;
          const float den = fmaxf(l[mt][h], 1e-30f);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int d = warp * (D / 4) + nt * 8 + 2 * t4;
            const float x0 = o[mt][nt][2 * h], x1 = o[mt][nt][2 * h + 1];
            if (nparts == 1 && stats) {
              *reinterpret_cast<float2*>(sacc_at(row, d)) = make_float2(x0, x1);
            } else if (nparts == 1) {
              *reinterpret_cast<__nv_bfloat162*>(out_at(row, d)) =
                  __floats2bfloat162_rn(x0 / den, x1 / den);
            } else {
              *reinterpret_cast<float2*>(pacc + (size_t(slot) * rstride + row) * D + d) =
                  make_float2(x0, x1);
            }
          }
          if (nparts > 1 && warp == 0 && t4 == 0)
            *reinterpret_cast<float2*>(pml + (size_t(slot) * rstride + row) * 2) =
                make_float2(m[mt][h], l[mt][h]);
          if (nparts == 1 && stats && warp == 0 && t4 == 0)
            stat_at(row, attn::stat_m(m[mt][h], l[mt][h]), l[mt][h]);
        }
    } else {
      // -------------------------------------------- f32: CUDA cores
      float* sm = reinterpret_cast<float*>(smem + L::RED);  // m [RG]
      float* sl = sm + RG;                                   // l [RG]
      float* sc = sl + RG;                                   // corr [2][RG]
      constexpr int DPT = D >= kCThreads ? D / kCThreads : 1;  // columns a thread owns
      constexpr int RSTEP = D >= kCThreads ? 1 : kCThreads / D;
      constexpr int RPT = RG / RSTEP;                        // rows a thread owns
      const int dcol = tid % (D < kCThreads ? D : kCThreads), rph = tid / (D < kCThreads ? D : kCThreads);
      float acc[RPT][DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
      for (int r = tid; r < RG; r += kCThreads) {
        sm[r] = kNegInf;
        sl[r] = 0.f;
      }
      attn::named_bar(kBar, kCThreads);  // Q and the row state staged
      const float* qf = reinterpret_cast<const float*>(sq);
      for (int ti = t_lo; ti < t_hi; ++ti) {
        hopper::mbar_wait(full(stage), parity);
        const int pb = tcount & 1;
        const int c0 = ti * TK;
        const int* sp = spos + stage * TK;
        const char* kt = smem + L::K + stage * L::TILE;
        const char* vt = smem + L::V + stage * L::TILE;
        float* pbuf = reinterpret_cast<float*>(smem + L::P + pb * L::PB);
        for (int p = tid; p < RG * TK; p += kCThreads) {
          const int r = p / TK, key = p % TK;
          float dot = 0.f;
          if (r < GSz) {
#pragma unroll 8
            for (int d = 0; d < D; d += 4) {
              const float4 kv = *reinterpret_cast<const float4*>(kt + swz<T, TK>(key, d));
              const float4 qv = *reinterpret_cast<const float4*>(qf + r * L::QLD + d);
              dot = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, dot))));
            }
          }
          pbuf[r * L::PLD + key] =
              c0 + key >= live ? -INFINITY : sp[key] <= qpos_of(r) ? dot * sl2 : mk;
        }
        attn::named_bar(kBar, kCThreads);
        for (int r = tid; r < GSz; r += kCThreads) {
          float mx = kNegInf;
          for (int key = 0; key < TK; ++key) mx = fmaxf(mx, pbuf[r * L::PLD + key]);
          const float mn = fmaxf(sm[r], mx);
          float ps = 0.f;
          for (int key = 0; key < TK; ++key) {
            const float p = attn::ex2(pbuf[r * L::PLD + key] - mn);
            ps += p;
            pbuf[r * L::PLD + key] = p;
          }
          const float c = attn::ex2(sm[r] - mn);
          sc[pb * RG + r] = c;
          sl[r] = sl[r] * c + ps;
          sm[r] = mn;
        }
        attn::named_bar(kBar, kCThreads);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rph + RSTEP * i;
          const float c = r < GSz ? sc[pb * RG + r] : 0.f;
#pragma unroll
          for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= c;
        }
        for (int key = 0; key < TK; ++key) {
          float vv[DPT];
#pragma unroll
          for (int jj = 0; jj < DPT; ++jj)
            vv[jj] = *reinterpret_cast<const float*>(vt + swz<T, TK>(key, dcol + jj * kCThreads));
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = rph + RSTEP * i;
            if (r >= GSz) continue;
            const float p = pbuf[r * L::PLD + key];
#pragma unroll
            for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
          }
        }
        hopper::mbar_arrive(empty(stage));
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
        ++tcount;
      }
      attn::named_bar(kBar, kCThreads);  // sm / sl final
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rph + RSTEP * i;
        if (r >= GSz) continue;
        const float den = fmaxf(sl[r], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) {
          const int d = dcol + jj * kCThreads;
          if (nparts == 1 && stats)
            *sacc_at(r, d) = acc[i][jj];
          else if (nparts == 1)
            *out_at(r, d) = acc[i][jj] / den;
          else
            pacc[(size_t(slot) * rstride + r) * D + d] = acc[i][jj];
        }
      }
      if (nparts > 1)
        for (int r = tid; r < GSz; r += kCThreads)
          *reinterpret_cast<float2*>(pml + (size_t(slot) * rstride + r) * 2) =
              make_float2(sm[r], sl[r]);
      else if (stats)
        for (int r = tid; r < GSz; r += kCThreads) stat_at(r, attn::stat_m(sm[r], sl[r]), sl[r]);
    }
    if (nparts > 1 &&
        attn::last_run(tickets + pair, nparts, sflag, kBar, kCThreads, tid)) {
      auto acc_of = [&](int i) { return pacc + size_t(i) * rstride * D; };
      auto ml_of = [&](int i) { return pml + size_t(i) * rstride * 2; };
      if (stats)
        attn::merge_runs<T, D, true>(acc_of, ml_of, nparts, GSz, sacc_at, warp, kCWarps,
                                     stat_at);
      else
        attn::merge_runs<T, D>(acc_of, ml_of, nparts, GSz, out_at, warp, kCWarps);
      if (tid == 0) tickets[pair] = 0;
    }
    attn::named_bar(kBar, kCThreads);  // Q, the row state and the flag are free again
  }
}

struct DecodeArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *tbl, *qpos, *kvpos, *nlive;
  void* out;
  float *sacc, *sm, *sl;  // stats mode (null otherwise)
  float* part;
  int* tickets;
  int B, S, Nh, Nkv, BS, Tb, NBk, pieces, slots, min_tiles;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, typename KT, int MT>
int run_mt(const DecodeArgs& a) {
  using L = DL<T, D, KT, MT>;
  const uint32_t rows = static_cast<uint32_t>(a.BS < L::TK ? a.BS : L::TK);
  CUtensorMap tk, tv;
  bool ok;
  if constexpr (L::kQuant) {
    ok = hopper::map_u8_4d(&tk, a.k, D, a.Nkv, a.BS, a.NBk, rows) &&
         hopper::map_u8_4d(&tv, a.v, D, a.Nkv, a.BS, a.NBk, rows);
  } else if constexpr (L::kTC) {
    ok = hopper::map_bf16_4d(&tk, a.k, D, a.Nkv, a.BS, a.NBk, rows) &&
         hopper::map_bf16_4d(&tv, a.v, D, a.Nkv, a.BS, a.NBk, rows);
  } else {
    ok = hopper::map_f32_4d(&tk, a.k, D, a.Nkv, a.BS, a.NBk, rows) &&
         hopper::map_f32_4d(&tv, a.v, D, a.Nkv, a.BS, a.NBk, rows);
  }
  if (!ok) return attn::kNoTensorMap;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const dim3 grid(a.pieces, a.Nkv, (GS + L::RG - 1) / L::RG);
  return attn::launch_n(paged_decode_kernel<T, D, KT, MT>, grid, L::kThreads, L::BYTES,
                        a.stream, tk, tv, static_cast<const T*>(a.q), a.k_scale, a.v_scale,
                        a.tbl, a.qpos, a.kvpos, a.nlive, static_cast<T*>(a.out), a.sacc, a.sm,
                        a.sl, a.part, a.tickets, a.B, a.S, a.Nh, a.Nkv, a.BS, a.Tb, a.slots, a.min_tiles,
                        a.scale * 1.4426950408889634f);
}

// bf16 queries: MT m16 row tiles hold min(G*S, 48) folded rows
template <typename T, int D, typename KT>
int run_kv(const DecodeArgs& a) {
  if constexpr (std::is_same<T, float>::value) {
    return run_mt<T, D, KT, 1>(a);
  } else {
    const int GS = (a.Nh / a.Nkv) * a.S;
    if (GS <= 16) return run_mt<T, D, KT, 1>(a);
    if (GS <= 32) return run_mt<T, D, KT, 2>(a);
    return run_mt<T, D, KT, 3>(a);
  }
}

template <typename T, int D>
int run(const DecodeArgs& a, int kv) {
  if (kv == 0) return run_kv<T, D, T>(a);
  if (kv == 1) return run_kv<T, D, int8_t>(a);
  if (kv == 2) return run_kv<T, D, __nv_fp8_e4m3>(a);
  return attn::kBadArgs;
}

}  // namespace

// q [B,S,Nh,D], arenas [NBk,BS,Nkv,D], scales [NBk,Nkv] f32 (null when
// kv_dtype = 0), tbl [B,T] int32, qpos [B,S], kvpos [B,T*BS] int32, nlive
// [B] int32 blocks covering each row's written frontier, or null (the
// whole table), out like q (null in stats mode); sacc [B,S,Nh,D], sm and
// sl [B,S,Nh] f32, the stats-mode outputs (all null otherwise); part: f32
// scratch of
// ops/paged_attention.plan_decode's size; tickets: B*Nkv*groups int32
// zeros, left zero. pieces, slots and min_tiles from plan_decode. dtype 0 = float32,
// 1 = bfloat16; kv_dtype 0 = the query dtype, 1 = int8, 2 = fp8-e4m3. One
// launch.
extern "C" int paged_attention_fwd(const void* q, const void* k_arena, const void* v_arena,
                                   const float* k_scale, const float* v_scale, const int* tbl,
                                   const int* qpos, const int* kvpos, const int* nlive, void* out,
                                   float* sacc, float* sm, float* sl, float* part, int* tickets,
                                   int B, int S, int Nh, int Nkv, int D,
                                   int BS, int T, int NBk, int pieces, int slots, int min_tiles,
                                   float scale, int dtype, int kv_dtype, void* stream) {
  const bool bs_ok = BS == 8 || BS == 16 || BS == 32 || (BS > 0 && BS % 64 == 0);
  if (!bs_ok || B < 1 || B > kMaxRows || pieces < 1 || slots < 1 || min_tiles < 1)
    return attn::kBadArgs;
  if ((sm == nullptr) != (sacc == nullptr) || (sm == nullptr) != (sl == nullptr))
    return attn::kBadArgs;
  const DecodeArgs a{q,      k_arena, v_arena, k_scale, v_scale,   tbl,  qpos, kvpos,
                     nlive,  out,     sacc,    sm,      sl,        part, tickets, B,
                     S,      Nh,      Nkv,     BS,      T,         NBk,  pieces,  slots,
                     min_tiles, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && D == 64) return run<float, 64>(a, kv_dtype);
  if (dtype == 0 && D == 128) return run<float, 128>(a, kv_dtype);
  if (dtype == 0 && D == 256) return run<float, 256>(a, kv_dtype);
  if (dtype == 1 && D == 64) return run<__nv_bfloat16, 64>(a, kv_dtype);
  if (dtype == 1 && D == 128) return run<__nv_bfloat16, 128>(a, kv_dtype);
  if (dtype == 1 && D == 256) return run<__nv_bfloat16, 256>(a, kv_dtype);
  return attn::kBadArgs;
}
