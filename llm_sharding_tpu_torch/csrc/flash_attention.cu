// Dense causal flash attention over a KV cache, position-masked: the port
// of llm_sharding_tpu/ops/flash_attention.py:124 (flash_attention, body
// _flash_kernel at :63).
//
// Dispatch by dtype, never by failure: bf16 queries take the tensor-core
// kernel below; f32 queries take the CUDA-core attn::Tile path
// (attn_tile.cuh), because f32 on the tensor cores would be TF32.
//
// What bounds it on the H100: at S = C = 2048 it does ~4*S*C/2*D flops per
// query head against ~S*D bytes per head, far above the ~295 flops/byte
// ridge, so it is bound by operations, and only the tensor cores reach the
// card's rate. The bf16 design (hopper.cuh has the primitives, and
// wgmma_attn.cuh the consumer loop it shares with paged_prefill.cu):
//
// - One CTA = 128 query rows of ONE query head (grid: (ceil(S/128), Nh, B),
//   heaviest causal tiles first): two consumer warpgroups of 64 rows and
//   one producer warp. Tiling one head at a time (not the GQA fold) keeps
//   a CTA's rows contiguous positions, so TMA loads Q as a box and the
//   causal skip stays tight; the G heads of a KV head re-read its K/V tiles
//   from L2 (all of K/V at S = 2048 is 8 MB).
// - The producer warp streams 64-key K and V tiles by TMA into a ring of 4
//   stages (2 at head dim 256, where Q and one stage take 96 KB: four
//   stages would need 320 KB of the 227 KB a CTA may have) with full/empty
//   mbarriers. A 128-element bf16 row (256 B) is two 64-column boxes, a
//   256-element one four, each 128-byte swizzled. The tensor maps (built on every
//   call, they encode the base pointers) are 4-D [B, C, Nkv, D], so keys past
//   C are zero-filled and then scored -inf, never as valid zero keys.
// - Skip rule, exact, decided by the producer from positions before the
//   tile's TMA is issued: a tile is skipped when none of its keys is
//   visible to any real row of the CTA and every real row has already seen
//   a key in an issued tile. Positions need not be sorted. The producer
//   also flags a tile whose every key exists and is visible to every real
//   row, and the consumers then skip the per-element mask.
// - S = Q K^T by wgmma m64n64k16 (Q and K both K-major in shared memory);
//   the next tile's S is issued before this tile's softmax, so the tensor
//   cores work while the softmax runs. The online softmax runs on the f32
//   accumulator fragment (a row spans a quad of lanes: max by two shuffles)
//   in the log2 domain (scores times scale * log2 e, then ex2). P is
//   rounded to bf16 in registers, which is exactly the contract's "p cast
//   to the V dtype", and O += P V by wgmma m64n128k16 (m64n64k16 at D = 64)
//   with A from registers and the V tile as the MN-major B operand (the
//   transpose bit; no transpose in shared memory).
// - Tried on the H100 and not kept, both slower than this design: the two
//   warpgroups taking turns to issue their products (named barriers)
//   instead of the overlap above, and Q held as register A fragments
//   (loaded once) instead of read from shared memory by each product.

#include <climits>

#include "attn_tile.cuh"
#include "hopper.cuh"
#include "wgmma_attn.cuh"

namespace {

// ------------------------------------------------------- f32: attn::Tile

// Column c of row b's cache lives at ((b * C + c) * Nkv + kh) * D.
struct DenseCols {
  const int* kvpos;    // this row's kv_positions [C]
  long long base;      // element offset of column 0 for this (b, kh)
  long long stride;    // Nkv * D
  __device__ int pos(int c) const { return kvpos[c]; }
  __device__ long long offset(int c) const { return base + c * stride; }
};

template <typename T, int D, int RI>
__global__ void __launch_bounds__(attn::kThreads)
flash_kernel(const T* q, const T* k, const T* v, const int* qpos, const int* kvpos, T* out,
             int S, int C, int Nh, int Nkv, float scale) {
  extern __shared__ __align__(16) char smem[];
  attn::Tile<T, D, RI> t(smem);
  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * attn::Tile<T, D, RI>::BQ;
  const int G = Nh / Nkv;
  const attn::QGeom g{S, G, Nh, G * S};
  t.load_q(q, qpos, b, kh, r0, g);
  const DenseCols cols{kvpos + size_t(b) * C,
                       (static_cast<long long>(b) * C * Nkv + kh) * D,
                       static_cast<long long>(Nkv) * D};
  attn::attend(t, k, v, C, cols, scale, r0, g.GS);
  t.store(out, b, kh, r0, g);
}

struct FlashArgs {
  const void *q, *k, *v;
  const int *qpos, *kvpos;
  void* out;
  int B, S, C, Nh, Nkv;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int RI>
int run(const FlashArgs& a) {
  using Tl = attn::Tile<T, D, RI>;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const dim3 grid((GS + Tl::BQ - 1) / Tl::BQ, a.Nkv, a.B);
  return attn::launch(flash_kernel<T, D, RI>, grid, Tl::smem_bytes(), a.stream,
                      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                      static_cast<const T*>(a.v), a.qpos, a.kvpos, static_cast<T*>(a.out), a.S,
                      a.C, a.Nh, a.Nkv, a.scale);
}

// ----------------------------------------------- bf16: wgmma + TMA kernel

using wgattn::kBM;
using wgattn::kBN;
using wgattn::kBox;
using wgattn::kWG;
constexpr int kFlashThreads = 128 * kWG + 32;  // + one producer warp

template <int D>
struct Smem {
  static constexpr int NB = D / 64;  // boxes across a row
  static constexpr int kStages = D <= 128 ? 4 : 2;  // K/V ring depth
  static constexpr int Q = 0;        // [kWG][NB] boxes
  static constexpr int K = Q + kWG * NB * kBox;
  static constexpr int V = K + kStages * NB * kBox;
  static constexpr int POS = V + kStages * NB * kBox;  // int [kStages][kBN]
  static constexpr int C0 = POS + kStages * kBN * 4;   // int [kStages], -1 = end
  static constexpr int ALL = C0 + kStages * 4;         // int [kStages], 1 = unmasked tile
  static constexpr int BAR = (ALL + kStages * 4 + 7) / 8 * 8;
  static constexpr size_t BYTES = BAR + (2 * kStages + 1) * 8 + 1024;  // + base alignment
};

template <int D>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const int* qpos, const int* kvpos,
                   __nv_bfloat16* out, int S, int C, int Nh, int Nkv, float scale) {
  using L = Smem<D>;
  constexpr int NB = L::NB, kStages = L::kStages;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sb = hopper::smem_u32(smem);
  int* spos = reinterpret_cast<int*>(smem + L::POS);
  int* sc0 = reinterpret_cast<int*>(smem + L::C0);
  int* sall = reinterpret_cast<int*>(smem + L::ALL);
  auto full = [&](int st) { return sb + L::BAR + 8 * st; };
  auto empty = [&](int st) { return sb + L::BAR + 8 * (kStages + st); };
  const uint32_t qbar = sb + L::BAR + 16 * kStages;
  auto k_box = [&](int st, int nb) { return sb + L::K + (st * NB + nb) * kBox; };
  auto v_box = [&](int st, int nb) { return sb + L::V + (st * NB + nb) * kBox; };

  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = (gridDim.x - 1 - blockIdx.x) * (kBM * kWG);  // heaviest tiles first
  const int kh = h / (Nh / Nkv);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), 128 * kWG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {
    // ------------------------------------------------------------ producer
    const int lane = threadIdx.x % 32;
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
          hopper::tma_load_4d(sb + L::Q + (w * NB + nb) * kBox, &tm_q, nb * 64, h, s0 + w * kBM,
                              b, qbar);
    }
    const int* kp = kvpos + size_t(b) * C;
    int stage = 0;
    uint32_t parity = 1;  // a fresh empty barrier passes the flipped parity
    int seen = INT_MAX;   // least key position of the tiles issued so far
    for (int c0 = 0; c0 < C; c0 += kBN) {
      const int p0 = c0 + lane < C ? kp[c0 + lane] : INT_MAX;
      const int p1 = c0 + 32 + lane < C ? kp[c0 + 32 + lane] : INT_MAX;
      const int tmin = __reduce_min_sync(0xffffffffu, min(p0, p1));
      if (tmin > qmax && seen <= qmin) continue;  // adds exactly zero to every row
      seen = min(seen, tmin);
      // every key of the tile exists and is visible to every real row
      const int tmax = __reduce_max_sync(0xffffffffu, max(p0, p1));
      const int all = c0 + kBN <= C && tmax <= qmin;
      if (lane == 0) hopper::mbar_wait(empty(stage), parity);
      __syncwarp();
      spos[stage * kBN + lane] = p0;
      spos[stage * kBN + 32 + lane] = p1;
      if (lane == 0) {
        sc0[stage] = c0;
        sall[stage] = all;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_expect_tx(full(stage), 2 * NB * kBox);
        for (int nb = 0; nb < NB; ++nb) {
          hopper::tma_load_4d(k_box(stage, nb), &tm_k, nb * 64, kh, c0, b, full(stage));
          hopper::tma_load_4d(v_box(stage, nb), &tm_v, nb * 64, kh, c0, b, full(stage));
        }
      }
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    if (lane == 0) {
      hopper::mbar_wait(empty(stage), parity);
      sc0[stage] = -1;
      hopper::mbar_arrive(full(stage));
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  // Scores run in the log2 domain: t = s * scale * log2(e), p = 2^(t - m),
  // which is exp(s * scale - m') with m' = m / log2(e); a masked score is
  // -1e30 there too, and the running max starts at -1e30.
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
  wgattn::consume<D, kStages>(ring, sb + L::Q + wg * NB * kBox, C, qp, sl2, o, m, l);

#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float ls = l[t];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const float den = fmaxf(ls, 1e-30f);
    const int s = s0 + row + 8 * t;
    if (s >= S) continue;
    __nv_bfloat16* dst = out + ((size_t(b) * S + s) * Nh + h) * D + 2 * quad;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * nb + 8 * j) = __floats2bfloat162_rn(
            o[32 * nb + 4 * j + 2 * t] / den, o[32 * nb + 4 * j + 2 * t + 1] / den);
  }
}

template <int D>
int run_wgmma(const FlashArgs& a) {
  CUtensorMap tq, tk, tv;
  if (!hopper::map_bf16_4d(&tq, a.q, D, a.Nh, a.S, a.B) ||
      !hopper::map_bf16_4d(&tk, a.k, D, a.Nkv, a.C, a.B) ||
      !hopper::map_bf16_4d(&tv, a.v, D, a.Nkv, a.C, a.B))
    return attn::kNoTensorMap;
  const size_t smem = Smem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.S + kBM * kWG - 1) / (kBM * kWG), a.Nh, a.B);
  flash_wgmma_kernel<D><<<grid, kFlashThreads, smem, a.stream>>>(
      tq, tk, tv, a.qpos, a.kvpos, static_cast<__nv_bfloat16*>(a.out), a.S, a.C, a.Nh, a.Nkv,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,S,Nh,D], k/v [B,C,Nkv,D], qpos [B,S], kvpos [B,C] int32, out like q.
// All contiguous on the device; dtype 0 = float32 (CUDA-core tile path),
// 1 = bfloat16 (tensor cores). Returns 0 or the launch's error code
// (attn_error_string names it).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const int* qpos,
                                   const int* kvpos, void* out, int B, int S, int C, int Nh,
                                   int Nkv, int D, float scale, int dtype, void* stream) {
  const FlashArgs a{q, k, v, qpos, kvpos, out, B, S, C, Nh, Nkv, scale,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && D == 64) return run_wgmma<64>(a);
  if (dtype == 1 && D == 128) return run_wgmma<128>(a);
  if (dtype == 1 && D == 256) return run_wgmma<256>(a);
  const bool small = (Nh / Nkv) * S <= attn::kTY;
  if (dtype == 0 && D == 64) return small ? run<float, 64, 1>(a) : run<float, 64, 4>(a);
  if (dtype == 0 && D == 128) return small ? run<float, 128, 1>(a) : run<float, 128, 4>(a);
  if (dtype == 0 && D == 256) return small ? run<float, 256, 1>(a) : run<float, 256, 4>(a);
  return attn::kBadArgs;
}
