// The consumer side of the tensor-core attention kernels (flash_attention.cu
// for bf16 queries, paged_prefill.cu for bf16 queries over the paged
// arena): two warpgroups of 64 query rows each walk a ring of 64-key K/V
// tiles that a producer fills, and keep the online-softmax state of their
// rows in registers.
//
// Per tile, in the contract of attn_tile.cuh's note:
// - S = Q K^T by wgmma m64n64k16 (Q and K both K-major, 128-byte-swizzled
//   64-column boxes in shared memory); at D = 64 and 128 the next tile's S
//   is issued before this tile's softmax, so the tensor cores work while
//   the softmax runs; at D = 256 the O accumulator alone is 128 registers a
//   thread of the 168 ptxas gives these CTAs (it rounds their 9 or 12 warps
//   up to whole warps per SM sub-partition, 3 of the 4), so a second S
//   fragment does not fit and each tile's S is issued and awaited at its
//   turn (issued early at D = 256, the flash and chunked-prefill kernels
//   ran 1.13-1.34x slower on an H100);
// - the online softmax runs on the f32 accumulator fragment (a row spans
//   a quad of lanes: max by two shuffles) in the log2 domain: scores times
//   scale * log2 e, then ex2; masked scores are -1e30 and the running max
//   starts there; columns at or past the walk's end score -inf;
// - P is rounded to bf16 in registers ("p cast to the V dtype") and
//   O += P V by wgmma m64n128k16 (m64n64k16 at D = 64, two m64n128k16 over
//   boxes 0-1 and 2-3 at D = 256) with A from registers and the V tile as
//   the MN-major B operand (transpose bit).
//
// The producer's side of the ring, per stage: the K and V boxes, the
// tile's key positions (kBN ints), its first column (-1 ends the walk)
// and a flag that every key of the tile exists and is visible to every
// real row (the consumers then skip the mask). A tile is released to the
// producer by an arrival of all 128 * kWG consumer threads on its empty
// barrier.

#pragma once

#include "attn_tile.cuh"
#include "hopper.cuh"

namespace wgattn {

constexpr int kBM = 64;              // query rows per consumer warpgroup
constexpr int kWG = 2;               // consumer warpgroups
constexpr int kBN = 64;              // keys per K/V tile
constexpr int kBox = 64 * 64 * 2;    // one 64 x 64 bf16 box (8 KB)

// Keep the compiler from moving register traffic across an in-flight wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory addresses of a ring of kStages tiles: stage st's K box nb
// is at k0 + (st * NB + nb) * kBox (V likewise), its full and empty
// barriers at full0 + 8 * st and empty0 + 8 * st.
struct Ring {
  uint32_t k0, v0, full0, empty0;
  const int* pos;  // [kStages][kBN] key positions
  const int* c0;   // [kStages] first column, -1 = end of the walk
  const int* all;  // [kStages] 1 = every key exists and is visible to every row
};

// The consumers' per-tile hook when a separate producer warp fills the ring.
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// Walk the ring until the producer's end marker, accumulating this
// thread's rows (row, row + 8 of its warpgroup) into o (unnormalised),
// m (running max, log2 domain) and l (this thread's columns' share of the
// row sum; the quad is summed by the caller). sq: this warpgroup's Q
// boxes; C: the walk's end column; qp: the two rows' query positions;
// sl2: scale * log2(e); masked: the score of a masked key (-1e30, or -inf
// in the paged kernels' stats mode, attn_tile.cuh's note). hook: called by
// every consumer thread at the top of each tile's turn (flash's inline
// producer refills the ring there; NoHook otherwise).
template <int D, int kStages, typename Hook = NoHook>
__device__ __forceinline__ void consume(const Ring& r, uint32_t sq, int C, const int* qp,
                                        float sl2, float* o, float* m, float* l,
                                        float masked = attn::kNegInf, Hook hook = Hook()) {
  constexpr int NB = D / 64;
  constexpr bool kEarly = D <= 128;  // issue the next tile's S before this softmax
  const int quad = threadIdx.x % 4;
  auto full = [&](int st) { return r.full0 + 8 * st; };
  auto empty = [&](int st) { return r.empty0 + 8 * st; };
  auto k_box = [&](int st, int nb) { return r.k0 + (st * NB + nb) * kBox; };
  auto v_box = [&](int st, int nb) { return r.v0 + (st * NB + nb) * kBox; };

  // S = Q K^T of the tile in `st`, issued asynchronously into acc
  auto issue_qk = [&](float* acc, int st) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;
      hopper::wgmma_ss_m64n64k16(acc, hopper::desc_sw128(sq + (kk / 4) * kBox + koff, 16, 1024),
                                 hopper::desc_sw128(k_box(st, kk / 4) + koff, 16, 1024), kk > 0);
    }
  };

  int stage = 0;
  uint32_t parity = 0;
  hopper::mbar_wait(full(stage), parity);
  int c0 = r.c0[stage];
  float sa[32], sn[32];
  if (c0 >= 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[i] = 0.f;
    hopper::wg_fence();
    issue_qk(sa, stage);
    hopper::wg_commit();
    hopper::wg_wait0();
    fence_regs<32>(sa);
  }
  while (c0 >= 0) {
    hook();
    int nstage = stage + 1;
    uint32_t nparity = parity;
    if (nstage == kStages) {
      nstage = 0;
      nparity ^= 1;
    }
    int nc0 = -1;
    if constexpr (kEarly) {
      hopper::mbar_wait(full(nstage), nparity);
      nc0 = r.c0[nstage];
      // the next tile's S = Q K^T runs on the tensor cores during this softmax
      if (nc0 >= 0) {
        hopper::wg_fence();
        issue_qk(sn, nstage);
        hopper::wg_commit();
      }
    }

    // mask (unless the whole tile is visible) and online softmax on the
    // fragment: element 4j + 2t + e is row (row + 8t), key 8j + 2*quad + e
    const int* sp = r.pos + stage * kBN;
    const bool all = r.all[stage] != 0;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float mx = attn::kNegInf;
      if (all) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sa[4 * j + 2 * t] *= sl2;
          sa[4 * j + 2 * t + 1] *= sl2;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * t + e, col = 8 * j + 2 * quad + e;
            sa[i] = c0 + col >= C ? -INFINITY : sp[col] <= qp[t] ? sa[i] * sl2 : masked;
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sa[4 * j + 2 * t], sa[4 * j + 2 * t + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[t], mx);
      const float corr = attn::ex2(m[t] - mn);
      m[t] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * t + e;
          sa[i] = attn::ex2(sa[i] - mn);
          ls += sa[i];
        }
      l[t] = l[t] * corr + ls;
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j) {
        o[4 * j + 2 * t] *= corr;
        o[4 * j + 2 * t + 1] *= corr;
      }
    }
    // P as the m64k16 A fragments of the four 16-key steps
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = hopper::pack_bf16(sa[8 * kk + 0], sa[8 * kk + 1]);
      pa[kk][1] = hopper::pack_bf16(sa[8 * kk + 2], sa[8 * kk + 3]);
      pa[kk][2] = hopper::pack_bf16(sa[8 * kk + 4], sa[8 * kk + 5]);
      pa[kk][3] = hopper::pack_bf16(sa[8 * kk + 6], sa[8 * kk + 7]);
    }
    // O += P V
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (NB == 4) {
        hopper::wgmma_rs_m64n128k16_tb(
            o, pa[kk], hopper::desc_sw128(v_box(stage, 0) + kk * 16 * 128, kBox, 1024));
        hopper::wgmma_rs_m64n128k16_tb(
            o + 64, pa[kk], hopper::desc_sw128(v_box(stage, 2) + kk * 16 * 128, kBox, 1024));
      } else if constexpr (NB == 2) {
        hopper::wgmma_rs_m64n128k16_tb(
            o, pa[kk], hopper::desc_sw128(v_box(stage, 0) + kk * 16 * 128, kBox, 1024));
      } else {
        hopper::wgmma_rs_m64n64k16_tb(
            o, pa[kk], hopper::desc_sw128(v_box(stage, 0) + kk * 16 * 128, kBox, 1024));
      }
    }
    hopper::wg_commit();
    hopper::wg_wait0();  // this PV (and, issued early, the next tile's QK)
    fence_regs<NB * 32>(o);
    if constexpr (kEarly) fence_regs<32>(sn);
    hopper::mbar_arrive(empty(stage));
    if constexpr (kEarly) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sa[i] = sn[i];
    } else {
      hopper::mbar_wait(full(nstage), nparity);
      nc0 = r.c0[nstage];
      if (nc0 >= 0) {
        hopper::wg_fence();
        issue_qk(sa, nstage);
        hopper::wg_commit();
        hopper::wg_wait0();
        fence_regs<32>(sa);
      }
    }
    stage = nstage;
    parity = nparity;
    c0 = nc0;
  }
}

}  // namespace wgattn
