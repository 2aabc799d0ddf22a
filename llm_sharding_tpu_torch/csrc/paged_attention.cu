// Paged decode attention over the pooled KV arena, as split-KV
// (flash-decoding): the port of llm_sharding_tpu/ops/paged_attention.py:484
// (paged_attention_tpu, body _paged_kernel at :404), in both modes: an
// arena in the query dtype, or int8 / fp8-e4m3 codes with per-(block, KV
// head) f32 scales, dequantized in registers (KT).
//
// What bounds it on the H100: each KV byte is read once per (row, KV head)
// for ~2 flops per byte and query row (G*S = 3 rows for Llama-3.2-3B
// decode), so it is bound by HBM bytes: keeping 3.35 TB/s busy takes tens
// of KB in flight on every SM, all the time. What the design does:
//
// - Split the columns. Each row's T*BS columns are cut into runs of
//   split_cols (a multiple of BS, at least 128 columns, chosen by
//   ops/paged_attention.plan_splits from B, Nkv, T, BS and the SM count), so
//   B*Nkv*nsplit CTAs fill the card even at B = 1. Grid: (nsplit, Nkv *
//   ceil(G*S / RP), B).
// - A CTA holds RP folded query rows in registers (RP = 3 where 3 divides
//   G*S and 4 does not, so Llama-3.2-3B's 3 decode rows carry no padding;
//   else 4; more rows take more CTAs along y) and spreads the keys over its
//   8 warps and, inside a warp, over lane groups of LPK lanes: each lane
//   owns 16 bytes of a K/V row, or VPL = 2 vectors of 16 bytes, LPK * 16
//   bytes apart, where a row exceeds a warp's 512 bytes (f32 at head dim
//   256: 1 KB). Each lane copies exactly the bytes it later
//   computes on, with cp.async into its warp's own ring of kStages chunks,
//   so there is no block-wide sync per key tile: a CTA syncs once after
//   staging its run's table entries and positions (the query rows load
//   meanwhile), and once before the final cross-warp merge. Two chunks
//   (64 KB per CTA) stay in flight while one is scored.
// - Dead columns (trash block 0) are zero-filled by the copy (source size
//   0): never read, so NaN/Inf there cannot reach the output. Columns past
//   the table end score -inf.
// - A run whose every column is invisible to every real row writes
//   (acc 0, m -1e30, l 0) and loads no K/V: exact for every row that sees a
//   key elsewhere (the merge's 2^(-1e30 - m) is 0), finite for the rest.
// - Each CTA writes one f32 partial (acc[D], m, l) per folded row; a second
//   small kernel (attn::split_merge_kernel in attn_tile.cuh, shared with
//   the split chunked prefill) merges the runs with the recurrence of
//   combine_attn_stats (m = max m_i, l = sum 2^(m_i - m) l_i, acc
//   likewise, out = acc / max(l, 1e-30)). It is launched as a programmatic dependent of the first
//   (its launch overlaps the split kernel's tail; griddepcontrol.wait orders
//   it after the partials). One call of paged_attention_fwd is both launches.
//
// Arithmetic is f32 on the CUDA cores (decode has no tensor-core-sized
// product at 3 rows). Scores are f32 dots scaled after the dot, by scale *
// log2(e): the softmax runs in the log2 domain (ex2), exp(s - m) for the
// contract's s and m. Masked scores are -1e30 and the running max starts
// there; p is summed into l in f32 and rounded to T before the PV product;
// a code is converted to f32 exactly, times its column's scale, rounded
// once to T (the plain version's kv_dequantize element for element).

#include <climits>

#include "attn_tile.cuh"

namespace {

using attn::kNegInf;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;         // cp.async ring depth of each warp
constexpr int kChunkBytes = 2048;  // K bytes of one ring chunk (V the same)

template <int D, typename KT>
struct Geo {
  static constexpr int ROW = D * int(sizeof(KT));  // bytes of one K/V row
  static constexpr int VPL = ROW > 512 ? ROW / 512 : 1;  // 16-byte vectors a lane owns
  static constexpr int LPK = ROW / (16 * VPL);     // lanes per key
  static constexpr int KPW = 32 / LPK;             // keys a warp scores at once
  static constexpr int E1 = 16 / int(sizeof(KT));  // row elements per vector
  static constexpr int E = VPL * E1;               // row elements per lane
  static constexpr int KC = kChunkBytes / ROW;     // keys per chunk
  static constexpr int J = KC / KPW;               // keys per lane group per chunk
  static constexpr int kRing = kWarps * kStages * 2 * kChunkBytes;
  static_assert(LPK >= 1 && LPK <= 32 && J >= 1 && KC % KPW == 0, "geometry");
  // row element of a lane's element e (vector e / E1 of the lane's VPL)
  __device__ static int col(int sub, int e) { return ((e / E1) * LPK + sub) * E1 + e % E1; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of a K/V row to f32: elements of T as they are, or 1-byte codes
// times the column's scale rounded to T.
template <typename T, typename KT>
__device__ __forceinline__ void unpack(const uint4 u, float sc, float* f) {
  if constexpr (std::is_same<KT, T>::value) {
    const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < 16 / int(sizeof(T)); ++e) f[e] = attn::to_f(x[e]);
  } else {
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      f[e] = attn::to_f(attn::from_f<T>(attn::code_to_f<KT>(w[e / 4] >> (8 * (e % 4))) * sc));
  }
}

template <typename T, int D, typename KT, int RP>
__global__ void __launch_bounds__(kThreads)
split_decode_kernel(const T* q, const KT* k_arena, const KT* v_arena, const float* k_scale,
                    const float* v_scale, const int* tbl, const int* qpos, const int* kvpos,
                    float* part_acc, float* part_ml, int S, int Nh, int Nkv, int BS,
                    int T_blocks, int split_cols, int nsplit, float sl2) {
  using Gm = Geo<D, KT>;
  constexpr int E = Gm::E, E1 = Gm::E1, VPL = Gm::VPL, J = Gm::J, LPK = Gm::LPK,
                KPW = Gm::KPW;
  constexpr bool kQuant = !std::is_same<KT, T>::value;
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, b = blockIdx.z;
  const int G = Nh / Nkv, GS = G * S;
  const int ngroups = (GS + RP - 1) / RP;
  const int kh = blockIdx.y / ngroups, r0 = (blockIdx.y % ngroups) * RP;
  const int W = T_blocks * BS;
  const int c_begin = split * split_cols;  // a multiple of BS
  const int ncols = min(split_cols, W - c_begin);
  const int nblk = (ncols + BS - 1) / BS;
  int* spos = reinterpret_cast<int*>(smem + Gm::kRing);  // [split_cols]
  int* sblk = spos + split_cols;                          // [split_cols / BS]
  float* sks = reinterpret_cast<float*>(sblk + split_cols / BS);
  float* svs = sks + split_cols / BS;

  int qp[RP];
  int qmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int fr = r0 + i;
    qp[i] = fr < GS ? qpos[size_t(b) * S + fr % S] : INT_MIN;
    qmax = max(qmax, qp[i]);
  }
  // the query rows first: their loads overlap the staging below
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / LPK, sub = lane % LPK;
  float qf[RP][E], m[RP], l[RP], acc[RP][E];
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int fr = r0 + i;
    const T* src = q + ((size_t(b) * S + fr % S) * Nh + size_t(kh) * G + fr / S) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[i][e] = fr < GS ? attn::to_f(src[Gm::col(sub, e)]) : 0.f;
      acc[i][e] = 0.f;
    }
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int* tb = tbl + size_t(b) * T_blocks + c_begin / BS;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    const int blk = tb[i];
    sblk[i] = blk;
    if constexpr (kQuant) {
      const size_t si = size_t(blk) * Nkv + kh;
      sks[i] = blk == 0 ? 0.f : k_scale[si];
      svs[i] = blk == 0 ? 0.f : v_scale[si];
    }
  }
  bool vis = false;
  const int* kp = kvpos + size_t(b) * W + c_begin;
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    const int p = kp[c];
    spos[c] = p;
    vis = vis || p <= qmax;
  }
  const size_t prow0 = ((size_t(b) * Nkv + kh) * nsplit + split) * GS + r0;
  if (!__syncthreads_or(vis)) {
    for (int idx = threadIdx.x; idx < RP * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      if (r0 + i >= GS) continue;
      part_acc[(prow0 + i) * D + d] = 0.f;
      if (d == 0) {
        part_ml[(prow0 + i) * 2] = kNegInf;
        part_ml[(prow0 + i) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  const size_t kv_stride = size_t(Nkv) * D;
  char* wring = smem + warp * kStages * 2 * kChunkBytes;
  const int nchunks = (ncols + Gm::KC - 1) / Gm::KC;
  const int my_chunks = nchunks > warp ? (nchunks - warp + kWarps - 1) / kWarps : 0;
  // this warp's chunk ch covers columns [(warp + kWarps*ch) * KC, +KC) of the run
  // block index (within the run) and slot of key kk of the chunk at cbase:
  // one division per chunk, not per key
  auto locate = [&](int cbase, int kk, int& bi, int& slot) {
    bi = cbase / BS;
    slot = cbase - bi * BS + kk;
    while (slot >= BS) {
      slot -= BS;
      ++bi;
    }
  };
  auto issue = [&](int ch) {
    if (ch < my_chunks) {
      const int cbase = (warp + kWarps * ch) * Gm::KC;
      char* st = wring + (ch % kStages) * 2 * kChunkBytes;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int kk = g + KPW * j, cl = cbase + kk;
        int bi, slot;
        locate(cbase, kk, bi, slot);
        const int blk = cl < ncols ? sblk[bi] : 0;
        const int bytes = blk != 0 ? 16 : 0;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int vec = u * LPK + sub;
          const size_t off =
              (size_t(blk) * BS + slot) * kv_stride + size_t(kh) * D + size_t(vec) * E1;
          cp_async16(st + kk * Gm::ROW + vec * 16, bytes ? k_arena + off : k_arena, bytes);
          cp_async16(st + kChunkBytes + kk * Gm::ROW + vec * 16,
                     bytes ? v_arena + off : v_arena, bytes);
        }
      }
    }
    cp_commit();  // empty groups keep the group count uniform
  };
#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) issue(ch);
  for (int ch = 0; ch < my_chunks; ++ch) {
    issue(ch + kStages - 1);
    cp_wait<kStages - 1>();
    const char* st = wring + (ch % kStages) * 2 * kChunkBytes;
    const int cbase = (warp + kWarps * ch) * Gm::KC;
    float s[RP][J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int kk = g + KPW * j, cl = cbase + kk;
      const bool in = cl < ncols;
      int bi = 0, slot;
      if constexpr (kQuant) locate(cbase, kk, bi, slot);
      float kf[E];
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        unpack<T, KT>(*reinterpret_cast<const uint4*>(st + kk * Gm::ROW + (u * LPK + sub) * 16),
                      kQuant && in ? sks[bi] : 0.f, kf + u * E1);
      float dot[RP];
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        dot[i] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot[i] = fmaf(qf[i][e], kf[e], dot[i]);
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < RP; ++i) dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], o);
      const int pos = in ? spos[cl] : 0;
#pragma unroll
      for (int i = 0; i < RP; ++i)
        s[i][j] = !in ? -INFINITY : (pos <= qp[i] ? dot[i] * sl2 : kNegInf);
    }
    float pr[RP][J];
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < J; ++j) mx = fmaxf(mx, s[i][j]);
      const float mn = fmaxf(m[i], mx);
      const float corr = attn::ex2(m[i] - mn);
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float p = attn::ex2(s[i][j] - mn);
        l[i] += p;
        pr[i][j] = attn::to_f(attn::from_f<T>(p));
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int kk = g + KPW * j, cl = cbase + kk;
      int bi = 0, slot;
      if constexpr (kQuant) locate(cbase, kk, bi, slot);
      float vf[E];
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        unpack<T, KT>(*reinterpret_cast<const uint4*>(st + kChunkBytes + kk * Gm::ROW +
                                                      (u * LPK + sub) * 16),
                      kQuant && cl < ncols ? svs[bi] : 0.f, vf + u * E1);
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pr[i][j], vf[e], acc[i][e]);
    }
  }
  cp_wait<0>();

  // merge the lane groups of the warp (same sub = same head-dim slice)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float mn = fmaxf(m[i], mo);
      const float c1 = attn::ex2(m[i] - mn), c2 = attn::ex2(mo - mn);
      l[i] = l[i] * c1 + lo * c2;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], o);
        acc[i][e] = acc[i][e] * c1 + ao * c2;
      }
    }
  }
  // then the warps, through the (drained) ring
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem);  // [kWarps][RP][D]
  float* wml = wacc + kWarps * RP * D;          // [kWarps][RP][2]
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < RP; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) wacc[(warp * RP + i) * D + Gm::col(sub, e)] = acc[i][e];
      if (sub == 0) {
        wml[(warp * RP + i) * 2] = m[i];
        wml[(warp * RP + i) * 2 + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RP * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    if (r0 + i >= GS) continue;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wml[(w * RP + i) * 2]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = attn::ex2(wml[(w * RP + i) * 2] - M);
      L += c * wml[(w * RP + i) * 2 + 1];
      A += c * wacc[(w * RP + i) * D + d];
    }
    part_acc[(prow0 + i) * D + d] = A;
    if (d == 0) {
      part_ml[(prow0 + i) * 2] = M;
      part_ml[(prow0 + i) * 2 + 1] = L;
    }
  }
}

struct DecodeArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *tbl, *qpos, *kvpos;
  void* out;
  float *part_acc, *part_ml;
  int B, S, Nh, Nkv, BS, Tb, split_cols, nsplit;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, typename KT, int RP>
int run_rp(const DecodeArgs& a) {
  using Gm = Geo<D, KT>;
  constexpr bool kQuant = !std::is_same<KT, T>::value;
  if (a.split_cols % a.BS || a.split_cols > 1 << 16) return attn::kBadArgs;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const size_t tables = size_t(a.split_cols / a.BS) * (kQuant ? 3 : 1);
  const size_t smem = Gm::kRing + sizeof(int) * (size_t(a.split_cols) + tables);
  const dim3 grid(a.nsplit, a.Nkv * ((GS + RP - 1) / RP), a.B);
  const int e = attn::launch_n(split_decode_kernel<T, D, KT, RP>, grid, kThreads, smem, a.stream,
                             static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
                             static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.tbl, a.qpos,
                             a.kvpos, a.part_acc, a.part_ml, a.S, a.Nh, a.Nkv, a.BS, a.Tb,
                             a.split_cols, a.nsplit, a.scale * 1.4426950408889634f);
  if (e != 0) return e;
  return attn::launch_merge<T>(a.part_acc, a.part_ml, static_cast<T*>(a.out), a.B, a.S, a.Nh,
                               a.Nkv, D, a.nsplit, a.stream);
}

// RP folded rows per CTA: 3 where they divide G*S (G = 3, Llama-3.2-3B),
// else 4, so few register rows are padding.
template <typename T, int D, typename KT>
int run_kv(const DecodeArgs& a) {
  const int GS = (a.Nh / a.Nkv) * a.S;
  return GS % 3 == 0 && GS % 4 != 0 ? run_rp<T, D, KT, 3>(a) : run_rp<T, D, KT, 4>(a);
}

template <typename T, int D>
int run(const DecodeArgs& a, int kv) {
  if (kv == 0) return run_kv<T, D, T>(a);
  if (kv == 1) return run_kv<T, D, int8_t>(a);
  if (kv == 2) return run_kv<T, D, __nv_fp8_e4m3>(a);
  return attn::kBadArgs;
}

}  // namespace

// q [B,S,Nh,D], arenas [NB,BS,Nkv,D], scales [NB,Nkv] f32 (null when
// kv_dtype = 0), tbl [B,T] int32, qpos [B,S], kvpos [B,T*BS] int32, out
// like q; part_acc [B*Nkv*nsplit*G*S*D] and part_ml [B*Nkv*nsplit*G*S*2]
// f32 scratch. dtype 0 = float32, 1 = bfloat16; kv_dtype 0 = the query
// dtype, 1 = int8, 2 = fp8-e4m3. Launches the split kernel and the merge.
extern "C" int paged_attention_fwd(const void* q, const void* k_arena, const void* v_arena,
                                   const float* k_scale, const float* v_scale, const int* tbl,
                                   const int* qpos, const int* kvpos, void* out, float* part_acc,
                                   float* part_ml, int B, int S, int Nh, int Nkv, int D, int BS,
                                   int T, int split_cols, int nsplit, float scale, int dtype,
                                   int kv_dtype, void* stream) {
  const DecodeArgs a{q,        k_arena, v_arena, k_scale,    v_scale, tbl,
                     qpos,     kvpos,   out,     part_acc,   part_ml, B,
                     S,        Nh,      Nkv,     BS,         T,       split_cols,
                     nsplit,   scale,   static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && D == 64) return run<float, 64>(a, kv_dtype);
  if (dtype == 0 && D == 128) return run<float, 128>(a, kv_dtype);
  if (dtype == 0 && D == 256) return run<float, 256>(a, kv_dtype);
  if (dtype == 1 && D == 64) return run<__nv_bfloat16, 64>(a, kv_dtype);
  if (dtype == 1 && D == 128) return run<__nv_bfloat16, 128>(a, kv_dtype);
  if (dtype == 1 && D == 256) return run<__nv_bfloat16, 256>(a, kv_dtype);
  return attn::kBadArgs;
}
