// Shared core of the port's CUDA-core attention path (paged_prefill.cu for
// f32 queries; paged_attention.cu and flash_attention.cu use its helpers,
// the fused merge's ticket and its contract): one CTA owns one query tile of
// GQA-folded rows of one (batch row, KV head) and streams KV tiles of
// kBK keys through shared memory with the online-softmax recurrence of
// llm_sharding_tpu/ops/paged_attention.py:376-401 (_online_update) and
// ops/flash_attention.py:89-120 (_flash_kernel):
//
//   s      = (q . k) * scale                f32 dot, scale after the dot
//   s      = kv_pos <= q_pos ? s : -1e30    masked scores are -1e30
//   m_new  = max(m, max_j s)                m starts at -1e30, not -inf
//   p      = exp(s - m_new); corr = exp(m - m_new)
//   l      = l * corr + sum_j p
//   acc    = acc * corr + (p cast to the V dtype) . v
//   out    = acc / max(l, 1e-30)
//
// Starting the running max at -1e30 keeps an all-masked first tile finite
// (exp(0) = 1 per masked key) and the first visible key's correction
// factor exp(-1e30 - m) = 0 wipes that garbage; a row that never sees a
// key ends as the uniform average, exactly like the plain version. Columns
// past a ragged end are excluded outright (score -inf, p = 0). Keys the
// caller marks dead (trash block 0, blocks past nlive) are loaded as zeros
// with a select, never read: the shared trash block may hold Inf/NaN.
//
// What is true of each kernel now:
// - paged_attention.cu (decode, verify) holds every folded row of a KV
//   head in one CTA (mma.sync for bf16), reads TMA rings of 64-key tiles,
//   cuts the rows' live tiles into equal pieces and merges a row's pieces
//   in its own launch (last_run, merge_runs below; its own note); it keeps
//   this header's conversions and the contract above.
// - flash_attention.cu runs bf16 on the tensor cores (wgmma fed by TMA,
//   hopper.cuh), per query head or a KV head's folded rows, split over the
//   SMs and merged in its launch (last_run below; its own merge), and f32
//   as 3xTF32 products on mma.sync; it keeps this header's contract.
// - paged_prefill.cu runs bf16 queries on the tensor cores (wgmma fed by
//   TMA boxes over the block table, wgmma_attn.cuh, split into runs merged
//   by split_merge_kernel below when a chunk's CTAs fall short of the SMs)
//   at block sizes 16, 32 and multiples of 64, and keeps this Tile for f32
//   queries and other block sizes. On the Tile, K/V tiles are copied with
//   16-byte loads, and a tile whose every key is masked for every row of
//   the CTA is skipped once every row has seen a visible key (its keys
//   would add exactly zero).
//
// Quantized arenas (the paged kernels' KV storage type KT = int8_t or
// __nv_fp8_e4m3 instead of T; ops/paged_attention.py:440-451 and :650-658)
// stream 1-byte codes, so each 16-byte load carries 16 of them: a quarter
// (f32) or half (bf16) of the unquantized bytes. Each code is converted to
// f32 exactly, multiplied by its column's per-(block, KV head) f32 scale
// (staged in shared memory beside the column's offset) and rounded to T,
// which is the plain version's kv_dequantize element for element; the
// dequantized tile exists only in shared memory. Dead columns stay zeros
// by the same select, so an Inf scale on the trash block never meets a
// zero code (Inf x 0 = NaN). With KT = T the code path is the
// unquantized one.
//
// Stats mode (context-parallel serving: each shard attends its own blocks
// and the shards' partials are merged by combine_attn_stats; the port of
// attn_stats_xla, llm_sharding_tpu/ops/paged_attention.py:284-346): the
// paged kernels write the unnormalised triple instead of acc / l, all f32,
// acc [B, S, Nh, D] (the sum of p * v), m [B, S, Nh] (the row max in the
// natural-log domain) and l [B, S, Nh] (the sum of p). A column is live
// only where its table entry is not 0 AND its position is visible, and a
// masked column adds exactly zero: its score is -inf instead of -1e30, so
// p = exp(-inf - m) = 0 even while the running max is still -1e30 (with
// -1e30 a wholly masked tile met first would add exp(0) = 1 per column). A
// row that sees no live column comes out as (0, -1e30, 0), and a merge of
// such parts stays finite (each part weighs 2^0 = 1 against an l of 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

namespace attn {

constexpr float kNegInf = -1e30f;   // masked score, initial running max
constexpr int kThreads = 128;       // 4 warps
constexpr int kBK = 64;             // keys per KV tile
constexpr int kTX = 8;              // threads across key columns / head dim
constexpr int kTY = 16;             // threads across query rows
constexpr int kPadPos = -2147483647 - 1;  // q position of a tile-padding row
constexpr int kBadArgs = -1;        // unsupported dtype / head_dim
constexpr int kNoTensorMap = -2;    // cuTensorMapEncodeTiled missing or refused
constexpr float kLn2 = 0.6931471805599453f;

// A stats-mode row max as the plain version gives it: natural-log domain
// from the kernels' log2 one, and -1e30 for a row that saw no live column.
__device__ __forceinline__ float stat_m(float m_log2, float l) {
  return l > 0.f ? m_log2 * kLn2 : kNegInf;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x (the hardware's approximation, flushing denormals): the redesigned
// kernels run scores in the log2 domain, t = s * scale * log2(e), so
// exp(s * scale - m) is ex2(t - m * log2(e)); ex2(-inf) = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 1-byte KV code (the low byte of b) to f32, exactly.
template <typename KT> __device__ __forceinline__ float code_to_f(unsigned int b);
template <> __device__ __forceinline__ float code_to_f<int8_t>(unsigned int b) {
  return static_cast<float>(static_cast<int8_t>(static_cast<unsigned char>(b)));
}
template <> __device__ __forceinline__ float code_to_f<__nv_fp8_e4m3>(unsigned int b) {
  __nv_fp8_e4m3 f;
  f.__x = static_cast<__nv_fp8_storage_t>(b);
  return static_cast<float>(f);
}

// Shared-memory row padding so a row stride is an odd number of 32-bit
// words (no bank conflicts when 8 threads read 8 different rows).
template <typename T> struct RowPad { static constexpr int value = 1; };
template <> struct RowPad<__nv_bfloat16> { static constexpr int value = 2; };

// Query geometry: folded row r = g * S + s of KV head kh is query head
// h = kh * G + g at sequence index s (the fold of flash_attention.py:151-157).
struct QGeom {
  int S, G, Nh, GS;
};

template <typename T, int D, int RI, typename KT = T>
struct Tile {
  static_assert(D % kTX == 0 && (D * sizeof(T)) % 16 == 0, "head_dim");
  static constexpr bool kQuant = !std::is_same<KT, T>::value;  // 1-byte codes + scales
  static_assert(!kQuant || (sizeof(KT) == 1 && D % 16 == 0), "KV storage type");
  static constexpr int BQ = kTY * RI;          // query rows per CTA
  static constexpr int LD = D + RowPad<T>::value;
  static constexpr int DJ = D / kTX;           // acc columns per thread
  static constexpr int CJ = kBK / kTX;         // score columns per thread
  static constexpr int LDP = kBK + 1;
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  static constexpr int PER_ROW = D / VEC;

  static constexpr size_t smem_bytes() {
    return sizeof(T) * size_t(BQ + 2 * kBK) * LD + sizeof(float) * size_t(BQ) * LDP +
           sizeof(long long) * kBK + sizeof(int) * size_t(BQ + kBK) +
           (kQuant ? 2 * sizeof(float) * kBK : 0);
  }

  T* sq;            // [BQ][LD] query tile
  T* sk;            // [kBK][LD] key tile
  T* sv;            // [kBK][LD] value tile
  float* sp;        // [BQ][LDP] probabilities, rounded to T
  long long* soff;  // [kBK] element offset of each key row, -1 = dead
  int* sqpos;       // [BQ]
  int* skpos;       // [kBK]
  float* sks;       // [kBK] K scale of each key row (quantized only)
  float* svs;       // [kBK] V scale of each key row (quantized only)
  int tx, ty;
  float masked;  // score of a masked column: -1e30, or -inf in stats mode
  float m[RI], l[RI], acc[RI][DJ];

  __device__ explicit Tile(char* smem) {
    sq = reinterpret_cast<T*>(smem);
    sk = sq + BQ * LD;
    sv = sk + kBK * LD;
    sp = reinterpret_cast<float*>(sv + kBK * LD);
    soff = reinterpret_cast<long long*>(sp + BQ * LDP);
    sqpos = reinterpret_cast<int*>(soff + kBK);
    skpos = sqpos + BQ;
    sks = reinterpret_cast<float*>(skpos + kBK);
    svs = sks + kBK;
    tx = threadIdx.x % kTX;
    ty = threadIdx.x / kTX;
    masked = kNegInf;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    }
  }

  __device__ static void store_vec(T* dst, uint4 u) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = u.x;
    d[1] = u.y;
    d[2] = u.z;
    d[3] = u.w;
  }

  // q: [B, S, Nh, D]; qpos: [B, S].
  __device__ void load_q(const T* q, const int* qpos, int b, int kh, int r0, QGeom g) {
    for (int idx = threadIdx.x; idx < BQ * PER_ROW; idx += kThreads) {
      const int r = idx / PER_ROW, cv = idx % PER_ROW, fr = r0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (fr < g.GS) {
        const int gg = fr / g.S, s = fr % g.S;
        const T* src = q + ((size_t(b) * g.S + s) * g.Nh + size_t(kh) * g.G + gg) * D;
        u = *reinterpret_cast<const uint4*>(src + cv * VEC);
      }
      store_vec(sq + r * LD + cv * VEC, u);
    }
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int fr = r0 + r;
      sqpos[r] = fr < g.GS ? qpos[size_t(b) * g.S + fr % g.S] : kPadPos;
    }
  }

  // K/V rows of the staged tile (soff) into shared memory; dead rows and
  // rows past n are zeros (selected, not multiplied).
  __device__ void load_kv(const KT* k, const KT* v, int n) {
    if constexpr (kQuant) {
      load_codes(k, v, n);
    } else {
      for (int idx = threadIdx.x; idx < kBK * PER_ROW; idx += kThreads) {
        const int r = idx / PER_ROW, cv = idx % PER_ROW;
        uint4 uk = make_uint4(0u, 0u, 0u, 0u), uv = uk;
        const long long off = r < n ? soff[r] : -1;
        if (off >= 0) {
          uk = *reinterpret_cast<const uint4*>(k + off + cv * VEC);
          uv = *reinterpret_cast<const uint4*>(v + off + cv * VEC);
        }
        store_vec(sk + r * LD + cv * VEC, uk);
        store_vec(sv + r * LD + cv * VEC, uv);
      }
    }
  }

  // Quantized load_kv: 16 codes per 16-byte load, dequantized against the
  // row's staged scales (sks/svs) into T.
  __device__ void load_codes(const KT* k, const KT* v, int n) {
    constexpr int CPR = D / 16;  // 16-byte code loads per row
    for (int idx = threadIdx.x; idx < kBK * CPR; idx += kThreads) {
      const int r = idx / CPR, cv = idx % CPR;
      T* dk = sk + r * LD + cv * 16;
      T* dv = sv + r * LD + cv * 16;
      const long long off = r < n ? soff[r] : -1;
      if (off < 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) dk[i] = dv[i] = from_f<T>(0.f);
        continue;
      }
      const uint4 uk = *reinterpret_cast<const uint4*>(k + off + cv * 16);
      const uint4 uv = *reinterpret_cast<const uint4*>(v + off + cv * 16);
      const unsigned int wk[4] = {uk.x, uk.y, uk.z, uk.w};
      const unsigned int wv[4] = {uv.x, uv.y, uv.z, uv.w};
      const float ks = sks[r], vs = svs[r];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dk[i] = from_f<T>(code_to_f<KT>(wk[i / 4] >> (8 * (i % 4))) * ks);
        dv[i] = from_f<T>(code_to_f<KT>(wv[i / 4] >> (8 * (i % 4))) * vs);
      }
    }
  }

  // One step of the recurrence over the n keys in shared memory.
  __device__ void update(int n, float scale) {
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = to_f(sq[(ty + kTY * i) * LD + d]);
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const float kv = to_f(sk[(tx + kTX * jj) * LD + d]);
#pragma unroll
        for (int i = 0; i < RI; ++i) s[i][jj] = fmaf(qv[i], kv, s[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + kTY * i;
      const int qp = sqpos[row];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const int c = tx + kTX * jj;
        float x;
        if (c >= n) {
          x = -INFINITY;
        } else {
          x = s[i][jj] * scale;
          if (!(skpos[c] <= qp)) x = masked;
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        psum += p;
        sp[row * LDP + tx + kTX * jj] = to_f(from_f<T>(p));
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = to_f(sv[c * LD + tx + kTX * j]);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = sp[(ty + kTY * i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  // out: [B, S, Nh, D] in the query dtype.
  __device__ void store(T* out, int b, int kh, int r0, QGeom g) const {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int fr = r0 + ty + kTY * i;
      if (fr >= g.GS) continue;
      const int gg = fr / g.S, s = fr % g.S;
      T* dst = out + ((size_t(b) * g.S + s) * g.Nh + size_t(kh) * g.G + gg) * D;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) dst[tx + kTX * j] = from_f<T>(acc[i][j] / den);
    }
  }

  // Stats mode: acc [B, S, Nh, D], m and l [B, S, Nh], f32 (m is in the
  // natural-log domain already: this tile runs expf).
  __device__ void store_stats(float* sacc, float* sm, float* sl, int b, int kh, int r0,
                              QGeom g) const {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int fr = r0 + ty + kTY * i;
      if (fr >= g.GS) continue;
      const int gg = fr / g.S, s = fr % g.S;
      const size_t row = (size_t(b) * g.S + s) * g.Nh + size_t(kh) * g.G + gg;
#pragma unroll
      for (int j = 0; j < DJ; ++j) sacc[row * D + tx + kTX * j] = acc[i][j];
      if (tx == 0) {
        sm[row] = m[i];
        sl[row] = l[i];
      }
    }
  }
};

// Key columns of one (row, KV head) of the pooled paged arena, for the
// chunked-prefill kernel. kv_positions is per LOGICAL column
// [B, T*BS]; column c lives in arena block tbl[c / BS] at slot c % BS, and
// table entry 0 (the shared trash block) is dead. A quantized arena's
// column also has the scales of its (block, KV head).
struct PagedCols {
  const int* tbl;       // this row's block table [T]
  const int* kvpos;     // this row's kv_positions [T * BS]
  int block_size;
  long long kv_stride;  // Nkv * D (one arena slot)
  long long head_off;   // kh * D
  const float* k_scale; // [NB, Nkv] (null for an unquantized arena)
  const float* v_scale;
  int num_kv, kh;
  bool stats;  // stats mode: a column of table entry 0 is never visible
  __device__ int pos(int c) const {
    return stats && tbl[c / block_size] == 0 ? INT_MAX : kvpos[c];
  }
  __device__ long long offset(int c) const {
    const int blk = tbl[c / block_size];
    if (blk == 0) return -1;
    return (static_cast<long long>(blk) * block_size + c % block_size) * kv_stride + head_off;
  }
  __device__ void scales(int c, float& ks, float& vs) const {
    const int blk = tbl[c / block_size];
    const long long i = static_cast<long long>(blk) * num_kv + kh;
    ks = blk == 0 ? 0.f : k_scale[i];
    vs = blk == 0 ? 0.f : v_scale[i];
  }
};

// Stream ncols logical key columns through the tile. Cols supplies, per
// column c, its key position (pos), the element offset of its K/V row in
// the source arrays (offset; -1 = dead, loaded as zeros) and, for 1-byte
// codes, its K and V scales (scales). In stats mode (t.masked = -inf) a
// tile that no row can see adds exactly zero whatever the rows have seen,
// so every such tile is skipped, the shard's trash tiles among them.
template <typename T, int D, int RI, typename KT, typename Cols>
__device__ void attend(Tile<T, D, RI, KT>& t, const KT* k, const KT* v, int ncols,
                       const Cols& cols, float scale, int r0, int GS) {
  const bool stats = t.masked == -INFINITY;
  for (int c0 = 0; c0 < ncols; c0 += kBK) {
    const int n = min(kBK, ncols - c0);
    for (int r = threadIdx.x; r < kBK; r += kThreads) {
      t.skpos[r] = r < n ? cols.pos(c0 + r) : 0;
      t.soff[r] = r < n ? cols.offset(c0 + r) : -1;
      if constexpr (Tile<T, D, RI, KT>::kQuant) {
        float ks = 0.f, vs = 0.f;
        if (r < n) cols.scales(c0 + r, ks, vs);
        t.sks[r] = ks;
        t.svs[r] = vs;
      }
    }
    __syncthreads();
    // Skip rule: no key of the tile is visible to any row, and every real
    // row has already seen a visible key (running max above -1e30), so
    // the tile would add exactly zero to acc and l.
    bool visible = false, seeded = true;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = t.ty + kTY * i;
      seeded = seeded && (r0 + row >= GS || t.m[i] > kNegInf);
      const int qp = t.sqpos[row];
#pragma unroll
      for (int jj = 0; jj < Tile<T, D, RI, KT>::CJ; ++jj) {
        const int c = t.tx + kTX * jj;
        visible = visible || (c < n && t.skpos[c] <= qp);
      }
    }
    const int all_seeded = __syncthreads_and(seeded);
    const int any_visible = __syncthreads_or(visible);
    if ((all_seeded || stats) && !any_visible) continue;
    t.load_kv(k, v, n);
    __syncthreads();
    t.update(n, scale);
    __syncthreads();
  }
}

// Raise a kernel's dynamic shared-memory limit to `smem` bytes on the
// current device, once per (kernel, device): cudaFuncSetAttribute is a host
// call of its own, so every launch after the first skips it. Each kernel
// instantiation is launched with one constant size.
inline int smem_attr_once(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == kernel && d.second == dev) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  done.emplace_back(kernel, dev);
  return 0;
}

// Launch a kernel instantiation with `threads` threads per CTA on the
// caller's stream (its shared-memory limit set once) and return
// cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_n(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
             Args... args) {
  const int e = smem_attr_once(reinterpret_cast<const void*>(kernel), smem);
  if (e != 0) return e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// launch_n with the Tile's kThreads.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  return launch_n(kernel, grid, kThreads, smem, stream, args...);
}

// Barrier `id` among the first `n` threads of the CTA (a multiple of 32).
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The merge of the decode kernel's pieces (paged_attention.cu), fused into
// its launch. A run of one (row, KV head) pair's columns writes its f32
// partial (acc [D] unnormalised, then (m, l), m in the log2 domain) for
// each of its folded rows into the pair's slot of the scratch; then
// last_run takes a ticket
// on the pair's counter. The CTA that draws the last of the pair's nparts
// tickets merges every slot in slot (= column) order, so the result does
// not depend on which CTA finished last, and resets the counter to 0 for
// the next launch. Called by the `n` threads of named barrier `bar`
// (thread `tid` of them) after each has written its part of the partial.
__device__ __forceinline__ bool last_run(int* ticket, int nparts, int* sflag, int bar, int n,
                                         int tid) {
  __threadfence();
  named_bar(bar, n);
  if (tid == 0) *sflag = atomicAdd(ticket, 1) == nparts - 1;
  named_bar(bar, n);
  const bool last = *sflag != 0;
  if (last) __threadfence();
  return last;
}

// Fold the nparts partials of folded rows [0, rows) of one pair (partial
// i of row r: acc [D] at acc_of(i) + r * D, (m, l) at ml_of(i) + r * 2)
// with the recurrence of combine_attn_stats (m = max m_i, l = sum 2^(m_i -
// m) l_i, acc likewise; a run that saw nothing, (0, -1e30, 0), weighs 0
// against any seen key) and write acc / max(l, 1e-30) of row r, element d,
// to out(r, d). The work is four rows by 128 columns at a time, dealt to
// warp `warp` of `nwarps` in turn: its lanes fold (m, l) of parts lane,
// lane + 32, ... and combine across the warp, then stream every part's
// acc as float4s with the part's weight 2^(m_i - m) / l shuffled from the
// lane that holds it. Partials are read past L1 (other CTAs wrote them).
// kStats: the stats-mode merge, which writes acc unnormalised (the weight
// is 2^(m_i - m) alone) through out(r, d), an f32 pointer, and hands each
// row's (m, l) to stat(r, m, l), m converted by stat_m.
__device__ __forceinline__ void put_f(float* d, float x) { *d = x; }
__device__ __forceinline__ void put_f(__nv_bfloat16* d, float x) { *d = __float2bfloat16(x); }

template <typename T, int D, bool kStats = false, typename AccOf, typename MlOf, typename Out,
          typename Stat = int>
__device__ void merge_runs(AccOf acc_of, MlOf ml_of, int nparts, int rows, Out out, int warp,
                           int nwarps, Stat stat = 0) {
  constexpr int RPW = 4;              // rows of a group
  constexpr int C4 = D / 4;           // float4 chunks of a row
  constexpr int CG = (C4 + 31) / 32;  // column groups of 32 chunks
  const int lane = threadIdx.x % 32;
  const int ngroups = (rows + RPW - 1) / RPW * CG;
  for (int it = warp; it < ngroups; it += nwarps) {
    const int rb = (it / CG) * RPW, cc = (it % CG) * 32 + lane;
    float M[RPW], L[RPW], inv[RPW];
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      M[q] = kNegInf;
      L[q] = 0.f;
    }
    for (int i = lane; i < nparts; i += 32) {
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        if (rb + q >= rows) continue;
        const float2 x = __ldcg(reinterpret_cast<const float2*>(ml_of(i) + (rb + q) * 2));
        const float mn = fmaxf(M[q], x.x);
        L[q] = L[q] * ex2(M[q] - mn) + x.y * ex2(x.x - mn);
        M[q] = mn;
      }
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, M[q], o);
        const float lo = __shfl_xor_sync(0xffffffffu, L[q], o);
        const float mn = fmaxf(M[q], mo);
        L[q] = L[q] * ex2(M[q] - mn) + lo * ex2(mo - mn);
        M[q] = mn;
      }
      inv[q] = kStats ? 1.f : 1.f / fmaxf(L[q], 1e-30f);
    }
    if constexpr (kStats) {
      if (it % CG == 0 && lane == 0)
#pragma unroll
        for (int q = 0; q < RPW; ++q)
          if (rb + q < rows) stat(rb + q, stat_m(M[q], L[q]), L[q]);
    }
    float4 a[RPW];
#pragma unroll
    for (int q = 0; q < RPW; ++q) a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = 0; base < nparts; base += 32) {
      float wq[RPW];  // the weight of part base + lane in each row
      const int i = base + lane;
#pragma unroll
      for (int q = 0; q < RPW; ++q)
        wq[q] = i < nparts && rb + q < rows
                    ? ex2(__ldcg(ml_of(i) + (rb + q) * 2) - M[q]) * inv[q]
                    : 0.f;
      const int n = min(32, nparts - base);
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) {
        const float* ap = acc_of(base + jj);
#pragma unroll
        for (int q = 0; q < RPW; ++q) {
          const float w = __shfl_sync(0xffffffffu, wq[q], jj);
          if (rb + q >= rows || cc >= C4) continue;
          const float4 x = __ldcg(reinterpret_cast<const float4*>(ap + (rb + q) * D) + cc);
          a[q].x = fmaf(w, x.x, a[q].x);
          a[q].y = fmaf(w, x.y, a[q].y);
          a[q].z = fmaf(w, x.z, a[q].z);
          a[q].w = fmaf(w, x.w, a[q].w);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      if (rb + q >= rows || cc >= C4) continue;
      auto* dst = out(rb + q, cc * 4);
      put_f(dst + 0, a[q].x);
      put_f(dst + 1, a[q].y);
      put_f(dst + 2, a[q].z);
      put_f(dst + 3, a[q].w);
    }
  }
}

// Four 1-byte codes (the bytes of w, lowest first) to f32, exactly.
template <typename KT>
__device__ __forceinline__ void codes4_to_f(uint32_t w, float* f);
template <>
__device__ __forceinline__ void codes4_to_f<int8_t>(uint32_t w, float* f) {
  // bias each byte to x + 128, put it under the exponent byte of 2^23 (one
  // byte permute) and subtract 2^23 + 128: exact, and no conversion
  // instruction
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}
template <>
__device__ __forceinline__ void codes4_to_f<__nv_fp8_e4m3>(uint32_t w, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>((w >> (16 * i)) & 0xFFFFu), __NV_E4M3);
    const float2 x = __half22float2(__half2(h));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The merge pass of paged_prefill.cu's split tensor-core prefill, a second
// launch (decode merges in its own launch: merge_runs above). Partial row
// ((b * Nkv + kh) * nsplit + split) * G*S + r of folded row r = g*S + s
// (query head kh*G + g) holds acc [D] (unnormalised, f32) in part_acc and
// (m, l) in part_ml, m in the log2 domain. One thread per head-dim
// element of one folded row folds the nsplit partials with the recurrence
// of combine_attn_stats (m = max m_i, l = sum 2^(m_i - m) l_i, acc
// likewise; a dead run's (0, -1e30, 0) weighs 0 against any seen key) and
// writes acc / max(l, 1e-30). Stats mode (sm, sl not null): acc
// unnormalised into out as f32, and (m, l) of the row by thread 0.
template <typename T>
__global__ void split_merge_kernel(const float* part_acc, const float* part_ml, void* out,
                                   float* sm, float* sl, int S, int Nh, int Nkv, int D,
                                   int nsplit) {
  // launched early (programmatic dependent launch): wait here until the
  // split kernel's partials are complete and visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = Nh / Nkv, GS = G * S;
  const size_t base = (size_t(b) * Nkv + kh) * nsplit * GS + r;
  float M = kNegInf;
  for (int i = 0; i < nsplit; ++i) M = fmaxf(M, part_ml[(base + size_t(i) * GS) * 2]);
  float L = 0.f, A = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const size_t pr = base + size_t(i) * GS;
    const float c = ex2(part_ml[pr * 2] - M);
    L += c * part_ml[pr * 2 + 1];
    A += c * part_acc[pr * D + d];
  }
  const size_t orow = (size_t(b) * S + r % S) * Nh + size_t(kh) * G + r / S;
  if (sm != nullptr) {
    static_cast<float*>(out)[orow * D + d] = A;
    if (d == 0) {
      sm[orow] = stat_m(M, L);
      sl[orow] = L;
    }
    return;
  }
  static_cast<T*>(out)[orow * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

// Launch the merge as a programmatic dependent of the split kernel just
// queued on `stream` (its launch overlaps that kernel's tail); returns
// 0 or the error.
template <typename T>
int launch_merge(const float* part_acc, const float* part_ml, void* out, float* sm, float* sl,
                 int B, int S, int Nh, int Nkv, int D, int nsplit, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Nh / Nkv) * S, Nkv, B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, split_merge_kernel<T>, part_acc, part_ml, out, sm, sl, S, Nh, Nkv,
                         D, nsplit);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace attn

// dtype: 0 = float32, 1 = bfloat16. RI = 1 (16-row query tiles) when all
// folded rows fit one small tile (a short chunk), else RI = 4 (64-row tiles).
#define ATTN_DISPATCH(RUN, dtype, head_dim, GS, ...)                                         \
  do {                                                                                       \
    const bool small_ = (GS) <= attn::kTY;                                                   \
    if ((dtype) == 0 && (head_dim) == 64)                                                    \
      return small_ ? RUN<float, 64, 1>(__VA_ARGS__) : RUN<float, 64, 4>(__VA_ARGS__);       \
    if ((dtype) == 0 && (head_dim) == 128)                                                   \
      return small_ ? RUN<float, 128, 1>(__VA_ARGS__) : RUN<float, 128, 4>(__VA_ARGS__);     \
    if ((dtype) == 0 && (head_dim) == 256)                                                   \
      return small_ ? RUN<float, 256, 1>(__VA_ARGS__) : RUN<float, 256, 4>(__VA_ARGS__);     \
    if ((dtype) == 1 && (head_dim) == 64)                                                    \
      return small_ ? RUN<__nv_bfloat16, 64, 1>(__VA_ARGS__)                                 \
                    : RUN<__nv_bfloat16, 64, 4>(__VA_ARGS__);                                \
    if ((dtype) == 1 && (head_dim) == 128)                                                   \
      return small_ ? RUN<__nv_bfloat16, 128, 1>(__VA_ARGS__)                                \
                    : RUN<__nv_bfloat16, 128, 4>(__VA_ARGS__);                               \
    if ((dtype) == 1 && (head_dim) == 256)                                                   \
      return small_ ? RUN<__nv_bfloat16, 256, 1>(__VA_ARGS__)                                \
                    : RUN<__nv_bfloat16, 256, 4>(__VA_ARGS__);                               \
    return attn::kBadArgs;                                                                   \
  } while (0)

// The paged kernels' KV storage: 0 = the query dtype T, 1 = int8 codes,
// 2 = fp8-e4m3 codes (each with per-(block, KV head) f32 scales).
#define KV_DISPATCH(RUN, T, D, RI, kv, ...)                                                   \
  do {                                                                                       \
    if ((kv) == 0) return RUN<T, D, RI, T>(__VA_ARGS__);                                     \
    if ((kv) == 1) return RUN<T, D, RI, int8_t>(__VA_ARGS__);                                \
    if ((kv) == 2) return RUN<T, D, RI, __nv_fp8_e4m3>(__VA_ARGS__);                         \
    return attn::kBadArgs;                                                                   \
  } while (0)

extern "C" const char* attn_error_string(int code) {
  if (code == attn::kBadArgs) return "unsupported dtype, KV storage or head_dim";
  if (code == attn::kNoTensorMap) return "cuTensorMapEncodeTiled is missing or refused a map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
