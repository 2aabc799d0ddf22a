// Chunked-prefill attention over the pooled KV arena: the port of
// llm_sharding_tpu/ops/paged_attention.py:689 (paged_prefill_tpu, body
// _paged_prefill_kernel at :619), in both modes: an arena in the query
// dtype, or int8 / fp8-e4m3 codes with per-(block, KV head) f32 scales,
// dequantized in shared memory (KT, attn_tile.cuh). A whole prompt chunk
// of queries is GQA-folded and tiled; the KV loop of row b stops at its
// written frontier, min(T, nlive[b]) blocks (the TPU kernel re-named dead
// blocks to block 0 so their DMA was elided, :765-778); inside it a key is
// live iff its table entry is not the trash block 0. Causality comes from
// positions alone: the chunk's own KV was written before the call.
// Grid: (ceil(G*Sc / BQ), Nkv, B). Design notes and bounds: attn_tile.cuh.

#include "attn_tile.cuh"

namespace {

template <typename T, int D, int RI, typename KT>
__global__ void __launch_bounds__(attn::kThreads)
paged_prefill_kernel(const T* q, const KT* k_arena, const KT* v_arena, const float* k_scale,
                     const float* v_scale, const int* tbl, const int* qpos, const int* kvpos,
                     const int* nlive, T* out, int S, int Nh, int Nkv, int BS, int T_blocks,
                     float scale) {
  extern __shared__ __align__(16) char smem[];
  attn::Tile<T, D, RI, KT> t(smem);
  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * attn::Tile<T, D, RI, KT>::BQ;
  const int G = Nh / Nkv;
  const attn::QGeom g{S, G, Nh, G * S};
  t.load_q(q, qpos, b, kh, r0, g);
  const int live_blocks = min(T_blocks, max(nlive[b], 0));
  const attn::PagedCols cols{tbl + size_t(b) * T_blocks, kvpos + size_t(b) * T_blocks * BS, BS,
                             static_cast<long long>(Nkv) * D, static_cast<long long>(kh) * D,
                             k_scale, v_scale, Nkv, kh};
  attn::attend(t, k_arena, v_arena, live_blocks * BS, cols, scale, r0, g.GS);
  t.store(out, b, kh, r0, g);
}

struct PrefillArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *tbl, *qpos, *kvpos, *nlive;
  void* out;
  int B, S, Nh, Nkv, BS, Tb, kv;
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
                      a.nlive, static_cast<T*>(a.out), a.S, a.Nh, a.Nkv, a.BS, a.Tb, a.scale);
}

template <typename T, int D, int RI>
int run(const PrefillArgs& a) {
  KV_DISPATCH(run_kv, T, D, RI, a.kv, a);
}

}  // namespace

// q [B,Sc,Nh,D], arenas [NB,BS,Nkv,D], scales [NB,Nkv] f32 (null when
// kv_dtype = 0), tbl [B,T] int32, qpos [B,Sc], kvpos [B,T*BS] int32,
// nlive [B] int32, out like q. dtype 0 = float32, 1 = bfloat16; kv_dtype
// 0 = the query dtype, 1 = int8, 2 = fp8-e4m3.
extern "C" int paged_prefill_fwd(const void* q, const void* k_arena, const void* v_arena,
                                 const float* k_scale, const float* v_scale, const int* tbl,
                                 const int* qpos, const int* kvpos, const int* nlive, void* out,
                                 int B, int S, int Nh, int Nkv, int D, int BS, int T, float scale,
                                 int dtype, int kv_dtype, void* stream) {
  const PrefillArgs a{q,   k_arena, v_arena, k_scale, v_scale, tbl, qpos, kvpos,    nlive,
                      out, B,       S,       Nh,      Nkv,     BS,  T,    kv_dtype, scale,
                      static_cast<cudaStream_t>(stream)};
  ATTN_DISPATCH(run, dtype, D, (Nh / Nkv) * S, a);
}
