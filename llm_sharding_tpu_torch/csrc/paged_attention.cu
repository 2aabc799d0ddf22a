// Paged decode attention over the pooled KV arena: the port of
// llm_sharding_tpu/ops/paged_attention.py:484 (paged_attention_tpu, body
// _paged_kernel at :404), in both modes: an arena in the query dtype, or
// int8 / fp8-e4m3 codes with per-(block, KV head) f32 scales, dequantized
// in shared memory (KT, attn_tile.cuh). Each CTA reads its row's block
// table itself (the TPU kernel scalar-prefetched it) and streams exactly
// the arena blocks the table names; table entry 0 (the shared trash block)
// streams as zeros. The KV loop covers the whole table width, T*BS columns
// (attn::PagedCols). Grid: (ceil(G*S / BQ), Nkv, B). Design notes and
// bounds: attn_tile.cuh.

#include "attn_tile.cuh"

namespace {

template <typename T, int D, int RI, typename KT>
__global__ void __launch_bounds__(attn::kThreads)
paged_decode_kernel(const T* q, const KT* k_arena, const KT* v_arena, const float* k_scale,
                    const float* v_scale, const int* tbl, const int* qpos, const int* kvpos,
                    T* out, int S, int Nh, int Nkv, int BS, int T_blocks, float scale) {
  extern __shared__ __align__(16) char smem[];
  attn::Tile<T, D, RI, KT> t(smem);
  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * attn::Tile<T, D, RI, KT>::BQ;
  const int G = Nh / Nkv;
  const attn::QGeom g{S, G, Nh, G * S};
  t.load_q(q, qpos, b, kh, r0, g);
  const int W = T_blocks * BS;
  const attn::PagedCols cols{tbl + size_t(b) * T_blocks, kvpos + size_t(b) * W, BS,
                             static_cast<long long>(Nkv) * D, static_cast<long long>(kh) * D,
                             k_scale, v_scale, Nkv, kh};
  attn::attend(t, k_arena, v_arena, W, cols, scale, r0, g.GS);
  t.store(out, b, kh, r0, g);
}

struct DecodeArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *tbl, *qpos, *kvpos;
  void* out;
  int B, S, Nh, Nkv, BS, Tb, kv;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int RI, typename KT>
int run_kv(const DecodeArgs& a) {
  using Tl = attn::Tile<T, D, RI, KT>;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const dim3 grid((GS + Tl::BQ - 1) / Tl::BQ, a.Nkv, a.B);
  return attn::launch(paged_decode_kernel<T, D, RI, KT>, grid, Tl::smem_bytes(), a.stream,
                      static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
                      static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.tbl, a.qpos, a.kvpos,
                      static_cast<T*>(a.out), a.S, a.Nh, a.Nkv, a.BS, a.Tb, a.scale);
}

template <typename T, int D, int RI>
int run(const DecodeArgs& a) {
  KV_DISPATCH(run_kv, T, D, RI, a.kv, a);
}

}  // namespace

// q [B,S,Nh,D], arenas [NB,BS,Nkv,D], scales [NB,Nkv] f32 (null when
// kv_dtype = 0), tbl [B,T] int32, qpos [B,S], kvpos [B,T*BS] int32, out
// like q. dtype 0 = float32, 1 = bfloat16; kv_dtype 0 = the query dtype,
// 1 = int8, 2 = fp8-e4m3.
extern "C" int paged_attention_fwd(const void* q, const void* k_arena, const void* v_arena,
                                   const float* k_scale, const float* v_scale, const int* tbl,
                                   const int* qpos, const int* kvpos, void* out, int B, int S,
                                   int Nh, int Nkv, int D, int BS, int T, float scale, int dtype,
                                   int kv_dtype, void* stream) {
  const DecodeArgs a{q,   k_arena, v_arena, k_scale, v_scale, tbl, qpos,     kvpos, out,
                     B,   S,       Nh,      Nkv,     BS,      T,   kv_dtype, scale,
                     static_cast<cudaStream_t>(stream)};
  ATTN_DISPATCH(run, dtype, D, (Nh / Nkv) * S, a);
}
