// Chunked-prefill attention over the pooled KV arena: the port of
// llm_sharding_tpu/ops/paged_attention.py:689 (paged_prefill_tpu, body
// _paged_prefill_kernel at :619). A whole prompt chunk of queries is
// GQA-folded and tiled; the KV loop of row b stops at its written frontier,
// min(T, nlive[b]) blocks (the TPU kernel re-named dead blocks to block 0
// so their DMA was elided, :765-778); inside it a key is live iff its
// table entry is not the trash block 0. Causality comes from positions
// alone: the chunk's own KV was written before the call.
// Grid: (ceil(G*Sc / BQ), Nkv, B). Design notes and bounds: attn_tile.cuh.

#include "attn_tile.cuh"

namespace {

template <typename T, int D, int RI>
__global__ void __launch_bounds__(attn::kThreads)
paged_prefill_kernel(const T* q, const T* k_arena, const T* v_arena, const int* tbl,
                     const int* qpos, const int* kvpos, const int* nlive, T* out, int S, int Nh,
                     int Nkv, int BS, int T_blocks, float scale) {
  extern __shared__ __align__(16) char smem[];
  attn::Tile<T, D, RI> t(smem);
  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * attn::Tile<T, D, RI>::BQ;
  const int G = Nh / Nkv;
  const attn::QGeom g{S, G, Nh, G * S};
  t.load_q(q, qpos, b, kh, r0, g);
  const int live_blocks = min(T_blocks, max(nlive[b], 0));
  const attn::PagedCols cols{tbl + size_t(b) * T_blocks, kvpos + size_t(b) * T_blocks * BS, BS,
                       static_cast<long long>(Nkv) * D, static_cast<long long>(kh) * D};
  attn::attend(t, k_arena, v_arena, live_blocks * BS, cols, scale, r0, g.GS);
  t.store(out, b, kh, r0, g);
}

struct PrefillArgs {
  const void *q, *k, *v;
  const int *tbl, *qpos, *kvpos, *nlive;
  void* out;
  int B, S, Nh, Nkv, BS, Tb;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int RI>
int run(const PrefillArgs& a) {
  using Tl = attn::Tile<T, D, RI>;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const dim3 grid((GS + Tl::BQ - 1) / Tl::BQ, a.Nkv, a.B);
  return attn::launch(paged_prefill_kernel<T, D, RI>, grid, Tl::smem_bytes(), a.stream,
                      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                      static_cast<const T*>(a.v), a.tbl, a.qpos, a.kvpos, a.nlive,
                      static_cast<T*>(a.out), a.S, a.Nh, a.Nkv, a.BS, a.Tb, a.scale);
}

}  // namespace

// q [B,Sc,Nh,D], arenas [NB,BS,Nkv,D], tbl [B,T] int32, qpos [B,Sc],
// kvpos [B,T*BS] int32, nlive [B] int32, out like q.
// dtype 0 = float32, 1 = bfloat16.
extern "C" int paged_prefill_fwd(const void* q, const void* k_arena, const void* v_arena,
                                 const int* tbl, const int* qpos, const int* kvpos,
                                 const int* nlive, void* out, int B, int S, int Nh, int Nkv,
                                 int D, int BS, int T, float scale, int dtype, void* stream) {
  const PrefillArgs a{q, k_arena, v_arena, tbl, qpos, kvpos, nlive, out, B, S, Nh, Nkv, BS, T,
                      scale, static_cast<cudaStream_t>(stream)};
  ATTN_DISPATCH(run, dtype, D, (Nh / Nkv) * S, a);
}
