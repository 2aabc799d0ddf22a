// Paged decode attention over the pooled KV arena: the port of
// llm_sharding_tpu/ops/paged_attention.py:484 (paged_attention_tpu, body
// _paged_kernel at :404). Each CTA reads its row's block table itself (the
// TPU kernel scalar-prefetched it) and streams exactly the arena blocks the
// table names; table entry 0 (the shared trash block) streams as zeros.
// The KV loop covers the whole table width, T*BS columns (attn::PagedCols).
// Grid: (ceil(G*S / BQ), Nkv, B). Design notes and bounds: attn_tile.cuh.

#include "attn_tile.cuh"

namespace {

template <typename T, int D, int RI>
__global__ void __launch_bounds__(attn::kThreads)
paged_decode_kernel(const T* q, const T* k_arena, const T* v_arena, const int* tbl,
                    const int* qpos, const int* kvpos, T* out, int S, int Nh, int Nkv, int BS,
                    int T_blocks, float scale) {
  extern __shared__ __align__(16) char smem[];
  attn::Tile<T, D, RI> t(smem);
  const int b = blockIdx.z, kh = blockIdx.y, r0 = blockIdx.x * attn::Tile<T, D, RI>::BQ;
  const int G = Nh / Nkv;
  const attn::QGeom g{S, G, Nh, G * S};
  t.load_q(q, qpos, b, kh, r0, g);
  const int W = T_blocks * BS;
  const attn::PagedCols cols{tbl + size_t(b) * T_blocks, kvpos + size_t(b) * W, BS,
                       static_cast<long long>(Nkv) * D, static_cast<long long>(kh) * D};
  attn::attend(t, k_arena, v_arena, W, cols, scale, r0, g.GS);
  t.store(out, b, kh, r0, g);
}

struct DecodeArgs {
  const void *q, *k, *v;
  const int *tbl, *qpos, *kvpos;
  void* out;
  int B, S, Nh, Nkv, BS, Tb;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int RI>
int run(const DecodeArgs& a) {
  using Tl = attn::Tile<T, D, RI>;
  const int GS = (a.Nh / a.Nkv) * a.S;
  const dim3 grid((GS + Tl::BQ - 1) / Tl::BQ, a.Nkv, a.B);
  return attn::launch(paged_decode_kernel<T, D, RI>, grid, Tl::smem_bytes(), a.stream,
                      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                      static_cast<const T*>(a.v), a.tbl, a.qpos, a.kvpos, static_cast<T*>(a.out),
                      a.S, a.Nh, a.Nkv, a.BS, a.Tb, a.scale);
}

}  // namespace

// q [B,S,Nh,D], arenas [NB,BS,Nkv,D], tbl [B,T] int32, qpos [B,S],
// kvpos [B,T*BS] int32, out like q. dtype 0 = float32, 1 = bfloat16.
extern "C" int paged_attention_fwd(const void* q, const void* k_arena, const void* v_arena,
                                   const int* tbl, const int* qpos, const int* kvpos, void* out,
                                   int B, int S, int Nh, int Nkv, int D, int BS, int T,
                                   float scale, int dtype, void* stream) {
  const DecodeArgs a{q, k_arena, v_arena, tbl, qpos, kvpos, out, B, S, Nh, Nkv, BS, T, scale,
                     static_cast<cudaStream_t>(stream)};
  ATTN_DISPATCH(run, dtype, D, (Nh / Nkv) * S, a);
}
