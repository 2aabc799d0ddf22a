// Dense causal flash attention over a KV cache, position-masked: the port
// of llm_sharding_tpu/ops/flash_attention.py:124 (flash_attention, body
// _flash_kernel at :63). The GQA fold puts the G query heads of a KV head
// into one CTA's row axis, so each K/V tile is read once per KV head.
// Grid: (ceil(G*S / BQ), Nkv, B). Design notes and bounds: attn_tile.cuh.

#include "attn_tile.cuh"

namespace {

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

}  // namespace

// q [B,S,Nh,D], k/v [B,C,Nkv,D], qpos [B,S], kvpos [B,C] int32, out like q.
// All contiguous on the device; dtype 0 = float32, 1 = bfloat16. Returns 0
// or the launch's error code (attn_error_string names it).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const int* qpos,
                                   const int* kvpos, void* out, int B, int S, int C, int Nh,
                                   int Nkv, int D, float scale, int dtype, void* stream) {
  const FlashArgs a{q, k, v, qpos, kvpos, out, B, S, C, Nh, Nkv, scale,
                    static_cast<cudaStream_t>(stream)};
  ATTN_DISPATCH(run, dtype, D, (Nh / Nkv) * S, a);
}
