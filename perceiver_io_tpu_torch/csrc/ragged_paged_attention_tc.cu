// Ragged paged attention for Hopper (sm_90a) on the tensor cores: K4's `tc`
// route for window rows (more than 16 queries a row), fp32 or bf16 queries
// over pools of q's type or int8 with fp32 scales.
//
// Replaces the Pallas TPU kernel in perceiver_io_tpu/ops/ragged_attention.py
// (`_make_kernel`, :82, launched by `_launch`, :156), as the other routes do
// (csrc/ragged_paged_attention_split.cu for decode rows; the first design,
// csrc/ragged_paged_attention.cu, reached by name only). Same function:
// pre-scaled queries q (B, H, Q, D) over a flat token-major k/v pool
// (T, H, D) addressed through a block table (B, pages) and per-row lengths
// (B,); query qi of row r sits at position lengths[r] - Q + qi and sees pool
// positions pos < min(pages * bs, lengths[r] - Q + 1 + qi). fp32 softmax with
// a -1e30 running-max sentinel, masked probabilities zeroed by select, output
// acc / max(l, 1e-30) in q's type: rows with lengths <= 0, and queries that
// see no key (a span shorter than Q), give exact zeros.
//
// What bounds it on the H100: a window row (Q = 512 latents over up to 1024
// keys) does 4*D flops per visible (query, key) pair and reads each live key
// once per 64-query tile: hundreds of flops per byte, so arithmetic bounds
// it. The first design ran the products on the CUDA cores (67 TFLOP/s fp32)
// from tiles staged with synchronous loads. This one runs both products on
// the tensor cores with mma.sync.m16n8k8 TF32 and stays fp32-accurate, as
// the JAX kernel computes in fp32 (it casts k and v to f32):
// - fp32 pools: every product as three TF32 products (3xTF32, the helpers of
//   csrc/tf32x3.cuh shared with K1's and K2/K3's `tf32x3` routes): each
//   operand x split into hi, x rounded to TF32, and lo = x - hi, and a.b
//   taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi;
// - bf16 and int8 pools: their values are exact in TF32 (8 and 7
//   significant bits), so k and v need no lo part and each product takes
//   two TF32 products, a_lo.b + a_hi.b; a bf16 q is exact too, so bf16's
//   S = Q.K^T takes one. p stays fp32 (split into hi and lo), as on the TPU;
// - int8 scales factor out exactly per key: s_ij = scale_k[j] (q_i . k_j)
//   over the raw int8 k, and acc_i = sum_j (p_ij scale_v[j]) v_j.
// TF32 is never turned on. Scores and probabilities stay in registers.
//
// Schedule: K1 `tf32x3`'s (csrc/flash_attention_fwd_tf32.cu): one block of
// 8 warps per (64-query tile, head, row). The grid is (H, B, query tiles),
// the last query tiles first: rows differ in length and the lengths lie on
// the card, so the tiles with the most keys of every row start first and the
// short ones fill the tail. Two warps per 16-query group, each over 32 of a
// kv tile's 64 keys with its own online-softmax state, merged at the end
// through shared memory in a fixed order. A tile reads only the kv tiles
// under its last query's bound, ceil(min(pages * bs, lengths[r] - Q + 1 +
// last) / 64) of them, so it never reads past the row's live span or the
// null block's trash; an idle row reads nothing. q is split into hi and lo
// once per block.
//
// Paged staging: a 64-key tile spans four 16-token pages and key rows sit at
// stride H * D in the pool, so each tile is gathered with cp.async, 16 bytes
// a thread, one table lookup per key row, two stages deep: the next tile's
// copies are in flight while this one is computed. Keys past the bound are
// zero-filled and selected out. fp32 pools land in (64, D + 4) fp32 tiles,
// the stride that serves every fragment read with no bank conflicts; bf16
// and int8 pools land raw (two stages of (64, D)) and each thread widens the
// chunks it copied into one (64, D + 4) fp32 tile (exact). TMA would need
// one box per page; it is left for a later speed change. q, the pools and o
// need 16-byte aligned bases (the wrapper checks). Shared memory at
// D = 128: 199 KB fp32, 197 KB bf16, 165 KB int8: one block per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"  // BM, BN, THREADS, Tile, cp.async, split, mma_tf32, mma3, fragment helpers
#include "vec16.cuh"   // unpack

namespace {

constexpr float NEG = -1e30f;  // the TPU kernel's finite sentinel

template <typename QT, typename P, int D>
struct Cfg {
  static constexpr bool F32 = std::is_same<P, float>::value;      // 3xTF32 on both sides
  static constexpr bool QUANT = std::is_same<P, int8_t>::value;   // per-key scales
  static constexpr bool Q_EXACT = !std::is_same<QT, float>::value;  // bf16 q: no lo part
  static constexpr int S = Tile<D>::S, TF = Tile<D>::FLOATS;
  static constexpr int VEC = 16 / sizeof(P);  // pool values per 16-byte copy
  static constexpr int CH = D / VEC;          // 16-byte chunks a pool row
  static constexpr int KV_STAGES = F32 ? 2 : 1;                    // fp32 k and v tiles
  static constexpr int RAW = F32 ? 0 : 64 * D * (int)sizeof(P) / 4;  // floats of a raw tile
  // q hi and lo, the fp32 k/v tiles, two raw stages each of k and v, and
  // two stages of 64 k and v scales
  static constexpr int SMEM = (2 * TF + 2 * KV_STAGES * TF + 4 * RAW + 4 * 64) * (int)sizeof(float);
};

// Issue the copies of the kv tile of keys [col0, col0 + 64): each key's pool
// row looked up in the table, 16 bytes a copy, into dk/dv ((64, D + 4) fp32
// tiles for fp32 pools, raw (64, D) tiles otherwise), zeros for keys at and
// past n_keys; for int8 pools also each key's k and v scale.
template <typename QT, typename P, int D>
__device__ __forceinline__ void stage_kv(float* dk, float* dv, float* dsk, float* dsv,
                                         const P* __restrict__ pk, const P* __restrict__ pv,
                                         const float* __restrict__ sk, const float* __restrict__ sv,
                                         const int* __restrict__ trow, int H, int hh, int bs, int col0,
                                         int n_keys) {
  using C = Cfg<QT, P, D>;
  for (int idx = threadIdx.x; idx < 64 * C::CH; idx += THREADS) {
    const int r = idx / C::CH, c = idx - (idx / C::CH) * C::CH;
    const int pos = col0 + r;
    const bool ok = pos < n_keys;
    const size_t row = ok ? ((size_t)trow[pos / bs] * bs + pos % bs) * H + hh : 0;
    const int dst = C::F32 ? r * C::S + 4 * c : 4 * idx;
    cp_async16(dk + dst, reinterpret_cast<const float*>(pk + row * D + C::VEC * c), ok);
    cp_async16(dv + dst, reinterpret_cast<const float*>(pv + row * D + C::VEC * c), ok);
  }
  if (C::QUANT && threadIdx.x < 64) {
    const int pos = col0 + threadIdx.x;
    const bool ok = pos < n_keys;
    const size_t row = ok ? ((size_t)trow[pos / bs] * bs + pos % bs) * H + hh : 0;
    cp_async4(dsk + threadIdx.x, sk + row, ok);
    cp_async4(dsv + threadIdx.x, sv + row, ok);
  }
}

// The chunks of a raw (64, D) tile that this thread copied (visible to it
// after its wait), widened into a (64, D + 4) fp32 tile: exact.
template <typename QT, typename P, int D>
__device__ __forceinline__ void widen(float* dst, const float* raw) {
  using C = Cfg<QT, P, D>;
  for (int idx = threadIdx.x; idx < 64 * C::CH; idx += THREADS) {
    const int r = idx / C::CH, c = idx - (idx / C::CH) * C::CH;
    float vals[C::VEC];
    unpack(*reinterpret_cast<const uint4*>(raw + 4 * idx), vals);
    float* d = dst + r * C::S + C::VEC * c;
#pragma unroll
    for (int e = 0; e < C::VEC; e += 4)
      *reinterpret_cast<float4*>(d + e) = make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

// Rows [row0, row0 + 64) of this (row, head)'s q (Q rows of D), zeros past
// Q, split once into TF32 hi and lo tiles (row stride D + 4); a bf16 q is
// its own hi and has no lo tile.
template <typename QT, int D>
__device__ __forceinline__ void load_q(uint32_t* qh, uint32_t* ql, const QT* __restrict__ qg, int row0,
                                       int Q) {
  constexpr int VEC = 16 / sizeof(QT), CH = D / VEC, S = Tile<D>::S;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const int gr = row0 + r;
    const uint4 raw =
        gr < Q ? *reinterpret_cast<const uint4*>(qg + (size_t)gr * D + VEC * c) : make_uint4(0, 0, 0, 0);
    float vals[VEC];
    unpack(raw, vals);
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const int off = r * S + VEC * c + e;
      if constexpr (std::is_same<QT, float>::value) {
        uint4 hi, lo;
        split(vals[e], hi.x, lo.x);
        split(vals[e + 1], hi.y, lo.y);
        split(vals[e + 2], hi.z, lo.z);
        split(vals[e + 3], hi.w, lo.w);
        *reinterpret_cast<uint4*>(qh + off) = hi;
        *reinterpret_cast<uint4*>(ql + off) = lo;
      } else {
        *reinterpret_cast<uint4*>(qh + off) =
            make_uint4(__float_as_uint(vals[e]), __float_as_uint(vals[e + 1]), __float_as_uint(vals[e + 2]),
                       __float_as_uint(vals[e + 3]));
      }
    }
  }
}

// acc[n] += a . tile[k-step kk] over every column pair of a (64, D + 4)
// tile whose values are exact in TF32 (no lo part): two TF32 products, the
// small one first; the B operand in mma3_columns' permuted orders
template <int D>
__device__ __forceinline__ void mma2_columns(float (&acc)[D / 8][4], const uint32_t (&ahi)[4],
                                             const uint32_t (&alo)[4], const float* tile, int kk,
                                             int g, int t) {
  constexpr int S = Tile<D>::S;
  const float* r0 = tile + (8 * kk + 2 * t) * S + 2 * g;
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    const float2 x0 = *reinterpret_cast<const float2*>(r0 + 16 * m);
    const float2 x1 = *reinterpret_cast<const float2*>(r0 + S + 16 * m);
    mma_tf32(acc[2 * m], alo, __float_as_uint(x0.x), __float_as_uint(x1.x));
    mma_tf32(acc[2 * m], ahi, __float_as_uint(x0.x), __float_as_uint(x1.x));
    mma_tf32(acc[2 * m + 1], alo, __float_as_uint(x0.y), __float_as_uint(x1.y));
    mma_tf32(acc[2 * m + 1], ahi, __float_as_uint(x0.y), __float_as_uint(x1.y));
  }
}

// rows r and r + 8 (global g0, g1) of a bf16 (., D) output from an
// accumulator in the permuted column order: 8 bytes a row per column pair
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 8][4], int g0, int g1,
                                           int limit, int t) {
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    const int c = 16 * m + 4 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = h ? g1 : g0;
      if (gr < limit) {
        __nv_bfloat162 a = __floats2bfloat162_rn(acc[2 * m][2 * h], acc[2 * m + 1][2 * h]);
        __nv_bfloat162 b = __floats2bfloat162_rn(acc[2 * m][2 * h + 1], acc[2 * m + 1][2 * h + 1]);
        *reinterpret_cast<uint2*>(out + (size_t)gr * D + c) =
            make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
      }
    }
  }
}

template <typename QT, typename P, int D>
__global__ void __launch_bounds__(THREADS, 1)
ragged_tc_kernel(const QT* __restrict__ q, const P* __restrict__ pk, const P* __restrict__ pv,
                 const float* __restrict__ sk, const float* __restrict__ sv,
                 const int* __restrict__ table, const int* __restrict__ lengths, QT* __restrict__ o,
                 int H, int Q, int pages, int bs) {
  using C = Cfg<QT, P, D>;
  constexpr int S = C::S, TF = C::TF;
  extern __shared__ __align__(16) float smem[];
  float* qh_s = smem;                      // q's hi parts (bits)
  float* ql_s = qh_s + TF;                 // q's lo parts (bits; fp32 q only)
  float* k_f = ql_s + TF;                  // fp32 k tiles: two stages for fp32 pools, else one
  float* v_f = k_f + C::KV_STAGES * TF;    // fp32 v tiles
  float* raw_k = v_f + C::KV_STAGES * TF;  // bf16/int8 pools: two raw stages of k
  float* raw_v = raw_k + 2 * C::RAW;       // and of v
  float* sk_s = raw_v + 2 * C::RAW;        // int8 pools: two stages of 64 k scales
  float* sv_s = sk_s + 2 * 64;             // and of v scales

  const int tid = threadIdx.x, lane = tid & 31;
  const int group = (tid >> 5) & 3, half = tid >> 7, g = lane >> 2, t = lane & 3;
  const int c0 = 32 * half;  // this warp's 32 keys of each tile
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BM;  // the tiles with the most keys first
  const int hh = blockIdx.x, r = blockIdx.y;
  const size_t rh = (size_t)r * H + hh;
  const int L = lengths[r];
  // keys the tile's last query may see, within the table's span
  const int n_keys = max(0, min(pages * bs, L - Q + min(row0 + BM, Q)));
  const int n_tiles = (n_keys + BN - 1) / BN;
  const int* trow = table + (size_t)r * pages;

  if (n_tiles > 0)
    stage_kv<QT, P, D>(C::F32 ? k_f : raw_k, C::F32 ? v_f : raw_v, sk_s, sv_s, pk, pv, sk, sv, trow, H, hh,
                       bs, 0, n_keys);
  cp_async_commit();
  // q hi/lo while the first kv tile is in flight (visible to all after the
  // loop's first barrier)
  uint32_t* qh = reinterpret_cast<uint32_t*>(qh_s);
  uint32_t* ql = reinterpret_cast<uint32_t*>(ql_s);
  load_q<QT, D>(qh, ql, q + rh * (size_t)Q * D, row0, Q);

  const int lr = 16 * group + g;  // this thread's rows lr and lr + 8 of the tile
  const int gr0 = row0 + lr, gr1 = gr0 + 8;
  // query gr sees the keys below L - Q + 1 + gr (and below n_keys: the same
  // bound for the tile's queries, the loaded keys for rows past Q)
  const int lim0 = min(n_keys, L - Q + 1 + gr0), lim1 = min(n_keys, L - Q + 1 + gr1);
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1, col0 = it * BN;
    if (it + 1 < n_tiles) {  // the next tile into the other stage (read two barriers ago)
      const int nx = cur ^ 1;
      stage_kv<QT, P, D>(C::F32 ? k_f + nx * TF : raw_k + nx * C::RAW,
                         C::F32 ? v_f + nx * TF : raw_v + nx * C::RAW,
                         sk_s + nx * 64, sv_s + nx * 64, pk, pv, sk, sv, trow, H, hh, bs, col0 + BN, n_keys);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    if constexpr (!C::F32) {
      widen<QT, P, D>(k_f, raw_k + cur * C::RAW);
      widen<QT, P, D>(v_f, raw_v + cur * C::RAW);
    }
    __syncthreads();  // (and, the first time, every thread's q split)
    const float* kt = C::F32 ? k_f + cur * TF : k_f;
    const float* vt = C::F32 ? v_f + cur * TF : v_f;
    const float* skt = sk_s + cur * 64;
    const float* svt = sv_s + cur * 64;

    // S = Q.K^T: 16 rows x 32 keys a warp, 4 n-tiles; the small terms in
    // their own accumulator, added once per tile
    float s[4][4], small[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = small[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const int o_a = lr * S + 8 * kk + t;
      const uint32_t ah[4] = {qh[o_a], qh[o_a + 8 * S], qh[o_a + 4], qh[o_a + 8 * S + 4]};
      uint32_t al[4] = {0u, 0u, 0u, 0u};
      if constexpr (!C::Q_EXACT) {
        al[0] = ql[o_a];
        al[1] = ql[o_a + 8 * S];
        al[2] = ql[o_a + 4];
        al[3] = ql[o_a + 8 * S + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* kr = kt + (c0 + 8 * j + g) * S + 8 * kk + t;  // B[d][key] = k[key][d]
        if constexpr (C::F32) {
          uint32_t h0, lo0, h1, lo1;
          split(kr[0], h0, lo0);
          split(kr[4], h1, lo1);
          mma_tf32(small[j], al, h0, h1);
          mma_tf32(small[j], ah, lo0, lo1);
          mma_tf32(s[j], ah, h0, h1);
        } else {
          const uint32_t b0 = __float_as_uint(kr[0]), b1 = __float_as_uint(kr[4]);
          if constexpr (!C::Q_EXACT) mma_tf32(small[j], al, b0, b1);
          mma_tf32(s[j], ah, b0, b1);
        }
      }
    }

    // the scale, the select (NEG where not allowed) and this tile's row max
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = c0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] + small[j][e];
        if constexpr (C::QUANT) x *= skt[lc];
        const bool allowed = col0 + lc < (e < 2 ? lim0 : lim1);
        s[j][e] = allowed ? x : NEG;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
        else mx1 = fmaxf(mx1, s[j][e]);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // rescale by exp(m_old - m_new): 1 where the max did not move (also
    // while the row has seen no key: both NEG), 0 from NEG to a real max
    const float alpha0 = m0 == n0 ? 1.f : __expf(m0 - n0);
    const float alpha1 = m1 == n1 ? 1.f : __expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = c0 + 8 * j + 2 * t + (e & 1);
        const bool allowed = col0 + lc < (e < 2 ? lim0 : lim1);
        const float p = allowed ? __expf(s[j][e] - (e < 2 ? n0 : n1)) : 0.f;  // masked: 0 by select
        if (e < 2) sum0 += p;
        else sum1 += p;
        s[j][e] = C::QUANT ? p * svt[lc] : p;  // int8: the key's v scale rides on p
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P.V, the sum over this warp's keys in the permuted order
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      a_from_c(ph, pl, s[kk]);
      if constexpr (C::F32) mma3_columns<D>(acc, ph, pl, vt, c0 / 8 + kk, g, t);
      else mma2_columns<D>(acc, ph, pl, vt, c0 / 8 + kk, g, t);
    }
    __syncthreads();  // this tile's stages are read by no one before the next copies into them
  }
  cp_async_wait<0>();

  // the row sums over the quad
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }

  // the second half's state into the first's, through the q tiles (read no
  // more: the barrier covers a block that ran no kv tile)
  __syncthreads();
  float* red = qh_s + group * (D / 2) * 32 + lane;  // 4 x (D / 2) x 32 floats, lane-contiguous
  float* ml = ql_s + (group * 32 + lane) * 4;       // (m0, m1, l0, l1) a thread
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * n + e) * 32] = acc[n][e];
    *reinterpret_cast<float4*>(ml) = make_float4(m0, m1, l0, l1);
  }
  __syncthreads();
  if (half == 1) return;
  const float4 other = *reinterpret_cast<const float4*>(ml);
  // weights exp(m_half - m): a half that saw no key has l = acc = 0, so its
  // weight (1 when both halves saw nothing) adds exactly 0
  const float mx0 = fmaxf(m0, other.x), mx1 = fmaxf(m1, other.y);
  const float wa0 = __expf(m0 - mx0), wb0 = __expf(other.x - mx0);
  const float wa1 = __expf(m1 - mx1), wb1 = __expf(other.y - mx1);
  // acc / max(l, 1e-30): a query that saw no key gives exactly 0
  const float inv0 = 1.f / fmaxf(l0 * wa0 + other.z * wb0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1 * wa1 + other.w * wb1, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = (acc[n][0] * wa0 + red[(4 * n + 0) * 32] * wb0) * inv0;
    acc[n][1] = (acc[n][1] * wa0 + red[(4 * n + 1) * 32] * wb0) * inv0;
    acc[n][2] = (acc[n][2] * wa1 + red[(4 * n + 2) * 32] * wb1) * inv1;
    acc[n][3] = (acc[n][3] * wa1 + red[(4 * n + 3) * 32] * wb1) * inv1;
  }
  store_rows<D>(o + rh * (size_t)Q * D, acc, gr0, gr1, Q, t);
}

template <typename QT, typename P, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv, const float* sk, const float* sv,
                   const int* table, const int* lengths, void* o, int B, int H, int Q, int pages, int bs,
                   cudaStream_t stream) {
  auto kernel = ragged_tc_kernel<QT, P, D>;
  constexpr int smem = Cfg<QT, P, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Q + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const QT*>(q), static_cast<const P*>(pk),
                                          static_cast<const P*>(pv), sk, sv, table, lengths,
                                          static_cast<QT*>(o), H, Q, pages, bs);
  return cudaGetLastError();
}

template <typename QT, int D>
cudaError_t dispatch_pool(const void* q, const void* pk, const void* pv, const float* sk, const float* sv,
                          const int* table, const int* lengths, void* o, int B, int H, int Q, int pages,
                          int bs, int quantized, cudaStream_t s) {
  if (quantized)
    return launch<QT, int8_t, D>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, s);
  return launch<QT, QT, D>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, s);
}

template <typename QT>
cudaError_t dispatch_dim(const void* q, const void* pk, const void* pv, const float* sk, const float* sv,
                         const int* table, const int* lengths, void* o, int B, int H, int Q, int D,
                         int pages, int bs, int quantized, cudaStream_t s) {
  switch (D) {
    case 64:
      return dispatch_pool<QT, 64>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, quantized, s);
    case 96:
      return dispatch_pool<QT, 96>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, quantized, s);
    case 112:
      return dispatch_pool<QT, 112>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, quantized, s);
    case 128:
      return dispatch_pool<QT, 128>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, quantized, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes; the arguments of the first design's entry
// (csrc/ragged_paged_attention.cu). q and o (B, H, Q, D) contiguous in q's
// type; pool_k, pool_v (pages_total * block_size, H, D) in q's type, or
// int8 when quantized, with scale_k, scale_v (same rows, H) fp32 (else
// null); q, the pools and o on 16-byte aligned bases; table (B, pages)
// int32; lengths (B,) int32. dtype: 0 = float32, 1 = bfloat16. Returns the
// launch's cudaError_t.
extern "C" int ragged_paged_attention_tc(const void* q, const void* pool_k, const void* pool_v,
                                         const void* scale_k, const void* scale_v, const void* table,
                                         const void* lengths, void* o, int B, int H, int Q, int D, int pages,
                                         int block_size, int dtype, int quantized, void* stream) {
  if (B < 1 || H < 1 || Q < 1 || pages < 1 || block_size < 1) return cudaErrorInvalidValue;
  if (quantized && (scale_k == nullptr || scale_v == nullptr)) return cudaErrorInvalidValue;
  const float* sk = static_cast<const float*>(scale_k);
  const float* sv = static_cast<const float*>(scale_v);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, pool_k, pool_v, sk, sv, tb, ln, o, B, H, Q, D, pages, block_size, quantized,
                               s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, pool_k, pool_v, sk, sv, tb, ln, o, B, H, Q, D, pages, block_size,
                                       quantized, s);
  return cudaErrorInvalidValue;
}

// Head dims this library instantiates, for the wrapper's checks.
extern "C" int ragged_paged_attention_tc_supports_head_dim(int d) {
  return d == 64 || d == 96 || d == 112 || d == 128;
}
