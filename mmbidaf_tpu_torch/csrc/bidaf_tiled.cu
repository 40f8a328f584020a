// K9 — blockwise BiDAF attention: the long-T_q mode of K2.
//
// Replaces: mmbidaf_tpu/ops/pallas/bidaf_tiled_kernel.py::_tiled_kernel
// (entry point bidaf_attention_tiled). Contract: K2's (csrc/bidaf.cu), all
// in f32, for any T_q:
//   S     = c·w_c 1ᵀ + 1 (q·w_q)ᵀ + (c∘w_cq)·qᵀ + bias          [T_c, T_q]
//   s_row = softmax over T_q of  qm*S + (1-qm)*(-1e30)
//   s_col = softmax over T_c of  cm*S + (1-cm)*(-1e30)
//   a = s_row·q;   b = s_row·s_colᵀ·c;   out = [c; a; c∘a; c∘b]   [T_c, 4D]
// A fully masked row or column softmaxes to the uniform distribution over
// the true length (the TPU kernel pads both axes to block multiples, so
// there the uniform spreads over the padding too; here the last tiles are
// cut short instead, which keeps K2's function).
//
// What bounds it on the H100: the operations (~0.14 GFLOP per example at
// the long-audio shape T_c=32, T_q=4096, D=256, 2.3 GFLOP at B=16: 0.034 ms
// at the f32 peak of the CUDA cores), once the work is spread over the
// card. The TPU kernel runs one program per example and walks both block
// loops in order inside it. The first port here split T_q over 128-column
// blocks, formed S one thread per element (two shared loads per FMA),
// read q twice, and wrote its partials (16 MB at B=16) to device memory
// for a second launch to combine: 16x its bound.
// Design: one launch, no device-memory scratch (but for long contexts, see
// kSpill below). One thread-block cluster of C blocks an example (grid
// (C, B), csrc/bidaf_cluster.cuh's launch); rank
// r walks its own span of q columns [r·span, (r+1)·span) in tiles of tq
// (walk_plan: C = ceil(T_q / 64) up to 6, and the fewest tiles whose block
// fits 227 KB: 11 tiles of 63 columns at T_q=4096). Up to 6, not 8: a block
// takes a whole SM, and an H100 held only 15 clusters of 8 at once (a
// cluster lives in one GPC), so B=16 ran as two waves (0.27 ms against
// 0.18 at C=6, where 17 fit: one wave of 96 blocks; an H100 80GB HBM3 at
// 700 W). A block holds c∘w_cq (rounded before the product, as the
// reference rounds it) for the whole walk, and each q tile and its mask
// once, in a two-stage cp.async ring: the next tile's copy runs under this
// tile's work, and the tile feeds S, s1 and a. Per tile, four phases
// between barriers:
//   1. S's products (c∘w_cq)·q_tᵀ, D split in halves over the two halves
//      of the block (partials into two buffers);
//   2. four threads a column: s1 = q_j·w_q, S = s0 + s1 + both partials +
//      bias, and the column softmax over all T_c rows, exact in the tile;
//   3. eight threads a row: the row statistics flash-style along the walk,
//      m_new = max(m, max_t v), p = exp(v − m_new), l = l·e^(m − m_new) + Σp;
//   4. a_acc = a_acc·e^(m − m_new) + p·q_t and P_acc = P_acc·e^(m − m_new)
//      + p·s_colᵀ ([T_c, D] and [T_c, T_c], K2's reassociation of Q2C).
// The products are register-blocked from shared memory with float4 operand
// loads, a warp's lanes 4 (rows) x 8 (columns): S 4x4 a thread, a 8 rows x
// 4 columns, P 2x2. A 16-byte shared load of a warp takes four wavefronts
// (a quarter-warp each) even where lanes share addresses, so a thread tile
// of TM x TN gives TM·TN / (TM + TN) FMA instructions a wavefront against
// the SM's 4 a cycle: S 2, a 2.7, P 1. That caps the products near half
// the f32 peak (measured on an H100: the S product at 4x2 ran at 34 % of
// the FMA rate, at 4x4 at 47 %; ~180 registers, one block an SM).
// Rows are padded to multiples of four floats with zeros (exact in every
// sum) and strided by an odd number of float4s, so 8 consecutive rows fall
// on distinct banks.
// After the walk the cluster combines in rank order through distributed
// shared memory with K2's combine (bidaf_cluster.cuh::combine_rows): w_J =
// exp(m_J − M) / Σ_J exp(m_J − M)·l_J, P = Σ_J w_J·P_J; rank r owns D/C
// columns of a = Σ_J w_J·a_J, of b = P·c and of the output. No atomics:
// two runs agree bit for bit. The sums differ in order from the plain
// version (and Q2C is reassociated as in K2); ops/cuda/bidaf_kernel.py
// states the tolerance. Shapes whose c∘w_cq does not fit beside the
// accumulators (T_c=64, D=384, say) read it from device memory instead
// (kResident = false, slow, for odd widths). Long contexts, whose a_acc
// [T_c, D] and P_acc [T_c, T_c] do not fit a block at all (past T_c=114
// at D=256: a serving config with max_sentences=600, say), keep them in
// device memory, B·C·T_c·(D + T_c) floats that the wrapper allocates
// (kSpill, slow: every tile reads and writes them once); rank r then owns
// rows [r·ceil(T_c/C), ...) of the combine and of the output, and forms
// P's rows in place of its own P_acc rows. Where not even the tile's S
// fits (T_c past 4288 at D=256) there is no plan, and the wrapper refuses
// the shape before any launch.
//
// K7's tiled route is this walk with kDrop (entry point
// mmb_bidaf_tiled_forward_dropout; replaces the same TPU kernel as K7,
// mmbidaf_tpu/ops/pallas/bidaf_kernel.py::_bidaf_drop_kernel, for the
// shapes K7's cluster plan refuses: T_c >= 48 at D=256, say). S is formed
// from the dropped operands (s0, c∘w_cq from cd; s1 and S's product from
// qd's tile, held in a second ring beside q's), and a, b and the output
// from the undropped c and q, as K7 does. It also writes each row's
// combined softmax maximum M and sum L = Σ_J exp(m_J − M)·l_J, so that
// K8's tiled route (csrc/bidaf_tiled_bwd.cu) rebuilds s_row = exp(v − M)/L
// without a pass over T_q of its own.
#include "bidaf_cluster.cuh"
#include "common.cuh"
#include "mma.cuh"

#include <math.h>
#include <stdint.h>

namespace {

namespace bc = mmb::bidafc;

constexpr int kThreads = 256;
// Register tiles a thread (products of 4·TM x 8·TN a warp): S (kSM x kSN,
// over half of D in each half of the block), a (kAM rows of 4 columns),
// P (kPM x kPN); at 256 threads, T_c=32 and 64-column tiles, one warp tile
// a warp.
constexpr int kSM = 4, kSN = 4, kAM = 8, kPM = 2, kPN = 2;
constexpr int kWalkCluster = 6;  // ranks a cluster, at most (see the design note)
constexpr int kMinSpan = 64;     // q columns a rank walks, at least, where T_q allows
constexpr int kStages = 2;       // q tiles in flight a block
constexpr int kDropTile = 128;   // K7's tiled route: the widest walk tile (K9's default)

__host__ __device__ inline int round4i(int n) { return (n + 3) & ~3; }

// A row stride of float4 rows: n rounded up to a multiple of 4 floats with an
// odd number of float4s, so 8 consecutive rows start on distinct bank quads.
__host__ __device__ inline int odd4(int n) {
  const int m = round4i(n);
  return (m / 4) % 2 ? m : m + 4;
}

// Shared-memory layout of a block, in floats, every section on a 16-byte
// boundary. The first part is dead after the walk and holds the combine's
// P (and this rank's D columns of c) where they fit; the cluster reads acc,
// pp, m and l of every rank in the combine. With spill, a_acc and P_acc
// live in device memory instead (work floats a block: [Tc][LD], then
// [Tc][LT]) and the combine's weights of this rank's rows in the dead part.
struct WalkLayout {
  int LD, LQ, LT, ND, tq4;
  size_t ring, ring_d, cw, ss, sc, s0, sf, wq, cms, qms;  // dead after the walk
  size_t acc, pp, m, l;                 // read by the cluster
  size_t wts, lw, pf, cs;               // the combine's own
  bool cs_staged;
  size_t floats, work;

  __host__ __device__ WalkLayout(int Tc, int tq, int D, int C, bool resident, bool spill,
                                bool drop = false) {
    LD = odd4(D), LQ = odd4(tq), LT = Tc | 1, ND = ((D + C - 1) / C) | 1, tq4 = round4i(tq);
    size_t o = 0;
    ring = bc::take(o, (size_t)kStages * tq4 * LD);  // [stage][tq4][LD] q tiles
    ring_d = drop ? bc::take(o, (size_t)kStages * tq4 * LD) : ring;  // (K7) qd's tiles
    cw = resident ? bc::take(o, (size_t)Tc * LD) : o;  // [Tc][LD] c∘w_cq
    ss = bc::take(o, (size_t)Tc * LQ);  // [Tc][LQ] S's first half, S, then p
    sc = bc::take(o, (size_t)Tc * LQ);  // [Tc][LQ] S's second half, then s_col
    s0 = bc::take(o, Tc);               // c·w_c
    sf = bc::take(o, Tc);               // the tile's rescale e^(m − m_new)
    wq = bc::take(o, round4i(D));       // w_q, zeros past D
    cms = bc::take(o, Tc);              // c's mask
    qms = bc::take(o, (size_t)kStages * tq4);  // [stage][tq4] the q tile's mask
    const size_t dead = o;
    if (spill) {
      // [C][ceil(Tc / C)] each twice, within the dead part (ring and ss alone
      // hold more than 2·(Tc + C + 6) floats).
      const size_t nw = bc::round4((size_t)C * ((Tc + C - 1) / C));
      acc = pp = pf = cs = 0;
      cs_staged = false;
      m = bc::take(o, Tc);
      l = bc::take(o, Tc);
      wts = 0, lw = nw;
      floats = o;
      work = (size_t)Tc * LD + bc::round4((size_t)Tc * LT);
      return;
    }
    acc = bc::take(o, (size_t)Tc * LD);  // [Tc][LD] a_acc
    pp = bc::take(o, (size_t)Tc * LT);   // [Tc][LT] P_acc
    m = bc::take(o, Tc);                 // running row maxima
    l = bc::take(o, Tc);                 // running row sums
    wts = bc::take(o, (size_t)C * Tc);   // [C][Tc] every rank's m, then w_J
    lw = bc::take(o, (size_t)C * Tc);    // [C][Tc] every rank's l
    const size_t npf = bc::round4((size_t)Tc * LT), ncs = bc::round4((size_t)Tc * ND);
    size_t free_at = 0;  // the first dead float after P
    if (C == 1) {
      pf = pp;  // a cluster of one combines in place
    } else if (npf <= dead) {
      pf = 0, free_at = npf;
    } else {
      pf = bc::take(o, npf);
    }
    cs_staged = free_at + ncs <= dead;
    cs = free_at;
    floats = o;
    work = 0;
  }
};

struct WalkPlan {
  int C;         // blocks a cluster
  int span;      // q columns a rank walks (the last rank's may be fewer)
  int tq;        // q columns a walk tile (a span's last tile may be fewer)
  int resident;  // c∘w_cq held in shared memory
  int smem;      // dynamic shared memory a block, bytes
  int work;      // floats of device memory a block for a_acc and P_acc (0: in shared memory)
};

// The plan for one example of T_c x T_q at width D, walk tiles of at most
// tq_blk columns: the accumulators in shared memory with c∘w_cq resident,
// else without it, else (long contexts: a_acc [Tc, D] and P_acc [Tc, Tc]
// past a block) spilled to device memory, each with the widest tile whose
// block fits; false if none does. drop: K7's layout (two rings).
// ops/cuda/bidaf_kernel.py::tiled_plan mirrors it.
inline bool walk_plan(int Tc, int Tq, int D, int tq_blk, WalkPlan* p, bool drop = false) {
  if (Tc <= 0 || Tq <= 0 || D <= 0 || tq_blk <= 0) return false;
  int C = (Tq + kMinSpan - 1) / kMinSpan;
  if (C > kWalkCluster) C = kWalkCluster;
  const int span = (Tq + C - 1) / C;
  C = (Tq + span - 1) / span;
  const int cap = tq_blk < span ? tq_blk : span;
  for (int spill = 0; spill <= 1; ++spill) {
    for (int resident = 1; resident >= 0; --resident) {
      for (int n = (span + cap - 1) / cap; n <= span; ++n) {  // the fewest tiles a rank that fit
        const int tq = (span + n - 1) / n;
        const WalkLayout L(Tc, tq, D, C, resident, spill, drop);
        if (4 * L.floats <= (size_t)mmb::kMaxSmemBytes) {
          *p = {C, span, tq, resident, (int)(4 * L.floats), (int)L.work};
          return true;
        }
      }
    }
  }
  return false;
}

// Rows [0, nj4) of a q tile into dst [nj4][LD]: the tile's nj rows of D
// floats, zeros past them and past D (exact in every product). 16-byte
// copies where rows are 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src, int nj,
                                          int nj4, int D, int LD, bool vec) {
  const int D4 = round4i(D);
  if (vec) {
    const int g = D4 / 4;
    for (int e = threadIdx.x; e < nj4 * g; e += blockDim.x) {
      const int row = e / g, k = 4 * (e - row * g);
      const bool in = row < nj;
      mmb::cp_async16(mmb::smem_u32(dst + row * LD + k), in ? src + (size_t)row * D + k : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < nj4 * D4; e += blockDim.x) {
      const int row = e / D4, d = e - row * D4;
      const bool in = row < nj && d < D;
      mmb::cp_async4(dst + row * LD + d, in ? src + (size_t)row * D + d : src, in);
    }
  }
}

// An [M, N] product over the float4 steps [k0, k1) of K-contiguous operands
// by warps [w0, w0 + nwarps) of the block: acc[m][n] = Σ_k A(m, k)·B(n, k)
// in k order, A(m, k4) / B(n, k4) the float4 of entries 4·k4 .. 4·k4+3.
// A warp's lanes are 4 rows x 8 columns,
// each thread TM x TN entries (rows 4 apart, columns 8 apart), so a warp
// tile is 4·TM x 8·TN; rows and columns past the edge are clamped for the
// loads and skipped by epi(m, n, v).
template <int TM, int TN, typename ALoad, typename BLoad, typename Epi>
__device__ __forceinline__ void nt_product(int M, int N, int k0, int k1, int w0, int nwarps,
                                           ALoad a, BLoad b, Epi epi) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0;
  const int lr = lane >> 3, lc = lane & 7;
  const int wn = (N + 8 * TN - 1) / (8 * TN), nw = (M + 4 * TM - 1) / (4 * TM) * wn;
  if (warp < 0 || warp >= nwarps) return;
  for (int w = warp; w < nw; w += nwarps) {
    const int bm = (w / wn) * 4 * TM + lr, bn = (w % wn) * 8 * TN + lc;
    int ms[TM], ns[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ms[i] = min(bm + 4 * i, M - 1);
#pragma unroll
    for (int j = 0; j < TN; ++j) ns[j] = min(bn + 8 * j, N - 1);
    float acc[TM][TN] = {};
#pragma unroll 2
    for (int k = k0; k < k1; ++k) {
      float4 av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a(ms[i], k);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b(ns[j], k);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float s = acc[i][j];
          s = fmaf(av[i].x, bv[j].x, s);
          s = fmaf(av[i].y, bv[j].y, s);
          s = fmaf(av[i].z, bv[j].z, s);
          acc[i][j] = fmaf(av[i].w, bv[j].w, s);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (bm + 4 * i < M && bn + 8 * j < N) epi(bm + 4 * i, bn + 8 * j, acc[i][j]);
  }
}

// An [M, 4·NG] product of a K-contiguous A and a row-major B over K4 float4
// steps: acc[m][4g .. 4g+3] = Σ_k A(m, k)·B(k, g) in k order, A(m, k4) the
// float4 of A[m][4k4 .. 4k4+3], B(k, g) the float4 of B[k][4g .. 4g+3]. A
// warp's lanes are 4 rows x 8 column groups, each thread TM rows (4 apart)
// of one group; epi(m, g, v) stores a row's four sums.
template <int TM, typename ALoad, typename BLoad, typename Epi>
__device__ __forceinline__ void nn_product(int M, int NG, int K4, ALoad a, BLoad b, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lr = lane >> 3, lc = lane & 7;
  const int wn = (NG + 7) / 8, nw = (M + 4 * TM - 1) / (4 * TM) * wn;
  for (int w = warp; w < nw; w += nwarps) {
    const int bm = (w / wn) * 4 * TM + lr, bg = (w % wn) * 8 + lc, g = min(bg, NG - 1);
    int ms[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ms[i] = min(bm + 4 * i, M - 1);
    float4 acc[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int k = 0; k < K4; ++k) {
      float4 av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a(ms[i], k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bv[kk] = b(4 * k + kk, g);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
        float4 s = acc[i];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          s.x = fmaf(x[kk], bv[kk].x, s.x);
          s.y = fmaf(x[kk], bv[kk].y, s.y);
          s.z = fmaf(x[kk], bv[kk].z, s.z);
          s.w = fmaf(x[kk], bv[kk].w, s.w);
        }
        acc[i] = s;
      }
    }
    if (bg < NG) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (bm + 4 * i < M) epi(bm + 4 * i, g, acc[i]);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool kResident, bool kSpill, bool kDrop>
__global__ void __launch_bounds__(kThreads) bidaf_tiled_cluster_kernel(
    const float* __restrict__ c, const float* __restrict__ q,            // [B,Tc,D], [B,Tq,D]
    const float* __restrict__ cd, const float* __restrict__ qd,          // kDrop: S's operands
    const float* __restrict__ c_mask, const float* __restrict__ q_mask,  // [B,Tc], [B,Tq]
    const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias,      // [D] x3, [1]
    float* __restrict__ out,                                             // [B,Tc,4D]
    float* __restrict__ stats,  // kDrop: [B][2][Tc] each row's combined M, then L
    float* __restrict__ work,  // kSpill: [B][C][L.work] every block's a_acc and P_acc
    int Tc, int Tq, int D, int span, int tq) {
  bc::cg::cluster_group cluster = bc::cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, r = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const WalkLayout L(Tc, tq, D, C, kResident, kSpill, kDrop);
  const int LD = L.LD, LQ = L.LQ, LT = L.LT, D4 = round4i(D);
  const int j_begin = r * span, j_end = min(j_begin + span, Tq);
  const int nt = (j_end - j_begin + tq - 1) / tq;
  const float* cb = c + (size_t)b * Tc * D;
  const float* qb = q + ((size_t)b * Tq + j_begin) * D;  // this rank's first q row
  // S's operands: cd and qd's tiles (K7), else c and q's.
  const float* sb = kDrop ? cd + (size_t)b * Tc * D : cb;
  const float* qdb = kDrop ? qd + ((size_t)b * Tq + j_begin) * D : qb;
  float* const stat_m = kDrop ? stats + (size_t)b * 2 * Tc : nullptr;
  const float* cm = c_mask + (size_t)b * Tc;
  const float* qm = q_mask + (size_t)b * Tq + j_begin;
  const float bias_v = *bias;
  float *ring = smem + L.ring, *cw = smem + L.cw, *ss = smem + L.ss, *sc = smem + L.sc;
  float *s0 = smem + L.s0, *sf = smem + L.sf;
  float* const work0 = kSpill ? work + (size_t)b * C * L.work : nullptr;  // this example's rank 0
  float* acc = kSpill ? work0 + (size_t)r * L.work : smem + L.acc;
  float* pp = kSpill ? acc + (size_t)Tc * LD : smem + L.pp;
  float *mrow = smem + L.m, *lrow = smem + L.l;
  float *wq_s = smem + L.wq, *cm_s = smem + L.cms;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                   (!kDrop || (reinterpret_cast<uintptr_t>(qd) & 15) == 0);
  const bool vec_c = D % 4 == 0 && (reinterpret_cast<uintptr_t>(sb) & 15) == 0;
  const size_t stage = (size_t)L.tq4 * LD;
  // Tile t and its mask into its stage; one commit group either way.
  const auto prefetch = [&](int t) {
    if (t < nt) {
      const int nj = min(tq, j_end - j_begin - t * tq), nj4 = round4i(nj);
      copy_tile(ring + (t % kStages) * stage, qb + (size_t)t * tq * D, nj, nj4, D, LD, vec);
      if (kDrop)
        copy_tile(smem + L.ring_d + (t % kStages) * stage, qdb + (size_t)t * tq * D, nj, nj4, D,
                  LD, vec);
      float* mk = smem + L.qms + (t % kStages) * L.tq4;
      for (int j = tid; j < nj4; j += blockDim.x)
        mmb::cp_async4(mk + j, j < nj ? qm + t * tq + j : qm, j < nj);
    }
    mmb::cp_async_commit_group();
  };
  if (kResident) copy_tile(cw, sb, Tc, Tc, D, LD, vec_c);  // c (cd), zeros past D; in tile 0's group
#pragma unroll
  for (int t = 0; t < kStages; ++t) prefetch(t);

  // The walk's statistics and accumulators; s0 = c·w_c (a warp a row) and
  // c∘w_cq in place (rounded as the reference rounds it).
  for (int d = tid; d < D4; d += blockDim.x) wq_s[d] = d < D ? w_q[d] : 0.0f;
  for (int i = tid; i < Tc; i += blockDim.x) cm_s[i] = cm[i];
  for (int e = tid; e < Tc * LD; e += blockDim.x) acc[e] = 0.0f;
  for (int e = tid; e < Tc * LT; e += blockDim.x) pp[e] = 0.0f;
  for (int i = tid; i < Tc; i += blockDim.x) mrow[i] = -INFINITY, lrow[i] = 0.0f;
  if (kResident) {
    mmb::cp_async_wait_group<kStages - 1>();
    __syncthreads();
  }
  const float* c_rows = kResident ? cw : sb;  // row i at c_rows + i·(LD or D)
  const int c_ld = kResident ? LD : D;
  for (int i = warp; i < Tc; i += nwarps) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(c_rows[(size_t)i * c_ld + d], __ldg(w_c + d), s);
    s = mmb::warp_sum(s);
    if (lane == 0) s0[i] = s;
  }
  if (kResident) {
    __syncthreads();
    for (int d = tid; d < D; d += blockDim.x) {
      const float w = __ldg(w_cq + d);
      for (int i = 0; i < Tc; ++i) cw[i * LD + d] *= w;
    }
  }

  const auto cw_load = [&](int i, int k) -> float4 {
    if constexpr (kResident) {
      return ld4(cw + i * LD + 4 * k);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * k + e;
        v[e] = d < D ? __ldg(sb + (size_t)i * D + d) * __ldg(w_cq + d) : 0.0f;
      }
      return make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  for (int t = 0; t < nt; ++t) {
    const int j0 = t * tq, nj = min(tq, j_end - j_begin - j0), nj4 = round4i(nj);
    const float* qt = ring + (t % kStages) * stage;
    const float* qdt = smem + L.ring_d + (t % kStages) * stage;  // qt but with kDrop
    mmb::cp_async_wait_group<kStages - 1>();
    __syncthreads();  // tile t (and, at t = 0, the set-up above) in place

    // 1. S's products, D split in halves over the two halves of the block:
    // c∘w_cq·q_tᵀ over the first half into ss, over the second into sc.
    {
      const int half = nwarps / 2, k4 = D4 / 4, mid = k4 / 2;
      const bool hi = warp >= half;
      float* part = hi ? sc : ss;
      nt_product<kSM, kSN>(
          Tc, nj, hi ? mid : 0, hi ? k4 : mid, hi ? half : 0, half, cw_load,
          [&](int j, int k) { return ld4(qdt + j * LD + 4 * k); },
          [&](int i, int j, float v) { part[i * LQ + j] = v; });
    }
    __syncthreads();

    // 2. Four threads a column: s1_j = q_j·w_q, S = s0 + s1 + c∘w_cq·q_jᵀ
    // + bias into ss, and s_col over all T_c rows into sc.
    const float* qmt = smem + L.qms + (t % kStages) * L.tq4;
    for (int base = 0; base < nj; base += blockDim.x / 4) {
      const int j = base + (tid >> 2), sub = tid & 3;
      const bool on = j < nj;
      float s1j = 0.0f, mx = -INFINITY, sum = 0.0f;
      if (on) {
        for (int k = sub; k < D4 / 4; k += 4) {
          const float4 a = ld4(qdt + j * LD + 4 * k), w = ld4(wq_s + 4 * k);
          s1j = fmaf(a.x, w.x, s1j);
          s1j = fmaf(a.y, w.y, s1j);
          s1j = fmaf(a.z, w.z, s1j);
          s1j = fmaf(a.w, w.w, s1j);
        }
      }
      s1j += __shfl_xor_sync(0xffffffffu, s1j, 1);
      s1j += __shfl_xor_sync(0xffffffffu, s1j, 2);
      if (on) {
        for (int i = sub; i < Tc; i += 4) {
          const float S = s0[i] + s1j + (ss[i * LQ + j] + sc[i * LQ + j]) + bias_v;
          ss[i * LQ + j] = S;
          const float mk = cm_s[i];
          mx = fmaxf(mx, mk * S + (1.0f - mk) * mmb::kNegInf);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (on) {
        for (int i = sub; i < Tc; i += 4) {
          const float mk = cm_s[i];
          const float e = expf(mk * ss[i * LQ + j] + (1.0f - mk) * mmb::kNegInf - mx);
          sc[i * LQ + j] = e;
          sum += e;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (on) {
        const float inv = 1.0f / sum;
        for (int i = sub; i < Tc; i += 4) sc[i * LQ + j] *= inv;
      }
    }
    __syncthreads();

    // 3. Eight threads a row: the running maximum, p = exp(v − m_new) into
    // ss, l and this tile's rescale; zeros past nj in ss and sc.
    for (int base = 0; base < Tc; base += blockDim.x / 8) {
      const int i = base + (tid >> 3), sub = tid & 7;
      const bool on = i < Tc;
      float* row = ss + (on ? i : 0) * LQ;
      float mx = -INFINITY, sum = 0.0f;
      if (on) {
        for (int j = sub; j < nj; j += 8) {
          const float mk = qmt[j];
          mx = fmaxf(mx, mk * row[j] + (1.0f - mk) * mmb::kNegInf);
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = on ? mrow[i] : 0.0f, m_new = fmaxf(m_old, mx);
      if (on) {
        for (int j = sub; j < nj; j += 8) {
          const float mk = qmt[j];
          const float e = expf(mk * row[j] + (1.0f - mk) * mmb::kNegInf - m_new);
          row[j] = e;
          sum += e;
        }
        for (int j = nj + sub; j < nj4; j += 8) row[j] = 0.0f, sc[i * LQ + j] = 0.0f;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (on && sub == 0) {
        const float scale = expf(m_old - m_new);
        sf[i] = scale;
        lrow[i] = fmaf(lrow[i], scale, sum);
        mrow[i] = m_new;
      }
    }
    __syncthreads();

    // 4. a_acc = a_acc·scale + p·q_t;  P_acc = P_acc·scale + p·s_colᵀ.
    const auto p_load = [&](int i, int k) { return ld4(ss + i * LQ + 4 * k); };
    nn_product<kAM>(
        Tc, D4 / 4, nj4 / 4, p_load, [&](int k, int g) { return ld4(qt + k * LD + 4 * g); },
        [&](int i, int g, float4 v) {
          float4* o = reinterpret_cast<float4*>(acc + i * LD + 4 * g);
          const float s = sf[i];
          const float4 a = *o;
          *o = make_float4(fmaf(a.x, s, v.x), fmaf(a.y, s, v.y), fmaf(a.z, s, v.z),
                           fmaf(a.w, s, v.w));
        });
    nt_product<kPM, kPN>(
        Tc, Tc, 0, nj4 / 4, 0, nwarps, p_load,
        [&](int k, int kk) { return ld4(sc + k * LQ + 4 * kk); },
        [&](int i, int k, float v) { pp[i * LT + k] = fmaf(pp[i * LT + k], sf[i], v); });
    __syncthreads();  // this tile's stage, ss and sc are free
    prefetch(t + kStages);
  }
  mmb::cp_async_wait_group<0>();

  if constexpr (kSpill) {
    // Rank r owns the rows [i0, i0 + nr) of every output; P's rows go in
    // place of its own P_acc rows, which no other rank reads.
    __threadfence();  // this rank's a_acc and P_acc, in device memory, for the cluster
    cluster.sync();
    const int NR = (Tc + C - 1) / C, i0 = min(r * NR, Tc), nr = min(NR, Tc - i0);
    float *wts = smem + L.wts, *lw = smem + L.lw;  // [C][NR]
    for (int e = tid; e < C * nr; e += blockDim.x) {
      const int J = e / nr, ii = e - J * nr;
      wts[J * NR + ii] = cluster.map_shared_rank(mrow, J)[i0 + ii];
      lw[J * NR + ii] = cluster.map_shared_rank(lrow, J)[i0 + ii];
    }
    __syncthreads();
    for (int ii = tid; ii < nr; ii += blockDim.x) {  // combine_rows' weights
      float M = -INFINITY;
      for (int J = 0; J < C; ++J) M = fmaxf(M, wts[J * NR + ii]);
      float tot = 0.0f;
      for (int J = 0; J < C; ++J) {
        const float s = expf(wts[J * NR + ii] - M);
        wts[J * NR + ii] = s;
        tot = fmaf(s, lw[J * NR + ii], tot);
      }
      for (int J = 0; J < C; ++J) wts[J * NR + ii] = wts[J * NR + ii] / tot;
      if (kDrop) stat_m[i0 + ii] = M, stat_m[Tc + i0 + ii] = tot;
    }
    __syncthreads();
    // Other ranks' accumulators through L2 (__ldcg), not this SM's L1.
    const size_t blk = L.work, pp_at = (size_t)Tc * LD;
    for (int e = tid; e < nr * Tc; e += blockDim.x) {
      const int ii = e / Tc, k = e - ii * Tc, i = i0 + ii;
      float v = 0.0f;
#pragma unroll 4
      for (int J = 0; J < C; ++J)
        v = fmaf(wts[J * NR + ii], __ldcg(work0 + J * blk + pp_at + i * LT + k), v);
      pp[i * LT + k] = v;
    }
    for (int e = tid; e < nr * D; e += blockDim.x) {
      const int ii = e / D, d = e - ii * D, i = i0 + ii;
      float a = 0.0f;
#pragma unroll 4
      for (int J = 0; J < C; ++J)
        a = fmaf(wts[J * NR + ii], __ldcg(work0 + J * blk + i * LD + d), a);
      const float cv = __ldg(cb + (size_t)i * D + d);
      float* o = out + ((size_t)b * Tc + i) * 4 * D;
      o[D + d] = a;
      o[2 * D + d] = cv * a;
    }
    __syncthreads();  // P's rows in place
    for (int e = tid; e < nr * D; e += blockDim.x) {
      const int ii = e / D, d = e - ii * D, i = i0 + ii;
      float bv = 0.0f;
      for (int k = 0; k < Tc; ++k) bv = fmaf(pp[i * LT + k], __ldg(cb + (size_t)k * D + d), bv);
      const float cv = __ldg(cb + (size_t)i * D + d);
      float* o = out + ((size_t)b * Tc + i) * 4 * D;
      o[d] = cv;
      o[3 * D + d] = cv * bv;
    }
    cluster.sync();  // no block leaves while the cluster still reads its m and l
  } else {
    // This rank's D columns of c for b = P·c: staged in the dead part of the
    // layout where they fit, else read from device memory.
    const int d0 = r * D / C, nd = (r + 1) * D / C - d0;
    const float* cs = cb + d0;
    int cld = D;
    if (L.cs_staged) {
      float* dst = smem + L.cs;
      for (int e = tid; e < Tc * nd; e += blockDim.x) {
        const int i = e / nd, dd = e - i * nd;
        dst[i * L.ND + dd] = cs[(size_t)i * D + dd];
      }
      cs = dst, cld = L.ND;
    }
    cluster.sync();  // every rank's m, l, a_acc and P_acc are final

    // The weights w_J and P; this rank's D columns of a, b = P·c and
    // out = [c; a; c∘a; c∘b].
    bc::combine_rows(smem, L, Tc, C, cluster, kDrop && r == 0 ? stat_m : nullptr,
                     kDrop && r == 0 ? stat_m + Tc : nullptr);
    const float* wts = smem + L.wts;
    const float* pf = smem + L.pf;
    for (int e = tid; e < Tc * nd; e += blockDim.x) {
      const int i = e / nd, dd = e - i * nd, d = d0 + dd;
      float a = 0.0f;
#pragma unroll 4
      for (int J = 0; J < C; ++J)
        a = fmaf(wts[J * Tc + i], cluster.map_shared_rank(acc, J)[i * LD + d], a);
      float bv = 0.0f;
      for (int k = 0; k < Tc; ++k) bv = fmaf(pf[i * LT + k], cs[(size_t)k * cld + dd], bv);
      const float cv = cs[(size_t)i * cld + dd];
      float* o = out + ((size_t)b * Tc + i) * 4 * D;
      o[d] = cv;
      o[D + d] = a;
      o[2 * D + d] = cv * a;
      o[3 * D + d] = cv * bv;
    }
    cluster.sync();  // no block leaves while the cluster still reads its shared memory
  }
}

// grid (C, B) with clusters of C along x (bidaf_cluster.cuh's launch).
bc::Plan cluster_of(const WalkPlan& p) { return {p.C, p.tq, p.smem, p.smem}; }

template <bool kDrop>
decltype(&bidaf_tiled_cluster_kernel<true, false, kDrop>) kernel_of(const WalkPlan& p) {
  if (p.work > 0)
    return p.resident ? &bidaf_tiled_cluster_kernel<true, true, kDrop>
                      : &bidaf_tiled_cluster_kernel<false, true, kDrop>;
  return p.resident ? &bidaf_tiled_cluster_kernel<true, false, kDrop>
                    : &bidaf_tiled_cluster_kernel<false, false, kDrop>;
}

}  // namespace

// K9: one launch; tq_blk caps the walk tile. work: B·C·plan.work floats of
// device memory where the plan spills its accumulators, else unused (may be
// null).
MMB_API int mmb_bidaf_tiled_forward(const void* c, const void* q, const void* c_mask,
                                    const void* q_mask, const void* w_c, const void* w_q,
                                    const void* w_cq, const void* bias, void* out, void* work,
                                    int B, int Tc, int Tq, int D, int tq_blk, void* stream) {
  WalkPlan p;
  if (B <= 0 || B > 65535 || !walk_plan(Tc, Tq, D, tq_blk, &p) || (p.work > 0 && !work))
    return (int)cudaErrorInvalidValue;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)bc::launch(kernel_of<false>(p), cluster_of(p), B, kThreads, p.smem, s, f(c), f(q),
                         f(nullptr), f(nullptr), f(c_mask), f(q_mask), f(w_c), f(w_q), f(w_cq),
                         f(bias), static_cast<float*>(out), static_cast<float*>(nullptr),
                         static_cast<float*>(work), Tc, Tq, D, p.span, p.tq);
}

// K7's tiled route: one launch of the walk with S from cd and qd (tiles of
// at most 128 columns). stats: [B][2][T_c], each row's combined softmax
// maximum, then its sum; work as for K9.
MMB_API int mmb_bidaf_tiled_forward_dropout(const void* c, const void* q, const void* cd,
                                            const void* qd, const void* c_mask,
                                            const void* q_mask, const void* w_c, const void* w_q,
                                            const void* w_cq, const void* bias, void* out,
                                            void* stats, void* work, int B, int Tc, int Tq, int D,
                                            void* stream) {
  WalkPlan p;
  if (B <= 0 || B > 65535 || !stats || !walk_plan(Tc, Tq, D, kDropTile, &p, true) ||
      (p.work > 0 && !work))
    return (int)cudaErrorInvalidValue;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  return (int)bc::launch(kernel_of<true>(p), cluster_of(p), B, kThreads, p.smem,
                         static_cast<cudaStream_t>(stream), f(c), f(q), f(cd), f(qd), f(c_mask),
                         f(q_mask), f(w_c), f(w_q), f(w_cq), f(bias), static_cast<float*>(out),
                         static_cast<float*>(stats), static_cast<float*>(work), Tc, Tq, D, p.span,
                         p.tq);
}

// K7's tiled plan: out[6] as mmb_bidaf_tiled_plan's, for K7's layout.
MMB_API int mmb_bidaf_tiled_drop_plan(int Tc, int Tq, int D, int* out) {
  WalkPlan p;
  if (!walk_plan(Tc, Tq, D, kDropTile, &p, true)) return (int)cudaErrorInvalidValue;
  const int v[6] = {p.C, p.span, p.tq, p.resident, p.smem, p.work};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// How many of K7's tiled clusters the card holds at once (0: none); a
// negative cudaError_t on failure.
MMB_API int mmb_bidaf_tiled_forward_dropout_occupancy(int Tc, int Tq, int D) {
  WalkPlan p;
  if (!walk_plan(Tc, Tq, D, kDropTile, &p, true)) return -(int)cudaErrorInvalidValue;
  return bc::max_active_clusters(kernel_of<true>(p), cluster_of(p), kThreads, p.smem);
}

// K9's plan: out[6] = C, span, tq, resident, the dynamic shared memory of a
// block (bytes), the floats of device memory a block (0: none).
MMB_API int mmb_bidaf_tiled_plan(int Tc, int Tq, int D, int tq_blk, int* out) {
  WalkPlan p;
  if (!walk_plan(Tc, Tq, D, tq_blk, &p)) return (int)cudaErrorInvalidValue;
  const int v[6] = {p.C, p.span, p.tq, p.resident, p.smem, p.work};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// How many of K9's clusters the card holds at once for this shape (0: the
// launch cannot run); a negative cudaError_t on failure.
MMB_API int mmb_bidaf_tiled_forward_occupancy(int Tc, int Tq, int D, int tq_blk) {
  WalkPlan p;
  if (!walk_plan(Tc, Tq, D, tq_blk, &p)) return -(int)cudaErrorInvalidValue;
  return bc::max_active_clusters(kernel_of<false>(p), cluster_of(p), kThreads, p.smem);
}
