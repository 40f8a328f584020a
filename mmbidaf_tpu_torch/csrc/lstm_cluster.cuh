// What the cluster bodies of K1 and K5 (csrc/lstm.cu) and K6
// (csrc/lstm_bwd.cu) share: the layout of W_h over a thread-block cluster, the host-side plan
// that sizes it, the exchange between the blocks of a cluster through
// distributed shared memory, and the launch.
//
// Layout. One cluster of C blocks serves one group of R rows in one
// direction. Block c owns the hidden units [unit_begin(c), unit_begin(c+1))
// (H split as evenly as the integers allow: slices differ by at most one
// unit, none is empty while C <= H) and all four gate columns of those units
// (u, H+u, 2H+u, 3H+u). It keeps W_h[:, those columns] in shared memory for
// the whole kernel as a [H][4U + 1] array, U = ceil(H / C) (column
// g·U + ul is gate g of unit unit_begin(c) + ul; the columns of a shorter
// slice past its units are zero). The odd row stride keeps both products
// conflict-free: K5 reads it with neighbouring threads on neighbouring
// columns, K6 with neighbouring threads on neighbouring rows.
//
// Exchange. Each step, every block pushes what the others need into their
// shared memory (cluster.map_shared_rank, remote stores), into a buffer of
// the step's parity, then the cluster passes one barrier
// (barrier.cluster.arrive.release / wait.acquire). A buffer of parity p is
// written again only two steps later, by a block that has passed the
// barrier which its readers reach after reading it, so one barrier a step
// suffices.
//
// Plan. R = 16 rows a cluster from 512 rows, 8 from 128, else 4; C the
// smallest power of two that gives U <= 16 units a block, raised further
// until the larger of the two kernels' shared memory fits a block's 227 KB;
// past C = 16 there is no plan, and K1, K5 and K6 serve the shape by their
// L2 routes (one plan for the three kernels: one layout, one rule).
// ops/cuda/lstm_kernel.py::cluster_plan mirrors this function.
//
// The L2 routes (l2_rows below; lstm.cu bilstm_kernel<R, kTrain> for K1 and
// K5, lstm_bwd.cu bilstm_bptt_l2_kernel<R> for K6's walk) take the widths
// with no cluster plan: one block a group of R rows in one direction, W_h
// read from L2 every step. ops/cuda/lstm_kernel.py::l2_rows mirrors it.
// K6's walk has a third body for those widths at few rows, the grid walk
// (grid_plan below), and its own rule, bptt_route.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace mmb {
namespace lstmc {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // threads a block
constexpr int kRC = 4;         // rows one thread of a product keeps (one float4)
constexpr int kMaxCluster = 16;
constexpr int kTargetUnits = 16;

struct Plan {
  int C;       // blocks a cluster
  int R;       // rows a cluster
  int U;       // units of the largest slice
  int groups;  // clusters a direction: ceil(B / R)
  int smem_fwd, smem_bwd;  // dynamic shared memory of a block, bytes
};

__host__ __device__ inline int units_max(int H, int C) { return (H + C - 1) / C; }
__host__ __device__ inline int unit_begin(int c, int H, int C) { return c * H / C; }

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// K1's and K5's block: hbuf [2][H][R] | W [H][4U+1] | z [R][4U] | gates stage
// [2][R][4U] | c [R][U] | mask stage [2][R], each section a multiple of
// four floats (16-byte aligned).
inline size_t smem_fwd(int H, int C, int R) {
  const size_t U = units_max(H, C), G4 = 4 * U;
  return 4 * (round4(2 * (size_t)H * R) + round4((size_t)H * (G4 + 1)) + round4(R * G4) +
              round4(2 * R * G4) + round4(R * U) + round4(2 * (size_t)R));
}

// K6's walk: dz [4U][R] | W [H][4U+1] | xbuf [2][C][U][R] | dh [R][U] |
// dc [R][U] | z stage [2][R][4U] | c_prev stage [2][R][U] | dout stage
// [2][R][U] | mask stage [2][R].
inline size_t smem_bwd(int H, int C, int R) {
  const size_t U = units_max(H, C), G4 = 4 * U;
  return 4 * (round4(G4 * R) + round4((size_t)H * (G4 + 1)) + round4(2 * (size_t)C * U * R) +
              2 * round4(R * U) + round4(2 * R * G4) + 2 * round4(2 * R * U) +
              round4(2 * (size_t)R));
}

// The plan for B rows of width H; false if no cluster of <= 16 blocks can
// hold W_h's slice (or the shape is empty).
inline bool plan(int B, int H, Plan* p) {
  if (B <= 0 || H <= 0) return false;
  const int R = B >= 512 ? 16 : B >= 128 ? 8 : 4;
  int C = 1;
  while (C < kMaxCluster && units_max(H, C) > kTargetUnits) C *= 2;
  while (C <= kMaxCluster && (smem_fwd(H, C, R) > (size_t)kMaxSmemBytes ||
                              smem_bwd(H, C, R) > (size_t)kMaxSmemBytes))
    C *= 2;
  if (C > kMaxCluster || C > H) return false;
  *p = {C, R, units_max(H, C), (B + R - 1) / R, (int)smem_fwd(H, C, R), (int)smem_bwd(H, C, R)};
  return true;
}

// The L2 routes' block: R rows of the carried state and the step's gate
// columns, [h | c | z] forward and [dh | dc | dz] in K6's walk, 6H floats a
// row.
inline size_t l2_smem(int H, int R) { return 4 * (size_t)R * 6 * H; }

// The L2 routes' rows a block: 16 from 1024 rows (each W_h read serves 16
// rows, and 2·B/16 >= 128 blocks still fill the card), else 4 (more
// blocks); halved while the block does not fit its shared memory. 0 where
// not even one row fits (H past 9,685) or the shape is empty.
inline int l2_rows(int B, int H) {
  if (B <= 0 || H <= 0) return 0;
  for (int R = B >= 1024 ? 16 : 4; R >= 1; R /= 2)
    if (l2_smem(H, R) <= (size_t)kMaxSmemBytes) return R;
  return 0;
}

// K6's grid walk (lstm_bwd.cu bilstm_bptt_cluster_kernel_grid<UT>), for the
// widths with no cluster plan at few rows, where the L2 walk would run on
// 2·ceil(rows / l2_rows) blocks of the card's 132 SMs. Per direction P
// blocks, one an SM, in clusters of CS = 8; block b owns the units
// [unit_begin(b, H, P), unit_begin(b+1, H, P)) for every row and keeps the
// four gate columns of W_h of them in registers (two rows k of W_h a
// thread; UT units a block, 8, 10 or 12, the fewest that hold the slice),
// so W_h is read from device memory once a launch. Rows a block: all of
// them, padded to row groups of 8. A step's partial dz·W_hᵀ [rows x H] of a
// block is summed first over its cluster (rank c sums the outputs
// [unit_begin(c, H, CS), unit_begin(c+1, H, CS))), then over the clusters
// through an exchange in device memory whose words carry the step that
// wrote them. The shape rule takes P = 64; a card that cannot hold the 2·P/CS
// clusters at once runs the plan at fewer (lstm_bwd.cu grid_plan_on_card).
// ops/cuda/lstm_kernel.py::grid_plan mirrors grid_plan.
constexpr int kGridBlocks = 64;   // blocks a direction: 128 of the card's SMs
constexpr int kGridCluster = 8;   // blocks a cluster (the portable size)
constexpr int kGridMaxRows = 64;  // past it the L2 walk has 32 blocks or more
constexpr int kGridRowGroup = 8;  // rows of a thread's product tile
constexpr int kGridPairs = 2;     // (unit, row) pairs of the gate math a thread, at most

struct GridPlan {
  int P, CS, NQ;  // blocks a direction, blocks a cluster, clusters a direction
  int U, UT;      // units of the largest slice; the instance's units a block
  int Rp, KC;     // rows padded to kGridRowGroup; outputs of a rank's chunk
  int threads;    // two rows k of W_h and up to kGridPairs (unit, row) pairs a thread
  int smem;       // dynamic shared memory a block, bytes (over half an SM's: one block an SM)
  int work;       // 4-byte words of the exchange in device memory
};

// K6's grid walk block: dz [4UT][Rp] | received partials [CS][KC][Rp] | dh
// [UT][Rp] | dc [UT][Rp] | z stage [2][4UT][Rp] | c_prev stage [2][UT][Rp]
// | dout stage [2][UT][Rp] | mask stage [2][Rp]; every section a multiple of
// eight floats.
inline size_t grid_smem(int UT, int CS, int KC, int Rp) {
  return 4 * (size_t)Rp * (3 * 4 * UT + (size_t)CS * KC + 6 * UT + 2);
}

// The grid walk's plan for B rows of width H at P blocks a direction; false
// where a block's slice of W_h needs more than 12 units, the rows exceed
// kGridMaxRows or the block does not fit.
inline bool grid_plan(int B, int H, int P, GridPlan* g) {
  const int CS = kGridCluster;
  if (B <= 0 || H <= 0 || B > kGridMaxRows || P <= 0 || P % CS || P > H) return false;
  const int U = units_max(H, P), UT = U <= 8 ? 8 : U <= 10 ? 10 : U <= 12 ? 12 : 0;
  if (UT == 0) return false;
  const int Rp = (B + kGridRowGroup - 1) / kGridRowGroup * kGridRowGroup, KC = units_max(H, CS);
  const int pair_warps = (UT * Rp + 32 * kGridPairs - 1) / (32 * kGridPairs);
  const int threads = 32 * ((H + 63) / 64 > pair_warps ? (H + 63) / 64 : pair_warps);
  const size_t smem = grid_smem(UT, CS, KC, Rp);
  if (threads > 32 * UT || smem > (size_t)kMaxSmemBytes) return false;
  const int NQ = P / CS;
  *g = {P, CS, NQ, U, UT, Rp, KC, threads,
        (int)(smem > (size_t)kMaxSmemBytes / 2 ? smem : (size_t)kMaxSmemBytes / 2 + 16),
        8 * NQ * H * Rp};
  return true;
}

// K6's walk: which body takes B rows of width H (by the shape alone).
enum BpttRoute { kRouteNone = 0, kRouteCluster = 1, kRouteGrid = 2, kRouteL2 = 3 };

inline int bptt_route(int B, int H) {
  Plan p;
  GridPlan g;
  if (plan(B, H, &p)) return kRouteCluster;
  if (grid_plan(B, H, kGridBlocks, &g)) return kRouteGrid;
  return l2_rows(B, H) ? kRouteL2 : kRouteNone;
}

// The launch configuration of a plan: grid (C, groups, 2 directions),
// clusters of C blocks along x (so a block's rank is blockIdx.x).
struct LaunchConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

template <typename Kernel>
cudaError_t configure(Kernel kernel, const Plan& p, int smem, cudaStream_t stream,
                      LaunchConfig* lc) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && p.C > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  lc->cfg = cudaLaunchConfig_t{};
  lc->cfg.gridDim = dim3(p.C, p.groups, 2);
  lc->cfg.blockDim = dim3(kThreads);
  lc->cfg.dynamicSmemBytes = smem;
  lc->cfg.stream = stream;
  lc->attr[0].id = cudaLaunchAttributeClusterDimension;
  lc->attr[0].val.clusterDim.x = p.C;
  lc->attr[0].val.clusterDim.y = 1;
  lc->attr[0].val.clusterDim.z = 1;
  lc->cfg.attrs = lc->attr;
  lc->cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of this plan the card can hold at once (0: none, the
// launch would fail); a negative cudaError_t on failure.
template <typename Kernel>
int max_active_clusters(Kernel kernel, const Plan& p, int smem) {
  LaunchConfig lc;
  cudaError_t e = configure(kernel, p, smem, nullptr, &lc);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &lc.cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Plan& p, int smem, cudaStream_t stream, Args... args) {
  LaunchConfig lc;
  cudaError_t e = configure(kernel, p, smem, stream, &lc);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&lc.cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// W_h[dir][:, this block's gate columns] -> w_s [H][4U+1]; zero past the
// slice's nu units.
__device__ __forceinline__ void load_w_slice(float* w_s, const float* __restrict__ wh, int H,
                                             int U, int u0, int nu) {
  const int G4 = 4 * U, ldw = G4 + 1;
  for (int e = threadIdx.x; e < H * G4; e += blockDim.x) {
    const int k = e / G4, jl = e - k * G4;
    const int g = jl / U, ul = jl - g * U;
    w_s[k * ldw + jl] = ul < nu ? wh[(size_t)k * 4 * H + (size_t)g * H + u0 + ul] : 0.0f;
  }
}

// The block of the cluster that owns unit k.
__device__ __forceinline__ int owner_of(int k, int H, int C) {
  int c = k * C / H;
  while (c + 1 < C && unit_begin(c + 1, H, C) <= k) ++c;
  while (unit_begin(c, H, C) > k) --c;
  return c;
}

using mmb::cp_async4;
using mmb::cp_async_wait_all;

}  // namespace lstmc
}  // namespace mmb
