// intersect_blocklist: closest-hit (or any-hit) of padded ray tiles
// through per-tile candidate superblock lists, walked near to far with
// early exit.
//
// Replaces the Pallas kernel mitsuba_path_guiding_tpu/ops/
// intersect_blocklist.py _kernel (via _run_kernel): one program per tile of
// 256 rays; a while loop over the tile's candidate list; per superblock a
// per-(block, ray) AABB gate, reduced to a 32-bit block mask per 128-ray
// half tile; a dense 128 x 128 Moeller-Trumbore for each set bit.
//
// Bound: operations.  A (block, half tile) visit moves one block's rows
// (5 KB) and does 128 x 128 triangle tests of ~46 FP32 operations each.
//
// What a step computes.  The gates of a superblock are taken once, with
// each ray's best t from before the step, and ORed over each half tile
// (the block boxes carry no padding, so a per-ray gate would cull grazing
// hits that the half-tile mask lets through).  No test of the step depends
// on another: for closest hit the step's result for a ray is the least
// (t, block index, triangle id) over the blocks its half visits
// (pg_block_key), taken when its t is strictly below the best from before
// the step; for any-hit, the ray is occluded when a visited block holds a
// hit below its t, and the first such block (ascending) ends its count of
// needed tests.  Only the per-ray best and the early exit carry over from
// one step to the next.  So a step is one ordered reduction, whose visits
// can run in any order on any number of warps and CTAs.
//
// Design: a thread-block cluster per tile (C CTAs of 512 threads, C a power
// of two up to 16, chosen at launch so that the grid fills the card: 16 for
// a 7-tile call, 4 for 103 tiles, 1 for the 512-tile waves of the sorted
// route).  Each CTA holds a replica of the tile's per-ray best t and
// computes every gate of the step itself, so all CTAs agree on the visits
// without exchanging them.  The step's (visit, triangle slice) units (1 to
// 8 slices of a block, as many as the cluster's 4C groups of 128 threads
// need to be busy) go round-robin to the groups; a thread owns one ray
// lane of the unit's half tile and tests the slice's triangles from shared
// memory, four at a time.  Each group stages its next unit's rows with
// cp.async into the other half of a two-slot ring while it tests the
// current one, with named barriers of its 128 threads only; the next
// step's boxes and the tile's candidate list are staged ahead too.  Every
// thread keeps its own least key per half and folds it into its CTA's
// buffer with a shared-memory atomicMin; one cluster barrier ends the
// step, and every CTA then reads the C buffers (distributed shared memory)
// and updates its replica; the thread whose key won keeps its u, v for the
// end.  (A 64-bit atomicMin into the leader's shared memory instead lost
// values on the H100; the 32-bit atomics that carry the first hit block and
// the real-triangle counts to the leader hold.)  The merge buffers form
// rings of three steps, so each is cleared two steps ahead and no second
// barrier is needed.  The work counts come from the per-ray own-gate bits
// and the merged first hit, once per step.
// A cluster, rather than a persistent grid with a grid-wide barrier, keeps
// tiles independent: each walks its own number of steps (early exit), its
// barrier is the hardware's cluster barrier, and a many-tile call simply
// takes clusters of one.
//
// Build: ops/build.py, nvcc -fmad=false, so the arithmetic is that of
// ops/intersect_blocklist.py blocklist_plain.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

namespace cg = cooperative_groups;

#define RAY_TILE 256
#define SUB_TILE 128
#define SB_BLOCKS 32
#define BLOCK_TRIS 128
#define THREADS 512
#define GROUPS (THREADS / SUB_TILE)
#define GATE_SPLIT (THREADS / RAY_TILE)  // threads per ray in the gate phase
#define MAX_CLUSTER 16
#define MAX_SLICE_LOG 3
#define TRI_ROWS 10
#define STAGE_FLOATS (TRI_ROWS * BLOCK_TRIS)
#define DYN_SMEM (GROUPS * 2 * STAGE_FLOATS * 4)
#define INF_T 3.0e38f
#define INF_HI 0x7F80
#define NO_BLOCK 32
#define MAX_LIST 128  // the widest candidate list (ops/intersect_blocklist.py MAX_CAND)

typedef unsigned long long u64;

struct __align__(16) Shared {
  float ray[6][RAY_TILE];        // o, d of the tile's rays
  float box[2][SB_BLOCKS][8];    // this step's block boxes and the next step's
  float cur[2][RAY_TILE];        // best t before the step / after it (replica)
  float prim[RAY_TILE];
  u64 taken[RAY_TILE];           // the key of the best hit so far (replica)
  u64 win_key[RAY_TILE];         // the key this CTA last won with, and its u, v
  float win_u[RAY_TILE];
  float win_v[RAY_TILE];
  unsigned own[GATE_SPLIT][RAY_TILE];  // own-gate bits, by block range
  unsigned bits[2][2];           // half-tile OR of the gates, by step parity
  int worst[RAY_TILE / 32];
  int list[MAX_LIST];            // the tile's candidate list
  // merge buffers, rings of three steps: this CTA's least keys; the
  // leader's first hit blocks and real-triangle counts
  u64 key[3][RAY_TILE];
  int first[3][RAY_TILE];
  int real[3][SB_BLOCKS];
  int visits;
  int tests;
};

__device__ __forceinline__ float pg_gate_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(SUB_TILE) : "memory");
}

// the block of the step's visit vi: half 0's set bits, then half 1's
__device__ __forceinline__ int visit_block(int vi, int pop0, unsigned bits0, unsigned bits1,
                                           int* half) {
  const int s = vi >= pop0;
  unsigned m = s ? bits1 : bits0;
  for (int kk = s ? vi - pop0 : vi; kk > 0; --kk) m &= m - 1u;
  *half = s;
  return __ffs(m) - 1;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
blocklist_kernel(const int* __restrict__ cand, const int* __restrict__ cnt, int k,
                 const float* __restrict__ ray, const float* __restrict__ tmax, int npad,
                 const float* __restrict__ blk_box, const float* __restrict__ tri_pack,
                 int n_sb, float* __restrict__ out, int* __restrict__ work) {
  __shared__ Shared sh;
  extern __shared__ float4 dyn_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  Shared* lead = cluster.map_shared_rank(&sh, 0);
  const int tile = blockIdx.x / C;
  const int i = threadIdx.x;
  const int g = i / SUB_TILE, lane = i % SUB_TILE;
  float* ring = reinterpret_cast<float*>(dyn_smem) + g * 2 * STAGE_FLOATS;
  const int64_t base = (int64_t)tile * RAY_TILE;

  for (int e = i; e < 6 * RAY_TILE; e += THREADS)
    sh.ray[e / RAY_TILE][e % RAY_TILE] = ray[(int64_t)(e / RAY_TILE) * npad + base + e % RAY_TILE];
  // gate mapping: ray gr, blocks gb0 .. gb0 + SB_BLOCKS / GATE_SPLIT - 1
  const int gr = i % RAY_TILE, gh = i / RAY_TILE, gb0 = gh * (SB_BLOCKS / GATE_SPLIT);
  const float ox = ray[base + gr], oy = ray[npad + base + gr];
  const float oz = ray[2 * (int64_t)npad + base + gr];
  const float ix = pg_gate_inv(ray[3 * (int64_t)npad + base + gr]);
  const float iy = pg_gate_inv(ray[4 * (int64_t)npad + base + gr]);
  const float iz = pg_gate_inv(ray[5 * (int64_t)npad + base + gr]);
  if (i < RAY_TILE) {
    sh.cur[0][i] = fminf(tmax[base + i], INF_T);
    sh.prim[i] = -1.0f;
    sh.taken[i] = PG_KEY_MISS;
    sh.win_key[i] = PG_KEY_MISS;
    for (int r = 0; r < 3; ++r) {
      sh.key[r][i] = PG_KEY_MISS;
      sh.first[r][i] = NO_BLOCK;
    }
  }
  if (i < 3 * SB_BLOCKS) sh.real[i / SB_BLOCKS][i % SB_BLOCKS] = 0;
  if (i < 4) sh.bits[i / 2][i % 2] = 0u;
  if (i == 0) sh.visits = sh.tests = 0;

  const int cnt_raw = cnt[tile];
  const bool use_list = cnt_raw <= k;
  const int n_iter = use_list ? cnt_raw : n_sb;
  const int* list = cand + (int64_t)tile * k;
  if (use_list)
    for (int e = i; e < cnt_raw; e += THREADS) sh.list[e] = list[e];
  const float4* boxes = reinterpret_cast<const float4*>(blk_box);
  if (n_iter > 0 && i < SB_BLOCKS * 2) {
    const int sb0 = use_list ? (list[0] & 0xFFFF) : 0;
    reinterpret_cast<float4*>(&sh.box[0][0][0])[i] = boxes[(int64_t)sb0 * SB_BLOCKS * 2 + i];
  }
  cluster.sync();  // every CTA has started and initialised its buffers

  const int n_workers = C * GROUPS;
  const int worker = rank * GROUPS + g;
  int worst_hi = INF_HI;
  int j = 0;
  while (j < n_iter) {  // every condition below is uniform over the cluster
    const int key = sh.list[min(j, k - 1)];
    if ((use_list ? key >> 16 : 0) > worst_hi) break;
    const int sb = use_list ? (key & 0xFFFF) : j;
    const int par = j & 1, buf = j % 3;
    // the next step's boxes, in flight while this step runs
    const bool has_next = j + 1 < n_iter;
    float4 next_box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (has_next && i < SB_BLOCKS * 2) {
      const int sbn = use_list ? (sh.list[j + 1] & 0xFFFF) : j + 1;
      next_box = boxes[(int64_t)sbn * SB_BLOCKS * 2 + i];
    }

    // gates with the best t from before the step
    const float cur_g = sh.cur[par][gr];
    unsigned own = 0u;
#pragma unroll 4
    for (int bb = 0; bb < SB_BLOCKS / GATE_SPLIT; ++bb) {
      const float* bx = sh.box[par][gb0 + bb];
      const float tx0 = (bx[0] - ox) * ix, tx1 = (bx[3] - ox) * ix;
      const float ty0 = (bx[1] - oy) * iy, ty1 = (bx[4] - oy) * iy;
      const float tz0 = (bx[2] - oz) * iz, tz1 = (bx[5] - oz) * iz;
      const float tnr = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                              fmaxf(fminf(tz0, tz1), 0.0f));
      const float tfr = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
      if (tfr >= tnr && tnr <= cur_g) own |= 1u << (gb0 + bb);
    }
    sh.own[gh][gr] = own;
    const unsigned mine = __reduce_or_sync(0xffffffffu, own);
    if ((i & 31) == 0 && mine) atomicOr(&sh.bits[par][gr / SUB_TILE], mine);
    __syncthreads();
    const unsigned bits0 = sh.bits[par][0], bits1 = sh.bits[par][1];
    const int pop0 = __popc(bits0), n_visits = pop0 + __popc(bits1);
    if (i == 0) sh.bits[par ^ 1][0] = sh.bits[par ^ 1][1] = 0u;
    int q_log = 0;
    while (q_log < MAX_SLICE_LOG && (n_visits << q_log) < n_workers) ++q_log;
    const int width = BLOCK_TRIS >> q_log, n_units = n_visits << q_log;

    // this thread's least key (closest) or first hit block (any-hit), per half
    u64 k0 = PG_KEY_MISS, k1 = PG_KEY_MISS;
    float u0 = 0.0f, v0 = 0.0f, u1 = 0.0f, v1 = 0.0f;
    int f0 = NO_BLOCK, f1 = NO_BLOCK;
    auto stage = [&](int un, int slot) {
      int s;
      const int b = visit_block(un >> q_log, pop0, bits0, bits1, &s);
      const float* src = tri_pack + ((int64_t)sb * SB_BLOCKS + b) * 16 * BLOCK_TRIS +
                         (un & ((1 << q_log) - 1)) * width;
      float* dst = ring + slot * STAGE_FLOATS;
      const int per_row = width / 4;
      for (int c = lane; c < TRI_ROWS * per_row; c += SUB_TILE) {
        const int r = c / per_row, col = (c % per_row) * 4;
        __pipeline_memcpy_async(dst + r * BLOCK_TRIS + col, src + r * BLOCK_TRIS + col, 16);
      }
    };
    int slot = 0;
    if (worker < n_units) stage(worker, 0);
    __pipeline_commit();
    for (int un = worker; un < n_units; un += n_workers) {
      if (un + n_workers < n_units) stage(un + n_workers, slot ^ 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
      group_sync(g);
      int s;
      const int b = visit_block(un >> q_log, pop0, bits0, bits1, &s);
      const float* tri = ring + slot * STAGE_FLOATS;
      // the block's real triangles, counted by the units of one half only
      if (s == 0 || !((bits0 >> b) & 1u)) {
        const unsigned m = __ballot_sync(0xffffffffu,
                                         lane < width && tri[9 * BLOCK_TRIS + lane] >= 0.0f);
        if ((lane & 31) == 0 && m) atomicAdd(&lead->real[buf][b], __popc(m));
      }
      const int r = s * SUB_TILE + lane;
      const float rox = sh.ray[0][r], roy = sh.ray[1][r], roz = sh.ray[2][r];
      const float rdx = sh.ray[3][r], rdy = sh.ray[4][r], rdz = sh.ray[5][r];
      if (ANY_HIT) {
        const float cb = sh.cur[par][r];
        int f = s ? f1 : f0;
#pragma unroll 4
        for (int q = 0; q < width && b < f; ++q) {
          if (tri[9 * BLOCK_TRIS + q] < 0.0f) continue;  // padding: uniform over the group
          float t, u, v;
          if (pg_mt_test(tri[q], tri[BLOCK_TRIS + q], tri[2 * BLOCK_TRIS + q],
                         tri[3 * BLOCK_TRIS + q], tri[4 * BLOCK_TRIS + q],
                         tri[5 * BLOCK_TRIS + q], tri[6 * BLOCK_TRIS + q],
                         tri[7 * BLOCK_TRIS + q], tri[8 * BLOCK_TRIS + q], rox, roy, roz, rdx,
                         rdy, rdz, &t, &u, &v) &&
              t < cb)
            f = b;
        }
        if (s) f1 = f; else f0 = f;
      } else {
        u64 kb = s ? k1 : k0;
        float ub = s ? u1 : u0, vb = s ? v1 : v0;
#pragma unroll 4
        for (int q = 0; q < width; ++q) {
          const float tid = tri[9 * BLOCK_TRIS + q];
          if (tid < 0.0f) continue;  // padding: uniform over the group
          float t, u, v;
          if (pg_mt_test(tri[q], tri[BLOCK_TRIS + q], tri[2 * BLOCK_TRIS + q],
                         tri[3 * BLOCK_TRIS + q], tri[4 * BLOCK_TRIS + q],
                         tri[5 * BLOCK_TRIS + q], tri[6 * BLOCK_TRIS + q],
                         tri[7 * BLOCK_TRIS + q], tri[8 * BLOCK_TRIS + q], rox, roy, roz, rdx,
                         rdy, rdz, &t, &u, &v)) {
            const u64 kq = pg_block_key(t, (uint32_t)b, (uint32_t)tid);
            if (kq < kb) {
              kb = kq;
              ub = u;
              vb = v;
            }
          }
        }
        if (s) {
          k1 = kb; u1 = ub; v1 = vb;
        } else {
          k0 = kb; u0 = ub; v0 = vb;
        }
      }
      group_sync(g);  // the slot is free for the unit after next
      slot ^= 1;
    }
    if (ANY_HIT) {
      if (f0 < NO_BLOCK) atomicMin(&lead->first[buf][lane], f0);
      if (f1 < NO_BLOCK) atomicMin(&lead->first[buf][SUB_TILE + lane], f1);
    } else {
      if (k0 != PG_KEY_MISS) atomicMin(&sh.key[buf][lane], k0);
      if (k1 != PG_KEY_MISS) atomicMin(&sh.key[buf][SUB_TILE + lane], k1);
    }
    cluster.sync();  // the step's reduction is complete in the leader

    if (i < RAY_TILE) {
      const float c0 = sh.cur[par][i];
      float c = c0;
      int last = SB_BLOCKS - 1;  // the last block whose tests count
      if (ANY_HIT) {
        const int f = lead->first[buf][i];
        if (f < NO_BLOCK) {
          c = -1.0f;
          sh.prim[i] = 1.0f;
          last = f;
        }
      } else {
        u64 m = PG_KEY_MISS;
        for (int c0 = 0; c0 < C; c0 += 4) {  // four reads in flight at a time
          u64 mc[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mc[c] = c0 + c < C ? cluster.map_shared_rank(&sh, c0 + c)->key[buf][i] : PG_KEY_MISS;
#pragma unroll
          for (int c = 0; c < 4; ++c) m = mc[c] < m ? mc[c] : m;
        }
        const float tm = pg_key_t(m);
        if (tm < c0) {
          c = tm;
          sh.prim[i] = (float)pg_key_tid(m);
          sh.taken[i] = m;
        }
      }
      sh.cur[par ^ 1][i] = c;
      sh.key[(j + 2) % 3][i] = PG_KEY_MISS;  // last read two steps ago, next written two ahead
      const int hi = __reduce_max_sync(0xffffffffu, __float_as_int(c) >> 16);
      if ((i & 31) == 0) sh.worst[i / 32] = hi;
      if (rank == 0) {
        int tests = 0;
        if (c0 > PG_EPS_T) {
          unsigned bm = 0u;
#pragma unroll
          for (int h = 0; h < GATE_SPLIT; ++h) bm |= sh.own[h][i];
          bm &= (2u << last) - 1u;
          while (bm) {
            tests += sh.real[buf][__ffs(bm) - 1];
            bm &= bm - 1u;
          }
        }
        tests = __reduce_add_sync(0xffffffffu, tests);
        if ((i & 31) == 0 && tests) atomicAdd(&sh.tests, tests);
        const int clear = (j + 2) % 3;  // last read two steps ago, next written two ahead
        sh.first[clear][i] = NO_BLOCK;
        if (i < SB_BLOCKS) sh.real[clear][i] = 0;
        if (i == 0) sh.visits += n_visits;
      }
    }
    if (has_next && i < SB_BLOCKS * 2) reinterpret_cast<float4*>(&sh.box[par ^ 1][0][0])[i] = next_box;
    __syncthreads();
    if (!ANY_HIT) {  // the thread whose key won keeps its u, v (+0 as the plain version's sum)
      if (k0 != PG_KEY_MISS && sh.taken[lane] == k0) {
        sh.win_key[lane] = k0;
        sh.win_u[lane] = u0 + 0.0f;
        sh.win_v[lane] = v0 + 0.0f;
      }
      if (k1 != PG_KEY_MISS && sh.taken[SUB_TILE + lane] == k1) {
        sh.win_key[SUB_TILE + lane] = k1;
        sh.win_u[SUB_TILE + lane] = u1 + 0.0f;
        sh.win_v[SUB_TILE + lane] = v1 + 0.0f;
      }
    }
    worst_hi = sh.worst[0];
#pragma unroll
    for (int w = 1; w < RAY_TILE / 32; ++w) worst_hi = max(worst_hi, sh.worst[w]);
    ++j;
  }
  cluster.sync();  // no CTA leaves while another may read the leader's buffers

  if (i < RAY_TILE) {
    const int64_t n = base + i;
    const bool hit = !ANY_HIT && sh.taken[i] != PG_KEY_MISS;
    if (rank == 0) {
      out[n] = sh.cur[j & 1][i];
      out[npad + n] = sh.prim[i];
      if (!hit) {
        out[2 * (int64_t)npad + n] = 0.0f;
        out[3 * (int64_t)npad + n] = 0.0f;
      }
    }
    if (hit && sh.win_key[i] == sh.taken[i]) {
      out[2 * (int64_t)npad + n] = sh.win_u[i];
      out[3 * (int64_t)npad + n] = sh.win_v[i];
    }
  }
  if (rank == 0 && i == 0) {
    work[3 * tile] = j;
    work[3 * tile + 1] = sh.visits;
    work[3 * tile + 2] = sh.tests;
  }
}

// Launch geometry: clusters of C CTAs per tile, C the largest power of two
// (at most 16, or what the card schedules) such that nt * C CTAs are at
// most twice what the card holds at once (measured on the H100: 16 for 7
// tiles, 4 for 103, 1 for 512 and 2048; larger clusters repeat the gates
// in more CTAs and queue behind each other).
template <bool ANY_HIT>
static int cluster_size(int nt, int* out_cluster) {
  static int dev_seen = -1, capacity = 0, max_cluster = 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != dev_seen) {
    auto kern = blocklist_kernel<ANY_HIT>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM);
    if (err != cudaSuccess) return (int)err;
    const bool non_portable =
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
        cudaSuccess;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, DYN_SMEM);
    if (err != cudaSuccess) return (int)err;
    max_cluster = 1;
    for (int c = 2; c <= (non_portable ? MAX_CLUSTER : 8); c *= 2) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = c;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(c);
      cfg.blockDim = dim3(THREADS);
      cfg.dynamicSmemBytes = DYN_SMEM;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int n_clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&n_clusters, kern, &cfg) != cudaSuccess ||
          n_clusters < 1)
        break;
      max_cluster = c;
    }
    (void)cudaGetLastError();  // a refused cluster size is not an error of the launch
    capacity = sms * per_sm;
    dev_seen = dev;
  }
  int c = 1;
  while (c < max_cluster && (int64_t)nt * c * 2 <= 2 * (int64_t)capacity) c *= 2;
  *out_cluster = c;
  return 0;
}

// C entry points: (cand (nt, k) int32 with k <= 128, cnt (nt,) int32, k, ray (6, npad)
// rows o, d, tmax (npad,), npad, blk_box (S, 32, 8), tri_pack
// (S, 32, 16, 128), S, out (4, npad) rows t, prim, u, v, work (nt, 3)
// int32, stream) -> cudaError_t.
template <bool ANY_HIT>
static int blocklist_launch(const void* cand, const void* cnt, int k, const void* ray,
                            const void* tmax, int npad, const void* blk_box,
                            const void* tri_pack, int n_sb, void* out, void* work,
                            void* stream) {
  const int nt = npad / RAY_TILE;
  if (nt == 0) return 0;
  int c = 1;
  const int err = cluster_size<ANY_HIT>(nt, &c);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(nt * c);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = DYN_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, blocklist_kernel<ANY_HIT>, (const int*)cand, (const int*)cnt, k,
                     (const float*)ray, (const float*)tmax, npad, (const float*)blk_box,
                     (const float*)tri_pack, n_sb, (float*)out, (int*)work);
  return (int)cudaGetLastError();
}

extern "C" int blocklist_closest(const void* cand, const void* cnt, int k, const void* ray,
                                 const void* tmax, int npad, const void* blk_box,
                                 const void* tri_pack, int n_sb, void* out, void* work,
                                 void* stream) {
  return blocklist_launch<false>(cand, cnt, k, ray, tmax, npad, blk_box, tri_pack, n_sb, out,
                                 work, stream);
}

extern "C" int blocklist_any(const void* cand, const void* cnt, int k, const void* ray,
                             const void* tmax, int npad, const void* blk_box,
                             const void* tri_pack, int n_sb, void* out, void* work,
                             void* stream) {
  return blocklist_launch<true>(cand, cnt, k, ray, tmax, npad, blk_box, tri_pack, n_sb, out,
                                work, stream);
}

// The geometry a call of npad rays launches with: out[0] CTAs, out[1]
// threads per CTA, out[2] cluster size, out[3] shared memory per CTA
// (static and dynamic bytes).  Returns a cudaError_t.
extern "C" int blocklist_geometry(int npad, int any_hit, int* out) {
  const int nt = npad / RAY_TILE;
  int c = 1;
  int err = any_hit ? cluster_size<true>(nt, &c) : cluster_size<false>(nt, &c);
  if (err) return err;
  cudaFuncAttributes fa;
  err = any_hit ? (int)cudaFuncGetAttributes(&fa, blocklist_kernel<true>)
                : (int)cudaFuncGetAttributes(&fa, blocklist_kernel<false>);
  if (err) return err;
  out[0] = nt * c;
  out[1] = THREADS;
  out[2] = c;
  out[3] = (int)fa.sharedSizeBytes + DYN_SMEM;
  return 0;
}
