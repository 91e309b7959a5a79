// intersect_pairs: the tile stage of the pair intersector.  Each tile of
// 128 sorted (ray, block) pairs holds real pairs of one block only (dummy
// sort entries separate the blocks); every pair is tested against the 128
// triangles of its tile's block and keeps its best (t, prim).
//
// Replaces the Pallas kernels of mitsuba_path_guiding_tpu/ops/
// intersect_pairs.py: _mt_pallas_kernel (via _mt_tiles_pallas, a dense
// 128 x 128 Moeller-Trumbore per tile on the VPU) and _plk_pallas_kernel
// (via _plk_tiles_pallas, the same test as one (16, 128)^T (16, 640) f32
// Pluecker matrix product on the MXU plus _plk_epilogue).
//
// Bound: operations.  A tile moves 128 pairs x 7 floats in and 2 out
// (4.6 KB) plus its block's rows, and does up to 128 x 128 triangle tests
// of ~46 (MT) or ~52 (Pluecker) FP32 operations: ~150 operations per byte,
// far above the card's ~10 FP32 operations per byte of HBM.  The bound
// counts the tests the data needs: pairs that can hit (tmax > EPS_T) times
// the real triangles of their block.
//
// MT design (pair_kernel<false, .>): one CTA of 4 warps per tile, and the
// issue slots go to the tests the data needs.
//   * A dead or dummy pair (tmax <= EPS_T) can find no hit: it writes
//     (INF, -1) at once, and the live pairs are compacted to the front of
//     the tile (one ballot per 32 pairs).  Lane l of every warp owns live
//     pairs l, l + 32, ... (up to 4), and the triangle loop runs for only
//     as many of those 32-pair slots as hold a live pair, so a wholly dead
//     group of 32 pairs costs nothing.
//   * Padding triangles (id -1) sit at a block's tail: the loop stops after
//     the last real one (a max over the staged ids).
//   * Each triangle is staged as one 48-byte record (p0, e1, e2, id, two
//     floats of padding; 3 STS.128, conflict-free) and read as 3 LDS.128
//     broadcasts, which feed the tests of all of a lane's pairs.
//   * Warp w tests triangles w, w + 4, ...: a quarter of the tile's tests,
//     so tiles of unequal cost spread evenly over the card; the four
//     partial winners of each pair merge in shared memory.
//   * The test runs in two stages (device_math.cuh pg_mt_u, pg_mt_vt): a
//     slot whose 32 pairs all fail 0 <= u <= 1 (a warp vote) skips v, t
//     and the winner update for that triangle; such a pair cannot hit.
// The winner is the least t and, among equal t, the least original
// triangle id (row 9), an order-free reduction, so skipping, splitting and
// compacting change no bit; any-hit keeps the least t too and writes +-1
// in row 1.
//
// Pluecker design (pair_kernel<true, .>): the same CTA, compaction, triangle
// split and merge as the MT kernel (one kernel template, pair_kernel), with
// the Pluecker test in place of MT.
//   * Each triangle's 25 coefficients (from tri_cols) and its id are staged
//     once as a 112-byte record (device_math.cuh pg_plk_record, 7 float4
//     written as STS.128, conflict-free) and read as 7 LDS.128 broadcasts.
//   * The test runs in two stages: pg_plucker_inside, the three edge sides,
//     and behind a warp vote pg_plucker_depth, the plane distance with its
//     IEEE division; a pair whose ray passes outside the triangle cannot
//     hit.  The closest-hit inside test keeps its PLK_EPS slack, any-hit
//     the exact one.
// The tests run in FP32 on the CUDA cores, summing in the plain version's
// order (pg_plucker_inside, pg_plucker_depth), not on the tensor cores,
// whose TF32 or bf16 inputs would drop hits.  Measured on the card
// (PERF.md section 6): without the vote 1.36x slower; at most 64 registers
// (__launch_bounds__(128, 8)) 8% slower.
//
// bf16 MT design (pair_kernel<false, false, __nv_bfloat16>, closest hit
// only): the reference's PAIR_DATA_BF16 path of _mt_pallas_kernel (its
// `loose` build, the pair rows gathered as bfloat16 and the inside tests
// widened by BF16_SLACK).  The same CTA, compaction, triangle split and
// merge as the f32 kernel; each pair row is read as __nv_bfloat16 and
// upcast on load (exact).  The loose test (device_math.cuh pg_mt_u_loose,
// pg_mt_vt_loose) takes its float32 constants from the wrapper
// (ops/intersect_pairs.py loose_bounds), which gives the same ones to the
// plain version: u, v >= -s, u + v <= 1 + s, t > EPS_T (1 - s), t below
// t_hi = tmax (1 + s), rounded once as the plain version rounds it.  A
// pair is dead when t_hi <= EPS_T (1 - s): no t lies between.  The first
// stage keeps -s <= u <= u_hi, wide enough never to drop a pair the whole
// test admits (the proof is at pg_mt_u_loose); the f32 kernel's
// division-free reject does not carry over.  Bound: operations, as the f32
// kernel; the pair rows move 7 x 2 bytes a pair instead of 7 x 4.
//
// An inert tile (tile_block < 0: dummies or the sort's tail) writes
// (INF, -1) and returns before touching the table.
//
// Build: ops/build.py, nvcc -fmad=false (no contraction), so the tests
// agree bit for bit with ops/intersect_pairs.py mt_tiles_plain /
// plk_tiles_plain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_math.cuh"

#define PAIR_TILE 128
#define LEAF PG_PAIR_LEAF
#define PLK_COLS (5 * LEAF)
#define INF_T 3.0e38f
#define NO_ID 2.0e9f
#define FULL 0xffffffffu
#define WARPS (PAIR_TILE / 32)  // warps of a tile's CTA, each with a share of the triangles
#define SLOTS (PAIR_TILE / 32)  // 32-pair slots of a tile: live pairs a lane owns at most

// the float32 constants of the loose test (bf16 pair data); unused by the
// f32 kernels
struct PgLoose {
  float neg, one, eps_lo, u_hi;
};

__device__ __forceinline__ float pg_ld(const float* p) { return *p; }
__device__ __forceinline__ float pg_ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void pg_take(bool hit, float t, float tid, float* bt, float* bid) {
  if (hit && pg_nearer(t, tid, *bt, *bid)) {
    *bt = t;
    *bid = tid;
  }
}

template <bool ANY_HIT>
__device__ __forceinline__ void pg_pair_out(float* out, int64_t P, int64_t p, float bt, float bid) {
  const bool hit = bt < INF_T;
  out[p] = bt;
  out[P + p] = ANY_HIT ? (hit ? 1.0f : -1.0f) : (hit ? bid : -1.0f);
}

// one warp's share of a tile: the live pairs of slots 0..S-1 (lane l,
// slot s: live pair 32 s + l) against the staged triangles k = warp,
// warp + WARPS, ... below n_tri; the best (t, id) of each slot and lane
// goes to best[warp][s][lane].  PD: float, or __nv_bfloat16 for the loose
// test of bf16 pair data.
template <int S, typename PD>
__device__ __forceinline__ void mt_slots(const float4* __restrict__ rec, int n_tri,
                                         const int* live, int n_live,
                                         const PD* __restrict__ pd, int64_t P, int64_t base,
                                         PgLoose lz, float2* best) {
  constexpr bool LOOSE = std::is_same<PD, __nv_bfloat16>::value;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ox[S], oy[S], oz[S], dx[S], dy[S], dz[S], tmax[S], bt[S], bid[S];
  bool has[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = 32 * s + lane;
    has[s] = j < n_live;
    const int64_t p = base + (has[s] ? live[j] : 0);
    ox[s] = pg_ld(pd + p);
    oy[s] = pg_ld(pd + P + p);
    oz[s] = pg_ld(pd + 2 * P + p);
    dx[s] = pg_ld(pd + 3 * P + p);
    dy[s] = pg_ld(pd + 4 * P + p);
    dz[s] = pg_ld(pd + 5 * P + p);
    tmax[s] = pg_ld(pd + 6 * P + p);
    if constexpr (LOOSE) tmax[s] = tmax[s] * lz.one;  // t_hi
    bt[s] = INF_T;
    bid[s] = NO_ID;
  }
  for (int k = warp; k < n_tri; k += WARPS) {
    const float4 a = rec[3 * k], b = rec[3 * k + 1], c = rec[3 * k + 2];
    // a: p0 e1x, b: e1y e1z e2x e2y, c: e2z id - -
    float tv[S][3], inv[S], u[S];
    bool may[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if constexpr (LOOSE) {
        may[s] = pg_mt_u_loose(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox[s], oy[s], oz[s],
                               dx[s], dy[s], dz[s], lz.neg, lz.u_hi, tv[s], &inv[s], &u[s]) &&
                 has[s];
      } else {
        may[s] = pg_mt_u(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox[s], oy[s], oz[s], dx[s],
                         dy[s], dz[s], tv[s], &inv[s], &u[s]) && has[s];
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (__any_sync(FULL, may[s])) {
        float t;
        bool hit;
        if constexpr (LOOSE) {
          hit = pg_mt_vt_loose(a.w, b.x, b.y, b.z, b.w, c.x, dx[s], dy[s], dz[s], tv[s], inv[s],
                               u[s], lz.neg, lz.one, lz.eps_lo, &t);
        } else {
          float v;
          hit = pg_mt_vt(a.w, b.x, b.y, b.z, b.w, c.x, dx[s], dy[s], dz[s], tv[s], inv[s], u[s],
                         &t, &v);
        }
        pg_take(may[s] && hit && t < tmax[s] && c.y >= 0.0f, t, c.y, &bt[s], &bid[s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) best[(warp * SLOTS + s) * 32 + lane] = make_float2(bt[s], bid[s]);
}

// one warp's share of a Pluecker tile, as mt_slots: live pair 32 s + lane
// of slot s against the staged records k = warp, warp + WARPS, ...
template <int S, bool ANY_HIT>
__device__ __forceinline__ void plk_slots(const float4* __restrict__ rec, int n_tri,
                                          const int* live, int n_live,
                                          const float* __restrict__ pd, int64_t P, int64_t base,
                                          float2* best) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float o[S][3], d[S][3], m[S][3], tmax[S], bt[S], bid[S];
  bool has[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = 32 * s + lane;
    has[s] = j < n_live;
    const int64_t p = base + (has[s] ? live[j] : 0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[s][a] = pd[a * P + p];
      d[s][a] = pd[(3 + a) * P + p];
    }
    tmax[s] = pd[6 * P + p];
    m[s][0] = o[s][1] * d[s][2] - o[s][2] * d[s][1];
    m[s][1] = o[s][2] * d[s][0] - o[s][0] * d[s][2];
    m[s][2] = o[s][0] * d[s][1] - o[s][1] * d[s][0];
    bt[s] = INF_T;
    bid[s] = NO_ID;
  }
  for (int k = warp; k < n_tri; k += WARPS) {
    float c[28];  // coefficients 0:25, the id at 25
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const float4 w = rec[7 * k + q];
      c[4 * q] = w.x;
      c[4 * q + 1] = w.y;
      c[4 * q + 2] = w.z;
      c[4 * q + 3] = w.w;
    }
    bool in[S];
#pragma unroll
    for (int s = 0; s < S; ++s) in[s] = pg_plucker_inside(c, d[s], m[s], ANY_HIT) && has[s];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (__any_sync(FULL, in[s])) {
        float t;
        const bool hit = pg_plucker_depth(c, o[s], d[s], tmax[s], &t);
        pg_take(in[s] && hit && c[25] >= 0.0f, t, c[25], &bt[s], &bid[s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) best[(warp * SLOTS + s) * 32 + lane] = make_float2(bt[s], bid[s]);
}

template <bool PLK, bool ANY_HIT, int S, typename PD>
__device__ __forceinline__ void run_slots(const float4* rec, int n_tri, const int* live,
                                          int n_live, const PD* pd, int64_t P, int64_t base,
                                          PgLoose lz, float2* best) {
  if constexpr (PLK) {
    plk_slots<S, ANY_HIT>(rec, n_tri, live, n_live, pd, P, base, best);
  } else {
    mt_slots<S, PD>(rec, n_tri, live, n_live, pd, P, base, lz, best);
  }
}

// One CTA of 4 warps per tile, for both tests: PLK selects the table
// (tri_cols and tri_rows, or tri_rows alone), the record and the slot loop;
// PD the type of the pair rows (__nv_bfloat16: the loose MT test, lz).
template <bool PLK, bool ANY_HIT, typename PD = float>
__global__ void __launch_bounds__(PAIR_TILE)
pair_kernel(const float* __restrict__ table, const float* __restrict__ tri_rows, int n_blocks,
            const int* __restrict__ tile_block, const PD* __restrict__ pd,
            float* __restrict__ out, int64_t P, PgLoose lz) {
  constexpr bool LOOSE = std::is_same<PD, __nv_bfloat16>::value;
  static_assert(!LOOSE || (!PLK && !ANY_HIT), "bf16 pair data: MT closest hit only");
  constexpr int R = PLK ? 7 : 3;        // float4 words of a triangle's record
  __shared__ float4 rec[R * LEAF];      // MT: p0 e1 e2 id, 2 floats of padding; PLK: pg_plk_record
  __shared__ int live[PAIR_TILE];       // the tile's live pairs, in order
  __shared__ float2 best[WARPS * SLOTS * 32];  // each warp's best (t, id) per pair
  __shared__ int s_live[WARPS], s_last[WARPS];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int64_t base = (int64_t)blockIdx.x * PAIR_TILE;
  const int blk = tile_block[blockIdx.x];
  if (blk < 0) {  // uniform over the CTA
    pg_pair_out<ANY_HIT>(out, P, base + i, INF_T, NO_ID);
    return;
  }
  // thread i: pair i's liveness and triangle i's record
  bool is_live;
  if constexpr (LOOSE) {
    is_live = pg_ld(pd + 6 * P + base + i) * lz.one > lz.eps_lo;
  } else {
    is_live = pd[6 * P + base + i] > PG_EPS_T;
  }
  const unsigned m = __ballot_sync(FULL, is_live);
  const int64_t b = min(blk, n_blocks - 1);
  float r[4 * R];
  if constexpr (PLK) {
    pg_plk_record(table + b * 16 * PLK_COLS, tri_rows + b * 10 * LEAF, i, r);
  } else {
#pragma unroll
    for (int c = 0; c < 10; ++c) r[c] = tri_rows[(b * 10 + c) * LEAF + i];
    r[10] = r[11] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) rec[R * i + q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                                                           r[4 * q + 3]);
  // one past the last real triangle (padding sits at a block's tail)
  const int last = __reduce_max_sync(FULL, r[PLK ? 25 : 9] >= 0.0f ? i + 1 : 0);
  if (lane == 0) {
    s_live[warp] = __popc(m);
    s_last[warp] = last;
  }
  __syncthreads();
  int n_live = 0, before = 0, n_tri = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? s_live[w] : 0;
    n_live += s_live[w];
    n_tri = max(n_tri, s_last[w]);
  }
  // the live pairs compacted to the front; a dead pair writes its miss now
  if (is_live) {
    live[before + __popc(m & ((1u << lane) - 1u))] = i;
  } else {
    pg_pair_out<ANY_HIT>(out, P, base + i, INF_T, NO_ID);
  }
  if (n_live == 0) return;  // uniform over the CTA
  __syncthreads();
  switch ((n_live + 31) / 32) {
    case 1: run_slots<PLK, ANY_HIT, 1>(rec, n_tri, live, n_live, pd, P, base, lz, best); break;
    case 2: run_slots<PLK, ANY_HIT, 2>(rec, n_tri, live, n_live, pd, P, base, lz, best); break;
    case 3: run_slots<PLK, ANY_HIT, 3>(rec, n_tri, live, n_live, pd, P, base, lz, best); break;
    default: run_slots<PLK, ANY_HIT, 4>(rec, n_tri, live, n_live, pd, P, base, lz, best); break;
  }
  __syncthreads();
  // thread i merges live pair i over the warps' shares (an order-free
  // minimum of (t, id)) and writes it
  if (i < n_live) {
    float bt = INF_T, bid = NO_ID;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float2 c = best[(w * SLOTS + (i >> 5)) * 32 + (i & 31)];
      pg_take(true, c.x, c.y, &bt, &bid);
    }
    pg_pair_out<ANY_HIT>(out, P, base + live[i], bt, bid);
  }
}

// C entry points: (table, tri_rows, n_blocks, tile_block, n_tiles, pdata
// (7, n_tiles*128), out (2, n_tiles*128), stream) -> cudaError_t.  The MT
// table is tri_rows (B, 10, 128); the Pluecker table is tri_cols
// (B, 16, 640), with the ids read from tri_rows row 9.  pair_mt_closest_bf16
// takes bfloat16 pair data and the loose test's four float32 constants
// (neg, one, eps_lo, u_hi) after the stream.
template <bool PLK, bool ANY_HIT, typename PD = float>
static int pair_launch(const void* table, const void* tri_rows, int n_blocks,
                       const void* tile_block, int n_tiles, const void* pdata, void* out,
                       void* stream, PgLoose lz = PgLoose{}) {
  if (n_tiles > 0) {
    const int64_t P = (int64_t)n_tiles * PAIR_TILE;
    pair_kernel<PLK, ANY_HIT, PD><<<n_tiles, PAIR_TILE, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const float*)tri_rows, n_blocks, (const int*)tile_block,
        (const PD*)pdata, (float*)out, P, lz);
  }
  return (int)cudaGetLastError();
}

#define PAIR_ARGS                                                                       \
  const void *table, const void *tri_rows, int n_blocks, const void *tile_block,        \
      int n_tiles, const void *pdata, void *out, void *stream
#define PAIR_PASS table, tri_rows, n_blocks, tile_block, n_tiles, pdata, out, stream

extern "C" int pair_mt_closest(PAIR_ARGS) { return pair_launch<false, false>(PAIR_PASS); }
extern "C" int pair_mt_any(PAIR_ARGS) { return pair_launch<false, true>(PAIR_PASS); }
extern "C" int pair_plk_closest(PAIR_ARGS) { return pair_launch<true, false>(PAIR_PASS); }
extern "C" int pair_plk_any(PAIR_ARGS) { return pair_launch<true, true>(PAIR_PASS); }
extern "C" int pair_mt_closest_bf16(PAIR_ARGS, float neg, float one, float eps_lo, float u_hi) {
  return pair_launch<false, false, __nv_bfloat16>(PAIR_PASS, PgLoose{neg, one, eps_lo, u_hi});
}
