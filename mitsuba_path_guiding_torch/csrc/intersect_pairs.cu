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
// (4.6 KB) plus its block's rows, and does 128 x 128 triangle tests of
// ~46 (MT) or ~52 (Pluecker) FP32 operations: ~150 operations per byte,
// far above the card's ~10 FP32 operations per byte of HBM.  Design: one
// CTA of 128 threads per tile, thread j owns pair j; the block's rows
// (MT: p0 e1 e2 id, 10 x 128 floats; Pluecker: 25 coefficients + id per
// triangle, from tri_cols) are staged once in shared memory and read as
// broadcasts (every thread reads the same triangle at the same time).
// An inert tile (tile_block < 0: dummies or the sort's tail) writes
// (INF, -1) and returns before touching the table.  The Pluecker test runs
// in FP32 on the CUDA cores, summing in the plain version's order
// (device_math.cuh pg_plucker_hit), not on the tensor cores, whose TF32 or
// bf16 inputs would drop hits.  The winner is the least t and, among equal
// t, the least original triangle id (row 9), as the Pallas kernels reduce
// it; any-hit writes +-1 in row 1.  Dead pairs carry tmax 0.
//
// Build: ops/build.py, nvcc -fmad=false (no contraction), so the tests
// agree bit for bit with ops/intersect_pairs.py mt_tiles_plain /
// plk_tiles_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

#define PAIR_TILE 128
#define LEAF 128
#define PLK_COLS (5 * LEAF)
#define INF_T 3.0e38f
#define NO_ID 2.0e9f

__device__ __forceinline__ void pg_take(bool hit, float t, float tid, float* bt, float* bid) {
  if (hit && (t < *bt || (t == *bt && tid < *bid))) {
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

template <bool ANY_HIT>
__global__ void __launch_bounds__(PAIR_TILE)
pair_mt_kernel(const float* __restrict__ tri_rows, int n_blocks,
               const int* __restrict__ tile_block, const float* __restrict__ pd,
               float* __restrict__ out, int64_t P) {
  __shared__ float s[10][LEAF];
  const int j = threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * PAIR_TILE + j;
  const int blk = tile_block[blockIdx.x];
  if (blk < 0) {  // uniform over the CTA
    pg_pair_out<ANY_HIT>(out, P, p, INF_T, NO_ID);
    return;
  }
  const float* src = tri_rows + (int64_t)min(blk, n_blocks - 1) * 10 * LEAF;
#pragma unroll
  for (int r = 0; r < 10; ++r) s[r][j] = src[r * LEAF + j];
  __syncthreads();
  const float ox = pd[p], oy = pd[P + p], oz = pd[2 * P + p];
  const float dx = pd[3 * P + p], dy = pd[4 * P + p], dz = pd[5 * P + p];
  const float tmax = pd[6 * P + p];
  float bt = INF_T, bid = NO_ID;
  for (int k = 0; k < LEAF; ++k) {
    const float tid = s[9][k];
    float t, u, v;
    const bool hit = pg_mt_test(s[0][k], s[1][k], s[2][k], s[3][k], s[4][k], s[5][k],
                                s[6][k], s[7][k], s[8][k], ox, oy, oz, dx, dy, dz, &t, &u, &v);
    pg_take(hit && t < tmax && tid >= 0.0f, t, tid, &bt, &bid);
  }
  pg_pair_out<ANY_HIT>(out, P, p, bt, bid);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(PAIR_TILE)
pair_plk_kernel(const float* __restrict__ tri_cols, const float* __restrict__ tri_rows,
                int n_blocks, const int* __restrict__ tile_block,
                const float* __restrict__ pd, float* __restrict__ out, int64_t P) {
  // per triangle: 25 coefficients in pg_plucker_hit's order, then its id
  __shared__ float c[LEAF][26];
  const int j = threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * PAIR_TILE + j;
  const int blk = tile_block[blockIdx.x];
  if (blk < 0) {
    pg_pair_out<ANY_HIT>(out, P, p, INF_T, NO_ID);
    return;
  }
  const int64_t b = min(blk, n_blocks - 1);
  const float* cols = tri_cols + b * 16 * PLK_COLS;  // (16, 5*128): row f, group g, tri j
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int f = 0; f < 6; ++f) c[j][6 * g + f] = cols[f * PLK_COLS + g * LEAF + j];
#pragma unroll
  for (int f = 0; f < 4; ++f) c[j][18 + f] = cols[(6 + f) * PLK_COLS + 3 * LEAF + j];
#pragma unroll
  for (int f = 0; f < 3; ++f) c[j][22 + f] = cols[f * PLK_COLS + 4 * LEAF + j];
  c[j][25] = tri_rows[(b * 10 + 9) * LEAF + j];
  __syncthreads();
  const float o[3] = {pd[p], pd[P + p], pd[2 * P + p]};
  const float d[3] = {pd[3 * P + p], pd[4 * P + p], pd[5 * P + p]};
  const float tmax = pd[6 * P + p];
  const float m[3] = {o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                      o[0] * d[1] - o[1] * d[0]};
  float bt = INF_T, bid = NO_ID;
  for (int k = 0; k < LEAF; ++k) {
    float t;
    const bool hit = pg_plucker_hit(&c[k][0], o, d, m, tmax, ANY_HIT, &t);
    pg_take(hit && c[k][25] >= 0.0f, t, c[k][25], &bt, &bid);
  }
  pg_pair_out<ANY_HIT>(out, P, p, bt, bid);
}

// C entry points: (table, tri_rows, n_blocks, tile_block, n_tiles, pdata
// (7, n_tiles*128), out (2, n_tiles*128), stream) -> cudaError_t.  The MT
// table is tri_rows (B, 10, 128); the Pluecker table is tri_cols
// (B, 16, 640), with the ids read from tri_rows row 9.
template <bool PLK, bool ANY_HIT>
static int pair_launch(const void* table, const void* tri_rows, int n_blocks,
                       const void* tile_block, int n_tiles, const void* pdata, void* out,
                       void* stream) {
  if (n_tiles > 0) {
    const int64_t P = (int64_t)n_tiles * PAIR_TILE;
    if (PLK) {
      pair_plk_kernel<ANY_HIT><<<n_tiles, PAIR_TILE, 0, (cudaStream_t)stream>>>(
          (const float*)table, (const float*)tri_rows, n_blocks, (const int*)tile_block,
          (const float*)pdata, (float*)out, P);
    } else {
      pair_mt_kernel<ANY_HIT><<<n_tiles, PAIR_TILE, 0, (cudaStream_t)stream>>>(
          (const float*)table, n_blocks, (const int*)tile_block, (const float*)pdata,
          (float*)out, P);
    }
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
