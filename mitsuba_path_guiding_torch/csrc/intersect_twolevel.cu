// intersect_twolevel: closest hit of padded 512-ray tiles through
// Morton-sorted superblocks of 64 blocks x 128 triangles.
//
// Replaces the Pallas kernel mitsuba_path_guiding_tpu/ops/
// intersect_twolevel.py _kernel (via intersect_blocks): one program per
// ray tile; the superblocks in the global near-to-far order; per active
// (tile, superblock) a DMA of the superblock's pack, per block a box gate
// of every ray ORed over the tile, and a dense 128 x 512 Moeller-Trumbore
// for each block the OR opens.
//
// Bound: operations.  An opened block moves 5 KB of triangle rows and
// does 128 x 512 triangle tests of ~46 FP32 operations each; a gate is
// ~23 operations per (ray, block) of an active superblock.
// Design: one CTA of 512 threads per tile, one thread per ray with its
// running best in registers.  Per active superblock the 64 block boxes
// (1.5 KB) are staged in shared memory; for each block every thread gates
// its ray with its current best t, and __syncthreads_or gives the tile's
// OR.  The OR is the reference's: an opened block is tested by all 512
// rays, and the block boxes carry no padding, so a per-ray gate could
// drop a grazing hit just outside a box.  Padding rays (zeros, tmax 0)
// take part in the OR as they do in the reference.  An opened block's
// 10 rows x 128 triangles are staged in shared memory (5 KB; the
// superblock's whole 512 KB pack does not fit in the SM's 228 KB, so it
// is staged block by block, and only the blocks that open).  Within a
// block the winner is the least t and, among equal t, the least original
// id; across blocks a strictly nearer t replaces the best, so a tie stays
// with the block visited first.  tmax enters only as the initial best t.
// Per tile the kernel writes its work (int64): superblocks walked, blocks
// opened, triangle tests run (512 x 128 per opened block), and the tests
// the data needed (per opened block, the rays whose own gate passed and
// whose t still admits a hit, times the block's real triangles).
//
// Build: ops/build.py, nvcc -fmad=false, so the arithmetic is that of
// ops/intersect_twolevel.py twolevel_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

#define RAY_TILE 512
#define TRI_TILE 128
#define SB_BLOCKS 64
#define SB_TRIS (SB_BLOCKS * TRI_TILE)
#define INF_T 3.0e38f
#define NO_ID 2.0e9f

__device__ __forceinline__ float tl_gate_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

__global__ void __launch_bounds__(RAY_TILE)
twolevel_kernel(const int* __restrict__ mask, const int* __restrict__ order, int n_sb,
                const float* __restrict__ blk_lo, const float* __restrict__ blk_hi, int bpad,
                const float* __restrict__ ray, const float* __restrict__ tmax, int npad,
                const float* __restrict__ tri_pack, float* __restrict__ out,
                long long* __restrict__ work) {
  __shared__ float s_lo[3][SB_BLOCKS];
  __shared__ float s_hi[3][SB_BLOCKS];
  __shared__ float s_tri[10][TRI_TILE];
  const int tile = blockIdx.x;
  const int i = threadIdx.x;
  const int64_t n = (int64_t)tile * RAY_TILE + i;
  const float ox = ray[n], oy = ray[npad + n], oz = ray[2 * (int64_t)npad + n];
  const float dx = ray[3 * (int64_t)npad + n], dy = ray[4 * (int64_t)npad + n];
  const float dz = ray[5 * (int64_t)npad + n];
  const float ix = tl_gate_inv(dx), iy = tl_gate_inv(dy), iz = tl_gate_inv(dz);
  float cur = fminf(tmax[n], INF_T);
  float prim = -1.0f, bu = 0.0f, bv = 0.0f;
  long long walked = 0, opened = 0, needed = 0;

  for (int si = 0; si < n_sb; ++si) {
    const int s = order[si];
    if (mask[(int64_t)tile * n_sb + s] == 0) continue;  // uniform over the CTA
    ++walked;
    // every thread has passed the last block's __syncthreads_or, after
    // which no thread reads s_lo / s_hi
    if (i < 3 * SB_BLOCKS) {
      s_lo[i / SB_BLOCKS][i % SB_BLOCKS] =
          blk_lo[(int64_t)(i / SB_BLOCKS) * bpad + (int64_t)s * SB_BLOCKS + i % SB_BLOCKS];
    } else if (i < 6 * SB_BLOCKS) {
      const int j = i - 3 * SB_BLOCKS;
      s_hi[j / SB_BLOCKS][j % SB_BLOCKS] =
          blk_hi[(int64_t)(j / SB_BLOCKS) * bpad + (int64_t)s * SB_BLOCKS + j % SB_BLOCKS];
    }
    __syncthreads();
    const float* pack = tri_pack + (int64_t)s * 16 * SB_TRIS;
    for (int k = 0; k < SB_BLOCKS; ++k) {
      const float tx0 = (s_lo[0][k] - ox) * ix, tx1 = (s_hi[0][k] - ox) * ix;
      const float ty0 = (s_lo[1][k] - oy) * iy, ty1 = (s_hi[1][k] - oy) * iy;
      const float tz0 = (s_lo[2][k] - oz) * iz, tz1 = (s_hi[2][k] - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fmaxf(fminf(tz0, tz1), 0.0f));
      const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
      const bool gate = tf >= tn && tn <= cur;
      // also the barrier after which s_tri is free: every thread is done
      // with the previous opened block
      if (!__syncthreads_or(gate)) continue;
      for (int e = i; e < 10 * TRI_TILE; e += RAY_TILE) {
        s_tri[e / TRI_TILE][e % TRI_TILE] = pack[(int64_t)(e / TRI_TILE) * SB_TRIS +
                                                 k * TRI_TILE + e % TRI_TILE];
      }
      const int rays = __syncthreads_count(gate && cur > PG_EPS_T);
      const int tris = __syncthreads_count(i < TRI_TILE && s_tri[9][i] >= 0.0f);
      ++opened;
      needed += (long long)rays * tris;
      float bt = INF_T, bid = NO_ID, bu_b = 0.0f, bv_b = 0.0f;
      for (int q = 0; q < TRI_TILE; ++q) {
        const float tid = s_tri[9][q];
        float t, u, v;
        const bool hit = pg_mt_test(s_tri[0][q], s_tri[1][q], s_tri[2][q], s_tri[3][q],
                                    s_tri[4][q], s_tri[5][q], s_tri[6][q], s_tri[7][q],
                                    s_tri[8][q], ox, oy, oz, dx, dy, dz, &t, &u, &v) &&
                         tid >= 0.0f;
        if (hit && (t < bt || (t == bt && tid < bid))) {
          bt = t;
          bid = tid;
          // + 0: the reference takes u, v by a one-hot sum, which turns -0 into +0
          bu_b = u + 0.0f;
          bv_b = v + 0.0f;
        }
      }
      if (bt < cur) {
        cur = bt;
        prim = bid;
        bu = bu_b;
        bv = bv_b;
      }
    }
  }
  out[n] = cur;
  out[npad + n] = prim;
  out[2 * (int64_t)npad + n] = bu;
  out[3 * (int64_t)npad + n] = bv;
  if (i == 0) {
    work[4 * tile] = walked;
    work[4 * tile + 1] = opened;
    work[4 * tile + 2] = opened * RAY_TILE * TRI_TILE;
    work[4 * tile + 3] = needed;
  }
}

// C entry point: (mask (nt, S) int32, order (S,) int32, S, blk_lo (3, Bpad),
// blk_hi (3, Bpad), Bpad, ray (6, npad) rows o, d, tmax (npad,), npad,
// tri_pack (S, 16, 8192), out (4, npad) rows t, prim, u, v, work (nt, 4)
// int64, stream) -> cudaError_t.
extern "C" int twolevel_closest(const void* mask, const void* order, int n_sb,
                                const void* blk_lo, const void* blk_hi, int bpad,
                                const void* ray, const void* tmax, int npad,
                                const void* tri_pack, void* out, void* work, void* stream) {
  const int nt = npad / RAY_TILE;
  if (nt > 0) {
    twolevel_kernel<<<nt, RAY_TILE, 0, (cudaStream_t)stream>>>(
        (const int*)mask, (const int*)order, n_sb, (const float*)blk_lo,
        (const float*)blk_hi, bpad, (const float*)ray, (const float*)tmax, npad,
        (const float*)tri_pack, (float*)out, (long long*)work);
  }
  return (int)cudaGetLastError();
}
