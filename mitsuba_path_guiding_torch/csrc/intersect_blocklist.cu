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
// Design: one CTA of 256 threads per tile, one thread per ray with its
// running best in registers.  Per superblock the 32 block boxes (1 KB) are
// staged in shared memory; each thread gates its ray against all 32 with
// its current best t, and the gates are ORed over each 128-ray half tile
// (warp __reduce_or_sync, then a shared atomicOr per warp).  The OR is the
// reference's: the block boxes carry no padding, so a per-ray gate would
// cull grazing hits that the half-tile mask lets through.  The set bits
// are visited in ascending order, half 0 first; for each, all 256 threads
// stage the block's 10 x 128 rows and the threads of that half test them.
// Within a block the winner is the least t and, among equal t, the least
// original id; across blocks a strictly nearer t replaces the best, so a
// tie stays with the block visited first.  Any-hit sets the ray's t to -1
// at its first hit, which fails every later gate.  After each superblock
// the CTA takes the max of its rays' t bits >> 16 and stops when the next
// candidate's key (entry-distance bits >> 16) exceeds it; an overflow tile
// (count > k) walks every superblock in index order with no early exit.
// Per tile the kernel writes its work: superblocks walked, (block, half
// tile) visits, and the triangle tests the data needed: for each visit,
// the rays of the half tile whose own gate passed the block and whose t
// still admits a hit, times the block's real (id >= 0) triangles.  The
// reference's double-buffered superblock DMA is left out: a CTA reads only
// the rows of the blocks it visits.
//
// Build: ops/build.py, nvcc -fmad=false, so the arithmetic is that of
// ops/intersect_blocklist.py blocklist_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

#define RAY_TILE 256
#define SUB_TILE 128
#define SB_BLOCKS 32
#define BLOCK_TRIS 128
#define INF_T 3.0e38f
#define NO_ID 2.0e9f
#define INF_HI 0x7F80

__device__ __forceinline__ float pg_gate_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(RAY_TILE)
blocklist_kernel(const int* __restrict__ cand, const int* __restrict__ cnt, int k,
                 const float* __restrict__ ray, const float* __restrict__ tmax, int npad,
                 const float* __restrict__ blk_box, const float* __restrict__ tri_pack,
                 int n_sb, float* __restrict__ out, int* __restrict__ work) {
  __shared__ float s_box[SB_BLOCKS][8];
  __shared__ float s_tri[10][BLOCK_TRIS];
  __shared__ unsigned s_bits[RAY_TILE / SUB_TILE];
  __shared__ int s_worst[RAY_TILE / 32];
  const int tile = blockIdx.x;
  const int i = threadIdx.x;
  const int half = i / SUB_TILE;
  const int64_t n = (int64_t)tile * RAY_TILE + i;
  const float ox = ray[n], oy = ray[npad + n], oz = ray[2 * (int64_t)npad + n];
  const float dx = ray[3 * (int64_t)npad + n], dy = ray[4 * (int64_t)npad + n];
  const float dz = ray[5 * (int64_t)npad + n];
  const float ix = pg_gate_inv(dx), iy = pg_gate_inv(dy), iz = pg_gate_inv(dz);
  float cur = fminf(tmax[n], INF_T);
  float prim = -1.0f, bu = 0.0f, bv = 0.0f;

  const int cnt_raw = cnt[tile];
  const bool use_list = cnt_raw <= k;
  const int n_iter = use_list ? cnt_raw : n_sb;
  const int* list = cand + (int64_t)tile * k;
  int worst_hi = INF_HI;
  int j = 0, visits = 0, tests = 0;
  while (j < n_iter) {  // every condition below is uniform over the CTA
    const int key = list[min(j, k - 1)];
    if ((use_list ? key >> 16 : 0) > worst_hi) break;
    const int sb = use_list ? (key & 0xFFFF) : j;
    __syncthreads();  // the previous superblock's readers are done
    s_box[i / 8][i % 8] = blk_box[(int64_t)sb * SB_BLOCKS * 8 + i];
    if (i < RAY_TILE / SUB_TILE) s_bits[i] = 0u;
    __syncthreads();
    unsigned own = 0u;
#pragma unroll 4
    for (int b = 0; b < SB_BLOCKS; ++b) {
      const float tx0 = (s_box[b][0] - ox) * ix, tx1 = (s_box[b][3] - ox) * ix;
      const float ty0 = (s_box[b][1] - oy) * iy, ty1 = (s_box[b][4] - oy) * iy;
      const float tz0 = (s_box[b][2] - oz) * iz, tz1 = (s_box[b][5] - oz) * iz;
      const float tnr = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                              fmaxf(fminf(tz0, tz1), 0.0f));
      const float tfr = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
      if (tfr >= tnr && tnr <= cur) own |= 1u << b;
    }
    const unsigned mine = __reduce_or_sync(0xffffffffu, own);
    if ((i & 31) == 0 && mine) atomicOr(&s_bits[half], mine);
    __syncthreads();
    for (int s = 0; s < RAY_TILE / SUB_TILE; ++s) {
      unsigned bits = s_bits[s];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        __syncthreads();  // s_tri is free
        const float* src = tri_pack + ((int64_t)sb * SB_BLOCKS + b) * 16 * BLOCK_TRIS;
        for (int e = i; e < 10 * BLOCK_TRIS; e += RAY_TILE) s_tri[e / BLOCK_TRIS][e % BLOCK_TRIS] = src[e];
        const int rays = __syncthreads_count(half == s && ((own >> b) & 1u) && cur > PG_EPS_T);
        const int tris = __syncthreads_count(i < BLOCK_TRIS && s_tri[9][i] >= 0.0f);
        ++visits;
        tests += rays * tris;
        if (half != s) continue;
        float bt = INF_T, bid = NO_ID, bu_b = 0.0f, bv_b = 0.0f;
        for (int q = 0; q < BLOCK_TRIS; ++q) {
          const float tid = s_tri[9][q];
          float t, u, v;
          const bool hit = pg_mt_test(s_tri[0][q], s_tri[1][q], s_tri[2][q], s_tri[3][q],
                                      s_tri[4][q], s_tri[5][q], s_tri[6][q], s_tri[7][q],
                                      s_tri[8][q], ox, oy, oz, dx, dy, dz, &t, &u, &v) &&
                           tid >= 0.0f;
          if (ANY_HIT) {
            if (hit && t < cur) {
              cur = -1.0f;
              prim = 1.0f;
              break;
            }
          } else if (hit && (t < bt || (t == bt && tid < bid))) {
            bt = t;
            bid = tid;
            bu_b = u;
            bv_b = v;
          }
        }
        if (!ANY_HIT && bt < cur) {
          cur = bt;
          prim = bid;
          bu = bu_b;
          bv = bv_b;
        }
      }
    }
    // block-wide max of the t bits >> 16 (monotonic for positive floats)
    const int hi = __reduce_max_sync(0xffffffffu, __float_as_int(cur) >> 16);
    if ((i & 31) == 0) s_worst[i / 32] = hi;
    __syncthreads();
    worst_hi = s_worst[0];
#pragma unroll
    for (int w = 1; w < RAY_TILE / 32; ++w) worst_hi = max(worst_hi, s_worst[w]);
    ++j;
  }
  out[n] = cur;
  out[npad + n] = prim;
  out[2 * (int64_t)npad + n] = bu;
  out[3 * (int64_t)npad + n] = bv;
  if (i == 0) {
    work[3 * tile] = j;
    work[3 * tile + 1] = visits;
    work[3 * tile + 2] = tests;
  }
}

// C entry points: (cand (nt, k) int32, cnt (nt,) int32, k, ray (6, npad)
// rows o, d, tmax (npad,), npad, blk_box (S, 32, 8), tri_pack
// (S, 32, 16, 128), S, out (4, npad) rows t, prim, u, v, work (nt, 3)
// int32, stream) -> cudaError_t.
template <bool ANY_HIT>
static int blocklist_launch(const void* cand, const void* cnt, int k, const void* ray,
                            const void* tmax, int npad, const void* blk_box,
                            const void* tri_pack, int n_sb, void* out, void* work,
                            void* stream) {
  const int nt = npad / RAY_TILE;
  if (nt > 0) {
    blocklist_kernel<ANY_HIT><<<nt, RAY_TILE, 0, (cudaStream_t)stream>>>(
        (const int*)cand, (const int*)cnt, k, (const float*)ray, (const float*)tmax, npad,
        (const float*)blk_box, (const float*)tri_pack, n_sb, (float*)out, (int*)work);
  }
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
