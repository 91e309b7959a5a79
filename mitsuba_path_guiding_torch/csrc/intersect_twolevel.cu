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
// What the kernel keeps of the reference: within a superblock the blocks
// are taken in order and each gate reads the ray's current best t; the OR
// opens a block for all 512 rays (the block boxes carry no padding, so a
// ray's own gate could drop a grazing hit just outside a box), padding
// rays (zeros, tmax 0) included; within a block the winner is the least t
// and, among equal t, the least original id; across blocks a strictly
// nearer t replaces the best, so a tie stays with the block visited first.
// tmax enters only as the initial best t.
//
// Bound: operations.  An opened block moves 5 KB of triangle rows and
// runs 128 x 512 triangle tests of ~46 FP32 operations each; a gate is ~23
// operations per (ray, block) of an active superblock.  The tests run are
// the reference's meaning, so their operations are the floor the design
// works against: the issue slots of each test, and the barriers and loads
// around them.
//
// Design: one CTA of 512 threads per tile (two resident on an SM at 64
// registers), one thread per ray with its running best in registers; the
// per-ray steps are device_math.cuh pg_tl_*, which g++ also runs in
// tests/test_torch_csrc_host.py.
//   * The walked superblocks' ids are read once per 512 of them into
//     shared memory, and each ray's slab inverses sit in shared memory too:
//     the test loop keeps only what it needs in registers.
//   * Candidates: on entering a superblock every thread gates its ray
//     against the 64 block boxes (staged in shared memory as 32-byte
//     records, read as LDS.128 broadcasts) at its best t then; the tile
//     ORs the 64-bit masks (a warp reduce, one word a warp, one barrier).
//     The best t only falls, so every block that opens is a candidate, and
//     only candidates take the exact gate against the current best t and
//     its __syncthreads_or: one barrier a candidate, none for the blocks no
//     ray can open.
//   * Staging: an opened block's 10 rows x 128 triangles become 48-byte
//     records (p0, e1, e2, id, two unused words) in shared memory, by
//     cp.async word by word, then one barrier.  The candidate's barrier
//     comes after every thread's tests of the block before, so one buffer
//     serves; the other CTA on the SM runs while this one waits.
//   * Tests: each record is read as LDS.128 broadcasts and tested in three
//     stages, each behind a vote of the warp on the one before: the
//     division-free part of u and a reject that is exact to skip
//     (pg_mt_surely_out), then the division and 0 <= u <= 1, then v, t
//     and the update.  Most warps stop at the first stage.  The loop takes
//     two records an iteration, so their loads and arithmetic interleave.
//     A winner keeps t, id and its record; its u and v are computed again
//     from the pack at the end, with the same operations.  The loop stops
//     after the block's last real triangle (padding sits at the pack's
//     tail), and a warp whose rays all have a best t at or below EPS_T
//     (padding, tmax <= EPS_T) skips the tests: no hit can replace such a
//     best.
//   * Order: a tile's walk can take several times the mean (a bounce
//     wave's densest tiles); where there are more than two waves of CTAs,
//     twolevel_order_kernel may start the longest walks first (below).
// Levers measured on the card and left out (PERF.md section 6): staging the
// next candidate during the tests, 40 registers for three CTAs an SM, two
// lanes a ray.
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
#define WARPS (RAY_TILE / 32)
#define TRI_TILE PG_TL_TRIS
#define SB_BLOCKS PG_TL_BLOCKS
#define SB_TRIS PG_TL_SB_TRIS
#define INF_T 3.0e38f
#define NO_ID 2.0e9f
#define FULL 0xffffffffu

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// issue block k's staging into the records at rec: words i, i + 512, ...
__device__ __forceinline__ void stage_block(const float* __restrict__ pack, int k, float4* rec) {
  float* w = reinterpret_cast<float*>(rec);
  for (int e = threadIdx.x; e < PG_TL_WORDS * TRI_TILE; e += RAY_TILE) {
    int dst, src;
    pg_tl_record_word(e, k, &dst, &src);
    cp_async4(w + dst, pack + src);
  }
  cp_async_commit();
}

// The order in which the CTAs take the tiles.  Where the tiles outnumber
// two waves of the card's resident CTAs and their walks are uneven (the
// longest over 1.5 times the mean), the tiles go in descending order of
// the superblocks they walk (a counting sort by one CTA), so that the
// longest walks start first and do not trail at the end.  Otherwise they
// keep index order: with at most two waves every tile starts early
// anyway, and even walks do not rank the tiles' cost.  The order goes to
// tl_order, which the main kernel reads after this kernel on the same
// stream; no order changes a result, since each tile's walk is its own.
#define MAX_TILES 16384
#define ORDER_BINS 1024
__device__ int tl_order[MAX_TILES];

__global__ void __launch_bounds__(1024)
twolevel_order_kernel(const int* __restrict__ mask, int n_sb, int nt) {
  __shared__ unsigned short s_key[MAX_TILES];  // ORDER_BINS - 1 - walk length
  __shared__ int s_bin[ORDER_BINS];
  __shared__ int s_max, s_sum;
  for (int b = threadIdx.x; b < ORDER_BINS; b += blockDim.x) s_bin[b] = 0;
  if (threadIdx.x == 0) s_max = s_sum = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    int walked = 0;
#pragma unroll 4
    for (int s = 0; s < n_sb; ++s) walked += mask[(int64_t)t * n_sb + s] != 0;
    const int key = ORDER_BINS - 1 - min(walked, ORDER_BINS - 1);
    s_key[t] = (unsigned short)key;
    atomicAdd(&s_bin[key], 1);
    atomicMax(&s_max, walked);
    atomicAdd(&s_sum, walked);
  }
  __syncthreads();
  if (2 * (int64_t)s_max * nt <= 3 * (int64_t)s_sum) {  // uniform over the CTA
    for (int t = threadIdx.x; t < nt; t += blockDim.x) tl_order[t] = t;
    return;
  }
  if (threadIdx.x == 0) {
    int start = 0;
    for (int b = 0; b < ORDER_BINS; ++b) {
      const int c = s_bin[b];
      s_bin[b] = start;
      start += c;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += blockDim.x) tl_order[atomicAdd(&s_bin[s_key[t]], 1)] = t;
}

__global__ void __launch_bounds__(RAY_TILE, 2)
twolevel_kernel(const int* __restrict__ mask, const int* __restrict__ order, int n_sb,
                const float* __restrict__ blk_lo, const float* __restrict__ blk_hi, int bpad,
                const float* __restrict__ ray, const float* __restrict__ tmax, int npad,
                const float* __restrict__ tri_pack, float* __restrict__ out,
                long long* __restrict__ work, int ordered) {
  __shared__ __align__(16) float4 s_box[2 * SB_BLOCKS];  // pg_tl_box_word
  __shared__ __align__(16) float4 s_rec[3 * TRI_TILE];  // an opened block's records
  __shared__ float s_inv[3][RAY_TILE];                  // each ray's slab inverses
  __shared__ int s_walk[RAY_TILE];                      // superblock, or -1 if inactive
  __shared__ unsigned long long s_cand[WARPS];          // each warp's candidates
  __shared__ unsigned long long s_need[WARPS];
  __shared__ int s_walked, s_opened;
  const int tile = ordered ? tl_order[blockIdx.x] : blockIdx.x;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int64_t n = (int64_t)tile * RAY_TILE + i;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = ray[a * (int64_t)npad + n];
    d[a] = ray[(3 + a) * (int64_t)npad + n];
    s_inv[a][i] = pg_tl_inv(d[a]);
  }
  if (i == 0) s_walked = s_opened = 0;
  float best_t = fminf(tmax[n], INF_T);
  int best_pos = -1;
  unsigned needed = 0;  // at most the pack's columns: ids are exact floats, below 2^24

  for (int si = 0; si < n_sb; ++si) {
    if (si % RAY_TILE == 0) {
      // every thread has read s_walk and passed the last barrier before
      __syncthreads();
      if (si + i < n_sb) {
        const int s = order[si + i];
        s_walk[i] = mask[tile * (int64_t)n_sb + s] != 0 ? s : -1;
      }
      __syncthreads();
    }
    const int s = s_walk[si % RAY_TILE];
    if (s < 0) continue;  // uniform over the CTA
    // every thread has passed the last barrier of the previous
    // superblock, after which none reads s_box or s_cand
    if (i < 6 * SB_BLOCKS) {
      int dst;
      bool lo;
      int64_t src;
      pg_tl_box_word(i, s, bpad, &dst, &lo, &src);
      reinterpret_cast<float*>(s_box)[dst] = (lo ? blk_lo : blk_hi)[src];
    }
    if (i == 0) ++s_walked;
    __syncthreads();
    {
      const float inv[3] = {s_inv[0][i], s_inv[1][i], s_inv[2][i]};
      const uint64_t mine = pg_tl_candidates(s_box, o, inv, best_t);
      const unsigned c_lo = __reduce_or_sync(FULL, (unsigned)mine);
      const unsigned c_hi = __reduce_or_sync(FULL, (unsigned)(mine >> 32));
      if (lane == 0) s_cand[warp] = ((unsigned long long)c_hi << 32) | c_lo;
    }
    __syncthreads();
    // candidates in ascending order; k is the last one taken
    for (int k = -1;;) {
      unsigned long long cand = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) cand |= s_cand[v];
      cand = k < 63 ? cand >> (k + 1) << (k + 1) : 0ull;
      if (cand == 0) break;  // uniform over the CTA
      k = __ffsll((long long)cand) - 1;
      const float inv[3] = {s_inv[0][i], s_inv[1][i], s_inv[2][i]};
      const bool gate = pg_tl_gate(s_box, k, o, inv, best_t);
      // also the barrier after which s_rec is free: every thread is done
      // with the previous opened block's tests
      if (!__syncthreads_or(gate)) continue;
      if (i == 0) ++s_opened;
      stage_block(tri_pack + (int64_t)s * 16 * SB_TRIS, k, s_rec);
      cp_async_wait_all();
      __syncthreads();
      const float* words = reinterpret_cast<const float*>(s_rec);
      int tris = 0, last = 0;
#pragma unroll
      for (int h = 0; h < TRI_TILE / 32; ++h) {
        const unsigned real = __ballot_sync(FULL, words[12 * (32 * h + lane) + 9] >= 0.0f);
        tris += __popc(real);
        if (real != 0) last = 32 * h + 32 - __clz(real);
      }
      if (gate && best_t > PG_EPS_T) needed += tris;
      if (!__any_sync(FULL, best_t > PG_EPS_T)) continue;
      pg_tl_win win = {INF_T, NO_ID, 0};
#pragma unroll 2
      for (int q = 0; q < last; ++q) {
        const float4 a = s_rec[3 * q], b = s_rec[3 * q + 1], c = s_rec[3 * q + 2];
        float tv[3], det, num, inv_det, u;
        pg_tl_num(a, b, c, o, d, tv, &det, &num);
        if (!__any_sync(FULL, !pg_mt_surely_out(num, det))) continue;
        const bool may = pg_mt_u_of(num, det, &inv_det, &u);
        if (__any_sync(FULL, may)) pg_tl_take(a, b, c, q, may, d, tv, inv_det, u, &win);
      }
      pg_tl_merge(&win, s * SB_TRIS + k * TRI_TILE, &best_t, &best_pos);
    }
  }
  float prim = -1.0f, bu = 0.0f, bv = 0.0f;
  if (best_pos >= 0) {
    float4 a, b, c;
    pg_tl_pack_record(tri_pack + (int64_t)(best_pos / SB_TRIS) * 16 * SB_TRIS,
                      best_pos % SB_TRIS, &a, &b, &c);
    pg_tl_uv(a, b, c, o, d, &bu, &bv);
    prim = c.y;
  }
  out[n] = best_t;
  out[npad + n] = prim;
  out[2 * (int64_t)npad + n] = bu;
  out[3 * (int64_t)npad + n] = bv;
  unsigned long long total = needed;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(FULL, total, off);
  if (lane == 0) s_need[warp] = total;
  __syncthreads();
  if (i == 0) {
    total = 0;
    for (int v = 0; v < WARPS; ++v) total += s_need[v];
    long long* w = work + 4 * (int64_t)tile;
    w[0] = s_walked;
    w[1] = s_opened;
    w[2] = (long long)s_opened * RAY_TILE * TRI_TILE;
    w[3] = (long long)total;
  }
}

// C entry point: (mask (nt, S) int32, order (S,) int32, S, blk_lo (3, Bpad),
// blk_hi (3, Bpad), Bpad, ray (6, npad) rows o, d, tmax (npad,), npad,
// tri_pack (S, 16, 8192), out (4, npad) rows t, prim, u, v, work (nt, 4)
// int64, stream) -> cudaError_t.  Calls on one stream: the tile order lives
// in the library's tl_order between the two launches.
extern "C" int twolevel_closest(const void* mask, const void* order, int n_sb,
                                const void* blk_lo, const void* blk_hi, int bpad,
                                const void* ray, const void* tmax, int npad,
                                const void* tri_pack, void* out, void* work, void* stream) {
  const int nt = npad / RAY_TILE;
  static int resident = 0;  // CTAs of twolevel_kernel the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, twolevel_kernel, RAY_TILE, 0);
    resident = sms * per_sm;
  }
  if (nt > 0) {
    const int ordered = nt > 2 * resident && nt <= MAX_TILES;
    if (ordered) {
      twolevel_order_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>((const int*)mask, n_sb, nt);
    }
    twolevel_kernel<<<nt, RAY_TILE, 0, (cudaStream_t)stream>>>(
        (const int*)mask, (const int*)order, n_sb, (const float*)blk_lo,
        (const float*)blk_hi, bpad, (const float*)ray, (const float*)tmax, npad,
        (const float*)tri_pack, (float*)out, (long long*)work, ordered);
  }
  return (int)cudaGetLastError();
}
