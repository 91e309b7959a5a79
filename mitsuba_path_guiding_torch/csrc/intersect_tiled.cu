// intersect_tiled: dense closest-hit (or any-hit) Moeller-Trumbore of N
// rays against all triangles of a small scene.
//
// Replaces the Pallas kernel mitsuba_path_guiding_tpu/ops/intersect_pallas.py
// (_kernel via intersect_tiled), which tiles 128 triangles x 512 rays
// through VMEM with a running best (t, prim, u, v) across a sequential
// triangle-tile grid axis.
//
// Bound: operations.  Each (ray, triangle) pair costs ~46 FP32 operations
// while a ray moves 44 bytes, so at Cornell's 36 triangles the FP32 rate,
// not memory, is the limit.  With one thread per ray, Cornell's 65536 rays
// gave 2048 warps, about four per scheduler, each a serial chain of 36
// dependent tests with an IEEE division: too few warps to hide the
// chain's latency.  Design:
//   * PG_TILED_LANES (G = 4) lanes share a ray: lane g tests triangles
//     g, g + G, ..., so a warp holds 8 rays, the card 4x the warps and each
//     thread a chain a quarter as long.  Each lane keeps its own best (t,
//     prim, u, v) in registers; at the end the group merges them with two
//     __shfl_xor_sync rounds by least t, then least id (device_math.cuh
//     pg_nearer), carrying the winner's u and v.  That order is the one of
//     a single pass in ascending id with strictly-nearer replacement (the
//     Pallas kernel's per-tile minimum and strict merge), so the split
//     changes no bit.
//   * The CTA stages only the real triangles of each 128-triangle tile,
//     min(128, n_tri - base), one thread a triangle, as 48-byte records
//     (pg_tiled_record: p0, e1, e2, three words of padding) written as
//     three STS.128; a test reads them as three LDS.128, four distinct
//     records a warp instruction, each a broadcast to its 8 rays, without
//     bank conflicts.  The record's position is the triangle's id.
//   * The test runs in two stages (pg_mt_u, pg_mt_vt): v, t and the winner
//     update run only when some lane of the warp has u in range (a warp
//     vote); a lane whose own u is out of range cannot hit.
// Every lane of a warp runs the same number of steps (steps past the
// tile's end test nothing), so the votes and shuffles see the whole warp.
// A lane's best starts at min(tmax, 3e38) (a NaN tmax stays NaN), and a
// lane whose best is not above EPS_T is dead: it tests nothing and reports
// a miss, t = 3e38, prim = -1, u = v = 0, as the Pallas kernel does.  The
// any-hit variant stops a lane at its first hit below tmax, ORs the
// group's flags after every step, leaves the step loop once the whole warp
// is done and the tile loop once the whole CTA is (a barrier AND); every
// thread, dead lanes included, takes part in every tile load and barrier.
// The arithmetic is that of intersect_pallas.py:53-74 (|det| < 1e-12 is
// no hit, EPS_T = 1e-4), built with -fmad=false (ops/build.py), so the
// kernel gives ops/intersect_tiled.py tiled_plain's bits.
// Tried on the card and left out (PERF.md section 6): 8 or 2 lanes a ray;
// 4 warps sharing 32 rays, one ray a lane (a warp tests one triangle at a
// time, so the vote passes less often, but 64 registers); 2 or 4 rays a
// lane, each record read feeding their tests (55 registers); at most 32
// registers (__launch_bounds__(128, 16), one wave at Cornell's size).
// None was faster on both Cornell's closest hit (the main path's call)
// and veach_mis's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

#define TRI_TILE 128
#define CTA 128
#define G PG_TILED_LANES
#define RAYS_PER_CTA (CTA / G)
#define INF_T 3.0e38f
#define FULL 0xffffffffu
static_assert(CTA >= TRI_TILE, "one thread stages each triangle of a tile");

template <bool ANY_HIT>
__global__ void __launch_bounds__(CTA)
intersect_tiled_kernel(const float* __restrict__ pack, int tpad, int n_tri,
                       const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tmax, int N,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       uint8_t* __restrict__ hit_out) {
  __shared__ float4 rec[3 * TRI_TILE];  // per triangle: p0 e1x | e1yz e2xy | e2z - - -
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x % G;
  const unsigned group = ((1u << G) - 1u) << (lane - g);  // the ray's lanes in the warp
  const int n = blockIdx.x * RAYS_PER_CTA + threadIdx.x / G;
  const bool live = n < N;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float best_t = -1.0f;
  if (live) {
    ox = o[3 * n];
    oy = o[3 * n + 1];
    oz = o[3 * n + 2];
    dx = d[3 * n];
    dy = d[3 * n + 1];
    dz = d[3 * n + 2];
    const float tm = tmax[n];
    best_t = tm > INF_T ? INF_T : tm;
  }
  int best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;
  // a lane with best_t <= EPS_T (or NaN) can never take a hit (t > EPS_T)
  bool done = !(best_t > PG_EPS_T);

  for (int base = 0; base < n_tri; base += TRI_TILE) {
    const int cnt = min(TRI_TILE, n_tri - base);
    if (threadIdx.x < cnt) {
      float r[12];
      pg_tiled_record(pack, tpad, base + threadIdx.x, r);
      float4* dst = rec + 3 * threadIdx.x;
      dst[0] = make_float4(r[0], r[1], r[2], r[3]);
      dst[1] = make_float4(r[4], r[5], r[6], r[7]);
      dst[2] = make_float4(r[8], r[9], r[10], r[11]);
    }
    __syncthreads();
    if (__any_sync(FULL, !done)) {  // uniform over the warp
      const int steps = (cnt + G - 1) / G;
      for (int s = 0; s < steps; ++s) {
        const int k = g + G * s;
        const float4* rk = rec + 3 * min(k, cnt - 1);
        const float4 a = rk[0], b = rk[1], c = rk[2];
        float tv[3], inv, u;
        const bool may = pg_mt_u(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz, dx,
                                 dy, dz, tv, &inv, &u) &&
                         k < cnt && !done;
        if (__any_sync(FULL, may)) {
          float t, v;
          const bool hit = pg_mt_vt(a.w, b.x, b.y, b.z, b.w, c.x, dx, dy, dz, tv, inv, u, &t, &v);
          if (may && hit && t < best_t) {
            best_t = t;
            best_prim = base + k;
            best_u = u;
            best_v = v;
            if (ANY_HIT) done = true;
          }
        }
        if (ANY_HIT) {
          const unsigned m = __ballot_sync(FULL, done);
          if (m == FULL) break;  // uniform over the warp
          done = done || (m & group) != 0u;
        }
      }
    }
    if (base + TRI_TILE >= n_tri) break;  // the last tile: no barrier before the merge
    if (ANY_HIT) {
      if (__syncthreads_and(done)) break;
    } else {
      __syncthreads();
    }
  }

  if (ANY_HIT) {
    const bool hit = (__ballot_sync(FULL, best_prim >= 0) & group) != 0u;
    if (live && g == 0) hit_out[n] = hit ? 1 : 0;
    return;
  }
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float ot = __shfl_xor_sync(FULL, best_t, off);
    const int op = __shfl_xor_sync(FULL, best_prim, off);
    const float ou = __shfl_xor_sync(FULL, best_u, off);
    const float ov = __shfl_xor_sync(FULL, best_v, off);
    if (pg_nearer(ot, op, best_t, best_prim)) {
      best_t = ot;
      best_prim = op;
      best_u = ou;
      best_v = ov;
    }
  }
  if (!live) return;
  // a hit lies strictly below the group's common start, so a lane without
  // one (prim -1) never wins a tie; each lane of the group writes one output
  const bool valid = best_prim >= 0;
  if (g == 0) t_out[n] = valid ? best_t : INF_T;
  if (g == 1 % G) prim_out[n] = best_prim;
  if (g == 2 % G) u_out[n] = best_u;
  if (g == 3 % G) v_out[n] = best_v;
}

extern "C" int intersect_tiled_closest(const void* pack, int tpad, int n_tri,
                                       const void* o, const void* d,
                                       const void* tmax, int N, void* t_out,
                                       void* prim_out, void* u_out, void* v_out,
                                       void* stream) {
  if (N > 0) {
    const int blocks = (N + RAYS_PER_CTA - 1) / RAYS_PER_CTA;
    intersect_tiled_kernel<false><<<blocks, CTA, 0, (cudaStream_t)stream>>>(
        (const float*)pack, tpad, n_tri, (const float*)o, (const float*)d,
        (const float*)tmax, N, (float*)t_out, (int*)prim_out, (float*)u_out,
        (float*)v_out, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int intersect_tiled_any(const void* pack, int tpad, int n_tri,
                                   const void* o, const void* d, const void* tmax,
                                   int N, void* hit_out, void* stream) {
  if (N > 0) {
    const int blocks = (N + RAYS_PER_CTA - 1) / RAYS_PER_CTA;
    intersect_tiled_kernel<true><<<blocks, CTA, 0, (cudaStream_t)stream>>>(
        (const float*)pack, tpad, n_tri, (const float*)o, (const float*)d,
        (const float*)tmax, N, nullptr, nullptr, nullptr, nullptr,
        (uint8_t*)hit_out);
  }
  return (int)cudaGetLastError();
}
