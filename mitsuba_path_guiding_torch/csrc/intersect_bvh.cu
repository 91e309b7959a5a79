// intersect_bvh: closest-hit (or any-hit) stack traversal of a binary BVH,
// one thread per ray.
//
// Replaces mitsuba_path_guiding_tpu/accel/traverse.py intersect_bvh, a
// vmapped lax.while_loop over a 48-entry stack (not a Pallas kernel; no
// plain tensor program walks a per-ray stack at a usable speed).
//
// Bound: a per-ray walk of data-dependent length, latency-bound on the
// dependent loads of each node.  The least work is the nodes and
// triangles this run's rays visit: per node 24 B of box and 8 B of
// children, per triangle 36 B and ~46 FP32 operations.
// Design: the walk of the reference, step for step, so that the plain
// version (ops/intersect_bvh.py bvh_plain) gives the same bits: pop; slab
// test of the node's box against the current best t (an axis with
// |1/d| >= 1e19 takes a containment test); a leaf tests its up to 4
// triangles in order with EPS_T < t < best t (a tie stays with the
// triangle found first); an inner node pushes the far child and then the
// near one, near meaning tn0 <= tn1 at the current best t.  The stack
// lives in local memory; the scene compiler checks the tree's depth
// against it, and indices are clamped to it as in bvh_plain.  Any-hit
// stops at the first triangle hit.  Each thread writes its ray's work:
// nodes popped and triangles tested.
//
// Build: ops/build.py, nvcc -fmad=false, so the arithmetic is that of
// bvh_plain (dot products summed as ((x0 y0 + x1 y1) + x2 y2)).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

#define STACK_SIZE 48
#define MAX_LEAF 4
#define INF_T 3.0e38f

__device__ __forceinline__ float bvh_safe_rcp(float x) {
  return (x >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(x), 1e-20f);
}

// traverse.py _ray_aabb for one ray and box; returns the hit, t_near in *tn
__device__ __forceinline__ bool bvh_ray_aabb(const float* o, const float* inv,
                                             const float* __restrict__ bmin,
                                             const float* __restrict__ bmax, float tmax,
                                             float* tn_out) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float mn = __ldg(bmin + a), mx = __ldg(bmax + a);
    const bool parallel = fabsf(inv[a]) >= 1e19f;
    const bool inside = o[a] >= mn && o[a] <= mx;
    const float t0 = (mn - o[a]) * inv[a];
    const float t1 = (mx - o[a]) * inv[a];
    lo[a] = parallel ? (inside ? -INF_T : INF_T) : fminf(t0, t1);
    hi[a] = parallel ? (inside ? INF_T : -INF_T) : fmaxf(t0, t1);
  }
  const float tn = fmaxf(fmaxf(lo[0], lo[1]), lo[2]);
  const float tf = fminf(fminf(hi[0], hi[1]), hi[2]);
  *tn_out = tn;
  return tf >= fmaxf(tn, 0.0f) && tn <= tmax;
}

// traverse.py moeller_trumbore: safe_rcp(det) and |det| > 1e-12, which
// pg_mt_test (inv_det 0 below 1e-12) does not share
__device__ __forceinline__ bool bvh_moeller_trumbore(const float* o, const float* d,
                                                     const float* __restrict__ p0,
                                                     const float* __restrict__ e1,
                                                     const float* __restrict__ e2, float tmax,
                                                     float* t_out, float* u_out, float* v_out) {
  const float p0x = __ldg(p0), p0y = __ldg(p0 + 1), p0z = __ldg(p0 + 2);
  const float e1x = __ldg(e1), e1y = __ldg(e1 + 1), e1z = __ldg(e1 + 2);
  const float e2x = __ldg(e2), e2y = __ldg(e2 + 1), e2z = __ldg(e2 + 2);
  const float pvx = d[1] * e2z - d[2] * e2y;
  const float pvy = d[2] * e2x - d[0] * e2z;
  const float pvz = d[0] * e2y - d[1] * e2x;
  const float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
  const float inv_det = bvh_safe_rcp(det);
  const float tvx = o[0] - p0x, tvy = o[1] - p0y, tvz = o[2] - p0z;
  const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = ((d[0] * qvx + d[1] * qvy) + d[2] * qvz) * inv_det;
  const float t = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > PG_EPS_T &&
         t < tmax;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
bvh_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ tmax, int n, const float* __restrict__ node_min,
           const float* __restrict__ node_max, const int* __restrict__ child0,
           const int* __restrict__ child1, const int* __restrict__ prim_idx, int n_prim_idx,
           const float* __restrict__ p0, const float* __restrict__ e1,
           const float* __restrict__ e2, float* __restrict__ out_t, int* __restrict__ out_prim,
           float* __restrict__ out_u, float* __restrict__ out_v, int* __restrict__ counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float o[3] = {ro[3 * (int64_t)r], ro[3 * (int64_t)r + 1], ro[3 * (int64_t)r + 2]};
  const float d[3] = {rd[3 * (int64_t)r], rd[3 * (int64_t)r + 1], rd[3 * (int64_t)r + 2]};
  const float inv[3] = {bvh_safe_rcp(d[0]), bvh_safe_rcp(d[1]), bvh_safe_rcp(d[2])};
  int stack[STACK_SIZE];
  stack[0] = 0;
  int sp = 1;
  float best_t = tmax[r], best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1, nodes = 0, prims = 0;
  while (sp > 0 && (!ANY_HIT || best_prim < 0)) {
    --sp;
    const int node = stack[min(sp, STACK_SIZE - 1)];
    ++nodes;
    float tn;
    if (!bvh_ray_aabb(o, inv, node_min + 3 * (int64_t)node, node_max + 3 * (int64_t)node,
                      best_t, &tn)) {
      continue;
    }
    const int c0 = __ldg(child0 + node), c1 = __ldg(child1 + node);
    if (c0 < 0) {
      const int start = -(c0 + 1), count = -c1;
      for (int k = 0; k < MAX_LEAF && k < count; ++k) {
        const int pid = __ldg(prim_idx + min(start + k, n_prim_idx - 1));
        ++prims;
        float t, u, v;
        if (bvh_moeller_trumbore(o, d, p0 + 3 * (int64_t)pid, e1 + 3 * (int64_t)pid,
                                 e2 + 3 * (int64_t)pid, best_t, &t, &u, &v)) {
          best_t = t;
          best_prim = pid;
          best_u = u;
          best_v = v;
          if (ANY_HIT) break;
        }
      }
    } else {
      float tn0, tn1;
      bvh_ray_aabb(o, inv, node_min + 3 * (int64_t)c0, node_max + 3 * (int64_t)c0, best_t, &tn0);
      bvh_ray_aabb(o, inv, node_min + 3 * (int64_t)c1, node_max + 3 * (int64_t)c1, best_t, &tn1);
      const bool first = tn0 <= tn1;
      stack[min(sp, STACK_SIZE - 1)] = first ? c1 : c0;
      stack[min(sp + 1, STACK_SIZE - 1)] = first ? c0 : c1;
      sp += 2;
    }
  }
  out_t[r] = best_t;
  out_prim[r] = best_prim;
  out_u[r] = best_u;
  out_v[r] = best_v;
  counts[r] = nodes;
  counts[n + r] = prims;
}

// C entry points: (o (N, 3), d (N, 3), tmax (N,), N, node_min (Nn, 3),
// node_max (Nn, 3), child0 (Nn,), child1 (Nn,), prim_idx (T,), T,
// p0 (T, 3), e1, e2, out t, prim, u, v (N,), counts (2, N) int32 nodes
// popped and triangles tested, stream) -> cudaError_t.
template <bool ANY_HIT>
static int bvh_launch(const void* o, const void* d, const void* tmax, int n,
                      const void* node_min, const void* node_max, const void* child0,
                      const void* child1, const void* prim_idx, int n_prim_idx, const void* p0,
                      const void* e1, const void* e2, void* t, void* prim, void* u, void* v,
                      void* counts, void* stream) {
  if (n > 0) {
    bvh_kernel<ANY_HIT><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax, n, (const float*)node_min,
        (const float*)node_max, (const int*)child0, (const int*)child1, (const int*)prim_idx,
        n_prim_idx, (const float*)p0, (const float*)e1, (const float*)e2, (float*)t,
        (int*)prim, (float*)u, (float*)v, (int*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" int bvh_closest(const void* o, const void* d, const void* tmax, int n,
                           const void* node_min, const void* node_max, const void* child0,
                           const void* child1, const void* prim_idx, int n_prim_idx,
                           const void* p0, const void* e1, const void* e2, void* t, void* prim,
                           void* u, void* v, void* counts, void* stream) {
  return bvh_launch<false>(o, d, tmax, n, node_min, node_max, child0, child1, prim_idx,
                           n_prim_idx, p0, e1, e2, t, prim, u, v, counts, stream);
}

extern "C" int bvh_any(const void* o, const void* d, const void* tmax, int n,
                       const void* node_min, const void* node_max, const void* child0,
                       const void* child1, const void* prim_idx, int n_prim_idx, const void* p0,
                       const void* e1, const void* e2, void* t, void* prim, void* u, void* v,
                       void* counts, void* stream) {
  return bvh_launch<true>(o, d, tmax, n, node_min, node_max, child0, child1, prim_idx,
                          n_prim_idx, p0, e1, e2, t, prim, u, v, counts, stream);
}
