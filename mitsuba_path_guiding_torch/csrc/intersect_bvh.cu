// intersect_bvh: closest-hit (or any-hit) stack traversal of a binary BVH,
// one thread per ray.
//
// Replaces mitsuba_path_guiding_tpu/accel/traverse.py intersect_bvh, a
// vmapped lax.while_loop over a 48-entry stack (not a Pallas kernel; no
// plain tensor program walks a per-ray stack at a usable speed).
//
// Bound: a per-ray walk of data-dependent length, latency-bound on the
// dependent loads of each node.  The least work is the boxes and triangles
// this run's rays test: per box ~23 FP32 operations, per triangle ~47.
// Design: the walk of device_math.cuh pg_bvh_walk (its note proves that it
// gives the reference's t, prim, u and v bit for bit): each box is tested
// once, at its parent, and a child whose box fails is never pushed, where
// the reference pushes both children and tests each box again when it
// pops it (three box tests per inner node and a pop per child that misses,
// now two tests and no pop).  The tree comes packed (accel/bvh.py
// pack_bvh): an inner node is one 64-byte record holding both children's
// boxes and references, read as 4 x LDG.128; a leaf's triangles are
// 48-byte records in leaf order, read as 3 x LDG.128 with no prim_idx
// indirection.  The stack holds (reference, tn) pairs, 8 bytes each: the
// entry pushed last (the near child) stays in registers and goes on at
// once, the rest in local memory; the scene compiler checks the tree's
// depth against it.  Tried on an H100 and left out, since neither paid:
// Möller-Trumbore computing v and t only where u is in range (0-7% slower
// on any-hit waves), and persistent warps refilled from a ray counter
// (20-26% slower: a 131072-ray wave is resident on the card at once).
// Each thread writes its ray's work: boxes tested and triangles tested.
//
// Build: ops/build.py, nvcc -fmad=false, so the arithmetic is that of
// bvh_plain (dot products summed as ((x0 y0 + x1 y1) + x2 y2)).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
bvh_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ tmax, int n, const float4* __restrict__ nodes,
           const float4* __restrict__ tris, int n_tris, float* __restrict__ out_t,
           int* __restrict__ out_prim, float* __restrict__ out_u, float* __restrict__ out_v,
           int* __restrict__ counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float o[3] = {ro[3 * (int64_t)r], ro[3 * (int64_t)r + 1], ro[3 * (int64_t)r + 2]};
  const float d[3] = {rd[3 * (int64_t)r], rd[3 * (int64_t)r + 1], rd[3 * (int64_t)r + 2]};
  pg_bvh_entry stack[PG_BVH_STACK];
  const pg_bvh_result h = pg_bvh_walk<ANY_HIT>(nodes, tris, n_tris, o, d, tmax[r], stack);
  out_t[r] = h.t;
  out_prim[r] = h.prim;
  out_u[r] = h.u;
  out_v[r] = h.v;
  counts[r] = h.boxes;
  counts[n + r] = h.tris;
}

// C entry points: (o (N, 3), d (N, 3), tmax (N,), N, nodes (NI + 1, 16)
// f32, tris (T, 12) f32, T, out t, prim, u, v (N,), counts (2, N) int32
// boxes tested and triangles tested, stream) -> cudaError_t.  The two
// tables must be 16-byte aligned.
template <bool ANY_HIT>
static int bvh_launch(const void* o, const void* d, const void* tmax, int n, const void* nodes,
                      const void* tris, int n_tris, void* t, void* prim, void* u, void* v,
                      void* counts, void* stream) {
  if (((uintptr_t)nodes | (uintptr_t)tris) & 15) return (int)cudaErrorMisalignedAddress;
  if (n > 0) {
    bvh_kernel<ANY_HIT><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax, n, (const float4*)nodes,
        (const float4*)tris, n_tris, (float*)t, (int*)prim, (float*)u, (float*)v,
        (int*)counts);
  }
  return (int)cudaGetLastError();
}

// the words of one node record and of one triangle record, for the
// wrapper to check the layout it packs against
extern "C" int bvh_record_words(int which) { return which == 0 ? 16 : 12; }

extern "C" int bvh_closest(const void* o, const void* d, const void* tmax, int n,
                           const void* nodes, const void* tris, int n_tris, void* t, void* prim,
                           void* u, void* v, void* counts, void* stream) {
  return bvh_launch<false>(o, d, tmax, n, nodes, tris, n_tris, t, prim, u, v, counts, stream);
}

extern "C" int bvh_any(const void* o, const void* d, const void* tmax, int n, const void* nodes,
                       const void* tris, int n_tris, void* t, void* prim, void* u, void* v,
                       void* counts, void* stream) {
  return bvh_launch<true>(o, d, tmax, n, nodes, tris, n_tris, t, prim, u, v, counts, stream);
}
