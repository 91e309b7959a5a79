// Per-lane arithmetic shared by the CUDA kernels and by a host build.
//
// Every function here is __host__ __device__ and uses only IEEE float
// operations in a fixed order, so the same code compiled by g++ (with
// -ffp-contract=off) and by nvcc (with -fmad=false) gives the same bits.
// tests/test_torch_csrc_host.py compiles this header on the CPU behind the
// small C shim csrc/host_shim.cpp and checks it against the plain PyTorch
// versions in ops/fused_path.py, ops/intersect_tiled.py and
// ops/intersect_bvh.py.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PG_HD __host__ __device__ __forceinline__
#else
#define PG_HD static inline
#endif

#define PG_EPS_T 1e-4f
#define PG_INF_BITS 0x7F800000u

PG_HD uint32_t pg_f2u(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

PG_HD float pg_u2f(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// ---------------------------------------------------------------------------
// Threefry-2x32 (Salmon et al. 2011) at ROUNDS rounds: the key schedule of
// mitsuba_path_guiding_tpu/ops/fused_path.py threefry2x32, including the
// key injection after a partial last group (13 rounds = 3 groups of 4 + 1).
// ---------------------------------------------------------------------------
PG_HD uint32_t pg_rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

template <int ROUNDS>
PG_HD void pg_threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                           uint32_t* y0, uint32_t* y1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int d = 0; d < (ROUNDS + 3) / 4; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < ROUNDS - 4 * d) {
        x0 += x1;
        x1 = pg_rotl(x1, rot[(d % 2) * 4 + i]) ^ x0;
      }
    }
    x0 += ks[(d + 1) % 3];
    x1 += ks[(d + 2) % 3] + (uint32_t)(d + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// uint32 -> float in [0, 1): 23 mantissa bits under exponent 0, minus one
PG_HD float pg_bits_to_unit(uint32_t bits) {
  return pg_u2f(0x3F800000u | (bits >> 9)) - 1.0f;
}

// ---------------------------------------------------------------------------
// Pluecker ray/triangle candidate test of fused_path.py _intersect_mxu for
// one triangle.  c points at the triangle's 25 packed coefficients:
//   c[0:6]   edge v0->v1: (a x b, b - a)     s0 = c0 d + c1 m
//   c[6:12]  edge v1->v2                      s1
//   c[12:18] edge v2->v0                      s2
//   c[18:22] plane: (-n, n.v0)                num = c18 o + c21
//   c[22:25] n                                den = n.d
// with m = o x d.  Returns whether the candidate hits and its t.
// ---------------------------------------------------------------------------
PG_HD float pg_side(const float* c, const float* d, const float* m) {
  return ((((c[0] * d[0] + c[1] * d[1]) + c[2] * d[2]) + c[3] * m[0]) + c[4] * m[1]) + c[5] * m[2];
}

PG_HD bool pg_plucker_hit(const float* c, const float* o, const float* d,
                          const float* m, float tmax, bool any_hit, float* t_out) {
  const float s0 = pg_side(c + 0, d, m);
  const float s1 = pg_side(c + 6, d, m);
  const float s2 = pg_side(c + 12, d, m);
  const float num = ((c[18] * o[0] + c[19] * o[1]) + c[20] * o[2]) + c[21];
  const float den = (c[22] * d[0] + c[23] * d[1]) + c[24] * d[2];
  const float smin = fminf(fminf(s0, s1), s2);
  const float smax = fmaxf(fmaxf(s0, s1), s2);
  bool inside;
  if (any_hit) {
    inside = (smin >= 0.0f) || (smax <= 0.0f);
  } else {
    const float eps = 1e-6f * ((fabsf(s0) + fabsf(s1)) + fabsf(s2));
    inside = (smin >= -eps) || (smax <= eps);
  }
  const bool ok_den = den != 0.0f;
  const float t = num / (ok_den ? den : 1.0f);
  *t_out = t;
  return inside && ok_den && (t > PG_EPS_T) && (t < tmax);
}

// ---------------------------------------------------------------------------
// pg_plucker_hit in two stages, each with the same operations in the same
// order: pg_plucker_inside, the edge sides from c[0:18], says whether the
// ray passes inside the triangle; pg_plucker_depth, the plane distance and
// its division from c[18:25], gives t and the range test.  Their AND is
// pg_plucker_hit, so a kernel may skip the second stage wherever the first
// failed (the fused kernel does, for a triangle no lane of a warp is in).
// ---------------------------------------------------------------------------
PG_HD bool pg_plucker_inside(const float* c, const float* d, const float* m, bool any_hit) {
  const float s0 = pg_side(c + 0, d, m);
  const float s1 = pg_side(c + 6, d, m);
  const float s2 = pg_side(c + 12, d, m);
  const float smin = fminf(fminf(s0, s1), s2);
  const float smax = fmaxf(fmaxf(s0, s1), s2);
  if (any_hit) return (smin >= 0.0f) || (smax <= 0.0f);
  const float eps = 1e-6f * ((fabsf(s0) + fabsf(s1)) + fabsf(s2));
  return (smin >= -eps) || (smax <= eps);
}

PG_HD bool pg_plucker_depth(const float* c, const float* o, const float* d, float tmax,
                            float* t_out) {
  const float num = ((c[18] * o[0] + c[19] * o[1]) + c[20] * o[2]) + c[21];
  const float den = (c[22] * d[0] + c[23] * d[1]) + c[24] * d[2];
  const bool ok_den = den != 0.0f;
  const float t = num / (ok_den ? den : 1.0f);
  *t_out = t;
  return ok_den && (t > PG_EPS_T) && (t < tmax);
}

// packed winner key: the low `bits` mantissa bits of t carry the triangle
// id (t > EPS_T > 0, so integer order is float order); INF for a miss
PG_HD uint32_t pg_packed_key(bool hit, float t, uint32_t tid, uint32_t lo_mask) {
  const uint32_t tb = hit ? pg_f2u(t) : PG_INF_BITS;
  return (tb & ~lo_mask) | tid;
}

// ---------------------------------------------------------------------------
// 64-bit merge key of the blocklist kernel: t bits (t > EPS_T > 0, so their
// integer order is float order), the block index (5 bits), the triangle id
// (27 bits; ids are exact floats below 2^24).  Integer order is the
// lexicographic order of (t, block, id).  A miss is the key of (3e38, 31,
// the largest id): it orders after every hit at or below 3e38, and its t
// is the plain version's INF, which no best t exceeds.
// ---------------------------------------------------------------------------
#define PG_KEY_MISS ((0x7F61B1E6ull << 32) | (31ull << 27) | 0x7FFFFFFull)

PG_HD uint64_t pg_block_key(float t, uint32_t block, uint32_t tid) {
  return ((uint64_t)pg_f2u(t) << 32) | ((uint64_t)block << 27) | tid;
}

PG_HD float pg_key_t(uint64_t key) { return pg_u2f((uint32_t)(key >> 32)); }

PG_HD uint32_t pg_key_block(uint64_t key) { return (uint32_t)(key >> 27) & 31u; }

PG_HD uint32_t pg_key_tid(uint64_t key) { return (uint32_t)key & 0x7FFFFFFu; }

// ---------------------------------------------------------------------------
// Moeller-Trumbore re-evaluation of the winning triangle (fused_path.py
// _mt_exact).  tri: p0, e1, e2 (9 floats).
// ---------------------------------------------------------------------------
PG_HD void pg_cross(const float* a, const float* b, float* r) {
  r[0] = a[1] * b[2] - a[2] * b[1];
  r[1] = a[2] * b[0] - a[0] * b[2];
  r[2] = a[0] * b[1] - a[1] * b[0];
}

PG_HD float pg_dot(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

PG_HD void pg_mt_exact(const float* tri, const float* o, const float* d,
                       float* t, float* u, float* v) {
  float pvec[3], tvec[3], qvec[3];
  pg_cross(d, tri + 6, pvec);
  const float det = pg_dot(tri + 3, pvec);
  const float inv = 1.0f / (fabsf(det) < 1e-20f ? 1.0f : det);
  tvec[0] = o[0] - tri[0];
  tvec[1] = o[1] - tri[1];
  tvec[2] = o[2] - tri[2];
  *u = pg_dot(tvec, pvec) * inv;
  pg_cross(tvec, tri + 3, qvec);
  *v = pg_dot(d, qvec) * inv;
  *t = pg_dot(tri + 6, qvec) * inv;
}

// ---------------------------------------------------------------------------
// Dense Moeller-Trumbore of intersect_pallas.py _kernel / traverse.py
// _mt_components for one (ray, triangle): p0, e1, e2 as scalars.
// ---------------------------------------------------------------------------
PG_HD bool pg_mt_test(float p0x, float p0y, float p0z, float e1x, float e1y,
                      float e1z, float e2x, float e2y, float e2z, float ox,
                      float oy, float oz, float dx, float dy, float dz,
                      float* t_out, float* u_out, float* v_out) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
  const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = ((dx * qvx + dy * qvy) + dz * qvz) * inv_det;
  const float t = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return (inv_det != 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > PG_EPS_T);
}

// ---------------------------------------------------------------------------
// pg_mt_test in two stages, each with the same operations in the same
// order.  pg_mt_u computes u and what the second stage needs (tvec and
// 1/det) and returns whether the pair can still hit: inv_det != 0 and
// 0 <= u <= 1 (a hit has v >= 0 and fl(u + v) <= 1, and fl(u + v) >= u,
// so it has u <= 1).  pg_mt_vt then gives v and t and pg_mt_test's whole
// hit condition.  A kernel may skip pg_mt_vt wherever pg_mt_u failed.
// ---------------------------------------------------------------------------
PG_HD bool pg_mt_u(float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
                   float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
                   float dy, float dz, float* tv, float* inv_out, float* u_out) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
  const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  tv[0] = ox - p0x;
  tv[1] = oy - p0y;
  tv[2] = oz - p0z;
  const float u = ((tv[0] * pvx + tv[1] * pvy) + tv[2] * pvz) * inv_det;
  *inv_out = inv_det;
  *u_out = u;
  return (inv_det != 0.0f) && (u >= 0.0f) && (u <= 1.0f);
}

PG_HD bool pg_mt_vt(float e1x, float e1y, float e1z, float e2x, float e2y, float e2z,
                    float dx, float dy, float dz, const float* tv, float inv_det, float u,
                    float* t_out, float* v_out) {
  const float qvx = tv[1] * e1z - tv[2] * e1y;
  const float qvy = tv[2] * e1x - tv[0] * e1z;
  const float qvz = tv[0] * e1y - tv[1] * e1x;
  const float v = ((dx * qvx + dy * qvy) + dz * qvz) * inv_det;
  const float t = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
  *t_out = t;
  *v_out = v;
  return (inv_det != 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > PG_EPS_T);
}

// ---------------------------------------------------------------------------
// The order of every closest-hit merge: the lesser t, and among equal t the
// lesser triangle id.  On distinct ids it is a total order, so partial
// winners merged in any grouping give the winner of one pass over the
// triangles in ascending id that replaces its best only with a strictly
// nearer hit (the Pallas kernels' per-tile minimum and strict merge).
// ---------------------------------------------------------------------------
template <typename I>
PG_HD bool pg_nearer(float t, I id, float bt, I bid) {
  return t < bt || (t == bt && id < bid);
}

// ---------------------------------------------------------------------------
// Shared-memory records, built by one thread per triangle and read back as
// float4 words.
//   pg_tiled_record: triangle j of intersect_tiled's (12, tpad) pack
//     (ops/intersect_tiled.py pack_triangles): p0, e1, e2 and three zeros
//     (12 words).
//   pg_plk_record: triangle i of one Pluecker pair block, from its tri_cols
//     (16, 5 * 128) and tri_rows (10, 128): the 25 coefficients in
//     pg_plucker_hit's order (ops/intersect_pairs.py plk_coeffs), the id
//     (row 9 of tri_rows, -1 for padding) and two zeros (28 words).
// PG_TILED_LANES is the lanes of intersect_tiled.cu that share one ray.
// ---------------------------------------------------------------------------
#define PG_TILED_LANES 4
#define PG_PAIR_LEAF 128

PG_HD void pg_tiled_record(const float* pack, int tpad, int j, float* r) {
#pragma unroll
  for (int c = 0; c < 9; ++c) r[c] = pack[(int64_t)c * tpad + j];
  r[9] = r[10] = r[11] = 0.0f;
}

PG_HD void pg_plk_record(const float* cols, const float* rows, int i, float* r) {
  const int w = 5 * PG_PAIR_LEAF;  // a row of tri_cols: five groups of 128 columns
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int f = 0; f < 6; ++f) r[6 * g + f] = cols[f * w + g * PG_PAIR_LEAF + i];
#pragma unroll
  for (int f = 0; f < 4; ++f) r[18 + f] = cols[(6 + f) * w + 3 * PG_PAIR_LEAF + i];
#pragma unroll
  for (int f = 0; f < 3; ++f) r[22 + f] = cols[f * w + 4 * PG_PAIR_LEAF + i];
  r[25] = rows[9 * PG_PAIR_LEAF + i];
  r[26] = r[27] = 0.0f;
}

// ---------------------------------------------------------------------------
// The BVH walk of csrc/intersect_bvh.cu for one ray (traverse.py
// intersect_bvh, with each box tested once, at its parent), over the packed
// layout of accel/bvh.py pack_bvh:
//   nodes: records of 16 words (4 x 16 bytes).  Record 0 holds the root's
//     box (words 0:6, lo then hi) and its reference (word 12); record k >= 1
//     is an inner node: child 0's box (0:6), child 1's box (6:12), their
//     references (12, 13).  A reference r >= 1 is an inner node's record; a
//     leaf is r = -(8 * start + count), its count (<= 4) triangles from
//     `start` of
//   tris: records of 12 words (3 x 16 bytes) in leaf order: p0, e1, e2 and
//     the original triangle id (int bits, word 9).
// Integers travel as float bits.
// ---------------------------------------------------------------------------
#ifdef __CUDACC__
typedef float4 pg_f4;
#else
struct pg_f4 {
  float x, y, z, w;
};
#endif

PG_HD pg_f4 pg_ld4(const pg_f4* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

PG_HD int pg_f2i(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}

#define PG_BVH_STACK 48
#define PG_BVH_MAX_LEAF 4
#define PG_BVH_INF 3.0e38f

PG_HD float pg_bvh_safe_rcp(float x) {
  return (x >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(x), 1e-20f);
}

// traverse.py _ray_aabb for one ray and box (lo, hi): the hit against
// tmax, and t_near in *tn_out.  tn and tf do not depend on tmax.
PG_HD bool pg_bvh_ray_aabb(const float* o, const float* inv, const float* lo, const float* hi,
                           float tmax, float* tn_out) {
  float l[3], h[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool parallel = fabsf(inv[a]) >= 1e19f;
    const bool inside = o[a] >= lo[a] && o[a] <= hi[a];
    const float t0 = (lo[a] - o[a]) * inv[a];
    const float t1 = (hi[a] - o[a]) * inv[a];
    l[a] = parallel ? (inside ? -PG_BVH_INF : PG_BVH_INF) : fminf(t0, t1);
    h[a] = parallel ? (inside ? PG_BVH_INF : -PG_BVH_INF) : fmaxf(t0, t1);
  }
  const float tn = fmaxf(fmaxf(l[0], l[1]), l[2]);
  const float tf = fminf(fminf(h[0], h[1]), h[2]);
  *tn_out = tn;
  return tf >= fmaxf(tn, 0.0f) && tn <= tmax;
}

// traverse.py moeller_trumbore on a triangle record (a, b, c): safe_rcp(det)
// and |det| > 1e-12, which pg_mt_test (inv_det 0 below 1e-12) does not
// share.
PG_HD bool pg_bvh_mt(const float* o, const float* d, pg_f4 a, pg_f4 b, pg_f4 c, float tmax,
                     float* t_out, float* u_out, float* v_out) {
  const float p0x = a.x, p0y = a.y, p0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = d[1] * e2z - d[2] * e2y;
  const float pvy = d[2] * e2x - d[0] * e2z;
  const float pvz = d[0] * e2y - d[1] * e2x;
  const float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
  const float inv_det = pg_bvh_safe_rcp(det);
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

struct pg_bvh_result {
  float t, u, v;
  int prim, boxes, tris;
};

struct alignas(8) pg_bvh_entry {
  int ref;
  float tn;
};

// One ray's walk.  The root's box is tested first, against tmax.  A
// popped entry whose entry distance tn exceeds the best t so far is
// dropped; a leaf tests its triangles in order (EPS_T < t < best t, so a
// tie stays with the triangle found first); an inner node slab-tests both
// children against the best t, orders them by tn0 <= tn1 (near first) and
// pushes the far child if its test passed, then the near one if its test
// passed, each with its tn.  Any-hit stops at the first hit.  The entry
// pushed last, the next one popped, stays in registers (`top`): the near
// child goes on at once, and only the far one goes to `stack`.
//
// This visits the leaves of the walk that pushes both children and tests
// each box when it pops it (the reference's), in the same order: tn and tf
// do not depend on tmax; the test passes at a smaller tmax only if it
// passes at a larger one; and the best t never grows.  So a child dropped
// at its parent would fail its own test at its pop, and a pushed child
// passes at its pop exactly when tn <= best t then.  Hence t, prim, u and v
// keep their bits.  Counts: boxes tested (1 for the root, 2 an inner node
// expanded) and triangles tested; on a closest-hit walk, which pops every
// node it pushes, the box count equals the reference's nodes popped.
template <bool ANY_HIT>
PG_HD pg_bvh_result pg_bvh_walk(const pg_f4* nodes, const pg_f4* tris, int n_tris,
                                const float* o, const float* d, float tmax,
                                pg_bvh_entry* stack) {
  const float inv[3] = {pg_bvh_safe_rcp(d[0]), pg_bvh_safe_rcp(d[1]), pg_bvh_safe_rcp(d[2])};
  pg_bvh_result r = {tmax, 0.0f, 0.0f, -1, 1, 0};
  pg_bvh_entry top;
  bool has_top;
  {
    const pg_f4 w0 = pg_ld4(nodes), w1 = pg_ld4(nodes + 1), w3 = pg_ld4(nodes + 3);
    const float lo[3] = {w0.x, w0.y, w0.z}, hi[3] = {w0.w, w1.x, w1.y};
    has_top = pg_bvh_ray_aabb(o, inv, lo, hi, tmax, &top.tn);
    top.ref = pg_f2i(w3.x);
  }
  int sp = 0;
  while ((has_top || sp > 0) && (!ANY_HIT || r.prim < 0)) {
    pg_bvh_entry e = top;
    if (!has_top) {
      --sp;
      e = stack[sp < PG_BVH_STACK - 1 ? sp : PG_BVH_STACK - 1];
    }
    has_top = false;
    if (e.tn > r.t) continue;
    if (e.ref <= 0) {
      const int start = (-e.ref) >> 3, count = (-e.ref) & 7;
      for (int k = 0; k < PG_BVH_MAX_LEAF && k < count; ++k) {
        const int j = start + k < n_tris - 1 ? start + k : n_tris - 1;
        const pg_f4* rec = tris + 3 * (int64_t)j;
        const pg_f4 a = pg_ld4(rec), b = pg_ld4(rec + 1), c = pg_ld4(rec + 2);
        ++r.tris;
        float t, u, v;
        if (pg_bvh_mt(o, d, a, b, c, r.t, &t, &u, &v)) {
          r.t = t;
          r.u = u;
          r.v = v;
          r.prim = pg_f2i(c.y);
          if (ANY_HIT) break;
        }
      }
    } else {
      const pg_f4* rec = nodes + 4 * (int64_t)e.ref;
      const pg_f4 w0 = pg_ld4(rec), w1 = pg_ld4(rec + 1), w2 = pg_ld4(rec + 2),
                  w3 = pg_ld4(rec + 3);
      const float lo0[3] = {w0.x, w0.y, w0.z}, hi0[3] = {w0.w, w1.x, w1.y};
      const float lo1[3] = {w1.z, w1.w, w2.x}, hi1[3] = {w2.y, w2.z, w2.w};
      float tn0, tn1;
      const bool h0 = pg_bvh_ray_aabb(o, inv, lo0, hi0, r.t, &tn0);
      const bool h1 = pg_bvh_ray_aabb(o, inv, lo1, hi1, r.t, &tn1);
      r.boxes += 2;
      const int ref0 = pg_f2i(w3.x), ref1 = pg_f2i(w3.y);
      const bool first = tn0 <= tn1;
      if (first ? h1 : h0) {
        const pg_bvh_entry far_e = {first ? ref1 : ref0, first ? tn1 : tn0};
        stack[sp < PG_BVH_STACK - 1 ? sp : PG_BVH_STACK - 1] = far_e;
        ++sp;
      }
      has_top = first ? h0 : h1;
      top.ref = first ? ref0 : ref1;
      top.tn = first ? tn0 : tn1;
    }
  }
  return r;
}
