// Per-lane arithmetic shared by the CUDA kernels and by a host build.
//
// Every function here is __host__ __device__ and uses only IEEE float
// operations in a fixed order, so the same code compiled by g++ (with
// -ffp-contract=off) and by nvcc (with -fmad=false) gives the same bits.
// tests/test_torch_csrc_host.py compiles this header on the CPU behind the
// small C shim csrc/host_shim.cpp and checks it against the plain PyTorch
// versions in ops/fused_path.py, ops/intersect_tiled.py, ops/intersect_bvh.py
// and ops/intersect_twolevel.py.
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
// pg_mt_u is pg_mt_num, the division-free part (det, tvec and u's
// numerator), then pg_mt_u_of, the division and the range test.
// ---------------------------------------------------------------------------
PG_HD void pg_mt_num(float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
                     float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
                     float dy, float dz, float* tv, float* det, float* num) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  *det = (e1x * pvx + e1y * pvy) + e1z * pvz;
  tv[0] = ox - p0x;
  tv[1] = oy - p0y;
  tv[2] = oz - p0z;
  *num = (tv[0] * pvx + tv[1] * pvy) + tv[2] * pvz;
}

PG_HD bool pg_mt_u_of(float num, float det, float* inv_out, float* u_out) {
  const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  const float u = num * inv_det;
  *inv_out = inv_det;
  *u_out = u;
  return (inv_det != 0.0f) && (u >= 0.0f) && (u <= 1.0f);
}

PG_HD bool pg_mt_u(float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
                   float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
                   float dy, float dz, float* tv, float* inv_out, float* u_out) {
  float det, num;
  pg_mt_num(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy, dz, tv, &det, &num);
  return pg_mt_u_of(num, det, inv_out, u_out);
}

// ---------------------------------------------------------------------------
// A division-free reject in front of pg_mt_u_of: true only where
// pg_mt_u_of(num, det) is false, so a kernel may skip the division and
// everything after it wherever it holds.  It holds where A: fl(num det) < 0
// and |num| 2^64 >= |det| (the product by 2^64 is exact or +inf), or B:
// |num| > fl(|det| (1 + 2^-10)) (false where that overflows).  Proof, for
// every float num, det:
//   * |det| < 1e-12, det = +-inf or det NaN: inv_det is 0, +-0 or NaN, so
//     pg_mt_u_of is false whatever this returns.
//   * Else det is finite with |det| >= 1e-12, and inv_det = fl(1/det) has
//     det's sign and |inv_det| >= (1/|det|)(1 - 2^-22) (1/|det| >= 2^-128,
//     so even a subnormal inv_det is within 2^-149 of it).  A NaN num makes
//     A and B false; num = +-0 makes them false too.
//   * A: num and det are nonzero with opposite signs, and |num inv_det| >=
//     2^-64 (1 - 2^-22), far above the 2^-150 below which the product
//     would round to -0; so u = fl(num inv_det) < 0 (or -inf), and u >= 0
//     fails.
//   * B with opposite signs: |num| > |det| makes A hold too (above).  B
//     with equal signs: |num| / |det| > (1 + 2^-10)(1 - 2^-24), so the
//     exact product exceeds (1 + 2^-10)(1 - 2^-24)(1 - 2^-22) > 1 + 2^-11,
//     a float, and u = fl(num inv_det) >= 1 + 2^-11 > 1 (rounding is
//     monotone), so u <= 1 fails.  (Opposite signs whose product rounds to
//     -0 need |num det| < 2^-149, which with B gives |det| < 2^-74 < 1e-12,
//     the first case.)
// tests/test_torch_csrc_host.py checks it on 10^6 ray-triangle pairs and
// on the edge cases (|det| at 1e-12, num +-0, u exactly 0 and 1,
// underflowing products, infinities and NaN).
// ---------------------------------------------------------------------------
PG_HD bool pg_mt_surely_out(float num, float det) {
  const float an = fabsf(num), ad = fabsf(det);
  return (num * det < 0.0f && an * 18446744073709551616.0f >= ad) || an > ad * 1.0009765625f;
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
// The two stages with the loose test of bf16 pair data (ops/intersect_pairs.py
// loose_bounds: neg = -s, one = 1 + s, eps_lo = EPS_T (1 - s) as float32, s
// the slack): a hit has inv_det != 0, u >= neg, v >= neg, u + v <= one,
// t > eps_lo (and t < tmax one, the caller's).  The same operations in the
// same order as pg_mt_u and pg_mt_vt.  pg_mt_u_loose keeps the pairs with
// neg <= u <= u_hi, u_hi >= one - neg + 2^-8: a hit has v >= neg and
// fl(u + v) <= one, and u > u_hi would give u + v >= u + neg > one + 2^-8
// (exactly), above the float after one, so fl(u + v) > one (rounding is
// monotone); so the first stage drops no pair the whole test admits.
// ---------------------------------------------------------------------------
PG_HD bool pg_mt_u_loose(float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
                         float e2x, float e2y, float e2z, float ox, float oy, float oz,
                         float dx, float dy, float dz, float neg, float u_hi, float* tv,
                         float* inv_out, float* u_out) {
  float det, num;
  pg_mt_num(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy, dz, tv, &det, &num);
  const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  const float u = num * inv_det;
  *inv_out = inv_det;
  *u_out = u;
  return (inv_det != 0.0f) && (u >= neg) && (u <= u_hi);
}

PG_HD bool pg_mt_vt_loose(float e1x, float e1y, float e1z, float e2x, float e2y, float e2z,
                          float dx, float dy, float dz, const float* tv, float inv_det, float u,
                          float neg, float one, float eps_lo, float* t_out) {
  const float qvx = tv[1] * e1z - tv[2] * e1y;
  const float qvy = tv[2] * e1x - tv[0] * e1z;
  const float qvz = tv[0] * e1y - tv[1] * e1x;
  const float v = ((dx * qvx + dy * qvy) + dz * qvz) * inv_det;
  const float t = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
  *t_out = t;
  return (inv_det != 0.0f) && (u >= neg) && (v >= neg) && (u + v <= one) && (t > eps_lo);
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

// 16-byte words of the records that kernels read from shared or global memory
#ifdef __CUDACC__
typedef float4 pg_f4;
#else
struct pg_f4 {
  float x, y, z, w;
};
#endif

// ---------------------------------------------------------------------------
// The tile walk of csrc/intersect_twolevel.cu, per ray (ops/intersect_twolevel.py
// twolevel_plain; the reference is mitsuba_path_guiding_tpu/ops/
// intersect_twolevel.py _kernel).
//   box: a superblock's 64 block boxes, each as 8 floats (2 x 16 bytes):
//     lo x, y, z, hi x, y, z and two unused words (pg_tl_box_word).
//   pg_tl_gate: the reference's gate of one ray and block, the box's slab
//     entry tn (clamped at 0) and exit tf, open when tf >= tn and
//     tn <= cur, the ray's best t so far.
//   pg_tl_candidates: the 64 gates of one superblock at one cur, as a bit
//     mask.  tn and tf do not depend on cur, and cur never grows along the
//     walk (a block's winner replaces it only when strictly nearer), so a
//     gate that passes at the current cur passed at the cur the ray had
//     when the walk entered the superblock: the mask taken there holds
//     every block whose gate can still pass (a NaN tn fails both).
//   Records: a block's triangle j as 12 words (3 x 16 bytes), p0, e1, e2,
//     the original id (-1 for padding) and two unused words; word r < 10
//     is row r of the superblock's pack (S, 16, 8192) at column 128 k + j
//     (pg_tl_record_word).
//   The test of one record runs in three stages, each only where some lane
//     of the warp passed the one before: pg_tl_num and pg_mt_surely_out
//     (division-free), pg_mt_u_of, then pg_tl_take (pg_mt_vt and the block
//     winner's update in pg_nearer order: least t, then least id, over
//     ascending records).  Together they are pg_mt_test's hit, since
//     pg_mt_vt's condition implies pg_mt_u's.  A winner keeps t, id and its
//     record; pg_tl_uv gives its u and v again from the record by the same
//     operations, so with the same bits, and adds 0, which turns -0 into +0
//     as the reference's one-hot sums do.
//   pg_tl_merge: across blocks only a strictly nearer t replaces the best,
//     which keeps the winner's place in the pack, s 8192 + 128 k + q.
// ---------------------------------------------------------------------------
#define PG_TL_BLOCKS 64
#define PG_TL_TRIS 128
#define PG_TL_SB_TRIS (PG_TL_BLOCKS * PG_TL_TRIS)
#define PG_TL_WORDS 10  // words of a record taken from the pack

struct pg_tl_win {
  float t, id;
  int q;
};

// 1 / d with |d| < 1e-12 replaced by +1e-12 (the sign is lost)
PG_HD float pg_tl_inv(float d) { return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d); }

// word e < 384 of a superblock's box staging: its place in the boxes and,
// for blk_lo (lo) or blk_hi, in that (3, bpad) table
PG_HD void pg_tl_box_word(int e, int s, int bpad, int* dst, bool* lo, int64_t* src) {
  const int r = e / PG_TL_BLOCKS, k = e % PG_TL_BLOCKS;
  *dst = 8 * k + r;
  *lo = r < 3;
  *src = (int64_t)(r % 3) * bpad + (int64_t)s * PG_TL_BLOCKS + k;
}

PG_HD bool pg_tl_gate(const pg_f4* box, int k, const float* o, const float* inv, float cur) {
  const pg_f4 a = box[2 * k], b = box[2 * k + 1];  // lo x y z, hi x | hi y z - -
  const float tx0 = (a.x - o[0]) * inv[0], tx1 = (a.w - o[0]) * inv[0];
  const float ty0 = (a.y - o[1]) * inv[1], ty1 = (b.x - o[1]) * inv[1];
  const float tz0 = (a.z - o[2]) * inv[2], tz1 = (b.y - o[2]) * inv[2];
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fmaxf(fminf(tz0, tz1), 0.0f));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tf >= tn && tn <= cur;
}

PG_HD uint64_t pg_tl_candidates(const pg_f4* box, const float* o, const float* inv, float cur) {
  uint32_t lo = 0, hi = 0;
#pragma unroll 1
  for (int k = 0; k < 32; ++k) {
    lo |= (uint32_t)pg_tl_gate(box, k, o, inv, cur) << k;
    hi |= (uint32_t)pg_tl_gate(box, 32 + k, o, inv, cur) << k;
  }
  return ((uint64_t)hi << 32) | lo;
}

// word e < 1280 of block k's staging: its place in the records and in the
// superblock's pack
PG_HD void pg_tl_record_word(int e, int k, int* dst, int* src) {
  const int r = e / PG_TL_TRIS, j = e % PG_TL_TRIS;
  *dst = 12 * j + r;
  *src = r * PG_TL_SB_TRIS + k * PG_TL_TRIS + j;
}

// pg_mt_num of one record (a: p0 e1x, b: e1y e1z e2x e2y, c: e2z id - -)
PG_HD void pg_tl_num(pg_f4 a, pg_f4 b, pg_f4 c, const float* o, const float* d, float* tv,
                     float* det, float* num) {
  pg_mt_num(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, o[0], o[1], o[2], d[0], d[1], d[2], tv,
            det, num);
}

PG_HD void pg_tl_take(pg_f4 a, pg_f4 b, pg_f4 c, int q, bool may, const float* d,
                      const float* tv, float inv_det, float u, pg_tl_win* w) {
  float t, v;
  const bool hit = pg_mt_vt(a.w, b.x, b.y, b.z, b.w, c.x, d[0], d[1], d[2], tv, inv_det, u, &t,
                            &v);
  if (may && hit && c.y >= 0.0f && pg_nearer(t, c.y, w->t, w->id)) {
    w->t = t;
    w->id = c.y;
    w->q = q;
  }
}

PG_HD void pg_tl_uv(pg_f4 a, pg_f4 b, pg_f4 c, const float* o, const float* d, float* u,
                    float* v) {
  float tv[3], det, num, inv_det, t;
  pg_tl_num(a, b, c, o, d, tv, &det, &num);
  pg_mt_u_of(num, det, &inv_det, u);
  pg_mt_vt(a.w, b.x, b.y, b.z, b.w, c.x, d[0], d[1], d[2], tv, inv_det, *u, &t, v);
  *u = *u + 0.0f;
  *v = *v + 0.0f;
}

// the record of the triangle at column `col` of a superblock's pack
// (S, 16, 8192), from device or host memory
PG_HD void pg_tl_pack_record(const float* pack, int col, pg_f4* a, pg_f4* b, pg_f4* c) {
  const float* p = pack + col;
  const int S = PG_TL_SB_TRIS;
  a->x = p[0];
  a->y = p[S];
  a->z = p[2 * S];
  a->w = p[3 * S];
  b->x = p[4 * S];
  b->y = p[5 * S];
  b->z = p[6 * S];
  b->w = p[7 * S];
  c->x = p[8 * S];
  c->y = p[9 * S];
  c->z = c->w = 0.0f;
}

PG_HD void pg_tl_merge(const pg_tl_win* w, int base, float* best_t, int* best_pos) {
  if (w->t < *best_t) {
    *best_t = w->t;
    *best_pos = base + w->q;
  }
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
