// trace_fused: the whole bounce loop of a guided (or unguided) path
// tracer, one ray per lane at a time, for small diffuse scenes with area
// lights.
//
// Replaces the Pallas megakernel mitsuba_path_guiding_tpu/ops/fused_path.py
// (_make_kernel via trace_fused).  On the TPU every per-lane fetch is a
// one-hot MXU matmul and the closest hit one (TILE, 16) x (16, 5T)
// Pluecker matmul; here each thread runs the same arithmetic as scalar
// FP32 code on the CUDA cores (no TF32/bf16 products: the bf16 guide table
// is widened exactly, never multiplied in reduced precision).
//
// Bound: operations.  A bounce tests every triangle for the closest hit
// and, up to the first occluder, for the shadow ray, ~50 FP32 operations
// per test, while a lane moves 96 bytes in and out for the whole path;
// everything in between stays in registers.  Design:
//   * persistent blocks, as many as fit on the card at once: the scene's
//     tables are staged once per block in dynamic shared memory, and a
//     warp whose lane ends its path (an escape, a zero throughput, roulette
//     or the last bounce) writes that ray's rows and takes the next ray
//     from a global counter, one atomic per warp, so warps stay full while
//     paths end at different depths;
//   * the 25 Pluecker coefficients of a triangle sit in shared memory as
//     six float4 (0:24) and one float (24), 25 floats as in the global
//     table, so the largest supported scene (2048 triangles, 200 KB) still
//     fits; a test reads five LDS.128 for its edge sides
//     (device_math.cuh pg_plucker_inside) and, only when some lane of the
//     warp passes inside the triangle (a vote), one LDS.128 and one LDS.32
//     for the plane distance and its IEEE division (pg_plucker_depth): a
//     lane that is not inside never takes that t;
//   * a guided lane's mixture lives in the lane's own columns of shared
//     memory (mu_x, mu_y, mu_z and kappa as packed bf16, 16 words, and the
//     8 normalised weights: 12 KB a block), not in registers; the sampled
//     lobe is picked by an unrolled compare-and-select, not a dynamic
//     index, so nothing goes to local memory;
//   * the mixture is used up (both mixture pdfs and the guided direction)
//     before the shadow ray's loop, which then carries only the radiance
//     with the light seen and with it occluded and the next segment; each
//     pair of uniforms is drawn where it is first used and each value of
//     the shading row where it is needed, and the first-hit rows are
//     written at the first hit, so a lane carries only o, d, throughput,
//     radiance, the last pdf, its key and counts: six 128-thread blocks an
//     SM (24 warps) fit in 80 registers.
// Each lane's arithmetic is the same, in the same order, whatever ray it
// runs next, so every ray's rows have the same bits in any schedule.
// Launches of this kernel on one device run one at a time (the ray counter
// is one per device; the port launches on one stream).
// Bits that match the plain version (ops/fused_path.py trace_fused_plain):
// 13-round threefry on the (depth, block) counters under the per-ray key,
// the Pluecker side test with its 1e-6 sum|s| slack, the packed-key winner
// whose low ceil(log2 Tpad) mantissa bits carry the triangle id, the exact
// MT re-evaluation, the CDF emitter pick (pad rows carry cdf 2.0) and the
// vMF pdf with 1 - exp.  Sums run in the plain version's order and the
// build disables FMA contraction.
// Output rows (16, N): 0:3 L, 3:6 first-hit albedo, 6:9 normal, 9 depth,
// 10 bounces, 11:14 first-hit emission; rows 14 and 15 (zero padding in
// the TPU kernel) count this lane's work: the closest-hit loops it entered
// and the triangles its shadow rays tested, from which a run counts the
// operations the kernel did.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_math.cuh"

#define BLOCK 128
#define K 8
#define PLK 25
#define PLK_VEC 6  // float4s of a triangle's coefficients 0:24 in shared memory
#define INFD 3.0e37f
#define PI_F 3.14159265358979323846f
#define INV_FOURPI_F 0.0795774715459476679f
#define FULL 0xffffffffu
#define MIN_BLOCKS 6  // resident 128-thread blocks an SM must hold: at most 80 registers

// the next ray a warp takes; set to 0 before every launch
__device__ unsigned int pg_fused_next_ray;

struct Params {
  const float* o;
  const float* d;
  const uint32_t* keys;
  int N;
  const float* plk;
  const float* shade;
  int n_tri;
  int t_pad;
  uint32_t lo_mask;
  const float* em;
  int n_em;
  int e_pad;
  const float* mat;
  int n_mat;
  const uint16_t* guide;
  const float* meta;
  float alpha;
  int max_depth;
  int rr_depth;
  float* out;
};

__device__ __forceinline__ float power_heuristic(float pa, float pb) {
  const float a2 = pa * pa;
  const float w = a2 / fmaxf(a2 + pb * pb, 1e-30f);
  return pa > 0.0f ? w : 0.0f;
}

__device__ __forceinline__ void frame_from(const float* n, float* s, float* t) {
  const float sign = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n[2]);
  const float b = n[0] * n[1] * a;
  s[0] = 1.0f + sign * n[0] * n[0] * a;
  s[1] = sign * b;
  s[2] = -sign * n[0];
  t[0] = b;
  t[1] = sign + n[1] * n[1] * a;
  t[2] = -n[1];
}

__device__ __forceinline__ void to_local(const float* s, const float* t, const float* n,
                                         const float* v, float* r) {
  r[0] = pg_dot(v, s);
  r[1] = pg_dot(v, t);
  r[2] = pg_dot(v, n);
}

__device__ __forceinline__ void to_world(const float* s, const float* t, const float* n,
                                         const float* v, float* r) {
  r[0] = (v[0] * s[0] + v[1] * t[0]) + v[2] * n[0];
  r[1] = (v[0] * s[1] + v[1] * t[1]) + v[2] * n[1];
  r[2] = (v[0] * s[2] + v[1] * t[2]) + v[2] * n[2];
}

__device__ __forceinline__ void normalize3(float* v) {
  const float inv = rsqrtf(fmaxf(pg_dot(v, v), 1e-30f));
  v[0] *= inv;
  v[1] *= inv;
  v[2] *= inv;
}

__device__ __forceinline__ float vmf_pdf(float t, float kappa) {
  const float kk = fminf(fmaxf(kappa, 0.0f), 1e4f);
  const float denom = (2.0f * PI_F) * (1.0f - expf(-2.0f * kk));
  const float norm = kk > 1e-6f ? kk / fmaxf(denom, 1e-30f) : INV_FOURPI_F;
  return norm * expf(kk * (fminf(fmaxf(t, -1.0f), 1.0f) - 1.0f));
}

__device__ __forceinline__ void cosine_hemisphere(float u0, float u1, float* w) {
  const float x = 2.0f * u0 - 1.0f;
  const float y = 2.0f * u1 - 1.0f;
  const bool zero = (x == 0.0f) && (y == 0.0f);
  const bool use_x = fabsf(x) > fabsf(y);
  float r = use_x ? x : y;
  float phi = use_x ? (PI_F / 4.0f) * (y / (fabsf(x) < 1e-12f ? 1.0f : x))
                    : (PI_F / 2.0f) - (PI_F / 4.0f) * (x / (fabsf(y) < 1e-12f ? 1.0f : y));
  if (zero) {
    r = 0.0f;
    phi = 0.0f;
  }
  w[0] = r * cosf(phi);
  w[1] = r * sinf(phi);
  w[2] = sqrtf(fmaxf((1.0f - w[0] * w[0]) - w[1] * w[1], 0.0f));
}

// bf16 value of a word holding two (the high half when hi), widened exactly
__device__ __forceinline__ float bf16_half(uint32_t w, bool hi) {
  return pg_u2f(hi ? (w & 0xFFFF0000u) : (w << 16));
}

// guiding mixture of one lane, kept in shared memory (lane-major columns,
// so every access is conflict-free): word (4 c + k / 2) of the lane's
// column of q holds lobes k and k + 1 of component c (mu_x, mu_y, mu_z,
// kappa) as packed bf16, w holds the 8 normalised weights
struct Mixture {
  const uint32_t* q;
  const float* w;
  bool valid;
};

__device__ __forceinline__ float mix_pdf(const Mixture& g, const float* v) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < K / 2; ++j) {
    const uint32_t wx = g.q[j * BLOCK], wy = g.q[(4 + j) * BLOCK];
    const uint32_t wz = g.q[(8 + j) * BLOCK], wk = g.q[(12 + j) * BLOCK];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * j + h;
      const float t = (bf16_half(wx, h) * v[0] + bf16_half(wy, h) * v[1]) + bf16_half(wz, h) * v[2];
      const float term = g.w[k * BLOCK] * vmf_pdf(t, bf16_half(wk, h));
      acc = k == 0 ? term : acc + term;
    }
  }
  return g.valid ? acc : INV_FOURPI_F;
}

// the 10 uniforms of a bounce come in pairs, block b giving 2b and 2b + 1
// (0:3 NEE, 3:5 direction, 6 guide select, 7 guide lobe, 8 RR); each pair
// is drawn where it is first used
__device__ __forceinline__ void uniform_pair(uint32_t k0, uint32_t k1, int depth, int b, float* u0,
                                             float* u1) {
  uint32_t b0, b1;
  pg_threefry2x32<13>(k0, k1, (uint32_t)depth, (uint32_t)b, &b0, &b1);
  *u0 = pg_bits_to_unit(b0);
  *u1 = pg_bits_to_unit(b1);
}

// coefficients 0:20 of triangle q (the edge sides and the numerator's
// first two), then 20:25
__device__ __forceinline__ void plk_edges(const float4* q, float* c) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float4 v = q[i];
    c[4 * i] = v.x;
    c[4 * i + 1] = v.y;
    c[4 * i + 2] = v.z;
    c[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void plk_plane(const float4* q, float c24, float* c) {
  const float4 v = q[5];
  c[20] = v.x;
  c[21] = v.y;
  c[22] = v.z;
  c[23] = v.w;
  c[24] = c24;
}

// the rows a lane writes when its path ends; the first-hit rows are
// written at the first hit, or here as zeros when the camera ray escaped
__device__ __forceinline__ void finish(const Params& P, int n, const float* L, float n_bounces,
                                       float loops, float shadow_tests) {
  float* out = P.out;
  const int64_t N = P.N;
  out[n] = L[0];
  out[N + n] = L[1];
  out[2 * N + n] = L[2];
  out[10 * N + n] = n_bounces;
  out[14 * N + n] = loops;
  out[15 * N + n] = shadow_tests;
  if (n_bounces == 0.0f) {
#pragma unroll
    for (int r = 3; r < 14; ++r)
      if (r != 10) out[r * N + n] = 0.0f;
  }
}

template <bool GUIDED>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) trace_fused_kernel(Params P) {
  extern __shared__ float4 smem4[];
  const float4* s_plk = smem4;                                      // (t_pad, 6) float4
  uint32_t* s_gq = reinterpret_cast<uint32_t*>(smem4 + P.t_pad * PLK_VEC);  // (16, BLOCK)
  float* s_gw = reinterpret_cast<float*>(s_gq + (GUIDED ? 16 * BLOCK : 0));  // (8, BLOCK)
  float* s_c24 = s_gw + (GUIDED ? K * BLOCK : 0);                   // (t_pad,)
  float* s_em = s_c24 + P.t_pad;                                    // (e_pad, 32)
  float* s_meta = s_em + P.e_pad * 32;                              // guide grid: lo, scale, res
  {
    float* s_plk_f = reinterpret_cast<float*>(smem4);
    for (int i = threadIdx.x; i < P.t_pad * PLK; i += blockDim.x) {
      const int t = i / PLK, c = i - t * PLK;
      if (c < 4 * PLK_VEC) {
        s_plk_f[4 * PLK_VEC * t + c] = P.plk[i];
      } else {
        s_c24[t] = P.plk[i];
      }
    }
  }
  for (int i = threadIdx.x; i < P.e_pad * 32; i += blockDim.x) s_em[i] = P.em[i];
  if (GUIDED) {
    for (int i = threadIdx.x; i < 7; i += blockDim.x) s_meta[i] = P.meta[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // the lane's ray n and its path state
  bool alive = false, exhausted = false;
  int n = 0, depth = 0;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 1.f};
  float L[3] = {0.f, 0.f, 0.f}, T[3] = {1.f, 1.f, 1.f};
  float prev_pdf = INFD, a_sh = 0.0f;
  uint32_t k0 = 0, k1 = 0;

  for (;;) {
    // lanes without a ray take the next ones, one atomic per warp
    if (!exhausted) {
      const unsigned need = __ballot_sync(FULL, !alive);
      if (need) {
        unsigned first = 0;
        if (lane == 0) first = atomicAdd(&pg_fused_next_ray, (unsigned)__popc(need));
        first = __shfl_sync(FULL, first, 0);
        if (!alive) {
          const unsigned r = first + __popc(need & ((1u << lane) - 1u));
          if (r < (unsigned)P.N) {
            n = (int)r;
            for (int i = 0; i < 3; ++i) {
              o[i] = P.o[3 * n + i];
              d[i] = P.d[3 * n + i];
              L[i] = 0.0f;
              T[i] = 1.0f;
            }
            k0 = P.keys[2 * n];
            k1 = P.keys[2 * n + 1];
            prev_pdf = INFD;
            a_sh = 0.0f;
            depth = 0;
            alive = P.max_depth > 0;
            if (!alive) finish(P, n, L, 0.0f, 0.0f, 0.0f);
          }
        }
        exhausted = first + (unsigned)__popc(need) >= (unsigned)P.N;
      }
    }
    if (!__any_sync(FULL, alive)) {
      if (exhausted) break;
      continue;
    }
    // one bounce of every live lane; the other lanes run along with their
    // results unused, so the warp stays converged for its votes

    // closest hit: Pluecker test + packed-key winner
    float m[3];
    pg_cross(o, d, m);
    uint32_t key_best = PG_INF_BITS;
    for (int t = 0; t < P.n_tri; ++t) {
      float c[PLK];
      plk_edges(s_plk + PLK_VEC * t, c);
      // both stages run on every lane of the warp, their results ANDed:
      // no branch inside the loop but the vote's
      const bool in = pg_plucker_inside(c, d, m, false) && alive;
      if (__any_sync(FULL, in)) {
        plk_plane(s_plk + PLK_VEC * t, s_c24[t], c);
        float tt;
        const bool h = pg_plucker_depth(c, o, d, INFD, &tt) && in;
        const uint32_t key = pg_packed_key(h, tt, (uint32_t)t, P.lo_mask);
        key_best = key < key_best ? key : key_best;
      }
    }
    const float t_mm = pg_u2f(key_best & ~P.lo_mask);
    // an escaped lane adds nothing more (no env light) and ends
    const bool hit = alive && t_mm < INFINITY;
    if (alive && !hit) {
      finish(P, n, L, (float)depth, (float)(depth + 1), a_sh);
      alive = false;
    }
    const int prim = (int)(key_best & P.lo_mask);

    // the winner's shading row: 0:9 p0 e1 e2, 9:12 ng, 12:21 vertex
    // normals, 21 material, 22 emitter flag, 23:26 emission, 26 pmf, 27 area
    const float* srow = P.shade + prim * 32;
    float t_ex, hu, hv;
    {
      float tri[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) tri[i] = __ldg(srow + i);
      pg_mt_exact(tri, o, d, &t_ex, &hu, &hv);
    }
    const float t_hit = fmaxf(t_ex, PG_EPS_T);
    float p[3] = {o[0] + d[0] * t_hit, o[1] + d[1] * t_hit, o[2] + d[2] * t_hit};
    const float ng[3] = {__ldg(srow + 9), __ldg(srow + 10), __ldg(srow + 11)};
    const float b0c = (1.0f - hu) - hv;
    float ns[3];
    for (int i = 0; i < 3; ++i)
      ns[i] = (b0c * __ldg(srow + 12 + i) + hu * __ldg(srow + 15 + i)) + hv * __ldg(srow + 18 + i);
    normalize3(ns);
    if (pg_dot(ns, ng) < 0.0f) {
      ns[0] = ns[0] * -1.0f;
      ns[1] = ns[1] * -1.0f;
      ns[2] = ns[2] * -1.0f;
    }
    const float le[3] = {__ldg(srow + 23), __ldg(srow + 24), __ldg(srow + 25)};

    // emissive hit, MIS against NEE (the previous bounce is a delta only
    // for the camera ray)
    const float nd[3] = {d[0] * -1.0f, d[1] * -1.0f, d[2] * -1.0f};
    const float cos_l = pg_dot(ng, nd);
    const bool is_em = __ldg(srow + 22) >= 0.0f;
    const bool emit = is_em && cos_l > 0.0f;
    float pdf_nee_hit = __ldg(srow + 26) * (t_hit * t_hit) /
                        fmaxf(fabsf(cos_l) * fmaxf(__ldg(srow + 27), 1e-12f), 1e-12f);
    pdf_nee_hit = is_em ? pdf_nee_hit : 0.0f;
    const float w_hit = depth == 0 ? 1.0f : power_heuristic(prev_pdf, pdf_nee_hit);
    const float gain = emit ? w_hit : 0.0f;
    if (hit) {
      for (int i = 0; i < 3; ++i) L[i] = L[i] + T[i] * (le[i] * gain);
    }

    // material row + first-hit rows
    const int mc = min(max((int)__ldg(srow + 21), 0), P.n_mat - 1);
    const float refl[3] = {__ldg(P.mat + mc * 8 + 1), __ldg(P.mat + mc * 8 + 2),
                           __ldg(P.mat + mc * 8 + 3)};
    if (hit && depth == 0) {
      float* out = P.out;
      const int64_t N = P.N;
      for (int i = 0; i < 3; ++i) {
        out[(3 + i) * N + n] = refl[i];
        out[(6 + i) * N + n] = ns[i];
        out[(11 + i) * N + n] = le[i] * (emit ? 1.0f : 0.0f);
      }
      out[9 * N + n] = t_hit;
    }

    float fs[3], ft[3];
    frame_from(ns, fs, ft);
    float wi_l[3];
    to_local(fs, ft, ns, nd, wi_l);

    // guiding-cache row of the lane's cell, into the lane's shared columns
    Mixture g;
    g.q = s_gq + threadIdx.x;
    g.w = s_gw + threadIdx.x;
    g.valid = false;
    float a_g = 0.0f;
    if (GUIDED) {
      const float g_res = s_meta[6];
      int qi[3];
      for (int i = 0; i < 3; ++i) {
        const float q = fminf(fmaxf((p[i] - s_meta[i]) * s_meta[3 + i], 0.0f), g_res - 1.0f);
        qi[i] = (int)q;
      }
      const int ires = (int)g_res;
      const int cid = (qi[0] * ires + qi[1]) * ires + qi[2];
      const uint4* gr = reinterpret_cast<const uint4*>(P.guide + (int64_t)cid * 48);
      uint32_t* gq = s_gq + threadIdx.x;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 v = __ldg(gr + c);
        gq[(4 * c) * BLOCK] = v.x;
        gq[(4 * c + 1) * BLOCK] = v.y;
        gq[(4 * c + 2) * BLOCK] = v.z;
        gq[(4 * c + 3) * BLOCK] = v.w;
      }
      const uint4 lw = __ldg(gr + 4);
      const uint4 tail = __ldg(gr + 5);
      const uint32_t lwords[4] = {lw.x, lw.y, lw.z, lw.w};
      float wmax = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; ++k) wmax = fmaxf(wmax, bf16_half(lwords[k / 2], k & 1));
      g.valid = bf16_half(tail.x, false) > 0.5f;
      const float g_ascale = bf16_half(tail.x, true);
      float* gw = s_gw + threadIdx.x;
      float wsum = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float we = expf(bf16_half(lwords[k / 2], k & 1) - wmax);
        gw[k * BLOCK] = we;
        wsum = k == 0 ? we : wsum + we;
      }
      const float wden = fmaxf(wsum, 1e-30f);
#pragma unroll
      for (int k = 0; k < K; ++k) gw[k * BLOCK] = gw[k * BLOCK] / wden;
      a_g = g.valid ? P.alpha * g_ascale : 0.0f;
    }

    // NEE: CDF emitter pick, uniform point on the emitting triangle
    float u0, u1, u2, u3;
    uniform_pair(k0, k1, depth, 0, &u0, &u1);
    uniform_pair(k0, k1, depth, 1, &u2, &u3);
    int eid = 0;
    for (int e = 0; e < P.e_pad; ++e) eid += s_em[e * 32 + 31] <= u0 ? 1 : 0;
    eid = min(max(eid, 0), P.n_em - 1);
    const float* er = s_em + eid * 32;
    const float su = sqrtf(fmaxf(u1, 0.0f));
    const float tb0 = 1.0f - su;
    const float tb1 = u2 * su;
    float to_q[3];
    for (int i = 0; i < 3; ++i) to_q[i] = ((er[14 + i] + tb0 * er[17 + i]) + tb1 * er[20 + i]) - p[i];
    const float nee_d2 = fmaxf(pg_dot(to_q, to_q), 1e-12f);
    const float nee_dist = sqrtf(nee_d2);
    const float inv_dist = 1.0f / nee_dist;
    const float nee_dir[3] = {to_q[0] * inv_dist, to_q[1] * inv_dist, to_q[2] * inv_dist};
    const float neg_dir[3] = {nee_dir[0] * -1.0f, nee_dir[1] * -1.0f, nee_dir[2] * -1.0f};
    const float cos_e = pg_dot(er + 23, neg_dir);
    const float nee_pdf = er[1] * nee_d2 / fmaxf(fabsf(cos_e) * fmaxf(er[13], 1e-12f), 1e-12f);
    const float rad_on = cos_e > 0.0f ? 1.0f : 0.0f;
    float wo_nee_l[3];
    to_local(fs, ft, ns, nee_dir, wo_nee_l);
    const bool up_nee = (wi_l[2] > 0.0f) && (wo_nee_l[2] > 0.0f);
    const float cos_nee = up_nee ? fmaxf(wo_nee_l[2], 0.0f) / PI_F : 0.0f;
    const float pdf_dir_nee = GUIDED ? a_g * mix_pdf(g, nee_dir) + (1.0f - a_g) * cos_nee : cos_nee;

    // BSDF or guided direction (drawn before the shadow ray is traced: it
    // does not depend on it, and the mixture is done with before the loop)
    float u4, u5;
    uniform_pair(k0, k1, depth, 2, &u4, &u5);
    float wo_cos[3];
    cosine_hemisphere(u3, u4, wo_cos);
    const float pdf_cos = fmaxf(wo_cos[2], 0.0f) / PI_F;
    float wo_w[3], next_w[3], next_pdf;
    if (GUIDED) {
      float u6, u7;
      uniform_pair(k0, k1, depth, 3, &u6, &u7);
      float run = 0.0f;
      int ksel = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        run = run + g.w[k * BLOCK];
        ksel += u7 > run ? 1 : 0;
      }
      ksel = min(max(ksel, 0), K - 1);
      // lobe ksel by compare-and-select over the unrolled lobes
      float mu_k[3] = {0.0f, 0.0f, 0.0f}, kap_k = 0.0f;
#pragma unroll
      for (int j = 0; j < K / 2; ++j) {
        const uint32_t wx = g.q[j * BLOCK], wy = g.q[(4 + j) * BLOCK];
        const uint32_t wz = g.q[(8 + j) * BLOCK], wk = g.q[(12 + j) * BLOCK];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool sel = ksel == 2 * j + h;
          mu_k[0] = sel ? bf16_half(wx, h) : mu_k[0];
          mu_k[1] = sel ? bf16_half(wy, h) : mu_k[1];
          mu_k[2] = sel ? bf16_half(wz, h) : mu_k[2];
          kap_k = sel ? bf16_half(wk, h) : kap_k;
        }
      }
      const float kk = fminf(fmaxf(kap_k, 0.0f), 1e4f);
      const float u0c = fminf(fmaxf(u3, 1e-7f), 1.0f - 1e-7f);
      const float safe_k = fmaxf(kk, 1e-3f);
      float wz = 1.0f + logf(u0c + (1.0f - u0c) * expf(-2.0f * safe_k)) / safe_k;
      wz = kk > 1e-3f ? wz : 1.0f - 2.0f * u0c;
      wz = fminf(fmaxf(wz, -1.0f), 1.0f);
      const float rr = sqrtf(fmaxf(1.0f - wz * wz, 0.0f));
      const float phi_v = (2.0f * PI_F) * u4;
      const float cphi = cosf(phi_v), sphi = sinf(phi_v);
      float d_guided[3];
      if (g.valid) {
        const float vloc[3] = {rr * cphi, rr * sphi, wz};
        normalize3(mu_k);
        float ms[3], mt[3];
        frame_from(mu_k, ms, mt);
        to_world(ms, mt, mu_k, vloc, d_guided);
      } else {
        const float zu = 1.0f - 2.0f * u3;
        const float ru = sqrtf(fmaxf(1.0f - zu * zu, 0.0f));
        d_guided[0] = ru * cphi;
        d_guided[1] = ru * sphi;
        d_guided[2] = zu;
      }
      float wo_l[3];
      if (u6 < a_g) {
        to_local(fs, ft, ns, d_guided, wo_l);
      } else {
        wo_l[0] = wo_cos[0];
        wo_l[1] = wo_cos[1];
        wo_l[2] = wo_cos[2];
      }
      to_world(fs, ft, ns, wo_l, wo_w);
      const bool up = (wi_l[2] > 0.0f) && (wo_l[2] > 0.0f);
      const float f_sel = up ? fmaxf(wo_l[2], 0.0f) / PI_F : 0.0f;
      const float pdf_comb = a_g * mix_pdf(g, wo_w) + (1.0f - a_g) * f_sel;
      const float wsc = pdf_comb > 1e-9f ? f_sel / fmaxf(pdf_comb, 1e-8f) : 0.0f;
      const bool native = a_g <= 0.0f;
      for (int i = 0; i < 3; ++i) next_w[i] = native ? refl[i] : refl[i] * wsc;
      next_pdf = native ? pdf_cos : pdf_comb;
    } else {
      to_world(fs, ft, ns, wo_cos, wo_w);
      for (int i = 0; i < 3; ++i) next_w[i] = refl[i];
      next_pdf = pdf_cos;
    }
    float T_new[3] = {T[0] * next_w[0], T[1] * next_w[1], T[2] * next_w[2]};
    const float tmax_t = fmaxf(fmaxf(fabsf(T_new[0]), fabsf(T_new[1])), fabsf(T_new[2]));
    bool cont = (tmax_t > 0.0f) && (next_pdf > 0.0f);
    if (P.rr_depth < P.max_depth && depth >= P.rr_depth) {
      float u8, u9;
      uniform_pair(k0, k1, depth, 4, &u8, &u9);
      const float qrr = fminf(fmaxf(fmaxf(fmaxf(T_new[0], T_new[1]), T_new[2]), 0.05f), 0.95f);
      const float inv_q = 1.0f / fmaxf(qrr, 1e-6f);
      if (cont) {
        for (int i = 0; i < 3; ++i) T_new[i] = T_new[i] * inv_q;
      }
      cont = cont && (u8 < qrr);
    }
    // the radiance after this bounce's NEE, with the light seen and with
    // it occluded (a zero gain), so that only these stay live across the
    // shadow ray's loop
    float L_vis[3], L_occ[3];
    {
      const float ph = power_heuristic(nee_pdf, pdf_dir_nee);
      const float gain_vis = nee_pdf > 0.0f ? 1.0f * ph / fmaxf(nee_pdf, 1e-12f) : 0.0f;
      for (int i = 0; i < 3; ++i) {
        const float f_nee = refl[i] * cos_nee;
        const float e_on = er[2 + i] * rad_on;
        L_vis[i] = L[i] + T[i] * (f_nee * (e_on * gain_vis));
        L_occ[i] = L[i] + T[i] * (f_nee * (e_on * 0.0f));
      }
    }
    const float off = pg_dot(ng, nee_dir) >= 0.0f ? 1e-4f : -1e-4f;
    const float o_sh[3] = {p[0] + ng[0] * off, p[1] + ng[1] * off, p[2] + ng[2] * off};
    const float t_sh = nee_dist * 0.999f;  // float32(1 - 1e-3)
    // the next segment, taken by a lane whose path goes on (one that ends
    // is given a new ray before it is read)
    const float offn = pg_dot(ng, wo_w) >= 0.0f ? 1e-4f : -1e-4f;
    for (int i = 0; i < 3; ++i) {
      o[i] = p[i] + ng[i] * offn;
      d[i] = wo_w[i];
      T[i] = T_new[i];
    }
    prev_pdf = next_pdf;

    // any-hit shadow ray, up to each lane's first occluder
    float m_sh[3];
    pg_cross(o_sh, nee_dir, m_sh);
    bool occ = false, looking = hit;
    int tested = 0;
    for (int t = 0; t < P.n_tri; ++t) {
      if (!__any_sync(FULL, looking)) break;
      float c[PLK];
      plk_edges(s_plk + PLK_VEC * t, c);
      const bool in = pg_plucker_inside(c, nee_dir, m_sh, true) && looking;
      if (__any_sync(FULL, in)) {
        plk_plane(s_plk + PLK_VEC * t, s_c24[t], c);
        float tt;
        occ = (pg_plucker_depth(c, o_sh, nee_dir, t_sh, &tt) && in) || occ;
      }
      tested += looking ? 1 : 0;
      looking = looking && !occ;
    }

    if (hit) {
      a_sh = a_sh + (float)tested;
      for (int i = 0; i < 3; ++i) L[i] = occ ? L_occ[i] : L_vis[i];
      if (!cont || depth + 1 >= P.max_depth) {
        finish(P, n, L, (float)(depth + 1), (float)(depth + 1), a_sh);
        alive = false;
      } else {
        depth += 1;
      }
    }
  }
}

template <bool GUIDED>
static int fused_launch(const Params& P, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(trace_fused_kernel<GUIDED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trace_fused_kernel<GUIDED>, BLOCK,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  void* next = nullptr;
  if ((err = cudaGetSymbolAddress(&next, pg_fused_next_ray)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(next, 0, sizeof(unsigned), stream)) != cudaSuccess) return (int)err;
  const int wanted = (P.N + BLOCK - 1) / BLOCK;
  const int blocks = per_sm * sms < wanted ? (per_sm * sms > 0 ? per_sm * sms : 1) : wanted;
  trace_fused_kernel<GUIDED><<<blocks, BLOCK, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int trace_fused_launch(const void* o, const void* d, const void* keys, int N,
                                  const void* plk, const void* shade, int n_tri, int t_pad,
                                  int lo_mask, const void* em, int n_em, int e_pad,
                                  const void* mat, int n_mat, const void* guide,
                                  const void* meta, int guided, float alpha, int max_depth,
                                  int rr_depth, void* out, void* stream) {
  Params P;
  P.o = (const float*)o;
  P.d = (const float*)d;
  P.keys = (const uint32_t*)keys;
  P.N = N;
  P.plk = (const float*)plk;
  P.shade = (const float*)shade;
  P.n_tri = n_tri;
  P.t_pad = t_pad;
  P.lo_mask = (uint32_t)lo_mask;
  P.em = (const float*)em;
  P.n_em = n_em;
  P.e_pad = e_pad;
  P.mat = (const float*)mat;
  P.n_mat = n_mat;
  P.guide = (const uint16_t*)guide;
  P.meta = (const float*)meta;
  P.alpha = alpha;
  P.max_depth = max_depth;
  P.rr_depth = rr_depth;
  P.out = (float*)out;
  if (N <= 0) return (int)cudaGetLastError();
  // a guide row is read as six 16-byte words
  if (guided && ((uintptr_t)guide & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  // the Pluecker table, the guided lanes' mixtures (16 words + 8 weights a
  // lane), the emitter rows and the guide grid's 7 floats
  const size_t smem = ((size_t)t_pad * PLK + (guided ? 24 * BLOCK : 0) + (size_t)e_pad * 32 + 8)
                      * sizeof(float);
  return guided ? fused_launch<true>(P, smem, (cudaStream_t)stream)
                : fused_launch<false>(P, smem, (cudaStream_t)stream);
}
