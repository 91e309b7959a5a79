// Host build of device_math.cuh behind a plain C interface, for the CPU
// test tests/test_torch_csrc_host.py:
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC host_shim.cpp
// Each entry point applies one of the kernels' per-lane functions to
// arrays, so its bits can be held against the plain PyTorch versions.

#include <vector>

#include "device_math.cuh"

extern "C" {

void host_threefry13(const uint32_t* k0, const uint32_t* k1, const uint32_t* x0,
                     const uint32_t* x1, uint32_t* y0, uint32_t* y1, int n) {
  for (int i = 0; i < n; ++i) pg_threefry2x32<13>(k0[i], k1[i], x0[i], x1[i], y0 + i, y1 + i);
}

void host_bits_to_unit(const uint32_t* bits, float* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = pg_bits_to_unit(bits[i]);
}

// closest hit over n_tri packed triangles (25 floats each) per ray:
// prim (-1 on a miss) and the packed-key t; any_hit != 0 gives 0/1 in prim
void host_plucker_closest(const float* plk, int n_tri, uint32_t lo_mask, const float* o,
                          const float* d, const float* tmax, int n, int any_hit,
                          int* prim, float* t_best) {
  for (int i = 0; i < n; ++i) {
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    float m[3];
    pg_cross(oi, di, m);
    uint32_t best = PG_INF_BITS;
    bool occ = false;
    for (int t = 0; t < n_tri; ++t) {
      float tt;
      const bool h = pg_plucker_hit(plk + 25 * t, oi, di, m, tmax[i], any_hit != 0, &tt);
      if (any_hit) {
        occ = occ || h;
      } else {
        const uint32_t key = pg_packed_key(h, tt, (uint32_t)t, lo_mask);
        best = key < best ? key : best;
      }
    }
    if (any_hit) {
      prim[i] = occ ? 1 : 0;
      t_best[i] = 0.0f;
    } else {
      const float tb = pg_u2f(best & ~lo_mask);
      const bool valid = tb < INFINITY;
      prim[i] = valid ? (int)(best & lo_mask) : -1;
      t_best[i] = tb;
    }
  }
}

// host_plucker_closest through the two stages pg_plucker_inside and
// pg_plucker_depth, the second run only where the first passed, as the
// fused kernel runs them
void host_plucker_split_closest(const float* plk, int n_tri, uint32_t lo_mask, const float* o,
                                const float* d, const float* tmax, int n, int any_hit,
                                int* prim, float* t_best) {
  for (int i = 0; i < n; ++i) {
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    float m[3];
    pg_cross(oi, di, m);
    uint32_t best = PG_INF_BITS;
    bool occ = false;
    for (int t = 0; t < n_tri; ++t) {
      const float* c = plk + 25 * t;
      float tt = 0.0f;
      const bool h = pg_plucker_inside(c, di, m, any_hit != 0) &&
                     pg_plucker_depth(c, oi, di, tmax[i], &tt);
      if (any_hit) {
        occ = occ || h;
      } else {
        const uint32_t key = pg_packed_key(h, tt, (uint32_t)t, lo_mask);
        best = key < best ? key : best;
      }
    }
    if (any_hit) {
      prim[i] = occ ? 1 : 0;
      t_best[i] = 0.0f;
    } else {
      const float tb = pg_u2f(best & ~lo_mask);
      const bool valid = tb < INFINITY;
      prim[i] = valid ? (int)(best & lo_mask) : -1;
      t_best[i] = tb;
    }
  }
}

void host_mt_exact(const float* tri, const float* o, const float* d, int n, float* t,
                   float* u, float* v) {
  for (int i = 0; i < n; ++i) pg_mt_exact(tri + 9 * i, o + 3 * i, d + 3 * i, t + i, u + i, v + i);
}

// dense MT over all triangles (p0, e1, e2 rows of 9 floats), closest hit
// below tmax with the lowest id on ties
void host_mt_closest(const float* tri, int n_tri, const float* o, const float* d,
                     const float* tmax, int n, float* t_out, int* prim, float* u_out,
                     float* v_out) {
  for (int i = 0; i < n; ++i) {
    float best = tmax[i] < 3.0e38f ? tmax[i] : 3.0e38f;
    int bp = -1;
    float bu = 0.0f, bv = 0.0f;
    for (int j = 0; j < n_tri; ++j) {
      const float* c = tri + 9 * j;
      float t, u, v;
      const bool h = pg_mt_test(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8],
                                o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                d[3 * i + 1], d[3 * i + 2], &t, &u, &v);
      if (h && t < best) {
        best = t;
        bp = j;
        bu = u;
        bv = v;
      }
    }
    t_out[i] = bp >= 0 ? best : 3.0e38f;
    prim[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

// The loose test of bf16 pair data on n (triangle i, ray i) pairs through
// the bf16 pair kernel's two stages, pg_mt_u_loose then pg_mt_vt_loose (the
// second only where the first passed) and t < tmax one, against the whole
// test applied to pg_mt_test's t, u, v (the plain version's terms).  Writes
// the staged hit, t and u of each pair; returns the pairs where the two
// disagree, which must be none.
int host_mt_loose_pairs(const float* tri, const float* o, const float* d, const float* tmax,
                        int n, float neg, float one, float eps_lo, float u_hi, int* hit,
                        float* t_out, float* u_out) {
  int wrong = 0;
  for (int i = 0; i < n; ++i) {
    const float* c = tri + 9 * i;
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    const float t_hi = tmax[i] * one;
    float tv[3], inv, u, t = 0.0f;
    const bool may = pg_mt_u_loose(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], oi[0],
                                   oi[1], oi[2], di[0], di[1], di[2], neg, u_hi, tv, &inv, &u);
    const bool h = may && pg_mt_vt_loose(c[3], c[4], c[5], c[6], c[7], c[8], di[0], di[1], di[2],
                                         tv, inv, u, neg, one, eps_lo, &t) && t < t_hi;
    float t1, u1, v1;
    pg_mt_test(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], oi[0], oi[1], oi[2], di[0],
               di[1], di[2], &t1, &u1, &v1);
    const bool whole = u1 >= neg && v1 >= neg && u1 + v1 <= one && t1 > eps_lo && t1 < t_hi;
    if (h != whole) ++wrong;
    hit[i] = h;
    t_out[i] = t1;
    u_out[i] = u1;
  }
  return wrong;
}

// host_mt_closest through the two stages pg_mt_u and pg_mt_vt, the second
// run only where the first passed, as the pair tile kernel runs them.
// Returns the (ray, triangle) tests where pg_mt_u failed and pg_mt_test
// hits, which must be none.
int host_mt_split_closest(const float* tri, int n_tri, const float* o, const float* d,
                          const float* tmax, int n, float* t_out, int* prim, float* u_out,
                          float* v_out) {
  int wrong = 0;
  for (int i = 0; i < n; ++i) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    float best = tmax[i] < 3.0e38f ? tmax[i] : 3.0e38f;
    int bp = -1;
    float bu = 0.0f, bv = 0.0f;
    for (int j = 0; j < n_tri; ++j) {
      const float* c = tri + 9 * j;
      float tv[3], inv, u, t = 0.0f, v = 0.0f;
      const bool may = pg_mt_u(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ox, oy,
                               oz, dx, dy, dz, tv, &inv, &u);
      const bool h = may && pg_mt_vt(c[3], c[4], c[5], c[6], c[7], c[8], dx, dy, dz, tv, inv, u,
                                     &t, &v);
      float t1, u1, v1;
      if (!may && pg_mt_test(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ox, oy, oz,
                             dx, dy, dz, &t1, &u1, &v1)) {
        ++wrong;
      }
      if (h && t < best) {
        best = t;
        bp = j;
        bu = u;
        bv = v;
      }
    }
    t_out[i] = bp >= 0 ? best : 3.0e38f;
    prim[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
  }
  return wrong;
}

// intersect_tiled.cu's split for n rays over the first n_tri triangles of
// its (12, tpad) pack: records from pg_tiled_record, PG_TILED_LANES lanes a
// ray, lane g testing triangles g, g + G, ... of each 128-triangle tile in
// two stages (pg_mt_vt only where pg_mt_u passed) with strictly-nearer
// replacement, then the kernel's butterfly (xor 1, 2, ...) by pg_nearer;
// as in the kernel, lane 0 gives t, lane 1 prim, lane 2 u and lane 3 v.
// any_hit != 0: hit[i] = 1 where some lane hit (a lane stops at its first).
void host_tiled_lanes(const float* pack, int tpad, int n_tri, const float* o, const float* d,
                      const float* tmax, int n, int any_hit, float* t_out, int* prim_out,
                      float* u_out, float* v_out, uint8_t* hit) {
  const int G = PG_TILED_LANES;
  std::vector<float> rec(12 * (size_t)n_tri);
  for (int j = 0; j < n_tri; ++j) pg_tiled_record(pack, tpad, j, &rec[12 * (size_t)j]);
  for (int i = 0; i < n; ++i) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float start = tmax[i] > 3.0e38f ? 3.0e38f : tmax[i];
    float bt[G], bu[G], bv[G];
    int bp[G];
    for (int g = 0; g < G; ++g) {
      bt[g] = start;
      bp[g] = -1;
      bu[g] = bv[g] = 0.0f;
      if (!(start > PG_EPS_T)) continue;
      for (int base = 0; base < n_tri && !(any_hit && bp[g] >= 0); base += 128) {
        const int cnt = n_tri - base < 128 ? n_tri - base : 128;
        for (int k = g; k < cnt; k += G) {
          const float* r = &rec[12 * (size_t)(base + k)];
          float tv[3], inv, u, t, v;
          if (!pg_mt_u(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], ox, oy, oz, dx, dy,
                       dz, tv, &inv, &u))
            continue;
          if (pg_mt_vt(r[3], r[4], r[5], r[6], r[7], r[8], dx, dy, dz, tv, inv, u, &t, &v) &&
              t < bt[g]) {
            bt[g] = t;
            bp[g] = base + k;
            bu[g] = u;
            bv[g] = v;
            if (any_hit) break;
          }
        }
      }
    }
    if (any_hit) {
      bool h = false;
      for (int g = 0; g < G; ++g) h = h || bp[g] >= 0;
      hit[i] = h ? 1 : 0;
      continue;
    }
    for (int off = 1; off < G; off <<= 1) {
      float t2[G], u2[G], v2[G];
      int p2[G];
      for (int g = 0; g < G; ++g) {
        const int x = g ^ off;
        const bool take = pg_nearer(bt[x], bp[x], bt[g], bp[g]);
        t2[g] = take ? bt[x] : bt[g];
        p2[g] = take ? bp[x] : bp[g];
        u2[g] = take ? bu[x] : bu[g];
        v2[g] = take ? bv[x] : bv[g];
      }
      for (int g = 0; g < G; ++g) {
        bt[g] = t2[g];
        bp[g] = p2[g];
        bu[g] = u2[g];
        bv[g] = v2[g];
      }
    }
    t_out[i] = bp[0] >= 0 ? bt[0] : 3.0e38f;
    prim_out[i] = bp[1 % G];
    u_out[i] = bu[2 % G];
    v_out[i] = bv[3 % G];
  }
}

// intersect_pairs.cu's Pluecker tiles (pair_kernel<true, .>) over n_tiles
// tiles of 128 pairs: an inert tile or a pair with tmax <= EPS_T gives
// (3e38, -1) at once; a live pair is tested by 4 warps' shares (warp w:
// records w, w + 4, ... from pg_plk_record, below one past the block's last
// real triangle), each in two stages (pg_plucker_depth only where
// pg_plucker_inside passed), the shares merged in warp order by pg_nearer.
// out (2, 128 n_tiles): t and the id, or +-1 with any_hit.
void host_plk_tiles(const float* cols, const float* rows, int n_blocks, const int* tile_block,
                    int n_tiles, const float* pd, int any_hit, float* out) {
  const int64_t P = (int64_t)n_tiles * 128;
  const float inf = 3.0e38f, no_id = 2.0e9f;
  float rec[128][28];
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int blk = tile_block[tile];
    int last = 0;
    if (blk >= 0) {
      const int64_t b = blk < n_blocks - 1 ? blk : n_blocks - 1;
      for (int i = 0; i < 128; ++i) {
        pg_plk_record(cols + b * 16 * 640, rows + b * 10 * 128, i, rec[i]);
        if (rec[i][25] >= 0.0f) last = i + 1;
      }
    }
    for (int j = 0; j < 128; ++j) {
      const int64_t p = (int64_t)tile * 128 + j;
      float bt = inf, bid = no_id;
      if (blk >= 0 && pd[6 * P + p] > PG_EPS_T) {
        const float oo[3] = {pd[p], pd[P + p], pd[2 * P + p]};
        const float dd[3] = {pd[3 * P + p], pd[4 * P + p], pd[5 * P + p]};
        const float m[3] = {oo[1] * dd[2] - oo[2] * dd[1], oo[2] * dd[0] - oo[0] * dd[2],
                            oo[0] * dd[1] - oo[1] * dd[0]};
        for (int w = 0; w < 4; ++w) {
          float wt = inf, wid = no_id;
          for (int k = w; k < last; k += 4) {
            const float* c = rec[k];
            float t;
            if (pg_plucker_inside(c, dd, m, any_hit != 0) &&
                pg_plucker_depth(c, oo, dd, pd[6 * P + p], &t) && c[25] >= 0.0f &&
                pg_nearer(t, c[25], wt, wid)) {
              wt = t;
              wid = c[25];
            }
          }
          if (pg_nearer(wt, wid, bt, bid)) {
            bt = wt;
            bid = wid;
          }
        }
      }
      const bool h = bt < inf;
      out[p] = bt;
      out[P + p] = any_hit ? (h ? 1.0f : -1.0f) : (h ? bid : -1.0f);
    }
  }
}

// intersect_twolevel.cu's walk of tile `tile`, with the kernel's arguments
// (mask (nt, S), order (S,), blk_lo / blk_hi (3, bpad), ray (6, npad),
// tmax (npad,), tri_pack (S, 16, 8192)): per walked superblock the
// candidates (pg_tl_candidates at each ray's best t on entry, ORed over
// the tile), then per candidate in ascending order the exact gates
// (pg_tl_gate at the current best t), ORed; an opened block's records
// (pg_tl_record_word), its real triangles and the last of them, and per
// warp of 32 rays (unless every ray's best t is at most EPS_T) the
// records up to the last real one, each in three stages, the next one
// only where a lane passed the last (the kernel's warp votes): pg_tl_num
// and pg_mt_surely_out, pg_mt_u_of, pg_tl_take; then pg_tl_merge, and at
// the end pg_tl_uv of each ray's winner from the pack.  Writes the tile's
// columns of out (4, npad) and its row of work (nt, 4); stats[0] += the
// candidates, stats[1] += the candidates that did not open, stats[2] +=
// the warps' tests (one a warp and record), stats[3] += those where a lane
// escaped pg_mt_surely_out, stats[4] += those where a lane passed
// pg_mt_u_of.
void host_twolevel_tile(const int* mask, const int* order, int n_sb, const float* blk_lo,
                        const float* blk_hi, int bpad, const float* ray, const float* tmax,
                        int npad, const float* tri_pack, int tile, float* out, int64_t* work,
                        int64_t* stats) {
  const int R = 512, B = PG_TL_BLOCKS, T = PG_TL_TRIS;
  std::vector<float> o(3 * R), d(3 * R), inv(3 * R), boxw(8 * B, 0.0f), words(12 * T, 0.0f);
  const pg_f4* box = (const pg_f4*)boxw.data();
  std::vector<float> best_t(R);
  std::vector<int> best_pos(R, -1);
  std::vector<uint8_t> gate(R);
  for (int i = 0; i < R; ++i) {
    const int64_t n = (int64_t)tile * R + i;
    for (int a = 0; a < 3; ++a) {
      o[3 * i + a] = ray[a * (int64_t)npad + n];
      d[3 * i + a] = ray[(3 + a) * (int64_t)npad + n];
      inv[3 * i + a] = pg_tl_inv(d[3 * i + a]);
    }
    best_t[i] = fminf(tmax[n], 3.0e38f);
  }
  int64_t walked = 0, opened = 0, needed = 0;
  for (int si = 0; si < n_sb; ++si) {
    const int s = order[si];
    if (mask[(int64_t)tile * n_sb + s] == 0) continue;
    ++walked;
    for (int e = 0; e < 6 * B; ++e) {
      int dst;
      bool lo;
      int64_t src;
      pg_tl_box_word(e, s, bpad, &dst, &lo, &src);
      boxw[dst] = (lo ? blk_lo : blk_hi)[src];
    }
    uint64_t cand = 0;
    for (int i = 0; i < R; ++i) cand |= pg_tl_candidates(box, &o[3 * i], &inv[3 * i], best_t[i]);
    const float* pack = tri_pack + (int64_t)s * 16 * PG_TL_SB_TRIS;
    for (int k = 0; k < B; ++k) {
      if (!((cand >> k) & 1)) continue;
      ++stats[0];
      bool open = false;
      for (int i = 0; i < R; ++i) {
        gate[i] = pg_tl_gate(box, k, &o[3 * i], &inv[3 * i], best_t[i]);
        open = open || gate[i];
      }
      if (!open) {
        ++stats[1];
        continue;
      }
      ++opened;
      for (int e = 0; e < PG_TL_WORDS * T; ++e) {
        int dst, src;
        pg_tl_record_word(e, k, &dst, &src);
        words[dst] = pack[src];
      }
      const pg_f4* rec = (const pg_f4*)words.data();
      int tris = 0, last = 0;
      for (int j = 0; j < T; ++j) {
        if (words[12 * j + 9] >= 0.0f) {
          ++tris;
          last = j + 1;
        }
      }
      for (int i = 0; i < R; ++i) {
        if (gate[i] && best_t[i] > PG_EPS_T) needed += tris;
      }
      for (int w = 0; w < R / 32; ++w) {
        bool live = false;
        for (int l = 0; l < 32; ++l) live = live || best_t[32 * w + l] > PG_EPS_T;
        if (!live) continue;
        pg_tl_win win[32];
        for (int l = 0; l < 32; ++l) win[l] = {3.0e38f, 2.0e9f, 0};
        for (int q = 0; q < last; ++q) {
          const pg_f4 a = rec[3 * q], b = rec[3 * q + 1], c = rec[3 * q + 2];
          float tv[32][3], det[32], num[32], inv_det[32], u[32];
          bool may[32], in = false, any = false;
          for (int l = 0; l < 32; ++l) {
            const int i = 32 * w + l;
            pg_tl_num(a, b, c, &o[3 * i], &d[3 * i], tv[l], &det[l], &num[l]);
            in = in || !pg_mt_surely_out(num[l], det[l]);
          }
          ++stats[2];
          if (!in) continue;
          ++stats[3];
          for (int l = 0; l < 32; ++l) {
            may[l] = pg_mt_u_of(num[l], det[l], &inv_det[l], &u[l]);
            any = any || may[l];
          }
          if (!any) continue;
          ++stats[4];
          for (int l = 0; l < 32; ++l) {
            pg_tl_take(a, b, c, q, may[l], &d[3 * (32 * w + l)], tv[l], inv_det[l], u[l],
                       &win[l]);
          }
        }
        for (int l = 0; l < 32; ++l) {
          const int i = 32 * w + l;
          pg_tl_merge(&win[l], s * PG_TL_SB_TRIS + k * T, &best_t[i], &best_pos[i]);
        }
      }
    }
  }
  for (int i = 0; i < R; ++i) {
    const int64_t n = (int64_t)tile * R + i;
    float prim = -1.0f, u = 0.0f, v = 0.0f;
    if (best_pos[i] >= 0) {
      pg_f4 a, b, c;
      pg_tl_pack_record(tri_pack + (int64_t)(best_pos[i] / PG_TL_SB_TRIS) * 16 * PG_TL_SB_TRIS,
                        best_pos[i] % PG_TL_SB_TRIS, &a, &b, &c);
      pg_tl_uv(a, b, c, &o[3 * i], &d[3 * i], &u, &v);
      prim = c.y;
    }
    out[n] = best_t[i];
    out[npad + n] = prim;
    out[2 * (int64_t)npad + n] = u;
    out[3 * (int64_t)npad + n] = v;
  }
  work[4 * tile] = walked;
  work[4 * tile + 1] = opened;
  work[4 * tile + 2] = opened * R * T;
  work[4 * tile + 3] = needed;
}

// pg_mt_surely_out against pg_mt_u_of on n (num, det) pairs: reject[i],
// may[i]; and, where tri != nullptr, on every pair of n_tri triangles (9
// floats) and n rays through pg_mt_num: counts[0] += pairs, counts[1] +=
// rejected, counts[2] += pg_mt_u accepts, counts[3] += rejected pairs that
// pg_mt_u accepts (must stay 0), counts[4] += pairs where pg_mt_num then
// pg_mt_u_of differs from pg_mt_u in a bit of u, 1/det or tvec (must stay 0)
void host_mt_surely_out(const float* num, const float* det, int n, uint8_t* reject,
                        uint8_t* may, const float* tri, int n_tri, const float* o,
                        const float* d, int n_rays, int64_t* counts) {
  for (int i = 0; i < n; ++i) {
    float inv, u;
    reject[i] = pg_mt_surely_out(num[i], det[i]) ? 1 : 0;
    may[i] = pg_mt_u_of(num[i], det[i], &inv, &u) ? 1 : 0;
  }
  if (tri == nullptr) return;
  for (int i = 0; i < n_rays; ++i) {
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    for (int j = 0; j < n_tri; ++j) {
      const float* c = tri + 9 * j;
      float tv[3], dt, nm, inv, u, tv2[3], inv2, u2;
      pg_mt_num(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], oi[0], oi[1], oi[2], di[0],
                di[1], di[2], tv, &dt, &nm);
      const bool out = pg_mt_surely_out(nm, dt);
      const bool m = pg_mt_u_of(nm, dt, &inv, &u);
      const bool m2 = pg_mt_u(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], oi[0], oi[1],
                              oi[2], di[0], di[1], di[2], tv2, &inv2, &u2);
      ++counts[0];
      counts[1] += out;
      counts[2] += m2;
      counts[3] += out && m2;
      counts[4] += m != m2 || pg_f2u(u) != pg_f2u(u2) || pg_f2u(inv) != pg_f2u(inv2) ||
                   memcmp(tv, tv2, sizeof(tv)) != 0;
    }
  }
}

// the blocklist kernel's merge keys of (t, block, id), and their unpacking
void host_block_key(const float* t, const uint32_t* block, const uint32_t* tid, int n,
                    uint64_t* key, float* t_out, uint32_t* block_out, uint32_t* tid_out) {
  for (int i = 0; i < n; ++i) {
    key[i] = pg_block_key(t[i], block[i], tid[i]);
    t_out[i] = pg_key_t(key[i]);
    block_out[i] = pg_key_block(key[i]);
    tid_out[i] = pg_key_tid(key[i]);
  }
}

uint64_t host_key_miss(void) { return PG_KEY_MISS; }

// the BVH walk of csrc/intersect_bvh.cu over a packed BVH (accel/bvh.py
// pack_bvh) for n rays: t, prim, u, v and counts (2, n), boxes tested and
// triangles tested
void host_bvh_walk(const float* nodes, const float* tris, int n_tris, const float* o,
                   const float* d, const float* tmax, int n, int any_hit, float* t, int* prim,
                   float* u, float* v, int* counts) {
  const pg_f4* nd = (const pg_f4*)nodes;
  const pg_f4* tr = (const pg_f4*)tris;
  pg_bvh_entry stack[PG_BVH_STACK];
  for (int i = 0; i < n; ++i) {
    const float* oi = o + 3 * i;
    const float* di = d + 3 * i;
    const pg_bvh_result r = any_hit
                                ? pg_bvh_walk<true>(nd, tr, n_tris, oi, di, tmax[i], stack)
                                : pg_bvh_walk<false>(nd, tr, n_tris, oi, di, tmax[i], stack);
    t[i] = r.t;
    prim[i] = r.prim;
    u[i] = r.u;
    v[i] = r.v;
    counts[i] = r.boxes;
    counts[n + i] = r.tris;
  }
}

}  // extern "C"
