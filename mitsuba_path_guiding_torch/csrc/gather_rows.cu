// gather_rows_t: out[c * N + n] = table[clamp(idx[n], 0, R-1) * C + c].
//
// Replaces the Pallas kernel mitsuba_path_guiding_tpu/ops/gather_pallas.py:32
// (_kernel, called through gather_rows_t at :63), which on the TPU is a
// one-hot MXU matmul emitting the transposed (C, N) layout.  On Hopper the
// function is a plain gather: it does no arithmetic, so the result is
// bit-equal to table[idx.clamp(0, R-1)].T by construction (no TF32/bf16
// product can quantise it, the trap gather_pallas.py:38-44 records).
//
// Bound: bytes.  It reads N indices and each distinct row once (C * 4
// bytes), and writes C * N floats.  The port sends every table here, from
// a 36-row material table to a scene's shading table (244838 rows, 31 MB,
// which no L1 holds).
//
// Design: a CTA of 256 threads takes a tile of NT = 128 lanes.  It reads
// the tile's rows whole: for C = 32 (every caller's width) 8 consecutive
// threads read one 128-byte row as 8 x LDG.128, so a warp instruction
// reads 4 rows as 4 full lines: 4 L1 wavefronts for 512 useful bytes,
// where one thread per lane, reading element c of 32 rows, spent up to 32
// wavefronts (and on a large table 32 L2 sectors) on 128 bytes.  The rows
// go into a shared tile [32][NT + 1]: a warp's 32 stores of one element
// j land at (4q + j) * 129 + n for 8 quads q and 4 lanes n, banks 4q + j + n
// mod 32, all distinct.  Then each warp reads row c of the tile at 32
// consecutive n (banks c + n, distinct) and writes out[c * N + n0 + n],
// 128 contiguous bytes per store instruction.  Stores are scalar along n:
// for N % 4 != 0 the output rows c * N are not 16-byte aligned.  Any other
// width C (or a table that is not 16-byte aligned) takes the same tile in
// passes of 32 columns with scalar loads, consecutive threads on
// consecutive words of one row.  Any N: the ragged last tile is masked.
// 65536 lanes make 512 CTAs, all resident at once on 132 SMs (8 of 256
// threads and 17 KB of shared memory each an SM).

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 128       // lanes of a tile
#define THREADS 256  // threads of a CTA
#define CB 32        // columns of a tile pass

template <typename Index, bool ROW32>
__global__ void __launch_bounds__(THREADS)
gather_rows_t_kernel(const float* __restrict__ table, const Index* __restrict__ idx,
                     float* __restrict__ out, int R, int C, int N) {
  __shared__ float tile[CB][NT + 1];
  __shared__ int rows[NT];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * NT;
  const int nt = min(NT, N - n0);
  if (tid < NT) {
    Index i = tid < nt ? idx[n0 + tid] : 0;
    rows[tid] = (int)(i < 0 ? 0 : (i > R - 1 ? R - 1 : i));
  }
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += CB) {
    if (ROW32) {
      // C == 32: thread k reads quad q = k % 8 of lane k / 8's row
#pragma unroll
      for (int k = tid; k < NT * 8; k += THREADS) {
        const int ln = k >> 3, q = k & 7;
        if (ln < nt) {
          const float4* row = reinterpret_cast<const float4*>(table + (int64_t)rows[ln] * 32);
          const float4 v = __ldg(row + q);
          tile[4 * q][ln] = v.x;
          tile[4 * q + 1][ln] = v.y;
          tile[4 * q + 2][ln] = v.z;
          tile[4 * q + 3][ln] = v.w;
        }
      }
    } else {
      for (int k = tid; k < NT * CB; k += THREADS) {
        const int ln = k / CB, c = k % CB;
        if (ln < nt && c0 + c < C) tile[c][ln] = __ldg(table + (int64_t)rows[ln] * C + c0 + c);
      }
    }
    __syncthreads();
    const int cw = ROW32 ? CB : min(CB, C - c0);
#pragma unroll 4
    for (int k = tid; k < cw * NT; k += THREADS) {
      const int c = k / NT, ln = k % NT;
      if (ln < nt) out[(int64_t)(c0 + c) * N + n0 + ln] = tile[c][ln];
    }
    __syncthreads();
  }
}

template <typename Index>
static int launch(const void* table, const void* idx, void* out, int R, int C, int N,
                  void* stream) {
  if (N > 0 && C > 0) {
    const int blocks = (N + NT - 1) / NT;
    cudaStream_t s = (cudaStream_t)stream;
    if (C == 32 && ((uintptr_t)table & 15) == 0) {
      gather_rows_t_kernel<Index, true><<<blocks, THREADS, 0, s>>>(
          (const float*)table, (const Index*)idx, (float*)out, R, C, N);
    } else {
      gather_rows_t_kernel<Index, false><<<blocks, THREADS, 0, s>>>(
          (const float*)table, (const Index*)idx, (float*)out, R, C, N);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_t_i32(const void* table, const void* idx, void* out,
                                 int R, int C, int N, void* stream) {
  return launch<int32_t>(table, idx, out, R, C, N, stream);
}

extern "C" int gather_rows_t_i64(const void* table, const void* idx, void* out,
                                 int R, int C, int N, void* stream) {
  return launch<int64_t>(table, idx, out, R, C, N, stream);
}
