// Four-step negacyclic NTT / INTT for primes q < 2^29 as two exact int8
// digit matmuls, for Hopper (sm_90a).
//
// Replaces the TPU kernel lattigo_tpu/ring/ntt_mxu.py::_ntt_mxu_kernel
// (forward branch :277-284, inverse branch :269-276), driven there by
// NTTMxu._call. It computes the same function bit for bit, lazy range
// included: N = R*C, the polynomial is split into four balanced base-256
// digit planes, each contraction is one [4A, 4A] x [4A, B] product of
// int8 digits with int32 sums (|P| <= 128*128*4A <= 2^23), the planes are
// recombined mod q with one 32-bit Montgomery multiply split at 2^24, the
// mid-step twiddle is one more Montgomery multiply, and the result leaves
// in bit-reversed order, in [0, q) or, when lazy, in [0, 2q).
//
// What bounds it on an H100. Per (limb, polynomial) the two contractions
// are 16*R^2*C + 16*R*C^2 int8 multiply-adds (67M at logN=14) against 16 N
// bytes of int64 in and out, so with int8 tensor cores the work would be
// bound by device memory. This first version computes the products with
// __dp4a on the integer ALUs, which makes it bound by integer operations,
// not bytes; PERF.md records its time beside the bytes bound.
//
// Design. One block of 256 threads per (limb, polynomial). The block reads
// its int64 coefficients once, reduces them (Montgomery entry reduction),
// and keeps the digit planes of both steps in shared memory (2 x 66 KB at
// logN=14), laid out so each output's contraction is contiguous in bytes
// (one int32 load feeds one __dp4a) and rows are padded by one word so the
// 32 lanes of a warp hit 32 banks. Each warp owns two output rows per pass
// and each lane four output columns, so a lane keeps 2 x 4 planes x 4
// columns int32 sums in registers; the weight digits are the same for the
// whole warp (one broadcast 16-byte load from L1/L2; 256 KB per limb stays
// L2-resident). The forward result is staged through shared memory so the
// int64 stores are coalesced. The TPU kernel's grid, its (8, 128) tiling
// and its limb-major transpose have no counterpart here: the kernel reads
// the [..., limbs, N] layout directly and takes a limb offset for the
// single-limb entry points. mma/wgmma s8 -> s32, TMA and several
// polynomials per block are left for a later version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;

struct LimbConsts {
  uint32_t q, qinv, c24m, negb, onem;
};

// a*b*2^-32 mod q in [0, 2q); needs a*b < q*2^32 (ntt_pallas._mred_lazy32).
__device__ __forceinline__ uint32_t mred_lazy32(uint32_t a, uint32_t b,
                                                uint32_t q, uint32_t qinv) {
  const uint32_t hi = __umulhi(a, b);
  const uint32_t m = a * b * qinv;
  return hi - __umulhi(m, q) + q;
}

// sum_s P_s 2^(8s) mod q from signed digit-plane sums; < 2^32, congruent
// mod q (ntt_mxu._recombine).
__device__ __forceinline__ uint32_t recombine(int p0, int p1, int p2, int p3,
                                              const LimbConsts& k) {
  const uint32_t u0 = static_cast<uint32_t>(p0 + (1 << 24));
  const uint32_t u1 = static_cast<uint32_t>(p1 + (1 << 24));
  const uint32_t u2 = static_cast<uint32_t>(p2 + (1 << 24));
  const uint32_t u3 = static_cast<uint32_t>(p3 + (1 << 24));
  const uint32_t lo = u0 + ((u1 & 0xFFFFu) << 8) + ((u2 & 0xFFu) << 16);
  const uint32_t hi = (u1 >> 16) + (u2 >> 8) + u3;
  return lo + mred_lazy32(hi, k.c24m, k.q, k.qinv) + k.negb;
}

// Balanced base-256 digits of x < 2^30, each in [-128, 128].
__device__ __forceinline__ void digits4(uint32_t x, int8_t d[4]) {
  uint32_t v = x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t dd = v & 0xFFu;
    const uint32_t c = dd >> 7;
    v = (v >> 8) + c;
    d[i] = static_cast<int8_t>(static_cast<int>(dd) - static_cast<int>(c << 8));
  }
}

// P_s[a][b] = sum_k W[s*A + a][k] * B[b*LD + k] over k < 4A, for every
// output (a, b), a < A, b < BN; epi(a, b, P_0, P_1, P_2, P_3) consumes it.
template <int A, int BN, int LD, class Epi>
__device__ __forceinline__ void digit_matmul(const int8_t* __restrict__ W,
                                             const int8_t* B, Epi epi) {
  constexpr int K = 4 * A;
  constexpr int JB = BN / 32;
  static_assert(A % (kWarps * kRowsPerWarp) == 0, "A must be a multiple of 16");
  static_assert(BN % 32 == 0 && JB >= 1 && JB <= 4, "BN must be 32..128");
  static_assert(LD % 4 == 0, "rows must stay word aligned");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int a0 = warp * kRowsPerWarp; a0 < A; a0 += kWarps * kRowsPerWarp) {
    int acc[kRowsPerWarp][4][JB];
#pragma unroll
    for (int ta = 0; ta < kRowsPerWarp; ++ta)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int jb = 0; jb < JB; ++jb) acc[ta][s][jb] = 0;
#pragma unroll 2
    for (int k = 0; k < K; k += 16) {
      int4 w[kRowsPerWarp][4];
#pragma unroll
      for (int ta = 0; ta < kRowsPerWarp; ++ta)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          w[ta][s] = __ldg(reinterpret_cast<const int4*>(
              W + static_cast<size_t>(s * A + a0 + ta) * K + k));
#pragma unroll
      for (int jb = 0; jb < JB; ++jb) {
        const int* brow = reinterpret_cast<const int*>(B + (lane + 32 * jb) * LD + k);
        const int d0 = brow[0], d1 = brow[1], d2 = brow[2], d3 = brow[3];
#pragma unroll
        for (int ta = 0; ta < kRowsPerWarp; ++ta)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            int v = acc[ta][s][jb];
            v = __dp4a(w[ta][s].x, d0, v);
            v = __dp4a(w[ta][s].y, d1, v);
            v = __dp4a(w[ta][s].z, d2, v);
            v = __dp4a(w[ta][s].w, d3, v);
            acc[ta][s][jb] = v;
          }
      }
    }
#pragma unroll
    for (int ta = 0; ta < kRowsPerWarp; ++ta)
#pragma unroll
      for (int jb = 0; jb < JB; ++jb)
        epi(a0 + ta, lane + 32 * jb, acc[ta][0][jb], acc[ta][1][jb],
            acc[ta][2][jb], acc[ta][3][jb]);
  }
}

template <int R, int C>
struct Layout {
  static constexpr int N = R * C;
  // digits for a contraction over rows: [C][4R + 4], k = (i, row)
  static constexpr int LDR = 4 * R + 4;
  // digits for a contraction over columns: [R][4C + 4], k = (i, col)
  static constexpr int LDC = 4 * C + 4;
  static constexpr int ROWS_BYTES = C * LDR;
  static constexpr int COLS_BYTES = R * LDC;
  static constexpr int SMEM_BYTES = ROWS_BYTES + COLS_BYTES;
  static_assert(R <= C, "staging of the forward output needs R <= C");
  static_assert(R * (C + 1) * 4 <= ROWS_BYTES, "staging must fit");
};

// x, out: int64 [blocks, N] with block = poly * limbs + limb.
// Forward tables: w1 = W1f [4R, 4R] (rows (s,t1), k (i,j1)), tw = TF [R, C],
// w2 = W2f transposed [4C, 4C] (rows (s,t2), k (i,j2)).
// Inverse tables: w1 = W1i transposed [4C, 4C] (rows (s,j2), k (i,t2)),
// tw = TI transposed [C, R], w2 = W2i [4R, 4R] (rows (s,j1), k (i,t1)).
template <int R, int C, bool INV>
__global__ void __launch_bounds__(kThreads)
ntt_mxu_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
               const uint32_t* __restrict__ consts,
               const int8_t* __restrict__ w1, const uint32_t* __restrict__ tw,
               const int8_t* __restrict__ w2, int limbs, int limb_lo,
               int lazy) {
  using L = Layout<R, C>;
  constexpr int N = L::N;
  constexpr int LDR = L::LDR;
  constexpr int LDC = L::LDC;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* rows = smem;
  int8_t* cols = smem + L::ROWS_BYTES;

  const int limb = static_cast<int>(blockIdx.x) % limbs + limb_lo;
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  const uint32_t* kc = consts + limb * 8;
  const LimbConsts k{kc[0], kc[1], kc[2], kc[3], kc[4]};
  constexpr size_t W1_SIZE = INV ? 16 * C * C : 16 * R * R;
  constexpr size_t W2_SIZE = INV ? 16 * R * R : 16 * C * C;
  const int8_t* w1l = w1 + limb * W1_SIZE;
  const int8_t* w2l = w2 + limb * W2_SIZE;
  const uint32_t* twl = tw + static_cast<size_t>(limb) * N;

  // Entry reduction to [0, 2q) < 2^30, then the four digit planes.
  for (int idx = threadIdx.x; idx < N; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const uint32_t v = mred_lazy32(
        static_cast<uint32_t>(static_cast<uint64_t>(x[base + idx])),
        k.onem, k.q, k.qinv);
    int8_t d[4];
    digits4(v, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (INV) cols[r * LDC + i * C + c] = d[i];
      else rows[c * LDR + i * R + r] = d[i];
    }
  }
  __syncthreads();

  if (!INV) {
    // step 1: contract j1 (rows), twiddle, digits for step 2
    digit_matmul<R, C, LDR>(w1l, rows, [&](int t1, int c, int p0, int p1,
                                           int p2, int p3) {
      uint32_t b = recombine(p0, p1, p2, p3, k);
      b = mred_lazy32(b, twl[t1 * C + c], k.q, k.qinv);
      int8_t d[4];
      digits4(b, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) cols[t1 * LDC + i * C + c] = d[i];
    });
    __syncthreads();
    // step 2: contract j2 (columns), normalise, stage for coalesced stores
    uint32_t* stage = reinterpret_cast<uint32_t*>(rows);
    digit_matmul<C, R, LDC>(w2l, cols, [&](int t2, int t1, int p0, int p1,
                                           int p2, int p3) {
      uint32_t v = mred_lazy32(recombine(p0, p1, p2, p3, k), k.onem, k.q, k.qinv);
      if (!lazy && v >= k.q) v -= k.q;
      stage[t1 * (C + 1) + t2] = v;
    });
    __syncthreads();
    for (int idx = threadIdx.x; idx < N; idx += kThreads)
      out[base + idx] = stage[(idx / C) * (C + 1) + idx % C];
  } else {
    // step 1: contract t2 (columns), twiddle, digits for step 2
    digit_matmul<C, R, LDC>(w1l, cols, [&](int j2, int t1, int p0, int p1,
                                           int p2, int p3) {
      uint32_t h = recombine(p0, p1, p2, p3, k);
      h = mred_lazy32(h, twl[j2 * R + t1], k.q, k.qinv);
      int8_t d[4];
      digits4(h, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) rows[j2 * LDR + i * R + t1] = d[i];
    });
    __syncthreads();
    // step 2: contract t1 (rows), normalise, store
    digit_matmul<R, C, LDR>(w2l, rows, [&](int j1, int j2, int p0, int p1,
                                           int p2, int p3) {
      uint32_t v = mred_lazy32(recombine(p0, p1, p2, p3, k), k.onem, k.q, k.qinv);
      if (!lazy && v >= k.q) v -= k.q;
      out[base + j1 * C + j2] = v;
    });
  }
}

template <int R, int C, bool INV>
cudaError_t launch(const int64_t* x, int64_t* out, const uint32_t* consts,
                   const int8_t* w1, const uint32_t* tw, const int8_t* w2,
                   int blocks, int limbs, int limb_lo, int lazy,
                   cudaStream_t stream) {
  constexpr int smem = Layout<R, C>::SMEM_BYTES;
  auto kern = ntt_mxu_kernel<R, C, INV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(x, out, consts, w1, tw, w2, limbs,
                                           limb_lo, lazy);
  return cudaGetLastError();
}

template <bool INV>
cudaError_t dispatch(int logn, const int64_t* x, int64_t* out,
                     const uint32_t* consts, const int8_t* w1,
                     const uint32_t* tw, const int8_t* w2, int blocks,
                     int limbs, int limb_lo, int lazy, cudaStream_t stream) {
  switch (logn) {
    case 12: return launch<32, 128, INV>(x, out, consts, w1, tw, w2, blocks, limbs, limb_lo, lazy, stream);
    case 13: return launch<64, 128, INV>(x, out, consts, w1, tw, w2, blocks, limbs, limb_lo, lazy, stream);
    case 14: return launch<128, 128, INV>(x, out, consts, w1, tw, w2, blocks, limbs, limb_lo, lazy, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ntt_mxu_launch(const void* x, void* out, const void* consts,
                              const void* w1, const void* tw, const void* w2,
                              int logn, int inverse, int lazy, int blocks,
                              int limbs, int limb_lo, void* stream) {
  const auto* xi = static_cast<const int64_t*>(x);
  auto* oi = static_cast<int64_t*>(out);
  const auto* ci = static_cast<const uint32_t*>(consts);
  const auto* w1i = static_cast<const int8_t*>(w1);
  const auto* twi = static_cast<const uint32_t*>(tw);
  const auto* w2i = static_cast<const int8_t*>(w2);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      inverse ? dispatch<true>(logn, xi, oi, ci, w1i, twi, w2i, blocks, limbs, limb_lo, lazy, s)
              : dispatch<false>(logn, xi, oi, ci, w1i, twi, w2i, blocks, limbs, limb_lo, lazy, s);
  return static_cast<int>(err);
}
