// Four-step negacyclic NTT / INTT for primes q < 2^29 as two exact int8
// digit matmuls on Hopper's tensor cores (sm_90a, mma.sync).
//
// Replaces the TPU kernel lattigo_tpu/ring/ntt_mxu.py::_ntt_mxu_kernel
// (forward branch :277-284, inverse branch :269-276), driven there by
// NTTMxu._call. It computes the same function bit for bit, lazy range
// included: N = R*C (C = 128, R = 32, 64, 128, 256 for logN = 12 .. 15;
// R = C = 256 for logN = 16), the polynomial is split into four balanced
// base-256 digit planes, each contraction is one [4A, 4A] x [4A, B]
// product of int8 digits with int32 sums (|P| <= 128*128*4A <= 2^24 for
// A <= 256, so the s8 x s8 -> s32 tensor-core product is exact), the
// planes are recombined mod q with one 32-bit Montgomery multiply split at
// 2^24 (each plane offset by 2^24, so its word u = P + 2^24 lies in
// [0, 2^25]), the mid-step twiddle is one more Montgomery multiply, and
// the result leaves in bit-reversed order, in [0, q) or, when lazy, in
// [0, 2q).
//
// What bounds it on an H100. Per (limb, polynomial) the two contractions
// are 16*R^2*C + 16*R*C^2 int8 multiply-adds (67M at logN=14, 537M at
// logN=16) against 16 N bytes of int64 in and out plus the limb's weight
// digits and twiddles (576 KB at logN=14, 2.3 MB at logN=16, shared by a
// call's polynomials). At the card's int8 rate the products take less
// time than those bytes up to logN 15, so the work is bound by device
// memory (7.3 us at 4 x 15 x 16384); at logN 16 on few polynomials a limb
// the products and the bytes come close. The products run on int8 tensor
// cores (mma.sync.m16n8k32.s8) so that they stay below the bytes. What
// holds this version back is on-chip traffic: without sharing weights
// between polynomials every block streams its limb's weight digits from
// L2 (a step's whole table in each of the S blocks of a pair), and every
// k step of a warp waits on those loads.
//
// Design.
// * Products: every contraction has the form
//   P[(s, a)][b] = sum_k W[(s, a)][k] * D[b][k], the weight digits as the
//   row-major A operand, the data digits as the column-major B operand.
//   The host keeps each weight table also in fragment order (NTTMxu,
//   mma_fragment_order), so one 16-byte ld.global.nc per lane feeds the
//   A fragment of one mma, kPrefetch k steps ahead of the products. The
//   data digits sit in shared memory with each B column's K bytes
//   contiguous and rows padded to 16 mod 128 bytes, so the 32-bit
//   B-fragment loads of a warp hit 32 banks.
// * Recombine in registers: a warp owns a 16-row slab of outputs a and NT
//   n8 tiles of columns b, and runs the four digit planes s = 0..3 of the
//   weights as four m16 tiles against the same B fragments. The four
//   planes of one output then sit in the same accumulator slot of the same
//   thread, so recombine, the twiddle and the next step's digits (or the
//   final normalisation and the int64 store) run on the accumulators.
// * logN 12-14, one fused launch, split over S blocks with no exchange.
//   The forward splits a (limb, polynomial) by t1: block k runs step 1
//   only on the weight rows (s, t1) of its t1 range, for every column, and
//   step 2 on those t1 columns only (output row t1 needs only row t1 of
//   step 1). The inverse splits by j2: step 1 on the rows (s, j2) of its
//   j2 range, step 2 on those j2 columns. Every block reads the whole
//   polynomial (the second and later reads come from L2) and does 1/S of
//   the multiply-adds; the outputs are disjoint. Shared memory: the
//   input's digit planes (4N bytes plus padding) and 1/S of the
//   intermediate's.
// * logN 15-16, two launches a call (ntt_mxu_kernel_step). The input's
//   4N digit bytes (128 and 256 KB) do not fit a block's shared memory
//   next to anything else, so each step runs as a launch of its own over
//   slabs of its B columns: step 1's block holds 1/S of the input's
//   columns (forward: j2; inverse: t1) with their whole contraction, runs
//   every weight row against them, twiddles, and writes the next step's
//   digits to a scratch tensor in device memory, laid out as step 2's B
//   operand (4N bytes a (limb, polynomial), read back mostly from L2);
//   step 2's block copies 1/S of those columns (forward: t1; inverse: j2)
//   into shared memory and runs every weight row against them. A block
//   then needs (4K + 16) bytes a column of its slab, K = R or C.
// * One block of 256 threads, int64 in and out in the [..., limbs, N]
//   layout with a limb offset, a template per logN and split S: S in
//   {1, 2, 4, 8} at logN 12-14, {2, 4, 8} at logN 15-16. The wrapper
//   (ring/ntt_mxu.py::NTTMxu.split_for) takes the least S at which two
//   blocks share an SM and every SM gets a block: small calls split up to
//   8 ways, at logN = 14 and 15 never less than 2, at logN 16 never less
//   than 4 (one block at S = 1 fills an SM at logN 14-15, and does not
//   fit one at logN 16).
// Left for later versions: several polynomials per block (to share the
// weight loads), wgmma with TMA-fed shared-memory tiles, clusters, and a
// fused logN 15-16 kernel that streams K through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;     // blocks per SM the registers must allow
constexpr int kPrefetch = 1;      // k steps the A fragments load ahead

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

// Balanced base-256 digits of x < 2^30, each in [-128, 128], as their
// two's-complement bytes (the low byte of the running value is the digit's
// byte whether or not it carries).
__device__ __forceinline__ void digits4(uint32_t x, uint32_t d[4]) {
  uint32_t v = x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = v & 0xFFu;
    v = (v >> 8) + (d[i] >> 7);
  }
}

// Final Montgomery exit to [0, 2q), then to [0, q) unless lazy.
__device__ __forceinline__ int64_t finish(int p0, int p1, int p2, int p3,
                                          const LimbConsts& k, bool lazy) {
  uint32_t v = mred_lazy32(recombine(p0, p1, p2, p3, k), k.onem, k.q, k.qinv);
  if (!lazy && v >= k.q) v -= k.q;
  return static_cast<int64_t>(v);
}

// d += a * b on the tensor cores: A 16x32 s8 (row), B 32x8 s8 (col),
// D 16x8 s32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// n8 tiles a warp takes at once: up to 4, fewer where that leaves warps
// without work.
__host__ __device__ constexpr int pick_nt(int slabs, int ntiles) {
  int nt = 4;
  while (nt > 1 && (ntiles % nt != 0 || slabs * (ntiles / nt) < kWarps)) nt /= 2;
  return nt;
}

// P_s[a][b] = sum_k W[s*A + a0 + a][k] * B[b*LD + k] over k < K, for
// a < AN, b < BN, with a0 = 16*mt0 and A = 16*MT rows in each plane s.
// W is in fragment order: [4*MT m16 tiles][K/32 k steps][32 lanes] x 16
// bytes, lane (g, t) holding rows g and g+8 at k 4t..4t+3 and 16+4t..19+4t
// (the a0..a3 registers of mma.m16n8k32). epi(a, b, p) consumes the four
// planes' sums p[s][j] of outputs (a, b + j), j = 0, 1.
template <int AN, int BN, int K, int LD, int MT, class Epi>
__device__ __forceinline__ void digit_matmul(const uint4* __restrict__ w,
                                             int mt0, const int8_t* b,
                                             Epi epi) {
  constexpr int KS = K / 32;
  constexpr int SLABS = AN / 16;
  constexpr int NTILES = BN / 8;
  constexpr int NT = pick_nt(SLABS, NTILES);
  constexpr int NCH = NTILES / NT;
  constexpr int PLANE = MT * KS * 32;           // uint4s from plane s to s+1
  static_assert(AN % 16 == 0 && BN % 8 == 0 && K % 32 == 0, "tile shapes");
  static_assert(LD % 128 == 16, "B rows must start 4 banks apart");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int u = threadIdx.x >> 5; u < SLABS * NCH; u += kWarps) {
    const int slab = u / NCH;
    const int n0 = (u % NCH) * (NT * 8);
    const uint4* wp = w + static_cast<size_t>(mt0 + slab) * KS * 32 + lane;
    const int8_t* bp = b + (n0 + g) * LD + 4 * t;
    int acc[4][NT][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][nt][r] = 0;
    // a ring of A fragments, loaded kPrefetch k steps ahead of the products
    // (the loops are unrolled, so the ring lives in registers)
    constexpr int RING = kPrefetch + 1;
    uint4 a[RING][4];
#pragma unroll
    for (int ks = 0; ks < kPrefetch && ks < KS; ++ks)
#pragma unroll
      for (int s = 0; s < 4; ++s) a[ks][s] = __ldg(wp + s * PLANE + ks * 32);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks + kPrefetch < KS) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          a[(ks + kPrefetch) % RING][s] =
              __ldg(wp + s * PLANE + (ks + kPrefetch) * 32);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* bk = bp + nt * 8 * LD + ks * 32;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bk);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bk + 16);
#pragma unroll
        for (int s = 0; s < 4; ++s) mma_s8(acc[s][nt], a[ks % RING][s], b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p[4][2];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          p[s][0] = acc[s][nt][2 * h];
          p[s][1] = acc[s][nt][2 * h + 1];
        }
        epi(slab * 16 + g + 8 * h, n0 + nt * 8 + 2 * t, p);
      }
  }
}

// Shared memory of one block. Forward: IN = [C][LDR] digits of x (B of
// step 1: column j2, k = (i, j1)), MID = [R/S][LDC] digits of step 1
// (B of step 2: column t1, k = (i, j2)). Inverse: IN = [R][LDC] digits of
// x (B of step 1: column t1, k = (i, t2)), MID = [C/S][LDR] digits of
// step 1 (B of step 2: column j2, k = (i, t1)).
template <int R, int C, int S, bool INV>
struct Layout {
  static constexpr int LDR = 4 * R + 16;
  static constexpr int LDC = 4 * C + 16;
  static constexpr int IN_BYTES = INV ? R * LDC : C * LDR;
  static constexpr int MID_BYTES = INV ? (C / S) * LDR : (R / S) * LDC;
  static constexpr int SMEM_BYTES = IN_BYTES + MID_BYTES;
  static_assert(C == 128 && R >= 32 && R <= C, "logN 12..14 (wider: StepLayout)");
  static_assert((INV ? C : R) / S >= 16, "a block needs a whole m16 slab");
};

// x, out: int64 [rows, N] with row = poly * limbs + limb; block
// row * S + part. Weight tables in fragment order, per limb:
// forward w1 = W1f [4R, 4R] (rows (s,t1), k (i,j1)), tw = TF [R, C],
// w2 = W2f transposed [4C, 4C] (rows (s,t2), k (i,j2));
// inverse w1 = W1i transposed [4C, 4C] (rows (s,j2), k (i,t2)),
// tw = TI transposed [C, R], w2 = W2i [4R, 4R] (rows (s,j1), k (i,t1)).
template <int R, int C, int S, bool INV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ntt_mxu_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
               const uint32_t* __restrict__ consts,
               const uint4* __restrict__ w1, const uint32_t* __restrict__ tw,
               const uint4* __restrict__ w2, int limbs, int limb_lo,
               int lazy_flag) {
  using L = Layout<R, C, S, INV>;
  constexpr int N = R * C;
  constexpr int LDR = L::LDR;
  constexpr int LDC = L::LDC;
  constexpr int A1 = INV ? C : R;            // step 1 weights [4 A1, 4 A1]
  constexpr int A2 = INV ? R : C;            // step 2 weights [4 A2, 4 A2]
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* in = smem;
  int8_t* mid = smem + L::IN_BYTES;

  const int row = static_cast<int>(blockIdx.x) / S;
  const int part = static_cast<int>(blockIdx.x) % S;
  const int limb = row % limbs + limb_lo;
  const int64_t* xr = x + static_cast<size_t>(row) * N;
  int64_t* outr = out + static_cast<size_t>(row) * N;
  const uint32_t* kc = consts + limb * 8;
  const LimbConsts k{kc[0], kc[1], kc[2], kc[3], kc[4]};
  const bool lazy = lazy_flag != 0;
  const uint4* w1l = w1 + static_cast<size_t>(limb) * A1 * A1;
  const uint4* w2l = w2 + static_cast<size_t>(limb) * A2 * A2;
  const uint32_t* twl = tw + static_cast<size_t>(limb) * N;

  if constexpr (!INV) {
    // Entry reduction to [0, 2q) < 2^30 and the digit planes, transposed:
    // in[c][(i, r)]. A warp takes 8 neighbouring columns by 4 quads of
    // rows, so its loads are 64-byte runs and its word stores hit 32 banks.
    constexpr int CB = C / 8;
#pragma unroll 4
    for (int it = threadIdx.x; it < N / 4; it += kThreads) {
      const int c = (it & 7) | (((it >> 5) % CB) << 3);
      const int r = 4 * (((it >> 3) & 3) | (((it >> 5) / CB) << 2));
      uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = mred_lazy32(
            static_cast<uint32_t>(static_cast<uint64_t>(xr[(r + j) * C + c])),
            k.onem, k.q, k.qinv);
        uint32_t d[4];
        digits4(v, d);
#pragma unroll
        for (int i = 0; i < 4; ++i) pk[i] |= d[i] << (8 * j);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(in + c * LDR + i * R + r) = pk[i];
    }
    __syncthreads();

    constexpr int RS = R / S;
    const int t1b = part * RS;
    // step 1: contract j1 on rows (s, t1) of this block's t1 range,
    // twiddle, digits for step 2 into mid[t1 - t1b][(i, j2)]
    digit_matmul<RS, C, 4 * R, LDR, R / 16>(
        w1l, t1b / 16, in, [&](int a, int c, const int (&p)[4][2]) {
          const uint2 tw2 = __ldg(reinterpret_cast<const uint2*>(
              twl + (t1b + a) * C + c));
          uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t v = mred_lazy32(
                recombine(p[0][j], p[1][j], p[2][j], p[3][j], k),
                j ? tw2.y : tw2.x, k.q, k.qinv);
            uint32_t d[4];
            digits4(v, d);
#pragma unroll
            for (int i = 0; i < 4; ++i) pk[i] |= d[i] << (8 * j);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint16_t*>(mid + a * LDC + i * C + c) =
                static_cast<uint16_t>(pk[i]);
        });
    __syncthreads();
    // step 2: contract j2 on every row (s, t2), for this block's t1
    // columns; normalise and store out[t1][t2]
    digit_matmul<C, RS, 4 * C, LDC, C / 16>(
        w2l, 0, mid, [&](int t2, int b, const int (&p)[4][2]) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            outr[(t1b + b + j) * C + t2] =
                finish(p[0][j], p[1][j], p[2][j], p[3][j], k, lazy);
        });
  } else {
    // Entry reduction and digit planes in[t1][(i, t2)]: a thread takes four
    // neighbouring coefficients of a row and stores one word per plane.
#pragma unroll 4
    for (int it = threadIdx.x; it < N / 4; it += kThreads) {
      const int t1 = it / (C / 4);
      const int t2 = 4 * (it % (C / 4));
      uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = mred_lazy32(
            static_cast<uint32_t>(static_cast<uint64_t>(xr[4 * it + j])),
            k.onem, k.q, k.qinv);
        uint32_t d[4];
        digits4(v, d);
#pragma unroll
        for (int i = 0; i < 4; ++i) pk[i] |= d[i] << (8 * j);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(in + t1 * LDC + i * C + t2) = pk[i];
    }
    __syncthreads();

    constexpr int CS = C / S;
    const int j2b = part * CS;
    // step 1: contract t2 on rows (s, j2) of this block's j2 range, for
    // every t1; twiddle, digits for step 2 into mid[j2 - j2b][(i, t1)]
    digit_matmul<CS, R, 4 * C, LDC, C / 16>(
        w1l, j2b / 16, in, [&](int a, int t1, const int (&p)[4][2]) {
          const uint2 tw2 = __ldg(reinterpret_cast<const uint2*>(
              twl + (j2b + a) * R + t1));
          uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t v = mred_lazy32(
                recombine(p[0][j], p[1][j], p[2][j], p[3][j], k),
                j ? tw2.y : tw2.x, k.q, k.qinv);
            uint32_t d[4];
            digits4(v, d);
#pragma unroll
            for (int i = 0; i < 4; ++i) pk[i] |= d[i] << (8 * j);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint16_t*>(mid + a * LDR + i * R + t1) =
                static_cast<uint16_t>(pk[i]);
        });
    __syncthreads();
    // step 2: contract t1 on every row (s, j1), for this block's j2
    // columns; normalise and store out[j1][j2] two at a time
    digit_matmul<R, CS, 4 * R, LDR, R / 16>(
        w2l, 0, mid, [&](int j1, int b, const int (&p)[4][2]) {
          longlong2 o;
          o.x = finish(p[0][0], p[1][0], p[2][0], p[3][0], k, lazy);
          o.y = finish(p[0][1], p[1][1], p[2][1], p[3][1], k, lazy);
          *reinterpret_cast<longlong2*>(outr + j1 * C + j2b + b) = o;
        });
  }
}

// Shared memory of one block of a step launch (logN 15-16): its slab of
// the step's B columns, each with the K = 4A bytes of its contraction,
// rows padded to 16 mod 128 bytes. Forward step 1: C/S columns j2, A = R;
// step 2: R/S columns t1, A = C. Inverse step 1: R/S columns t1, A = C;
// step 2: C/S columns j2, A = R. Step s's weights are [4A, 4A].
template <int R, int C, int S, int STEP, bool INV>
struct StepLayout {
  static constexpr bool KR = (STEP == 1) != INV;   // contracts over R
  static constexpr int A = KR ? R : C;
  static constexpr int COLS = (KR ? C : R) / S;
  static constexpr int LD = 4 * A + 16;
  static constexpr int SMEM_BYTES = COLS * LD;
  static_assert(R == 256 && (C == 128 || C == 256), "logN 15..16");
  static_assert(COLS >= 16 && COLS % 16 == 0, "a slab of 16 columns or more");
};

// One step of a logN 15-16 call. x, out: int64 [rows, N]; mid: int8
// [rows, 4N], step 1's digits as step 2's B operand: forward mid[t1][(i,
// j2)] (4C bytes a t1), inverse mid[j2][(i, t1)] (4R bytes a j2). Block
// row * S + part takes the part-th slab of the step's B columns. Weights
// in fragment order as for ntt_mxu_kernel: step 1 forward W1f, inverse
// W1i transposed; step 2 forward W2f transposed, inverse W2i; tw (step 1
// only) TF [R, C] forward, TI transposed [C, R] inverse.
template <int R, int C, int S, int STEP, bool INV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ntt_mxu_kernel_step(const int64_t* __restrict__ x, int8_t* __restrict__ mid,
                    int64_t* __restrict__ out,
                    const uint32_t* __restrict__ consts,
                    const uint4* __restrict__ w,
                    const uint32_t* __restrict__ tw, int limbs, int limb_lo,
                    int lazy_flag) {
  using L = StepLayout<R, C, S, STEP, INV>;
  constexpr int N = R * C;
  constexpr int A = L::A;
  constexpr int COLS = L::COLS;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) int8_t smem[];

  const int row = static_cast<int>(blockIdx.x) / S;
  const int part = static_cast<int>(blockIdx.x) % S;
  const int limb = row % limbs + limb_lo;
  const uint32_t* kc = consts + limb * 8;
  const LimbConsts k{kc[0], kc[1], kc[2], kc[3], kc[4]};
  const uint4* wl = w + static_cast<size_t>(limb) * A * A;
  int8_t* midr = mid + static_cast<size_t>(row) * 4 * N;
  const int c0 = part * COLS;                 // the slab's first B column

  if constexpr (STEP == 1) {
    const int64_t* xr = x + static_cast<size_t>(row) * N;
    if constexpr (!INV) {
      // Entry reduction to [0, 2q) < 2^30 and the digit planes of columns
      // j2 = c0 + c, transposed: smem[c][(i, j1)]. A warp takes 8
      // neighbouring columns by 4 quads of rows, as ntt_mxu_kernel does.
      constexpr int CB = COLS / 8;
#pragma unroll 4
      for (int it = threadIdx.x; it < COLS * R / 4; it += kThreads) {
        const int c = (it & 7) | (((it >> 5) % CB) << 3);
        const int r = 4 * (((it >> 3) & 3) | (((it >> 5) / CB) << 2));
        uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = mred_lazy32(static_cast<uint32_t>(
              static_cast<uint64_t>(xr[(r + j) * C + c0 + c])),
              k.onem, k.q, k.qinv);
          uint32_t d[4];
          digits4(v, d);
#pragma unroll
          for (int i = 0; i < 4; ++i) pk[i] |= d[i] << (8 * j);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint32_t*>(smem + c * LD + i * R + r) = pk[i];
      }
    } else {
      // Entry reduction and digit planes of rows t1 = c0 + t:
      // smem[t][(i, t2)], four neighbouring coefficients a thread.
#pragma unroll 4
      for (int it = threadIdx.x; it < COLS * C / 4; it += kThreads) {
        const int t = it / (C / 4);
        const int t2 = 4 * (it % (C / 4));
        uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = mred_lazy32(static_cast<uint32_t>(
              static_cast<uint64_t>(xr[c0 * C + 4 * it + j])),
              k.onem, k.q, k.qinv);
          uint32_t d[4];
          digits4(v, d);
#pragma unroll
          for (int i = 0; i < 4; ++i) pk[i] |= d[i] << (8 * j);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint32_t*>(smem + t * LD + i * C + t2) = pk[i];
      }
    }
    __syncthreads();
    // Every weight row (s, a) against the slab: forward a = t1 and column
    // j2, inverse a = j2 and column t1. Twiddle (TF[t1][j2], or TI
    // transposed [j2][t1]), then the digits into mid[a][(i, column)].
    constexpr int PL = INV ? R : C;           // a mid plane's bytes
    const uint32_t* twl = tw + static_cast<size_t>(limb) * N;
    digit_matmul<A, COLS, 4 * A, LD, A / 16>(
        wl, 0, smem, [&](int a, int c, const int (&p)[4][2]) {
          const uint2 tw2 = __ldg(reinterpret_cast<const uint2*>(
              twl + a * PL + c0 + c));
          uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t v = mred_lazy32(
                recombine(p[0][j], p[1][j], p[2][j], p[3][j], k),
                j ? tw2.y : tw2.x, k.q, k.qinv);
            uint32_t d[4];
            digits4(v, d);
#pragma unroll
            for (int i = 0; i < 4; ++i) pk[i] |= d[i] << (8 * j);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint16_t*>(midr + a * 4 * PL + i * PL + c0 + c) =
                static_cast<uint16_t>(pk[i]);
        });
  } else {
    // Step 1's digits of the slab's columns (forward t1, inverse j2), each
    // 4A contiguous bytes of mid, into smem[b][(i, k)] in 16-byte words.
    constexpr int WORDS = 4 * A / 16;
    const int8_t* src = midr + static_cast<size_t>(c0) * 4 * A;
#pragma unroll 4
    for (int it = threadIdx.x; it < COLS * WORDS; it += kThreads) {
      const int b = it / WORDS;
      const int v = it % WORDS;
      *reinterpret_cast<uint4*>(smem + b * LD + 16 * v) =
          *reinterpret_cast<const uint4*>(src + b * 4 * A + 16 * v);
    }
    __syncthreads();
    int64_t* outr = out + static_cast<size_t>(row) * N;
    digit_matmul<A, COLS, 4 * A, LD, A / 16>(
        wl, 0, smem, [&](int a, int b, const int (&p)[4][2]) {
          if constexpr (!INV) {
            // a = t2, column t1 = c0 + b: out[t1][t2]
#pragma unroll
            for (int j = 0; j < 2; ++j)
              outr[(c0 + b + j) * C + a] =
                  finish(p[0][j], p[1][j], p[2][j], p[3][j], k, lazy_flag != 0);
          } else {
            // a = j1, column j2 = c0 + b: out[j1][j2], two at a time
            longlong2 o;
            o.x = finish(p[0][0], p[1][0], p[2][0], p[3][0], k, lazy_flag != 0);
            o.y = finish(p[0][1], p[1][1], p[2][1], p[3][1], k, lazy_flag != 0);
            *reinterpret_cast<longlong2*>(outr + a * C + c0 + b) = o;
          }
        });
  }
}

template <int R, int C, int S, bool INV>
cudaError_t launch(const int64_t* x, int64_t* out, const uint32_t* consts,
                   const uint4* w1, const uint32_t* tw, const uint4* w2,
                   int rows, int limbs, int limb_lo, int lazy, int device,
                   cudaStream_t stream) {
  if constexpr ((INV ? C : R) / S < 16) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int smem = Layout<R, C, S, INV>::SMEM_BYTES;
    auto kern = ntt_mxu_kernel<R, C, S, INV>;
    static uint64_t ready = 0;               // devices with the attribute set
    const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
    if (!(ready & bit)) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      ready |= bit;
    }
    kern<<<rows * S, kThreads, smem, stream>>>(x, out, consts, w1, tw, w2,
                                               limbs, limb_lo, lazy);
    return cudaGetLastError();
  }
}

template <int R, int C, int S, int STEP, bool INV>
cudaError_t launch_step(const int64_t* x, int8_t* mid, int64_t* out,
                        const uint32_t* consts, const uint4* w,
                        const uint32_t* tw, int rows, int limbs, int limb_lo,
                        int lazy, int device, cudaStream_t stream) {
  constexpr int smem = StepLayout<R, C, S, STEP, INV>::SMEM_BYTES;
  auto kern = ntt_mxu_kernel_step<R, C, S, STEP, INV>;
  static uint64_t ready = 0;                 // devices with the attribute set
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(ready & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready |= bit;
  }
  kern<<<rows * S, kThreads, smem, stream>>>(x, mid, out, consts, w, tw, limbs,
                                             limb_lo, lazy);
  return cudaGetLastError();
}

// logN 15-16: step 1 into mid, then step 2 out of it, on one stream.
template <int R, int C, int S, bool INV>
cudaError_t launch_steps(const int64_t* x, int8_t* mid, int64_t* out,
                         const uint32_t* consts, const uint4* w1,
                         const uint32_t* tw, const uint4* w2, int rows,
                         int limbs, int limb_lo, int lazy, int device,
                         cudaStream_t stream) {
  if (mid == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = launch_step<R, C, S, 1, INV>(
      x, mid, out, consts, w1, tw, rows, limbs, limb_lo, lazy, device, stream);
  if (err != cudaSuccess) return err;
  return launch_step<R, C, S, 2, INV>(x, mid, out, consts, w2, tw, rows,
                                      limbs, limb_lo, lazy, device, stream);
}

template <bool INV>
cudaError_t dispatch(int logn, int split, const int64_t* x, int8_t* mid,
                     int64_t* out, const uint32_t* consts, const uint4* w1,
                     const uint32_t* tw, const uint4* w2, int rows, int limbs,
                     int limb_lo, int lazy, int device, cudaStream_t stream) {
#define NTT_MXU_CASE(LOGN, R, S)                                            \
  case (LOGN) * 16 + (S):                                                   \
    return launch<R, 128, S, INV>(x, out, consts, w1, tw, w2, rows, limbs,  \
                                  limb_lo, lazy, device, stream);
#define NTT_MXU_STEPS(LOGN, C, S)                                           \
  case (LOGN) * 16 + (S):                                                   \
    return launch_steps<256, C, S, INV>(x, mid, out, consts, w1, tw, w2,    \
                                        rows, limbs, limb_lo, lazy, device, \
                                        stream);
  switch (logn * 16 + split) {
    NTT_MXU_CASE(12, 32, 1)
    NTT_MXU_CASE(12, 32, 2)
    NTT_MXU_CASE(12, 32, 4)
    NTT_MXU_CASE(12, 32, 8)
    NTT_MXU_CASE(13, 64, 1)
    NTT_MXU_CASE(13, 64, 2)
    NTT_MXU_CASE(13, 64, 4)
    NTT_MXU_CASE(13, 64, 8)
    NTT_MXU_CASE(14, 128, 1)
    NTT_MXU_CASE(14, 128, 2)
    NTT_MXU_CASE(14, 128, 4)
    NTT_MXU_CASE(14, 128, 8)
    NTT_MXU_STEPS(15, 128, 2)
    NTT_MXU_STEPS(15, 128, 4)
    NTT_MXU_STEPS(15, 128, 8)
    NTT_MXU_STEPS(16, 256, 2)
    NTT_MXU_STEPS(16, 256, 4)
    NTT_MXU_STEPS(16, 256, 8)
    default:
      return cudaErrorInvalidValue;
  }
#undef NTT_MXU_CASE
#undef NTT_MXU_STEPS
}

}  // namespace

// What a launch needs of one engine, filled once by the binding: the
// tables on `device` (weights in fragment order) and logN.
struct NttMxuEngine {
  const uint32_t* consts;   // [L, 8]
  const uint4* w1f;         // [L, 16 R^2] bytes
  const uint32_t* tf;       // [L, R, C]
  const uint4* w2f;         // [L, 16 C^2] bytes
  const uint4* w1i;         // [L, 16 C^2] bytes
  const uint32_t* ti;       // [L, C, R]
  const uint4* w2i;         // [L, 16 R^2] bytes
  int logn;
  int device;
};

// flags: bit 0 inverse, bit 1 lazy. rows = polynomials x limbs; the grid
// is rows * split blocks. mid: int8 scratch of 4N bytes a row at logN
// 15-16 (two launches, step 1 then step 2), unused below. Launches on
// `stream` of the engine's device (made current for the launch when it is
// not) and returns the cudaError_t of the launches (0 on success).
extern "C" int ntt_mxu_launch(const void* x, void* mid, void* out,
                              const NttMxuEngine* eng, int flags, int rows,
                              int limbs, int limb_lo, int split, void* stream) {
  const int device = eng->device;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const auto* xi = static_cast<const int64_t*>(x);
  auto* mi = static_cast<int8_t*>(mid);
  auto* oi = static_cast<int64_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int lazy = (flags >> 1) & 1;
  err = flags & 1
            ? dispatch<true>(eng->logn, split, xi, mi, oi, eng->consts, eng->w1i,
                             eng->ti, eng->w2i, rows, limbs, limb_lo, lazy,
                             device, s)
            : dispatch<false>(eng->logn, split, xi, mi, oi, eng->consts, eng->w1f,
                              eng->tf, eng->w2f, rows, limbs, limb_lo, lazy,
                              device, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
