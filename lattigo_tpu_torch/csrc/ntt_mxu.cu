// Four-step negacyclic NTT / INTT for primes q < 2^29 as two exact int8
// digit matmuls on Hopper's tensor cores (sm_90a: mma.sync up to logN 14,
// wgmma on thread-block clusters at logN 15-16).
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
// [0, 2q). One launch a call at every N.
//
// What bounds it on an H100 (3.35 TB/s, 1979 int8 TOPS). Per (limb,
// polynomial) the two contractions are 16*R^2*C + 16*R*C^2 int8
// multiply-adds (67M at logN=14, 537M at logN=16) against 16 N bytes of
// int64 in and out plus the limb's weight digits and twiddles (576 KB at
// logN=14, 2.3 MB at logN=16, shared by a call's polynomials). Up to
// logN 15 the bytes bound it (7.3 us at 4 x 15 x 16384, 32.7 us at
// 4 x 31 x 32768); at logN 16 the two come close on few polynomials a
// limb (2 x 62 x 65536: 82.5 us by bytes, 67.3 by operations) and the
// operations bound it on many (256 x 1 x 65536: 138.9 us, bytes 80.8).
//
// logN 12-14: one fused launch (ntt_mxu_kernel).
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
// * Split over S blocks with no exchange. The forward splits a (limb,
//   polynomial) by t1: block k runs step 1 only on the weight rows (s, t1)
//   of its t1 range, for every column, and step 2 on those t1 columns only
//   (output row t1 needs only row t1 of step 1). The inverse splits by j2:
//   step 1 on the rows (s, j2) of its j2 range, step 2 on those j2
//   columns. Every block reads the whole polynomial (the second and later
//   reads come from L2) and does 1/S of the multiply-adds; the outputs are
//   disjoint. Shared memory: the input's digit planes (4N bytes plus
//   padding) and 1/S of the intermediate's. S in {1, 2, 4, 8}; the wrapper
//   (ring/ntt_mxu.py::NTTMxu.split_for) takes the least S at which two
//   blocks share an SM and every SM gets a block.
// * Left for later: several polynomials a block (to share the weight
//   loads) and wgmma, as at logN 15-16.
//
// logN 15-16: one launch on thread-block clusters (ntt_mxu_cluster_kernel).
// The input's 4N digit bytes (128 and 256 KB) do not fit one block, and
// without sharing every block would stream its step's whole weight table
// from L2 (16 A^2 bytes, 1 MB at A = 256): 325 MB a call at 4 x 31 x 32768,
// 1.04 GB at 2 x 62 x 65536, 2.15 GB at 256 x 1 x 65536, with the products
// on mma.sync at a quarter of the card's int8 rate. The design:
// * A cluster of S blocks (S = 2, 4, 8 at logN 15; 4, 8 at 16) takes one
//   limb and G = S * 2^14 / N polynomials of it (rows poly * limbs + limb
//   are `limbs` apart; a last group may be partial). Block k holds slab k
//   of step 1's B columns (forward j2, inverse t1) of each of them with
//   their whole contraction: 64 KB. Step 1's epilogue recombines,
//   twiddles and stores the digits straight into the step-2 slab (another
//   64 KB) of the cluster block that owns them, through distributed shared
//   memory (forward: block t1 / (R/S), its column (poly, t1), K bytes
//   (i, j2)). A cluster barrier, then step 2 runs from local shared memory
//   and stores the int64 output. No scratch in device memory.
// * Weight tiles by bulk copy, multicast: the host orders each table as
//   16 KB tiles (NTTMxu, wgmma_tile_order), each already in the layout the
//   wgmma descriptor reads; every block copies 1/S of a tile to all S
//   blocks (cp.async.bulk .multicast::cluster, completion on mbarriers),
//   so one L2 read serves the cluster and its G polynomials: weight bytes
//   read from L2 a call S times fewer than one read a block, 163 MB (325
//   before) at 4 x 31 x 32768, 260 MB (1040) at 2 x 62 x 65536, 537 MB
//   (2147) at 256 x 1 x 65536 at the least cluster, a quarter of that at
//   8. One producer thread keeps a ring of 6 tiles in flight, prefilled
//   while every thread of the block computes the entry digits.
// * Products on wgmma.m64nNk32.s32.s8.s8, both operands in shared memory:
//   the data digits are A (M = 64 columns), the weights B. A step runs as
//   8 jobs of A/2 weight rows, the four planes of A/8 rows a, as N: one
//   n128 at A = 256, two n64 on two 64-column groups at A = 128. The four
//   planes of one output then sit in the same thread, 4 * A/64 registers
//   apart (64 accumulators a thread), and the epilogues run on them.
//   Three consumer warpgroups take the tensor cores in turns, job by job
//   (a turn passes once a job's last products are queued), so that two
//   epilogues run under one group's products; setmaxnreg moves registers
//   from the producer group to them.
// * Shared memory: the slabs in wgmma's K-major layout without swizzle
//   (8-row x 16-byte core matrices; slab_off), columns paired within each
//   16 so that a thread's two accumulator rows hold neighbouring columns
//   and step 1's remote stores are whole words; 229472 bytes a block,
//   one block an SM. The rule (NTTMxu.split_for) takes the least cluster:
//   a larger one waits on more blocks for each ring slot, and is slower.
// * What holds it back on the H100 (bench_ntt_mxu.py,
//   bench_ntt_mxu_phases.py, PERF.md): shared memory. The two 64 KB slabs
//   leave 96 KB for the ring, 6 tiles, few for the round trip of a
//   multicast tile (released in every block, copied from L2), and every
//   16 KB tile feeds only 256 clocks of products (64 columns) against
//   about 40 KB of shared-memory traffic (its fill and the operand
//   reads), 312 clocks. The entry digits are not overlapped, and one
//   block an SM leaves nothing to fill the gaps.

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

// ---------------------------------------------------------------------------
// logN 15-16: one launch a call on a thread-block cluster (see the header).

constexpr int kGroups = 3;                          // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;
constexpr int kClusterThreads = kConsumers + 128;   // and a producer group
constexpr int kProducerRegs = 40;                   // registers a thread after
constexpr int kConsumerRegs = 152;                  // setmaxnreg: 63488 a block
constexpr int kSlabBytes = 65536;                   // one step's digit slab
constexpr int kStageBytes = 16384;                  // one weight tile
constexpr int kStages = 6;                          // the ring of tiles
constexpr int kClusterSmem =
    2 * kSlabBytes + kStages * kStageBytes + 16 * kStages;   // + mbarriers

// One step contracting over A (256 or 128): its weights [4A, 4A] run as 8
// jobs of A/2 rows, (s, a) for the plane s and A/8 rows a, which are a
// wgmma's N; its slab is 64 KB, 256/A groups of 64 columns (a wgmma's M)
// with their K = 4A digit bytes. A job is NKC weight tiles of KC bytes of
// K, KS k steps of 32 each, and 64 accumulators a thread.
template <int A>
struct StepShape {
  static constexpr int JOBS = 8;
  static constexpr int AJ = A / 8;
  static constexpr int J8 = AJ / 8;                // n8 blocks of a plane
  static constexpr int K = 4 * A;
  static constexpr int NG = 256 / A;
  static constexpr int KC = 2 * kStageBytes / A;
  static constexpr int NKC = K / KC;
  static constexpr int KS = KC / 32;
  static_assert(A == 128 || A == 256, "logN 15..16");
  static_assert(64 * NG * K == kSlabBytes, "a slab of 64 KB");
};

// A cluster of S blocks takes one limb and G polynomials of it. Step 1
// contracts over A1, step 2 over A2; block `rank` holds CW1 step-1 columns
// and CW2 step-2 columns of each polynomial (forward: j2 then t1; inverse:
// t1 then j2), from column rank * CW1 (or CW2) on.
template <int R, int C, int S, bool INV>
struct ClusterShape {
  static constexpr int N = R * C;
  static constexpr int CC = C;
  static constexpr int SIZE = S;
  static constexpr bool INVERSE = INV;
  static constexpr int G = S * 16384 / N;
  static constexpr int A1 = INV ? C : R;
  static constexpr int A2 = INV ? R : C;
  static constexpr int CW1 = A2 / S;
  static constexpr int CW2 = A1 / S;
  static_assert(R == 256 && (C == 128 || C == 256), "logN 15..16");
  static_assert(G >= 1 && G * CW1 * 4 * A1 == kSlabBytes &&
                    G * CW2 * 4 * A2 == kSlabBytes, "64 KB slabs");
  static_assert(CW1 % 16 == 0 && CW2 % 16 == 0, "whole 16-column groups");
};

// Byte of column col, K byte k in a slab of K bytes a column: wgmma's
// K-major layout without swizzle, core matrices of 8 rows (columns) x 16
// bytes, 8-row groups 8K bytes apart (SBO), K cores 128 bytes apart (LBO).
// Within each group of 16 columns, column c sits at row c / 2 + 8 (c & 1),
// so that a thread's two accumulator rows g and g + 8 hold neighbouring
// columns.
__device__ __forceinline__ int slab_off(int col, int k, int kbytes) {
  const int row = (col & ~15) | ((col & 15) >> 1) | ((col & 1) << 3);
  return (row >> 3) * 8 * kbytes + (k >> 4) * 128 + (row & 7) * 16 + (k & 15);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor: no swizzle, LBO 128 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` of the mbarrier at `bar`; a wait
// that has not ended after ~2^34 clocks (seconds) traps, so that a fault
// ends the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// Arrive on the mbarrier at offset `bar` of cluster block `rank`.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank) : "memory");
}

// Store a word at shared offset `addr` of cluster block `rank`.
__device__ __forceinline__ void st_at(uint32_t addr, uint32_t rank, uint32_t v) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "st.shared::cluster.u32 [ra], %2;\n}\n" ::"r"(addr),
      "r"(rank), "r"(v) : "memory");
}

// Copy `bytes` from global memory to offset `dst` of every cluster block
// in `mask`, completing on the mbarrier at offset `bar` of each.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Named barriers 2 + w between two consumer groups: group w waits there
// for its turn on the tensor cores, the group before it arrives.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

#define WG_R8(b)                                                             \
  "+r"(d[b]), "+r"(d[(b) + 1]), "+r"(d[(b) + 2]), "+r"(d[(b) + 3]),          \
      "+r"(d[(b) + 4]), "+r"(d[(b) + 5]), "+r"(d[(b) + 6]), "+r"(d[(b) + 7])

// d += a * b^T with a 64 x 32 and b N x 32 s8 (both K-major in shared
// memory), d 64 x N s32: N = 128 on all of d, N = 64 on its low or high
// half; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_n128(uint32_t (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : WG_R8(0), WG_R8(8),
        WG_R8(16), WG_R8(24),
        WG_R8(32), WG_R8(40),
        WG_R8(48), WG_R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64_lo(uint32_t (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : WG_R8(0), WG_R8(8),
        WG_R8(16), WG_R8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64_hi(uint32_t (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : WG_R8(32), WG_R8(40),
        WG_R8(48), WG_R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef WG_R8

// What a block of the cluster kernel knows of its call.
struct ClusterCtx {
  const int64_t* x;
  int64_t* out;
  const uint32_t* twl;      // the limb's twiddles (TF [R, C], or TI^T [C, R])
  LimbConsts k;
  uint32_t rank;            // of the block in its cluster
  uint32_t mid;             // shared offset of the step-2 slab
  int p0, polys, limbs, limb_i;
  bool lazy;
};

// Entry reduction to [0, 2q) and the digit planes of the block's step-1
// columns, by every thread of the block: slab[col][(i, kk)] for column
// col of polynomial col / CW1 (forward x[kk][j2], inverse x[t1][kk]). A
// warp takes 8 neighbouring columns by 4 quads of kk; a thread loads the
// low words of kBatch of its quads before it digitises them, so that
// enough reads are in flight to cover device memory's latency.
template <class Sh>
__device__ __forceinline__ void digitize(uint8_t* slab, const ClusterCtx& c) {
  constexpr int A1 = Sh::A1;
  constexpr int COLS = Sh::G * Sh::CW1;
  constexpr int CB = COLS / 8;
  constexpr int kIters = COLS * A1 / 4 / kClusterThreads;
  constexpr int kBatch = 8;
  static_assert(kIters % kBatch == 0, "whole batches");
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(c.x);
  for (int b0 = 0; b0 < kIters; b0 += kBatch) {
    uint32_t lo[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = threadIdx.x + (b0 + u) * kClusterThreads;
      const int col = (it & 7) | (((it >> 5) % CB) << 3);
      const int kk = 4 * (((it >> 3) & 3) | (((it >> 5) / CB) << 2));
      const int p = c.p0 + col / Sh::CW1;
      const int cg = static_cast<int>(c.rank) * Sh::CW1 + col % Sh::CW1;
      const size_t row = (static_cast<size_t>(p) * c.limbs + c.limb_i) * Sh::N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        lo[u][j] = p < c.polys ? __ldg(x32 + 2 * (row + (Sh::INVERSE ? cg * Sh::CC + kk + j
                                                                     : (kk + j) * Sh::CC + cg)))
                               : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = threadIdx.x + (b0 + u) * kClusterThreads;
      const int col = (it & 7) | (((it >> 5) % CB) << 3);
      const int kk = 4 * (((it >> 3) & 3) | (((it >> 5) / CB) << 2));
      const bool valid = c.p0 + col / Sh::CW1 < c.polys;
      uint32_t pk[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t d[4];
        digits4(mred_lazy32(lo[u][j], c.k.onem, c.k.q, c.k.qinv), d);
#pragma unroll
        for (int i = 0; i < 4; ++i) pk[i] |= (valid ? d[i] : 0) << (8 * j);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(slab + slab_off(col, i * A1 + kk, 4 * A1)) = pk[i];
    }
  }
}

// The producer (one thread): ring positions [from, to) of one step whose
// first tile is at ring position `base`. The step's tiles come job by job
// (job j taken by consumer group j % kGroups, in turn) in table order,
// each multicast to the cluster as S slices, this block's slice `rank`; a
// slot is refilled once every block's consuming group released it.
template <int A, int S>
__device__ __forceinline__ void produce(const uint8_t* table, uint32_t base,
                                        uint32_t from, uint32_t to, uint32_t ring,
                                        uint32_t full, uint32_t empty, uint32_t rank) {
  using St = StepShape<A>;
  constexpr uint32_t kSlice = kStageBytes / S;
  const uint32_t end = base + St::JOBS * St::NKC;
  for (uint32_t t = from > base ? from : base; t < end && t < to; ++t) {
    const uint32_t slot = t % kStages;
    const uint32_t round = t / kStages;
    if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);
    mbar_expect_tx(full + 8 * slot, kStageBytes);
    bulk_multicast(ring + slot * kStageBytes + rank * kSlice,
                   table + static_cast<size_t>(t - base) * kStageBytes + rank * kSlice,
                   kSlice, full + 8 * slot, static_cast<uint16_t>((1u << S) - 1));
  }
}

// Step 1's epilogue on one job's accumulators: recombine, twiddle, the
// digits of the output (a, column) into the step-2 slab of the block that
// owns row a, at its column (polynomial, a) and K bytes (i, column). Lane
// pairs (g, g ^ 1) swap halves so that each stores whole words: four
// neighbouring columns of one a and plane i.
template <class Sh>
__device__ __forceinline__ void epilogue1(const uint32_t (&acc)[64], int jb,
                                          const ClusterCtx& c) {
  using St = StepShape<Sh::A1>;
  constexpr int J8 = St::J8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = (threadIdx.x >> 5) & 3;
  const bool odd = g & 1;
#pragma unroll
  for (int cg = 0; cg < St::NG; ++cg) {
    const int colb = 64 * cg + 16 * wq + 2 * g;
    const int poly = colb / Sh::CW1;
    const int col = static_cast<int>(c.rank) * Sh::CW1 + colb % Sh::CW1;
    uint2 tws[J8][2];                         // the twiddles, all loads first
#pragma unroll
    for (int jj = 0; jj < J8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tws[jj][e] = __ldg(reinterpret_cast<const uint2*>(
            c.twl + (jb * St::AJ + 8 * jj + 2 * t + e) * Sh::A2 + col));
#pragma unroll
    for (int jj = 0; jj < J8; ++jj) {
      uint32_t pk[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint2 tw2 = tws[jj][e];
#pragma unroll
        for (int i = 0; i < 4; ++i) pk[e][i] = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * St::AJ * cg + 4 * jj + 2 * h + e;
          const uint32_t v = mred_lazy32(
              recombine(static_cast<int>(acc[r]), static_cast<int>(acc[r + 4 * J8]),
                        static_cast<int>(acc[r + 8 * J8]),
                        static_cast<int>(acc[r + 12 * J8]), c.k),
              h ? tw2.y : tw2.x, c.k.q, c.k.qinv);
          uint32_t d[4];
          digits4(v, d);
#pragma unroll
          for (int i = 0; i < 4; ++i) pk[e][i] |= d[i] << (8 * h);
        }
      }
      const int keep = odd ? 1 : 0;
      const uint32_t r01 = __shfl_xor_sync(
          0xFFFFFFFFu, pk[1 - keep][0] | pk[1 - keep][1] << 16, 4);
      const uint32_t r23 = __shfl_xor_sync(
          0xFFFFFFFFu, pk[1 - keep][2] | pk[1 - keep][3] << 16, 4);
      const uint32_t got[4] = {r01 & 0xFFFFu, r01 >> 16, r23 & 0xFFFFu, r23 >> 16};
      const int a = jb * St::AJ + 8 * jj + 2 * t + keep;
      const uint32_t owner = static_cast<uint32_t>(a / Sh::CW2);
      const int col2 = poly * Sh::CW2 + a % Sh::CW2;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st_at(c.mid + slab_off(col2, i * Sh::A2 + (col & ~3), 4 * Sh::A2), owner,
              odd ? got[i] | pk[1][i] << 16 : pk[0][i] | got[i] << 16);
    }
  }
}

// Step 2's epilogue: normalise the output (a, column) and store it,
// forward out[t1 = column][t2 = a], inverse out[j1 = a][j2 = column], two
// neighbouring words at a time.
template <class Sh>
__device__ __forceinline__ void epilogue2(const uint32_t (&acc)[64], int jb,
                                          const ClusterCtx& c) {
  using St = StepShape<Sh::A2>;
  constexpr int J8 = St::J8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int cg = 0; cg < St::NG; ++cg) {
    const int colb = 64 * cg + 16 * wq + 2 * g;
    const int p = c.p0 + colb / Sh::CW2;
    if (p >= c.polys) continue;
    const int col = static_cast<int>(c.rank) * Sh::CW2 + colb % Sh::CW2;
    int64_t* o = c.out + (static_cast<size_t>(p) * c.limbs + c.limb_i) * Sh::N;
#pragma unroll
    for (int jj = 0; jj < J8; ++jj) {
      const int a = jb * St::AJ + 8 * jj + 2 * t;
      int64_t v[2][2];                              // [h][e]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * St::AJ * cg + 4 * jj + 2 * h + e;
          v[h][e] = finish(static_cast<int>(acc[r]), static_cast<int>(acc[r + 4 * J8]),
                           static_cast<int>(acc[r + 8 * J8]),
                           static_cast<int>(acc[r + 12 * J8]), c.k, c.lazy);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        longlong2 o2;
        if constexpr (!Sh::INVERSE) {
          o2.x = v[u][0];
          o2.y = v[u][1];
          *reinterpret_cast<longlong2*>(o + (col + u) * Sh::CC + a) = o2;
        } else {
          o2.x = v[0][u];
          o2.y = v[1][u];
          *reinterpret_cast<longlong2*>(o + (a + u) * Sh::CC + col) = o2;
        }
      }
    }
  }
}

// One step of consumer group w: jobs w, w + kGroups, ..., each NKC tiles
// of the ring against the slab, wgmma groups one tile deep in flight; a
// tile's slot is released to every block of the cluster once its products
// are done. The groups take the tensor cores in turns, job by job (a turn
// passes once a job's last products are queued), so that the others'
// epilogues run under one's products, and the ring's tiles come in that
// order: `base` is the ring position of the step's first.
template <class Sh, int STEP>
__device__ __forceinline__ void consume(uint32_t slab, int w, uint32_t base,
                                        uint32_t ring, uint32_t full, uint32_t empty,
                                        const ClusterCtx& c) {
  constexpr int A = STEP == 1 ? Sh::A1 : Sh::A2;
  using St = StepShape<A>;
  constexpr uint32_t kSboSlab = 8 * St::K;
  constexpr uint32_t kSboTile = 8 * St::KC;
  // lane r of each warp arrives on the slot's barrier in cluster block r
  const int lane = threadIdx.x & 31;
  const auto release = [lane](uint32_t bar) {
    if (lane < Sh::SIZE) mbar_arrive_at(bar, lane);
  };
  for (int jb = w; jb < St::JOBS; jb += kGroups) {
    uint32_t acc[64];
    if (jb > 0) bar_sync(2 + w);
    uint32_t prev = 0;
    uint32_t t = base + jb * St::NKC;
    for (int kc = 0; kc < St::NKC; ++kc, ++t) {
      const uint32_t slot = t % kStages;
      mbar_wait(full + 8 * slot, (t / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < St::KS; ++ks) {
        const uint64_t db = wgmma_desc(ring + slot * kStageBytes + 256 * ks, kSboTile);
        const uint32_t ka = slab + (kc * St::KC / 16 + 2 * ks) * 128;
        const int sc = (kc | ks) != 0;
        if constexpr (St::NG == 1) {
          wgmma_n128(acc, wgmma_desc(ka, kSboSlab), db, sc);
        } else {
          wgmma_n64_lo(acc, wgmma_desc(ka, kSboSlab), db, sc);
          wgmma_n64_hi(acc, wgmma_desc(ka + 8 * kSboSlab, kSboSlab), db, sc);
        }
      }
      wgmma_commit();
      // the next group may start once this one's last products are queued
      if (kc == St::NKC - 1 && jb + 1 < St::JOBS) bar_arrive(2 + (jb + 1) % kGroups);
      if (kc > 0) {
        wgmma_wait<1>();
        release(empty + 8 * prev);
      }
      prev = slot;
    }
    wgmma_wait<0>();
    release(empty + 8 * prev);
    if constexpr (STEP == 1)
      epilogue1<Sh>(acc, jb, c);
    else
      epilogue2<Sh>(acc, jb, c);
  }
}

// x, out: int64 [rows, N], row = poly * limbs + limb; cluster
// limb_i * groups + group takes limb limb_i and the G polynomials of its
// group; block `rank` of it the rank-th slab of columns of each step.
// Weights in wgmma tile order (NTTMxu, wgmma_tile_order), per limb: step 1
// forward W1f [4R, 4R], inverse W1i^T [4C, 4C]; step 2 forward W2f^T
// [4C, 4C], inverse W2i [4R, 4R]; tw forward TF [R, C], inverse TI^T [C, R].
template <int R, int C, int S, bool INV>
__global__ void __launch_bounds__(kClusterThreads, 1)
ntt_mxu_cluster_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                       const uint32_t* __restrict__ consts,
                       const uint8_t* __restrict__ w1, const uint32_t* __restrict__ tw,
                       const uint8_t* __restrict__ w2, int polys, int limbs,
                       int limb_lo, int lazy_flag) {
  using Sh = ClusterShape<R, C, S, INV>;
  extern __shared__ __align__(128) uint8_t cluster_smem[];
  const uint32_t in = smem_addr(cluster_smem);
  const uint32_t mid = in + kSlabBytes;
  const uint32_t ring = mid + kSlabBytes;
  const uint32_t full = ring + kStages * kStageBytes;   // kStages mbarriers
  const uint32_t empty = full + 8 * kStages;            // kStages mbarriers
  const int groups = (polys + Sh::G - 1) / Sh::G;
  const int cl = static_cast<int>(cluster_index());
  const int limb_i = cl / groups;
  const int limb = limb_i + limb_lo;
  const uint32_t rank = cluster_rank();

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * S);     // a warp of each block's group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();

  const uint32_t* kc = consts + limb * 8;
  const ClusterCtx c{x, out, tw + static_cast<size_t>(limb) * Sh::N,
                     LimbConsts{kc[0], kc[1], kc[2], kc[3], kc[4]}, rank, mid,
                     (cl % groups) * Sh::G, polys, limbs, limb_i, lazy_flag != 0};
  const uint8_t* w1l = w1 + static_cast<size_t>(limb) * 16 * Sh::A1 * Sh::A1;
  const uint8_t* w2l = w2 + static_cast<size_t>(limb) * 16 * Sh::A2 * Sh::A2;
  const uint32_t base2 = StepShape<Sh::A1>::JOBS * StepShape<Sh::A1>::NKC;
  // the ring's first round needs no slot released: in flight during the
  // entry digits, which every thread computes
  if (threadIdx.x == kConsumers)
    produce<Sh::A1, S>(w1l, 0, 0, kStages, ring, full, empty, rank);
  digitize<Sh>(cluster_smem, c);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Two paths that never rejoin (setmaxnreg holds only so): the producer
  // group, whose first thread fills the ring, and the consumer groups.
  const int warp = threadIdx.x >> 5;
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    cluster_arrive();                        // the step barrier, ahead of time
    if (threadIdx.x == kConsumers) {
      produce<Sh::A1, S>(w1l, 0, kStages, ~0u, ring, full, empty, rank);
      produce<Sh::A2, S>(w2l, base2, kStages, ~0u, ring, full, empty, rank);
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive();                        // no block leaves while another
    cluster_wait();                          // may still reach its memory
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = warp >> 2;
    consume<Sh, 1>(in, w, 0, ring, full, empty, c);
    // step 1's digits reached every block of the cluster before step 2
    asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
    cluster_arrive();
    cluster_wait();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consume<Sh, 2>(mid, w, base2, ring, full, empty, c);
    cluster_arrive();
    cluster_wait();
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

// logN 15-16: limbs * ceil(polys / G) clusters of S blocks.
template <int R, int C, int S, bool INV>
cudaError_t launch_cluster(const int64_t* x, int64_t* out, const uint32_t* consts,
                           const uint4* w1, const uint32_t* tw, const uint4* w2,
                           int rows, int limbs, int limb_lo, int lazy, int device,
                           cudaStream_t stream) {
  using Sh = ClusterShape<R, C, S, INV>;
  if (limbs <= 0 || rows % limbs != 0) return cudaErrorInvalidValue;
  auto kern = ntt_mxu_cluster_kernel<R, C, S, INV>;
  static uint64_t ready = 0;                 // devices with the attribute set
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(ready & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem);
    if (err != cudaSuccess) return err;
    ready |= bit;
  }
  const int polys = rows / limbs;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(limbs * ((polys + Sh::G - 1) / Sh::G) * S);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = kClusterSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, x, out, consts, reinterpret_cast<const uint8_t*>(w1), tw,
      reinterpret_cast<const uint8_t*>(w2), polys, limbs, limb_lo, lazy);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool INV>
cudaError_t dispatch(int logn, int split, const int64_t* x, int64_t* out,
                     const uint32_t* consts, const uint4* w1, const uint32_t* tw,
                     const uint4* w2, int rows, int limbs, int limb_lo, int lazy,
                     int device, cudaStream_t stream) {
#define NTT_MXU_CASE(LOGN, R, S)                                            \
  case (LOGN) * 16 + (S):                                                   \
    return launch<R, 128, S, INV>(x, out, consts, w1, tw, w2, rows, limbs,  \
                                  limb_lo, lazy, device, stream);
#define NTT_MXU_CLUSTER(LOGN, C, S)                                         \
  case (LOGN) * 16 + (S):                                                   \
    return launch_cluster<256, C, S, INV>(x, out, consts, w1, tw, w2, rows, \
                                          limbs, limb_lo, lazy, device,     \
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
    NTT_MXU_CLUSTER(15, 128, 2)
    NTT_MXU_CLUSTER(15, 128, 4)
    NTT_MXU_CLUSTER(15, 128, 8)
    NTT_MXU_CLUSTER(16, 256, 4)
    NTT_MXU_CLUSTER(16, 256, 8)
    default:
      return cudaErrorInvalidValue;
  }
#undef NTT_MXU_CASE
#undef NTT_MXU_CLUSTER
}

}  // namespace

// What a launch needs of one engine, filled once by the binding: the
// tables on `device` (weights in the kernel's order: mma fragment order up
// to logN 14, wgmma tile order at 15-16) and logN.
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

// flags: bit 0 inverse, bit 1 lazy. rows = polynomials x limbs; split is
// the blocks per (limb, polynomial) up to logN 14 and the cluster size at
// 15-16. One launch on `stream` of the engine's device (made current for
// the launch when it is not); returns its cudaError_t (0 on success).
extern "C" int ntt_mxu_launch(const void* x, void* out, const NttMxuEngine* eng,
                              int flags, int rows, int limbs, int limb_lo,
                              int split, void* stream) {
  const int device = eng->device;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const auto* xi = static_cast<const int64_t*>(x);
  auto* oi = static_cast<int64_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int lazy = (flags >> 1) & 1;
  err = flags & 1
            ? dispatch<true>(eng->logn, split, xi, oi, eng->consts, eng->w1i,
                             eng->ti, eng->w2i, rows, limbs, limb_lo, lazy,
                             device, s)
            : dispatch<false>(eng->logn, split, xi, oi, eng->consts, eng->w1f,
                              eng->tf, eng->w2f, rows, limbs, limb_lo, lazy,
                              device, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
