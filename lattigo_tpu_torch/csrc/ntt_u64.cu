// Negacyclic NTT / INTT of u64 residues for primes q < 2^61 at N = 2^15 and
// 2^16, with 64-bit Montgomery butterflies (R = 2^64), for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package runs this transform at the
// XLA level (lattigo_tpu/ring/ntt_u64_mxu.py, NTTMxu64, int8 digit matmuls
// for the TPU's matrix unit, which has no 64-bit integer multiply). The
// H100 has 64 integer lanes on each SM, so here the transform is the
// radix-2 lazy Harvey NTT of ring/ntt.py, butterfly for butterfly: forward
// stages fold x0 into [0, 2q), take v = MRedLazy(x1, w) and leave
// (x0 + v, x0 - v + 2q) in [0, 4q); inverse stages leave
// (fold(x0 + x1), MRedLazy(x0 - x1 + 2q, w)) in [0, 2q) and end with
// MRedLazy(x, N^-1). MRedLazy(a, b) = hi(a b) - hi(lo(a b) qinv q) + q, with
// __umul64hi, always the 64-bit route (a chain may mix 25- and 61-bit
// limbs). It reads the ring's own tables: the bit-reversed Montgomery root
// tables, N^-1 in Montgomery form, q and q^-1 mod 2^64. Inputs are in
// [0, 2q); outputs in [0, q), or [0, 2q) when lazy (the forward's [0, 4q)
// folded once more).
//
// What bounds it on an H100. A butterfly is one 64-bit Montgomery product
// (two 64 x 64 -> 128 high words and two low products, ~14 IMAD-class
// 32-bit instructions) and its adds, compares and selects, ~22 integer
// instructions. 2^16 points take 16 x 2^15 = 524,288 butterflies: ~0.78 us
// a row of 2^16 at 132 SMs x 64 lanes x ~1.75 GHz (~0.37 us a row of
// 2^15), 0.44 us for the IMADs alone at the 1980 MHz boost clock; the
// bytes, each residue read and written once as int64, take 0.31 / 0.16 us
// at 3.35 TB/s. So it is bound by 64-bit multiply throughput.
//
// Design, against that bound:
// * Two passes of N = N1 x 256 (N1 = 256 at 2^16, 128 at 2^15): the column
//   pass runs the first log N1 stages (pairs at strides >= 256) on each of
//   the 256 columns, the row pass the last 8 stages on each row of 256.
//   Each pass is one launch over all (polynomial, limb) rows; the second
//   works in place on the output. Every butterfly keeps ring/ntt.py's
//   arithmetic; only the order of independent butterflies changes.
// * Registers, not shared memory, do the arithmetic. A thread holds 16
//   coefficients of one column or row: 4 stages run on them in registers
//   (layout A, the thread's coefficients at stride P/16), one exchange
//   through shared memory regroups them (layout B, 16 neighbours), and the
//   remaining 3-4 stages run in registers again. Each stage gives a thread
//   8 independent butterflies, which keeps the integer pipes fed. Both
//   passes are held to two blocks of 256 an SM (at most 128 registers):
//   the row pass's inverse took 13% longer at its free 142.
// * Memory in whole lines. A column-pass block takes 4096 coefficients: 16
//   neighbouring columns at 2^16 (32 at 2^15) by all their rows, its lanes
//   spread over the columns, so every load and store is 128-byte runs. A
//   row pass takes 16 rows; each row is one half-warp, which reads and
//   writes it in layout A (neighbouring lanes, neighbouring words) and
//   regroups through a padded row of shared memory under __syncwarp.
// * Twiddles from the cache. The column pass reads the 255 roots every
//   block shares; the row pass reads its row's 255 (roots[(N1 + row) 2^s +
//   g] at its local stage s), from L2, shared by every polynomial of the
//   batch. No table is added.
//
// The kernel reads the port's int64 [..., limbs, N] layout directly (row =
// polynomial * limbs + limb), takes the limb offset of the single-limb entry
// points, writes int64, and returns the launches' cudaGetLastError(); there
// is no fallback.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int E = 16;          // coefficients a thread holds
constexpr int LOG2 = 8;        // row-pass stages
constexpr int N2 = 1 << LOG2;  // row length
constexpr int THREADS = 256;
constexpr int TILE = THREADS * E;   // coefficients a block takes
constexpr int ROWS = TILE / N2;     // rows a row-pass block takes
constexpr int ROW_PAD = N2 + N2 / E;

struct Mod {
  uint64_t q, qinv, q2;
};

// a*b*2^-64 mod q in [0, 2q) (modops.mred_lazy); needs a*b < q*2^64.
__device__ __forceinline__ uint64_t mred_lazy(uint64_t a, uint64_t b, Mod m) {
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t t = a * b * m.qinv;
  return hi - __umul64hi(t, m.q) + m.q;
}

__device__ __forceinline__ uint64_t fold(uint64_t x, uint64_t bound) {
  return x >= bound ? x - bound : x;
}

// forward (Cooley-Tukey) butterfly of ring/ntt.py's _fwd_stage
__device__ __forceinline__ void ct(uint64_t& a, uint64_t& b, uint64_t w,
                                   Mod m) {
  const uint64_t x0 = fold(a, m.q2);
  const uint64_t v = mred_lazy(b, w, m);
  a = x0 + v;
  b = x0 - v + m.q2;
}

// inverse (Gentleman-Sande) butterfly of ring/ntt.py's _inv_stage
__device__ __forceinline__ void gs(uint64_t& a, uint64_t& b, uint64_t w,
                                   Mod m) {
  const uint64_t x0 = a, x1 = b;
  a = fold(x0 + x1, m.q2);
  b = mred_lazy(x0 - x1 + m.q2, w, m);
}

// The stages of a P = 2^LP point sub-transform (a column or a row) that a
// thread's 16 coefficients v[k] allow. Layout A (B = false): v[k] sits at
// position tc + (P/16) k and takes local stages 0..3; layout B: v[k] sits
// at 16 tc + k and takes stages 4..LP-1. Group g of local stage s reads
// roots[(rb << s) + g] (rb = 1 for a column, N1 + row for a row). The
// forward runs the stages up, the inverse down.
template <int LP, bool B, bool INV, int STEP = 0>
__device__ __forceinline__ void stages(uint64_t* v, int tc,
                                       const uint64_t* __restrict__ roots,
                                       int rb, Mod m) {
  constexpr int S0 = B ? 4 : 0, S1 = B ? LP : 4;
  if constexpr (STEP < S1 - S0) {
    // one stage, its shape known at compile time so that every index into
    // v is a constant and v stays in registers
    constexpr int s = INV ? S1 - 1 - STEP : S0 + STEP;
    constexpr int hk = B ? 1 << (LP - 1 - s) : 8 >> s;   // pair distance in k
    constexpr int ng = E / (2 * hk);                      // groups a thread sees
    const uint64_t* rs = roots + (static_cast<size_t>(rb) << s) + (B ? tc * ng : 0);
#pragma unroll
    for (int j = 0; j < ng; ++j) {
      const uint64_t w = __ldg(rs + j);
#pragma unroll
      for (int i = 0; i < hk; ++i) {
        if constexpr (INV)
          gs(v[2 * hk * j + i], v[2 * hk * j + i + hk], w, m);
        else
          ct(v[2 * hk * j + i], v[2 * hk * j + i + hk], w, m);
      }
    }
    stages<LP, B, INV, STEP + 1>(v, tc, roots, rb, m);
  }
}

__device__ __forceinline__ Mod load_mod(const uint64_t* q, const uint64_t* qinv,
                                        int limb) {
  const uint64_t qq = q[limb];
  return Mod{qq, qinv[limb], 2 * qq};
}

// Column pass: the first LOG1 stages (forward) or the last ones of the
// inverse, on 256 / COLS blocks a row, each COLS neighbouring columns of
// P = 2^LOG1 coefficients. Thread (tc, c) holds column c0 + c. The inverse
// ends the transform: x N^-1 and the final reduction.
template <int LOG1, bool INV>
__global__ void __launch_bounds__(THREADS, 2)
ntt_u64_col(const int64_t* x, int64_t* out,
            const uint64_t* __restrict__ q, const uint64_t* __restrict__ qinv,
            const uint64_t* __restrict__ ninv,
            const uint64_t* __restrict__ roots, int limbs, int limb_lo,
            int lazy) {
  constexpr int P = 1 << LOG1, TC = P / E, COLS = TILE / P;
  constexpr int BPR = N2 / COLS;   // blocks a row
  constexpr size_t N = static_cast<size_t>(P) * N2;
  __shared__ uint64_t tile[TILE];
  const int tid = static_cast<int>(threadIdx.x);
  const int c = tid % COLS, tc = tid / COLS;
  const size_t row = blockIdx.x / BPR;
  const int col = static_cast<int>(blockIdx.x % BPR) * COLS + c;
  const int limb = static_cast<int>(row % limbs) + limb_lo;
  const Mod m = load_mod(q, qinv, limb);
  const uint64_t* rt = roots + static_cast<size_t>(limb) * N;
  const auto* src = reinterpret_cast<const uint64_t*>(x) + row * N + col;
  auto* dst = reinterpret_cast<uint64_t*>(out) + row * N + col;
  uint64_t v[E];
  // layout A: v[k] at row tc + TC k; layout B: at row 16 tc + k
  const auto pos_a = [tc](int k) { return tc + TC * k; };
  const auto pos_b = [tc](int k) { return E * tc + k; };
  if constexpr (!INV) {
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = src[static_cast<size_t>(pos_a(k)) * N2];
    stages<LOG1, false, false>(v, tc, rt, 1, m);
#pragma unroll
    for (int k = 0; k < E; ++k) tile[pos_a(k) * COLS + c] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = tile[pos_b(k) * COLS + c];
    stages<LOG1, true, false>(v, tc, rt, 1, m);
#pragma unroll
    for (int k = 0; k < E; ++k) dst[static_cast<size_t>(pos_b(k)) * N2] = v[k];
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = src[static_cast<size_t>(pos_b(k)) * N2];
    stages<LOG1, true, true>(v, tc, rt, 1, m);
#pragma unroll
    for (int k = 0; k < E; ++k) tile[pos_b(k) * COLS + c] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = tile[pos_a(k) * COLS + c];
    stages<LOG1, false, true>(v, tc, rt, 1, m);
    const uint64_t ni = ninv[limb];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const uint64_t y = mred_lazy(v[k], ni, m);
      dst[static_cast<size_t>(pos_a(k)) * N2] = lazy ? y : fold(y, m.q);
    }
  }
}

// Row pass: the last 8 stages (forward) or the first 8 of the inverse, on
// N1 / 16 blocks a row, each 16 rows of 256; row r of the block is one
// half-warp (tc = lane % 16). Global memory is read and written in layout A
// (neighbouring lanes, neighbouring words); the regrouping goes through a
// padded row of shared memory. The forward ends the transform with the
// final reduction.
template <int LOG1, bool INV>
__global__ void __launch_bounds__(THREADS, 2)
ntt_u64_row(const int64_t* x, int64_t* out,
            const uint64_t* __restrict__ q, const uint64_t* __restrict__ qinv,
            const uint64_t* __restrict__ roots, int limbs, int limb_lo,
            int lazy) {
  constexpr int N1 = 1 << LOG1, BPR = N1 / ROWS;
  constexpr size_t N = static_cast<size_t>(N1) * N2;
  __shared__ uint64_t tile[ROWS * ROW_PAD];
  const int tid = static_cast<int>(threadIdx.x);
  const int tc = tid % E, r = tid / E;
  const size_t row = blockIdx.x / BPR;
  const int i1 = static_cast<int>(blockIdx.x % BPR) * ROWS + r;
  const int limb = static_cast<int>(row % limbs) + limb_lo;
  const Mod m = load_mod(q, qinv, limb);
  const uint64_t* rt = roots + static_cast<size_t>(limb) * N;
  const size_t off = row * N + static_cast<size_t>(i1) * N2;
  const auto* src = reinterpret_cast<const uint64_t*>(x) + off;
  auto* dst = reinterpret_cast<uint64_t*>(out) + off;
  uint64_t* sh = tile + r * ROW_PAD;
  // one pad word every 16, so that layout B's stride-16 lanes miss each
  // other's banks
  const auto pad = [](int p) { return p + p / E; };
  const auto pos_a = [tc](int k) { return tc + E * k; };
  const auto pos_b = [tc](int k) { return E * tc + k; };
  const int rb = N1 + i1;
  uint64_t v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = src[pos_a(k)];
  if constexpr (!INV) {
    stages<LOG2, false, false>(v, tc, rt, rb, m);
#pragma unroll
    for (int k = 0; k < E; ++k) sh[pad(pos_a(k))] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = sh[pad(pos_b(k))];
    stages<LOG2, true, false>(v, tc, rt, rb, m);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const uint64_t y = fold(v[k], m.q2);
      v[k] = lazy ? y : fold(y, m.q);
    }
#pragma unroll
    for (int k = 0; k < E; ++k) sh[pad(pos_b(k))] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < E; ++k) dst[pos_a(k)] = sh[pad(pos_a(k))];
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) sh[pad(pos_a(k))] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = sh[pad(pos_b(k))];
    stages<LOG2, true, true>(v, tc, rt, rb, m);
#pragma unroll
    for (int k = 0; k < E; ++k) sh[pad(pos_b(k))] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = sh[pad(pos_a(k))];
    stages<LOG2, false, true>(v, tc, rt, rb, m);
#pragma unroll
    for (int k = 0; k < E; ++k) dst[pos_a(k)] = v[k];
  }
}

template <int LOG1>
cudaError_t launch(bool inverse, const int64_t* x, int64_t* out,
                   const uint64_t* q, const uint64_t* qinv,
                   const uint64_t* ninv, const uint64_t* roots, int rows,
                   int limbs, int limb_lo, int lazy, cudaStream_t stream) {
  constexpr int P = 1 << LOG1;
  const dim3 col_grid(static_cast<unsigned>(rows) * (N2 / (TILE / P)));
  const dim3 row_grid(static_cast<unsigned>(rows) * (P / ROWS));
  cudaError_t err;
  if (!inverse) {
    ntt_u64_col<LOG1, false><<<col_grid, THREADS, 0, stream>>>(
        x, out, q, qinv, ninv, roots, limbs, limb_lo, lazy);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ntt_u64_row<LOG1, false><<<row_grid, THREADS, 0, stream>>>(
        out, out, q, qinv, roots, limbs, limb_lo, lazy);
  } else {
    ntt_u64_row<LOG1, true><<<row_grid, THREADS, 0, stream>>>(
        x, out, q, qinv, roots, limbs, limb_lo, lazy);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ntt_u64_col<LOG1, true><<<col_grid, THREADS, 0, stream>>>(
        out, out, q, qinv, ninv, roots, limbs, limb_lo, lazy);
  }
  return cudaGetLastError();
}

}  // namespace

// What a launch needs of one ring, filled once by the binding: the ring's
// tables on `device` (u64 bit patterns) and logN.
struct NttU64Engine {
  const uint64_t* q;        // [L]
  const uint64_t* qinv;     // [L], q^-1 mod 2^64
  const uint64_t* ninv;     // [L], MForm(N^-1)
  const uint64_t* roots;    // [L, N], forward, bit-reversed Montgomery powers
  const uint64_t* iroots;   // [L, N], inverse
  int logn;
  int device;
};

// flags: bit 0 inverse, bit 1 lazy. Two launches on `stream` of the
// engine's device (made current for them when it is not); returns the
// cudaError_t of the launches (0 on success).
extern "C" int ntt_u64_launch(const void* x, void* out,
                              const NttU64Engine* eng, int flags, int rows,
                              int limbs, int limb_lo, void* stream) {
  const int device = eng->device;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const auto* xi = static_cast<const int64_t*>(x);
  auto* oi = static_cast<int64_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool inverse = flags & 1;
  const int lazy = (flags >> 1) & 1;
  const uint64_t* roots = inverse ? eng->iroots : eng->roots;
  switch (eng->logn) {
    case 15:
      err = launch<7>(inverse, xi, oi, eng->q, eng->qinv, eng->ninv, roots,
                      rows, limbs, limb_lo, lazy, s);
      break;
    case 16:
      err = launch<8>(inverse, xi, oi, eng->q, eng->qinv, eng->ninv, roots,
                      rows, limbs, limb_lo, lazy, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
