// Fused negacyclic NTT / INTT with u32 Montgomery arithmetic for primes
// q < 2^30 and 512 <= N <= 2^15, for Hopper (sm_90a).
//
// Replaces the TPU kernels lattigo_tpu/ring/ntt_pallas.py::_ntt_kernel
// (:111) and ::_intt_kernel (:135), launched there through NTTPallas._call
// (:188, pallas_call :219). It computes the same function bit for bit,
// lazy ranges included: all logN radix-2 stages on a row held in fast
// memory, Montgomery products with R = 2^32 (__umulhi for the high word),
// each forward stage folding x into [0, 2q) before its butterfly and
// leaving [0, 4q), each inverse stage keeping [0, 2q) and the inverse
// ending with x N^-1 on the Montgomery exit. Outputs are in [0, q), or,
// when lazy, [0, 4q) forward and [0, 2q) inverse. Inputs are read as their
// low 32 bits, as the TPU kernel's u32 cast does.
//
// What bounds it on an H100. Each butterfly is about 12 32-bit integer
// operations (two folds, a Montgomery product of four multiplies, an add
// and a subtract) against 16 bytes of int64 in and out per coefficient
// plus 4 N bytes of roots per limb, so at logN = 14 the integer ALUs
// (64 int32 lanes per SM) and device memory bound it about equally. At the
// blind rotation's shapes (a few rows of N = 512 or 1024, 8-32 KB a
// launch) neither does: the launch latency sets the time.
//
// Design. The TPU kernel's roll-and-select butterflies over [logN, N]
// stage-root tables exist for the TPU's lanes; here every butterfly reads
// its pair directly. One block of 512 threads per row of N coefficients
// (two rows at N = 512, so that every thread has a butterfly), the row
// held as u32 in shared memory (4 KB at N = 1024, 128 KB at N = 2^15,
// dynamic shared memory above 48 KB), N/2 butterflies a stage spread over
// the threads, __syncthreads() between stages. The roots are one compact
// per-limb table of N entries, MForm32(psi^brev(k)) forward and
// MForm32(psi^-brev(k)) inverse: group g of the stage with m groups reads
// entry m + g, which is the value gen_stage_roots spreads over that
// stage's upper positions. The kernel reads the port's int64
// [..., limbs, N] layout directly (row = poly * limbs + limb), takes the
// limb offset of the single-limb entry points, and writes int64, with no
// transpose or cast pass. Register-resident radix-4/8 stages and several
// rows per block at large N are left for a later version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

// a*b*2^-32 mod q in [0, 2q); needs a*b < q*2^32 (ntt_pallas._mred_lazy32).
__device__ __forceinline__ uint32_t mred_lazy32(uint32_t a, uint32_t b,
                                                uint32_t q, uint32_t qinv) {
  const uint32_t hi = __umulhi(a, b);
  const uint32_t m = a * b * qinv;
  return hi - __umulhi(m, q) + q;
}

__device__ __forceinline__ uint32_t fold(uint32_t x, uint32_t bound) {
  return x >= bound ? x - bound : x;
}

template <int LOGN>
struct Shape {
  static constexpr int N = 1 << LOGN;
  static constexpr int HALF = N / 2;
  static constexpr int ROWS = HALF >= kThreads ? 1 : kThreads / HALF;
  static constexpr int SMEM_BYTES = ROWS * N * 4;
};

// x, out: int64 [rows, N]; row r has limb r % limbs + limb_lo.
// consts: uint32 [L, 4] = q, q^-1 mod 2^32, MForm32(N^-1), 0.
// roots: uint32 [L, N], forward or inverse table.
template <int LOGN, bool INV>
__global__ void __launch_bounds__(kThreads)
ntt_u32_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
               const uint32_t* __restrict__ consts,
               const uint32_t* __restrict__ roots, int rows, int limbs,
               int limb_lo, int lazy) {
  using S = Shape<LOGN>;
  constexpr int N = S::N;
  constexpr int HALF = S::HALF;
  constexpr int ROWS = S::ROWS;
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t kq[ROWS], kqinv[ROWS], kninv[ROWS];
  __shared__ const uint32_t* kroots[ROWS];

  const int row0 = static_cast<int>(blockIdx.x) * ROWS;
  const int nrows = min(ROWS, rows - row0);
  if (static_cast<int>(threadIdx.x) < nrows) {
    const int limb = (row0 + static_cast<int>(threadIdx.x)) % limbs + limb_lo;
    kq[threadIdx.x] = consts[limb * 4];
    kqinv[threadIdx.x] = consts[limb * 4 + 1];
    kninv[threadIdx.x] = consts[limb * 4 + 2];
    kroots[threadIdx.x] = roots + static_cast<size_t>(limb) * N;
  }
  const size_t base = static_cast<size_t>(row0) * N;
  const int count = nrows * N;
  for (int i = threadIdx.x; i < count; i += kThreads)
    smem[i] = static_cast<uint32_t>(static_cast<uint64_t>(x[base + i]));
  __syncthreads();

  const int butterflies = nrows * HALF;
#pragma unroll 1
  for (int st = 0; st < LOGN; ++st) {
    // forward: m = 2^st groups; inverse: m = N/2 ... 1
    const int s = INV ? LOGN - 1 - st : st;
    const int lt = LOGN - 1 - s;              // log2 of the pair stride
    const int t = 1 << lt;
    const int m = 1 << s;
    for (int b = threadIdx.x; b < butterflies; b += kThreads) {
      const int r = b >> (LOGN - 1);
      const int j = b & (HALF - 1);
      const int g = j >> lt;
      const int p = (g << (lt + 1)) + (j & (t - 1));
      uint32_t* row = smem + r * N;
      const uint32_t q = kq[r], qinv = kqinv[r], q2 = q + q;
      const uint32_t w = __ldg(kroots[r] + m + g);
      if (INV) {
        const uint32_t x0 = row[p], x1 = row[p + t];
        row[p] = fold(x0 + x1, q2);
        row[p + t] = mred_lazy32(x0 - x1 + q2, w, q, qinv);
      } else {
        const uint32_t x0 = fold(row[p], q2), x1 = fold(row[p + t], q2);
        const uint32_t u = mred_lazy32(x1, w, q, qinv);
        row[p] = x0 + u;
        row[p + t] = x0 - u + q2;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int r = i >> LOGN;
    const uint32_t q = kq[r];
    uint32_t v = smem[i];
    if (INV) {
      v = mred_lazy32(v, kninv[r], q, kqinv[r]);
      if (!lazy) v = fold(v, q);
    } else if (!lazy) {
      v = fold(fold(v, q + q), q);
    }
    out[base + i] = static_cast<int64_t>(v);
  }
}

template <int LOGN, bool INV>
cudaError_t launch(const int64_t* x, int64_t* out, const uint32_t* consts,
                   const uint32_t* roots, int rows, int limbs, int limb_lo,
                   int lazy, cudaStream_t stream) {
  using S = Shape<LOGN>;
  auto kern = ntt_u32_kernel<LOGN, INV>;
  if (S::SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (rows + S::ROWS - 1) / S::ROWS;
  kern<<<blocks, kThreads, S::SMEM_BYTES, stream>>>(x, out, consts, roots,
                                                    rows, limbs, limb_lo, lazy);
  return cudaGetLastError();
}

template <bool INV>
cudaError_t dispatch(int logn, const int64_t* x, int64_t* out,
                     const uint32_t* consts, const uint32_t* roots, int rows,
                     int limbs, int limb_lo, int lazy, cudaStream_t stream) {
  switch (logn) {
    case 9: return launch<9, INV>(x, out, consts, roots, rows, limbs, limb_lo, lazy, stream);
    case 10: return launch<10, INV>(x, out, consts, roots, rows, limbs, limb_lo, lazy, stream);
    case 11: return launch<11, INV>(x, out, consts, roots, rows, limbs, limb_lo, lazy, stream);
    case 12: return launch<12, INV>(x, out, consts, roots, rows, limbs, limb_lo, lazy, stream);
    case 13: return launch<13, INV>(x, out, consts, roots, rows, limbs, limb_lo, lazy, stream);
    case 14: return launch<14, INV>(x, out, consts, roots, rows, limbs, limb_lo, lazy, stream);
    case 15: return launch<15, INV>(x, out, consts, roots, rows, limbs, limb_lo, lazy, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ntt_u32_launch(const void* x, void* out, const void* consts,
                              const void* roots, int logn, int inverse,
                              int lazy, int rows, int limbs, int limb_lo,
                              void* stream) {
  const auto* xi = static_cast<const int64_t*>(x);
  auto* oi = static_cast<int64_t*>(out);
  const auto* ci = static_cast<const uint32_t*>(consts);
  const auto* ri = static_cast<const uint32_t*>(roots);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      inverse ? dispatch<true>(logn, xi, oi, ci, ri, rows, limbs, limb_lo, lazy, s)
              : dispatch<false>(logn, xi, oi, ci, ri, rows, limbs, limb_lo, lazy, s);
  return static_cast<int>(err);
}
