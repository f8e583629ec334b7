// Fused negacyclic NTT / INTT with u32 Montgomery arithmetic for primes
// q < 2^30 and 512 <= N <= 2^15, for Hopper (sm_90a).
//
// Replaces the TPU kernels lattigo_tpu/ring/ntt_pallas.py::_ntt_kernel
// (:111) and ::_intt_kernel (:135), launched there through NTTPallas._call
// (:188, pallas_call :219). It computes the same function bit for bit,
// lazy ranges included: all logN radix-2 stages of a row, Montgomery
// products with R = 2^32 (__umulhi for the high word), each forward stage
// folding both inputs into [0, 2q) before its butterfly and leaving
// [0, 4q), each inverse stage keeping [0, 2q) and the inverse ending with
// x N^-1 on the Montgomery exit. Input contract: the forward takes [0, 4q),
// the inverse [0, 2q) (an inverse input in [2q, 4q), such as a lazy
// forward output, gives other integers, as in the TPU kernel). Outputs are
// in [0, q), or, when lazy, [0, 4q) forward and [0, 2q) inverse. Inputs are
// read as their low 32 bits, as the TPU kernel's u32 cast does.
//
// What bounds it on an H100. Each butterfly is about 12 32-bit integer
// operations against 16 bytes of int64 in and out per coefficient, so at
// logN = 14 device memory and the integer ALUs bound it about equally
// (~5 us at 4 x 15 x 16384). At the blind rotation's shapes (a few rows of
// N = 512 or 1024) neither does: the time is a chain of latencies, one
// memory round trip and one barrier per step, and on the host the launch.
//
// Design, against that:
// * Register-resident passes. A thread holds E = 8 coefficients and runs
//   up to K = 3 radix-2 stages on them in registers (a block of M
//   coefficients has M / 8 threads); shared memory and one barrier come
//   only between passes. The pass that meets global memory (the forward's
//   first, the inverse's last) reads or writes it directly, so a row on one
//   block has one barrier fewer than passes: 3 at N = 1024 (passes of 1, 3,
//   3, 3 stages), where the kernel it replaces had 11. Each butterfly keeps
//   the TPU kernel's exact arithmetic and fold points; only the order in
//   which independent butterflies run changes.
// * Roots staged once. At start each block copies the roots its stages
//   read (an N-entry compact table per limb, entry m + g for group g of
//   the stage with m groups; the block's share when a row is split) into
//   shared memory with 16-byte cp.async, overlapped with the input loads
//   and the first pass (whose few roots each thread loads itself ahead of
//   its stages); no global load is left in the stage loop. The int64 input
//   and output move as 16-byte vectors (the forward's last pass goes back
//   through shared memory, warp by warp, so that its stores are in order).
// * Few long rows fill the card. A row of N coefficients runs on a
//   cluster of C = 2^LC blocks (C <= 4) when one block per row would leave
//   SMs idle (rows * C < SM count) and each block keeps >= 2048
//   coefficients; C >= N / 8192 always, so that a block's chunk and roots
//   fit in shared memory. The first LC forward stages (last LC inverse
//   stages) cross the chunks: they run as one radix-C pass whose
//   coefficients are read from global memory (forward) or from the other
//   blocks' shared memory (inverse, through distributed shared memory),
//   and whose results go to the owning block's shared memory (forward) or
//   to global memory (inverse). After (before) them each chunk is an
//   independent sub-transform. At 4 x 15 x 16384 that is 240 blocks, not
//   60. At the blind rotation's 2 x 1 x 1024 it stays one block of 128
//   threads per row, where latency is what counts.
// * Shared memory is padded by one word in 32, so that the strided
//   accesses of every pass fall on distinct banks.
//
// The kernel reads the port's int64 [..., limbs, N] layout directly (row =
// poly * limbs + limb), takes the limb offset of the single-limb entry
// points, writes int64, and returns the launch's cudaGetLastError(); there
// is no fallback.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

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

struct Mod {
  uint32_t q, qinv, q2;
};

// forward (Cooley-Tukey) butterfly: inputs folded into [0, 2q), out [0, 4q)
__device__ __forceinline__ void ct(uint32_t& a, uint32_t& b, uint32_t w,
                                   Mod m) {
  const uint32_t x0 = fold(a, m.q2), x1 = fold(b, m.q2);
  const uint32_t u = mred_lazy32(x1, w, m.q, m.qinv);
  a = x0 + u;
  b = x0 - u + m.q2;
}

// inverse (Gentleman-Sande) butterfly, [0, 2q) in and out
__device__ __forceinline__ void gs(uint32_t& a, uint32_t& b, uint32_t w,
                                   Mod m) {
  const uint32_t x0 = a, x1 = b;
  a = fold(x0 + x1, m.q2);
  b = mred_lazy32(x0 - x1 + m.q2, w, m.q, m.qinv);
}

// R consecutive stages on one unit of 2^R coefficients held in v, at
// register stride 2^(R-1-l) on level l (forward order: level l pairs v[i]
// with v[i + 2^(R-1-l)]). root(l, gi) is the root of group gi of level l;
// the forward runs levels 0 .. R-1, the inverse R-1 .. 0.
template <int R, bool INV, class Root>
__device__ __forceinline__ void radix(uint32_t* v, const Root& root, Mod m) {
#pragma unroll
  for (int step = 0; step < R; ++step) {
    const int l = INV ? R - 1 - step : step;
    const int half = 1 << (R - 1 - l);
#pragma unroll
    for (int gi = 0; gi < (1 << l); ++gi) {
      const uint32_t w = root(l, gi);
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const int i = 2 * half * gi + k;
        if (INV)
          gs(v[i], v[i + half], w, m);
        else
          ct(v[i], v[i + half], w, m);
      }
    }
  }
}

// A row of N = M C coefficients runs on C = 2^LC blocks of M; a thread holds
// E = 2^K of them. The local stages of a chunk (logM of them, in forward
// order) go in passes: pass 0 of R0 stages, passes 1 .. P-2 of K, pass P-1
// of RL. R0 <= K - 1 when LC = 0, so that the pass that meets global memory
// there (forward pass 0, inverse pass 0) can give every thread pairs of
// neighbouring units (16-byte accesses).
template <int LOGM, int LC>
struct Geom {
  static constexpr int M = 1 << LOGM;
  static constexpr int C = 1 << LC;
  static constexpr int K = 3;
  static constexpr int E = 1 << K;
  static constexpr int T = M / E;         // threads per block
  static constexpr int R0 =
      LOGM % K != 0 ? LOGM % K : (LC == 0 ? K - 1 : K);
  static constexpr int MID = (LOGM - R0 - 1) / K;
  static constexpr int RL = LOGM - R0 - K * MID;
  static constexpr int P = MID + 2;
  __host__ __device__ static constexpr int size(int p) {
    return p == 0 ? R0 : p == P - 1 ? RL : K;
  }
  __host__ __device__ static constexpr int start(int p) {
    return p == 0 ? 0 : R0 + (p - 1) * K;
  }
  // The edge pass meets global memory on pairs of units: the row's LC
  // cross-chunk stages when LC > 0, else local pass 0. Its units are
  // j, j + SE, ..., of which block b takes b UB .. b UB + UB - 1.
  static constexpr int RE = LC > 0 ? LC : R0;
  static constexpr int SE = (M << LC) >> RE;
  static constexpr int UB = M >> RE;
  static constexpr int NP = E >> (RE + 1);   // unit pairs per thread
  // roots (M words, 16-byte aligned) then the padded chunk
  static constexpr int SMEM = (2 * M + M / 32) * 4;
};

__device__ __forceinline__ int pad(int a) { return a + (a >> 5); }

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Local pass p over the block's chunk in shared memory, then a barrier. Its
// M / 2^R units are dealt out to the threads, unit u = c T + tid; unit
// (group g, offset j) holds the coefficients g M / 2^s0 + j + i M / 2^(s0+R),
// i < 2^R, whose level-l group gi reads rt[2^(s0+l) + g 2^l + gi].
template <int LOGM, int LC, int PASS, bool INV>
__device__ __forceinline__ void local_pass(uint32_t* data, const uint32_t* rt,
                                           Mod m) {
  using S = Geom<LOGM, LC>;
  constexpr int R = S::size(PASS), s0 = S::start(PASS);
  constexpr int U = S::E >> R, W = 1 << R, jl = LOGM - s0 - R;
  uint32_t v[S::E];
  int g[U], base[U];
#pragma unroll
  for (int c = 0; c < U; ++c) {
    const int u = c * S::T + static_cast<int>(threadIdx.x);
    g[c] = u >> jl;
    base[c] = (g[c] << (jl + R)) + (u & ((1 << jl) - 1));
#pragma unroll
    for (int i = 0; i < W; ++i) v[c * W + i] = data[pad(base[c] + (i << jl))];
  }
#pragma unroll
  for (int c = 0; c < U; ++c) {
    const int gc = g[c];
    radix<R, INV>(v + c * W, [rt, gc](int l, int gi) {
      return rt[(1 << (s0 + l)) + (gc << l) + gi];
    }, m);
  }
#pragma unroll
  for (int c = 0; c < U; ++c)
#pragma unroll
    for (int i = 0; i < W; ++i) data[pad(base[c] + (i << jl))] = v[c * W + i];
  if constexpr (INV && LC > 0 && PASS == 0)   // the cross stages read it
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Local passes FIRST .. LAST, in stage order (reversed for the inverse).
template <int LOGM, int LC, int FIRST, int LAST, bool INV>
__device__ __forceinline__ void local_passes(uint32_t* data, const uint32_t* rt,
                                             Mod m) {
  if constexpr (FIRST <= LAST) {
    constexpr int P = INV ? LAST : FIRST;
    local_pass<LOGM, LC, P, INV>(data, rt, m);
    local_passes<LOGM, LC, INV ? FIRST : FIRST + 1, INV ? LAST - 1 : LAST,
                 INV>(data, rt, m);
  }
}

// x, out: int64 [rows, N]; row r has limb r % limbs + limb_lo and runs on
// blocks r C .. r C + C - 1 (one cluster).
// consts: uint32 [L, 4] = q, q^-1 mod 2^32, MForm32(N^-1), 0.
// roots: uint32 [L, N], the forward or inverse compact table.
template <int LOGM, int LC, bool INV>
__global__ void __launch_bounds__(Geom<LOGM, LC>::T)
ntt_u32_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
               const uint32_t* __restrict__ consts,
               const uint32_t* __restrict__ roots, int limbs, int limb_lo,
               int lazy) {
  using S = Geom<LOGM, LC>;
  constexpr int M = S::M, C = S::C, E = S::E, T = S::T, P = S::P;
  constexpr int RL = S::RL, RE = S::RE, SE = S::SE, NP = S::NP;
  constexpr int UL = E >> RL;   // units per thread in local pass P-1
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rt = smem;         // rt[k], 1 <= k < M: roots of the local stages
  uint32_t* data = smem + M;   // the chunk, padded
  const int tid = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x) & (C - 1);   // rank in cluster
  const size_t row = blockIdx.x >> LC;
  const int limb = static_cast<int>(row % limbs) + limb_lo;
  const uint32_t* groots = roots + static_cast<size_t>(limb) * (M * C);
  const int64_t* xrow = x + row * (M * C);
  int64_t* orow = out + row * (M * C);
  const Mod m{consts[limb * 4], consts[limb * 4 + 1], 2 * consts[limb * 4]};

  if constexpr (!INV && LC > 0)   // every block of the cluster has started
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Local stage s (2^s groups) of chunk b is stage s + LC of the row, and
  // its group g is the row's group b 2^s + g: rt[2^s + g] =
  // roots[(C + b) 2^s + g]. Entries 4..M-1 come in 16-byte pieces (a piece
  // never crosses a stage, whose 2^s entries start at a multiple of 4).
  for (int c = tid + 1; c < M / 4; c += T) {
    const int k = 4 * c, s = 1 << (31 - __clz(k));
    cp_async16(rt + k, groots + (C + b) * s + k - s);
  }
  if (tid >= 1 && tid < 4) {
    const int s = tid == 1 ? 1 : 2;
    rt[tid] = groots[(C + b) * s + tid - s];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // roots of the edge pass's stages, the row's first RE: entries 1 .. 2^RE-1
  uint32_t xr[1 << RE];
#pragma unroll
  for (int k = 1; k < (1 << RE); ++k) xr[k] = __ldg(groots + k);
  const auto xroot = [&xr](int l, int gi) { return xr[(1 << l) + gi]; };

  if constexpr (!INV) {
    // Edge pass: units j, j+1 of block b's share, each read as the pairs
    // (j + i SE, j + 1 + i SE) in 16-byte loads; result i of unit j goes to
    // the chunk (of block (j + i SE) / M) at (j + i SE) mod M.
    uint32_t a[NP][2][1 << RE];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = b * S::UB + 2 * (p * T + tid);
#pragma unroll
      for (int i = 0; i < (1 << RE); ++i) {
        const longlong2 t =
            __ldg(reinterpret_cast<const longlong2*>(xrow + i * SE + j));
        a[p][0][i] = static_cast<uint32_t>(t.x);
        a[p][1][i] = static_cast<uint32_t>(t.y);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) radix<RE, false>(a[p][h], xroot, m);
    }
    if constexpr (LC > 0)
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = b * S::UB + 2 * (p * T + tid);
#pragma unroll
      for (int i = 0; i < (1 << RE); ++i) {
        const int pos = j + i * SE;
        uint32_t* dst = data;
        if constexpr (LC > 0)
          dst = cg::this_cluster().map_shared_rank(data, pos >> LOGM);
        dst[pad(pos & (M - 1))] = a[p][0][i];
        dst[pad((pos & (M - 1)) + 1)] = a[p][1][i];
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if constexpr (LC > 0)
      cg::this_cluster().sync();
    else
      __syncthreads();

    local_passes<LOGM, LC, (LC > 0 ? 0 : 1), P - 2, false>(data, rt, m);

    // Local pass P-1: unit c of thread tid is the 2^RL neighbouring
    // coefficients from (c T + tid) 2^RL on. The units c T + 32 w ..
    // c T + 32 w + 31 of warp w cover one stretch of the chunk, which the
    // warp writes back and then stores in order, 512 bytes an instruction.
    uint32_t v[1 << RL];
    const int lane = tid & 31;
#pragma unroll
    for (int c = 0; c < UL; ++c) {
      const int g = c * T + tid;
#pragma unroll
      for (int i = 0; i < (1 << RL); ++i) v[i] = data[pad((g << RL) + i)];
      radix<RL, false>(v, [rt, g](int l, int gi) {
        return rt[(1 << (LOGM - RL + l)) + (g << l) + gi];
      }, m);
#pragma unroll
      for (int i = 0; i < (1 << RL); ++i)
        data[pad((g << RL) + i)] = lazy ? v[i] : fold(fold(v[i], m.q2), m.q);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < UL; ++c) {
      const int base = (c * T + tid - lane) << RL;
#pragma unroll
      for (int h = 0; h < (1 << RL) / 2; ++h) {
        const int k = base + 2 * (32 * h + lane);
        *reinterpret_cast<longlong2*>(orow + b * M + k) =
            make_longlong2(data[pad(k)], data[pad(k + 1)]);
      }
    }
  } else {
    // Local pass P-1 (local stages logM-1 .. logM-RL): unit c of thread tid
    // is the 2^RL neighbouring coefficients from (c T + tid) 2^RL on, read
    // from global memory in 16-byte loads; its roots too, ahead of the
    // stages, since the staged table is not visible before the barrier.
    uint32_t v[E], w[UL][1 << RL];
#pragma unroll
    for (int c = 0; c < UL; ++c) {
      const int g = c * T + tid;
      const int64_t* src = xrow + b * M + (g << RL);
#pragma unroll
      for (int i = 0; i < (1 << RL); i += 2) {
        const longlong2 t = __ldg(reinterpret_cast<const longlong2*>(src + i));
        v[c * (1 << RL) + i] = static_cast<uint32_t>(t.x);
        v[c * (1 << RL) + i + 1] = static_cast<uint32_t>(t.y);
      }
#pragma unroll
      for (int l = 0; l < RL; ++l) {
        const int s = 1 << (LOGM - RL + l);   // groups of the stage
#pragma unroll
        for (int gi = 0; gi < (1 << l); ++gi)
          w[c][(1 << l) + gi] = __ldg(groots + (C + b) * s + (g << l) + gi);
      }
    }
#pragma unroll
    for (int c = 0; c < UL; ++c) {
      radix<RL, true>(v + c * (1 << RL), [&w, c](int l, int gi) {
        return w[c][(1 << l) + gi];
      }, m);
#pragma unroll
      for (int i = 0; i < (1 << RL); ++i)
        data[pad(((c * T + tid) << RL) + i)] = v[c * (1 << RL) + i];
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    local_passes<LOGM, LC, (LC > 0 ? 0 : 1), P - 2, true>(data, rt, m);

    // Edge pass (the row's stages RE-1 .. 0) on pairs of units, read from
    // the chunks, then x N^-1, to global memory in 16-byte stores.
    const uint32_t ninv = consts[limb * 4 + 2];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int j = b * S::UB + 2 * (p * T + tid);
      uint32_t a[2][1 << RE];
#pragma unroll
      for (int i = 0; i < (1 << RE); ++i) {
        const int pos = j + i * SE;
        const uint32_t* src = data;
        if constexpr (LC > 0)
          src = cg::this_cluster().map_shared_rank(data, pos >> LOGM);
        a[0][i] = src[pad(pos & (M - 1))];
        a[1][i] = src[pad((pos & (M - 1)) + 1)];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) radix<RE, true>(a[h], xroot, m);
#pragma unroll
      for (int i = 0; i < (1 << RE); ++i) {
        uint32_t y0 = mred_lazy32(a[0][i], ninv, m.q, m.qinv);
        uint32_t y1 = mred_lazy32(a[1][i], ninv, m.q, m.qinv);
        if (!lazy) {
          y0 = fold(y0, m.q);
          y1 = fold(y1, m.q);
        }
        *reinterpret_cast<longlong2*>(orow + i * SE + j) =
            make_longlong2(y0, y1);
      }
    }
    if constexpr (LC > 0)   // no block leaves while others read its chunk
      cg::this_cluster().sync();
  }
}

template <int LOGM, int LC, bool INV>
cudaError_t launch(const int64_t* x, int64_t* out, const uint32_t* consts,
                   const uint32_t* roots, int rows, int limbs, int limb_lo,
                   int lazy, int device, cudaStream_t stream) {
  using S = Geom<LOGM, LC>;
  auto kern = ntt_u32_kernel<LOGM, LC, INV>;
  if constexpr (S::SMEM > 48 * 1024) {
    static uint64_t ready = 0;   // devices on which the attribute is set
    const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
    if (!(ready & bit)) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
      if (err != cudaSuccess) return err;
      ready |= bit;
    }
  }
  if constexpr (LC == 0) {
    kern<<<rows, S::T, S::SMEM, stream>>>(x, out, consts, roots, limbs,
                                          limb_lo, lazy);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * S::C);
    cfg.blockDim = dim3(S::T);
    cfg.dynamicSmemBytes = S::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = S::C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, x, out, consts,
                                               roots, limbs, limb_lo, lazy);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

// log2 of the blocks per row: at least N / 8192 (a block's chunk and roots
// fit in shared memory), doubled while rows * C leaves SMs idle and each
// block keeps >= 2048 coefficients, at most 4 blocks.
int split(int logn, int rows, int sms) {
  int lc = logn > 13 ? logn - 13 : 0;
  while (lc < 2 && logn - lc - 1 >= 11 &&
         (static_cast<long long>(rows) << lc) < sms)
    ++lc;
  return lc;
}

int sm_count(int device) {
  static int cached[64] = {};
  int n = device < 64 ? cached[device] : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess)
      n = 1;
    if (device < 64) cached[device] = n;
  }
  return n;
}

template <bool INV>
cudaError_t dispatch(int logn, const int64_t* x, int64_t* out,
                     const uint32_t* consts, const uint32_t* roots, int rows,
                     int limbs, int limb_lo, int lazy, int device,
                     cudaStream_t stream) {
  const int lc = split(logn, rows, sm_count(device));
#define NTT_U32_CASE(LOGN, LC)                                              \
  case (LOGN) * 4 + (LC):                                                   \
    return launch<(LOGN) - (LC), LC, INV>(x, out, consts, roots, rows,      \
                                          limbs, limb_lo, lazy, device,     \
                                          stream);
  switch (logn * 4 + lc) {
    NTT_U32_CASE(9, 0)
    NTT_U32_CASE(10, 0)
    NTT_U32_CASE(11, 0)
    NTT_U32_CASE(12, 0)
    NTT_U32_CASE(13, 0)
    NTT_U32_CASE(12, 1)
    NTT_U32_CASE(13, 1)
    NTT_U32_CASE(14, 1)
    NTT_U32_CASE(13, 2)
    NTT_U32_CASE(14, 2)
    NTT_U32_CASE(15, 2)
    default:
      return cudaErrorInvalidValue;
  }
#undef NTT_U32_CASE
}

}  // namespace

// What a launch needs of one engine, filled once by the binding: the
// uint32 tables on `device` and logN.
struct NttU32Engine {
  const uint32_t* consts;   // [L, 4]
  const uint32_t* roots;    // [L, N], forward
  const uint32_t* iroots;   // [L, N], inverse
  int logn;
  int device;
};

// flags: bit 0 inverse, bit 1 lazy. Launches on `stream` of the engine's
// device (made current for the launch when it is not) and returns the
// cudaError_t of the launch (0 on success).
extern "C" int ntt_u32_launch(const void* x, void* out,
                              const NttU32Engine* eng, int flags, int rows,
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
  const int lazy = (flags >> 1) & 1;
  err = flags & 1 ? dispatch<true>(eng->logn, xi, oi, eng->consts, eng->iroots,
                                   rows, limbs, limb_lo, lazy, device, s)
                  : dispatch<false>(eng->logn, xi, oi, eng->consts, eng->roots,
                                    rows, limbs, limb_lo, lazy, device, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
