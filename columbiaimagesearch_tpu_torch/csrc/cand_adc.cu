// Per-candidate ADC distances from rotated residuals: the table-free route
// of the probed query (index/cand_adc.py), taken by strip rungs, square
// rungs wider than 128 x 128 and candidate budgets above 16,384.
//
// Replaces no Pallas kernel. It is the direct branch of
// columbiaimagesearch_tpu/index/tpu_query.py:597-609, which XLA fuses one
// query at a time, so that nothing larger than [Q, Dh] exists there. The
// port's batched eager form of it materialised a [NQ, Q, Dh] gather of
// rotated residuals and F [NQ, Q, Dsub] temporaries a half: ~7 GB of
// traffic a 100-query wave at the release shapes (V=4096, Dh=128, F=4,
// Dsub=32, Q=11,264). For query n and valid slot j (j < min(n_valid[n],
// Q)), with c_s = isel_s[n, slot_s[n, j]] and code = codes[rows[n, j]]:
//
//   out[n, j] = sum_{f<F} ||pr[0, c_0, n, f] - subs[0, f, code[f]]||^2
//             + sum_{f<F} ||pr[1, c_1, n, f] - subs[1, f, code[F+f]]||^2
//
// the f terms of a half added in order 0..F-1, then half 0 plus half 1,
// as the plain version adds them; out is +inf on the other slots. pr[s, v,
// n] = R_s[v] ((x_s[n] - C_s[v]) - mu_s[v]) is [2, V, NQ, Dh]: cand_residuals
// below writes the residuals in that layout in one pass, and the wrapper
// rotates them with one fp32 batched GEMM, so a (half, cluster, query) row
// is one contiguous Dh * 4 bytes.
//
// What bounds it on the H100: bytes, and few of them. A candidate reads
// its ids (rows, slot0, slot1: 24 B), M code bytes and writes 4 B; the pr
// rows it reads are shared by every slot of a probed cluster, and the
// tables are read once a block. At NQ=100, Q=11,264 that is ~45 MB plus
// the pr rows touched (a few hundred clusters a query and half, ~0.1 GB at
// most): tens of microseconds at 3.35 TB/s. The arithmetic (3 * M * Dsub
// FLOPs a candidate, 0.9 GFLOP a wave) is a hundredth of a millisecond. The
// traffic inside the SM is larger: each candidate reads 2 * F * Dsub floats
// of tables from shared memory and as many of pr through L1 (1 KB each at
// release).
//
// Design:
// - One thread scores one candidate: a warp holds 32 consecutive slots of
//   a query, which mostly share a cell, so their pr reads hit the same L1
//   lines and their codes the same 32-byte sectors.
// - A block walks a contiguous range of the wave's [NQ, Q] slots, so it
//   reads a query's slots in order. The grid is as many blocks as fit on
//   the SMs; each stages one half's tables (F * S * Dsub * 4 bytes: 128 KB
//   at release, 64 KB at face) in shared memory, scores its range for
//   half 0, then stages half 1's tables and walks the range again, adding
//   half 1 into the values it wrote (the same thread reads its own
//   writes). Both halves' tables (256 KB at release) do not fit in one
//   block's 227 KB.
// - Shared-memory reads of the tables are float4s at a rotated offset:
//   thread `lane` reads chunk (k + lane) mod Dsub/4 of its table row at
//   step k, so a quarter-warp's 16-byte reads fall in distinct bank groups
//   whatever codes its threads hold (a 32-wide row at a common offset
//   would put all 32 threads in one bank). The pr reads take the same
//   order. The terms of a Dsub sum are added in that order, not 0..Dsub-1.
//
// Out-of-range rows, slots, cluster ids or code bytes >= S poison their
// slot with NaN instead of reading outside the arrays.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py). C interface for ctypes; each
// launcher checks its shapes, returns cudaErrorInvalidValue or
// cudaGetLastError(), and the Python wrapper raises if that is not 0.

#include <algorithm>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kResThreads = 256;
constexpr int kMaxDevices = 64;  // devices the launch caches hold

struct Params {
  const long long* rows;     // [NQ, Q]
  const long long* slot0;    // [NQ, Q]
  const long long* slot1;    // [NQ, Q]
  const long long* isel0;    // [NQ, *] row stride istride0
  const long long* isel1;    // [NQ, *] row stride istride1
  const long long* n_valid;  // [NQ]
  const unsigned char* codes;  // [N, M]
  const float4* pr;          // [2, V, NQ, Dh]
  const float4* subs;        // [2, F, S, Dsub]
  float* out;                // [NQ, Q]
  long long istride0, istride1, N, total, per;
  int Bi, M, NQ, Q, V, F, S, dq;
};

// ||a - b||^2 over dq float4s, a in device memory (read through L1), b in
// shared memory, chunk (k + lane) mod dq at step k.
__device__ __forceinline__ float sq4(const float4* a, const float4* b,
                                     int k) {
  const float4 x = __ldg(a + k);
  const float4 y = b[k];
  const float d0 = x.x - y.x, d1 = x.y - y.y, d2 = x.z - y.z, d3 = x.w - y.w;
  return d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
}

template <int DQ>
__device__ __forceinline__ float sub_dist(const float4* a, const float4* b,
                                          int lane, int dq) {
  float part = 0.f;
  if (DQ) {
#pragma unroll
    for (int k = 0; k < DQ; ++k) part += sq4(a, b, (k + lane) & (DQ - 1));
  } else {
    for (int k = 0; k < dq; ++k) part += sq4(a, b, (k + lane) % dq);
  }
  return part;
}

// Scores the slots [blockIdx.x * per, + per) of the wave. DQ is Dsub / 4
// where a specialisation exists (a power of two), else 0 (read p.dq).
template <int DQ>
__global__ void __launch_bounds__(kThreads) cand_adc_kernel(Params p) {
  extern __shared__ float4 tab[];
  const float inf = __int_as_float(0x7f800000);
  const float nan = __int_as_float(0x7fc00000);
  const int dq = DQ ? DQ : p.dq;
  const int lane = threadIdx.x & 31;
  const int half_q = p.F * p.S * dq;  // float4s of one half's tables
  const long long lo = blockIdx.x * p.per;
  const long long hi = lo + p.per < p.total ? lo + p.per : p.total;
  const long long row_q = static_cast<long long>(dq) * p.F;  // Dh / 4

  for (int s = 0; s < 2; ++s) {
    if (s) __syncthreads();  // every thread is done with half 0's tables
    const float4* src = p.subs + static_cast<long long>(s) * half_q;
    for (int i = threadIdx.x; i < half_q; i += blockDim.x) tab[i] = src[i];
    __syncthreads();
    const long long* slot = s ? p.slot1 : p.slot0;
    const long long* isel = s ? p.isel1 : p.isel0;
    const long long istride = s ? p.istride1 : p.istride0;
    const float4* pr = p.pr + static_cast<long long>(s) * p.V * p.NQ * row_q;
    const unsigned char* codes = p.codes + s * p.F;

    long long i = lo + threadIdx.x;
    long long n = i / p.Q;
    int j = static_cast<int>(i - n * p.Q);
    for (; i < hi; i += blockDim.x) {
      if (j < p.n_valid[n]) {  // j < Q: the same as j < min(n_valid, Q)
        const long long row = p.rows[i];
        const long long sl = slot[i];
        float acc = nan;
        if (row >= 0 && row < p.N && sl >= 0 && sl < p.Bi) {
          const long long c = isel[n * istride + sl];
          if (c >= 0 && c < p.V) {
            const float4* a = pr + (c * p.NQ + n) * row_q;
            const unsigned char* code = codes + row * p.M;
            acc = 0.f;
            for (int f = 0; f < p.F; ++f) {
              const int t = code[f];
              if (t >= p.S) {
                acc = nan;
                break;
              }
              acc += sub_dist<DQ>(a + f * dq, tab + (f * p.S + t) * dq,
                                  lane, dq);
            }
          }
        }
        p.out[i] = s ? p.out[i] + acc : acc;
      } else if (s == 0) {
        p.out[i] = inf;
      }
      j += blockDim.x;
      while (j >= p.Q) {
        j -= p.Q;
        ++n;
      }
    }
  }
}

// r[s, v, n, :] = (x2[n, s, :] - Cs[s, v, :]) - mus[s, v, :]: one block a
// (half, cluster), its threads over the NQ x Dh/4 float4s of that row
// block, so the writes are contiguous.
__global__ void __launch_bounds__(kResThreads)
    residual_kernel(const float4* x2, const float4* Cs, const float4* mus,
                    float4* r, int NQ, int dh4, int V) {
  const long long sv = blockIdx.x;  // s * V + v
  const int s = static_cast<int>(sv / V);
  const float4* c = Cs + sv * dh4;
  const float4* m = mus + sv * dh4;
  float4* o = r + sv * NQ * dh4;
  const int count = NQ * dh4;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const int n = k / dh4, d = k - n * dh4;
    const float4 x = x2[(2 * n + s) * dh4 + d];
    const float4 cc = c[d], mm = m[d];
    o[k] = make_float4((x.x - cc.x) - mm.x, (x.y - cc.y) - mm.y,
                       (x.z - cc.z) - mm.z, (x.w - cc.w) - mm.w);
  }
}

template <int DQ>
cudaError_t launch(Params p, int num_sms, cudaStream_t stream) {
  // Set once per (device, shared-memory size): the attribute and the
  // occupancy query cost host time on every call otherwise. The mutex
  // serialises the first set where several host threads launch at once.
  static std::mutex mu;
  static size_t set_smem[kMaxDevices] = {};
  static int per_sm_of[kMaxDevices] = {};
  const size_t smem = static_cast<size_t>(p.F) * p.S * p.dq * 16;
  int dev = 0;
  cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return de;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (set_smem[dev] != smem) {
      cudaError_t e = cudaFuncSetAttribute(
          cand_adc_kernel<DQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm_of[dev], cand_adc_kernel<DQ>, kThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm_of[dev] < 1) return cudaErrorInvalidValue;
      set_smem[dev] = smem;
    }
    per_sm = per_sm_of[dev];
  }
  // Ranges of whole warps, at most as many as fit on the card at once.
  const long long warps = (p.total + 31) / 32;
  const long long want = std::min<long long>(
      static_cast<long long>(per_sm) * num_sms, warps);
  p.per = (warps + want - 1) / want * 32;
  const long long grid = (p.total + p.per - 1) / p.per;
  cand_adc_kernel<DQ><<<static_cast<unsigned>(grid), kThreads, smem,
                        stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x2 [NQ, 2, Dh] f32, Cs/mus [2, V, Dh] f32 -> r [2, V, NQ, Dh] f32, all
// contiguous, on the current device; Dh % 4 == 0, pointers 16-byte
// aligned.
extern "C" int cand_residuals(const void* x2, const void* Cs, const void* mus,
                              void* r, int NQ, int V, int Dh, void* stream) {
  if (NQ < 0 || V < 1 || Dh < 4 || Dh % 4 != 0 ||
      static_cast<long long>(NQ) * (Dh / 4) > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (NQ == 0) return 0;
  residual_kernel<<<2u * static_cast<unsigned>(V), kResThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x2), static_cast<const float4*>(Cs),
      static_cast<const float4*>(mus), static_cast<float4*>(r), NQ, Dh / 4,
      V);
  return static_cast<int>(cudaGetLastError());
}

// rows/slot0/slot1 [NQ, Q] i64, isel0/isel1 [NQ, >= Bi] i64 with row
// strides istride0/istride1 (unit column stride), n_valid [NQ] i64, codes
// [N, M] u8 (M = 2F), pr [2, V, NQ, Dh] f32 (Dh = F * Dsub), subs
// [2, F, S, Dsub] f32 -> out [NQ, Q] f32. Contiguous unless said, on the
// current device; pr and subs 16-byte aligned; Dsub % 4 == 0, 1 <= S <=
// 256, F * S * Dsub * 4 bytes of shared memory within the card's
// per-block limit (the launch fails otherwise).
extern "C" int cand_adc(const void* rows, const void* slot0, const void* slot1,
                        const void* isel0, const void* isel1,
                        long long istride0, long long istride1, int Bi,
                        const void* n_valid, const void* codes, long long N,
                        int M, const void* pr, const void* subs, void* out,
                        int NQ, int Q, int V, int F, int S, int Dsub,
                        int num_sms, void* stream) {
  if (NQ < 0 || Q < 0 || Bi < 1 || istride0 < Bi || istride1 < Bi ||
      N < 0 || F < 1 || M != 2 * F || V < 1 || S < 1 || S > 256 ||
      Dsub < 4 || Dsub % 4 != 0 || num_sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (NQ == 0 || Q == 0) return 0;
  Params p;
  p.rows = static_cast<const long long*>(rows);
  p.slot0 = static_cast<const long long*>(slot0);
  p.slot1 = static_cast<const long long*>(slot1);
  p.isel0 = static_cast<const long long*>(isel0);
  p.isel1 = static_cast<const long long*>(isel1);
  p.n_valid = static_cast<const long long*>(n_valid);
  p.codes = static_cast<const unsigned char*>(codes);
  p.pr = static_cast<const float4*>(pr);
  p.subs = static_cast<const float4*>(subs);
  p.out = static_cast<float*>(out);
  p.istride0 = istride0;
  p.istride1 = istride1;
  p.N = N;
  p.total = static_cast<long long>(NQ) * Q;
  p.per = 0;
  p.Bi = Bi;
  p.M = M;
  p.NQ = NQ;
  p.Q = Q;
  p.V = V;
  p.F = F;
  p.S = S;
  p.dq = Dsub / 4;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (p.dq) {
    case 8: e = launch<8>(p, num_sms, st); break;
    case 4: e = launch<4>(p, num_sms, st); break;
    default: e = launch<0>(p, num_sms, st); break;
  }
  return static_cast<int>(e);
}
