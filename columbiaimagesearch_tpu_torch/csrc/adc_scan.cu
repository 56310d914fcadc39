// Exhaustive ADC scan: the distance of every indexed code to a batch of
// queries, with no cell probing.
//
// Replaces the TPU kernel columbiaimagesearch_tpu/index/pallas_adc.py:
// _adc_kernel (called through adc_scan_all). The index is cell-major, with
// every cell's run padded to 128 rows, so each 128-row block belongs to one
// cell c = block_cell[b]. For padded row r of block b and query q:
//
//   out[q, r] = sum_{m<F} lut0[c / V, m, code[r, m], q]
//             + sum_{m>=F} lut1[c % V, m - F, code[r, m], q]
//
// summed in m order (so the result is bit-equal to the plain version), and
// rows at or past block_count[b] get +inf. The TPU kernel turned the
// lookups into a one-hot [128, M*S] x [M*S, NQ] contraction on the MXU; on
// Hopper the lookup is a gather from shared memory.
//
// What bounds it on the H100. The work itself moves the codes (M bytes a
// padded row), the tables and the [NQ, Npad] output: 575 MB at face scale
// (13.9M padded rows, V=256, M=8, S=256) and NQ=8, 0.17 ms at 3.35 TB/s.
// A gather needs its cell's tables in shared memory, and a cell holds only
// ~128 rows against F*S = 1024 table rows a half, so the table fill from
// L2 (the tables, 2*V*F*S*NQ*4 bytes, stay in the 50 MB L2) is the traffic
// to cut. The first design filled both halves for every (128-row block,
// query tile): 7.1 GB from L2 a call at face NQ=8, serialised with the
// gathers by one __syncthreads.
//
// Design:
// - Work items: runs of consecutive blocks of one cell, at most
//   ITEM_BLOCKS (4) blocks each, listed by the host from the layout
//   (index/exhaustive_adc.py scan_items). One table fill serves every block
//   of an item. A persistent grid (as many blocks as fit on the SMs) gives
//   each block a contiguous range of items of about NB/grid blocks.
// - Tables in a query-tiled layout [V, T, F, Sp, QT] (T = ceil(NQ/QT),
//   S padded to Sp = a multiple of 4; index/exhaustive_adc.py builds it),
//   so the half of one cluster for one query tile is a single contiguous
//   run that one TMA bulk copy (cp.async.bulk, completion on an mbarrier)
//   moves.
// - lut0[c / V] is the same for V consecutive cells: it stays resident in
//   shared memory while (c / V, tile) is unchanged and is refilled (a
//   blocking bulk copy) only when it changes. Each item fills only its
//   lut1[c % V] half, with its codes (nb * 128 * M bytes), into one of two
//   stage buffers: the next item's copy is in flight while the current one
//   is scored. At QT=8, F=4, S=256 each half is 32 KB: 32 KB resident +
//   2 x (32 KB + 4 KB of codes) = 104 KB, two blocks an SM.
// - At NQ > QT a block walks its items once per query tile, tile outermost,
//   so the resident lut0 half serves all the cells of a pass. The codes are
//   then read T times (T * M bytes a padded row, 0.9 GB at NQ=64 against
//   3.6 GB of output). Holding an item's codes across its tiles instead
//   (ADC_TILE_INNER: the tiles of an item back to back) refills lut0 with
//   every (item, tile) and was 2.1x slower on the face index at NQ=64 on
//   the H100 (scripts/torch_kernel_breakdown.py; PERF.md). A thread's codes
//   cannot stay in registers across tiles: the tables of all T tiles of a
//   cell (T x 64 KB) do not fit in shared memory.
// - A thread scores a row: at M=8 its M gathers are unrolled, so all are
//   in flight at once; the entries are still added in m order.
// Compile-time switches, for timing only (scripts/torch_kernel_breakdown.py
// builds copies with them; the port builds none): ADC_STAGES (ring
// buffers), ADC_TILE_INNER (each item's query tiles back to back),
// ADC_NO_FILL, ADC_NO_GATHER, ADC_NO_STORE (that part taken out).
// Where the time goes (scripts/torch_kernel_breakdown.py): on the face
// index at NQ=8 the walk alone (the codes' copies, the barriers, one step
// an item) takes about half the time, the gathers a quarter, the lut1 fill
// and the output stores a tenth each. The rate follows the blocks an SM
// holds: a deeper ring with one block an SM is slower. Not done here (a
// later design): fusing the top-k so [NQ, Npad] is never written, and
// sharing each lut1 fill across the blocks of a cluster (TMA multicast).
//
// Out-of-range cell ids (block_cell outside [0, V*V)) and code bytes >= S
// poison their rows with NaN instead of reading outside the tables.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py). C interface for ctypes; the
// launcher checks its shapes, returns cudaErrorInvalidValue or
// cudaGetLastError(), and the Python wrapper raises if that is not 0.

#include <algorithm>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#ifndef ADC_STAGES
#define ADC_STAGES 2
#endif

namespace {

constexpr int kBlk = 128;       // rows per layout block
constexpr int kThreads = 256;
constexpr int kBarBytes = 128;  // the mbarriers, padded
// Buffers of (lut1 half, codes) in a block's ring. Two, with two blocks an
// SM at QT=8, beat three to five with one block an SM (0.53 against
// 0.85 ms at face scale, NQ=8, on the H100): the blocks an SM hold, not
// the copies in flight in one, set the rate.
constexpr int kStages = ADC_STAGES;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Shared memory written by the threads (or read by them) before an async
// bulk copy overwrites it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// First index i in [0, n] with a[i] >= x (a ascending, a[n] is the end).
__device__ __forceinline__ int lower_bound(const int* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// acc[q] += the table entry of code byte c at position m (lut0 half below
// F, lut1 half from F); true when c >= S (the row is poisoned).
template <int QT>
__device__ __forceinline__ bool add_entry(int c, int m, int F,
                                          const float* res, const float* h1,
                                          int S, int Sp, float* acc) {
  const bool bad = c >= S;
  c = min(c, S - 1);
  const float* e = m < F ? res + (m * Sp + c) * QT
                         : h1 + ((m - F) * Sp + c) * QT;
  if constexpr (QT % 4 == 0) {
    const float4* e4 = reinterpret_cast<const float4*>(e);
#pragma unroll
    for (int q4 = 0; q4 < QT / 4; ++q4) {
      const float4 v = e4[q4];
      acc[4 * q4 + 0] += v.x;
      acc[4 * q4 + 1] += v.y;
      acc[4 * q4 + 2] += v.z;
      acc[4 * q4 + 3] += v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[q] += e[q];
  }
  return bad;
}

struct Params {
  const unsigned char* codes;
  const int* block_cell;
  const int* block_count;
  const int* items;  // [n_items + 1] first block of each item, then NB
  const float* lut0;  // [V, T, F, Sp, QT]
  const float* lut1;
  float* out;         // [NQ, NB * 128]
  int NB, n_items, M, V, S, Sp, NQ, T, cap;
  long long npad;
};

// MT: M when it is fixed at compile time (8), else 0.
template <int QT, int MT>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // bar[0, kStages): the stages; bar[kStages]: the resident lut0 half.
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int F = p.M >> 1;
  const int H = F * p.Sp * QT;                 // floats of one table half
  const int CB = (p.cap * kBlk * p.M + 15) & ~15;  // code bytes of a stage
  float* res = reinterpret_cast<float*>(smem + kBarBytes);
  // Stage j: its lut1 half, then its codes.
  auto half1 = [&](int j) {
    return reinterpret_cast<float*>(smem + kBarBytes + 4 * H +
                                    j * (4 * H + CB));
  };
  auto cbuf = [&](int j) {
    return smem + kBarBytes + 4 * H + j * (4 * H + CB) + 4 * H;
  };

  // This block's items: those starting in its share of the blocks.
  const long long G = gridDim.x;
  const long long NB = p.NB;
  const int lo = lower_bound(p.items, p.n_items, NB * blockIdx.x / G);
  const int hi = lower_bound(p.items, p.n_items, NB * (blockIdx.x + 1) / G);
  const int n_it = hi - lo;
  const int K = n_it * p.T;  // stages: (tile, item), tile outermost
  if (K == 0) return;

  const long long VV = static_cast<long long>(p.V) * p.V;
  // Stage k: (query tile, item), tile outermost; ADC_TILE_INNER: item
  // outermost, so an item's codes are re-read from L2 for each tile.
#ifdef ADC_TILE_INNER
  auto tile_of = [&](int k) { return k % p.T; };
  auto item_of = [&](int k) { return lo + k / p.T; };
#else
  auto tile_of = [&](int k) { return k / n_it; };
  auto item_of = [&](int k) { return lo + k % n_it; };
#endif
  auto issue = [&](int k) {  // thread 0: stage k's codes and lut1 half
    const int t = tile_of(k);
    const int it = item_of(k);
    const int b0 = p.items[it];
    const int nb = p.items[it + 1] - b0;
    const int cell = p.block_cell[b0];
    const bool good = cell >= 0 && cell < VV;
    const uint32_t cbytes = static_cast<uint32_t>(nb) * kBlk * p.M;
    const int j = k % kStages;
    fence_proxy_async();
#ifdef ADC_NO_FILL
    const bool fill = false;
#else
    const bool fill = good;
#endif
    mbar_expect(&bar[j], cbytes + (fill ? 4u * H : 0u));
    bulk_g2s(cbuf(j), p.codes + static_cast<long long>(b0) * kBlk * p.M,
             cbytes, &bar[j]);
    if (fill) {
      const long long h1 = cell % p.V;
      bulk_g2s(half1(j), p.lut1 + (h1 * p.T + t) * H, 4u * H, &bar[j]);
    }
  };

  if (threadIdx.x == 0) {
    for (int j = 0; j <= kStages; ++j) mbar_init(&bar[j]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the first kStages - 1 stages ahead
    for (int k = 0; k < kStages - 1 && k < K; ++k) issue(k);
  }

  const float inf = __int_as_float(0x7f800000);
  const float nan = __int_as_float(0x7fc00000);
  long long res_key = -1;  // (c / V) * T + tile held in `res`
  uint32_t res_phase = 0;
  for (int k = 0; k < K; ++k) {
    // Stage (k - 1) % kStages was freed by the last step's __syncthreads.
    if (threadIdx.x == 0 && k + kStages - 1 < K) issue(k + kStages - 1);
    const int t = tile_of(k);
    const int it = item_of(k);
    const int b0 = p.items[it];
    const int nrows = (p.items[it + 1] - b0) * kBlk;
    const int cell = p.block_cell[b0];
    const bool good = cell >= 0 && cell < VV;
    if (good) {
      const long long key = static_cast<long long>(cell / p.V) * p.T + t;
      if (key != res_key) {  // uniform: every thread sees the same key
        if (threadIdx.x == 0) {
          fence_proxy_async();
          mbar_expect(&bar[kStages], 4u * H);
          bulk_g2s(res, p.lut0 + key * H, 4u * H, &bar[kStages]);
        }
        mbar_wait(&bar[kStages], res_phase);
        res_phase ^= 1;
        res_key = key;
      }
    }
    const int j = k % kStages;
    mbar_wait(&bar[j], (k / kStages) & 1);

    const float* h1 = half1(j);
    const unsigned char* cb = cbuf(j);
    const int q0 = t * QT;
    const int nq = min(QT, p.NQ - q0);
    for (int r = threadIdx.x; r < nrows; r += kThreads) {
      const int b = b0 + r / kBlk;
      const long long row = static_cast<long long>(b) * kBlk + r % kBlk;
      float* o = p.out + q0 * p.npad + row;
      if (r % kBlk >= p.block_count[b] || !good) {
        const float v = r % kBlk >= p.block_count[b] ? inf : nan;
        for (int q = 0; q < nq; ++q) o[q * p.npad] = v;
        continue;
      }
      float acc[QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) acc[q] = 0.f;
      bool bad = false;
      const unsigned char* code = cb + r * p.M;
      if constexpr (MT > 0) {  // unrolled: every gather is issued at once
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#ifdef ADC_NO_GATHER
          acc[m % QT] += code[m];
#else
          bad |= add_entry<QT>(code[m], m, MT / 2, res, h1, p.S, p.Sp, acc);
#endif
        }
      } else {
        for (int m = 0; m < p.M; ++m) {
          bad |= add_entry<QT>(code[m], m, F, res, h1, p.S, p.Sp, acc);
        }
      }
#pragma unroll
      for (int q = 0; q < QT; ++q) {
#ifdef ADC_NO_STORE
        if (q < nq && acc[q] == -1.2345f) o[q * p.npad] = acc[q];
#else
        if (q < nq) o[q * p.npad] = bad ? nan : acc[q];
#endif
      }
    }
    __syncthreads();  // stage j and `res` are free for the next copies
  }
}

// Devices the per-device launch caches hold (device ordinals below it).
constexpr int kMaxDevices = 64;

template <int QT, int MT>
cudaError_t launch(const Params& p, size_t smem, int num_sms,
                   cudaStream_t stream) {
  // Set once per (device, shared-memory size) of a kernel: the attribute
  // and occupancy queries cost host time on every call otherwise. One
  // entry per device, so launches that alternate between cards do not set
  // the attribute on every call; the mutex serialises the first set where
  // several host threads launch at once.
  static std::mutex mu;
  static size_t set_smem[kMaxDevices] = {};
  static int per_sm_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return de;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (set_smem[dev] != smem) {
      cudaError_t e = cudaFuncSetAttribute(
          adc_scan_kernel<QT, MT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm_of[dev], adc_scan_kernel<QT, MT>, kThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm_of[dev] < 1) return cudaErrorInvalidValue;
      set_smem[dev] = smem;
    }
    per_sm = per_sm_of[dev];
  }
  const long long grid =
      std::min<long long>(static_cast<long long>(per_sm) * num_sms, p.n_items);
  adc_scan_kernel<QT, MT><<<static_cast<unsigned>(grid), kThreads, smem,
                            stream>>>(p);
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_m(const Params& p, size_t smem, int num_sms,
                     cudaStream_t stream) {
  return p.M == 8 ? launch<QT, 8>(p, smem, num_sms, stream)
                  : launch<QT, 0>(p, smem, num_sms, stream);
}

}  // namespace

// codes [NB*128, M] u8, block_cell/block_count [NB] i32, items
// [n_items + 1] i32 (first block of each work item, ascending, then NB;
// each item one cell's run of at most `cap` blocks), lut0t/lut1t
// [V, T, F, Sp, QT] f32 (T = ceil(NQ / QT), Sp >= S, Sp % 4 == 0) -> out
// [NQ, NB*128] f32. All contiguous, all on the current device (the
// caller makes the inputs' device current). M even,
// 1 <= S <= 256, V <= 46340 (cell ids are int32), QT in {1, 2, 4, 8};
// `smem` the dynamic shared memory the wrapper sized (index/exhaustive_adc.py
// _scan_smem_bytes).
extern "C" int adc_scan(const void* codes, const void* block_cell,
                        const void* block_count, const void* items,
                        const void* lut0t, const void* lut1t, void* out,
                        int NB, int n_items, int M, int V, int S, int Sp,
                        int NQ, int QT, int cap, long long smem, int num_sms,
                        void* stream) {
  if (NB < 0 || NQ < 0 || n_items < 0 || M < 2 || M % 2 != 0 || S < 1 ||
      S > 256 || Sp < S || Sp % 4 != 0 || V < 1 || V > 46340 || cap < 1 ||
      num_sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long half = 4LL * (M / 2) * Sp * QT;
  const long long cb = (static_cast<long long>(cap) * kBlk * M + 15) & ~15LL;
  if (smem < kBarBytes + (1 + kStages) * half + kStages * cb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (NB == 0 || NQ == 0 || n_items == 0) return 0;
  Params p;
  p.codes = static_cast<const unsigned char*>(codes);
  p.block_cell = static_cast<const int*>(block_cell);
  p.block_count = static_cast<const int*>(block_count);
  p.items = static_cast<const int*>(items);
  p.lut0 = static_cast<const float*>(lut0t);
  p.lut1 = static_cast<const float*>(lut1t);
  p.out = static_cast<float*>(out);
  p.NB = NB;
  p.n_items = n_items;
  p.M = M;
  p.V = V;
  p.S = S;
  p.Sp = Sp;
  p.NQ = NQ;
  p.T = (NQ + QT - 1) / QT;
  p.cap = cap;
  p.npad = static_cast<long long>(NB) * kBlk;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sm = static_cast<size_t>(smem);
  cudaError_t e;
  switch (QT) {
    case 8: e = launch_m<8>(p, sm, num_sms, st); break;
    case 4: e = launch_m<4>(p, sm, num_sms, st); break;
    case 2: e = launch_m<2>(p, sm, num_sms, st); break;
    case 1: e = launch_m<1>(p, sm, num_sms, st); break;
    default: e = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(e);
}
