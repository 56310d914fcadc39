// ADC lookup tables for the probed coarse clusters of a batch of queries.
//
// Replaces the TPU kernel columbiaimagesearch_tpu/index/tpu_query.py:
// _lut_kernel (called through build_luts_pallas), which handles one query.
// This takes a batch: for query q, split s and probed slot b with cluster
// v = isel[q, s, b]
//
//   r            = x2[q, s] - Cs[s, v] - mus[s, v]             [Dh]
//   pr           = Rs[s, v] @ r                                [Dh]
//   T[q,s,b,f,t] = sum_d (pr[f*Dsub + d] - subs[s, f, t, d])^2
//
// What bounds it on the H100: device-memory bytes, and above all the
// rotation matrices (Dh*Dh*4 bytes each, 64 KB at Dh=128). The work needs
// each distinct probed (s, v) matrix once: ~211 MB for a 32-query serving
// wave at B=64, V=4096 (0.063 ms at 3.35 TB/s), against a 16.8 MB output;
// at the exhaustive path's all-V shape (every query probes every cluster)
// the 134 MB output binds instead, against 8.4 MB of matrices. The first
// design (one block per (q, s, tile of slots)) read a matrix once per
// probing slot: 839 MB at NQ=100 against 424 MB distinct, 537 MB against
// 8.4 MB at all-V.
//
// Design: two launches on the caller's stream.
// 1. lut_sort_kernel (one block): a counting sort of each split's slots by
//    cluster id -- histogram, scan, scatter, with the bins in shared memory
//    (in global scratch when 2 * (V + 1) bins do not fit) -- that also
//    lists the groups: each distinct (split, cluster) with the run of
//    sorted slots that probe it; out-of-range ids form a last group of
//    their split, cluster -1. Two calls skip it: one query's (each slot a
//    group of its own, since a query's probes of a split are distinct
//    clusters), and the exhaustive path's, where every query probes every
//    cluster (the groups are known: cluster v's slots are the queries).
// 2. lut_band_kernel: a work unit is (group, f): band f of the group's
//    matrix (rows [f*Dsub, (f+1)*Dsub), all that table f needs), applied to
//    every slot of the group, then table f of each slot. Each band, so each
//    probed matrix, is read from device memory once per call, however many
//    slots probe it. Block b takes the split s and sub f of pair b % (2F)
//    and a contiguous range of that split's groups, so subs[s, f] stays in
//    registers (one table entry a thread) for the whole walk, and the 2F
//    blocks of neighbouring ids read the F bands of the same matrices. One
//    producer warp reads each group's ids and issues TMA bulk copies
//    (cp.async.bulk, completion on an mbarrier) of its band, its Cs and mus
//    rows and its slots' query rows into a ring of kStages shared-memory
//    stages, up to kStages groups ahead; eight consumer warps wait for a
//    stage and work from shared memory alone (a group of more than kx
//    slots reads its later slots' rows directly). A one-query call has
//    2 * B * F units (512 at B=64, F=4): the matrices' row bands spread over
//    every SM instead of one block a slot. Plain fp32 FMA (no tensor cores,
//    no TF32); a slot's arithmetic does not depend on its group, so its
//    tables do not depend on the rest of the batch.
//    The producer reads ids ahead so that no dependent round trip to
//    device memory sits in a group's path (with the consumers reading
//    them, three did, and the kernel was latency-bound). Two blocks an SM
//    with four stages: registers sized for three blocks spill the tables'
//    subs and were slower.
// Where the time goes (scripts/torch_kernel_breakdown.py; PERF.md): at a
// serving wave the sort takes a tenth of the call and the producer's
// copies most of the rest, at ~2.75 TB/s of distinct matrix bytes; the
// sort about pays for itself there (uniform random probes share a fifth
// of their matrices) and pays at 100 queries. At the all-V shape the
// rotation (a warp's half idle at Dh=64) and the tables take the time.
//
// Compile-time switches, for timing only (scripts/torch_kernel_breakdown.py
// builds copies with them; the port builds none): LUT_STAGES (ring depth),
// LUT_MIN_BLOCKS (blocks an SM the registers and stages are sized for),
// LUT_SORT_ONLY (the grouping launch alone), LUT_NO_TABLES (rotate but
// write no tables), LUT_LOADS_ONLY (the producer's copies and the
// consumers' walk alone).
//
// Requires Dh % 4 == 0, Dsub % 4 == 0 and 16-byte aligned buffers (bulk
// copies, float4 rows; the wrapper checks), and a block's shared memory
// (kStages bands of Dsub*Dh*4 bytes plus the residuals) within the card's
// 227 KB. Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC (see kernels/build.py). C interface for ctypes;
// the launcher returns cudaErrorInvalidValue or cudaGetLastError(), and the
// Python wrapper raises if it is not 0.

#include <algorithm>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#ifndef LUT_STAGES
#define LUT_STAGES 4
#endif
#ifndef LUT_MIN_BLOCKS
#define LUT_MIN_BLOCKS 2
#endif

namespace {

constexpr int kConsumers = 256;  // threads that rotate and build tables
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = LUT_STAGES;  // groups in a block's ring
constexpr int kBarBytes = 128;  // the mbarriers (full, empty), padded
constexpr int kMaxKx = 64;  // most slots whose query rows a stage holds
constexpr int kMeta = 4 + kMaxKx;  // a stage's header: cluster, p0, p1, -,
                                   // then its first slots
constexpr int kHead = kBarBytes + ((kStages * kMeta * 4 + 15) & ~15);
constexpr int kSortThreads = 1024;
constexpr int kSortSmemMax = 96 * 1024;  // bins in shared memory up to this
constexpr int kMaxDevices = 64;  // devices the launch caches hold
constexpr int kMinBlocks = LUT_MIN_BLOCKS;  // blocks an SM to fit
constexpr int kTargetSmem = 227 * 1024 / kMinBlocks - 1024;
constexpr int kMaxSmem = 227 * 1024;
static_assert(2 * kStages * 8 <= kBarBytes, "barriers do not fit");

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The consumers' barrier (the producer warp does not take part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
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

// Shared memory read by the threads before an async bulk copy overwrites it.
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

__device__ __forceinline__ float sq_dist4(float4 p, float4 c, float acc) {
  float d = p.x - c.x;
  acc = fmaf(d, d, acc);
  d = p.y - c.y;
  acc = fmaf(d, d, acc);
  d = p.z - c.z;
  acc = fmaf(d, d, acc);
  d = p.w - c.w;
  return fmaf(d, d, acc);
}

// The warp sums of four values in six shuffles: lane l ends with the sum
// of value 2 * bit4(l) + bit3(l) (lanes 0, 8, 16, 24 hold values 0-3).
__device__ __forceinline__ float reduce4(float a0, float a1, float a2,
                                         float a3, int lane) {
  const bool hi = lane & 16;
  const float b0 = (hi ? a2 : a0) + __shfl_xor_sync(0xffffffffu, hi ? a0 : a2, 16);
  const float b1 = (hi ? a3 : a1) + __shfl_xor_sync(0xffffffffu, hi ? a1 : a3, 16);
  const bool mid = lane & 8;
  float c = (mid ? b1 : b0) + __shfl_xor_sync(0xffffffffu, mid ? b0 : b1, 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  return c;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Bin of flat slot j = (q * 2 + s) * B + b: s * (V + 1) + v, with
// out-of-range ids in bin s * (V + 1) + V.
__device__ __forceinline__ int slot_bin(const int* isel, int j, int B,
                                        int V) {
  const int v = isel[j];
  return ((j / B) & 1) * (V + 1) + ((v >= 0 && v < V) ? v : V);
}

// The block's exclusive prefix of x over threads, and the total.
__device__ __forceinline__ int block_exclusive_scan(int x, int* wsum,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(x, lane);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) wsum[lane] = warp_inclusive_scan(wsum[lane], lane);
  __syncthreads();
  const int r = incl - x + (warp > 0 ? wsum[warp - 1] : 0);
  *total = wsum[kSortThreads / 32 - 1];
  __syncthreads();  // wsum is free for the next scan
  return r;
}

// Sorted slots and their groups. order[p], p < 2 * NS: split s's slots at
// positions [s * NS, (s + 1) * NS), ascending cluster id, out-of-range ids
// last. Group g: cluster gv[g] (-1: out of range), positions
// [gstart[g], gstart[g + 1]); split 0 holds groups [0, ngs[0]), split 1
// groups [ngs[0], ngs[1]). gbins: [2 * (V + 1)] global scratch, or null
// for shared-memory bins.
__global__ void __launch_bounds__(kSortThreads)
lut_sort_kernel(const int* __restrict__ isel, int nslots, int B, int V,
                int* __restrict__ gbins, int* __restrict__ order,
                int* __restrict__ gstart, int* __restrict__ gv,
                int* __restrict__ ngs) {
  extern __shared__ int sbins[];
  __shared__ int wsum[kSortThreads / 32];
  int* bins = gbins != nullptr ? gbins : sbins;
  const int tid = threadIdx.x;
  const int nbins = 2 * (V + 1);
  for (int k = tid; k < nbins; k += kSortThreads) bins[k] = 0;
  __syncthreads();
  for (int j = tid; j < nslots; j += kSortThreads) {
    atomicAdd(&bins[slot_bin(isel, j, B, V)], 1);
  }
  __syncthreads();
  // Each thread a chunk of bins: the slots before them and the groups
  // (non-empty bins) before them.
  const int chunk = (nbins + kSortThreads - 1) / kSortThreads;
  const int k0 = min(nbins, tid * chunk);
  const int k1 = min(nbins, k0 + chunk);
  int sum = 0, nz = 0;
  for (int k = k0; k < k1; ++k) {
    sum += bins[k];
    nz += bins[k] > 0;
  }
  int total_slots, total_groups;
  int run = block_exclusive_scan(sum, wsum, &total_slots);
  int g = block_exclusive_scan(nz, wsum, &total_groups);
  for (int k = k0; k < k1; ++k) {
    if (k == V + 1) ngs[0] = g;  // the groups of split 0
    const int c = bins[k];
    if (c > 0) {
      const int v = k % (V + 1);
      gstart[g] = run;
      gv[g] = v < V ? v : -1;
      ++g;
    }
    bins[k] = run;  // becomes the scatter cursor
    run += c;
  }
  if (tid == 0) {
    ngs[1] = total_groups;
    gstart[total_groups] = total_slots;
  }
  __syncthreads();
  for (int j = tid; j < nslots; j += kSortThreads) {
    order[atomicAdd(&bins[slot_bin(isel, j, B, V)], 1)] = j;
  }
}

struct Args {
  const float* x2;
  const int* isel;
  const float* Cs;
  const float* Rs;
  const float* mus;
  const float* subs;
  const int* order;   // lut_sort_kernel's outputs, or null: every slot a
  const int* gstart;  // group of its own, in slot order
  const int* gv;
  const int* ngs;
  float* out;
  int mode, NQ, B, V, Dh, F, S, Dsub, parts, kx;
};

// The groups of a call, by mode (lut_build's `grouping`):
// kSlots: every slot a group of its own, positions in (split, q, b) order;
// kSorted: lut_sort_kernel's groups; kAllClusters: isel[q, s, b] = b for
// every query (B = V), so group g is cluster g % V of split g / V, probed
// once by each query, at positions [g * NQ, (g + 1) * NQ).
enum Grouping { kSlots = 0, kSorted = 1, kAllClusters = 2 };

// Flat output slot at position p of group g.
__device__ __forceinline__ int group_slot(const Args& a, int g, int p) {
  if (a.mode == kSorted) return a.order[p];
  if (a.mode == kAllClusters) {
    const int s = g >= a.V;
    return ((p - g * a.NQ) * 2 + s) * a.B + (g - s * a.V);
  }
  const int NS = a.NQ * a.B;
  const int s = p >= NS;
  const int i = p - s * NS;
  return ((i / a.B) * 2 + s) * a.B + i % a.B;
}

__device__ __forceinline__ int group_cluster(const Args& a, int g) {
  if (a.mode == kSorted) return a.gv[g];
  if (a.mode == kAllClusters) return g >= a.V ? g - a.V : g;
  const int v = a.isel[group_slot(a, g, g)];
  return (v >= 0 && v < a.V) ? v : -1;
}

// Positions [p0, p1) of group g.
__device__ __forceinline__ void group_range(const Args& a, int g, int& p0,
                                            int& p1) {
  if (a.mode == kSorted) {
    p0 = a.gstart[g];
    p1 = a.gstart[g + 1];
  } else if (a.mode == kAllClusters) {
    p0 = g * a.NQ;
    p1 = p0 + a.NQ;
  } else {
    p0 = g;
    p1 = g + 1;
  }
}

// pr[k, i] = sum_j band[i, j] * r[k, j] for the nk slots of a chunk and
// the Dsub rows of the band: a warp takes four rows and two slots at a
// time, a lane the float4 columns lane, lane + 32, ...
__device__ __forceinline__ void rotate_chunk(const float* band, const float* r,
                                             float* pr, int nk, int Dh,
                                             int Dsub) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Dh4 = Dh >> 2;
  const int quads = Dsub >> 2;
  const int units = quads * ((nk + 1) >> 1);
  const float4* r4 = reinterpret_cast<const float4*>(r);
  const float4* b4 = reinterpret_cast<const float4*>(band);
  for (int u = warp; u < units; u += kWarps) {
    const int i0 = (u % quads) * 4;
    const int k0 = (u / quads) * 2;
    const bool two = k0 + 1 < nk;  // uniform across the warp
    float acc[4][2] = {};
    for (int j4 = lane; j4 < Dh4; j4 += 32) {
      const float4 x0 = r4[k0 * Dh4 + j4];
      const float4 x1 = two ? r4[(k0 + 1) * Dh4 + j4] : x0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 row = b4[(i0 + q) * Dh4 + j4];
        acc[q][0] = fmaf(row.x, x0.x, acc[q][0]);
        acc[q][0] = fmaf(row.y, x0.y, acc[q][0]);
        acc[q][0] = fmaf(row.z, x0.z, acc[q][0]);
        acc[q][0] = fmaf(row.w, x0.w, acc[q][0]);
        acc[q][1] = fmaf(row.x, x1.x, acc[q][1]);
        acc[q][1] = fmaf(row.y, x1.y, acc[q][1]);
        acc[q][1] = fmaf(row.z, x1.z, acc[q][1]);
        acc[q][1] = fmaf(row.w, x1.w, acc[q][1]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c == 0 || two) {
        const float x = reduce4(acc[0][c], acc[1][c], acc[2][c], acc[3][c],
                                lane);
        if ((lane & 7) == 0) pr[(k0 + c) * Dsub + i0 + (lane >> 3)] = x;
      }
    }
  }
}

// Block b: split s and sub f of pair b % (2F), and groups [g_lo, g_hi) of
// split s (part b / (2F) of a.parts). Warp kConsumers / 32 is the
// producer: for each group it reads the group's cluster, positions and
// first kx slot ids, writes them into the stage's header, and issues the
// bulk copies of the band, the Cs and mus rows and those slots' x2 rows
// (one completion barrier a stage, `full`), up to kStages groups ahead of
// the consumers, who free a stage through its `empty` barrier. The
// consumers (threads [0, kConsumers)) wait for a stage and read nothing
// else from device memory for a group of at most kx slots: residuals,
// rotation and tables come from shared memory and registers. DS4: Dsub / 4
// when it is fixed at compile time and S <= kConsumers (subs held in
// registers), else 0.
template <int DS4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lut_band_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int* meta = reinterpret_cast<int*>(smem + kBarBytes);  // [kStages][kMeta]
  const int Dh = a.Dh;
  const int Dsub = a.Dsub;
  const int kx = a.kx;
  const int pair = blockIdx.x % (2 * a.F);
  const int part = blockIdx.x / (2 * a.F);
  const int s = pair / a.F;
  const int f = pair - s * a.F;
  const int band = Dsub * Dh;               // floats of a band
  const int stage = band + (2 + kx) * Dh;   // band, Cs, mus, kx x2 rows
  float* st0 = reinterpret_cast<float*>(smem + kHead);
  float* pr = st0 + kStages * stage;        // [kx, Dsub] rotated rows
  int* sl = reinterpret_cast<int*>(pr + kx * Dsub);  // [kx] later slots
  // Groups of split 0, and of both splits.
  const int NS = a.NQ * a.B;
  const int ng0 = a.mode == kSorted ? a.ngs[0] : a.mode == kAllClusters ? a.V : NS;
  const int ng = a.mode == kSorted ? a.ngs[1] : 2 * ng0;
  const int gb = s ? ng0 : 0;
  const long long n = s ? ng - ng0 : ng0;
  const int g_lo = gb + static_cast<int>(n * part / a.parts);
  const int K = gb + static_cast<int>(n * (part + 1) / a.parts) - g_lo;
  if (K <= 0) return;

  if (threadIdx.x == 0) {
    for (int j = 0; j < kStages; ++j) {
      mbar_init(&full[j]);
      mbar_init(&empty[j]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x & 31;
    // Loads run ahead of their use: a group's cluster and positions two
    // groups ahead, its first kx slot ids one group ahead, so no round
    // trip to device memory waits in line behind another.
    auto group_of = [&](int k, int& v, int& p0, int& p1) {
      const int g = g_lo + k;
      v = group_cluster(a, g);
      group_range(a, g, p0, p1);
    };
    // Lane l takes the group's slots l and l + 32.
    auto slot_of = [&](int k, int p0, int p1, int i) {
      return i < min(kx, p1 - p0) ? group_slot(a, g_lo + k, p0 + i) : -1;
    };
    int v1 = -1, q0 = 0, q1 = 0, v2 = -1, r0 = 0, r1 = 0;
    group_of(0, v1, q0, q1);
    int slot1a = slot_of(0, q0, q1, lane);
    int slot1b = slot_of(0, q0, q1, lane + 32);
    if (K > 1) group_of(1, v2, r0, r1);
    for (int k = 0; k < K; ++k) {
      const int j = k % kStages;
      const int v = v1;
      const int p0 = q0;
      const int p1 = q1;
      const int slot[2] = {slot1a, slot1b};
      v1 = v2;
      q0 = r0;
      q1 = r1;
      if (k + 1 < K) {
        slot1a = slot_of(k + 1, q0, q1, lane);
        slot1b = slot_of(k + 1, q0, q1, lane + 32);
      }
      if (k + 2 < K) group_of(k + 2, v2, r0, r1);
      if (k >= kStages) mbar_wait(&empty[j], (k / kStages - 1) & 1);
      const int nk = min(kx, p1 - p0);
      int* mj = meta + j * kMeta;
      if (lane == 0) {
        mj[0] = v;
        mj[1] = p0;
        mj[2] = p1;
      }
      if (lane < kx) mj[4 + lane] = slot[0];
      if (lane + 32 < kx) mj[4 + lane + 32] = slot[1];
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_expect(&full[j], v >= 0 ? 4u * (band + (2 + nk) * Dh) : 0u);
      }
      __syncwarp();
      if (v >= 0) {
        float* st = st0 + j * stage;
        const long long cv = static_cast<long long>(s) * a.V + v;
        if (lane == 0) {
          bulk_g2s(st, a.Rs + (cv * Dh + static_cast<long long>(f) * Dsub) * Dh,
                   4u * band, &full[j]);
          bulk_g2s(st + band, a.Cs + cv * Dh, 4u * Dh, &full[j]);
          bulk_g2s(st + band + Dh, a.mus + cv * Dh, 4u * Dh, &full[j]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = lane + 32 * h;
          if (i < nk) {
            const long long q = slot[h] / (2 * a.B);
            bulk_g2s(st + band + (2 + i) * Dh, a.x2 + (q * 2 + s) * Dh,
                     4u * Dh, &full[j]);
          }
        }
      }
    }
    return;
  }

  // subs[s, f, t, :] of this thread's entry t = threadIdx.x
  const float4* sub4 = reinterpret_cast<const float4*>(
      a.subs + (static_cast<long long>(s) * a.F + f) * a.S * Dsub);
  float4 cr[DS4 > 0 ? DS4 : 1];
  if constexpr (DS4 > 0) {
    if (threadIdx.x < a.S) {
#pragma unroll
      for (int d4 = 0; d4 < DS4; ++d4) {
        cr[d4] = __ldg(sub4 + threadIdx.x * DS4 + d4);
      }
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  const int Dsub4 = Dsub >> 2;
  const float4* pr4 = reinterpret_cast<const float4*>(pr);

  for (int k = 0; k < K; ++k) {
    const int j = k % kStages;
    mbar_wait(&full[j], (k / kStages) & 1);
    const int* mj = meta + j * kMeta;
    const int v = mj[0];
    const int p0 = mj[1];
    const int p1 = mj[2];
    float* st = st0 + j * stage;
    float* xr = st + band + 2 * Dh;  // x2 rows, then residuals, [kx, Dh]
    for (int c0 = p0; c0 < p1; c0 += kx) {
      const int nk = min(kx, p1 - c0);
      const bool first = c0 == p0;  // its slots and x2 rows are in the stage
      if (!first) {
        if (threadIdx.x < nk) {
          const int p = c0 + threadIdx.x;
          sl[threadIdx.x] = group_slot(a, g_lo + k, p);
        }
        consumer_sync();
      }
      const int* slots = first ? mj + 4 : sl;
#ifndef LUT_LOADS_ONLY
      if (v >= 0) {
        // r = x2 - Cs - mus, in place over the stage's query rows; a later
        // chunk's query values are all loaded before the first is used.
        if (first) {
          for (int e = threadIdx.x; e < nk * Dh; e += kConsumers) {
            const int d = e % Dh;
            xr[e] = xr[e] - st[band + d] - st[band + Dh + d];
          }
        } else {
          constexpr int kR = 8;
          for (int e0 = threadIdx.x; e0 < nk * Dh; e0 += kConsumers * kR) {
            float x[kR];
#pragma unroll
            for (int u = 0; u < kR; ++u) {
              const int e = e0 + u * kConsumers;
              const int kk = e / Dh;
              x[u] = e < nk * Dh
                         ? __ldg(a.x2 + (static_cast<long long>(
                                             slots[kk] / (2 * a.B)) * 2 + s) *
                                            Dh + (e - kk * Dh))
                         : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kR; ++u) {
              const int e = e0 + u * kConsumers;
              if (e < nk * Dh) {
                const int d = e % Dh;
                xr[e] = x[u] - st[band + d] - st[band + Dh + d];
              }
            }
          }
        }
        consumer_sync();
        rotate_chunk(st, xr, pr, nk, Dh, Dsub);
        consumer_sync();
      }
#ifndef LUT_NO_TABLES
      // Table f of each slot: thread t the entries t, t + kConsumers, ...,
      // each summed in d order. (Summing two or four slots at once, for
      // more independent sums in flight, was no faster on the H100.)
      for (int t = threadIdx.x; t < a.S; t += kConsumers) {
        for (int kk = 0; kk < nk; ++kk) {
          float acc = 0.f;
          if constexpr (DS4 > 0) {
#pragma unroll
            for (int d4 = 0; d4 < DS4; ++d4) {
              acc = sq_dist4(pr4[kk * DS4 + d4], cr[d4], acc);
            }
          } else {
            for (int d4 = 0; d4 < Dsub4; ++d4) {
              acc = sq_dist4(pr4[kk * Dsub4 + d4],
                             __ldg(sub4 + static_cast<long long>(t) * Dsub4 +
                                   d4),
                             acc);
            }
          }
          // An out-of-range cluster id poisons its table instead of
          // reading outside Rs; the caller's results then show NaN.
          a.out[(static_cast<long long>(slots[kk]) * a.F + f) * a.S + t] =
              v >= 0 ? acc : nan;
        }
      }
#endif
#endif
      consumer_sync();  // xr, pr and sl are free
    }
    if (threadIdx.x == 0) mbar_arrive(&empty[j]);  // the stage is free
  }
}

template <int DS4>
cudaError_t launch_bands(const Args& base, int NS, int num_sms,
                         cudaStream_t stream) {
  // kx: the most slots (64, 32, 16 or 8) whose x2 rows a stage holds with a
  // block's shared memory within kTargetSmem (kMinBlocks blocks an SM).
  Args a = base;
  size_t smem = 0;
  for (int kx = kMaxKx; kx >= 8; kx >>= 1) {
    a.kx = kx;
    smem = kHead +
           4 * (static_cast<size_t>(kStages) *
                    (static_cast<size_t>(a.Dsub) * a.Dh + (2 + kx) * a.Dh) +
                static_cast<size_t>(kx) * a.Dsub) +
           4 * kx;
    if (smem <= static_cast<size_t>(kTargetSmem)) break;
  }
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  // The attribute and occupancy queries cost host time: once per (device,
  // shared-memory size), one entry per device, so launches that alternate
  // between cards do not set the attribute on every call; the mutex
  // serialises the first set where several host threads launch at once.
  static std::mutex mu;
  static size_t set_smem[kMaxDevices] = {};
  static int per_sm_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (set_smem[dev] != smem) {
      e = cudaFuncSetAttribute(lut_band_kernel<DS4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm_of[dev], lut_band_kernel<DS4>, kThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm_of[dev] < 1) return cudaErrorInvalidValue;
      set_smem[dev] = smem;
    }
    per_sm = per_sm_of[dev];
  }
  // As many parts of each split's groups as the resident blocks allow, and
  // no more than a split can have groups.
  const int pairs = 2 * a.F;
  a.parts = static_cast<int>(std::max<long long>(
      1, std::min<long long>(1LL * per_sm * num_sms / pairs, NS)));
  lut_band_kernel<DS4><<<static_cast<unsigned>(pairs * a.parts), kThreads,
                         smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// int32 scratch that lut_build needs for a grouped call: the sorted slots
// [2 * NS], the group starts [2 * NS + 1], their clusters [2 * NS], the two
// group counts, then bins [2 * (V + 1)] for a V whose bins do not fit in
// shared memory (NS = NQ * B).
extern "C" long long lut_scratch_ints(int NQ, int B, int V) {
  const long long NS = static_cast<long long>(NQ) * B;
  return 6 * NS + 3 + 2 * (static_cast<long long>(V) + 1);
}

// x2 [NQ, 2, Dh] f32, isel [NQ, 2, B] i32, Cs/mus [2, V, Dh] f32,
// Rs [2, V, Dh, Dh] f32, subs [2, F, S, Dsub] f32 -> out [NQ, 2, B, F, S]
// f32. grouping: 1 (kSorted) groups the slots by (split, cluster) first,
// in iscratch (int32 [lut_scratch_ints(NQ, B, V)]); 0 (kSlots) makes every
// slot a group of its own; 2 (kAllClusters) is for isel[q, s, b] = b with
// B = V, which it does not read (isel may be null). iscratch may be null
// unless grouping is 1. All contiguous, 16-byte aligned, on the current
// device (the caller makes the inputs' device current). Dh == F * Dsub, and Dh, Dsub multiples of 4. num_sms: the
// device's SM count (grid size).
extern "C" int lut_build(const void* x2, const void* isel, const void* Cs,
                         const void* Rs, const void* mus, const void* subs,
                         void* out, void* iscratch, int grouping, int NQ,
                         int B, int V, int Dh, int F, int S, int Dsub,
                         int num_sms, void* stream) {
  if (NQ == 0 || B == 0) return 0;
  if (NQ < 0 || B < 0 || F < 1 || S < 1 || Dh != F * Dsub || Dh % 4 != 0 ||
      Dsub % 4 != 0 || V < 1 || num_sms < 1 || grouping < kSlots ||
      grouping > kAllClusters || (grouping == kAllClusters && B != V) ||
      (grouping == kSorted && iscratch == nullptr) ||
      (grouping != kAllClusters && isel == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long NS = static_cast<long long>(NQ) * B;
  if (lut_scratch_ints(NQ, B, V) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool sorted = grouping == kSorted;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pi = static_cast<const int*>(isel);
  int* order = sorted ? static_cast<int*>(iscratch) : nullptr;
  int* gstart = sorted ? order + 2 * NS : nullptr;
  int* gv = sorted ? gstart + 2 * NS + 1 : nullptr;
  int* ngs = sorted ? gv + 2 * NS : nullptr;
  cudaError_t e = cudaSuccess;
  if (sorted) {
    const size_t bin_bytes = 2 * (static_cast<size_t>(V) + 1) * sizeof(int);
    const bool in_smem = bin_bytes <= static_cast<size_t>(kSortSmemMax);
    const size_t sort_smem = in_smem ? bin_bytes : 0;
    // The attribute, once per device (see launch_bands).
    static std::mutex sort_mu;
    static bool sort_set[kMaxDevices] = {};
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= kMaxDevices) {
      return static_cast<int>(cudaErrorInvalidDevice);
    }
    {
      std::lock_guard<std::mutex> lock(sort_mu);
      if (!sort_set[dev]) {
        e = cudaFuncSetAttribute(lut_sort_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSortSmemMax);
        if (e != cudaSuccess) return static_cast<int>(e);
        sort_set[dev] = true;
      }
    }
    lut_sort_kernel<<<1, kSortThreads, sort_smem, st>>>(
        pi, static_cast<int>(2 * NS), B, V, in_smem ? nullptr : ngs + 2,
        order, gstart, gv, ngs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
#ifdef LUT_SORT_ONLY
    return 0;
#endif
  }

  Args a;
  a.x2 = static_cast<const float*>(x2);
  a.isel = pi;
  a.Cs = static_cast<const float*>(Cs);
  a.Rs = static_cast<const float*>(Rs);
  a.mus = static_cast<const float*>(mus);
  a.subs = static_cast<const float*>(subs);
  a.mode = grouping;
  a.order = order;
  a.gstart = gstart;
  a.gv = gv;
  a.ngs = ngs;
  a.out = static_cast<float*>(out);
  a.NQ = NQ;
  a.B = B;
  a.V = V;
  a.Dh = Dh;
  a.F = F;
  a.S = S;
  a.Dsub = Dsub;
  a.parts = 1;
  a.kx = 8;
  const int ns = static_cast<int>(NS);
  if (S <= kConsumers) {
    switch (Dsub) {
      case 32: e = launch_bands<8>(a, ns, num_sms, st); break;
      case 16: e = launch_bands<4>(a, ns, num_sms, st); break;
      case 8: e = launch_bands<2>(a, ns, num_sms, st); break;
      default: e = launch_bands<0>(a, ns, num_sms, st); break;
    }
  } else {
    e = launch_bands<0>(a, ns, num_sms, st);
  }
  return static_cast<int>(e);
}
