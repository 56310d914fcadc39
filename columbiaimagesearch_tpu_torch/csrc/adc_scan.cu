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
// and rows at or past block_count[b] get +inf. The TPU kernel turned the
// lookups into a one-hot [128, M*S] x [M*S, NQ] contraction on the MXU; on
// Hopper the lookup is a gather from shared memory.
//
// Design: one block of 128 threads per (cell block, tile of QT queries);
// each thread owns one row. The block copies its cell's two table halves
// for its query tile into shared memory as [M, S, QT] (entry (m, t) at
// (m * S + t) * QT: half 0 holds m < F, half 1 the rest), which is
// M * S * QT * 4 bytes (64 KB at M=8, S=256, QT=8; above 48 KB it is
// dynamic shared memory opted in with cudaFuncSetAttribute). Each thread
// reads its row's M code bytes once, adds the M table rows (float4 reads
// when QT % 4 == 0) for every query of the tile, in m order, and writes
// out[q, r] for each query: 128 consecutive floats per query, coalesced.
// Blocks with count 0 skip the table fill. QT is the smallest power of two
// >= min(NQ, 8) whose tables fit the shared memory a block may opt into.
//
// Bound: the table fill from L2, 2*F*S*QT*4 bytes per block and query tile
// (64 KB per 128 rows at F=4, S=256, QT=8), against a codes read of M bytes
// and an output write of NQ*4 bytes per padded row: the fill moves 16x the
// bytes of the output. Later designs (a later PR): keep lut0[c / V]
// resident across the V consecutive cells that share it, and fuse the
// top-k so [NQ, Npad] is never written.
//
// Out-of-range cell ids (block_cell outside [0, V*V)) and code bytes >= S
// poison their rows with NaN instead of reading outside the tables.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see kernels/build.py). C interface for ctypes; the
// launcher checks its shapes, returns cudaErrorInvalidValue or
// cudaGetLastError(), and the Python wrapper raises if that is not 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 128;

template <int QT>
__global__ void __launch_bounds__(kBlk)
adc_scan_kernel(const unsigned char* __restrict__ codes,
                const int* __restrict__ block_cell,
                const int* __restrict__ block_count,
                const float* __restrict__ lut0,
                const float* __restrict__ lut1, float* __restrict__ out,
                int M, int V, int S, int NQ, long long npad, bool vec) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);  // [M, S, QT]

  const long long b = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, NQ - q0);
  const long long row = b * kBlk + threadIdx.x;
  const int count = block_count[b];
  const int cell = block_cell[b];
  const float inf = __int_as_float(0x7f800000);
  const float nan = __int_as_float(0x7fc00000);
  float* out_row = out + static_cast<long long>(q0) * npad + row;

  // Whole-block exits (uniform, before the barrier).
  if (count <= 0) {
    for (int k = 0; k < nq; ++k) out_row[k * npad] = inf;
    return;
  }
  if (cell < 0 || static_cast<long long>(cell) >= static_cast<long long>(V) * V) {
    const float v = threadIdx.x < count ? nan : inf;
    for (int k = 0; k < nq; ++k) out_row[k * npad] = v;
    return;
  }

  const int FS = (M >> 1) * S;  // entries of one table half
  const float* src0 = lut0 + static_cast<long long>(cell / V) * FS * NQ + q0;
  const float* src1 = lut1 + static_cast<long long>(cell % V) * FS * NQ + q0;
  if constexpr (QT % 4 == 0) {
    if (vec) {  // NQ % 4 == 0: a float4 is either all in range or all out
      constexpr int QT4 = QT / 4;
      for (int i = threadIdx.x; i < 2 * FS * QT4; i += kBlk) {
        const int j = i % QT4;
        const int he = i / QT4;
        const float* src = he < FS ? src0 + static_cast<long long>(he) * NQ
                                   : src1 + static_cast<long long>(he - FS) * NQ;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * j < nq) v = __ldg(reinterpret_cast<const float4*>(src) + j);
        smem4[i] = v;
      }
    }
  }
  if (!(QT % 4 == 0 && vec)) {
    for (int i = threadIdx.x; i < 2 * FS * QT; i += kBlk) {
      const int k = i % QT;
      const int he = i / QT;
      const float* src = he < FS ? src0 + static_cast<long long>(he) * NQ
                                 : src1 + static_cast<long long>(he - FS) * NQ;
      tab[i] = k < nq ? __ldg(src + k) : 0.f;
    }
  }
  __syncthreads();

  if (threadIdx.x >= count) {
    for (int k = 0; k < nq; ++k) out_row[k * npad] = inf;
    return;
  }
  float acc[QT];
#pragma unroll
  for (int k = 0; k < QT; ++k) acc[k] = 0.f;
  bool bad = false;
  const unsigned char* code = codes + row * M;
  for (int m = 0; m < M; ++m) {
    int t = code[m];
    bad |= t >= S;
    t = min(t, S - 1);
    const float* e = tab + (m * S + t) * QT;
    if constexpr (QT % 4 == 0) {
      const float4* e4 = reinterpret_cast<const float4*>(e);
#pragma unroll
      for (int k4 = 0; k4 < QT / 4; ++k4) {
        const float4 v = e4[k4];
        acc[4 * k4 + 0] += v.x;
        acc[4 * k4 + 1] += v.y;
        acc[4 * k4 + 2] += v.z;
        acc[4 * k4 + 3] += v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < QT; ++k) acc[k] += e[k];
    }
  }
#pragma unroll
  for (int k = 0; k < QT; ++k) {
    if (k < nq) out_row[k * npad] = bad ? nan : acc[k];
  }
}

template <int QT>
cudaError_t launch(int NB, int tiles, size_t smem, cudaStream_t stream,
                   const unsigned char* codes, const int* block_cell,
                   const int* block_count, const float* lut0,
                   const float* lut1, float* out, int M, int V, int S,
                   int NQ, bool vec) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        adc_scan_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(NB), static_cast<unsigned>(tiles));
  adc_scan_kernel<QT><<<grid, kBlk, smem, stream>>>(
      codes, block_cell, block_count, lut0, lut1, out, M, V, S, NQ,
      static_cast<long long>(NB) * kBlk, vec);
  return cudaGetLastError();
}

}  // namespace

// codes [NB*128, M] u8, block_cell/block_count [NB] i32, lut0/lut1
// [V, M/2, S, NQ] f32 -> out [NQ, NB*128] f32. All contiguous, all on the
// current device. M even, 1 <= S <= 256, V <= 46340 (cell ids are int32).
extern "C" int adc_scan(const void* codes, const void* block_cell,
                        const void* block_count, const void* lut0,
                        const void* lut1, void* out, int NB, int M, int V,
                        int S, int NQ, void* stream) {
  if (NB < 0 || NQ < 0 || M < 2 || M % 2 != 0 || S < 1 || S > 256 ||
      V < 1 || V > 46340) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (NB == 0 || NQ == 0) return 0;
  int dev = 0;
  int max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto smem_of = [&](int qt) {
    return static_cast<size_t>(M) * S * qt * sizeof(float);
  };
  int qt = 8;
  while (qt > 1 && qt / 2 >= NQ) qt >>= 1;
  while (qt > 1 && smem_of(qt) > static_cast<size_t>(max_smem)) qt >>= 1;
  if (smem_of(qt) > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (NQ + qt - 1) / qt;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = qt % 4 == 0 && NQ % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(lut0) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(lut1) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pc = static_cast<const unsigned char*>(codes);
  const auto* pb = static_cast<const int*>(block_cell);
  const auto* pn = static_cast<const int*>(block_count);
  const auto* l0 = static_cast<const float*>(lut0);
  const auto* l1 = static_cast<const float*>(lut1);
  auto* po = static_cast<float*>(out);
  const size_t smem = smem_of(qt);
  switch (qt) {
    case 8: e = launch<8>(NB, tiles, smem, st, pc, pb, pn, l0, l1, po, M, V, S, NQ, vec); break;
    case 4: e = launch<4>(NB, tiles, smem, st, pc, pb, pn, l0, l1, po, M, V, S, NQ, vec); break;
    case 2: e = launch<2>(NB, tiles, smem, st, pc, pb, pn, l0, l1, po, M, V, S, NQ, vec); break;
    default: e = launch<1>(NB, tiles, smem, st, pc, pb, pn, l0, l1, po, M, V, S, NQ, vec); break;
  }
  return static_cast<int>(e);
}
