// SAC bit-plane matmul on a compacted work schedule, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sac_matmul/kernel.py::sac_matmul_kernel
// (launched there by sac_matmul_pallas_call).  Same inputs, same schedule
// walk, same mask semantics, per-plane f32 segments and one rear
// shift-and-add with the per-channel scale:
//
//   for each (M tile, N tile j), for each slot w with mask[j, w] != 0:
//     b = plane_ids[j, w], t = ktile_ids[j, w]
//     S_b += a[:, tile t] @ (unpack(planes[b, t, j]) * (1 - 2 unpack(signs[t, j])))
//   out = (sum_b 2^b S_b) * scale[j]          (run once, even for 0 slots)
//
// What bounds it on the card: a slot does 2 * M * ks * 128 f32 flops on
// ks * 128 / 8 bytes of packed plane words, 16 * M flops per byte, against
// a ridge of 67 TFLOP/s (FP32 outside the tensor cores) / 3.35 TB/s = 20.
// So every VGG-16 layer, the 8-row fc GEMVs included, is bound by FP32
// operations; only a single unpadded row (M = 1) would be bound by bytes.
//
// What the design does about it:
//  * Segment storage.  The TPU kept [B-1, 256, 128] f32 segments in VMEM
//    (917,504 B at B = 8); a Hopper block has 227 KB.  Here a CTA owns BM
//    = 8, 16 or 32 rows (the wrapper picks the tallest that fits and still
//    gives every SM a CTA) so the (B-1) * BM * 128 * 4 B of segments fit
//    in shared memory: 114,688 B at B = 8 and BM = 32.  Each
//    thread accumulates one slot's tile dot in registers and adds it to its
//    own segment entries once per slot: shared-memory traffic per slot is
//    R words per thread, not one per FMA.
//  * The walk.  One CTA per (N tile, M tile).  The schedule row is the same
//    for every thread, so the slot loop and the mask test are uniform; no
//    scalar prefetch exists, the CTA reads its own mask/plane_ids/ktile_ids.
//  * Memory access.  Slots are k-major, so consecutive slots share a K
//    tile: the [BM, ks] activation slice and the sign words are staged in
//    shared memory once per K-tile change (the TPU's sign-multiplier cache),
//    and only the [ks/32, 128] plane words are loaded per slot.  Threads run
//    along N, so those word loads coalesce; a thread unpacks one word per 32
//    K rows and reuses each {-1, 0, +1} value across its R rows, reading the
//    activations as float4 broadcasts.
//  * Arithmetic.  Exact f32 FMA (the products are exact), no tensor cores:
//    TF32 would break the parity bar.  Only the order of the f32 sums
//    differs from the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // N tile == the kneaded format's n_block
constexpr int THREADS = 256;  // 128 columns x 2 row groups
constexpr int WORD = 32;      // packed bits per word

// Shared memory of one CTA at M tile bm.  The wrapper's cta_tiles (in
// kernels/sac_matmul/kernel.py) picks bm by the same sum; a tile that did not
// fit would fail in cudaFuncSetAttribute and the wrapper would raise.
size_t smem_bytes(int bm, int bits, int ks) {
  return (size_t)((bits - 1) * bm * BN + bm * ks) * sizeof(float)
       + (size_t)2 * (ks / WORD) * BN * sizeof(uint32_t);
}

// R rows per thread; the CTA's M tile is BM = 2 * R.
template <int R>
__global__ void __launch_bounds__(THREADS)
sac_matmul_kernel(const float* __restrict__ a,          // [M, K]
                  const uint32_t* __restrict__ planes,  // [B-1, K/32, N]
                  const uint32_t* __restrict__ signs,   // [K/32, N]
                  const float* __restrict__ scale,      // [N]
                  const int32_t* __restrict__ mask,     // [N/128, num_work]
                  const int32_t* __restrict__ plane_ids,
                  const int32_t* __restrict__ ktile_ids,
                  float* __restrict__ out,              // [M, N]
                  int M, int K, int N, int bits, int ks, int num_work) {
  constexpr int BM = 2 * R;
  extern __shared__ __align__(16) float smem[];
  const int nplanes = bits - 1;
  const int kwords = ks / WORD;
  float* seg = smem;                                    // [B-1][BM][BN]
  float* s_a = seg + nplanes * BM * BN;                 // [BM][ks]
  uint32_t* s_sign = reinterpret_cast<uint32_t*>(s_a + BM * ks);  // [kw][BN]
  uint32_t* s_plane = s_sign + kwords * BN;             // [kw][BN]

  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int row0 = (tid / BN) * R;   // this thread's first row in the tile
  const int j = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const size_t ncol0 = (size_t)j * BN;

  // each thread owns seg[b][row0 .. row0+R)[col]: no barrier needed
  for (int b = 0; b < nplanes; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) seg[(b * BM + row0 + r) * BN + col] = 0.f;

  const int32_t* mrow = mask + (size_t)j * num_work;
  const int32_t* prow = plane_ids + (size_t)j * num_work;
  const int32_t* krow = ktile_ids + (size_t)j * num_work;
  const int kwords_total = K / WORD;
  int cached_kt = -1;

  for (int w = 0; w < num_work; ++w) {
    if (mrow[w] == 0) continue;                 // same for the whole CTA
    const int b = prow[w];
    const int kt = krow[w];
    __syncthreads();                            // last slot's reads are done
    if (kt != cached_kt) {
      const int ks4 = ks / 4;
      for (int i = tid; i < BM * ks4; i += THREADS) {
        const int r = i / ks4, c4 = i % ks4;
        const int row = m0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < M)
          v = reinterpret_cast<const float4*>(
              a + (size_t)row * K + (size_t)kt * ks)[c4];
        reinterpret_cast<float4*>(s_a)[i] = v;
      }
      for (int i = tid; i < kwords * BN; i += THREADS) {
        const int wd = i / BN, c = i % BN;
        s_sign[i] = signs[(size_t)(kt * kwords + wd) * N + ncol0 + c];
      }
      cached_kt = kt;
    }
    for (int i = tid; i < kwords * BN; i += THREADS) {
      const int wd = i / BN, c = i % BN;
      s_plane[i] = planes[((size_t)b * kwords_total + kt * kwords + wd) * N
                          + ncol0 + c];
    }
    __syncthreads();

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const float* arow = s_a + row0 * ks;
    for (int wd = 0; wd < kwords; ++wd) {
      const uint32_t pw = s_plane[wd * BN + col];
      const uint32_t sw = s_sign[wd * BN + col];
#pragma unroll
      for (int i = 0; i < WORD; i += 4) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float mag = (float)((pw >> (i + q)) & 1u);
          wv[q] = ((sw >> (i + q)) & 1u) ? -mag : mag;
        }
        const int k = wd * WORD + i;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(arow + r * ks + k);
          acc[r] = fmaf(av.x, wv[0], acc[r]);
          acc[r] = fmaf(av.y, wv[1], acc[r]);
          acc[r] = fmaf(av.z, wv[2], acc[r]);
          acc[r] = fmaf(av.w, wv[3], acc[r]);
        }
      }
    }
    float* sb = seg + (b * BM + row0) * BN + col;
#pragma unroll
    for (int r = 0; r < R; ++r) sb[r * BN] += acc[r];
  }

  // rear adder tree: once per output tile, also when no slot survived
  const float sc = scale[ncol0 + col];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = m0 + row0 + r;
    float total = 0.f;
    float pow2 = 1.f;
    for (int b = 0; b < nplanes; ++b) {
      total += seg[(b * BM + row0 + r) * BN + col] * pow2;
      pow2 *= 2.f;
    }
    if (row < M) out[(size_t)row * N + ncol0 + col] = total * sc;
  }
}

template <int R>
cudaError_t launch(const float* a, const uint32_t* planes,
                   const uint32_t* signs, const float* scale,
                   const int32_t* mask, const int32_t* plane_ids,
                   const int32_t* ktile_ids, float* out, int M, int K, int N,
                   int bits, int ks, int num_work, cudaStream_t stream) {
  constexpr int BM = 2 * R;
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;  // grid.y
  const size_t smem = smem_bytes(BM, bits, ks);
  cudaError_t err = cudaFuncSetAttribute(
      sac_matmul_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  sac_matmul_kernel<R><<<grid, THREADS, smem, stream>>>(
      a, planes, signs, scale, mask, plane_ids, ktile_ids, out, M, K, N,
      bits, ks, num_work);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  bm in {8, 16, 32}; N % 128 == 0, K % ks == 0, ks % 32 == 0.
int sac_matmul_launch(const void* a, const void* planes, const void* signs,
                      const void* scale, const void* mask,
                      const void* plane_ids, const void* ktile_ids,
                      void* out, int M, int K, int N, int bits, int ks,
                      int num_work, int bm, void* stream) {
  if (M <= 0 || N % BN || ks <= 0 || ks % WORD || K % ks || bits < 2 ||
      bits > 16 || num_work < 1)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the result is ours
  const auto* fa = static_cast<const float*>(a);
  const auto* up = static_cast<const uint32_t*>(planes);
  const auto* us = static_cast<const uint32_t*>(signs);
  const auto* fs = static_cast<const float*>(scale);
  const auto* im = static_cast<const int32_t*>(mask);
  const auto* ip = static_cast<const int32_t*>(plane_ids);
  const auto* ik = static_cast<const int32_t*>(ktile_ids);
  auto* fo = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 8:
      return (int)launch<4>(fa, up, us, fs, im, ip, ik, fo, M, K, N, bits,
                            ks, num_work, st);
    case 16:
      return (int)launch<8>(fa, up, us, fs, im, ip, ik, fo, M, K, N, bits,
                            ks, num_work, st);
    case 32:
      return (int)launch<16>(fa, up, us, fs, im, ip, ik, fo, M, K, N, bits,
                             ks, num_work, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sac_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
