// A block-wide SIMT tile product shared by the fused MLP and the fused
// window-attention kernels: 256 threads, each owning a TM x TN micro tile
// of a BM x BN block tile, with K staged through shared memory kKS deep.
// Operands come from functors that return fp32 (zero outside the matrix),
// so one code path serves fp32 and bf16 inputs: bf16 x bf16 products are
// exact in fp32.
#pragma once

#include "common.cuh"

namespace swindet {

constexpr int kGemmThreads = 256;
constexpr int kKS = 16;                // depth of one K slice in shared memory
constexpr int kStage = kKS * (64 + 1);  // floats of one staged operand slice

// This thread's micro tile of a BM x BN block tile: rows tm .. tm+TM-1,
// columns tn .. tn+TN-1.
template <int BM, int BN, int TM, int TN>
struct Micro {
  static_assert((BM / TM) * (BN / TN) == kGemmThreads, "one tile per thread");
  int tm, tn;
  __device__ Micro()
      : tm((threadIdx.x / (BN / TN)) * TM),
        tn((threadIdx.x % (BN / TN)) * TN) {}
};

// acc[i][j] += sum_{k < K} A(tm + i, k) * B(tn + j, k) for this thread's
// micro tile. fa(m, k) and fb(n, k) return the operands as fp32 (zero
// outside the matrices); K is staged through As and Bs (kStage floats
// each) in slices of kKS. With A_MFAST, neighbouring threads load
// neighbouring m of one k (a source that is contiguous along m);
// otherwise neighbouring k of one m. The same for B.
template <int BM, int BN, int TM, int TN, bool A_MFAST, bool B_MFAST,
          typename FA, typename FB>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM][TN], int K,
                                          FA fa, FB fb, float* As,
                                          float* Bs) {
  const Micro<BM, BN, TM, TN> mt;
  for (int k0 = 0; k0 < K; k0 += kKS) {
    for (int e = threadIdx.x; e < BM * kKS; e += kGemmThreads) {
      const int m = A_MFAST ? e % BM : e / kKS;
      const int k = A_MFAST ? e / BM : e % kKS;
      As[k * (BM + 1) + m] = k0 + k < K ? fa(m, k0 + k) : 0.f;
    }
    for (int e = threadIdx.x; e < BN * kKS; e += kGemmThreads) {
      const int n = B_MFAST ? e % BN : e / kKS;
      const int k = B_MFAST ? e / BN : e % kKS;
      Bs[k * (BN + 1) + n] = k0 + k < K ? fb(n, k0 + k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKS; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k * (BM + 1) + mt.tm + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k * (BN + 1) + mt.tn + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace swindet
