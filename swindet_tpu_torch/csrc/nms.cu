// Greedy NMS over boxes already sorted by score, batched over images:
//   keep box i (in score order) if it is valid and no kept box j < i has
//   IoU(j, i) > thr; stop once max_out boxes are kept. The kept boxes and
//   scores go to dets[0 .. count) in score order, their indices into the
//   unsorted inputs (order[i]) to inds, the rest of the slots are zero.
//
// Replaces: swindet_tpu/ops/nms_pallas.py · _kernel (via nms_pallas_sorted,
// pallas_call at :146). The port runs it as the main-path NMS: RPN
// proposals (batched_nms; 4,819 candidates when serving, 8,819 per image in
// a training step, IoU 0.7, 1,000 kept) and the bbox head's multiclass_nms
// (2,048 candidates, IoU 0.5, 100 kept).
//
// Bound: neither bytes nor operations but the scan's chain of dependent
// steps: whether box i is kept depends on every earlier decision. The TPU
// kernel walked 128-box tiles on one core, suppressing each against its
// kept buffer; on the card one block per image would put every IoU of the
// kept boxes (about 8.8 M at N = 8,819) on one SM of 132. So the IoUs are
// spread over the card as a bitmask, and the chain is the scan over it.
// Design, two kernels behind one entry point:
//  (a) nms_mask_kernel: "IoU(i, j) > thr" for every pair j > i, as one
//      64-bit word per box i and 64-box column block, N x ceil(N / 64)
//      words per image (9.8 MB at N = 8,819) in place of an N x N IoU
//      matrix. A triangular grid of (row block, column block) pairs, 64
//      threads each, one per row box: no block of the lower triangle is
//      launched, and a pair that does not intersect skips the division
//      (0 / max(union, 1e-10) is 0, so the comparison is decided without
//      it, exactly). The diagonal blocks also write the word of invalid
//      boxes of their block (and of those past N), in an extra row N.
//  (b) nms_scan_kernel, one block per image, chains one step per 64-box
//      column block rather than one per kept box: a step per kept box
//      would pass a barrier and wait for a read of its mask row 1,000
//      times, one after the other. A bitset of removed boxes
//      lives in shared memory. At step cb its word cb is final: every kept
//      box of an earlier block has ORed its row into it. One thread
//      resolves the block's 64 boxes against that word, the invalid word
//      and the block's diagonal words, which cp.async brought into shared
//      memory during the step before: it jumps from one surviving box to
//      the next (__ffsll), keeps it and ORs its diagonal word in, so the
//      loop runs once per kept box, a shared-memory load each, and stops
//      at max_out. (A warp holding the diagonal words in registers would
//      need a shuffle per step, as slow as the load, and 64 steps a block
//      however few boxes survive.) Then the whole block ORs the kept
//      boxes' rows, from word cb + 1 on, into the bitset, several threads
//      a word where the words are few (shared 64-bit atomicOr), while the
//      next block's diagonal and invalid words come in, and writes the
//      kept boxes' dets and inds in parallel: two barriers a block.
//      The scan ends at max_out, so the chain is as many steps as the
//      blocks that hold the first max_out kept boxes (about 17 of 138 at
//      N = 8,819 with 1,000 kept).
// The IoU rounds as the plain version's elementwise torch ops do, one
// rounding per operation (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn; no
// contraction into fused multiply-adds), so the keep set is the same bit
// for bit, also for class-offset boxes at coordinates of 1e4-1e5.
#include "sm90.cuh"

namespace swindet {

constexpr int kNmsBlock = 64;      // boxes per mask word and per block side
constexpr int kScanThreads = 1024;
// shared memory of the scan past its removed bitset, in 64-bit words: two
// buffers of a block's 64 diagonal words and its invalid word, then the
// block's kept boxes (64 ints) and their count
constexpr int kPre = kNmsBlock + 1;
constexpr int kScanExtraWords = 2 * kPre + (kNmsBlock + 2) / 2;

typedef unsigned long long u64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

// pairwise_iou of ops/nms.py for a = box i, b = box j (x1, y1, x2, y2,
// area), compared with thr: inter / max((area_a + area_b) - inter, 1e-10)
// > thr, with the division only where the boxes intersect
__device__ __forceinline__ bool iou_over(const float4& a, float area_a,
                                         const float* b, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b[2]), fmaxf(a.x, b[0])), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b[3]), fmaxf(a.y, b[1])), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f > thr;
  const float uni = __fsub_rn(__fadd_rn(area_a, b[4]), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-10f)) > thr;
}

// Block (blockIdx.x, image blockIdx.y): the pairs (rb, cb) of the upper
// triangle run column by column, column cb holding row blocks 0 .. cb.
__global__ void __launch_bounds__(kNmsBlock)
nms_mask_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                int n, int words, float thr) {
  const long long at = blockIdx.x;
  int cb = (int)((sqrt(8.0 * (double)at + 1.0) - 1.0) / 2.0);
  while ((long long)cb * (cb + 1) / 2 > at) --cb;
  while ((long long)(cb + 1) * (cb + 2) / 2 <= at) ++cb;
  const int rb = (int)(at - (long long)cb * (cb + 1) / 2);
  boxes += (int64_t)blockIdx.y * n * 4;
  valid += (int64_t)blockIdx.y * n;
  mask += (int64_t)blockIdx.y * (n + 1) * words;
  const float4* box4 = reinterpret_cast<const float4*>(boxes);

  __shared__ float cols[kNmsBlock * 5];
  const int tid = threadIdx.x;
  const int j0 = cb * kNmsBlock;
  const int ncol = min(kNmsBlock, n - j0);
  if (tid < ncol) {
    const float4 b = box4[j0 + tid];
    cols[5 * tid] = b.x;
    cols[5 * tid + 1] = b.y;
    cols[5 * tid + 2] = b.z;
    cols[5 * tid + 3] = b.w;
    cols[5 * tid + 4] = box_area(b.x, b.y, b.z, b.w);
  }
  __syncthreads();
  const int i = rb * kNmsBlock + tid;
  if (rb == cb) {
    // the block's invalid boxes and those past n, which the scan starts
    // removed: row n, 32 bits a warp
    const unsigned bad = __ballot_sync(0xffffffffu, i >= n || !valid[i]);
    if ((tid & 31) == 0)
      reinterpret_cast<uint32_t*>(mask + (int64_t)n * words + cb)[tid >> 5] =
          bad;
  }
  if (i >= n) return;
  const float4 a = box4[i];
  const float area_a = box_area(a.x, a.y, a.z, a.w);
  u64 bits = 0;
  for (int k = cb == rb ? tid + 1 : 0; k < ncol; ++k)
    if (iou_over(a, area_a, cols + 5 * k, thr)) bits |= 1ull << k;
  mask[(int64_t)i * words + cb] = bits;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ boxes,
                const float* __restrict__ score,
                const int64_t* __restrict__ order,
                const u64* __restrict__ mask, float* __restrict__ dets,
                int64_t* __restrict__ inds, int64_t* __restrict__ count,
                int n, int max_out) {
  extern __shared__ u64 scan_smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int words = (n + kNmsBlock - 1) / kNmsBlock;
  u64* removed = scan_smem;
  u64* pre = removed + words;  // two buffers of kPre words
  int* list = reinterpret_cast<int*>(pre + 2 * kPre);
  int* list_len = list + kNmsBlock;
  boxes += (int64_t)b * n * 4;
  score += (int64_t)b * n;
  order += (int64_t)b * n;
  mask += (int64_t)b * (n + 1) * words;
  dets += (int64_t)b * max_out * 5;
  inds += (int64_t)b * max_out;

  // block cb's diagonal words mask[64 cb + l][cb] and its invalid word
  // into buffer buf, by threads 32 .. 96 (not the resolving warp)
  auto prefetch = [&](int cb, int buf) {
    const int l = tid - 32;
    const int row = l < kNmsBlock ? cb * kNmsBlock + l : n;
    if (l >= 0 && (l == kNmsBlock || row < n))
      cp_async8(pre + buf * kPre + l, mask + (int64_t)row * words + cb);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int w = tid; w < words; w += kScanThreads) removed[w] = 0;
  if (words) prefetch(0, 0);

  int kept = 0;
  for (int cb = 0; cb < words && kept < max_out; ++cb) {
    const int buf = cb & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // block cb's words are in, removed[cb] is final, and the last step's
    // readers of list are done
    __syncthreads();
    if (tid == 0) {
      const u64* d = pre + buf * kPre;
      u64 rem = removed[cb] | d[kNmsBlock];
      u64 cand = ~rem;
      int nk = 0;
      while (cand && kept + nk < max_out) {
        const int k = __ffsll((long long)cand) - 1;
        list[nk++] = k;
        rem |= d[k];  // bits of boxes after k only
        cand = ~rem & ((~0ull << k) << 1);
      }
      *list_len = nk;
    }
    if (cb + 1 < words) prefetch(cb + 1, buf ^ 1);
    __syncthreads();
    const int nk = *list_len;
    // the kept boxes' dets and inds, by the last threads
    const int slot = kScanThreads - 1 - tid;
    if (slot < nk) {
      const int i = cb * kNmsBlock + list[slot];
      const float4 bx = reinterpret_cast<const float4*>(boxes)[i];
      float* out = dets + (int64_t)(kept + slot) * 5;
      out[0] = bx.x;
      out[1] = bx.y;
      out[2] = bx.z;
      out[3] = bx.w;
      out[4] = score[i];
      inds[kept + slot] = order[i];
    }
    // the kept boxes' rows into the words after cb, `parts` threads a word
    const int rest = words - cb - 1;
    if (nk && rest > 0) {
      const int parts = max(1, min(nk, kScanThreads / rest));
      const u64* rows = mask + (int64_t)cb * kNmsBlock * words;
      for (int e = tid; e < rest * parts; e += kScanThreads) {
        const int v = cb + 1 + e % rest;
        u64 acc = 0;
#pragma unroll 4
        for (int k = e / rest; k < nk; k += parts)
          acc |= rows[(int64_t)list[k] * words + v];
        if (acc) atomicOr(removed + v, acc);
      }
    }
    kept += nk;
  }
  // a step that ended the scan may have left the next block's copies in
  // flight
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  for (int s = kept + tid; s < max_out; s += kScanThreads) {
#pragma unroll
    for (int t = 0; t < 5; ++t) dets[s * 5 + t] = 0.f;
    inds[s] = 0;
  }
  if (tid == 0) count[b] = kept;
}

}  // namespace swindet

// boxes (B, N, 4) fp32, score (B, N) fp32, valid (B, N) bool, order (B, N)
// int64, all sorted by score; mask (B, N + 1, ceil(N / 64)) scratch;
// outputs dets (B, max_out, 5) fp32, inds (B, max_out) int64, count (B,)
// int64.
SWINDET_EXPORT int swindet_nms_sorted(
    const float* boxes, const float* score, const uint8_t* valid,
    const int64_t* order, unsigned long long* mask, float* dets,
    int64_t* inds, int64_t* count, int batch, int n, int max_out, float thr,
    cudaStream_t stream) {
  using namespace swindet;
  if (batch <= 0) return cudaGetLastError();
  const int words = (n + kNmsBlock - 1) / kNmsBlock;
  if (n > 0) {
    dim3 grid((unsigned)((long long)words * (words + 1) / 2), batch);
    nms_mask_kernel<<<grid, kNmsBlock, 0, stream>>>(boxes, valid, mask, n,
                                                     words, thr);
  }
  const size_t smem = sizeof(u64) * ((size_t)words + kScanExtraWords);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  nms_scan_kernel<<<batch, kScanThreads, smem, stream>>>(
      boxes, score, order, mask, dets, inds, count, n, max_out);
  return cudaGetLastError();
}
