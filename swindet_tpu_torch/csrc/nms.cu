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
// kernel carried its kept buffer across a sequential grid of 128-box tiles.
// Design, two kernels behind one entry point:
//  (a) nms_mask_kernel, parallel over (column block, row block, image) of
//      64 boxes each, upper triangle only: one thread per row box i writes
//      one 64-bit word of "IoU(i, j) > thr" for the 64 boxes j > i of the
//      column block, staged in shared memory. N x ceil(N / 64) words per
//      image (9.8 MB at N = 8,819) in place of an N x N IoU matrix.
//  (b) nms_scan_kernel, one block per image: a bitset of removed boxes in
//      shared memory (invalid boxes start removed), a sequential loop over
//      the sorted boxes that skips removed ones, and for each kept box the
//      block ORs its mask row into the bitset, one word per thread. Only
//      kept boxes (at most max_out) cost a barrier and a read of device
//      memory.
// The IoU rounds as the plain version's elementwise torch ops do, one
// rounding per operation (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn; no
// contraction into fused multiply-adds), so the keep set is the same bit
// for bit, also for class-offset boxes at coordinates of 1e4-1e5.
#include "common.cuh"

namespace swindet {

constexpr int kNmsBlock = 64;     // boxes per mask word and per block side
constexpr int kScanThreads = 256;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

// pairwise_iou of ops/nms.py for a = box i, b = box j:
//   inter / max((area_a + area_b) - inter, 1e-10)
__device__ __forceinline__ float box_iou(const float* a, const float* b) {
  const float area_a = box_area(a[0], a[1], a[2], a[3]);
  const float area_b = box_area(b[0], b[1], b[2], b[3]);
  const float w =
      fmaxf(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 0.f);
  const float h =
      fmaxf(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-10f));
}

__global__ void __launch_bounds__(kNmsBlock)
nms_mask_kernel(const float* __restrict__ boxes,
                unsigned long long* __restrict__ mask, int n, float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;  // the scan reads words at or after a box's own
  const int words = (n + kNmsBlock - 1) / kNmsBlock;
  boxes += (int64_t)blockIdx.z * n * 4;
  mask += (int64_t)blockIdx.z * n * words;
  __shared__ float cols[kNmsBlock * 4];
  const int j0 = cb * kNmsBlock;
  const int ncol = min(kNmsBlock, n - j0);
  for (int t = threadIdx.x; t < ncol * 4; t += kNmsBlock)
    cols[t] = boxes[(int64_t)j0 * 4 + t];
  __syncthreads();
  const int i = rb * kNmsBlock + threadIdx.x;
  if (i >= n) return;
  float row[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) row[t] = boxes[(int64_t)i * 4 + t];
  unsigned long long bits = 0;
  for (int k = cb == rb ? threadIdx.x + 1 : 0; k < ncol; ++k)
    if (box_iou(row, cols + k * 4) > thr) bits |= 1ull << k;
  mask[(int64_t)i * words + cb] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ boxes,
                const float* __restrict__ score,
                const uint8_t* __restrict__ valid,
                const int64_t* __restrict__ order,
                const unsigned long long* __restrict__ mask,
                float* __restrict__ dets, int64_t* __restrict__ inds,
                int64_t* __restrict__ count, int n, int max_out) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int words = (n + kNmsBlock - 1) / kNmsBlock;
  boxes += (int64_t)b * n * 4;
  score += (int64_t)b * n;
  valid += (int64_t)b * n;
  order += (int64_t)b * n;
  mask += (int64_t)b * n * words;
  dets += (int64_t)b * max_out * 5;
  inds += (int64_t)b * max_out;
  for (int w = tid; w < words; w += kScanThreads) {
    unsigned long long bits = 0;
    for (int k = 0; k < kNmsBlock; ++k) {
      const int j = w * kNmsBlock + k;
      if (j >= n || !valid[j]) bits |= 1ull << k;
    }
    removed[w] = bits;
  }
  __syncthreads();
  int kept = 0;
  for (int i = 0; i < n && kept < max_out; ++i) {
    const int w = i / kNmsBlock;
    // every thread reads the same word: the decision is uniform
    if ((removed[w] >> (i % kNmsBlock)) & 1ull) continue;
    if (tid == 0) {
#pragma unroll
      for (int t = 0; t < 4; ++t) dets[kept * 5 + t] = boxes[(int64_t)i * 4 + t];
      dets[kept * 5 + 4] = score[i];
      inds[kept] = order[i];
    }
    // row i holds only boxes after i, so a thread that ORs word w here
    // cannot change bit i for a thread still reading it
    const unsigned long long* row = mask + (int64_t)i * words;
    for (int v = w + tid; v < words; v += kScanThreads) removed[v] |= row[v];
    ++kept;
    __syncthreads();
  }
  for (int s = kept + tid; s < max_out; s += kScanThreads) {
#pragma unroll
    for (int t = 0; t < 5; ++t) dets[s * 5 + t] = 0.f;
    inds[s] = 0;
  }
  if (tid == 0) count[b] = kept;
}

}  // namespace swindet

// boxes (B, N, 4) fp32, score (B, N) fp32, valid (B, N) bool, order (B, N)
// int64, all sorted by score; mask (B, N, ceil(N / 64)) scratch; outputs
// dets (B, max_out, 5) fp32, inds (B, max_out) int64, count (B,) int64.
SWINDET_EXPORT int swindet_nms_sorted(
    const float* boxes, const float* score, const uint8_t* valid,
    const int64_t* order, unsigned long long* mask, float* dets,
    int64_t* inds, int64_t* count, int batch, int n, int max_out, float thr,
    cudaStream_t stream) {
  using namespace swindet;
  if (batch <= 0) return cudaGetLastError();
  const int words = (n + kNmsBlock - 1) / kNmsBlock;
  if (n > 0) {
    dim3 grid(words, words, batch);
    nms_mask_kernel<<<grid, kNmsBlock, 0, stream>>>(boxes, mask, n, thr);
  }
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  nms_scan_kernel<<<batch, kScanThreads, smem, stream>>>(
      boxes, score, valid, order, mask, dets, inds, count, n, max_out);
  return cudaGetLastError();
}
