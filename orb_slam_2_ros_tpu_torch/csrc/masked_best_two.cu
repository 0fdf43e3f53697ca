// Fused masked best-two Hamming matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel orb_slam_2_ros_tpu/ops/pallas_match.py::
// masked_best_two. For each of N query descriptors it finds the best and
// second-best of M candidate descriptors by Hamming distance, among the
// candidates that pass the gates:
//   window   |u_row - u_col| <= r_row and |v_row - v_col| <= r_row
//   octave   oct_lo_row <= oct_col <= oct_hi_row
//   stereo   |ur_row - ur_col| <= r_row where ur_col > 0
//   validity ok_row > 0 and ok_col > 0
// row_meta (8, N) f32 = [u, v, r, oct_lo, oct_hi, ur, ok, 0]
// col_meta (8, M) f32 = [u, v, oct, ur, ok, 0, 0, 0]
// Descriptors are (N, 8) / (M, 8) 32-bit words.
//
// What bounds it on this card: at the tracking path's shapes (1536 x 1536,
// about 2.4M pairs, and 4096 x 1536, about 6.3M pairs) the work is tiny
// (8 XOR + 8 popc per pair that passes the gates), so the kernel is bound
// by launch latency and by L2 traffic for the column metadata and
// descriptors (48 KB of descriptors at M = 1536, resident in the 50 MB L2).
// The Pallas kernel's bf16 +-1 planes exist only to reach the TPU's matrix
// unit; here XOR + __popc on packed words needs no unpacking.
//
// Design (simple first): one warp per query row; lane l visits columns
// l, l + 32, ...; metadata loads are coalesced across the warp, and the
// descriptor words are read only for columns that pass the gates. Each lane
// keeps its best and second-best packed keys (d << 15) | col in registers;
// a butterfly over __shfl_xor_sync merges lanes with the Pallas kernel's
// fold b1' = min(b1, c1), b2' = min(max(b1, c1), min(b2, c2)). Keys are
// unique per column, so the merge is exact and ties go to the lowest
// column, as with argmin. (N, M) is never materialised. Rows with no
// candidate decode to d = 1024 (INF_DIST of ops/hamming.py) and index 0.
// Later work: shared-memory column tiles, several rows per warp, an int8
// mma dot product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIdxBits = 15;  // M < 32768
constexpr int kInfKey = 1024 << kIdxBits;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void push(int key, int& b1, int& b2) {
  if (key < b1) {
    b2 = b1;
    b1 = key;
  } else if (key < b2) {
    b2 = key;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
masked_best_two_kernel(const int32_t* __restrict__ desc_rows,
                       const float* __restrict__ row_meta,
                       const int32_t* __restrict__ desc_cols,
                       const float* __restrict__ col_meta, int n, int m,
                       int32_t* __restrict__ best_idx,
                       int32_t* __restrict__ best_d,
                       int32_t* __restrict__ second_idx,
                       int32_t* __restrict__ second_d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together

  const float ru = row_meta[0 * n + row];
  const float rv = row_meta[1 * n + row];
  const float rr = row_meta[2 * n + row];
  const float rlo = row_meta[3 * n + row];
  const float rhi = row_meta[4 * n + row];
  const float rur = row_meta[5 * n + row];
  const bool rok = row_meta[6 * n + row] > 0.f;

  uint32_t q[8];
  const uint4* qv = reinterpret_cast<const uint4*>(desc_rows + 8 * row);
  const uint4 q0 = qv[0], q1 = qv[1];
  q[0] = q0.x; q[1] = q0.y; q[2] = q0.z; q[3] = q0.w;
  q[4] = q1.x; q[5] = q1.y; q[6] = q1.z; q[7] = q1.w;

  int b1 = kInfKey, b2 = kInfKey;
  if (rok) {
    for (int c = lane; c < m; c += 32) {
      const float cu = col_meta[0 * m + c];
      const float cv = col_meta[1 * m + c];
      const float co = col_meta[2 * m + c];
      const float cur = col_meta[3 * m + c];
      const bool cok = col_meta[4 * m + c] > 0.f;
      const bool ok = cok && fabsf(ru - cu) <= rr && fabsf(rv - cv) <= rr &&
                      co >= rlo && co <= rhi &&
                      (cur <= 0.f || fabsf(rur - cur) <= rr);
      if (!ok) continue;
      const uint4* cvp = reinterpret_cast<const uint4*>(desc_cols + 8 * c);
      const uint4 c0 = cvp[0], c1 = cvp[1];
      const int d = __popc(q[0] ^ c0.x) + __popc(q[1] ^ c0.y) +
                    __popc(q[2] ^ c0.z) + __popc(q[3] ^ c0.w) +
                    __popc(q[4] ^ c1.x) + __popc(q[5] ^ c1.y) +
                    __popc(q[6] ^ c1.z) + __popc(q[7] ^ c1.w);
      push((d << kIdxBits) | c, b1, b2);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int c1 = __shfl_xor_sync(0xffffffffu, b1, off);
    const int c2 = __shfl_xor_sync(0xffffffffu, b2, off);
    const int nb1 = min(b1, c1);
    b2 = min(max(b1, c1), min(b2, c2));
    b1 = nb1;
  }

  if (lane == 0) {
    const int mask = (1 << kIdxBits) - 1;
    best_idx[row] = b1 & mask;
    best_d[row] = b1 >> kIdxBits;
    second_idx[row] = b2 & mask;
    second_d[row] = b2 >> kIdxBits;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() (0 = success).
extern "C" int masked_best_two_launch(const int32_t* desc_rows,
                                      const float* row_meta,
                                      const int32_t* desc_cols,
                                      const float* col_meta, int n, int m,
                                      int32_t* best_idx, int32_t* best_d,
                                      int32_t* second_idx, int32_t* second_d,
                                      void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    masked_best_two_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        desc_rows, row_meta, desc_cols, col_meta, n, m, best_idx, best_d,
        second_idx, second_d);
  }
  return static_cast<int>(cudaGetLastError());
}
