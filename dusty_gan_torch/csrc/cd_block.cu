// Pairwise symmetric Chamfer block for Hopper (sm_90a).
//
// Replaces dusty_gan_tpu/metrics/chamfer_pallas.py::cd_block_pallas
// (kernel body _cd_block_kernel).  For an (R, N, 3) stack of row clouds and
// a (C, M, 3) stack of column clouds it writes the (R, C) block
//
//     out[i, j] = mean_n min_m |x_in - y_jm|^2 + mean_m min_n |x_in - y_jm|^2
//
// with squared distances formed from explicit coordinate differences (not
// x^2 + y^2 - 2xy, which cancels badly for nearby points).
//
// What bounds it: FP32 arithmetic outside the tensor cores.  One distance is
// 3 subtractions, 1 multiply, 2 fused multiply-adds and 1 min, about 8 FLOPs,
// and a pair needs at least N*M distances; at N = M = 2048 that is ~33.6
// MFLOP, ~0.50 us per pair at the published 67 TFLOP/s.  The bytes are
// negligible: each cloud is 24 KB and is reused N or M times.
//
// What the design does about it:
//   * one thread block per (row, col) pair; a (16, 512) block is 8192
//     blocks, enough to fill every SM many times over;
//   * the partner cloud is staged in shared memory as SoA in chunks of
//     kChunk points, so any N and M work and every thread reads the same
//     partner point at once (a broadcast, no bank conflicts);
//   * each thread keeps kQPT query points and their running minima in
//     registers, so one shared-memory read of a partner point feeds kQPT
//     distances;
//   * loops are bounded by the true N and M: no padding, no sentinels;
//   * both directions run in the same block (two one-way passes, 2*N*M
//     distances), the per-thread sums are reduced with warp shuffles and
//     the block writes its one scalar directly.
// A single-pass bidirectional form and tensor-core formulations are left
// for later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQPT = 8;        // query points held in registers per thread
constexpr int kChunk = 2048;   // partner points staged per shared-memory pass

// Sum over the query cloud a (na points) of the squared distance to its
// nearest point in cloud b (nb points).  Every thread returns its partial
// sum; the caller reduces across the block.
__device__ float one_way_sum(const float* __restrict__ a, int na,
                             const float* __restrict__ b, int nb,
                             float* sx, float* sy, float* sz) {
  float acc = 0.f;
  for (int q0 = 0; q0 < na; q0 += kThreads * kQPT) {
    float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT];
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      const int q = q0 + k * kThreads + threadIdx.x;
      const bool ok = q < na;
      qx[k] = ok ? a[3 * q + 0] : 0.f;
      qy[k] = ok ? a[3 * q + 1] : 0.f;
      qz[k] = ok ? a[3 * q + 2] : 0.f;
      best[k] = CUDART_INF_F;
    }
    for (int p0 = 0; p0 < nb; p0 += kChunk) {
      const int np = min(kChunk, nb - p0);
      __syncthreads();  // the previous chunk is no longer being read
      for (int t = threadIdx.x; t < np; t += kThreads) {
        const float* p = b + 3 * (p0 + t);
        sx[t] = p[0];
        sy[t] = p[1];
        sz[t] = p[2];
      }
      __syncthreads();
      for (int t = 0; t < np; ++t) {
        const float px = sx[t], py = sy[t], pz = sz[t];
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          const float dx = qx[k] - px;
          const float dy = qy[k] - py;
          const float dz = qz[k] - pz;
          const float d = dx * dx + dy * dy + dz * dz;
          best[k] = fminf(best[k], d);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      if (q0 + k * kThreads + threadIdx.x < na) acc += best[k];
    }
  }
  return acc;
}

__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
cd_block_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                float* __restrict__ out, int C, int N, int M) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  __shared__ float scratch[kThreads / 32];
  const int j = blockIdx.x;  // column cloud
  const int i = blockIdx.y;  // row cloud
  const float* x = rows + (size_t)i * N * 3;
  const float* y = cols + (size_t)j * M * 3;
  const float s1 = block_sum(one_way_sum(x, N, y, M, sx, sy, sz), scratch);
  const float s2 = block_sum(one_way_sum(y, M, x, N, sx, sy, sz), scratch);
  if (threadIdx.x == 0) out[(size_t)i * C + j] = s1 / (float)N + s2 / (float)M;
}

}  // namespace

extern "C" {

// rows (R, N, 3), cols (C, M, 3), out (R, C): contiguous float32 on the
// current device.  Launches on `stream` and returns cudaGetLastError().
int cd_block_launch(const float* rows, const float* cols, float* out, int R,
                    int C, int N, int M, void* stream) {
  const dim3 grid(C, R);
  cd_block_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, cols, out, C, N, M);
  return static_cast<int>(cudaGetLastError());
}

const char* cd_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
