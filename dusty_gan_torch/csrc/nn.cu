// Batched one-way nearest neighbour for Hopper (sm_90a): kernels K2 and K3.
//
// Replaces dusty_gan_tpu/metrics/chamfer_pallas.py::nn_pallas, both of its
// kernel bodies: _nn_kernel_dist_only (need_idx=False, K2) and _nn_kernel
// (need_idx=True, K3).  For query clouds x (B, N, 3) and partner clouds
// y (B, M, 3), matched 1:1 by batch index, it writes
//
//     dist[b, n] = max(0, min_m |x_bn - y_bm|^2)               (both)
//     idx[b, n]  = the smallest m that reaches that minimum      (K3 only)
//
// with squared distances formed from explicit coordinate differences (not
// x^2 + y^2 - 2xy, which cancels badly for nearby points).
//
// Argmin rule: the TPU kernel takes the first index within a tile and keeps
// the earlier tile (and the earlier 4096-point M chunk) on a tie, i.e. the
// first occurrence of the minimum.  Here every thread scans its partner
// cloud in increasing m and replaces its best only on a strict d < best,
// which is the same rule.  Reconstruction clouds hold thousands of dropped
// points exactly at the origin, so exact ties are common there.
//
// What bounds it: FP32 arithmetic outside the tensor cores.  One distance is
// 3 subtractions, 1 multiply, 2 fused multiply-adds and 1 min (K3: a
// compare and two selects instead of the min), about 8 FLOPs.  At the
// reconstruction shape, B = 512 and N = M = 16,384, one launch computes
// 1.37e11 distances: ~16.4 ms at the published 67 TFLOP/s.  The bytes are
// ~130 MB (~0.04 ms at 3.35 TB/s): each partner point is reused N times.
//
// What the design does about it (the shape of cd_block.cu):
//   * grid (query tiles, B): a 16,384-point query cloud is split over
//     several blocks; the launcher picks the query points per thread
//     (kQPT in 8/4/2/1) so that even a small batch (a CLI run with a small
//     --batch-size, the demo's few scans) gives at least one block per SM
//     of the current device, and a batch of 512 keeps 8 points per thread;
//   * the partner cloud is staged in shared memory as SoA in chunks of
//     kChunk points, so any N and M work and every thread of a block reads
//     the same partner point at once (a broadcast, no bank conflicts);
//   * each thread keeps kQPT query points and their running minima (and
//     indices) in registers, so one shared-memory read feeds kQPT distances;
//   * loops are bounded by the true N and M: no padding, no sentinels;
//   * each query point writes its own result; there is no reduction.
// A bidirectional pass (one distance evaluation for both directions) and a
// tensor-core formulation are left for later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;  // partner points staged per shared-memory pass

template <int kQPT, bool kIdx>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
          float* __restrict__ dist, int* __restrict__ idx, int N, int M) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * (kThreads * kQPT);
  const float* xb = x + (size_t)b * N * 3;
  const float* yb = y + (size_t)b * M * 3;

  float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT];
  int bidx[kQPT];
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int q = q0 + k * kThreads + threadIdx.x;
    const bool ok = q < N;
    qx[k] = ok ? xb[3 * q + 0] : 0.f;
    qy[k] = ok ? xb[3 * q + 1] : 0.f;
    qz[k] = ok ? xb[3 * q + 2] : 0.f;
    best[k] = CUDART_INF_F;
    bidx[k] = 0;
  }

  for (int p0 = 0; p0 < M; p0 += kChunk) {
    const int np = min(kChunk, M - p0);
    __syncthreads();  // the previous chunk is no longer being read
    for (int t = threadIdx.x; t < np; t += kThreads) {
      const float* p = yb + 3 * (p0 + t);
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
        if (kIdx) {
          if (d < best[k]) {  // strict: the first occurrence wins
            best[k] = d;
            bidx[k] = p0 + t;
          }
        } else {
          best[k] = fminf(best[k], d);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int q = q0 + k * kThreads + threadIdx.x;
    if (q < N) {
      dist[(size_t)b * N + q] = fmaxf(best[k], 0.f);
      if (kIdx) idx[(size_t)b * N + q] = bidx[k];
    }
  }
}

// Query points per thread: 8 unless that leaves fewer blocks than the
// current device has SMs.
int points_per_thread(int B, int N) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int qpt = 8; qpt > 1; qpt >>= 1) {
    const long long tiles = (N + kThreads * qpt - 1) / (kThreads * qpt);
    if (tiles * B >= sms) return qpt;
  }
  return 1;
}

template <int kQPT, bool kIdx>
void launch(const float* x, const float* y, float* dist, int* idx, int B,
            int N, int M, cudaStream_t stream) {
  const dim3 grid((N + kThreads * kQPT - 1) / (kThreads * kQPT), B);
  nn_kernel<kQPT, kIdx><<<grid, kThreads, 0, stream>>>(x, y, dist, idx, N, M);
}

template <bool kIdx>
int nn_launch(const float* x, const float* y, float* dist, int* idx, int B,
              int N, int M, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (points_per_thread(B, N)) {
    case 8: launch<8, kIdx>(x, y, dist, idx, B, N, M, stream); break;
    case 4: launch<4, kIdx>(x, y, dist, idx, B, N, M, stream); break;
    case 2: launch<2, kIdx>(x, y, dist, idx, B, N, M, stream); break;
    default: launch<1, kIdx>(x, y, dist, idx, B, N, M, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, N, 3), y (B, M, 3), dist (B, N): contiguous float32 on the current
// device.  Launches on `stream` and returns cudaGetLastError().
int nn_dist_launch(const float* x, const float* y, float* dist, int B, int N,
                   int M, void* stream) {
  return nn_launch<false>(x, y, dist, nullptr, B, N, M, stream);
}

// As nn_dist_launch, plus idx (B, N) int32: the first index of the minimum.
int nn_argmin_launch(const float* x, const float* y, float* dist, int* idx,
                     int B, int N, int M, void* stream) {
  return nn_launch<true>(x, y, dist, idx, B, N, M, stream);
}

// The query points per thread (the kernel instantiation) that a launch of
// B clouds of N query points takes on the current device.
int nn_points_per_thread(int B, int N) { return points_per_thread(B, N); }

const char* nn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
