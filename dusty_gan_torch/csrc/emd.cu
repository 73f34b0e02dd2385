// Approximate earth mover's distance by the annealed auction, for Hopper
// (sm_90a): kernels K4 and K5.
//
// Replaces dusty_gan_tpu/metrics/emd_pallas.py, both of its kernel bodies
// over the shared auction _run_auction:
//   * emd_block_launch: _emd_block_kernel (emd_block_pallas, K4), the (R, C)
//     block of costs of R row clouds (N points) against C column clouds
//     (M points);
//   * emd_pair_launch: _emd_pair_kernel (emd_pair_pallas, K5), B pairs
//     matched 1:1, emitting the residues from which the cost and both
//     gradients are elementwise: R[n] = sum_m match, C[m] = sum_n match,
//     V[n] = sum_m match * y[m] and U[m] = sum_n match * x[n].
//
// The auction (dusty_gan_tpu/metrics/emd.py::approx_match) for one pair,
// with d[n,m] = |x_n - y_m|^2 from explicit coordinate differences:
//   masses: multi_l = 1, multi_r = N / M (integer division) when N >= M,
//           else multi_l = M / N, multi_r = 1;
//   rounds i = 0..9 at level -4^(7-i), and 0 at i = 9, with w = exp(level*d):
//     1. ratio_l[n] = remain_l[n] / (1e-9 + sum_m w * remain_r[m]);
//     2. s[m] = sum_n w * ratio_l[n], sumr = s * remain_r[m],
//        ratio_r[m] = min(remain_r / (sumr + 1e-9), 1) * remain_r,
//        remain_r[m] = max(0, remain_r - sumr);
//     3. match += w * ratio_l[n] * ratio_r[m],
//        remain_l[n] = max(0, remain_l - sum_m of that round's match).
// The match is never formed: its row mass R, column mass C, and V (and U)
// are accumulated per round, and
//   cost = sum_n |x_n|^2 R[n] + sum_m |y_m|^2 C[m] - 2 sum_n x_n . V[n].
//
// What bounds it: FP32 arithmetic and exp outside the tensor cores.  Rounds
// 0-8 need, per distance, one exp and about 21 FLOPs (d 8, level*d 1, the
// row sum 2, the column sum 2, the match mass 2, V 6; K5 adds 6 for U);
// round 9 (w = 1) is O(N + M).  At N = M = 2048 that is 0.79 GFLOP a pair,
// 11.8 us at the published 67 TFLOP/s; the bytes (two 24 KB clouds in, one
// float out) are negligible.
//
// What the design does about it (a first kernel, simple and right):
//   * one thread block of 1024 threads per pair, with the whole auction
//     state in dynamic shared memory: the clouds as float4 (x, y, z, a
//     per-point weight), remain_l, R, V (N each), remain_r, C (and U)
//     (M each); so the only device-memory traffic is the two clouds in and
//     the results out;
//   * each round is three sweeps over the (N, M) distances separated by
//     __syncthreads(): a row sweep (a thread per row, looping over m), a
//     column sweep (a thread per column, looping over n) and a second row
//     sweep; each recomputes d and w from the shared clouds, and each
//     thread holds two rows (or columns) in registers so that one broadcast
//     shared-memory read feeds two distances;
//   * the weight a sweep multiplies w by (remain_r, ratio_l or ratio_r)
//     sits in the fourth lane of the partner's float4, one 16-byte read;
//   * round 9 has w = 1 and is vector math with block reductions;
//   * every sum has a fixed order (one thread per row or column, and a
//     fixed-shape block reduction; no atomics), so the same inputs give the
//     same bits on every launch.
// The TPU kernel fuses round i-1's third sweep into round i's first and
// takes the column sum in the same pass; those fusions, fewer exp
// evaluations and tensor cores are left for later work.
//
// Limits: N and M at most kMaxPoints (3072), so that K5's state fits the
// 227 KB of shared memory a block may use; any N and M up to it, not only
// multiples of anything.  metrics/emd_cuda.py's MAX_POINTS states the same
// limit to callers; a launch beyond it returns cudaErrorInvalidValue.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoints = 3072;
constexpr int kMaxReduce = 4;  // values reduced together across the block
// level of rounds 0..8: -4^7 .. -4^-1, exact powers of 4 (round 9 is 0)
__constant__ float kLevels[9] = {-16384.f, -4096.f, -1024.f, -256.f, -64.f,
                                 -16.f,    -4.f,    -1.f,    -0.25f};

struct State {
  float4* xw;  // (N) x0, x1, x2 and the row weight ratio_l
  float4* yw;  // (M) y0, y1, y2 and the column weight of the next row sweep
  float *remain_l, *R, *V0, *V1, *V2;  // (N)
  float *remain_r, *C;                 // (M)
  float *U0, *U1, *U2;                 // (M), K5 only
  float* red;                          // (kMaxReduce * kWarps)
};

size_t shared_bytes(int N, int M, bool with_u) {
  return sizeof(float) * ((4 + 5) * (size_t)N + (4 + 2 + (with_u ? 3 : 0)) * (size_t)M +
                          kMaxReduce * kWarps);
}

__device__ State carve(float* smem, int N, int M, bool with_u) {
  State s;
  s.xw = reinterpret_cast<float4*>(smem);
  s.yw = reinterpret_cast<float4*>(smem + 4 * N);
  float* p = smem + 4 * N + 4 * M;
  s.remain_l = p; p += N;
  s.R = p; p += N;
  s.V0 = p; p += N;
  s.V1 = p; p += N;
  s.V2 = p; p += N;
  s.remain_r = p; p += M;
  s.C = p; p += M;
  if (with_u) {
    s.U0 = p; p += M;
    s.U1 = p; p += M;
    s.U2 = p; p += M;
  } else {
    s.U0 = s.U1 = s.U2 = nullptr;
  }
  s.red = p;
  return s;
}

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float4 b) {
  const float dx = ax - b.x, dy = ay - b.y, dz = az - b.z;
  return dx * dx + dy * dy + dz * dz;
}

__device__ __forceinline__ void set_weight(float4* p, int i, float w) {
  reinterpret_cast<float*>(p)[4 * i + 3] = w;
}

// Sum each of v[0..K) over the block; every thread gets the same bits: a
// warp shuffle tree, then the warps' sums added in warp order.
template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
  static_assert(K <= kMaxReduce, "raise kMaxReduce");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  __syncthreads();  // the previous reduction's reads are done
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * kWarps + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[k * kWarps + w];
    v[k] = t;
  }
}

// Row sweep 1 for rows n0 + r * kThreads, r < kR:
// ratio_l = remain_l / (1e-9 + sum_m w * remain_r).
template <int kR>
__device__ void rows_ratio(const State& s, int n0, int M, float level) {
  float px[kR], py[kR], pz[kR], acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float4 p = s.xw[n0 + r * kThreads];
    px[r] = p.x; py[r] = p.y; pz[r] = p.z; acc[r] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    const float4 q = s.yw[m];  // q.w = remain_r[m]
#pragma unroll
    for (int r = 0; r < kR; ++r)
      acc[r] += expf(level * sq_dist(px[r], py[r], pz[r], q)) * q.w;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = n0 + r * kThreads;
    set_weight(s.xw, n, s.remain_l[n] / (acc[r] + 1e-9f));
  }
}

// Row sweep 2 for rows n0 + r * kThreads: this round's match row mass
// t = sum_m w * ratio_r and sum_m w * ratio_r * y, into R, V and remain_l.
template <int kR>
__device__ void rows_match(const State& s, int n0, int M, float level) {
  float px[kR], py[kR], pz[kR], t[kR], v0[kR], v1[kR], v2[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float4 p = s.xw[n0 + r * kThreads];
    px[r] = p.x; py[r] = p.y; pz[r] = p.z;
    t[r] = v0[r] = v1[r] = v2[r] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    const float4 q = s.yw[m];  // q.w = ratio_r[m]
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float wr = expf(level * sq_dist(px[r], py[r], pz[r], q)) * q.w;
      t[r] += wr;
      v0[r] += wr * q.x;
      v1[r] += wr * q.y;
      v2[r] += wr * q.z;
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = n0 + r * kThreads;
    const float rl = s.xw[n].w;
    const float mass = rl * t[r];
    s.R[n] += mass;
    s.V0[n] += rl * v0[r];
    s.V1[n] += rl * v1[r];
    s.V2[n] += rl * v2[r];
    s.remain_l[n] = fmaxf(0.f, s.remain_l[n] - mass);
  }
}

// Column sweep for columns m0 + c * kThreads: s = sum_n w * ratio_l (and,
// for U, sum_n w * ratio_l * x), then the column epilogue.
template <int kC, bool kU>
__device__ void cols_ratio(const State& s, int m0, int N, float level) {
  float qx[kC], qy[kC], qz[kC], acc[kC], a0[kC], a1[kC], a2[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float4 q = s.yw[m0 + c * kThreads];
    qx[c] = q.x; qy[c] = q.y; qz[c] = q.z;
    acc[c] = a0[c] = a1[c] = a2[c] = 0.f;
  }
  for (int n = 0; n < N; ++n) {
    const float4 p = s.xw[n];  // p.w = ratio_l[n]
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float wl = expf(level * sq_dist(qx[c], qy[c], qz[c], p)) * p.w;
      acc[c] += wl;
      if (kU) {
        a0[c] += wl * p.x;
        a1[c] += wl * p.y;
        a2[c] += wl * p.z;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int m = m0 + c * kThreads;
    const float rr = s.remain_r[m];
    const float sumr = acc[c] * rr;
    const float ratio_r = fminf(rr / (sumr + 1e-9f), 1.f) * rr;
    s.remain_r[m] = fmaxf(0.f, rr - sumr);
    s.C[m] += ratio_r * acc[c];
    if (kU) {
      s.U0[m] += ratio_r * a0[c];
      s.U1[m] += ratio_r * a1[c];
      s.U2[m] += ratio_r * a2[c];
    }
    set_weight(s.yw, m, ratio_r);
  }
}

// The auction for one pair; returns the cost (the same in every thread) and
// leaves R, V, C (and U) in shared memory.
template <bool kU>
__device__ float auction(const State& s, const float* __restrict__ x,
                         const float* __restrict__ y, int N, int M) {
  const int tid = threadIdx.x;
  const float multi_l = N >= M ? 1.f : (float)(M / N);
  const float multi_r = N >= M ? (float)(N / M) : 1.f;
  for (int n = tid; n < N; n += kThreads) {
    s.xw[n] = make_float4(x[3 * n], x[3 * n + 1], x[3 * n + 2], 0.f);
    s.remain_l[n] = multi_l;
    s.R[n] = s.V0[n] = s.V1[n] = s.V2[n] = 0.f;
  }
  for (int m = tid; m < M; m += kThreads) {
    s.yw[m] = make_float4(y[3 * m], y[3 * m + 1], y[3 * m + 2], multi_r);
    s.remain_r[m] = multi_r;
    s.C[m] = 0.f;
    if (kU) s.U0[m] = s.U1[m] = s.U2[m] = 0.f;
  }
  __syncthreads();

  for (int i = 0; i < 9; ++i) {
    const float level = kLevels[i];
    // yw.w = remain_r
    for (int n0 = tid; n0 < N; n0 += 2 * kThreads) {
      if (n0 + kThreads < N) rows_ratio<2>(s, n0, M, level);
      else rows_ratio<1>(s, n0, M, level);
    }
    __syncthreads();
    for (int m0 = tid; m0 < M; m0 += 2 * kThreads) {
      if (m0 + kThreads < M) cols_ratio<2, kU>(s, m0, N, level);
      else cols_ratio<1, kU>(s, m0, N, level);
    }
    __syncthreads();
    // yw.w = ratio_r
    for (int n0 = tid; n0 < N; n0 += 2 * kThreads) {
      if (n0 + kThreads < N) rows_match<2>(s, n0, M, level);
      else rows_match<1>(s, n0, M, level);
    }
    __syncthreads();
    for (int m = tid; m < M; m += kThreads) set_weight(s.yw, m, s.remain_r[m]);
    __syncthreads();
  }

  // round 9, level 0: w = 1 everywhere, so every sum over the partner cloud
  // is one block reduction
  float a[1] = {0.f};
  for (int m = tid; m < M; m += kThreads) a[0] += s.remain_r[m];
  block_sum(a, s.red);
  const float suml = a[0] + 1e-9f;
  float b[4] = {0.f, 0.f, 0.f, 0.f};  // sum_n ratio_l, sum_n ratio_l * x
  for (int n = tid; n < N; n += kThreads) {
    const float4 p = s.xw[n];
    const float rl = s.remain_l[n] / suml;
    set_weight(s.xw, n, rl);
    b[0] += rl;
    if (kU) {
      b[1] += rl * p.x;
      b[2] += rl * p.y;
      b[3] += rl * p.z;
    }
  }
  block_sum(b, s.red);
  float c[4] = {0.f, 0.f, 0.f, 0.f};  // sum_m ratio_r, sum_m ratio_r * y
  for (int m = tid; m < M; m += kThreads) {
    const float4 q = s.yw[m];
    const float rr = s.remain_r[m];
    const float sumr = b[0] * rr;
    const float ratio_r = fminf(rr / (sumr + 1e-9f), 1.f) * rr;
    s.C[m] += ratio_r * b[0];
    if (kU) {
      s.U0[m] += ratio_r * b[1];
      s.U1[m] += ratio_r * b[2];
      s.U2[m] += ratio_r * b[3];
    }
    c[0] += ratio_r;
    c[1] += ratio_r * q.x;
    c[2] += ratio_r * q.y;
    c[3] += ratio_r * q.z;
  }
  block_sum(c, s.red);

  // the cost; each thread's rows and columns carry their own last updates
  float cost[1] = {0.f};
  for (int n = tid; n < N; n += kThreads) {
    const float4 p = s.xw[n];
    const float rl = p.w;
    const float r = s.R[n] + rl * c[0];
    const float v0 = s.V0[n] + rl * c[1];
    const float v1 = s.V1[n] + rl * c[2];
    const float v2 = s.V2[n] + rl * c[3];
    s.R[n] = r;
    s.V0[n] = v0;
    s.V1[n] = v1;
    s.V2[n] = v2;
    cost[0] += (p.x * p.x + p.y * p.y + p.z * p.z) * r -
               2.f * (p.x * v0 + p.y * v1 + p.z * v2);
  }
  for (int m = tid; m < M; m += kThreads) {
    const float4 q = s.yw[m];
    cost[0] += (q.x * q.x + q.y * q.y + q.z * q.z) * s.C[m];
  }
  block_sum(cost, s.red);
  return cost[0];
}

__global__ void __launch_bounds__(kThreads, 1)
emd_block_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                 float* __restrict__ out, int C, int N, int M) {
  extern __shared__ float4 smem4[];
  const State s = carve(reinterpret_cast<float*>(smem4), N, M, false);
  const long long pair = blockIdx.x;
  const long long i = pair / C, j = pair % C;
  const float cost = auction<false>(s, rows + i * N * 3, cols + j * M * 3, N, M);
  if (threadIdx.x == 0) out[pair] = cost;
}

__global__ void __launch_bounds__(kThreads, 1)
emd_pair_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ cost, float* __restrict__ R,
                float* __restrict__ C, float* __restrict__ V,
                float* __restrict__ U, int N, int M) {
  extern __shared__ float4 smem4[];
  const State s = carve(reinterpret_cast<float*>(smem4), N, M, true);
  const long long b = blockIdx.x;
  const float c = auction<true>(s, x + b * N * 3, y + b * M * 3, N, M);
  if (threadIdx.x == 0) cost[b] = c;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    R[b * N + n] = s.R[n];
    V[(b * N + n) * 3 + 0] = s.V0[n];
    V[(b * N + n) * 3 + 1] = s.V1[n];
    V[(b * N + n) * 3 + 2] = s.V2[n];
  }
  for (int m = threadIdx.x; m < M; m += kThreads) {
    C[b * M + m] = s.C[m];
    U[(b * M + m) * 3 + 0] = s.U0[m];
    U[(b * M + m) * 3 + 1] = s.U1[m];
    U[(b * M + m) * 3 + 2] = s.U2[m];
  }
}

bool shape_ok(long long pairs, int N, int M) {
  return pairs >= 1 && pairs <= 0x7fffffffLL && N >= 1 && M >= 1 &&
         N <= kMaxPoints && M <= kMaxPoints;
}

}  // namespace

extern "C" {

// rows (R, N, 3), cols (C, M, 3), out (R, C): contiguous float32 on the
// current device.  Launches R*C blocks on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape beyond the limits).
int emd_block_launch(const float* rows, const float* cols, float* out, int R,
                     int C, int N, int M, void* stream) {
  if (!shape_ok((long long)R * C, N, M)) return (int)cudaErrorInvalidValue;
  const size_t bytes = shared_bytes(N, M, false);
  cudaError_t err = cudaFuncSetAttribute(
      emd_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  emd_block_kernel<<<(unsigned)((long long)R * C), kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(rows, cols, out, C, N, M);
  return (int)cudaGetLastError();
}

// x (B, N, 3), y (B, M, 3) matched 1:1; cost (B), R (B, N), C (B, M),
// V (B, N, 3), U (B, M, 3): contiguous float32 on the current device.
int emd_pair_launch(const float* x, const float* y, float* cost, float* R,
                    float* C, float* V, float* U, int B, int N, int M,
                    void* stream) {
  if (!shape_ok(B, N, M)) return (int)cudaErrorInvalidValue;
  const size_t bytes = shared_bytes(N, M, true);
  cudaError_t err = cudaFuncSetAttribute(
      emd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  emd_pair_kernel<<<(unsigned)B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, cost, R, C, V, U, N, M);
  return (int)cudaGetLastError();
}

const char* emd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
