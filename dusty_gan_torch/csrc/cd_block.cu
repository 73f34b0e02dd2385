// Pairwise symmetric Chamfer block for Hopper (sm_90a).
//
// Replaces dusty_gan_tpu/metrics/chamfer_pallas.py::cd_block_pallas (kernel
// body _cd_block_kernel, its `bidir` path).  For an (R, N, 3) stack of row
// clouds and a (C, M, 3) stack of column clouds it writes the (R, C) block
//
//     out[i, j] = mean_n min_m |x_in - y_jm|^2 + mean_m min_n |x_in - y_jm|^2
//
// with squared distances formed from explicit coordinate differences,
// dx*dx + dy*dy + dz*dz (not x^2 + y^2 - 2xy, which cancels badly for
// nearby points; that rules out the tensor cores).
//
// What bounds it: instruction issue.  A distance is 3 FADD, 1 FMUL and 2
// FFMA, and it feeds two minima (its row's and its column's), 2 FMNMX: 8
// issued instructions.  An H100 issues one warp instruction a clock per
// scheduler, 132 SMs x 4 x 32 lanes x 1.98 GHz = 33.4e12 thread-instructions
// a second, so a (16, 512) block at 2048 x 2048 points (3.44e10 distances)
// cannot take less than ~8.2 ms.  Bytes are negligible: a cloud is 24 KB and
// is read N or M times from shared memory.
//
// What the design does about it:
//   * each distance is formed once and feeds both minima, as the TPU
//     kernel's bidirectional path does: half the distances of two one-way
//     passes;
//   * one thread block per (row cloud, column cloud) pair; the larger cloud
//     is the query side, 8 points a thread in registers (a tile of 2048
//     points per 256 threads, looped over for larger clouds), the smaller
//     the partner side, staged in shared memory in chunks of kChunk points;
//   * partners go by in groups of 32 on a skewed schedule: at step s lane l
//     takes partner (l + s) mod 32 of the group.  Each group is stored twice
//     in a row in shared memory, so that partner is one 16-byte load at a
//     constant offset from the lane's base, and its running column minimum
//     travels with it by one __shfl_sync a step: one load and one shuffle
//     per 8 distances.  The 32 steps of a group are unrolled, so loop
//     overhead comes once a group: 8.39 issued instructions a distance in
//     SASS (counted by chip_smoke.py);
//   * after a group, each lane holds its partner's minimum over the warp's
//     256 query points and merges it into a column-minimum buffer in shared
//     memory (one per partner point of the pair) with an integer atomicMin
//     on the bits of the non-negative float: exact and order-free;
//   * ragged counts are padded within the last tile and group, query points
//     with +inf and partners with -inf coordinates (so no difference is
//     inf - inf): their distances are +inf, never win a minimum, and are
//     left out of the sums; a warp whose query points are all padding skips
//     the sweep;
//   * sums are taken in a fixed order (per thread, then a shuffle tree), so
//     two launches give the same bits.
// One pass needs the column-minimum buffer of the smaller cloud in shared
// memory beside the staged chunk: up to 49,888 points in the 227 KB a block
// may have.  Where both clouds are larger, the block makes two one-way
// passes instead (with no scratch in device memory, the minima of one side
// must stay in the block).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQPT = 8;                    // query points a thread
constexpr int kTile = kThreads * kQPT;     // query points per sweep of the block
constexpr int kChunk = 1024;               // partner points staged at once
static_assert(kQPT == 8, "the column minimum's tree in sweep() takes 8 distances");

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// Staged partner slots of a block whose partner side has np points: each
// group of 32 of a chunk twice.
__host__ __device__ inline int staged_slots(int np) {
  return 2 * (np < kChunk ? round32(np) : kChunk);
}

// Its shared memory: the staged chunk and, for one pass, the column minima.
inline size_t smem_bytes(int np, bool bidir) {
  return staged_slots(np) * sizeof(float4) + (bidir ? round32(np) * sizeof(float) : 0);
}

// Sum over the query cloud q (nq points) of the squared distance to its
// nearest point in the partner cloud p (np points).  With kBidir, also the
// minimum over q of every partner's distance, merged into colmin (as int
// bits; the caller set it to +inf and reads it after a barrier).  Every
// thread returns its partial sum.
template <bool kBidir>
__device__ float sweep(const float* __restrict__ q, int nq, const float* __restrict__ p,
                       int np, float4* pts, int* colmin) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int next = (lane + 1) & 31;
  float acc = 0.f;
  for (int q0 = 0; q0 < nq; q0 += kTile) {
    // warp w takes points q0 + 256 w + 32 k + lane, k < kQPT
    const int qw = q0 + warp * (32 * kQPT);
    float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT];
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      const int t = qw + 32 * k + lane;
      const bool ok = t < nq;
      qx[k] = ok ? q[3 * t + 0] : CUDART_INF_F;
      qy[k] = ok ? q[3 * t + 1] : CUDART_INF_F;
      qz[k] = ok ? q[3 * t + 2] : CUDART_INF_F;
      best[k] = CUDART_INF_F;
    }
    for (int p0 = 0; p0 < np; p0 += kChunk) {
      const int cnt = min(kChunk, np - p0);
      const int groups = (cnt + 31) >> 5;
      if (q0 == 0 || np > kChunk) {  // one chunk stays staged across tiles
        __syncthreads();  // the previous chunk is no longer being read
        for (int t = threadIdx.x; t < 64 * groups; t += kThreads) {
          const int u = 32 * (t >> 6) + (t & 31);  // partner of slot t in the chunk
          float4 v = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, 0.f);
          if (u < cnt) {
            const float* s = p + 3 * (p0 + u);
            v = make_float4(s[0], s[1], s[2], 0.f);
          }
          pts[t] = v;
        }
        __syncthreads();
      }
      if (qw >= nq) continue;  // every query point of this warp is padding
      for (int g = 0; g < groups; ++g) {
        const float4* base = pts + 64 * g + lane;
        float cm = CUDART_INF_F;  // column minimum of partner (lane + s) mod 32
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          const float4 v = base[s];
          float d[kQPT];
#pragma unroll
          for (int k = 0; k < kQPT; ++k) {
            const float dx = qx[k] - v.x;
            const float dy = qy[k] - v.y;
            const float dz = qz[k] - v.z;
            d[k] = dx * dx + dy * dy + dz * dz;
            best[k] = fminf(best[k], d[k]);
          }
          if (kBidir) {
            const float c = fminf(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])),
                                  fminf(fminf(d[4], d[5]), fminf(d[6], d[7])));
            cm = __shfl_sync(0xffffffffu, fminf(cm, c), next);
          }
        }
        // after 32 steps and shuffles, lane l holds partner l of the group
        const int u = 32 * g + lane;
        if (kBidir && u < cnt) atomicMin(colmin + p0 + u, __float_as_int(cm));
      }
    }
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      if (qw + 32 * k + lane < nq) acc += best[k];
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
    v = lane < kWarps ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

// kBidir: one pass, the larger cloud as the query side.  Otherwise two
// one-way passes (both clouds too large for a column-minimum buffer).
template <bool kBidir>
__global__ void __launch_bounds__(kThreads)
cd_block_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                float* __restrict__ out, int C, int N, int M) {
  extern __shared__ float4 pts[];
  __shared__ float scratch[kWarps];
  const int j = blockIdx.x;  // column cloud
  const int i = blockIdx.y;  // row cloud
  const float* x = rows + (size_t)i * N * 3;
  const float* y = cols + (size_t)j * M * 3;
  float sx, sy;  // partial sums of the x points' minima and the y points'
  if (kBidir) {
    const bool x_queries = N >= M;
    const int nq = x_queries ? N : M, np = x_queries ? M : N;
    int* colmin = reinterpret_cast<int*>(pts + staged_slots(np));
    for (int t = threadIdx.x; t < np; t += kThreads) colmin[t] = __float_as_int(CUDART_INF_F);
    // the first chunk's staging barriers order these stores before any merge
    const float sq = sweep<true>(x_queries ? x : y, nq, x_queries ? y : x, np, pts, colmin);
    __syncthreads();  // every merge into colmin is done
    float sp = 0.f;
    for (int t = threadIdx.x; t < np; t += kThreads) sp += __int_as_float(colmin[t]);
    sx = x_queries ? sq : sp;
    sy = x_queries ? sp : sq;
  } else {
    sx = sweep<false>(x, N, y, M, pts, nullptr);
    sy = sweep<false>(y, M, x, N, pts, nullptr);
  }
  sx = block_sum(sx, scratch);
  sy = block_sum(sy, scratch);
  if (threadIdx.x == 0) out[(size_t)i * C + j] = sx / (float)N + sy / (float)M;
}

template <bool kBidir>
cudaError_t launch(const float* rows, const float* cols, float* out, int R, int C, int N,
                   int M, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cd_block_kernel<kBidir>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cd_block_kernel<kBidir><<<dim3(C, R), kThreads, smem, stream>>>(rows, cols, out, C, N, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (R, N, 3), cols (C, M, 3), out (R, C): contiguous float32 on the
// current device.  Launches on `stream` and returns cudaGetLastError().
int cd_block_launch(const float* rows, const float* cols, float* out, int R,
                    int C, int N, int M, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the static scratch shares the block's limit with the dynamic buffer
  const size_t limit = optin - kWarps * sizeof(float);
  const size_t one_pass = smem_bytes(std::min(N, M), true);
  const auto s = static_cast<cudaStream_t>(stream);
  e = one_pass <= limit
          ? launch<true>(rows, cols, out, R, C, N, M, one_pass, s)
          : launch<false>(rows, cols, out, R, C, N, M, smem_bytes(std::max(N, M), false), s);
  return static_cast<int>(e);
}

const char* cd_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
