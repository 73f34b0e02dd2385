// Furthest point sampling for Hopper (sm_90a): all k - 1 dependent steps of a
// batch of clouds in one launch, one thread block a cloud.
//
// What it computes: for a (B, N, 3) float32 stack of clouds, the (B, k) int64
// indices of dusty_gan_torch/metrics/fps.py::furthest_point_sampling_reference,
// bit for bit.  Index 0 comes first; each later step takes the point whose
// running minimum squared distance to the points taken so far is largest,
// among the points whose squared magnitude exceeds 1e-3 (dropped pixels
// back-project to the origin), ties to the first index; a point that is not
// valid reads -1 and so is taken only where no valid point is left above it.
//
// It replaces no TPU kernel: dusty_gan_tpu/metrics/fps.py is a lax.fori_loop
// that XLA compiles into one program.  The port first ran it as a loop of
// PyTorch operations, k - 1 dependent steps of about eight small kernels each:
// launch-bound, ~470 ms a call of 256 clouds of 16,384 points to 2048 on an
// H100, 1.9 s of a 5.8 s synthesis round of 1024 generated scans.
//
// What bounds it on an H100: arithmetic.  A point and step is 3 FADD for the
// differences, 3 FMUL and 2 FADD for the squared distance and one minimum:
// 9 FP32 operations, so a (256, 16384) -> 2048 call cannot take less than
// 256 * 16384 * 2047 * 9 / 67e12 s = 1.15 ms.  As issued instructions it is
// about 13 a point and step (the nine, the comparison and two selects of the
// running argmax, 3/4 of a 16-byte shared-memory load), ~3.2 ms at 132 SMs x
// 4 schedulers x 1.98 GHz; the same call reads 12 bytes of shared memory a
// point and step, 103 GB, ~3.1 ms at 128 bytes a clock per SM.  Device memory
// is read once: the cloud, 196 KB.
//
// What the design does about it:
//   * one launch for the whole loop: the steps run inside the block, so no
//     launch, no host round trip and no device-memory pass a step;
//   * one thread block of 1024 threads a cloud.  The block stages the cloud's
//     x, y and z once into dynamic shared memory as three float planes (12 N
//     bytes: 196,608 B at N = 16,384, under the 232,448 B a block may use);
//   * the running distances stay in registers, kPPT a thread (4, 8 or 16, as
//     N needs).  Thread t holds points 4 (g * 1024 + t) + r, r < 4, so each
//     plane gives a thread four neighbouring points in one 16-byte load, a
//     warp reads 512 contiguous bytes (no bank conflict), and a thread meets
//     its points in ascending index order;
//   * a point that is not valid starts at -1 and a padding slot (past N) at
//     -0.5; both stay, since every distance is >= 0, so no mask is kept.
//     The argmax compares the distances' bits as signed integers: for values
//     >= 0 that is the float order, both negative values rank below every
//     distance, and -0.5 ranks below -1, so padding never beats a point;
//   * one step: read the last point from shared memory (a broadcast), update
//     the thread's distances and its argmax (strict >, ascending), take the
//     warp's by two redux.sync (the largest value, then the smallest index
//     holding it), write one pair a warp into a double-buffered shared slot,
//     one __syncthreads, and every warp reduces the 32 pairs itself the same
//     way, so every thread knows the next point; thread 0 writes out[b, j].
//     A slot is written again two steps later, after a barrier that every
//     warp reaches only once it has read it;
//   * where N exceeds 16 points a thread or 12 N bytes exceed the block's
//     shared memory (other sensors' widths), the block reads the cloud from
//     device memory instead, where it stays in L2, and keeps the running
//     distances in a device-memory workspace of N floats a cloud that the
//     wrapper allocates.  N, read from the input, makes the choice.
// A (256, 16384) launch is 256 blocks, one an SM at a time (shared memory),
// on 132 SMs: two waves.
//
// Exactness, four rules:
//   1. No contracted FMAs: each product and sum is its own rounded
//      __fmul_rn / __fadd_rn / __fsub_rn, as PyTorch runs each as a kernel of
//      its own: d = (dx*dx + dy*dy) + dz*dz of the coordinate differences.
//      The intrinsics keep this in the source: NVCC_FLAGS are shared with
//      kernels whose FMAs are wanted.
//   2. Validity is (x*x + y*y) + z*z > 1e-3f, under the same rounding.
//   3. Index 0 is the first output even where that point is not valid; a
//      cloud with no valid point gives all zeros.
//   4. The first index wins every tie, which also settles k above the number
//      of valid points.
// The plain loop's torch.minimum and argmax carry a NaN distance along and
// pick it; this kernel's minimum drops it.  The two agree on clouds of finite
// coordinates, which is what the port's callers pass (depths clamped to the
// sensor's range, dropped pixels at the origin).

#include <cuda_runtime.h>

#include <climits>
#include <initializer_list>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kMinSqNorm = 1e-3f;
constexpr float kFar = 1e10f;      // a valid point's starting distance
constexpr float kInvalid = -1.0f;  // a point with squared magnitude <= 1e-3
constexpr float kPadding = -0.5f;  // a slot past N: ranks below kInvalid as bits
static_assert(kWarps == 32, "the second reduction gives one warp's pair to each lane");

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float start_distance(float x, float y, float z) {
  return sq_norm(x, y, z) > kMinSqNorm ? kFar : kInvalid;
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx, float ly,
                                         float lz) {
  return sq_norm(__fsub_rn(x, lx), __fsub_rn(y, ly), __fsub_rn(z, lz));
}

__device__ __forceinline__ float component(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// The block's (largest value, smallest index holding it) from each thread's
// (best, bi), returned to every thread; one barrier.
__device__ __forceinline__ int block_argmax(int best, int bi, int2* slot) {
  const int lane = threadIdx.x & 31;
  const int wbest = __reduce_max_sync(kAll, best);
  const int widx = __reduce_min_sync(kAll, best == wbest ? bi : INT_MAX);
  if (lane == 0) slot[threadIdx.x >> 5] = make_int2(wbest, widx);
  __syncthreads();
  const int2 s = slot[lane];
  const int gbest = __reduce_max_sync(kAll, s.x);
  return __reduce_min_sync(kAll, s.x == gbest ? s.y : INT_MAX);
}

// The cloud staged in shared memory, kPPT running distances a thread in
// registers; N <= kPPT * kThreads.
template <int kPPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_staged_kernel(const float* __restrict__ xyz, long long* __restrict__ out, int N, int k) {
  static_assert(kPPT % 4 == 0, "a thread's points come four to a 16-byte load");
  constexpr int kGroups = kPPT / 4;
  constexpr int kStaged = kPPT * kThreads;
  extern __shared__ float4 planes[];  // x, y and z, kStaged floats each
  __shared__ int2 slots[2][kWarps];
  float* sx = reinterpret_cast<float*>(planes);
  float* sy = sx + kStaged;
  float* sz = sy + kStaged;
  const float* c = xyz + (size_t)blockIdx.x * N * 3;
  for (int p = threadIdx.x; p < kStaged; p += kThreads) {
    float x = 0.f, y = 0.f, z = 0.f;
    if (p < N) {
      x = c[3 * p];
      y = c[3 * p + 1];
      z = c[3 * p + 2];
    }
    sx[p] = x;
    sy[p] = y;
    sz[p] = z;
  }
  __syncthreads();
  const float4* vx = reinterpret_cast<const float4*>(sx);
  const float4* vy = reinterpret_cast<const float4*>(sy);
  const float4* vz = reinterpret_cast<const float4*>(sz);
  float t[kPPT];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int q = g * kThreads + threadIdx.x;
    const float4 x = vx[q], y = vy[q], z = vz[q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      t[4 * g + r] = 4 * q + r < N
                         ? start_distance(component(x, r), component(y, r), component(z, r))
                         : kPadding;
  }
  long long* o = out + (size_t)blockIdx.x * k;
  if (threadIdx.x == 0) o[0] = 0;
  int last = 0;
  for (int j = 1; j < k; ++j) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    int best = INT_MIN, bi = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int q = g * kThreads + threadIdx.x;
      const float4 x = vx[q], y = vy[q], z = vz[q];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float& tv = t[4 * g + r];
        tv = fminf(tv, sq_dist(component(x, r), component(y, r), component(z, r), lx, ly, lz));
        const int v = __float_as_int(tv);
        if (v > best) {
          best = v;
          bi = 4 * q + r;
        }
      }
    }
    last = block_argmax(best, bi, slots[j & 1]);
    if (threadIdx.x == 0) o[j] = last;
  }
}

// The cloud read from device memory, the running distances in `work`
// (N floats a cloud): any N.
__global__ void __launch_bounds__(kThreads, 1)
fps_device_kernel(const float* __restrict__ xyz, float* __restrict__ work,
                  long long* __restrict__ out, int N, int k) {
  __shared__ int2 slots[2][kWarps];
  const float* c = xyz + (size_t)blockIdx.x * N * 3;
  float* t = work + (size_t)blockIdx.x * N;
  // each thread reads and writes only its own points of `t`
  for (int p = threadIdx.x; p < N; p += kThreads)
    t[p] = start_distance(c[3 * p], c[3 * p + 1], c[3 * p + 2]);
  long long* o = out + (size_t)blockIdx.x * k;
  if (threadIdx.x == 0) o[0] = 0;
  int last = 0;
  for (int j = 1; j < k; ++j) {
    const float lx = c[3 * last], ly = c[3 * last + 1], lz = c[3 * last + 2];
    int best = INT_MIN, bi = 0;
    for (int p = threadIdx.x; p < N; p += kThreads) {
      const float tv = fminf(t[p], sq_dist(c[3 * p], c[3 * p + 1], c[3 * p + 2], lx, ly, lz));
      t[p] = tv;
      const int v = __float_as_int(tv);
      if (v > best) {
        best = v;
        bi = p;
      }
    }
    last = block_argmax(best, bi, slots[j & 1]);
    if (threadIdx.x == 0) o[j] = last;
  }
}

constexpr size_t kStaticSmem = 2 * kWarps * sizeof(int2);

size_t staged_bytes(int ppt) { return 3 * sizeof(float) * (size_t)ppt * kThreads; }

// Dynamic shared memory a block may have on the current device.
cudaError_t smem_limit(size_t* limit) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = e == cudaSuccess && (size_t)optin > kStaticSmem ? optin - kStaticSmem : 0;
  return e;
}

// Points a thread of the staged kernel for N points (0: the device-memory
// kernel).
int staged_ppt(int N, size_t limit) {
  for (int ppt : {4, 8, 16})
    if (N <= ppt * kThreads && staged_bytes(ppt) <= limit) return ppt;
  return 0;
}

template <int kPPT>
cudaError_t launch_staged(const float* xyz, long long* out, int B, int N, int k,
                          cudaStream_t stream) {
  const size_t smem = staged_bytes(kPPT);
  const cudaError_t e = cudaFuncSetAttribute(
      fps_staged_kernel<kPPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fps_staged_kernel<kPPT><<<B, kThreads, smem, stream>>>(xyz, out, N, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The most points a cloud that the staged kernel takes on the current device
// (larger clouds take the device-memory kernel and its workspace); 0 where
// the device cannot be queried.
int fps_staged_points(void) {
  size_t limit = 0;
  if (smem_limit(&limit) != cudaSuccess) return 0;
  int most = 0;
  for (int ppt : {4, 8, 16})
    if (staged_bytes(ppt) <= limit) most = ppt * kThreads;
  return most;
}

// xyz (B, N, 3) float32, out (B, k) int64, work (B, N) float32 where N exceeds
// fps_staged_points() (else unused, may be null): contiguous, on the current
// device, B >= 1, N >= 1, k >= 1.  Launches on `stream` and returns
// cudaGetLastError().
int fps_launch(const float* xyz, long long* out, float* work, int B, int N, int k,
               void* stream) {
  size_t limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B < 1 || N < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (staged_ppt(N, limit)) {
    case 4: e = launch_staged<4>(xyz, out, B, N, k, s); break;
    case 8: e = launch_staged<8>(xyz, out, B, N, k, s); break;
    case 16: e = launch_staged<16>(xyz, out, B, N, k, s); break;
    default:
      if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      fps_device_kernel<<<B, kThreads, 0, s>>>(xyz, work, out, N, k);
      e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
