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
// with the squared distance formed from explicit coordinate differences
// (not x^2 + y^2 - 2xy, which cancels for nearby points) by one fixed
// sequence of correctly rounded operations, so that no contraction choice
// of the compiler can change it:
//
//     dx = x0 - y0, dy = x1 - y1, dz = x2 - y2   (__fsub_rn)
//     d  = fma(dz, dz, fma(dy, dy, dx * dx))      (__fmul_rn, __fmaf_rn)
//
// metrics/chamfer_cuda.py's plain version computes the same expression.
//
// What bounds it.  Brute force forms all B*N*M distances (1.37e11 at the
// reconstruction shape, B = 512, N = M = 16,384): 7 instructions each
// (3 FADD, FMUL, 2 FFMA, FMNMX), an issue floor of ~30 ms on an H100
// against 16.4 ms of FP32 operations at the published 67 TFLOP/s, and the
// brute-force kernel took 34.2 ms.  No layout of the explicit form clears
// half the bound, and the tensor-core form cancels.  So the design removes
// work, not instructions: a nearest neighbour is local, and a partner
// group whose box is farther from a set of queries than any of their
// current minima cannot lower them.  Skipping it is exact.
//
// The design:
//   * The wrapper orders each cloud by a Morton code of its coordinates
//     (quantised in that cloud's own bounding box; a stable sort, so equal
//     points keep their original order) and passes the sorted clouds, the
//     queries' original positions, the partners' original indices, and
//     for each group of kGroup (32) consecutive sorted partners its
//     axis-aligned box and the smallest original index it holds.  The
//     partner cloud is padded to whole groups with copies of its last
//     sorted point, which change no minimum, no box and no index.
//   * A warp owns 32 * kQPT consecutive sorted queries, kQPT to a lane,
//     as kQPT slices of 32 (slice k: lane l holds query 32k + l).  Each
//     slice has its box, and its lanes' current minima their maximum
//     (maxb, one __reduce_max_sync on the float's bits: the minima are
//     non-negative).  The warp works alone: no block barrier anywhere.
//     kQPT is 4 unless that leaves fewer blocks than the device has SMs;
//     then 2 or 1 (points_per_thread), so that a small batch (the demo's,
//     a small --batch-size) still fills the card.
//   * Pass 1 (K2, and K3's minimum): the warp starts at the partner group
//     nearest its queries' centre and sweeps outward in sorted order, in
//     batches of 32 groups; lane j tests group j of the batch against
//     every slice (lb = the squared gap between the two boxes, by the
//     distance's own sequence of operations).  A slice takes a group only
//     if lb < its maxb, re-tested against the current maxb just before.
//     The group's 32 points are staged in shared memory (one 16-byte load
//     a lane), then every live slice that takes it runs 32 distances a
//     lane; when all do, one broadcast read of a partner point feeds kQPT
//     distances.
//   * K3, the index: pass 1 is K2's sweep, but a slice first takes each
//     group's own minimum per lane and then notes whether it lowers the
//     lane's minimum (the group becomes the lane's candidate) or reaches
//     it again (the first such group is kept too).  Afterwards each lane
//     rescans those one or two groups alone for the smallest original
//     index at its minimum.  Only a lane that saw a second tie, or whose
//     slice culled a group at lb == maxb with the lane's minimum at maxb
//     (the one way a culled group can hold a tie), goes on to pass 2: the groups in sorted order
//     whose box is within its minimum (per slice, then per lane, point to
//     box) and whose smallest original index is below its index so far.
//     The stable sort keeps duplicate points (thousands at the origin in
//     reconstruction clouds) in one run in original order, so pass 2
//     touches about one group of them.  The compare-and-select of an
//     argmin never enters the sweep.
// Exactness: float subtraction, multiplication and FMA round monotonically,
// so for a query q in box A and a partner p in box P, |fl(q - p)| >=
// max(fl(A.lo - P.hi), fl(P.lo - A.hi), 0) on each axis, and the gap's
// squared sum by the same sequence is <= d(q, p).  Culling on lb >= maxb
// (pass 1) never drops a partner that sets a minimum, and one that ties
// it only at lb == maxb, which K3 notes; culling on lb > minimum (pass 2)
// never drops a tie; nn_dist's and nn_argmin's minima are the same bits,
// and those of the plain version (tests/test_torch_nn_order.py holds the
// bound on random boxes).
//
// A counting instantiation (kCount) adds up the distances each pass forms
// (K3's candidate rescans counted with pass 2); only chip_smoke.py
// launches it, to state the work a launch did.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;  // partner points a group; one a lane when staged
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x), dy = __fsub_rn(qy, p.y), dz = __fsub_rn(qz, p.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// The gap between [alo, ahi] and [blo, bhi] on one axis, 0 if they overlap.
__device__ __forceinline__ float gap(float alo, float ahi, float blo, float bhi) {
  return fmaxf(fmaxf(__fsub_rn(alo, bhi), __fsub_rn(blo, ahi)), 0.f);
}

struct Box {
  float lo[3], hi[3];
};

// The squared gap between two boxes by sq_dist's sequence: a lower bound
// of d(q, p) for every q in a and p in b.
__device__ __forceinline__ float box_lb(const Box& a, const Box& b) {
  const float gx = gap(a.lo[0], a.hi[0], b.lo[0], b.hi[0]);
  const float gy = gap(a.lo[1], a.hi[1], b.lo[1], b.hi[1]);
  const float gz = gap(a.lo[2], a.hi[2], b.lo[2], b.hi[2]);
  return __fmaf_rn(gz, gz, __fmaf_rn(gy, gy, __fmul_rn(gx, gx)));
}

__device__ __forceinline__ Box load_box(const float* __restrict__ boxes, int g) {
  const float* p = boxes + 6 * (size_t)g;
  return Box{{p[0], p[1], p[2]}, {p[3], p[4], p[5]}};
}

__device__ __forceinline__ Box shfl_box(const Box& a, int src) {
  Box r;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.lo[i] = __shfl_sync(kFull, a.lo[i], src);
    r.hi[i] = __shfl_sync(kFull, a.hi[i], src);
  }
  return r;
}

// The largest of the warp's non-negative floats (as bits, which order alike).
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

// Position pos of the outward sweep from group s over G groups: s, s + 1,
// s - 1, s + 2, s - 2, ..., then the rest of the longer side.
__device__ __forceinline__ int sweep_group(int pos, int s, int G) {
  if (pos == 0) return s;
  const int left = s, right = G - 1 - s, both = min(left, right);
  if (pos <= 2 * both) return (pos & 1) ? s + (pos + 1) / 2 : s - pos / 2;
  const int rest = pos - 2 * both;
  return left > right ? s - both - rest : s + both + rest;
}

// No __launch_bounds__: with it (128 threads), ptxas capped the registers
// of the larger instantiations and spilled; without it none spills (CUDA
// 12.8; chip_smoke.py prints the registers).
template <int kQPT, bool kIdx, bool kCount>
__global__ void nn_kernel(const float* __restrict__ xs, const int* __restrict__ xpos,
          const float* __restrict__ ys, const int* __restrict__ yidx,
          const float* __restrict__ boxes, const int* __restrict__ gmin,
          float* __restrict__ dist, int* __restrict__ idx,
          unsigned long long* __restrict__ count, int N, int G) {
  __shared__ float4 staged[kWarps][kGroup];
  __shared__ Box slice_box[kWarps][kQPT];
  __shared__ float bounds[kWarps][kQPT][32];  // a batch's lb, by slice and lane
  __shared__ int tie_group[kIdx ? kWarps : 1][kQPT][32];  // K3: a group that tied
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x * kWarps + warp) * 32 * kQPT;
  if (t0 >= N) return;  // the whole warp: it shares nothing with the others
  const float* xb = xs + (size_t)b * N * 3;
  const float* yb = ys + (size_t)b * G * kGroup * 3;
  const float* bb = boxes + (size_t)b * G * 6;
  const int* yi = yidx + (size_t)b * G * kGroup;
  const int nslices = min(kQPT, (N - t0 + 31) / 32);
  const unsigned live = (1u << nslices) - 1u;

  // the warp's queries (past N: copies of the last, never written) and the
  // slices' boxes
  float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT], maxb[kQPT];
  Box warp_box{{CUDART_INF_F, CUDART_INF_F, CUDART_INF_F},
               {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F}};
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int i = min(t0 + 32 * k + lane, N - 1);
    qx[k] = xb[3 * i];
    qy[k] = xb[3 * i + 1];
    qz[k] = xb[3 * i + 2];
    best[k] = maxb[k] = CUDART_INF_F;
    Box s{{qx[k], qy[k], qz[k]}, {qx[k], qy[k], qz[k]}};
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s.lo[a] = fminf(s.lo[a], __shfl_xor_sync(kFull, s.lo[a], o));
        s.hi[a] = fmaxf(s.hi[a], __shfl_xor_sync(kFull, s.hi[a], o));
      }
    if (lane == 0) slice_box[warp][k] = s;
    if (live >> k & 1u)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        warp_box.lo[a] = fminf(warp_box.lo[a], s.lo[a]);
        warp_box.hi[a] = fmaxf(warp_box.hi[a], s.hi[a]);
      }
  }
  __syncwarp();

  // the partner group nearest the centre of the warp's queries (the first
  // on ties): where the sweep starts
  int start;
  {
    Box c;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      c.lo[a] = c.hi[a] = 0.5f * (warp_box.lo[a] + warp_box.hi[a]);
    float near = CUDART_INF_F;
    start = 0;
    for (int g = lane; g < G; g += 32) {
      const float lb = box_lb(c, load_box(bb, g));
      if (lb < near) near = lb, start = g;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float on = __shfl_xor_sync(kFull, near, o);
      const int os = __shfl_xor_sync(kFull, start, o);
      if (on < near || (on == near && os < start)) near = on, start = os;
    }
  }

  unsigned long long evaluated[2] = {0ull, 0ull};

  // stage group g (its points, with their original indices for pass 2)
  auto stage = [&](int g, bool with_idx) {
    const int j = g * kGroup + lane;
    __syncwarp();  // the previous group is no longer being read
    staged[warp][lane] = make_float4(yb[3 * j], yb[3 * j + 1], yb[3 * j + 2],
                                     with_idx ? __int_as_float(yi[j]) : 0.f);
    __syncwarp();
  };

  // pass 1: the minima.  K3 also notes, per lane and slice, the group that
  // last lowered the minimum (cand), whether a later group reached it
  // again (tied), and, per slice, whether a group was culled at lb == maxb
  // (eq_cull), the only way a culled group can hold a tie.
  int cand[kQPT];
  unsigned tied = 0, tied_again = 0, eq_cull = 0;
  for (int base = 0; base < G; base += 32) {
    const int pos = base + lane;
    const int g = pos < G ? sweep_group(pos, start, G) : 0;
    unsigned alive = 0, at_max = 0;
    const Box gb = load_box(bb, g);
    __syncwarp();  // the previous batch's bounds are no longer being read
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      float lb = CUDART_INF_F;
      if (pos < G && (live >> k & 1u)) {
        lb = box_lb(slice_box[warp][k], gb);
        if (lb < maxb[k]) alive |= 1u << k;
        else if (lb == maxb[k]) at_max |= 1u << k;
      }
      bounds[warp][k][lane] = lb;
    }
    if (kIdx) eq_cull |= __reduce_or_sync(kFull, at_max);
    __syncwarp();
    for (unsigned todo = __ballot_sync(kFull, alive != 0); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int gg = __shfl_sync(kFull, g, src);
      unsigned take = __shfl_sync(kFull, alive, src);
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        const float lb = bounds[warp][k][src];
        if (lb >= maxb[k]) {
          take &= ~(1u << k);
          if (kIdx && lb == maxb[k] && (live >> k & 1u)) eq_cull |= 1u << k;
        }
      }
      if (!take) continue;
      stage(gg, false);
      if (kCount) evaluated[0] += (unsigned long long)__popc(take) * kGroup * 32;
      // K3: the group's own minimum first, then whether it lowers the
      // minimum or reaches it again (the first such group is kept)
      auto note = [&](int k, float low) {
        if (low < best[k]) {
          best[k] = low;
          cand[k] = gg;
          tied &= ~(1u << k);
          tied_again &= ~(1u << k);
        } else if (low == best[k]) {
          if (tied >> k & 1u) tied_again |= 1u << k;
          else tie_group[warp][k][lane] = gg;
          tied |= 1u << k;
        }
      };
      if (take == live) {
        float low[kQPT];
#pragma unroll
        for (int k = 0; k < kQPT; ++k) low[k] = CUDART_INF_F;
        for (int s = 0; s < kGroup; ++s) {
          const float4 p = staged[warp][s];
#pragma unroll
          for (int k = 0; k < kQPT; ++k) {
            const float d = sq_dist(qx[k], qy[k], qz[k], p);
            if (kIdx) low[k] = fminf(low[k], d);
            else best[k] = fminf(best[k], d);
          }
        }
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          if (kIdx) note(k, low[k]);
          maxb[k] = warp_max(best[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          if (!(take >> k & 1u)) continue;
          float low = CUDART_INF_F;
          for (int s = 0; s < kGroup; ++s) {
            const float d = sq_dist(qx[k], qy[k], qz[k], staged[warp][s]);
            if (kIdx) low = fminf(low, d);
            else best[k] = fminf(best[k], d);
          }
          if (kIdx) note(k, low);
          maxb[k] = warp_max(best[k]);
        }
      }
    }
  }

  int bidx[kQPT];
  if (kIdx) {
    // each lane: the smallest original index at its minimum in the group
    // that set it and in the first group that reached it again (lanes read
    // their own groups)
    auto rescan = [&](int k, int g) {
      for (int s = 0; s < kGroup; ++s) {
        const int j = g * kGroup + s;
        const float4 p = make_float4(yb[3 * j], yb[3 * j + 1], yb[3 * j + 2], 0.f);
        if (sq_dist(qx[k], qy[k], qz[k], p) == best[k]) bidx[k] = min(bidx[k], yi[j]);
      }
    };
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      bidx[k] = INT_MAX;
      if (!(live >> k & 1u)) continue;
      rescan(k, cand[k]);
      if (tied >> k & 1u) rescan(k, tie_group[warp][k][lane]);
      if (kCount) {
        evaluated[1] += kGroup * 32;
        if (__any_sync(kFull, tied >> k & 1u)) evaluated[1] += kGroup * 32;
      }
    }

    // pass 2, for the lanes whose minimum a third group may reach too: the
    // groups in sorted order whose box is within the minimum and whose
    // smallest original index is below the lane's index so far
    unsigned unsure = 0, maxi[kQPT];
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      if ((live >> k & 1u) &&
          ((tied_again >> k & 1u) || ((eq_cull >> k & 1u) && best[k] == maxb[k])))
        unsure |= 1u << k;
      maxi[k] = __reduce_max_sync(kFull, unsure >> k & 1u ? (unsigned)bidx[k] : 0u);
    }
    const unsigned need = __reduce_or_sync(kFull, unsure);
    const int* gm = gmin + (size_t)b * G;
    for (int base = 0; need && base < G; base += 32) {
      const int g = min(base + lane, G - 1);
      const Box gb = load_box(bb, g);
      const int low = gm[g];
      unsigned alive = 0;
#pragma unroll
      for (int k = 0; k < kQPT; ++k)
        if (base + lane < G && (need >> k & 1u) && box_lb(slice_box[warp][k], gb) <= maxb[k] &&
            (unsigned)low < maxi[k])
          alive |= 1u << k;
      for (unsigned todo = __ballot_sync(kFull, alive != 0); todo; todo &= todo - 1) {
        const int src = __ffs(todo) - 1;
        const int gg = base + src;
        const int glow = __shfl_sync(kFull, low, src);
        const Box pb = shfl_box(gb, src);
        unsigned take = __shfl_sync(kFull, alive, src);
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          if (!(take >> k & 1u)) continue;
          const Box q{{qx[k], qy[k], qz[k]}, {qx[k], qy[k], qz[k]}};
          if (!__any_sync(kFull, (unsure >> k & 1u) && glow < bidx[k] && box_lb(q, pb) <= best[k]))
            take &= ~(1u << k);
        }
        if (!take) continue;
        stage(gg, true);
        if (kCount) evaluated[1] += (unsigned long long)__popc(take) * kGroup * 32;
#pragma unroll
        for (int k = 0; k < kQPT; ++k) {
          if (!(take >> k & 1u)) continue;
          for (int s = 0; s < kGroup; ++s) {
            const float4 p = staged[warp][s];
            if (sq_dist(qx[k], qy[k], qz[k], p) == best[k])
              bidx[k] = min(bidx[k], __float_as_int(p.w));
          }
          maxi[k] = __reduce_max_sync(kFull, unsure >> k & 1u ? (unsigned)bidx[k] : 0u);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int i = t0 + 32 * k + lane;
    if (i < N) {
      const size_t o = (size_t)b * N + xpos[(size_t)b * N + i];
      dist[o] = fmaxf(best[k], 0.f);
      if (kIdx) idx[o] = bidx[k];
    }
  }
  if (kCount && lane == 0) {
    atomicAdd(count, evaluated[0]);
    atomicAdd(count + 1, evaluated[1]);
  }
}

// Query points per thread: 4 unless that leaves fewer blocks than the
// current device has SMs.  At 8, the brute-force kernel's choice, K2 and
// K3 ran slower on the timed clouds and no faster on clouds where nothing
// can be culled (build variants on an H100).
int points_per_thread(int B, int N) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int qpt = 4; qpt > 1; qpt >>= 1) {
    const long long tiles = (N + kThreads * qpt - 1) / (kThreads * qpt);
    if (tiles * B >= sms) return qpt;
  }
  return 1;
}

struct Args {
  const float* xs;
  const int* xpos;
  const float* ys;
  const int* yidx;
  const float* boxes;
  const int* gmin;
  float* dist;
  int* idx;
  unsigned long long* count;
  int B, N, G;
};

template <int kQPT, bool kIdx, bool kCount>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + kThreads * kQPT - 1) / (kThreads * kQPT), a.B);
  nn_kernel<kQPT, kIdx, kCount><<<grid, kThreads, 0, stream>>>(
      a.xs, a.xpos, a.ys, a.yidx, a.boxes, a.gmin, a.dist, a.idx, a.count, a.N, a.G);
}

template <bool kIdx, bool kCount>
int nn_launch(const Args& a, void* stream_ptr) {
  if (a.B < 1 || a.B > 65535 || a.N < 1 || a.G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (points_per_thread(a.B, a.N)) {
    case 4: launch<4, kIdx, kCount>(a, stream); break;
    case 2: launch<2, kIdx, kCount>(a, stream); break;
    default: launch<1, kIdx, kCount>(a, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The layout of metrics/chamfer_cuda.py::nn_layout, contiguous on the
// current device: xs (B, N, 3) float32 queries in Morton order and xpos
// (B, N) int32 their original positions; ys (B, G * 32, 3) float32
// partners in Morton order, padded to whole groups, yidx (B, G * 32) int32
// their original indices; boxes (B, G, 6) float32 each group's lo and hi
// corners, gmin (B, G) int32 each group's smallest original index.
// dist (B, N) float32 and idx (B, N) int32 are written at the queries'
// original positions.  Launches on `stream`; returns cudaGetLastError().
int nn_dist_launch(const float* xs, const int* xpos, const float* ys, const float* boxes,
                   float* dist, int B, int N, int G, void* stream) {
  return nn_launch<false, false>(
      Args{xs, xpos, ys, nullptr, boxes, nullptr, dist, nullptr, nullptr, B, N, G}, stream);
}

int nn_argmin_launch(const float* xs, const int* xpos, const float* ys, const int* yidx,
                     const float* boxes, const int* gmin, float* dist, int* idx, int B,
                     int N, int G, void* stream) {
  return nn_launch<true, false>(
      Args{xs, xpos, ys, yidx, boxes, gmin, dist, idx, nullptr, B, N, G}, stream);
}

// As nn_dist_launch (need_idx 0) or nn_argmin_launch (1), and adds the
// distances formed in pass 1 and pass 2 to count[0] and count[1]
// (unsigned 64-bit, zeroed by the caller).
int nn_count_launch(const float* xs, const int* xpos, const float* ys, const int* yidx,
                    const float* boxes, const int* gmin, float* dist, int* idx,
                    unsigned long long* count, int need_idx, int B, int N, int G,
                    void* stream) {
  const Args a{xs, xpos, ys, yidx, boxes, gmin, dist, idx, count, B, N, G};
  return need_idx ? nn_launch<true, true>(a, stream) : nn_launch<false, true>(a, stream);
}

// The query points per thread (the kernel instantiation) that a launch of
// B clouds of N query points takes on the current device.
int nn_points_per_thread(int B, int N) { return points_per_thread(B, N); }

const char* nn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
