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
//     A. ratio_l[n] = remain_l[n] / (1e-9 + sum_m w * remain_r[m]);
//     B. s[m] = sum_n w * ratio_l[n], sumr = s * remain_r[m],
//        ratio_r[m] = min(remain_r / (sumr + 1e-9), 1) * remain_r,
//        remain_r[m] = max(0, remain_r - sumr);
//     C. match += w * ratio_l[n] * ratio_r[m],
//        remain_l[n] = max(0, remain_l - sum_m of that round's match).
// The match is never formed: its row mass R, column mass C, and V (and U)
// are accumulated per round, and
//   cost = sum_n |x_n|^2 R[n] + sum_m |y_m|^2 C[m] - 2 sum_n x_n . V[n].
//
// What bounds it: FP32 issue and the special function unit (SFU), outside
// the tensor cores.  Rounds 0-8 need, per distance, one exp2 and 16 FLOPs
// for K4 (d 8, the row sum 2, the column sum 2, the match mass 2, d * match
// 2) or 26 for K5 (V 6 and U 6 in place of d * match); round 9 (w = 1) is
// O(N + M).  At N = M = 2048 K4 needs 0.60 GFLOP a pair, 9.0 us at the
// published 67 TFLOP/s, and 3.8e7 exp2, 9.0 us at 16 a clock per SM (132
// SMs, 1.98 GHz); the bytes (two 24 KB clouds in, one float out) are
// negligible.  A warp instruction takes one issue slot of its SM quarter
// whatever its width, and an SFU exp2 eight slots of the quarter's SFU, so
// the time is the larger of the instructions and 8x the exp2s per distance.
//
// The design: one thread block of 1024 threads per pair, with the whole
// auction state in dynamic shared memory (the clouds as float4: x, y, z
// and a per-point weight; remain_l, remain_r; E (N) for K4, R, V (N) and
// C, U (M) for K5), so the only device-memory traffic is the two clouds in
// and the results out (up to 3072 points a cloud; see "Two paths" below).  A sweep is a loop over the partner cloud by a
// thread per row (or column): K4 gives a thread 4 rows and splits the
// partner cloud between the two halves of a warp (Layout), so that one
// broadcast read of a partner point feeds four distances; K5 2 rows.
// Three choices keep the work per distance low:
//   1. The TPU kernel's schedule: one fused row sweep a round.  Round 0 is
//      a row sweep (A) and a column sweep (B); each of rounds 1-8 is one
//      row sweep that runs round i-1's step C and round i's step A on one
//      distance, then B(i); round 8's C sweep stands alone.  19 sweeps,
//      not 27.  A row combines the two only at its end, so ratio_l(i) sees
//      remain_l after C(i-1).  ratio_r(i-1) sits in the partner's float4,
//      remain_r(i) in its own array.
//   2. exp on the SFU: w = exp(level d) = 2^-|x'' - y''|^2, one MUFU.EX2
//      (ex2.approx.ftz) in place of expf's ~8 instructions, with the
//      coordinates in shared memory scaled by sqrt(-level log2(e)): one
//      rounding per coordinate, then halvings, which are exact, so the
//      level table stays exact and the argument needs no multiply.  A
//      weight below 2^-126 is flushed to 0, not kept subnormal: it changes
//      a sum by less than 1e-22, far below the 1e-9 terms, which stay where
//      the JAX dense path puts them (PERF.md trap (a)).  Not
//      --use_fast_math, which would flush subnormals everywhere else.
//      C's weight of round i-1 in the fused sweep of round i is w^4 from
//      fused round 4 on (two multiplies), else a second exp2.
//   3. K4 sums d * match directly (E: one FFMA a distance, not V's three),
//      which also takes the cancellation out of its cost.
// Skipping weights that are exactly zero, by warp vote on Morton-sorted
// clouds, was measured slower on the card and is not built (PERF.md).
// Every sum has a fixed order (one thread, or a fixed pair of lanes, per
// row or column, and a fixed-shape block reduction; no atomics), so the
// same inputs give the same bits on every launch.
//
// ptxas (sm_90a, CUDA 12.8; chip_smoke.py prints it): emd_block_kernel
// and emd_pair_kernel 64 registers each on the shared-memory path (all
// that 1024 threads a block leave a thread), no spills.
//
// Two paths, one auction.  Up to kSharedMaxPoints (3072) points a cloud,
// the state above sits in dynamic shared memory (K5's fits the 227 KB a
// block may use up to there).  Above it the same kernels are instantiated
// with the state in device memory (kGlobal): the caller passes a workspace
// of state_floats(N, M) floats a pair for the pairs of one launch, and only
// the block reduction's scratch stays in shared memory.  The sweeps, the
// SFU exp2 and the fixed-order sums are the same code on 512 threads a
// block, not 1024 (Block<kG>: the state's 64-bit addresses need more
// than 64 registers a thread); its loads and stores go through L1 and L2
// instead of shared memory.  Launches that
// do not take the device-memory path compile to the code they had before
// it existed.  metrics/emd_cuda.py states the threshold to callers
// (SHARED_MAX_POINTS) and launches the device-memory path in chunks of
// pairs whose workspace stays under its cap.

#include <cuda_runtime.h>

namespace {

// Threads a block: 1024 on the shared-memory path; 512 on the device-memory
// path (kG), whose 64-bit state addresses need more registers than the 64
// a thread of a 1024-thread block has.
template <bool kG>
struct Block {
  static constexpr int kThreads = kG ? 512 : 1024;
};
constexpr int kMaxWarps = Block<false>::kThreads / 32;
constexpr int kSharedMaxPoints = 3072;  // the shared-memory path's largest N, M
constexpr int kMaxReduce = 5;  // values reduced together across the block
constexpr unsigned kFull = 0xffffffffu;
// Round i (level(i) = -4^(7-i), i < 9) keeps its coordinates in shared
// memory scaled by s_i = 2^(7-i) sqrt(log2(e)), so that |x'' - y''|^2 =
// -level(i) log2(e) d and w = exp(level(i) d) = 2^-|x'' - y''|^2; s_0 is
// kScale0 and each round halves the coordinates, exactly.
constexpr float kScale0 = 153.743668f;  // 128 sqrt(log2(e))

// The auction's state, in shared memory or, on the device-memory path, in
// the pair's slice of the workspace.  K4 keeps E, each row's sum of
// d * match; K5 the residues R, V, C and U.
struct State {
  float4* xw;                  // (N) x0, x1, x2 and the row weight ratio_l
  float4* yw;                  // (M) y0, y1, y2 and the column weight ratio_r
  float *remain_l, *remain_r;  // (N), (M)
  float* E;                    // (N), K4 only
  float *R, *V0, *V1, *V2;     // (N), K5 only
  float *C, *U0, *U1, *U2;     // (M), K5 only
  float* red;                  // (kMaxReduce * kMaxWarps)
};

// Floats of the state arrays of one pair, rounded up to whole float4s so
// that the next pair's slice of a workspace stays 16-byte aligned.
__host__ __device__ long long state_floats(int N, int M, bool residues) {
  const long long f = (residues ? 9LL : 6LL) * N + (residues ? 9LL : 5LL) * M;
  return (f + 3) / 4 * 4;
}

size_t shared_bytes(int N, int M, bool residues) {
  return sizeof(float) * ((residues ? 9 : 6) * (size_t)N + (residues ? 9 : 5) * (size_t)M +
                          kMaxReduce * kMaxWarps);
}

constexpr size_t kReduceBytes = sizeof(float) * kMaxReduce * kMaxWarps;

__device__ State carve(float* smem, int N, int M, bool residues) {
  State s = {};
  s.xw = reinterpret_cast<float4*>(smem);
  s.yw = reinterpret_cast<float4*>(smem + 4 * N);
  float* p = smem + 4 * N + 4 * M;
  s.remain_l = p; p += N;
  s.remain_r = p; p += M;
  if (residues) {
    s.R = p; p += N;
    s.V0 = p; p += N;
    s.V1 = p; p += N;
    s.V2 = p; p += N;
    s.C = p; p += M;
    s.U0 = p; p += M;
    s.U1 = p; p += M;
    s.U2 = p; p += M;
  } else {
    s.E = p; p += N;
  }
  s.red = p;
  return s;
}

// -|a - b|^2 from coordinate differences: the weight's exponent
__device__ __forceinline__ float neg_sq_dist(float ax, float ay, float az, float4 b) {
  const float dx = ax - b.x, dy = ay - b.y, dz = az - b.z;
  return fmaf(-dz, dz, fmaf(-dy, dy, -dx * dx));
}

// 2^a on the SFU; a result below 2^-126 is flushed to +0
__device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// The match step's weight of round i-1 in the fused sweep of round i,
// exp(level(i-1) d): as level(i-1) = 4 level(i) and s_(i-1) = 2 s_i
// exactly, it is w^4 (kSq) or 2^(4 arg).  The fourth power takes one SFU
// operation fewer, but the rounding of w, raised to the fourth, is too
// coarse for the sharp weights of the first rounds.  Standing in for
// rounds 0 and 1 (levels -16384 and -4096) it moved card-against-CPU
// pairwise EMD costs 2.03e-4 off, past their hold; on 576 LiDAR-like pairs
// the auction was 9.94e-4 from float64 with squares from fused round 1 or 2
// on, 7.32e-4 (as with no squares) from fused round 3, 4 or 5 on.  Fused
// rounds 1-3 take a second exp2 and rounds 4-8 the fourth power: 4.3%
// faster than a second exp2 everywhere (PERF.md).
constexpr int kSquaresFrom = 4;
template <bool kSq>
__device__ __forceinline__ float prev_weight(float w, float arg) {
  if (kSq) {
    const float w2 = w * w;
    return w2 * w2;
  }
  return ex2(4.f * arg);
}

__device__ __forceinline__ void set_weight(float4* p, int i, float w) {
  reinterpret_cast<float*>(p)[4 * i + 3] = w;
}

// Sum each of v[0..K) over the block of kT threads; every thread gets the
// same bits: a warp shuffle tree, then the warps' sums added in warp order.
template <int kT, int K>
__device__ void block_sum(float (&v)[K], float* red) {
  static_assert(K <= kMaxReduce, "raise kMaxReduce");
  constexpr int kWarps = kT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], o);
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

// How a sweep lays its rows (or columns) on the threads: a thread owns kR
// of them, n0 + r * slots (r < kR), and the kS threads that own the same
// ones (lanes 16 apart when kS = 2) split the partner cloud into kS
// contiguous parts, adding their partial sums in a fixed order at the end.
// K4 takes 4 rows a thread and kS = 2, so that one shared-memory read of a
// partner point feeds four distances; K5 (three more sums a row) 2 and 1.
// The device-memory path (kG) lays them alike on its 512 threads.
template <bool kU, bool kG>
struct Layout {
  static constexpr int kS = kU ? 1 : 2;
  static constexpr int kR = kU ? 2 : 4;
  static constexpr int kSlots = Block<kG>::kThreads / kS;  // owners of one level r
  static constexpr int kPass = kR * kSlots;      // rows a pass covers
  static __device__ int slot() {
    return kS == 1 ? threadIdx.x : (threadIdx.x >> 5) * 16 + (threadIdx.x & 15);
  }
  static __device__ int part() { return kS == 1 ? 0 : (threadIdx.x >> 4) & 1; }
};

// The device-memory path sums a sweep in blocks of kSumBlock terms and then
// the blocks' sums, for clouds of up to tens of thousands of points: a
// single running float32 sum over thousands of equal terms (the points a
// LiDAR scan drops to the origin all match each other in round 0) leaves
// a column a few 1e-4 of its mass, which later rounds match far away, and
// K5's cost, a difference of sums ~100x larger, moved 1.2e-3 from float64
// on a (1, 16384)^2 scan-like pair (an H100, chip_smoke.py).
constexpr int kSumBlock = 64;

// Add a partial sum of the other part (the same bits in both).
template <int kS>
__device__ __forceinline__ float combine(float v) {
  return kS == 1 ? v : v + __shfl_xor_sync(kFull, v, 16);
}

// Row sweep of round i over rows n0 + r * slots, r < kR (rows past N are
// computed on row N - 1 and not written).  The row's coordinates are
// loaded at scale s_(i-1) and scaled by `half` to s_i (1 when they are at
// s_i already); `inv_s` is 1 / s_i.
//   kA: step A of round i, ratio_l = remain_l / (1e-9 + sum_m w * remain_r),
//       stored with the row's coordinates at s_i;
//   kC: step C, this round's match row mass t = sum_m w' * ratio_r into
//       remain_l and, for K5, R and V (sum_m w' * ratio_r * y), for K4, E
//       (sum_m w' * ratio_r * d); w' is the weight of round i-1 when kA
//       (ratio_r of round i-1 in yw.w; prev_weight), else of round i.
// With both, C's update of remain_l comes before A's ratio_l.
template <int kR, bool kA, bool kC, bool kU, bool kG, bool kSq>
__device__ void row_sweep(const State& s, int n0, int N, int M, float half, float inv_s) {
  using L = Layout<kU, kG>;
  float px[kR], py[kR], pz[kR], a[kR], t[kR], e0[kR], e1[kR], e2[kR];
  bool valid[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = n0 + r * L::kSlots;
    valid[r] = n < N;
    const float4 p = s.xw[valid[r] ? n : N - 1];
    px[r] = p.x * half; py[r] = p.y * half; pz[r] = p.z * half;
    a[r] = t[r] = e0[r] = e1[r] = e2[r] = 0.f;
  }
  const int share = (M + L::kS - 1) / L::kS, lo = L::part() * share;
  const int hi = min(M, lo + share);
  // the sums over partners m in [m_lo, m_hi), into sa, st, s0, s1, s2
  auto terms = [&](int m_lo, int m_hi, float (&sa)[kR], float (&st)[kR], float (&s0)[kR],
                   float (&s1)[kR], float (&s2)[kR]) {
    for (int m = m_lo; m < m_hi; ++m) {
      const float4 q = s.yw[m];  // q.w = ratio_r (kC)
      const float rr = kA ? s.remain_r[m] : 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float arg = neg_sq_dist(px[r], py[r], pz[r], q);
        const float w = ex2(arg);
        if (kA) sa[r] = fmaf(w, rr, sa[r]);
        if (kC) {
          const float wr = (kA ? prev_weight<kSq>(w, arg) : w) * q.w;
          st[r] += wr;
          if (kU) {
            s0[r] = fmaf(wr, q.x, s0[r]);
            s1[r] = fmaf(wr, q.y, s1[r]);
            s2[r] = fmaf(wr, q.z, s2[r]);
          } else {
            s0[r] = fmaf(wr, arg, s0[r]);  // d = -arg / s_i^2
          }
        }
      }
    }
  };
  if (!kG) {
    terms(lo, hi, a, t, e0, e1, e2);
  } else {
    for (int b0 = lo; b0 < hi; b0 += kSumBlock) {
      float pa[kR] = {}, pt[kR] = {}, p0[kR] = {}, p1[kR] = {}, p2[kR] = {};
      terms(b0, min(hi, b0 + kSumBlock), pa, pt, p0, p1, p2);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        a[r] += pa[r];
        t[r] += pt[r];
        e0[r] += p0[r];
        e1[r] += p1[r];
        e2[r] += p2[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    a[r] = combine<L::kS>(a[r]);
    t[r] = combine<L::kS>(t[r]);
    e0[r] = combine<L::kS>(e0[r]);
    if (kU) {
      e1[r] = combine<L::kS>(e1[r]);
      e2[r] = combine<L::kS>(e2[r]);
    }
    const int n = n0 + r * L::kSlots;
    if (!valid[r] || r % L::kS != L::part()) continue;
    float remain = s.remain_l[n];
    if (kC) {
      const float rl = s.xw[n].w;  // ratio_l of C's round
      const float mass = rl * t[r];
      remain = fmaxf(0.f, remain - mass);
      s.remain_l[n] = remain;
      if (kU) {
        s.R[n] += mass;
        s.V0[n] += rl * (e0[r] * inv_s);
        s.V1[n] += rl * (e1[r] * inv_s);
        s.V2[n] += rl * (e2[r] * inv_s);
      } else {
        s.E[n] += rl * (e0[r] * (-inv_s * inv_s));
      }
    }
    if (kA) s.xw[n] = make_float4(px[r], py[r], pz[r], remain / (a[r] + 1e-9f));
  }
}

// Column sweep (step B) of round i over columns m0 + k * slots, k < kK,
// with the coordinates at s_i: s = sum_n w * ratio_l (and, for U, sum_n w *
// ratio_l * x), then the column epilogue, which stores ratio_r with the
// column's coordinates scaled by `next` for the next row sweep.
template <int kK, bool kU, bool kG>
__device__ void col_sweep(const State& s, int m0, int N, int M, float next, float inv_s) {
  using L = Layout<kU, kG>;
  float qx[kK], qy[kK], qz[kK], acc[kK], a0[kK], a1[kK], a2[kK];
  bool valid[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int m = m0 + k * L::kSlots;
    valid[k] = m < M;
    const float4 q = s.yw[valid[k] ? m : M - 1];
    qx[k] = q.x; qy[k] = q.y; qz[k] = q.z;
    acc[k] = a0[k] = a1[k] = a2[k] = 0.f;
  }
  const int share = (N + L::kS - 1) / L::kS, lo = L::part() * share;
  const int hi = min(N, lo + share);
  // the sums over rows n in [n_lo, n_hi), into sc, s0, s1, s2
  auto terms = [&](int n_lo, int n_hi, float (&sc)[kK], float (&s0)[kK], float (&s1)[kK],
                   float (&s2)[kK]) {
    for (int n = n_lo; n < n_hi; ++n) {
      const float4 p = s.xw[n];  // p.w = ratio_l[n]
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float wl = ex2(neg_sq_dist(qx[k], qy[k], qz[k], p)) * p.w;
        sc[k] += wl;
        if (kU) {
          s0[k] = fmaf(wl, p.x, s0[k]);
          s1[k] = fmaf(wl, p.y, s1[k]);
          s2[k] = fmaf(wl, p.z, s2[k]);
        }
      }
    }
  };
  if (!kG) {
    terms(lo, hi, acc, a0, a1, a2);
  } else {
    for (int b0 = lo; b0 < hi; b0 += kSumBlock) {
      float pc[kK] = {}, p0[kK] = {}, p1[kK] = {}, p2[kK] = {};
      terms(b0, min(hi, b0 + kSumBlock), pc, p0, p1, p2);
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        acc[k] += pc[k];
        a0[k] += p0[k];
        a1[k] += p1[k];
        a2[k] += p2[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    acc[k] = combine<L::kS>(acc[k]);
    if (kU) {
      a0[k] = combine<L::kS>(a0[k]);
      a1[k] = combine<L::kS>(a1[k]);
      a2[k] = combine<L::kS>(a2[k]);
    }
    const int m = m0 + k * L::kSlots;
    if (!valid[k] || k % L::kS != L::part()) continue;
    const float rr = s.remain_r[m];
    const float sumr = acc[k] * rr;
    const float ratio_r = fminf(rr / (sumr + 1e-9f), 1.f) * rr;
    s.remain_r[m] = fmaxf(0.f, rr - sumr);
    if (kU) {
      s.C[m] += ratio_r * acc[k];
      s.U0[m] += ratio_r * (a0[k] * inv_s);
      s.U1[m] += ratio_r * (a1[k] * inv_s);
      s.U2[m] += ratio_r * (a2[k] * inv_s);
    }
    s.yw[m] = make_float4(qx[k] * next, qy[k] * next, qz[k] * next, ratio_r);
  }
}

// One sweep over the whole row (or column) cloud, pass by pass; a pass
// with fewer rows takes fewer rows a thread (the same in the whole block).
template <bool kA, bool kC, bool kU, bool kG, bool kSq = false>
__device__ void rows(const State& s, int N, int M, float half, float inv_s) {
  using L = Layout<kU, kG>;
  const int n0 = L::slot();
  for (int base = 0; base < N; base += L::kPass) {
    const int levels = min(L::kR, (N - base + L::kSlots - 1) / L::kSlots);
    if (levels >= 4) row_sweep<L::kR, kA, kC, kU, kG, kSq>(s, base + n0, N, M, half, inv_s);
    else if (levels == 3) row_sweep<3, kA, kC, kU, kG, kSq>(s, base + n0, N, M, half, inv_s);
    else if (levels == 2) row_sweep<2, kA, kC, kU, kG, kSq>(s, base + n0, N, M, half, inv_s);
    else row_sweep<1, kA, kC, kU, kG, kSq>(s, base + n0, N, M, half, inv_s);
  }
}

template <bool kU, bool kG>
__device__ void cols(const State& s, int N, int M, float next, float inv_s) {
  using L = Layout<kU, kG>;
  const int m0 = L::slot();
  for (int base = 0; base < M; base += L::kPass) {
    const int levels = min(L::kR, (M - base + L::kSlots - 1) / L::kSlots);
    if (levels >= 4) col_sweep<L::kR, kU, kG>(s, base + m0, N, M, next, inv_s);
    else if (levels == 3) col_sweep<3, kU, kG>(s, base + m0, N, M, next, inv_s);
    else if (levels == 2) col_sweep<2, kU, kG>(s, base + m0, N, M, next, inv_s);
    else col_sweep<1, kU, kG>(s, base + m0, N, M, next, inv_s);
  }
}

// The auction for one pair; returns the cost (the same in every thread)
// and, for K5, leaves R, V, C and U in the state (kG: in device memory).
template <bool kU, bool kG>
__device__ float auction(const State& s, const float* __restrict__ x,
                         const float* __restrict__ y, int N, int M) {
  constexpr int kT = Block<kG>::kThreads;
  const int tid = threadIdx.x;
  const float multi_l = N >= M ? 1.f : (float)(M / N);
  const float multi_r = N >= M ? (float)(N / M) : 1.f;
  for (int n = tid; n < N; n += kT) {
    s.xw[n] = make_float4(x[3 * n] * kScale0, x[3 * n + 1] * kScale0,
                          x[3 * n + 2] * kScale0, 0.f);
    s.remain_l[n] = multi_l;
    if (kU) s.R[n] = s.V0[n] = s.V1[n] = s.V2[n] = 0.f;
    else s.E[n] = 0.f;
  }
  for (int m = tid; m < M; m += kT) {
    s.yw[m] = make_float4(y[3 * m] * kScale0, y[3 * m + 1] * kScale0,
                          y[3 * m + 2] * kScale0, 0.f);
    s.remain_r[m] = multi_r;
    if (kU) s.C[m] = s.U0[m] = s.U1[m] = s.U2[m] = 0.f;
  }
  __syncthreads();

  // round 0: A, B; rounds 1-8: C(i-1) with A(i), B(i); then C(8).  Round
  // i's row sweep halves its rows' coordinates, its column sweep halves
  // the columns' for the next round (not after round 8: C(8) is at s_8).
  float inv_s = 1.f / kScale0;
  rows<true, false, kU, kG>(s, N, M, 1.f, inv_s);
  __syncthreads();
  cols<kU, kG>(s, N, M, 0.5f, inv_s);
  __syncthreads();
  for (int i = 1; i < 9; ++i) {
    inv_s *= 2.f;
    if (i >= kSquaresFrom) rows<true, true, kU, kG, true>(s, N, M, 0.5f, inv_s);
    else rows<true, true, kU, kG, false>(s, N, M, 0.5f, inv_s);
    __syncthreads();
    cols<kU, kG>(s, N, M, i < 8 ? 0.5f : 1.f, inv_s);
    __syncthreads();
  }
  rows<false, true, kU, kG>(s, N, M, 1.f, inv_s);
  __syncthreads();

  // round 9, level 0: w = 1 everywhere, so every sum over the partner cloud
  // is one block reduction, and its match is ratio_l[n] * ratio_r[m]; the
  // clouds are read again unscaled
  float a[1] = {0.f};
  for (int m = tid; m < M; m += kT) a[0] += s.remain_r[m];
  block_sum<kT>(a, s.red);
  const float suml = a[0] + 1e-9f;
  float b[4] = {0.f, 0.f, 0.f, 0.f};  // sum_n ratio_l, sum_n ratio_l * x
  for (int n = tid; n < N; n += kT) {
    const float rl = s.remain_l[n] / suml;
    set_weight(s.xw, n, rl);
    b[0] += rl;
    if (kU) {
      b[1] += rl * x[3 * n];
      b[2] += rl * x[3 * n + 1];
      b[3] += rl * x[3 * n + 2];
    }
  }
  block_sum<kT>(b, s.red);
  // sum_m ratio_r, sum_m ratio_r * y and sum_m ratio_r * |y|^2
  float cs[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int m = tid; m < M; m += kT) {
    const float q0 = y[3 * m], q1 = y[3 * m + 1], q2 = y[3 * m + 2];
    const float rr = s.remain_r[m];
    const float sumr = b[0] * rr;
    const float ratio_r = fminf(rr / (sumr + 1e-9f), 1.f) * rr;
    if (kU) {
      s.C[m] += ratio_r * b[0];
      s.U0[m] += ratio_r * b[1];
      s.U1[m] += ratio_r * b[2];
      s.U2[m] += ratio_r * b[3];
    }
    cs[0] += ratio_r;
    cs[1] += ratio_r * q0;
    cs[2] += ratio_r * q1;
    cs[3] += ratio_r * q2;
    cs[4] += ratio_r * (q0 * q0 + q1 * q1 + q2 * q2);
  }
  block_sum<kT>(cs, s.red);

  // the cost; each thread's rows and columns carry their own last updates
  float cost[1] = {0.f};
  for (int n = tid; n < N; n += kT) {
    const float p0 = x[3 * n], p1 = x[3 * n + 1], p2 = x[3 * n + 2];
    const float rl = s.xw[n].w;
    const float xx = p0 * p0 + p1 * p1 + p2 * p2;
    if (kU) {
      const float r = s.R[n] + rl * cs[0];
      const float v0 = s.V0[n] + rl * cs[1];
      const float v1 = s.V1[n] + rl * cs[2];
      const float v2 = s.V2[n] + rl * cs[3];
      s.R[n] = r;
      s.V0[n] = v0;
      s.V1[n] = v1;
      s.V2[n] = v2;
      cost[0] += xx * r - 2.f * (p0 * v0 + p1 * v1 + p2 * v2);
    } else {
      // rounds 0-8 as sum_m d * match, round 9 as rl * sum_m ratio_r * d
      cost[0] += s.E[n] + rl * (xx * cs[0] + cs[4] -
                                2.f * (p0 * cs[1] + p1 * cs[2] + p2 * cs[3]));
    }
  }
  if (kU)
    for (int m = tid; m < M; m += kT) {
      const float q0 = y[3 * m], q1 = y[3 * m + 1], q2 = y[3 * m + 2];
      cost[0] += (q0 * q0 + q1 * q1 + q2 * q2) * s.C[m];
    }
  block_sum<kT>(cost, s.red);
  return cost[0];
}

// The pair's state: carved from dynamic shared memory, or (kGlobal) from
// its slice of the workspace, with only the reduction scratch in shared
// memory.
template <bool kGlobal>
__device__ State pair_state(float* smem, float* work, long long pair, int N, int M,
                            bool residues) {
  if (!kGlobal) return carve(smem, N, M, residues);
  State s = carve(work + pair * state_floats(N, M, residues), N, M, residues);
  s.red = smem;
  return s;
}

template <bool kGlobal>
__global__ void __launch_bounds__(Block<kGlobal>::kThreads, 1)
emd_block_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                 float* __restrict__ out, int C, int N, int M, float* work) {
  extern __shared__ float4 smem4[];
  const long long pair = blockIdx.x;
  const State s = pair_state<kGlobal>(reinterpret_cast<float*>(smem4), work, pair, N, M, false);
  const long long i = pair / C, j = pair % C;
  const float cost = auction<false, kGlobal>(s, rows + i * N * 3, cols + j * M * 3, N, M);
  if (threadIdx.x == 0) out[pair] = cost;
}

template <bool kGlobal>
__global__ void __launch_bounds__(Block<kGlobal>::kThreads, 1)
emd_pair_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ cost, float* __restrict__ R,
                float* __restrict__ C, float* __restrict__ V,
                float* __restrict__ U, int N, int M, float* work) {
  extern __shared__ float4 smem4[];
  const long long b = blockIdx.x;
  const State s = pair_state<kGlobal>(reinterpret_cast<float*>(smem4), work, b, N, M, true);
  const float c = auction<true, kGlobal>(s, x + b * N * 3, y + b * M * 3, N, M);
  if (threadIdx.x == 0) cost[b] = c;
  for (int n = threadIdx.x; n < N; n += Block<kGlobal>::kThreads) {
    R[b * N + n] = s.R[n];
    V[(b * N + n) * 3 + 0] = s.V0[n];
    V[(b * N + n) * 3 + 1] = s.V1[n];
    V[(b * N + n) * 3 + 2] = s.V2[n];
  }
  for (int m = threadIdx.x; m < M; m += Block<kGlobal>::kThreads) {
    C[b * M + m] = s.C[m];
    U[(b * M + m) * 3 + 0] = s.U0[m];
    U[(b * M + m) * 3 + 1] = s.U1[m];
    U[(b * M + m) * 3 + 2] = s.U2[m];
  }
}

bool global_path(int N, int M) { return N > kSharedMaxPoints || M > kSharedMaxPoints; }

// Whether a launch of `pairs` pairs can run: a one-dimensional grid, and on
// the device-memory path a workspace of at least state_floats a pair.
bool shape_ok(long long pairs, int N, int M, const float* work, long long work_floats,
              bool residues) {
  if (pairs < 1 || pairs > 0x7fffffffLL || N < 1 || M < 1) return false;
  return !global_path(N, M) ||
         (work != nullptr && work_floats / pairs >= state_floats(N, M, residues));
}

// Set the kernel's dynamic shared memory and return the bytes to launch
// with: the whole state, or (device-memory path) the reduction scratch.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int N, int M, bool residues, size_t* bytes) {
  *bytes = global_path(N, M) ? kReduceBytes : shared_bytes(N, M, residues);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

}  // namespace

extern "C" {

// rows (R, N, 3), cols (C, M, 3), out (R, C): contiguous float32 on the
// current device.  Launches R*C blocks on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape beyond the limits).
// Above kSharedMaxPoints points a cloud, `work` holds at least
// state_floats(N, M, false) floats for each of the R*C pairs
// (metrics/emd_cuda.py::state_floats); below it, `work` is not read and
// may be null.
int emd_block_launch(const float* rows, const float* cols, float* out, int R,
                     int C, int N, int M, float* work, long long work_floats,
                     void* stream) {
  const long long pairs = (long long)R * C;
  if (!shape_ok(pairs, N, M, work, work_floats, false)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t bytes = 0;
  if (global_path(N, M)) {
    cudaError_t err = prepare(emd_block_kernel<true>, N, M, false, &bytes);
    if (err != cudaSuccess) return (int)err;
    emd_block_kernel<true><<<(unsigned)pairs, Block<true>::kThreads, bytes, st>>>(
        rows, cols, out, C, N, M, work);
  } else {
    cudaError_t err = prepare(emd_block_kernel<false>, N, M, false, &bytes);
    if (err != cudaSuccess) return (int)err;
    emd_block_kernel<false><<<(unsigned)pairs, Block<false>::kThreads, bytes, st>>>(
        rows, cols, out, C, N, M, nullptr);
  }
  return (int)cudaGetLastError();
}

// x (B, N, 3), y (B, M, 3) matched 1:1; cost (B), R (B, N), C (B, M),
// V (B, N, 3), U (B, M, 3): contiguous float32 on the current device.
// `work` as for emd_block_launch, with state_floats(N, M, true) a pair.
int emd_pair_launch(const float* x, const float* y, float* cost, float* R,
                    float* C, float* V, float* U, int B, int N, int M,
                    float* work, long long work_floats, void* stream) {
  if (!shape_ok(B, N, M, work, work_floats, true)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t bytes = 0;
  if (global_path(N, M)) {
    cudaError_t err = prepare(emd_pair_kernel<true>, N, M, true, &bytes);
    if (err != cudaSuccess) return (int)err;
    emd_pair_kernel<true><<<(unsigned)B, Block<true>::kThreads, bytes, st>>>(
        x, y, cost, R, C, V, U, N, M, work);
  } else {
    cudaError_t err = prepare(emd_pair_kernel<false>, N, M, true, &bytes);
    if (err != cudaSuccess) return (int)err;
    emd_pair_kernel<false><<<(unsigned)B, Block<false>::kThreads, bytes, st>>>(
        x, y, cost, R, C, V, U, N, M, nullptr);
  }
  return (int)cudaGetLastError();
}

const char* emd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
