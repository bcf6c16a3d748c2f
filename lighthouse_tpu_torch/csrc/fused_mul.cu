// Fused field multiply for BLS12-381 limb planes on Hopper (sm_90a): the plan
// kernel and the chain kernel.
//
// Replaces the reference's only Pallas kernel, lighthouse_tpu/ops/bls/
// pallas_kernels.py:_build_call (its pl.pallas_call), as entered through
// fused_mul (fq.mont_mul / fq.mont_mul_lazy) and execute_plan
// (plans.execute). It computes the same function, not a block-by-block copy.
// One multiply step ("plan step") of a row:
//
//   raw int64 limbs a [n_a, 25], b [n_b, 25] (+ the plan's constant pool)
//     -> input lincombs: lane l operand = sum_j c_lj x_j + C_l (int64, exact;
//        the signed coefficient lists and borrow constants of plans.py)
//     -> base-2^8 digits [L, 51] per operand (overlap-added, as fq.to_digits)
//     -> 51x51 digit convolution per lane          -> [L, 101]
//     -> pre-schedule (split / trim / fold ops)     -> [L, w]
//     -> optional output map: sum_j c_rj plane_j + oconst_r -> [R, w]
//        (planes j >= L are pass-through digit rows of the raw a)
//     -> post-schedule                              -> [R, <= 50]
//     -> int64 limbs [R, 25] (limb i = d[2i] + (d[2i+1] << 8))
//
// The schedule is static per call site and decided on the host from exact
// bounds (fused_mul.py): every intermediate digit is proved below 2^24, so
// the digit arithmetic is exact in int32 (the reference needs
// Precision.HIGHEST to keep its f32 MXU passes exact; integer arithmetic
// makes that question moot). The lincombs are int64 under the 2^63 bounds
// plans.lincomb_tables proves.
//
// What bounds it on the H100: neither bytes nor int32 operations at the
// verify path's shapes (1 to a few hundred rows, 1 to 54 lanes): latency.
// A step is a chain of dependent phases (lincomb, digits, conv, a dozen
// schedule ops, output map), so the design shortens that chain and stops
// paying a launch per step:
//   * a warp owns a lane from its lincomb to the end of its pre-schedule
//     (and an output row through its post-schedule): every phase inside is
//     ordered by __syncwarp, never by a block barrier; each thread keeps 4
//     conv outputs in registers, summed in ONE uniform 51-step loop over a
//     zero-padded B digit row (four independent chains, no divergent
//     anti-diagonal bounds);
//   * the lanes of a row are split over a thread-block cluster of C CTAs
//     (C = 1, 2, 4 or 8, picked on the host from rows x L against the 132
//     SMs, at least 4 lanes per CTA): each CTA runs the lincombs, conv and
//     pre-schedule of its lanes in its own shared memory; after
//     cluster.sync() it copies every lane plane of the row through
//     distributed shared memory (map_shared_rank, 16-byte loads) and runs
//     its share of the output rows from local shared memory;
//   * the chain kernel runs a whole fixed-exponent chain (a static step
//     program) in ONE launch, its accumulator and table resident in shared
//     memory, replicated in every CTA of the cluster; only the base is read
//     from HBM and only the result is written back.
// The conv stays on the int32 CUDA cores: each lane has its own Toeplitz
// operand (M = 1 per lane), and digits reach 255 + 63, above int8.
//
// Op encoding: code | (arg << 8); code 0 = split, 1 = trim to width arg,
// 2 = fold arg digits at positions >= 48 through the 2^(8(48+h)) mod p rows.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 51;         // digits per 25-limb element
constexpr int kConvD = 101;    // conv output digit positions
constexpr int kFoldBase = 48;  // digit position of 2^384
constexpr int kLimbs = 25;
constexpr int kWMax = 128;     // widest digit plane a thread set covers (4 x 32)
// per-warp scratch, in int32 words: A digits, zero-padded B digits (index
// 50 + k holds digit k; zeros at 0..49 and 101..177), two int64 limb rows,
// one output-row plane
constexpr int kScrA = 0;
constexpr int kScrB = 64;
constexpr int kScrLimbs = 244;  // 8-byte aligned: 244 * 4 = 976
constexpr int kScrRow = kScrLimbs + 128;
constexpr int kScrWords = kScrRow + kWMax;  // 500

}  // namespace

// One static plan signature (mirrors fused_mul.py:_PlanDesc). ints holds the
// schedule ops and the signed (index, coefficient) lists, i64 the borrow
// constants and the constant pool; offsets index those arrays.
struct PlanDesc {
  const int* ints;
  const long long* i64;
  int L, R, n_a, n_b, has_out, n_pre, n_post, w_mid, wmax;
  int off_ops;     // n_pre + n_post encoded ops
  int off_la;      // A lists: L + 1 row starts (absolute ints offsets)
  int off_lb;      // B lists (indices >= n_b address the pool)
  int off_out;     // output-map lists: R + 1 row starts (index j >= L: the
                   // pass-through row j - L of a)
  int off_oconst;  // [R, w_mid] digit borrow constants
  int off_ca;      // [L, 25] A borrow constants
  int off_cb;      // [L, 25] B borrow constants
  int off_pool;    // [n_pool, 25] constant pool (B inputs n_b ...)
};

// A fixed-exponent chain as a step program (mirrors fused_mul.py:_ChainArgs).
// Step s is prog[s * step_len + ...] = {desc, dst, src_a, src_b[n_chains]};
// desc = -1 copies src_b[chain] into dst. Row r belongs to chain r / batch.
struct ChainArgs {
  PlanDesc d[2];
  const int* prog;
  const long long* one;  // [n_el, 25] multiplicative identity (slot_one)
  int n_steps, step_len, batch;
  int n_el, n_state, slot_one, slot_base, slot_acc;
};

namespace {

// Digit planes sit at a stride of wmax rounded up to 4 words (16 bytes).
__device__ __forceinline__ int plane_stride(const PlanDesc& d) { return (d.wmax + 3) & ~3; }

__device__ __forceinline__ int digit_of(const int64_t* x, int d) {
  const int i = d >> 1;
  if (d & 1) return static_cast<int>((x[i] >> 8) & 0xFF);
  int v = (i < kLimbs) ? static_cast<int>(x[i] & 0xFF) : 0;
  if (i >= 1) v += static_cast<int>(x[i - 1] >> 16);
  return v;
}

// Replay n_ops schedule ops on one digit plane of width w, in place, by one
// warp (thread t owns digits t, t+32, t+64, t+96). Returns the final width.
__device__ int replay_warp(const int* ops, int n_ops, int* pl, int w,
                           const int* f8) {
  const int t = threadIdx.x & 31;
  for (int k = 0; k < n_ops; ++k) {
    const int op = ops[k];
    const int code = op & 0xFF;
    const int arg = op >> 8;
    if (code == 1) {  // trim: the dropped digits are provably zero
      w = arg;
      continue;
    }
    int v[4];
    if (code == 0) {  // split: d -> (d & 0xFF) + (d_{i-1} >> 8), width + 1
      const int nw = w + 1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = t + 32 * q;
        v[q] = 0;
        if (i < nw) {
          if (i < w) v[q] = pl[i] & 0xFF;
          if (i >= 1) v[q] += pl[i - 1] >> 8;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = t + 32 * q;
        if (i < nw) pl[i] = v[q];
      }
      w = nw;
    } else {  // fold: positions >= 48 through the digit rows of 2^(8k) mod p
      // thread t owns positions t and t + 32 (< 48): two independent sums
      const int i1 = t < kFoldBase - 32 ? t + 32 : t;
      int s0 = pl[t];
      int s1 = pl[i1];
#pragma unroll 4
      for (int h = 0; h < arg; ++h) {
        const int x = pl[kFoldBase + h];
        s0 += x * f8[h * kFoldBase + t];
        s1 += x * f8[h * kFoldBase + i1];
      }
      v[0] = s0;
      v[1] = s1;
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = t + 32 * q;
        if (i < kFoldBase) pl[i] = v[q];
      }
      w = kFoldBase;
    }
    __syncwarp();
  }
  return w;
}

// 50 digits of a plane (zero at and above width w) as 25 int64 limbs.
__device__ __forceinline__ void write_limbs(const int* pl, int w, int64_t* out) {
  const int t = threadIdx.x & 31;
  if (t < kLimbs) {
    const int d0 = 2 * t < w ? pl[2 * t] : 0;
    const int d1 = 2 * t + 1 < w ? pl[2 * t + 1] : 0;
    out[t] = static_cast<int64_t>(d0) + (static_cast<int64_t>(d1) << 8);
  }
}

// lincomb of one lane: x[t] = C[t] + sum (j, c) c * in_j[t], where in_j is
// a row of `lo` for j < n_lo and of `hi` (the constant pool) above.
__device__ __forceinline__ int64_t lincomb_limb(const int* ints, int k0, int k1,
                                                const int64_t* cst,
                                                const int64_t* lo, int n_lo,
                                                const long long* hi, int t) {
  int64_t x = cst[t];
  for (int k = k0; k < k1; k += 2) {
    const int j = ints[k];
    const int64_t c = ints[k + 1];
    const int64_t v = j < n_lo ? lo[j * kLimbs + t]
                               : static_cast<int64_t>(hi[(j - n_lo) * kLimbs + t]);
    x += c * v;
  }
  return x;
}

// Phase 1 of a plan step: lanes [l0, l1) of the row, one warp per lane:
// lincombs, digits, conv, pre-schedule. Lane l's plane lands at
// planes[(l - l0) * plane_stride]. Without an output map the lane's limbs go
// to out[l * 25] (then L == R).
__device__ void lane_phase(const PlanDesc& d, const int64_t* a, const int64_t* b,
                           int l0, int l1, int* planes, int* scr,
                           const int* f8, int64_t* out) {
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int t = threadIdx.x & 31;
  int* dA = scr + warp * kScrWords + kScrA;
  int* dB = scr + warp * kScrWords + kScrB;
  int64_t* la = reinterpret_cast<int64_t*>(scr + warp * kScrWords + kScrLimbs);
  int64_t* lb = la + 32;
  const int* ints = d.ints;
  const int64_t* ca = reinterpret_cast<const int64_t*>(d.i64 + d.off_ca);
  const int64_t* cb = reinterpret_cast<const int64_t*>(d.i64 + d.off_cb);
  const long long* pool = d.i64 + d.off_pool;
  for (int l = l0 + warp; l < l1; l += nw) {
    if (t < kLimbs) {
      la[t] = lincomb_limb(ints, ints[d.off_la + l], ints[d.off_la + l + 1],
                           ca + l * kLimbs, a, d.n_a, nullptr, t);
      lb[t] = lincomb_limb(ints, ints[d.off_lb + l], ints[d.off_lb + l + 1],
                           cb + l * kLimbs, b, d.n_b, pool, t);
    }
    __syncwarp();
    for (int k = t; k < kD; k += 32) {
      dA[k] = digit_of(la, k);
      dB[50 + k] = digit_of(lb, k);
    }
    __syncwarp();
    // conv: outputs d = t + 32q, four independent sums over one uniform
    // loop; the zero margins of dB absorb every out-of-range term
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      const int x = dA[i];
      s0 += x * dB[50 + t - i];
      s1 += x * dB[82 + t - i];
      s2 += x * dB[114 + t - i];
      s3 += x * dB[146 + t - i];
    }
    int* pl = planes + (l - l0) * plane_stride(d);
    pl[t] = s0;
    pl[32 + t] = s1;
    pl[64 + t] = s2;
    if (96 + t < kConvD) pl[96 + t] = s3;
    __syncwarp();
    const int w = replay_warp(ints + d.off_ops, d.n_pre, pl, kConvD, f8);
    if (!d.has_out) write_limbs(pl, w, out + l * kLimbs);
    __syncwarp();
  }
}

// Between the phases of a cluster: copy every lane plane of the row (lane j
// lives in the CTA of cluster rank j / Lc) into this CTA's `all`, 16 bytes
// per load through distributed shared memory, so the output map then reads
// local shared memory only. Block-synchronized on exit.
__device__ void gather_planes(const PlanDesc& d, const int* planes, int Lc,
                              int rank, int* all) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ps = plane_stride(d);
  const int nv = (d.w_mid + 3) >> 2;
  for (int idx = threadIdx.x; idx < d.L * nv; idx += blockDim.x) {
    const int j = idx / nv;
    const int v = idx - j * nv;
    const int owner = j / Lc;
    const int* src = planes + (j - owner * Lc) * ps + 4 * v;
    if (owner != rank) src = cluster.map_shared_rank(const_cast<int*>(src), owner);
    *reinterpret_cast<int4*>(all + j * ps + 4 * v) = *reinterpret_cast<const int4*>(src);
  }
  __syncthreads();
}

// Phase 2 of a plan step: output rows r = r0, r0 + rstep, ... one warp per
// row: the output map over every lane plane (all[j * plane_stride], local)
// and the pass-through rows of a, then the post-schedule.
__device__ void row_phase(const PlanDesc& d, const int64_t* a, const int* all,
                          int r0, int rstep, int* scr, const int* f8, int64_t* out) {
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int t = threadIdx.x & 31;
  int* row = scr + warp * kScrWords + kScrRow;
  const int* ints = d.ints;
  const int w = d.w_mid;
  const int ps = plane_stride(d);
  for (int r = r0 + warp * rstep; r < d.R; r += nw * rstep) {
    const int k0 = ints[d.off_out + r];
    const int k1 = ints[d.off_out + r + 1];
    const int* oc = ints + d.off_oconst + r * w;
    int v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = (t + 32 * q < w) ? oc[t + 32 * q] : 0;
    for (int k = k0; k < k1; k += 2) {
      const int j = ints[k];
      const int c = ints[k + 1];
      if (j < d.L) {
        const int* pl = all + j * ps;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (t + 32 * q < w) v[q] += c * pl[t + 32 * q];
      } else {
        const int64_t* x = a + (j - d.L) * kLimbs;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int dd = t + 32 * q;
          if (dd < w && dd < kD) v[q] += c * digit_of(x, dd);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (t + 32 * q < w) row[t + 32 * q] = v[q];
    __syncwarp();
    const int wo = replay_warp(ints + d.off_ops + d.n_pre, d.n_post, row, w, f8);
    write_limbs(row, wo, out + r * kLimbs);
    __syncwarp();
  }
}

__device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ void zero_margins(int* scr) {
  const int nw = blockDim.x >> 5;
  for (int i = threadIdx.x; i < nw * kScrWords; i += blockDim.x) scr[i] = 0;
}

__global__ void plan_kernel(PlanDesc d, const int64_t* __restrict__ a,
                            long long a_rs, long long a_es,
                            const int64_t* __restrict__ b, long long b_rs,
                            long long b_es, int64_t* __restrict__ out,
                            const int* __restrict__ f8, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long row = blockIdx.x / C;
  const int Lc = (d.L + C - 1) / C;
  int64_t* sa = reinterpret_cast<int64_t*>(smem);
  int64_t* sb = sa + d.n_a * kLimbs;
  int* planes = reinterpret_cast<int*>(
      smem + align16(static_cast<size_t>(d.n_a + d.n_b) * kLimbs * 8));
  int* all = planes + Lc * plane_stride(d);  // the gathered planes (C > 1)
  int* scr = all + (C > 1 ? d.L * plane_stride(d) : 0);
  for (int i = threadIdx.x; i < d.n_a * kLimbs; i += blockDim.x) {
    const int j = i / kLimbs;
    sa[i] = a[row * a_rs + j * a_es + (i - j * kLimbs)];
  }
  for (int i = threadIdx.x; i < d.n_b * kLimbs; i += blockDim.x) {
    const int j = i / kLimbs;
    sb[i] = b[row * b_rs + j * b_es + (i - j * kLimbs)];
  }
  zero_margins(scr);
  __syncthreads();
  int64_t* orow = out + row * d.R * kLimbs;
  const int l0 = rank * Lc;
  const int l1 = min(d.L, l0 + Lc);
  lane_phase(d, sa, sb, l0, l1, planes, scr, f8, orow);
  if (!d.has_out) return;
  if (C > 1) {
    cg::this_cluster().sync();
    gather_planes(d, planes, Lc, rank, all);
  } else {
    __syncthreads();
    all = planes;
  }
  row_phase(d, sa, all, rank, C, scr, f8, orow);
  // keep this CTA's planes alive until every peer has copied them
  if (C > 1) cg::this_cluster().sync();
}

__global__ void chain_kernel(ChainArgs g, const int64_t* __restrict__ base,
                             int64_t* __restrict__ out,
                             const int* __restrict__ f8g, int C, int lane_words,
                             int all_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int row = blockIdx.x / C;
  const int chain = row / g.batch;
  const int el = g.n_el * kLimbs;  // int64 words per state slot
  int64_t* state = reinterpret_cast<int64_t*>(smem);
  int64_t* res = state + g.n_state * el;
  int* f8 = reinterpret_cast<int*>(
      smem + align16(static_cast<size_t>(g.n_state + 1) * el * 8));
  int* planes = f8 + 64 * kFoldBase;  // two buffers of lane_words
  int* all = planes + 2 * lane_words;  // the gathered planes (C > 1)
  int* scr = all + all_words;
  for (int i = threadIdx.x; i < 64 * kFoldBase; i += blockDim.x) f8[i] = f8g[i];
  for (int i = threadIdx.x; i < el; i += blockDim.x) {
    state[g.slot_base * el + i] = base[static_cast<long long>(row) * el + i];
    if (g.slot_one >= 0) state[g.slot_one * el + i] = g.one[i];
  }
  zero_margins(scr);
  __syncthreads();
  int buf = 0;
  for (int s = 0; s < g.n_steps; ++s) {
    const int* st = g.prog + s * g.step_len;
    const int di = st[0];
    const int dst = st[1];
    const int src_b = st[3 + chain];
    if (di < 0) {  // gather: a table slot picked per chain
      for (int i = threadIdx.x; i < el; i += blockDim.x)
        state[dst * el + i] = state[src_b * el + i];
      __syncthreads();
      continue;
    }
    const PlanDesc& d = g.d[di];
    const int64_t* a = state + st[2] * el;
    const int64_t* b = state + src_b * el;
    const int Lc = (d.L + C - 1) / C;
    const int l0 = rank * Lc;
    int* pl = planes + buf * lane_words;
    lane_phase(d, a, b, l0, min(d.L, l0 + Lc), pl, scr, f8, res);
    if (d.has_out) {
      const int* src = pl;
      if (C > 1) {
        cg::this_cluster().sync();
        gather_planes(d, pl, Lc, rank, all);
        src = all;
      } else {
        __syncthreads();
      }
      // every CTA computes every output row: the state stays replicated
      row_phase(d, a, src, 0, 1, scr, f8, res);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d.R * kLimbs; i += blockDim.x) state[dst * el + i] = res[i];
    __syncthreads();
    buf ^= 1;  // a peer may still copy this step's planes until the next sync
  }
  if (rank == 0)
    for (int i = threadIdx.x; i < el; i += blockDim.x)
      out[static_cast<long long>(row) * el + i] = state[g.slot_acc * el + i];
  if (C > 1) cg::this_cluster().sync();
}

size_t plan_scr_bytes(int threads) { return static_cast<size_t>(threads / 32) * kScrWords * 4; }

// The dynamic shared-memory opt-in is an attribute of the kernel on the
// CURRENT device, so each kernel keeps the size it configured per device
// (0 = not yet configured there: the 48 KiB every launch may take unasked).
constexpr int kMaxDevices = 64;

template <typename K>
int configure(K kernel, size_t smem, size_t (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const size_t have = configured[dev] ? configured[dev] : size_t(48 * 1024);
  if (smem > have) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = smem;
  }
  return 0;
}

cudaLaunchConfig_t launch_config(int grid, int threads, size_t smem, void* stream,
                                 cudaLaunchAttribute* attr, int C) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Dynamic shared memory of one plan-kernel CTA (the host checks it against
// the 227 KB launch limit before the first launch).
extern "C" long long lh_plan_smem_bytes(int n_a, int n_b, int L, int Lc, int wmax,
                                        int C, int threads) {
  const size_t io = (static_cast<size_t>(n_a + n_b) * kLimbs * 8 + 15) & ~size_t(15);
  const size_t ps = (wmax + 3) & ~3;
  return static_cast<long long>(io + (Lc + (C > 1 ? L : 0)) * ps * 4 +
                                plan_scr_bytes(threads));
}

extern "C" long long lh_chain_smem_bytes(int n_state, int n_el, int lane_words,
                                         int all_words, int threads) {
  const size_t el = static_cast<size_t>(n_el) * kLimbs * 8;
  const size_t st = ((n_state + 1) * el + 15) & ~size_t(15);
  return static_cast<long long>(st + 64 * kFoldBase * 4 +
                                (2 * static_cast<size_t>(lane_words) + all_words) * 4 +
                                plan_scr_bytes(threads));
}

// Launch on `stream`; returns the launch's CUDA error (0 = launched).
extern "C" int lh_plan_launch(const PlanDesc* desc, const void* a, long long a_rs,
                              long long a_es, const void* b, long long b_rs,
                              long long b_es, void* out, const void* f8, int rows,
                              int C, int threads, long long smem, void* stream) {
  if (rows <= 0) return 0;
  static size_t configured[kMaxDevices] = {};
  int e = configure(plan_kernel, static_cast<size_t>(smem), configured);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(rows * C, threads, smem, stream, attr, C);
  e = cudaLaunchKernelEx(&cfg, plan_kernel, *desc, static_cast<const int64_t*>(a), a_rs,
                         a_es, static_cast<const int64_t*>(b), b_rs, b_es,
                         static_cast<int64_t*>(out), static_cast<const int*>(f8), C);
  if (e) return e;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh_chain_launch(const ChainArgs* args, const void* base, void* out,
                               const void* f8, int rows, int C, int threads,
                               int lane_words, int all_words, long long smem,
                               void* stream) {
  if (rows <= 0) return 0;
  static size_t configured[kMaxDevices] = {};
  int e = configure(chain_kernel, static_cast<size_t>(smem), configured);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(rows * C, threads, smem, stream, attr, C);
  e = cudaLaunchKernelEx(&cfg, chain_kernel, *args, static_cast<const int64_t*>(base),
                         static_cast<int64_t*>(out), static_cast<const int*>(f8), C,
                         lane_words, all_words);
  if (e) return e;
  return static_cast<int>(cudaGetLastError());
}

// sizeof checks for the ctypes mirrors
extern "C" int lh_plan_desc_size() { return static_cast<int>(sizeof(PlanDesc)); }
extern "C" int lh_chain_args_size() { return static_cast<int>(sizeof(ChainArgs)); }
