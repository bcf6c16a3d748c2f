// Fused field multiply for BLS12-381 limb planes on Hopper (sm_90a).
//
// Replaces the reference's only Pallas kernel, lighthouse_tpu/ops/bls/
// pallas_kernels.py:_build_call (its pl.pallas_call), as entered through
// fused_mul (fq.mont_mul / fq.mont_mul_lazy) and execute_plan
// (plans.execute). It computes the same function, not a block-by-block copy:
//
//   int64 limbs [rows, L, 25] (a, b; plus n_pass raw rows of a)
//     -> base-2^8 digits [L, 51] per operand (overlap-added, as fq.to_digits)
//     -> 51x51 digit convolution per lane          -> [L, 101]
//     -> pre-schedule (split / trim / fold ops)     -> [L, w]
//     -> optional output map: pos - neg + oconst    -> [R, w]
//     -> post-schedule                              -> [R, <= 50]
//     -> int64 limbs [rows, R, 25] (limb i = d[2i] + (d[2i+1] << 8))
//
// The schedule is static per call site and decided on the host from exact
// bounds (fused_mul.py): it proves every intermediate below 2^24, so the
// arithmetic here is exact in int32 registers and shared memory (the
// reference needs Precision.HIGHEST to keep its f32 MXU passes exact; integer
// arithmetic makes that question moot).
//
// What bounds it on the H100: neither bytes nor int32 operations at the
// shapes the verify path gives it (a few to a few thousand rows per launch);
// a launch is a few microseconds of fixed cost. The design keeps everything
// after the input lincombs inside ONE launch per field op, with all planes in
// shared memory; one block per row, threads striding over (lane, digit).
// Op encoding: code | (arg << 8); code 0 = split, 1 = trim to width arg,
// 2 = fold arg digits at positions >= 48 through the 2^(8(48+h)) mod p rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 51;         // digits per 25-limb element
constexpr int kConvD = 101;    // conv output digit positions
constexpr int kFoldBase = 48;  // digit position of 2^384
constexpr int kLimbs = 25;

__device__ __forceinline__ int digit_of(const int64_t* x, int d) {
  const int i = d >> 1;
  if (d & 1) return static_cast<int>((x[i] >> 8) & 0xFF);
  int v = (i < kLimbs) ? static_cast<int>(x[i] & 0xFF) : 0;
  if (i >= 1) v += static_cast<int>(x[i - 1] >> 16);
  return v;
}

// Replay n_ops schedule ops on nplanes digit planes of width w (stride wmax),
// ping-ponging between cur and nxt. Returns the final width; cur then holds
// the result. Entry and exit are block-synchronized.
__device__ int replay(const int* __restrict__ ops, int n_ops, int*& cur,
                      int*& nxt, int nplanes, int w, int wmax,
                      const int* __restrict__ f8) {
  for (int k = 0; k < n_ops; ++k) {
    const int op = ops[k];
    const int code = op & 0xFF;
    const int arg = op >> 8;
    if (code == 1) {  // trim: the dropped digits are provably zero
      w = arg;
      continue;
    }
    if (code == 0) {  // split: d -> (d & 0xFF) + (d_{i-1} >> 8), width + 1
      const int nw = w + 1;
      for (int idx = threadIdx.x; idx < nplanes * nw; idx += blockDim.x) {
        const int p = idx / nw;
        const int i = idx - p * nw;
        const int* t = cur + p * wmax;
        nxt[p * wmax + i] =
            (i < w ? (t[i] & 0xFF) : 0) + (i >= 1 ? (t[i - 1] >> 8) : 0);
      }
      w = nw;
    } else {  // fold: positions >= 48 through the digit rows of 2^(8k) mod p
      for (int idx = threadIdx.x; idx < nplanes * kFoldBase;
           idx += blockDim.x) {
        const int p = idx / kFoldBase;
        const int i = idx - p * kFoldBase;
        const int* t = cur + p * wmax;
        int v = t[i];
        for (int h = 0; h < arg; ++h) v += t[kFoldBase + h] * f8[h * kFoldBase + i];
        nxt[p * wmax + i] = v;
      }
      w = kFoldBase;
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return w;
}

__global__ void fused_mul_kernel(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b,
    const int64_t* __restrict__ ain, const int* __restrict__ f8,
    const int* __restrict__ mpos, const int* __restrict__ mneg,
    const int* __restrict__ oconst, const int* __restrict__ ops,
    int64_t* __restrict__ out, int L, int n_pass, int R, int has_out,
    int has_neg, int n_pre, int n_post, int wmax) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int slots = max(L + n_pass, R);
  int* dA = smem;
  int* dB = dA + L * kD;
  int* cur = dB + L * kD;
  int* nxt = cur + slots * wmax;

  const int64_t* ar = a + static_cast<size_t>(row) * L * kLimbs;
  const int64_t* br = b + static_cast<size_t>(row) * L * kLimbs;
  for (int idx = threadIdx.x; idx < L * kD; idx += blockDim.x) {
    const int l = idx / kD;
    const int d = idx - l * kD;
    dA[idx] = digit_of(ar + l * kLimbs, d);
    dB[idx] = digit_of(br + l * kLimbs, d);
  }
  __syncthreads();

  // digit convolution: T[l][d] = sum_{i+j=d} A[l][i] * B[l][j]
  for (int idx = threadIdx.x; idx < L * kConvD; idx += blockDim.x) {
    const int l = idx / kConvD;
    const int d = idx - l * kConvD;
    const int lo = d > kD - 1 ? d - (kD - 1) : 0;
    const int hi = d < kD - 1 ? d : kD - 1;
    const int* pa = dA + l * kD;
    const int* pb = dB + l * kD;
    int s = 0;
    for (int i = lo; i <= hi; ++i) s += pa[i] * pb[d - i];
    cur[l * wmax + d] = s;
  }
  __syncthreads();

  int w = replay(ops, n_pre, cur, nxt, L, kConvD, wmax, f8);
  int nplanes = L;
  if (has_out) {
    if (n_pass) {  // raw rows of a as digit planes, zero above digit 50
      const int64_t* pr = ain + static_cast<size_t>(row) * n_pass * kLimbs;
      for (int idx = threadIdx.x; idx < n_pass * w; idx += blockDim.x) {
        const int j = idx / w;
        const int d = idx - j * w;
        cur[(L + j) * wmax + d] = d < kD ? digit_of(pr + j * kLimbs, d) : 0;
      }
      __syncthreads();
    }
    const int nin = L + n_pass;
    for (int idx = threadIdx.x; idx < R * w; idx += blockDim.x) {
      const int r = idx / w;
      const int d = idx - r * w;
      const int* cp = mpos + r * nin;
      const int* cn = mneg + r * nin;
      int pos = 0;
      int neg = 0;
      for (int j = 0; j < nin; ++j) {
        const int x = cur[j * wmax + d];
        pos += cp[j] * x;
        if (has_neg) neg += cn[j] * x;
      }
      nxt[r * wmax + d] = has_neg ? pos + (oconst[r * w + d] - neg) : pos;
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    w = replay(ops + n_pre, n_post, cur, nxt, R, w, wmax, f8);
    nplanes = R;
  }

  int64_t* orow = out + static_cast<size_t>(row) * nplanes * kLimbs;
  for (int idx = threadIdx.x; idx < nplanes * kLimbs; idx += blockDim.x) {
    const int p = idx / kLimbs;
    const int i = idx - p * kLimbs;
    const int d0 = 2 * i < w ? cur[p * wmax + 2 * i] : 0;
    const int d1 = 2 * i + 1 < w ? cur[p * wmax + 2 * i + 1] : 0;
    orow[idx] = static_cast<int64_t>(d0) + (static_cast<int64_t>(d1) << 8);
  }
}

}  // namespace

extern "C" int lh_fused_mul_smem_bytes(int L, int n_pass, int R, int wmax) {
  const int slots = (L + n_pass) > R ? (L + n_pass) : R;
  return static_cast<int>((2 * L * kD + 2 * slots * wmax) * sizeof(int));
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int lh_fused_mul(const void* a, const void* b, const void* ain,
                            const void* f8, const void* mpos, const void* mneg,
                            const void* oconst, const void* ops, void* out,
                            int rows, int L, int n_pass, int R, int has_out,
                            int has_neg, int n_pre, int n_post, int wmax,
                            void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = lh_fused_mul_smem_bytes(L, n_pass, R, wmax);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const int threads = L * kConvD >= 256 ? 256 : 128;
  fused_mul_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<const int64_t*>(ain), static_cast<const int*>(f8),
      static_cast<const int*>(mpos), static_cast<const int*>(mneg),
      static_cast<const int*>(oconst), static_cast<const int*>(ops),
      static_cast<int64_t*>(out), L, n_pass, R, has_out, has_neg, n_pre,
      n_post, wmax);
  return static_cast<int>(cudaGetLastError());
}
