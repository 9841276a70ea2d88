// PnP-RANSAC's damped Gauss-Newton refinement for Hopper (sm_90a): the
// hypotheses' refinement and the best hypothesis's polish, each one launch.
//
// It replaces no Pallas kernel. The JAX package's refinement
// (visual_odom_tpu/backend/pnp.py `_gn_refine`, with core/linalg.py
// `solve_spd` and core/lie.py `rodrigues` / `rodrigues_inverse`) is
// elementwise code that XLA fuses. The port's plain twin
// (visual_odom_tpu_torch/backend/pnp.py `_gn_refine`) runs each of its ops as
// a kernel: ~6,350 of the ~7,100 kernels of a step (the 18 unrolled 6x6
// solves alone ~4,460), each paying a launch's floor of ~1.3 us inside a
// graph replay whatever the batch, ~8 ms of a live frame's ~10 ms of device
// time on the H100, for ~4.5 MFLOP of work.
//
// What bounds it on the H100: neither bytes nor FLOPs (a step reads a few
// tens of KB and does ~4.5 MFLOP, nanoseconds at the card's rates), but the
// serial chain of 6 (polish: 12) dependent iterations, each a transform,
// the normal equations, an unrolled Cholesky with 6 square roots and 18
// divisions, and a Rodrigues update with its sine and cosine.
//
// Design. Two kernels over the same device functions, the arithmetic of
// the plain twin in its order and in float32, IEEE division and square root
// and precise sinf / cosf / acosf (the library is built with --fmad=false,
// so no product is fused into a sum):
//   - pnp_gn_hypotheses_kernel: one thread per hypothesis of every sequence
//     (B * H threads in blocks of 128). A thread gathers its `k` sample
//     points itself through `idx` (B, H, k), starts from the warm start
//     pose0[b] (even h) or the identity (odd h), and runs every iteration
//     with the pose, the 21 + 6 sums of the normal equations and the
//     Cholesky factor in registers; it writes pose6 once.
//   - pnp_gn_polish_kernel: one block per pose (a sequence's best
//     hypothesis), threads over its M weighted points. An iteration sums
//     the 27 terms per thread, then over the warp by shuffles and over the
//     warps in shared memory, always in the same order, so a launch is
//     deterministic (a graph's replay equals the eager launch bit for bit);
//     every thread then solves and updates the pose identically.
// The results differ from the plain twin's only by the order of the sums of
// G and g and of the transform's 3-term and the 3x3 products' sums.
// A sample index outside [0, N) gives a NaN pose, which the caller's
// finiteness test drops; the plain twin's gather would fault instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHypThreads = 128;
constexpr int kPolishMaxThreads = 256;
constexpr int kPolishMaxWarps = kPolishMaxThreads / 32;
constexpr int kSums = 27;            // the 21 upper entries of G and g's 6

struct Camera {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

__device__ __forceinline__ float sign_of(float x) {
  // torch.sign: 0 for 0 and NaN
  return (float)(0.0f < x) - (float)(x < 0.0f);
}

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float safe_div(float d) {
  // solve_spd's safe(): |d| < 1e-30 -> 1e-30
  return fabsf(d) < 1.0e-30f ? 1.0e-30f : d;
}

// core/lie.py rodrigues: R = cos(t) I + sin(t)/t [w]_x + (1-cos(t))/t^2 w w^T
// with series terms for theta^2 < 1e-8, each entry as (c I + a K) + b ww^T.
__device__ void rodrigues(float r0, float r1, float r2, float R[9]) {
  const float theta2 = r0 * r0 + r1 * r1 + r2 * r2;
  const float theta = sqrtf(theta2 + 1.0e-16f);
  const bool small = theta2 < 1.0e-8f;
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(theta)) / theta2;
  const float c = small ? 1.0f - theta2 * 0.5f : cosf(theta);
  const float r[3] = {r0, r1, r2};
  const float K[9] = {0.0f, -r2, r1, r2, 0.0f, -r0, -r1, r0, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[3 * i + j] = (c * (i == j ? 1.0f : 0.0f) + a * K[3 * i + j])
                     + b * (r[i] * r[j]);
    }
  }
}

// core/lie.py rodrigues_inverse, the near-pi branch included.
__device__ void rodrigues_inverse(const float R[9], float w[3]) {
  const float trace = R[0] + R[4] + R[8];
  float cos_t = (trace - 1.0f) * 0.5f;
  cos_t = cos_t < -1.0f ? -1.0f : (cos_t > 1.0f ? 1.0f : cos_t);
  const float theta = acosf(cos_t);
  const float vee[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const float s = sinf(theta);
  const float scale =
      fabsf(s) < 1.0e-6f
          ? 0.5f + theta * theta / 12.0f
          : theta / (2.0f * clamp_min(fabsf(s), 1.0e-8f)) * sign_of(s + 1.0e-8f);

  float A[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = 0.5f * (R[3 * i + j] + (i == j ? 1.0f : 0.0f));
    }
  }
  const float d[3] = {A[0], A[4], A[8]};
  float ax[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ax[i] = sqrtf(clamp_min(d[i], 0.0f) + 1.0e-16f);
  // torch.argmax: the first largest, NaN counting as the largest
  int k = 0;
  float best = d[0];
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    if (!is_nan(best) && (is_nan(d[i]) || d[i] > best)) {
      k = i;
      best = d[i];
    }
  }
  const float s01 = sign_of(A[1]), s02 = sign_of(A[2]), s12 = sign_of(A[5]);
  float c0, c1, c2;
  if (k == 0) {
    c0 = ax[0]; c1 = ax[1] * s01; c2 = ax[2] * s02;
  } else if (k == 1) {
    c0 = ax[0] * s01; c1 = ax[1]; c2 = ax[2] * s12;
  } else {
    c0 = ax[0] * s02; c1 = ax[1] * s12; c2 = ax[2];
  }
  const float norm = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
  const bool near_pi = (3.14159265358979f - theta) < 1.0e-3f;
  w[0] = near_pi ? c0 / norm * theta : vee[0] * scale;
  w[1] = near_pi ? c1 / norm * theta : vee[1] * scale;
  w[2] = near_pi ? c2 / norm * theta : vee[2] * scale;
}

// One weighted correspondence's terms of the normal equations, added to
// acc[0..20] (G's upper triangle, row by row) and acc[21..26] (g):
// _gn_refine's residual and Jacobian rows written out, the u row's product
// added before the v row's.
__device__ __forceinline__ void add_point(const float R[9], const float t[3],
                                          const Camera& cam, float X0, float X1,
                                          float X2, float xo0, float xo1,
                                          float w, float acc[kSums]) {
  const float p0 = X0 * R[0] + X1 * R[1] + X2 * R[2] + t[0];
  const float p1 = X0 * R[3] + X1 * R[4] + X2 * R[5] + t[1];
  const float p2 = X0 * R[6] + X1 * R[7] + X2 * R[8] + t[2];
  const float z = fabsf(p2) < 1.0e-9f ? 1.0e-9f : p2;
  const float inv_z = 1.0f / z;
  const float u = p0 * inv_z * cam.fx + cam.cx;
  const float v = p1 * inv_z * cam.fy + cam.cy;
  const float du0 = cam.fx * inv_z;
  const float du2 = -cam.fx * p0 * inv_z * inv_z;
  const float dv1 = cam.fy * inv_z;
  const float dv2 = -cam.fy * p1 * inv_z * inv_z;
  const float q0 = p0 - t[0], q1 = p1 - t[1], q2 = p2 - t[2];
  float Ju[6] = {du2 * q1, du0 * q2 - du2 * q0, -du0 * q1, du0, 0.0f, du2};
  float Jv[6] = {-dv1 * q2 + dv2 * q1, -dv2 * q0, dv1 * q0, 0.0f, dv1, dv2};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    Ju[i] = Ju[i] * w;
    Jv[i] = Jv[i] * w;
  }
  const float ru = (u - xo0) * w, rv = (v - xo1) * w;
  int e = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      acc[e] = acc[e] + Ju[i] * Ju[j];
      acc[e] = acc[e] + Jv[i] * Jv[j];
      ++e;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc[21 + i] = acc[21 + i] + Ju[i] * ru;
    acc[21 + i] = acc[21 + i] + Jv[i] * rv;
  }
}

// Index of G[i][j] (i <= j) in acc.
__host__ __device__ constexpr int upper(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// One damped step from the summed normal equations: step = solve_spd(G +
// damping I, g) in core/linalg.py's sequence; a step that is finite moves the
// pose (R <- rodrigues(-dw) R, t <- t - dt), one that is not leaves it.
__device__ void gn_update(const float acc[kSums], float damping, float R[9],
                          float t[3]) {
  float A[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float Gij = i <= j ? acc[upper(i, j)] : acc[upper(j, i)];
      A[i][j] = Gij + (i == j ? damping : 0.0f);
    }
  }
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
    const float inv = 1.0f / safe_div(L[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float tt = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) tt = tt - L[i][k] * L[j][k];
      L[i][j] = tt * inv;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float tt = acc[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) tt = tt - L[i][k] * y[k];
    y[i] = tt / safe_div(L[i][i]);
  }
  float x[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float tt = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) tt = tt - L[k][i] * x[k];
    x[i] = tt / safe_div(L[i][i]);
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && is_finite(x[i]);
  if (!ok) return;
  float D[9];
  rodrigues(-x[0], -x[1], -x[2], D);
  float Rn[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Rn[3 * i + j] = D[3 * i] * R[j] + D[3 * i + 1] * R[3 + j]
                      + D[3 * i + 2] * R[6 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = Rn[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t[i] - x[3 + i];
}

__device__ __forceinline__ Camera load_camera(const float* K) {
  return Camera{K[0], K[4], K[2], K[5]};
}

__device__ __forceinline__ void write_pose(const float R[9], const float t[3],
                                           float* out) {
  float w[3];
  rodrigues_inverse(R, w);
  out[0] = w[0];
  out[1] = w[1];
  out[2] = w[2];
  out[3] = t[0];
  out[4] = t[1];
  out[5] = t[2];
}

// Thread g = b * hyps + h refines hypothesis h of sequence b on its k
// samples idx[g, :] of points3d[b] / points2d[b] (each N points), weight 1.
__global__ void __launch_bounds__(kHypThreads)
pnp_gn_hypotheses_kernel(const float* __restrict__ pose0,
                         const float* __restrict__ X,
                         const float* __restrict__ x_obs,
                         const int64_t* __restrict__ idx,
                         const float* __restrict__ K,
                         float* __restrict__ out, int batch, int hyps, int n,
                         int k, int iters, float damping) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (int64_t)batch * hyps) return;
  const int b = (int)(g / hyps);
  const int h = (int)(g % hyps);
  const int64_t* my_idx = idx + g * k;
  float* my_out = out + g * 6;
  for (int m = 0; m < k; ++m) {
    const int64_t j = my_idx[m];
    if (j < 0 || j >= n) {
#pragma unroll
      for (int i = 0; i < 6; ++i) my_out[i] = __int_as_float(0x7fc00000);
      return;
    }
  }
  const Camera cam = load_camera(K);
  float start[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) start[i] = h % 2 == 0 ? pose0[b * 6 + i] : 0.0f;
  float R[9];
  rodrigues(start[0], start[1], start[2], R);
  float t[3] = {start[3], start[4], start[5]};
  const float* Xb = X + (int64_t)b * n * 3;
  const float* xb = x_obs + (int64_t)b * n * 2;
  for (int it = 0; it < iters; ++it) {
    float acc[kSums];
#pragma unroll
    for (int e = 0; e < kSums; ++e) acc[e] = 0.0f;
    for (int m = 0; m < k; ++m) {
      const int64_t j = my_idx[m];
      add_point(R, t, cam, Xb[3 * j], Xb[3 * j + 1], Xb[3 * j + 2],
                xb[2 * j], xb[2 * j + 1], 1.0f, acc);
    }
    gn_update(acc, damping, R, t);
  }
  write_pose(R, t, my_out);
}

// Block p refines pose6[p] on its m points X[p], x_obs[p] with weights
// w[p]; the block's threads split the points.
__global__ void __launch_bounds__(kPolishMaxThreads)
pnp_gn_polish_kernel(const float* __restrict__ pose6,
                     const float* __restrict__ X,
                     const float* __restrict__ x_obs,
                     const float* __restrict__ w, const float* __restrict__ K,
                     float* __restrict__ out, int m, int iters,
                     float damping) {
  __shared__ float partial[kPolishMaxWarps][kSums];
  __shared__ float total[kSums];
  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const Camera cam = load_camera(K);
  float R[9];
  rodrigues(pose6[p * 6], pose6[p * 6 + 1], pose6[p * 6 + 2], R);
  float t[3] = {pose6[p * 6 + 3], pose6[p * 6 + 4], pose6[p * 6 + 5]};
  const float* Xp = X + (int64_t)p * m * 3;
  const float* xp = x_obs + (int64_t)p * m * 2;
  const float* wp = w + (int64_t)p * m;
  for (int it = 0; it < iters; ++it) {
    float acc[kSums];
#pragma unroll
    for (int e = 0; e < kSums; ++e) acc[e] = 0.0f;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      add_point(R, t, cam, Xp[3 * j], Xp[3 * j + 1], Xp[3 * j + 2],
                xp[2 * j], xp[2 * j + 1], wp[j], acc);
    }
#pragma unroll
    for (int e = 0; e < kSums; ++e) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[e] = acc[e] + __shfl_down_sync(0xffffffffu, acc[e], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < kSums; ++e) partial[warp][e] = acc[e];
    }
    __syncthreads();
    if (threadIdx.x < kSums) {
      float s = partial[0][threadIdx.x];
      for (int q = 1; q < warps; ++q) s = s + partial[q][threadIdx.x];
      total[threadIdx.x] = s;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kSums; ++e) acc[e] = total[e];
    gn_update(acc, damping, R, t);
  }
  if (threadIdx.x == 0) write_pose(R, t, out + p * 6);
}

int polish_threads(int m) {
  const int rounded = (m + 31) / 32 * 32;
  return rounded < kPolishMaxThreads ? rounded : kPolishMaxThreads;
}

}  // namespace

// B * H hypotheses: pose0 (B, 6), points3d (B, N, 3), points2d (B, N, 2),
// idx (B, H, k) int64, K (3, 3) row-major, out (B, H, 6); all float32
// unless said, contiguous, on the current device. Returns
// cudaGetLastError() after the launch.
extern "C" int pnp_gn_hypotheses_launch(const float* pose0, const float* X,
                                        const float* x_obs, const int64_t* idx,
                                        const float* K, float* out, int batch,
                                        int hyps, int n, int k, int iters,
                                        float damping, cudaStream_t stream) {
  if (batch < 1 || hyps < 1 || n < 1 || k < 1 || iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t threads = (int64_t)batch * hyps;
  const int64_t blocks = (threads + kHypThreads - 1) / kHypThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  pnp_gn_hypotheses_kernel<<<(unsigned)blocks, kHypThreads, 0, stream>>>(
      pose0, X, x_obs, idx, K, out, batch, hyps, n, k, iters, damping);
  return (int)cudaGetLastError();
}

// P poses on their own M weighted points: pose6 (P, 6), X (P, M, 3), x_obs
// (P, M, 2), w (P, M), K (3, 3), out (P, 6). Returns cudaGetLastError()
// after the launch.
extern "C" int pnp_gn_polish_launch(const float* pose6, const float* X,
                                    const float* x_obs, const float* w,
                                    const float* K, float* out, int poses,
                                    int m, int iters, float damping,
                                    cudaStream_t stream) {
  if (poses < 1 || m < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  pnp_gn_polish_kernel<<<poses, polish_threads(m), 0, stream>>>(
      pose6, X, x_obs, w, K, out, m, iters, damping);
  return (int)cudaGetLastError();
}
