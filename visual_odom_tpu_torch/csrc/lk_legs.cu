// Circular-quad pyramidal Lucas-Kanade for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel `_legs_kernel`
// (visual_odom_tpu/ops/lk_pallas.py), which the TPU launches twice per quad
// (two 2-leg chains). Here ONE launch runs all four legs of the quad
// L0 -> R0 -> R1 -> L1 -> L0 for every feature; the per-feature result is
// the same function: each leg is seeded at chain + sign * (disp | flow)
// scaled to the start level, runs coarse-to-fine from `start_level` to 0,
// and each level does
//   - in-kernel Scharr (3,10,3)/16 x (-1,0,1)/2 on a 24x24 superblock of I,
//   - fp32 bilinear template / gradient patches at floor(prevPt),
//   - the normal matrix G and the min-eig / det gate,
//   - up to max_iters damped updates delta = -G^-1 b with OpenCV's
//     flip-flop half step and per-feature iteration count,
// with status failing only at level 0.
//
// What bounds it on the H100: neither bytes nor FLOPs. A frame's quad moves
// a few MB of windows and does ~0.1 GFLOP, microseconds at the card's
// rates; the work is a chain of dependent steps per feature (8 leg-levels x
// up to 30 iterations, each a window read, two reductions and a 2x2 solve),
// so the kernel is latency-bound and only a few hundred warps exist.
//
// Design: one warp per feature, so features never wait for each other (the
// TPU's group-of-4 interleave is gone: iteration counts are per feature).
// The 24x24 template superblock is staged in shared memory once per
// (leg, level); the 21x21 template and gradient patches stay in registers
// (14 pixels a lane) across the iterations; each iteration reads its 22x22
// J window straight from global memory / L2 and reduces b1, b2 (and G at
// setup) with warp shuffles. Bilinear weights are computed in fp32 in the
// reference's order (no texture filtering: it keeps 8 fractional bits).
// Build with --fmad=false so every a*b+c rounds as the plain PyTorch
// version does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 21;                     // LK window
constexpr int W1 = WIN + 1;                 // bilinear support
constexpr int BLK = W1 + 2;                 // plus the Scharr ring
constexpr int NPIX = WIN * WIN;
constexpr int PER_LANE = (NPIX + 31) / 32;  // 14
constexpr int MAX_LEVELS = 4;
constexpr int N_IMG = 4;                    // L0, R0, R1, L1
constexpr int N_LEGS = 4;
constexpr int WARPS = 2;                    // features per block

constexpr float SM0 = 3.0f / 16.0f, SM1 = 10.0f / 16.0f, SM2 = 3.0f / 16.0f;
constexpr float DF0 = -0.5f, DF2 = 0.5f;
constexpr float D_EPS = (float)(1.19209e-07 * 1024.0 * 1024.0);
constexpr float EIG_SCALE = 2.0f * (float)(WIN * WIN) * 1024.0f;

struct QuadArgs {
  const float* planes[N_IMG][MAX_LEVELS];
  int rows[MAX_LEVELS];
  int cols[MAX_LEVELS];
  int stride[MAX_LEVELS];
  const float* pts;
  const float* flow;
  const float* disp;
  const int32_t* valid;
  float* out_pts;        // (N_LEGS, n, 2)
  int32_t* out_status;   // (n,)
  int n;
  int start_level;
  int pad;
  int max_iters;
  float eps2;
  float min_eig_threshold;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ int floor_to_int(float f) {
  // f is already floor()ed; clamp before converting so a runaway estimate
  // stays far out of bounds instead of wrapping.
  return __float2int_rz(fminf(fmaxf(f, -1.0e9f), 1.0e9f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Shared {
  float blk[BLK * BLK];
  float wI[W1 * W1];
  float wIx[W1 * W1];
  float wIy[W1 * W1];
};

__global__ void __launch_bounds__(32 * WARPS)
lk_quad_kernel(const QuadArgs args) {
  __shared__ Shared smem_all[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + warp;
  if (f >= args.n) return;
  Shared& sm = smem_all[warp];

  const float px0 = args.pts[2 * f], py0 = args.pts[2 * f + 1];
  if (args.valid[f] == 0) {
    // Invalid slots pass their input through, status 0.
    if (lane == 0) {
      for (int leg = 0; leg < N_LEGS; ++leg) {
        args.out_pts[(leg * args.n + f) * 2] = px0;
        args.out_pts[(leg * args.n + f) * 2 + 1] = py0;
      }
      args.out_status[f] = 0;
    }
    return;
  }

  const int SL = args.start_level;
  const int pad = args.pad;
  const float half = (WIN - 1) * 0.5f;
  const float seed_div = (float)(1 << SL);
  float cx = px0, cy = py0;
  bool status = true;

  for (int leg = 0; leg < N_LEGS; ++leg) {
    const int i_img = leg, j_img = (leg + 1) % N_IMG;
    const float* seed = (leg % 2 == 0) ? args.disp : args.flow;
    const float sgn = leg < 2 ? 1.0f : -1.0f;
    float nx = (cx + sgn * seed[2 * f]) / seed_div;
    float ny = (cy + sgn * seed[2 * f + 1]) / seed_div;
    bool ok_leg = true;

    for (int level = SL; level >= 0; --level) {
      const int rows = args.rows[level], cols = args.cols[level];
      const int stride = args.stride[level];
      const int Hp = rows + 2 * pad, Wp = cols + 2 * pad;
      const float* I = args.planes[i_img][level];
      const float* J = args.planes[j_img][level];
      const float scale = (float)(1 << level);
      const float prevx = cx / scale - half, prevy = cy / scale - half;
      if (level != SL) { nx = nx * 2.0f; ny = ny * 2.0f; }
      const float initx = nx - half, inity = ny - half;

      // ---- template setup -------------------------------------------
      const float fx = floorf(prevx), fy = floorf(prevy);
      const float a = prevx - fx, b = prevy - fy;
      const int ix = floor_to_int(fx), iy = floor_to_int(fy);
      const bool templ_ok = (ix >= -WIN) & (ix < cols) & (iy >= -WIN) & (iy < rows);
      const int sy = clampi(iy + pad, 1, Hp - W1 - 1);
      const int sx = clampi(ix + pad, 1, Wp - W1 - 1);
      const float* src = I + (size_t)(sy - 1) * stride + (sx - 1);
      __syncwarp();
      for (int k = lane; k < BLK * BLK; k += 32) {
        const int r = k / BLK, c = k - r * BLK;
        sm.blk[k] = src[(size_t)r * stride + c];
      }
      __syncwarp();
      for (int k = lane; k < W1 * W1; k += 32) {
        const int r = k / W1, c = k - r * W1;
        const float* r0 = sm.blk + r * BLK;
        const float* r1 = r0 + BLK;
        const float* r2 = r1 + BLK;
        sm.wI[k] = r1[c + 1];
        const float smr0 = r0[c] * SM0 + r1[c] * SM1 + r2[c] * SM2;
        const float smr2 = r0[c + 2] * SM0 + r1[c + 2] * SM1 + r2[c + 2] * SM2;
        sm.wIx[k] = smr0 * DF0 + smr2 * DF2;
        const float dfr0 = r0[c] * DF0 + r2[c] * DF2;
        const float dfr1 = r0[c + 1] * DF0 + r2[c + 1] * DF2;
        const float dfr2 = r0[c + 2] * DF0 + r2[c + 2] * DF2;
        sm.wIy[k] = dfr0 * SM0 + dfr1 * SM1 + dfr2 * SM2;
      }
      __syncwarp();

      const float w00 = (1.0f - a) * (1.0f - b), w01 = a * (1.0f - b);
      const float w10 = (1.0f - a) * b, w11 = a * b;
      float templ[PER_LANE], gx[PER_LANE], gy[PER_LANE];
      int off[PER_LANE];  // top-left of the pixel's 2x2 support in a W1 window
      float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int p = lane + 32 * j;
        templ[j] = gx[j] = gy[j] = 0.0f;
        off[j] = 0;
        if (p < NPIX) {
          const int r = p / WIN, c = p - r * WIN;
          const int o = r * W1 + c;
          off[j] = r * stride + c;
          templ[j] = w00 * sm.wI[o] + w01 * sm.wI[o + 1]
                   + w10 * sm.wI[o + W1] + w11 * sm.wI[o + W1 + 1];
          gx[j] = w00 * sm.wIx[o] + w01 * sm.wIx[o + 1]
                + w10 * sm.wIx[o + W1] + w11 * sm.wIx[o + W1 + 1];
          gy[j] = w00 * sm.wIy[o] + w01 * sm.wIy[o + 1]
                + w10 * sm.wIy[o + W1] + w11 * sm.wIy[o + W1 + 1];
          s11 += gx[j] * gx[j];
          s12 += gx[j] * gy[j];
          s22 += gy[j] * gy[j];
        }
      }
      const float A11 = warp_sum(s11), A12 = warp_sum(s12), A22 = warp_sum(s22);
      const float D = A11 * A22 - A12 * A12;
      const float dd = A11 - A22;
      const float min_eig = (A22 + A11 - sqrtf(dd * dd + 4.0f * A12 * A12)) / EIG_SCALE;
      const bool level_ok = templ_ok & (min_eig >= args.min_eig_threshold) & (D >= D_EPS);
      const float inv_D = 1.0f / (D == 0.0f ? 1.0f : D);

      // ---- iterations ------------------------------------------------
      float x = initx, y = inity, pdx = 0.0f, pdy = 0.0f;
      bool ok0 = true;
      bool active = level_ok;
      const bool finest = level == 0;
      for (int ji = 0; active; ++ji) {
        const float jfx = floorf(x), jfy = floorf(y);
        const float aa = x - jfx, bb = y - jfy;
        const int jx = floor_to_int(jfx), jy = floor_to_int(jfy);
        const bool in_b = (jx >= -WIN) & (jx < cols) & (jy >= -WIN) & (jy < rows);
        const int ty = clampi(jy + pad, 0, Hp - W1);
        const int tx = clampi(jx + pad, 0, Wp - W1);
        const float* win = J + (size_t)ty * stride + tx;
        const float v00 = (1.0f - aa) * (1.0f - bb), v01 = aa * (1.0f - bb);
        const float v10 = (1.0f - aa) * bb, v11 = aa * bb;
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          if (lane + 32 * j < NPIX) {
            const float* q = win + off[j];
            const float patch = v00 * __ldg(q) + v01 * __ldg(q + 1)
                              + v10 * __ldg(q + stride) + v11 * __ldg(q + stride + 1);
            const float diff = patch - templ[j];
            s1 += diff * gx[j];
            s2 += diff * gy[j];
          }
        }
        const float b1 = warp_sum(s1), b2 = warp_sum(s2);
        const float dx = (A12 * b2 - A22 * b1) * inv_D;
        const float dy = (A12 * b1 - A11 * b2) * inv_D;
        float nnx = x + dx, nny = y + dy;
        const bool converged = dx * dx + dy * dy <= args.eps2;
        const bool flip = (ji > 0) & (fabsf(dx + pdx) < 0.01f) & (fabsf(dy + pdy) < 0.01f);
        if (flip) { nnx = nnx - dx * 0.5f; nny = nny - dy * 0.5f; }
        const bool stop = converged | flip | !in_b;
        ok0 = ok0 & (in_b | !finest);
        if (in_b) { x = nnx; y = nny; }
        pdx = dx;
        pdy = dy;
        active = !stop & (ji + 1 < args.max_iters);
      }
      const float outx = level_ok ? x : initx;
      const float outy = level_ok ? y : inity;
      nx = outx + half;
      ny = outy + half;
      if (finest) ok_leg = level_ok & ok0;
    }
    cx = nx;
    cy = ny;
    status = status & ok_leg;
    if (lane == 0) {
      args.out_pts[(leg * args.n + f) * 2] = cx;
      args.out_pts[(leg * args.n + f) * 2 + 1] = cy;
    }
  }
  if (lane == 0) args.out_status[f] = status ? 1 : 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Host arrays: plane_ptrs holds
// N_IMG * (start_level + 1) device pointers, image-major (L0, R0, R1, L1);
// dims holds (rows, cols, row stride) for levels 0..start_level. Returns
// cudaGetLastError() after the launch.
extern "C" int lk_quad_launch(const int64_t* plane_ptrs, const int32_t* dims,
                              const float* pts, const float* flow,
                              const float* disp, const int32_t* valid,
                              float* out_pts, int32_t* out_status, int n,
                              int start_level, int pad, int max_iters,
                              float eps2, float min_eig_threshold,
                              void* stream) {
  if (start_level < 0 || start_level >= MAX_LEVELS || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  QuadArgs args{};
  const int nl = start_level + 1;
  for (int im = 0; im < N_IMG; ++im) {
    for (int lv = 0; lv < nl; ++lv) {
      args.planes[im][lv] = reinterpret_cast<const float*>(plane_ptrs[im * nl + lv]);
    }
  }
  for (int lv = 0; lv < nl; ++lv) {
    args.rows[lv] = dims[3 * lv];
    args.cols[lv] = dims[3 * lv + 1];
    args.stride[lv] = dims[3 * lv + 2];
  }
  args.pts = pts;
  args.flow = flow;
  args.disp = disp;
  args.valid = valid;
  args.out_pts = out_pts;
  args.out_status = out_status;
  args.n = n;
  args.start_level = start_level;
  args.pad = pad;
  args.max_iters = max_iters;
  args.eps2 = eps2;
  args.min_eig_threshold = min_eig_threshold;
  const int blocks = (n + WARPS - 1) / WARPS;
  lk_quad_kernel<<<blocks, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
