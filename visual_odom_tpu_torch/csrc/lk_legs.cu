// Pyramidal Lucas-Kanade for Hopper (sm_90a): the circular quad and the
// single level, two kernels over one per-level device function, each built
// in four instances.
//
// lk_quad_kernel replaces the JAX package's Pallas TPU kernel `_legs_kernel`
// (visual_odom_tpu/ops/lk_pallas.py:299), which the TPU launches twice per
// quad (two 2-leg chains), on grid (feature_blocks,) from `_build_legs_call`
// and on grid (B, feature_blocks) from `_build_legs_call_batched` when the
// step is vmapped over B sequences. Here ONE launch runs all four legs of the
// quad L0 -> R0 -> R1 -> L1 -> L0 for every feature of every sequence
// (grid (feature_blocks, B); the unbatched call is B = 1). The per-feature
// result is the same function: each leg is seeded at chain + sign * (disp | flow)
// scaled to the start level and runs coarse-to-fine from `start_level` to 0.
//
// lk_level_kernel replaces `_level_kernel` (lk_pallas.py:90), launched by
// `_build_level_call` (lk_pallas.py:271) once per pyramid level of one leg:
// given each feature's template corner `prev` and start estimate `init` in
// the level's coordinates, it returns the refined estimate (`init` where the
// level's gate fails) and the level's status. The per-leg route
// (ops/lk.lk_track_pyramid) chains it coarse-to-fine, one launch per level.
//
// Each (leg, level) of either kernel is `track_level`:
//   - in-kernel Scharr (3,10,3)/16 x (-1,0,1)/2 on a 24x24 superblock of I,
//   - fp32 bilinear template / gradient patches at floor(prevPt),
//   - the normal matrix G and the min-eig / det gate,
//   - up to max_iters damped updates delta = -G^-1 b with OpenCV's
//     flip-flop half step and per-feature iteration count,
// with status failing only at level 0. Both kernels run each level with the
// same instructions, so four chained legs of level launches give the quad's
// result bit for bit (the glue between levels scales by powers of two).
//
// What bounds them on the H100: neither bytes nor FLOPs. A frame's quad moves
// a few MB of windows and does ~0.1 GFLOP, microseconds at the card's rates.
// The work is a chain of dependent updates per feature (up to 30 per level,
// up to ~140 in one quad), each a window read, two reductions and a 2x2
// solve, and at B = 1 only 384 features exist for 132 SMs, about one warp
// per SM sub-partition. So a launch lasts as long as its longest chain: the
// latency of one update, ~0.5-0.6 us on the H100, and each level's template
// setup, about a third of a quad. An update's latency is set by the
// instructions one lane issues for its share of the 441 window pixels
// (a bilinear patch, the difference, two products and sums: ~16 a pixel,
// in order), not by where the window comes from: it is the same from L1 /
// L2 as from shared memory, and it triples when a lane holds 56 pixels
// instead of 14.
//
// Design. Both kernels are templates on <LANES, REUSE>; the C entry points
// pick the instance at run time (packed -> LANES 8, doublestep -> REUSE).
//   - A feature is a group of LANES lanes; features never wait for each
//     other's results. Sequence b = blockIdx.y reads its planes at base +
//     b * plane_size and its features at row b of the (B, n, ...) arrays;
//     nothing else depends on b, so a batched launch computes for sequence b
//     exactly what a B = 1 launch on that sequence computes.
//   - The 24x24 template superblock is staged in shared memory once per
//     (leg, level); the 21x21 template and gradient patches stay in
//     registers (14 pixels a lane at LANES 32, 56 at LANES 8) across the
//     updates, and so do the window offsets of a lane's pixels.
//   - REUSE, the counterpart of the TPU kernel's VO_LK_DOUBLESTEP body
//     (lk_pallas.py:75-83, 638-651): the update reads its 22x22 J window
//     from a 32x36 superblock of J in shared memory, staged with the window
//     5 rows and 5-8 columns from its top-left corner, and staged again only
//     when the window's integer corner leaves it. The TPU body reuses its
//     block while floor(pt) stays put; this keeps it while the window stays
//     inside, and is bit-exact by the same argument: the same pixels, the
//     same arithmetic, the same order. An update's loads are 32-bit shared
//     loads at offsets fixed per lane and pixel, with no 64-bit address
//     arithmetic. Both superblocks are staged by cp.async in 16-byte copies
//     (their columns start on a multiple of 4; the rows of every plane are a
//     multiple of 4 floats), not by TMA: a TMA copy needs a tensor map per
//     plane, encoded on the host, while here each feature stages its own
//     tile at places and times that only the feature knows, from a plain
//     pointer. The J superblock overlays the template buffers, which are
//     dead after setup (`Shared`: 6,560 bytes a feature).
//   - Without REUSE the update reads its window from global memory, as the
//     port did before window reuse: the A/B and bit-for-bit reference.
//   - LANES 8, the counterpart of VO_LK_PACKED (lk_pallas.py:396-579, where
//     _GROUP = 4 features share one 128-lane array): four features a warp.
//     The warp runs an update while any of its features is active; a group
//     that has stopped idles under a mask, so each feature keeps its own
//     iteration count. Sums reduce over 8 lanes in 3 shuffle steps. The
//     order of the sums differs from LANES 32, so packed results equal the
//     plain version within tolerance, not bit for bit, as the TPU's packed
//     body does. It holds 4x the pixels a lane and 255 registers; on this
//     card it is slower than LANES 32 at every batch measured.
// Bilinear weights are computed in fp32 in the reference's order (no texture
// filtering: it keeps 8 fractional bits). Build with --fmad=false so every
// a*b+c rounds as the plain PyTorch version does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 21;                     // LK window
constexpr int W1 = WIN + 1;                 // bilinear support
constexpr int BLK = W1 + 2;                 // plus the Scharr ring
constexpr int NPIX = WIN * WIN;
constexpr int MAX_LEVELS = 4;
constexpr int N_IMG = 4;                    // L0, R0, R1, L1
constexpr int N_LEGS = 4;
// J superblock of the REUSE instances: rows x columns, staged in 16-byte
// chunks, with the window JB_MARGIN rows below its top and 5-8 columns
// right of its left edge.
constexpr int JB_ROWS = 32;
constexpr int JB_COLS = 36;
constexpr int JB_MARGIN = 5;
// Row pitch of the I superblock: its 16-byte copies start up to 3 (4 at the
// plane's right edge) columns left of the block.
constexpr int IB_COLS = BLK + 4;
static_assert(JB_COLS % 4 == 0 && IB_COLS % 4 == 0, "16-byte staging");

constexpr float SM0 = 3.0f / 16.0f, SM1 = 10.0f / 16.0f, SM2 = 3.0f / 16.0f;
constexpr float DF0 = -0.5f, DF2 = 0.5f;
constexpr float D_EPS = (float)(1.19209e-07 * 1024.0 * 1024.0);
constexpr float EIG_SCALE = 2.0f * (float)(WIN * WIN) * 1024.0f;

// A feature's lane group: LANES lanes, PER_LANE window pixels a lane.
template <int LANES>
struct Group {
  static_assert(LANES == 32 || LANES == 8, "one or four features a warp");
  static constexpr int PER_LANE = (NPIX + LANES - 1) / LANES;  // 14 or 56
  static constexpr int WARPS = LANES == 32 ? 2 : 1;            // per block
  static constexpr int PER_BLOCK = WARPS * (32 / LANES);       // features
};

struct QuadArgs {
  const float* planes[N_IMG][MAX_LEVELS];
  int rows[MAX_LEVELS];
  int cols[MAX_LEVELS];
  int stride[MAX_LEVELS];
  int plane_rows[MAX_LEVELS];
  long long plane_size[MAX_LEVELS];  // elements of one sequence's plane
  const float* pts;
  const float* flow;
  const float* disp;
  const int32_t* valid;
  float* out_pts;        // (N_LEGS, B, n, 2)
  int32_t* out_status;   // (B, n)
  int n;
  int batch;
  int start_level;
  int pad;
  int max_iters;
  float eps2;
  float min_eig_threshold;
};

// Sum over the lane group: a butterfly. IEEE addition commutes, so the two
// lanes of a pair compute the same bits at every step, and every lane of the
// group ends with the same sum: no broadcast is needed.
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int floor_to_int(float f) {
  // f is already floor()ed; clamp before converting so a runaway estimate
  // stays far out of bounds instead of wrapping.
  return __float2int_rz(fminf(fmaxf(f, -1.0e9f), 1.0e9f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Offset, in a window stored row-major at `pitch`, of pixel j of lane gl of
// its group: window pixel p = gl + LANES * j, at row p / WIN, column
// p % WIN. Once j is unrolled, LANES * j is a constant.
template <int LANES>
__device__ __forceinline__ int pix_off(const int gl, const int j,
                                       const int pitch) {
  const int p0 = LANES * j;
  int r = p0 / WIN, c = p0 % WIN + gl;
  if (c >= WIN) { c -= WIN; ++r; }
  if (LANES > WIN && c >= WIN) { c -= WIN; ++r; }
  return r * pitch + c;
}

// One feature's shared memory: the template buffers during setup, then the
// J superblock of the REUSE instances over them.
union __align__(16) Shared {
  struct {
    float blk[BLK * IB_COLS];  // I superblock; wI is its inner 22x22
    float wIx[W1 * W1];
    float wIy[W1 * W1];
  } t;
  float jblk[JB_ROWS * JB_COLS];
};

// Stage the ROWS x COLS block of a plane at `src` (row stride `stride`,
// 16-byte aligned) into `dst` (row pitch COLS), one cp.async per 16 bytes
// over the group's lanes; `stage_wait` waits for it.
template <int LANES, int ROWS, int COLS>
__device__ __forceinline__ void stage_block(float* dst, const float* src,
                                            const int stride, const int gl) {
  constexpr int ROW_CHUNKS = COLS / 4, CHUNKS = ROWS * ROW_CHUNKS;
#pragma unroll
  for (int i = 0; i < (CHUNKS + LANES - 1) / LANES; ++i) {
    const int k = gl + LANES * i;
    if (CHUNKS % LANES == 0 || k < CHUNKS) {
      const int r = k / ROW_CHUNKS, c = 4 * (k - r * ROW_CHUNKS);
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + r * COLS + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d), "l"(src + (size_t)r * stride + c) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// One LK level of one leg for the feature of this lane group. prev:
// template window corner, init: start estimate, both in the level's
// coordinates. `live` false masks the feature off (its level gate fails).
// Writes level_ok ? refined : init to (outx, outy) and returns
// level_ok & ok0 (ok0: no step left the image at the finest level). Every
// lane of the warp calls it together.
template <int LANES, bool REUSE>
__device__ __forceinline__ bool track_level(
    Shared& sm, const int lane, const bool live, const float* I,
    const float* J, const int rows, const int cols, const int stride,
    const int plane_rows, const int pad, const bool finest,
    const int max_iters, const float eps2, const float min_eig_threshold,
    const float prevx, const float prevy, const float initx,
    const float inity, float& outx, float& outy) {
  constexpr int PER_LANE = Group<LANES>::PER_LANE;
  // Where pixel j of this lane sits in the update's window, stored row-major
  // at `pitch` (JB_COLS in the J superblock, the plane's stride otherwise):
  //  - LANES 32: off[j], kept in registers (14 a lane);
  //  - LANES 8 with REUSE: gl + K_j + wrap[t_j], K_j a constant and wrap[t]
  //    = JB_COLS - WIN where the pixel's row wraps (gl >= t, t = 1..7), so
  //    a load takes a constant offset from one of 8 bases;
  //  - LANES 8 from global memory: computed in the update.
  constexpr bool KEEP_OFF = LANES == 32;
  const int gl = lane & (LANES - 1);
  const int Hp = rows + 2 * pad, Wp = cols + 2 * pad;
  const int pitch = REUSE ? JB_COLS : stride;

  // ---- template setup -------------------------------------------------
  const float fx = floorf(prevx), fy = floorf(prevy);
  const float a = prevx - fx, b = prevy - fy;
  const int ix = floor_to_int(fx), iy = floor_to_int(fy);
  const bool templ_ok = (ix >= -WIN) & (ix < cols) & (iy >= -WIN) & (iy < rows);
  const int sy = clampi(iy + pad, 1, Hp - W1 - 1);
  const int sx = clampi(ix + pad, 1, Wp - W1 - 1);
  // The BLK x BLK block at (sy - 1, sx - 1) lands at column bo of blk.
  int bo = 0;
  __syncwarp();
  if constexpr (REUSE) {
    const int ax = min((sx - 1) & ~3, stride - IB_COLS);
    bo = sx - 1 - ax;
    stage_block<LANES, BLK, IB_COLS>(
        sm.t.blk, I + (size_t)(sy - 1) * stride + ax, stride, gl);
    stage_wait();
  } else {
    const float* src = I + (size_t)(sy - 1) * stride + (sx - 1);
    for (int k = gl; k < BLK * BLK; k += LANES) {
      const int r = k / BLK, c = k - r * BLK;
      sm.t.blk[r * IB_COLS + c] = src[(size_t)r * stride + c];
    }
    __syncwarp();
  }
  for (int k = gl; k < W1 * W1; k += LANES) {
    const int r = k / W1, c = k - r * W1;
    const float* r0 = sm.t.blk + r * IB_COLS + bo;
    const float* r1 = r0 + IB_COLS;
    const float* r2 = r1 + IB_COLS;
    const float smr0 = r0[c] * SM0 + r1[c] * SM1 + r2[c] * SM2;
    const float smr2 = r0[c + 2] * SM0 + r1[c + 2] * SM1 + r2[c + 2] * SM2;
    sm.t.wIx[k] = smr0 * DF0 + smr2 * DF2;
    const float dfr0 = r0[c] * DF0 + r2[c] * DF2;
    const float dfr1 = r0[c + 1] * DF0 + r2[c + 1] * DF2;
    const float dfr2 = r0[c + 2] * DF0 + r2[c + 2] * DF2;
    sm.t.wIy[k] = dfr0 * SM0 + dfr1 * SM1 + dfr2 * SM2;
  }
  __syncwarp();

  const float w00 = (1.0f - a) * (1.0f - b), w01 = a * (1.0f - b);
  const float w10 = (1.0f - a) * b, w11 = a * b;
  float templ[PER_LANE], gx[PER_LANE], gy[PER_LANE];
  int off[KEEP_OFF ? PER_LANE : 1];
  int wrap[8];
  float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
#pragma unroll
  for (int t = 0; t < 8; ++t) wrap[t] = gl >= t ? JB_COLS - WIN : 0;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int p = gl + LANES * j;
    templ[j] = gx[j] = gy[j] = 0.0f;
    if constexpr (KEEP_OFF) off[j] = pix_off<LANES>(gl, j, pitch);
    if (p < NPIX) {
      const int r = p / WIN, c = p - r * WIN;
      const int o = r * W1 + c;                          // in wIx, wIy
      const int ob = (r + 1) * IB_COLS + bo + c + 1;     // wI[o] in blk
      templ[j] = w00 * sm.t.blk[ob] + w01 * sm.t.blk[ob + 1]
               + w10 * sm.t.blk[ob + IB_COLS] + w11 * sm.t.blk[ob + IB_COLS + 1];
      gx[j] = w00 * sm.t.wIx[o] + w01 * sm.t.wIx[o + 1]
            + w10 * sm.t.wIx[o + W1] + w11 * sm.t.wIx[o + W1 + 1];
      gy[j] = w00 * sm.t.wIy[o] + w01 * sm.t.wIy[o + 1]
            + w10 * sm.t.wIy[o + W1] + w11 * sm.t.wIy[o + W1 + 1];
      s11 += gx[j] * gx[j];
      s12 += gx[j] * gy[j];
      s22 += gy[j] * gy[j];
    }
  }
  const float A11 = group_sum<LANES>(s11);
  const float A12 = group_sum<LANES>(s12);
  const float A22 = group_sum<LANES>(s22);
  const float D = A11 * A22 - A12 * A12;
  const float dd = A11 - A22;
  const float min_eig = (A22 + A11 - sqrtf(dd * dd + 4.0f * A12 * A12)) / EIG_SCALE;
  const bool level_ok = live & templ_ok & (min_eig >= min_eig_threshold)
                      & (D >= D_EPS);
  const float inv_D = 1.0f / (D == 0.0f ? 1.0f : D);

  // ---- iterations -----------------------------------------------------
  float x = initx, y = inity, pdx = 0.0f, pdy = 0.0f;
  bool ok0 = true;
  bool active = level_ok;
  int by = 0, bx = 0;     // REUSE: the staged superblock's corner
  bool staged = false;
  // REUSE: every lane has read the template buffers before the superblock
  // overwrites them.
  if constexpr (REUSE) __syncwarp();
  for (int ji = 0; __any_sync(0xffffffffu, active); ++ji) {
    const float jfx = floorf(x), jfy = floorf(y);
    const float aa = x - jfx, bb = y - jfy;
    const int jx = floor_to_int(jfx), jy = floor_to_int(jfy);
    const bool in_b = (jx >= -WIN) & (jx < cols) & (jy >= -WIN) & (jy < rows);
    const int ty = clampi(jy + pad, 0, Hp - W1);
    const int tx = clampi(jx + pad, 0, Wp - W1);
    const float v00 = (1.0f - aa) * (1.0f - bb), v01 = aa * (1.0f - bb);
    const float v10 = (1.0f - aa) * bb, v11 = aa * bb;
    const float* win;
    if constexpr (REUSE) {
      const bool inside = staged & (ty >= by) & (ty + W1 <= by + JB_ROWS)
                        & (tx >= bx) & (tx + W1 <= bx + JB_COLS);
      const bool stage = active & !inside;
      if (stage) {
        by = clampi(ty - JB_MARGIN, 0, plane_rows - JB_ROWS);
        bx = clampi((tx - JB_MARGIN) & ~3, 0, stride - JB_COLS);
        staged = true;
        stage_block<LANES, JB_ROWS, JB_COLS>(
            sm.jblk, J + (size_t)by * stride + bx, stride, gl);
      }
      if (__any_sync(0xffffffffu, stage)) stage_wait();
      win = sm.jblk + (ty - by) * JB_COLS + (tx - bx);
    } else {
      win = J + (size_t)ty * stride + tx;
      // An empty asm barrier makes the window pointer an opaque value.
      // Without it nvcc folds the plane offset and the window corner into
      // the 64-bit index of each of the update's loads, which adds about
      // half again to the update loop's SASS instructions and slows both
      // kernels on the H100. The addresses, and so the results, are the
      // same.
      asm("" : "+l"(win));
    }
    float s1 = 0.0f, s2 = 0.0f;
    if (active) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if (gl + LANES * j < NPIX) {
          int o;
          if constexpr (KEEP_OFF) {
            o = off[j];
          } else if constexpr (REUSE) {
            const int p0 = LANES * j, c0 = p0 % WIN;
            o = gl + (p0 / WIN) * JB_COLS + c0
              + (c0 + LANES > WIN ? wrap[WIN - c0] : 0);
          } else {
            o = pix_off<LANES>(gl, j, pitch);
          }
          const float* q = win + o;
          float q00, q01, q10, q11;
          if constexpr (REUSE) {
            q00 = q[0]; q01 = q[1]; q10 = q[JB_COLS]; q11 = q[JB_COLS + 1];
          } else {
            q00 = __ldg(q); q01 = __ldg(q + 1);
            q10 = __ldg(q + pitch); q11 = __ldg(q + pitch + 1);
          }
          const float patch = v00 * q00 + v01 * q01 + v10 * q10 + v11 * q11;
          const float diff = patch - templ[j];
          s1 += diff * gx[j];
          s2 += diff * gy[j];
        }
      }
    }
    const float b1 = group_sum<LANES>(s1);
    const float b2 = group_sum<LANES>(s2);
    if (active) {
      const float dx = (A12 * b2 - A22 * b1) * inv_D;
      const float dy = (A12 * b1 - A11 * b2) * inv_D;
      float nnx = x + dx, nny = y + dy;
      const bool converged = dx * dx + dy * dy <= eps2;
      const bool flip = (ji > 0) & (fabsf(dx + pdx) < 0.01f)
                      & (fabsf(dy + pdy) < 0.01f);
      if (flip) { nnx = nnx - dx * 0.5f; nny = nny - dy * 0.5f; }
      const bool stop = converged | flip | !in_b;
      ok0 = ok0 & (in_b | !finest);
      if (in_b) { x = nnx; y = nny; }
      pdx = dx;
      pdy = dy;
      active = !stop & (ji + 1 < max_iters);
    }
  }
  outx = level_ok ? x : initx;
  outy = level_ok ? y : inity;
  return level_ok & ok0;
}

template <int LANES, bool REUSE>
__global__ void __launch_bounds__(32 * Group<LANES>::WARPS)
lk_quad_kernel(const QuadArgs args) {
  using G = Group<LANES>;
  __shared__ Shared smem_all[G::PER_BLOCK];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x / LANES;
  const int f = blockIdx.x * G::PER_BLOCK + slot;
  const bool in_range = f < args.n;
  const int b = blockIdx.y;
  // row b, slot f of (B, n, ...); a group past the end reads slot n - 1
  const size_t bf = (size_t)b * args.n + (in_range ? f : args.n - 1);
  const bool live = in_range && args.valid[bf] != 0;
  const bool writer = in_range && (lane & (LANES - 1)) == 0;
  // out_pts[leg][b][f] for leg 0.. at out + leg * leg_step
  float* out = args.out_pts + 2 * bf;
  const size_t leg_step = (size_t)2 * args.batch * args.n;

  const float px0 = args.pts[2 * bf], py0 = args.pts[2 * bf + 1];
  if (!__any_sync(0xffffffffu, live)) {
    // Invalid slots pass their input through, status 0.
    if (writer) {
      for (int leg = 0; leg < N_LEGS; ++leg) {
        out[leg * leg_step] = px0;
        out[leg * leg_step + 1] = py0;
      }
      args.out_status[bf] = 0;
    }
    return;
  }

  Shared& sm = smem_all[slot];
  const int SL = args.start_level;
  const float half = (WIN - 1) * 0.5f;
  const float seed_div = (float)(1 << SL);
  float cx = px0, cy = py0;
  bool status = live;

#pragma unroll 1
  for (int leg = 0; leg < N_LEGS; ++leg) {
    const int i_img = leg, j_img = (leg + 1) % N_IMG;
    const float* seed = (leg % 2 == 0) ? args.disp : args.flow;
    const float sgn = leg < 2 ? 1.0f : -1.0f;
    float nx = (cx + sgn * seed[2 * bf]) / seed_div;
    float ny = (cy + sgn * seed[2 * bf + 1]) / seed_div;
    bool ok_leg = true;

#pragma unroll 1
    for (int level = SL; level >= 0; --level) {
      const size_t plane_off = (size_t)b * (size_t)args.plane_size[level];
      const float scale = (float)(1 << level);
      const float prevx = cx / scale - half, prevy = cy / scale - half;
      if (level != SL) { nx = nx * 2.0f; ny = ny * 2.0f; }
      const float initx = nx - half, inity = ny - half;
      float outx, outy;
      const bool ok = track_level<LANES, REUSE>(
          sm, lane, live, args.planes[i_img][level] + plane_off,
          args.planes[j_img][level] + plane_off, args.rows[level],
          args.cols[level], args.stride[level], args.plane_rows[level],
          args.pad, level == 0, args.max_iters, args.eps2,
          args.min_eig_threshold, prevx, prevy, initx, inity, outx, outy);
      nx = outx + half;
      ny = outy + half;
      if (level == 0) ok_leg = ok;
    }
    // An invalid slot beside valid ones keeps its input.
    if (live) { cx = nx; cy = ny; }
    status = status & ok_leg;
    if (writer) {
      out[leg * leg_step] = cx;
      out[leg * leg_step + 1] = cy;
    }
  }
  if (writer) args.out_status[bf] = status ? 1 : 0;
}

struct LevelArgs {
  const float* I;
  const float* J;
  long long plane_size;  // elements of one sequence's plane
  int rows;
  int cols;
  int stride;
  int plane_rows;
  int pad;
  const float* prev;     // (B, n, 2)
  const float* init;     // (B, n, 2)
  const int32_t* valid;  // (B, n)
  float* out_pt;         // (B, n, 2)
  int32_t* out_ok;       // (B, n)
  int n;
  int finest;
  int max_iters;
  float eps2;
  float min_eig_threshold;
};

template <int LANES, bool REUSE>
__global__ void __launch_bounds__(32 * Group<LANES>::WARPS)
lk_level_kernel(const LevelArgs args) {
  using G = Group<LANES>;
  __shared__ Shared smem_all[G::PER_BLOCK];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x / LANES;
  const int f = blockIdx.x * G::PER_BLOCK + slot;
  const bool in_range = f < args.n;
  const size_t bf = (size_t)blockIdx.y * args.n + (in_range ? f : args.n - 1);
  const bool live = in_range && args.valid[bf] != 0;
  const float initx = args.init[2 * bf], inity = args.init[2 * bf + 1];
  float outx = initx, outy = inity;
  bool ok = false;
  // Invalid slots fail the level's gate: init passes through, status 0.
  if (__any_sync(0xffffffffu, live)) {
    const size_t plane_off = (size_t)blockIdx.y * (size_t)args.plane_size;
    ok = track_level<LANES, REUSE>(
        smem_all[slot], lane, live, args.I + plane_off, args.J + plane_off,
        args.rows, args.cols, args.stride, args.plane_rows, args.pad,
        args.finest != 0, args.max_iters, args.eps2, args.min_eig_threshold,
        args.prev[2 * bf], args.prev[2 * bf + 1], initx, inity, outx, outy);
  }
  if (in_range && (lane & (LANES - 1)) == 0) {
    args.out_pt[2 * bf] = outx;
    args.out_pt[2 * bf + 1] = outy;
    args.out_ok[bf] = ok ? 1 : 0;
  }
}

template <int LANES, bool REUSE>
struct Instance {
  using G = Group<LANES>;
  static dim3 grid(int n, int batch) {
    return dim3((n + G::PER_BLOCK - 1) / G::PER_BLOCK, batch);
  }
  static int quad(const QuadArgs& args, cudaStream_t stream) {
    lk_quad_kernel<LANES, REUSE><<<grid(args.n, args.batch), 32 * G::WARPS,
                                   0, stream>>>(args);
    return (int)cudaGetLastError();
  }
  static int level(const LevelArgs& args, int batch, cudaStream_t stream) {
    lk_level_kernel<LANES, REUSE><<<grid(args.n, batch), 32 * G::WARPS, 0,
                                    stream>>>(args);
    return (int)cudaGetLastError();
  }
  // info: registers a thread, static shared bytes a block, local (spill)
  // bytes a thread, threads a block, features a block, resident blocks an
  // SM.
  static int info(int level_kernel, int32_t* out) {
    const void* fn = level_kernel
        ? reinterpret_cast<const void*>(lk_level_kernel<LANES, REUSE>)
        : reinterpret_cast<const void*>(lk_quad_kernel<LANES, REUSE>);
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        32 * G::WARPS, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int32_t)a.sharedSizeBytes;
    out[2] = (int32_t)a.localSizeBytes;
    out[3] = 32 * G::WARPS;
    out[4] = G::PER_BLOCK;
    out[5] = blocks;
    return 0;
  }
};

// Runs Op<LANES, REUSE>::fn for the instance the flags name.
template <template <int, bool> class Op, typename Fn>
int dispatch(int doublestep, int packed, Fn fn) {
  if ((doublestep != 0 && doublestep != 1) || (packed != 0 && packed != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (packed) {
    return doublestep ? fn(Op<8, true>()) : fn(Op<8, false>());
  }
  return doublestep ? fn(Op<32, true>()) : fn(Op<32, false>());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Host arrays: plane_ptrs holds
// N_IMG * (start_level + 1) device pointers, image-major (L0, R0, R1, L1),
// each to a (batch, plane rows, row stride) buffer; dims holds (rows, cols,
// row stride, plane rows) for levels 0..start_level. pts, flow, disp are
// (batch, n, 2), valid and out_status (batch, n), out_pts (N_LEGS, batch,
// n, 2), all contiguous. doublestep (0/1) picks the REUSE instance, packed
// (0/1) LANES 8; REUSE needs 16-byte aligned planes with row strides of a
// multiple of 4 and at least JB_ROWS x JB_COLS. Returns cudaGetLastError()
// after the launch.
extern "C" int lk_quad_launch(const int64_t* plane_ptrs, const int32_t* dims,
                              const float* pts, const float* flow,
                              const float* disp, const int32_t* valid,
                              float* out_pts, int32_t* out_status, int n,
                              int batch, int start_level, int pad,
                              int max_iters, float eps2,
                              float min_eig_threshold, int doublestep,
                              int packed, void* stream) {
  if (start_level < 0 || start_level >= MAX_LEVELS || n <= 0 || batch <= 0
      || batch > 65535) {
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
    args.rows[lv] = dims[4 * lv];
    args.cols[lv] = dims[4 * lv + 1];
    args.stride[lv] = dims[4 * lv + 2];
    args.plane_rows[lv] = dims[4 * lv + 3];
    args.plane_size[lv] = (long long)dims[4 * lv + 3] * dims[4 * lv + 2];
  }
  args.pts = pts;
  args.flow = flow;
  args.disp = disp;
  args.valid = valid;
  args.out_pts = out_pts;
  args.out_status = out_status;
  args.n = n;
  args.batch = batch;
  args.start_level = start_level;
  args.pad = pad;
  args.max_iters = max_iters;
  args.eps2 = eps2;
  args.min_eig_threshold = min_eig_threshold;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<Instance>(doublestep, packed,
                            [&](auto inst) { return inst.quad(args, s); });
}

// Plain C entry point of the level kernel. I and J are (batch, plane rows,
// row stride) buffers of one level; prev, init, out_pt are (batch, n, 2),
// valid and out_ok (batch, n), all contiguous. doublestep and packed as for
// lk_quad_launch. Returns cudaGetLastError() after the launch.
extern "C" int lk_level_launch(const float* I, const float* J,
                               const float* prev, const float* init,
                               const int32_t* valid, float* out_pt,
                               int32_t* out_ok, int rows, int cols, int stride,
                               int plane_rows, int pad, int n, int batch,
                               int finest, int max_iters, float eps2,
                               float min_eig_threshold, int doublestep,
                               int packed, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  LevelArgs args{};
  args.I = I;
  args.J = J;
  args.plane_size = (long long)plane_rows * stride;
  args.rows = rows;
  args.cols = cols;
  args.stride = stride;
  args.plane_rows = plane_rows;
  args.pad = pad;
  args.prev = prev;
  args.init = init;
  args.valid = valid;
  args.out_pt = out_pt;
  args.out_ok = out_ok;
  args.n = n;
  args.finest = finest;
  args.max_iters = max_iters;
  args.eps2 = eps2;
  args.min_eig_threshold = min_eig_threshold;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<Instance>(doublestep, packed, [&](auto inst) {
    return inst.level(args, batch, s);
  });
}

// Resource use of one instance (level_kernel 0: lk_quad_kernel, 1:
// lk_level_kernel) on the current device, into info[6]: registers a thread,
// static shared bytes a block, local bytes a thread, threads a block,
// features a block, resident blocks an SM. Returns a CUDA error code.
extern "C" int lk_kernel_info(int level_kernel, int doublestep, int packed,
                              int32_t* info) {
  return dispatch<Instance>(doublestep, packed, [&](auto inst) {
    return inst.info(level_kernel, info);
  });
}
