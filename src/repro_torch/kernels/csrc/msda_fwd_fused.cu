// Fused whole-pyramid multi-scale deformable attention forward, for Hopper
// (sm_90a).  Inference only: no saved corners.
//
// Replaces the TPU kernel src/repro/kernels/msda_fwd.py::msda_fwd_fused
// (pallas_call at :504, body _fwd_fused_kernel at :377).  Same function:
// for every (b, q, h) and every level l, point p, bilinearly sample the
// level at loc[b,q,h,l,p] (grid_sample, align_corners=False, zero padding)
// with the 4 corners masked on validity, weight by attn[b,q,h,l,p], sum the
// points into a per-level fp32 partial, and fold the partials in level
// order (the reference's fori_loop fold, msda_fwd.py:427-441).
//
// Layout: the public MMCV layout, read in place.
//   value (B, S, H, D) fp32, S = sum_l H_l*W_l, levels back to back
//   loc   (B, Q, H, L, P, 2) fp32, last axis (x, y) in [0, 1]
//   attn  (B, Q, H, L, P) fp32
//   out   (B, Q, H*D) fp32
// The TPU kernel's (H+2, W+2) zero-padded, packed super-slab exists for
// VMEM residency and branch-free pair loads; here it would cost one more
// full pass over value and buy nothing, so corners are masked and skipped.
//
// What bounds it on an H100 (3.35 TB/s HBM, 67 TFLOP/s fp32): memory.  At
// paper geometry and B = 1 an encoder call must read value 89.4 MB + loc
// 111.7 MB + attn 55.9 MB and write out 89.4 MB: 346 MB, >= 103 us.  Its
// 4.5 GFLOP of fp32 take >= 67 us.  A decoder call (Q = 300) moves only
// what its 300 queries touch: loc 0.38 MB, attn 0.19 MB, out 0.31 MB and
// at most 300*8*20*4 corner rows of 128 B (<= 24.6 MB of value, fewer when
// corners repeat or fall outside), so it is launch and latency bound.
//
// Design: one warp per (b, q, h), split into 4 groups of 8 lanes.  Group g
// samples points p = g, g+4, ... of each level; each of its 8 lanes loads
// 4 consecutive channels of a corner as one float4, so a group reads a
// 32-channel corner as one 128-byte request and the warp has 4 points in
// flight per step.  That divides the corner arithmetic and the load
// instructions per warp by 4 against one point per warp step.  The
// groups' per-level partials are summed with two xor-shuffles, then folded
// into the output in level order.  Warps are numbered with h fastest, then
// q: the warps resident together on the card work on neighbouring queries
// of one image, whose corners overlap, so the ~7.2 GB of 128-byte corner
// reads an encoder call issues at B = 1 mostly hit the 50 MB L2 instead of
// HBM.  All offsets are 64-bit.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kGroups = 4;      // point groups per warp
constexpr int kGroupLanes = 8;  // lanes per group: 8 x float4 = 32 channels

struct LevelTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];  // first pixel of level l along S
};

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x += v.x * w;
  acc.y += v.y * w;
  acc.z += v.z * w;
  acc.w += v.w * w;
}

__device__ __forceinline__ float4 shfl_xor4(const float4& v, int mask) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask),
                     __shfl_xor_sync(0xffffffffu, v.z, mask),
                     __shfl_xor_sync(0xffffffffu, v.w, mask));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_fused_kernel(const float* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn,
                      float* __restrict__ out,
                      long long n_warps, long long S, long long Q, int H,
                      int D, int L, int P, LevelTable lv) {
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // whole warps exit together, so the full-mask shuffles below are safe
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroupLanes;
  const int j = lane % kGroupLanes;
  // warp = (b * Q + q) * H + h
  const int h = (int)(warp % H);
  const long long b = warp / H / Q;
  const long long HD = (long long)H * D;
  const long long LP = (long long)L * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  const float* value_bh = value + b * S * HD + (long long)h * D;
  float* out_w = out + warp * D;

  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + 4 * j;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const float* vl = value_bh + lv.start[l] * HD + c;
      float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = g; p < P; p += kGroups) {
        const long long i = (long long)l * P + p;
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_w) + i);
        const float a = __ldg(attn_w + i);
        const float px = xy.x * (float)Wl - 0.5f;
        const float py = xy.y * (float)Hl - 0.5f;
        const float x0f = floorf(px);
        const float y0f = floorf(py);
        const float lx = px - x0f;
        const float ly = py - y0f;
        // floor, then convert: truncation toward zero would be wrong for
        // px < 0.  The clamp keeps the conversion defined for any input and
        // changes no validity decision (both ends are out of range).
        const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)Wl);
        const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)Hl);
        const bool vx0 = x0 >= 0 && x0 < Wl;
        const bool vx1 = x0 + 1 >= 0 && x0 + 1 < Wl;
        const bool vy0 = y0 >= 0 && y0 < Hl;
        const bool vy1 = y0 + 1 >= 0 && y0 + 1 < Hl;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        if (vy0) {
          const float* row = vl + (long long)y0 * Wl * HD;
          if (vx0) fma4(s, (1.f - lx) * (1.f - ly),
                        __ldg(reinterpret_cast<const float4*>(row + (long long)x0 * HD)));
          if (vx1) fma4(s, lx * (1.f - ly),
                        __ldg(reinterpret_cast<const float4*>(row + (long long)(x0 + 1) * HD)));
        }
        if (vy1) {
          const float* row = vl + (long long)(y0 + 1) * Wl * HD;
          if (vx0) fma4(s, (1.f - lx) * ly,
                        __ldg(reinterpret_cast<const float4*>(row + (long long)x0 * HD)));
          if (vx1) fma4(s, lx * ly,
                        __ldg(reinterpret_cast<const float4*>(row + (long long)(x0 + 1) * HD)));
        }
        fma4(part, a, s);
      }
      // sum the 4 groups' partials (every lane ends with the same sum)
      const float4 o1 = shfl_xor4(part, kGroupLanes);
      part = make_float4(part.x + o1.x, part.y + o1.y, part.z + o1.z, part.w + o1.w);
      const float4 o2 = shfl_xor4(part, 2 * kGroupLanes);
      part = make_float4(part.x + o2.x, part.y + o2.y, part.z + o2.z, part.w + o2.w);
      // ordered level fold of rounded fp32 partials
      acc = make_float4(acc.x + part.x, acc.y + part.y, acc.z + part.z, acc.w + part.w);
    }
    if (g == 0) *reinterpret_cast<float4*>(out_w + c) = acc;
  }
}

}  // namespace

// level_hw: host array of 2*L ints (h0, w0, h1, w1, ...); level_start: host
// array of L int64 pixel offsets along S.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int msda_fwd_fused_launch(const void* value, const void* loc,
                                     const void* attn, void* out, long long B,
                                     long long S, long long Q, int H, int D,
                                     int L, int P, const void* level_hw,
                                     const void* level_start, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || H < 1 || D < 32 || D % 32 != 0 ||
      B < 1 || Q < 1 || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  LevelTable lv;
  const int* hw = static_cast<const int*>(level_hw);
  const long long* st = static_cast<const long long*>(level_start);
  for (int l = 0; l < L; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = st[l];
  }
  const long long n_warps = B * Q * H;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  msda_fwd_fused_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out), n_warps, S,
      Q, H, D, L, P, lv);
  return (int)cudaGetLastError();
}

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
