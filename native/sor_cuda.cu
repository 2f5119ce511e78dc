// Fused multi-sweep red-black SOR for the variational flow solver
// (rs_sfm_tpu/flow/dense.py _level_solve), called from JAX through the
// foreign function interface (rs_sfm_tpu/ops/sor_cuda.py).
//
// The XLA loop streams every coefficient plane through device memory on
// each half-sweep.  Here one block loads a tile of all planes, with a halo
// of 2*S rows and columns, into shared memory, runs S red-black sweeps
// there and writes back only the tile's interior.  The dependence cone of
// the 4-neighbour stencil grows by one pixel per colour, so after S sweeps
// every interior pixel equals what S global sweeps produce.  Pixels outside
// the image are never updated and never read: the Neumann boundary (the
// missing neighbour beyond an image edge is the pixel itself) is applied at
// the global edges.  Nothing carries between blocks.
//
// The per-pixel arithmetic repeats the XLA loop's expressions in the same
// order (_point_solve in dense.py), with the reciprocal square roots XLA's
// simplifier makes of its w / sqrt(x), so the two agree to rounding.
//
// Plane order of the (10, H, W) input: ix iy it ixx ixy iyy gtx gty u0 v0.

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kTileY = 32;    // interior rows per block
constexpr int kTileX = 64;    // interior columns per block
constexpr int kSweeps = 4;    // sweeps per launch (halo = 2 * sweeps)
constexpr int kThreads = 512;
constexpr int kPlanes = 10;

struct Params {
  float omega, lam, eps2, wbr, wgrad;
};

__host__ __device__ constexpr int WindowPixels(int sweeps) {
  return (kTileY + 4 * sweeps) * (kTileX + 4 * sweeps);
}

__global__ void __launch_bounds__(kThreads)
SorPass(const float* __restrict__ planes, const float* __restrict__ u_in,
        const float* __restrict__ v_in, float* __restrict__ u_out,
        float* __restrict__ v_out, int h, int w, int sweeps, Params p) {
  extern __shared__ float smem[];
  const int halo = 2 * sweeps;
  const int wy = kTileY + 2 * halo;
  const int wx = kTileX + 2 * halo;
  const int n = wy * wx;
  float* su = smem + kPlanes * n;
  float* sv = su + n;
  const int y0 = blockIdx.y * kTileY - halo;
  const int x0 = blockIdx.x * kTileX - halo;
  const size_t plane = static_cast<size_t>(h) * w;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ly = i / wx;
    const int lx = i - ly * wx;
    const int gy = min(max(y0 + ly, 0), h - 1);
    const int gx = min(max(x0 + lx, 0), w - 1);
    const size_t g = static_cast<size_t>(gy) * w + gx;
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) smem[k * n + i] = planes[k * plane + g];
    su[i] = u_in[g];
    sv[i] = v_in[g];
  }
  __syncthreads();

  const int half = (wx + 1) / 2;
  for (int s = 0; s < sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      for (int j = threadIdx.x; j < wy * half; j += blockDim.x) {
        const int ly = j / half;
        const int gy = y0 + ly;
        // The checkerboard colour is (gy + gx) mod 2 in global coordinates.
        const int lx = 2 * (j - ly * half) + ((color + gy + x0) & 1);
        const int gx = x0 + lx;
        if (lx >= wx || gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
        const int i = ly * wx + lx;
        const float ix = smem[0 * n + i], iy = smem[1 * n + i];
        const float it = smem[2 * n + i], ixx = smem[3 * n + i];
        const float ixy = smem[4 * n + i], iyy = smem[5 * n + i];
        const float gtx = smem[6 * n + i], gty = smem[7 * n + i];
        const float u0 = smem[8 * n + i], v0 = smem[9 * n + i];
        const float uc = su[i], vc = sv[i];
        // Neighbours beyond the window edge lie outside the dependence
        // cone of the interior; any value will do there.
        const bool top = gy == 0 || ly == 0;
        const bool bot = gy == h - 1 || ly == wy - 1;
        const bool lft = gx == 0 || lx == 0;
        const bool rgt = gx == w - 1 || lx == wx - 1;
        const float ubar = (((top ? uc : su[i - wx]) + (bot ? uc : su[i + wx]))
                            + (lft ? uc : su[i - 1]) + (rgt ? uc : su[i + 1]))
                           * 0.25f;
        const float vbar = (((top ? vc : sv[i - wx]) + (bot ? vc : sv[i + wx]))
                            + (lft ? vc : sv[i - 1]) + (rgt ? vc : sv[i + 1]))
                           * 0.25f;
        const float du = uc - u0;
        const float dv = vc - v0;
        const float r = ix * du + iy * dv + it;
        const float wd = p.wbr * rsqrtf(r * r + p.eps2);
        const float rgx = gtx + ixx * du + ixy * dv;
        const float rgy = gty + ixy * du + iyy * dv;
        const float wg = p.wgrad * rsqrtf(rgx * rgx + rgy * rgy + p.eps2);
        const float c = it - ix * u0 - iy * v0;
        const float cgx = gtx - ixx * u0 - ixy * v0;
        const float cgy = gty - ixy * u0 - iyy * v0;
        const float a11 = p.lam + wd * ix * ix + wg * (ixx * ixx + ixy * ixy);
        const float a12 = wd * ix * iy + wg * (ixx * ixy + ixy * iyy);
        const float a22 = p.lam + wd * iy * iy + wg * (ixy * ixy + iyy * iyy);
        const float b1 =
            p.lam * ubar - wd * ix * c - wg * (ixx * cgx + ixy * cgy);
        const float b2 =
            p.lam * vbar - wd * iy * c - wg * (ixy * cgx + iyy * cgy);
        float det = a11 * a22 - a12 * a12;
        if (fabsf(det) < 1e-12f) det = 1e-12f;
        const float un = (a22 * b1 - a12 * b2) / det;
        const float vn = (a11 * b2 - a12 * b1) / det;
        su[i] = uc + p.omega * (un - uc);
        sv[i] = vc + p.omega * (vn - vc);
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < kTileY * kTileX; i += blockDim.x) {
    const int ty = i / kTileX;
    const int tx = i - ty * kTileX;
    const int gy = blockIdx.y * kTileY + ty;
    const int gx = blockIdx.x * kTileX + tx;
    if (gy < h && gx < w) {
      const int li = (ty + halo) * wx + tx + halo;
      const size_t g = static_cast<size_t>(gy) * w + gx;
      u_out[g] = su[li];
      v_out[g] = sv[li];
    }
  }
}

ffi::Error SorSweepsImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> planes,
                         ffi::Buffer<ffi::F32> u, ffi::Buffer<ffi::F32> v,
                         ffi::ResultBuffer<ffi::F32> u_out,
                         ffi::ResultBuffer<ffi::F32> v_out,
                         ffi::ResultBuffer<ffi::F32> scratch, int32_t iters,
                         float omega, float lam, float eps2, float wbr,
                         float wgrad) {
  const auto dims = u.dimensions();
  const auto pdims = planes.dimensions();
  if (dims.size() != 2 || pdims.size() != 3 || pdims[0] != kPlanes ||
      pdims[1] != dims[0] || pdims[2] != dims[1] || iters < 1) {
    return ffi::Error::InvalidArgument(
        "rs_sor_sweeps: expects planes (10, H, W), u and v (H, W), "
        "iters >= 1");
  }
  const int h = static_cast<int>(dims[0]);
  const int w = static_cast<int>(dims[1]);
  const size_t smem_max =
      (kPlanes + 2) * WindowPixels(kSweeps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      SorPass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_max));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));

  const Params p{omega, lam, eps2, wbr, wgrad};
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const int n_full = iters / kSweeps;
  const int rem = iters % kSweeps;
  const int n_pass = n_full + (rem ? 1 : 0);
  float* su = scratch->typed_data();
  float* sv = su + static_cast<size_t>(h) * w;
  const float* ui = u.typed_data();
  const float* vi = v.typed_data();
  for (int pass = 0; pass < n_pass; ++pass) {
    const int sweeps = pass < n_full ? kSweeps : rem;
    // Ping-pong so that the last pass writes the results.
    const bool last_parity = (n_pass - 1 - pass) % 2 == 0;
    float* uo = last_parity ? u_out->typed_data() : su;
    float* vo = last_parity ? v_out->typed_data() : sv;
    const size_t smem = (kPlanes + 2) * WindowPixels(sweeps) * sizeof(float);
    SorPass<<<grid, kThreads, smem, stream>>>(planes.typed_data(), ui, vi, uo,
                                              vo, h, w, sweeps, p);
    ui = uo;
    vi = vo;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RsSorSweeps, SorSweepsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("iters")
                                  .Attr<float>("omega")
                                  .Attr<float>("lam")
                                  .Attr<float>("eps2")
                                  .Attr<float>("wbr")
                                  .Attr<float>("wgrad"));
