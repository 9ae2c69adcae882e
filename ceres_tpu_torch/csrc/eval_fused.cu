// eval_fused: residuals, exact Jacobian and cost of the Snavely
// reprojection model, one thread per observation.
//
// Replaces the Pallas kernel eval_fused (ceres_tpu/ops/pallas_kernels.py:2066,
// pallas_call at :2492), for its Euclidean, trivial-loss use with
// rows_fn = snavely_residual_rows (ceres_tpu/models/bal.py:38).
//
// What bounds it on an H100: bytes. Per observation it reads 2 ids, the
// observation (2) and gathers a camera (9) and a point (3), about 300
// flops, and writes 2 residuals plus 24 Jacobian lanes: ~26 values out
// against ~300 flops, far below the card's flop-per-byte balance.
// The design therefore writes J transposed (24, B), so that consecutive
// threads store consecutive addresses of every lane; the camera table is
// tiny and stays in L1/L2; points are read almost in order because rows
// are sorted by point. The derivatives are exact: forward-mode dual
// numbers over the three angle-axis components for the rotation, closed
// form for the projection and distortion, all in registers. The cost is
// reduced deterministically: a fixed-order tree per block into one double
// partial per block, then one block sums the partials in order.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;

// value and its derivatives along the three angle-axis components
template <typename T>
struct D3 {
  T v, d0, d1, d2;
};

template <typename T>
__device__ __forceinline__ D3<T> add(D3<T> a, D3<T> b) {
  return {a.v + b.v, a.d0 + b.d0, a.d1 + b.d1, a.d2 + b.d2};
}
template <typename T>
__device__ __forceinline__ D3<T> sub(D3<T> a, D3<T> b) {
  return {a.v - b.v, a.d0 - b.d0, a.d1 - b.d1, a.d2 - b.d2};
}
template <typename T>
__device__ __forceinline__ D3<T> mul(D3<T> a, D3<T> b) {
  return {a.v * b.v, a.d0 * b.v + a.v * b.d0, a.d1 * b.v + a.v * b.d1,
          a.d2 * b.v + a.v * b.d2};
}
template <typename T>
__device__ __forceinline__ D3<T> scale(D3<T> a, T s) {
  return {a.v * s, a.d0 * s, a.d1 * s, a.d2 * s};
}
// a function of one dual argument with value fv and derivative dfv
template <typename T>
__device__ __forceinline__ D3<T> chain(D3<T> a, T fv, T dfv) {
  return {fv, dfv * a.d0, dfv * a.d1, dfv * a.d2};
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
eval_fused_kernel(const T* __restrict__ cams, const T* __restrict__ pts,
                  const T* __restrict__ obs, const int* __restrict__ cam_idx,
                  const int* __restrict__ pt_idx, int B, T* __restrict__ rT,
                  T* __restrict__ JT, double* __restrict__ partial) {
  __shared__ double sh[kThreads];
  int b = blockIdx.x * kThreads + threadIdx.x;
  double sq = 0.0;
  if (b < B) {
    const T* cam = cams + (long long)cam_idx[b] * kTF;
    const T* X = pts + (long long)pt_idx[b] * kTE;
    T X0 = X[0], X1 = X[1], X2 = X[2];

    // Branch-free Rodrigues, theta = sqrt(theta2 + 1e-30), as
    // snavely_residual_rows computes it.
    D3<T> ax = {cam[0], T(1), T(0), T(0)};
    D3<T> ay = {cam[1], T(0), T(1), T(0)};
    D3<T> az = {cam[2], T(0), T(0), T(1)};
    D3<T> theta2 = add(add(mul(ax, ax), mul(ay, ay)), mul(az, az));
    T th = sqrt(theta2.v + T(1e-30));
    D3<T> theta = chain(theta2, th, T(0.5) / th);
    T inv = T(1) / theta.v;
    D3<T> inv_t = chain(theta, inv, -inv * inv);
    D3<T> wx = mul(ax, inv_t), wy = mul(ay, inv_t), wz = mul(az, inv_t);
    T cv = cos(theta.v), sv = sin(theta.v);
    D3<T> ctd = chain(theta, cv, -sv);
    D3<T> std_ = chain(theta, sv, cv);
    D3<T> cxx = sub(scale(wy, X2), scale(wz, X1));
    D3<T> cyy = sub(scale(wz, X0), scale(wx, X2));
    D3<T> czz = sub(scale(wx, X1), scale(wy, X0));
    D3<T> wdp = add(add(scale(wx, X0), scale(wy, X1)), scale(wz, X2));
    D3<T> one_m_ct = {T(1) - ctd.v, -ctd.d0, -ctd.d1, -ctd.d2};
    D3<T> k = mul(wdp, one_m_ct);
    D3<T> p0 = add(add(scale(ctd, X0), mul(cxx, std_)), mul(wx, k));
    D3<T> p1 = add(add(scale(ctd, X1), mul(cyy, std_)), mul(wy, k));
    D3<T> p2 = add(add(scale(ctd, X2), mul(czz, std_)), mul(wz, k));
    T P0 = p0.v + cam[3], P1 = p1.v + cam[4], P2 = p2.v + cam[5];

    // dp/dX: the rotation matrix ct I + st [w]x + (1 - ct) w w'
    T c = ctd.v, s = std_.v, omc = T(1) - c;
    T w0 = wx.v, w1 = wy.v, w2 = wz.v;
    T R[3][3] = {
        {c + omc * w0 * w0, -s * w2 + omc * w0 * w1, s * w1 + omc * w0 * w2},
        {s * w2 + omc * w1 * w0, c + omc * w1 * w1, -s * w0 + omc * w1 * w2},
        {-s * w1 + omc * w2 * w0, s * w0 + omc * w2 * w1, c + omc * w2 * w2}};
    T dpa[3][3] = {{p0.d0, p0.d1, p0.d2},
                   {p1.d0, p1.d1, p1.d2},
                   {p2.d0, p2.d1, p2.d2}};

    // projection and distortion
    T f = cam[6], k1 = cam[7], k2 = cam[8];
    T xp = -P0 / P2, yp = -P1 / P2;
    T r2 = xp * xp + yp * yp;
    T dist = T(1) + r2 * (k1 + k2 * r2);
    T ddr2 = k1 + T(2) * k2 * r2;  // d dist / d r2
    T ddx = T(2) * xp * ddr2, ddy = T(2) * yp * ddr2;
    T res0 = f * dist * xp - obs[2 * (long long)b];
    T res1 = f * dist * yp - obs[2 * (long long)b + 1];
    // d res / d (xp, yp)
    T a00 = f * (dist + xp * ddx), a01 = f * xp * ddy;
    T a10 = f * yp * ddx, a11 = f * (dist + yp * ddy);
    // d (xp, yp) / d P
    T ip2 = T(1) / P2;
    T gx[3] = {-ip2, T(0), P0 * ip2 * ip2};
    T gy[3] = {T(0), -ip2, P1 * ip2 * ip2};
    T Jp[2][3];
    for (int m = 0; m < 3; ++m) {
      Jp[0][m] = a00 * gx[m] + a01 * gy[m];
      Jp[1][m] = a10 * gx[m] + a11 * gy[m];
    }

    T xy[2] = {xp, yp};
    for (int i = 0; i < 2; ++i) {
      T* Jf = JT + (long long)(i * kTF) * B + b;
      for (int j = 0; j < 3; ++j) {
        T v = Jp[i][0] * dpa[0][j] + Jp[i][1] * dpa[1][j] + Jp[i][2] * dpa[2][j];
        Jf[(long long)j * B] = v;
        Jf[(long long)(3 + j) * B] = Jp[i][j];
      }
      Jf[6LL * B] = dist * xy[i];
      Jf[7LL * B] = f * r2 * xy[i];
      Jf[8LL * B] = f * r2 * r2 * xy[i];
      T* Je = JT + (long long)(kEOff + i * kTE) * B + b;
      for (int j = 0; j < 3; ++j) {
        Je[(long long)j * B] =
            Jp[i][0] * R[0][j] + Jp[i][1] * R[1][j] + Jp[i][2] * R[2][j];
      }
    }
    rT[b] = res0;
    rT[(long long)B + b] = res1;
    T sqi = res0 * res0 + res1 * res1;
    sq = (double)sqi;
  }
  double tot = ct::block_sum<kThreads>(sq, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = tot;
}

// One block: the partials summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const double* __restrict__ partial, int n,
                    double* __restrict__ out) {
  __shared__ double sh[kThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partial[i];
  double tot = ct::block_sum<kThreads>(acc, sh);
  if (threadIdx.x == 0) out[0] = tot;
}

template <typename T>
int launch(const T* cams, const T* pts, const T* obs, const int* cam_idx,
           const int* pt_idx, int B, T* rT, T* JT, double* partial,
           double* cost, cudaStream_t stream) {
  int blocks = ct::ceil_div(B, kThreads);
  if (blocks > 0) {
    CT_LAUNCH(eval_fused_kernel<T>, blocks, kThreads, stream, cams, pts, obs,
              cam_idx, pt_idx, B, rT, JT, partial);
  }
  CT_LAUNCH(sum_partials_kernel, 1, kThreads, stream, partial, blocks, cost);
  return (int)cudaGetLastError();
}

}  // namespace

// Sum of squared residuals in `cost` (one double); rT (2, B), JT (24, B);
// `partial` is workspace of ceil(B / 256) doubles.
extern "C" int ct_eval_fused_f64(const double* cams, const double* pts,
                                 const double* obs, const int* cam_idx,
                                 const int* pt_idx, int B, double* rT,
                                 double* JT, double* partial, double* cost,
                                 cudaStream_t stream) {
  return launch<double>(cams, pts, obs, cam_idx, pt_idx, B, rT, JT, partial,
                        cost, stream);
}

extern "C" int ct_eval_fused_f32(const float* cams, const float* pts,
                                 const float* obs, const int* cam_idx,
                                 const int* pt_idx, int B, float* rT, float* JT,
                                 double* partial, double* cost,
                                 cudaStream_t stream) {
  return launch<float>(cams, pts, obs, cam_idx, pt_idx, B, rT, JT, partial,
                       cost, stream);
}
