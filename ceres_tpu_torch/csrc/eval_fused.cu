// eval_fused: residuals, exact tangent-space Jacobian and cost of the
// Snavely reprojection model, with the camera as angle-axis (model 0) or as
// a unit quaternion under its manifold (model 1), and a robust loss applied
// by the Triggs corrector; one thread per observation.
//
// Replaces the Pallas kernel eval_fused (ceres_tpu/ops/pallas_kernels.py:2066,
// pallas_call at :2492) for the two row-vectorized residuals the JAX package
// ships: snavely_residual_rows (ceres_tpu/models/bal.py:38) on (C, 9)
// cameras and snavely_quat_residual_rows (:103) on (C, 10) cameras under
// ProductManifold(QuaternionManifold, EuclideanManifold(6)). It carries the
// kernel's two further branches: the manifold chain rule (pj_cols_f,
// :2323-2347), whose jvp tangents are the PlusJacobian columns, so that the
// camera lanes come out in the 9 tangent coordinates; and the in-kernel
// Triggs corrector (loss_rho, :2356-2402).
//
// What bounds it on an H100: bytes. Per observation it reads 2 ids, the
// observation (2) and gathers a camera (9 or 10) and a point (3), does a
// few hundred flops (about 400 with a loss), and writes 2 residuals plus 24
// Jacobian lanes: ~26 values out against ~300-400 flops, far below the
// card's flop-per-byte balance. The design therefore writes J transposed
// (24, B), so that consecutive threads store consecutive addresses of every
// lane; the camera table is tiny and stays in L1/L2; points are read almost
// in order because rows are sorted by point. The derivatives are exact, all
// in registers: forward-mode dual numbers over the three rotation tangent
// directions (for the quaternion, seeded with the PlusJacobian's columns,
// manifolds.py:233-246), closed forms for the point, projection and
// distortion. The loss is a chain of at most kMaxChain elementary ops passed
// by value (no device memory), each a __device__ function; the corrector
// then acts on the 24 lanes in registers before they are stored. The cost is
// reduced deterministically: a fixed-order tree per block into one double
// partial per block, then one block sums the partials in order.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;

constexpr double kTiny = 2.2250738585072014e-308;  // loss.py _TINY
constexpr int kMaxChain = 4;                        // loss.py MAX_CHAIN

}  // namespace

// A robust loss as loss.py's LossChain: n ops applied to (s, 1, 0), op k
// with code[k] (1 Huber, 2 SoftLOne, 3 Cauchy, 4 Arctan, 5 Tolerant, 6 Tukey,
// 7 scale by a) and parameters a[k], b[k]; n = 0 is the trivial loss.
struct CtLoss {
  int n;
  int code[kMaxChain];
  double a[kMaxChain];
  double b[kMaxChain];
};

namespace {

// value and its derivatives along three tangent directions
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

// The camera's rotation of X: P = R X, dP/d(rotation tangent) as dPr[m][j]
// and dP/dX as dPX[m][j].
template <typename T>
__device__ __forceinline__ void rotate_angle_axis(const T* cam, T X0, T X1,
                                                  T X2, T P[3], T dPr[3][3],
                                                  T dPX[3][3]) {
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
  D3<T> p[3] = {add(add(scale(ctd, X0), mul(cxx, std_)), mul(wx, k)),
                add(add(scale(ctd, X1), mul(cyy, std_)), mul(wy, k)),
                add(add(scale(ctd, X2), mul(czz, std_)), mul(wz, k))};
  for (int m = 0; m < 3; ++m) {
    P[m] = p[m].v;
    dPr[m][0] = p[m].d0;
    dPr[m][1] = p[m].d1;
    dPr[m][2] = p[m].d2;
  }
  // dP/dX: the rotation matrix ct I + st [w]x + (1 - ct) w w'
  T c = ctd.v, s = std_.v, omc = T(1) - c;
  T w0 = wx.v, w1 = wy.v, w2 = wz.v;
  T R[3][3] = {
      {c + omc * w0 * w0, -s * w2 + omc * w0 * w1, s * w1 + omc * w0 * w2},
      {s * w2 + omc * w1 * w0, c + omc * w1 * w1, -s * w0 + omc * w1 * w2},
      {-s * w1 + omc * w2 * w0, s * w0 + omc * w2 * w1, c + omc * w2 * w2}};
  for (int m = 0; m < 3; ++m)
    for (int j = 0; j < 3; ++j) dPX[m][j] = R[m][j];
}

template <typename T>
__device__ __forceinline__ void rotate_quaternion(const T* cam, T X0, T X1,
                                                  T X2, T P[3], T dPr[3][3],
                                                  T dPX[3][3]) {
  // q = [w, x, y, z] seeded with the columns of the QuaternionManifold's
  // PlusJacobian [[-x,-y,-z],[w,z,-y],[-z,w,x],[y,-x,w]]: the derivatives
  // come out along the tangent, as the JAX kernel's pj_cols_f jvps.
  T qw = cam[0], qx = cam[1], qy = cam[2], qz = cam[3];
  D3<T> w = {qw, -qx, -qy, -qz};
  D3<T> x = {qx, qw, qz, -qy};
  D3<T> y = {qy, -qz, qw, qx};
  D3<T> z = {qz, qy, -qx, qw};
  // uv = v x p; uuv = v x uv; P = p + 2 (w uv + uuv), as
  // snavely_quat_residual_rows computes it
  D3<T> uvx = sub(scale(y, X2), scale(z, X1));
  D3<T> uvy = sub(scale(z, X0), scale(x, X2));
  D3<T> uvz = sub(scale(x, X1), scale(y, X0));
  D3<T> uux = sub(mul(y, uvz), mul(z, uvy));
  D3<T> uuy = sub(mul(z, uvx), mul(x, uvz));
  D3<T> uuz = sub(mul(x, uvy), mul(y, uvx));
  D3<T> p[3] = {add(mul(w, uvx), uux), add(mul(w, uvy), uuy),
                add(mul(w, uvz), uuz)};
  T X[3] = {X0, X1, X2};
  for (int m = 0; m < 3; ++m) {
    P[m] = X[m] + T(2) * p[m].v;
    dPr[m][0] = T(2) * p[m].d0;
    dPr[m][1] = T(2) * p[m].d1;
    dPr[m][2] = T(2) * p[m].d2;
  }
  // dP/dX = (1 - 2|v|^2) I + 2 w [v]x + 2 v v'
  T d = T(1) - T(2) * (qx * qx + qy * qy + qz * qz);
  T v[3] = {qx, qy, qz};
  T vx[3][3] = {{T(0), -qz, qy}, {qz, T(0), -qx}, {-qy, qx, T(0)}};
  for (int m = 0; m < 3; ++m)
    for (int j = 0; j < 3; ++j)
      dPX[m][j] = (m == j ? d : T(0)) + T(2) * qw * vx[m][j] +
                  T(2) * v[m] * v[j];
}

template <typename T>
struct Rho {
  T r0, r1, r2;
};

// the larger of a and b, for float and double alike
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a < b ? b : a;
}

template <typename T>
__device__ __forceinline__ T floor_tiny(T x) {
  return tmax(x, T(kTiny));
}

// rho(s) and its two derivatives of one base loss, as loss.py computes it,
// the loss's constants taken in double and then in T.
template <typename T>
__device__ Rho<T> base_loss(int code, double a, double b, T s) {
  switch (code) {
    case 1: {  // Huber
      T bb = T(a * a);
      T r = sqrt(floor_tiny(s));
      if (s > bb) {
        T r1 = floor_tiny(T(a) / r);
        return {T(2.0 * a) * r - bb, r1, -r1 / (T(2) * floor_tiny(s))};
      }
      return {s, T(1), T(0)};
    }
    case 2: {  // SoftLOne
      double bb = a * a, c = 1.0 / bb;
      T total = T(1) + s * T(c);
      T tmp = sqrt(total);
      T r1 = floor_tiny(T(1) / tmp);
      return {T(2.0 * bb) * (tmp - T(1)), r1, -(T(c) * r1) / (T(2) * total)};
    }
    case 3: {  // Cauchy
      double bb = a * a, c = 1.0 / bb;
      T total = T(1) + s * T(c);
      T inv = T(1) / total;
      return {T(bb) * log(total), floor_tiny(inv), T(-c) * inv * inv};
    }
    case 4: {  // Arctan
      double bb = 1.0 / (a * a);
      T inv = T(1) / (T(1) + s * s * T(bb));
      return {T(a) * atan2(s, T(a)), floor_tiny(inv),
              T(-2) * s * T(bb) * inv * inv};
    }
    case 5: {  // Tolerant
      double c = b * log1p(exp(-a / b));
      T x = (s - T(a)) / T(b);
      if (x > T(36)) return {s - T(a) - T(c), T(1), T(0)};
      T e_x = exp(x);
      return {T(b) * log1p(e_x) - T(c), floor_tiny(e_x / (T(1) + e_x)),
              T(0.5) / (T(b) * (T(1) + cosh(x)))};
    }
    default: {  // Tukey
      double a2 = a * a;
      if (s <= T(a2)) {
        T value = T(1) - s / T(a2);
        T value_sq = value * value;
        return {T(a2 / 3.0) * (T(1) - value_sq * value), value_sq,
                T(-2.0 / a2) * value};
      }
      return {T(a2 / 3.0), T(0), T(0)};
    }
  }
}

// The chain applied to (s, 1, 0) innermost first (loss.py evaluate_chain).
template <typename T>
__device__ Rho<T> loss_chain(const CtLoss& loss, T s) {
  Rho<T> g = {s, T(1), T(0)};
  // unrolled, so that every op is read from the parameter bank at a fixed
  // offset and the descriptor is not copied to local memory
#pragma unroll
  for (int k = 0; k < kMaxChain; ++k) {
    if (k >= loss.n) break;
    if (loss.code[k] == 7) {
      T a = T(loss.a[k]);
      g = {a * g.r0, a * g.r1, a * g.r2};
      continue;
    }
    Rho<T> f = base_loss<T>(loss.code[k], loss.a[k], loss.b[k], g.r0);
    g = k == 0 ? f : Rho<T>{f.r0, f.r1 * g.r1, f.r2 * g.r1 * g.r1 + f.r1 * g.r2};
  }
  return g;
}

constexpr int kThreads = 256;

// Model 0: cams (C, 9) [angle-axis, t, f, k1, k2]; model 1: cams (C, 10)
// [q (w, x, y, z), t, f, k1, k2].
template <typename T, int kModel>
__global__ void __launch_bounds__(kThreads)
eval_fused_kernel(const T* __restrict__ cams, const T* __restrict__ pts,
                  const T* __restrict__ obs, const int* __restrict__ cam_idx,
                  const int* __restrict__ pt_idx, int B, CtLoss loss,
                  T* __restrict__ rT, T* __restrict__ JT,
                  double* __restrict__ partial) {
  constexpr int kCam = kModel == 0 ? 9 : 10;
  constexpr int kT = kCam - 6;  // first translation parameter
  __shared__ double sh[kThreads];
  int b = blockIdx.x * kThreads + threadIdx.x;
  double sq = 0.0;
  if (b < B) {
    const T* cam = cams + (long long)cam_idx[b] * kCam;
    const T* X = pts + (long long)pt_idx[b] * kTE;
    T X0 = X[0], X1 = X[1], X2 = X[2];
    T Pr[3], dPr[3][3], dPX[3][3];
    if (kModel == 0) {
      rotate_angle_axis(cam, X0, X1, X2, Pr, dPr, dPX);
    } else {
      rotate_quaternion(cam, X0, X1, X2, Pr, dPr, dPX);
    }
    T P0 = Pr[0] + cam[kT], P1 = Pr[1] + cam[kT + 1], P2 = Pr[2] + cam[kT + 2];

    // projection and distortion
    T f = cam[kT + 3], k1 = cam[kT + 4], k2 = cam[kT + 5];
    T xp = -P0 / P2, yp = -P1 / P2;
    T r2 = xp * xp + yp * yp;
    T dist = T(1) + r2 * (k1 + k2 * r2);
    T ddr2 = k1 + T(2) * k2 * r2;  // d dist / d r2
    T ddx = T(2) * xp * ddr2, ddy = T(2) * yp * ddr2;
    T res[2] = {f * dist * xp - obs[2 * (long long)b],
                f * dist * yp - obs[2 * (long long)b + 1]};
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

    // J[i][0..8] camera tangent lanes, J[i][9..11] point lanes
    T J[2][kTF + kTE];
    T xy[2] = {xp, yp};
    for (int i = 0; i < 2; ++i) {
      for (int j = 0; j < 3; ++j) {
        J[i][j] = Jp[i][0] * dPr[0][j] + Jp[i][1] * dPr[1][j] +
                  Jp[i][2] * dPr[2][j];
        J[i][3 + j] = Jp[i][j];
        J[i][kTF + j] = Jp[i][0] * dPX[0][j] + Jp[i][1] * dPX[1][j] +
                        Jp[i][2] * dPX[2][j];
      }
      J[i][6] = dist * xy[i];
      J[i][7] = f * r2 * xy[i];
      J[i][8] = f * r2 * r2 * xy[i];
    }

    T s = res[0] * res[0] + res[1] * res[1];
    T cost = s;
    if (loss.n > 0) {
      // The Triggs corrector (pallas_kernels.py:2356-2402): rho' clamped
      // at 1e-30, J corrected with the raw residuals, then r scaled; the
      // cost partial is rho(s).
      Rho<T> rho = loss_chain<T>(loss, s);
      T rho1 = tmax(rho.r1, T(1e-30));
      bool simple = (s == T(0)) || (rho.r2 <= T(0));
      T safe_sq = simple ? T(1) : s;
      T sqrt_r1 = sqrt(rho1);
      T D = T(1) + T(2) * safe_sq * (simple ? T(0) : rho.r2) / rho1;
      T alpha = T(1) - sqrt(tmax(D, T(0)));
      T rs = simple ? sqrt_r1 : sqrt_r1 / (T(1) - alpha);
      T asq = simple ? T(0) : alpha / safe_sq;
      T ar0 = asq * res[0], ar1 = asq * res[1];
      for (int c = 0; c < kTF + kTE; ++c) {
        T rtj = res[0] * J[0][c] + res[1] * J[1][c];
        J[0][c] = (J[0][c] - ar0 * rtj) * sqrt_r1;
        J[1][c] = (J[1][c] - ar1 * rtj) * sqrt_r1;
      }
      res[0] = rs * res[0];
      res[1] = rs * res[1];
      cost = rho.r0;
    }

    for (int i = 0; i < 2; ++i) {
      T* Jf = JT + (long long)(i * kTF) * B + b;
      for (int j = 0; j < kTF; ++j) Jf[(long long)j * B] = J[i][j];
      T* Je = JT + (long long)(kEOff + i * kTE) * B + b;
      for (int j = 0; j < kTE; ++j) Je[(long long)j * B] = J[i][kTF + j];
    }
    rT[b] = res[0];
    rT[(long long)B + b] = res[1];
    sq = (double)cost;
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
           const int* pt_idx, int B, int model, CtLoss loss, T* rT, T* JT,
           double* partial, double* cost, cudaStream_t stream) {
  if ((model != 0 && model != 1) || loss.n < 0 || loss.n > kMaxChain)
    return (int)cudaErrorInvalidValue;
  int blocks = ct::ceil_div(B, kThreads);
  if (blocks > 0) {
    auto kernel = model == 0 ? eval_fused_kernel<T, 0> : eval_fused_kernel<T, 1>;
    CT_LAUNCH(kernel, blocks, kThreads, stream, cams, pts, obs, cam_idx, pt_idx,
              B, loss, rT, JT, partial);
  }
  CT_LAUNCH(sum_partials_kernel, 1, kThreads, stream, partial, blocks, cost);
  return (int)cudaGetLastError();
}

}  // namespace

// The cost partials' sum in `cost` (one double): sum |r|^2 with the trivial
// loss (loss.n = 0), else sum rho(|r|^2); rT (2, B) and JT (24, B) the
// corrected residuals and tangent-space Jacobian lanes; `partial` is
// workspace of ceil(B / 256) doubles. model 0: cams (C, 9), model 1: (C, 10).
extern "C" int ct_eval_fused_f64(const double* cams, const double* pts,
                                 const double* obs, const int* cam_idx,
                                 const int* pt_idx, int B, int model,
                                 CtLoss loss, double* rT, double* JT,
                                 double* partial, double* cost,
                                 cudaStream_t stream) {
  return launch<double>(cams, pts, obs, cam_idx, pt_idx, B, model, loss, rT,
                        JT, partial, cost, stream);
}

extern "C" int ct_eval_fused_f32(const float* cams, const float* pts,
                                 const float* obs, const int* cam_idx,
                                 const int* pt_idx, int B, int model,
                                 CtLoss loss, float* rT, float* JT,
                                 double* partial, double* cost,
                                 cudaStream_t stream) {
  return launch<float>(cams, pts, obs, cam_idx, pt_idx, B, model, loss, rT, JT,
                       partial, cost, stream);
}
