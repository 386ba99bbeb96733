// Device tile models: closed-form dynamics, Jacobians and cost
// derivatives for the fused step and candidate kernels.
//
// Device counterparts of ratilqr_tpu/ops/tile_model.py
// (unicycle_tile_model :68, cartpole_tile_model :121, quadrotor_tile_model
// :199, lqr_tile_model :285) and of the plain-torch mirrors in
// ratilqr_tpu_torch/ops/tile_model.py, formula for formula.  A model holds
// its scalar parameters; the kernel is templated on it.
#pragma once

#include <math.h>

#include "smallmat.cuh"

namespace rq {

// Model ids, shared with ratilqr_tpu_torch/ops/tile_model.py.
enum ModelId { kUnicycle = 0, kLqr = 1, kQuadrotor = 2, kCartpole = 3 };

// Parameter slots a kernel takes (tile_model.MAX_PARAMS); unused slots are 0.
constexpr int kMaxParams = 8;
using Params = double[kMaxParams];

// Unicycle (n=3, m=2): parameters (dt, goal_x, goal_y).
template <typename T>
struct Unicycle {
  static constexpr int N = 3;
  static constexpr int M = 2;
  T dt, gx, gy;

  __device__ explicit Unicycle(const Params& p) : dt(T(p[0])), gx(T(p[1])), gy(T(p[2])) {}

  __device__ void f(const T (&x)[N], const T (&u)[M], T (&xn)[N]) const {
    const T s = sin(x[2]), c = cos(x[2]);
    xn[0] = x[0] + dt * u[0] * c;
    xn[1] = x[1] + dt * u[0] * s;
    xn[2] = x[2] + dt * u[1];
  }

  __device__ void jac(const T (&x)[N], const T (&u)[M], T (&A)[N][N], T (&B)[N][M]) const {
    const T s = sin(x[2]), c = cos(x[2]);
    A[0][0] = T(1); A[0][1] = T(0); A[0][2] = -dt * u[0] * s;
    A[1][0] = T(0); A[1][1] = T(1); A[1][2] = dt * u[0] * c;
    A[2][0] = T(0); A[2][1] = T(0); A[2][2] = T(1);
    B[0][0] = dt * c; B[0][1] = T(0);
    B[1][0] = dt * s; B[1][1] = T(0);
    B[2][0] = T(0);   B[2][1] = dt;
  }

  __device__ void quad(int, const T (&x)[N], const T (&u)[M], T& q, T (&qv)[N], T (&Q)[N][N],
                       T (&r)[M], T (&R)[M][M], T (&P)[M][N]) const {
    const T dx[N] = {x[0] - gx, x[1] - gy, x[2]};
    q = T(0.05) * (dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]) +
        T(0.05) * (u[0] * u[0] + u[1] * u[1]);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      qv[i] = T(0.1) * dx[i];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? T(0.1) : T(0);
    }
#pragma unroll (rq::Unroll<M>::value)
    for (int i = 0; i < M; ++i) {
      r[i] = T(0.1) * u[i];
#pragma unroll (rq::Unroll<M>::value)
      for (int j = 0; j < M; ++j) R[i][j] = (i == j) ? T(0.1) : T(0);
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) P[i][j] = T(0);
    }
  }

  __device__ void term(const T (&x)[N], T& q, T (&qv)[N], T (&Q)[N][N]) const {
    const T dx[N] = {x[0] - gx, x[1] - gy, x[2]};
    q = T(10) * (dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      qv[i] = T(20) * dx[i];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? T(20) : T(0);
    }
  }
};

// Quadratic 2-D integrator (n=2, m=2): f = x + u,
// c = ½·wx·x·x + wu·u·u, h = ½·wh·x·x; parameters (wx, wu, wh).
template <typename T>
struct Lqr {
  static constexpr int N = 2;
  static constexpr int M = 2;
  T hwx, wx, wu, twu, hwh, wh;

  __device__ explicit Lqr(const Params& p)
      : hwx(T(0.5 * p[0])), wx(T(p[0])), wu(T(p[1])), twu(T(2.0 * p[1])),
        hwh(T(0.5 * p[2])), wh(T(p[2])) {}

  __device__ void f(const T (&x)[N], const T (&u)[M], T (&xn)[N]) const {
    xn[0] = x[0] + u[0];
    xn[1] = x[1] + u[1];
  }

  __device__ void jac(const T (&)[N], const T (&)[M], T (&A)[N][N], T (&B)[N][M]) const {
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i)
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) {
        A[i][j] = (i == j) ? T(1) : T(0);
        B[i][j] = (i == j) ? T(1) : T(0);
      }
  }

  __device__ void quad(int, const T (&x)[N], const T (&u)[M], T& q, T (&qv)[N], T (&Q)[N][N],
                       T (&r)[M], T (&R)[M][M], T (&P)[M][N]) const {
    q = hwx * (x[0] * x[0] + x[1] * x[1]) + wu * (u[0] * u[0] + u[1] * u[1]);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      qv[i] = wx * x[i];
      r[i] = twu * u[i];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) {
        Q[i][j] = (i == j) ? wx : T(0);
        R[i][j] = (i == j) ? twu : T(0);
        P[i][j] = T(0);
      }
    }
  }

  __device__ void term(const T (&x)[N], T& q, T (&qv)[N], T (&Q)[N][N]) const {
    q = hwh * (x[0] * x[0] + x[1] * x[1]);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      qv[i] = wh * x[i];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? wh : T(0);
    }
  }
};

// Cart-pole with φ measured from upright (n=4, m=1): state (x, ẋ, φ, φ̇),
// control the horizontal force; parameters (dt, mc, mp, lp, grav).  The
// Jacobians expand phi_acc = N(φ)/D(φ) by the quotient rule, as the Pallas
// tile model does.  The 1x1 control blocks make H + μI's factor a square
// root and P a 1x4 row.
template <typename T>
struct Cartpole {
  static constexpr int N = 4;
  static constexpr int M = 1;
  T dt, mp, lp, grav, Mt, k1;

  __device__ explicit Cartpole(const Params& p)
      : dt(T(p[0])), mp(T(p[2])), lp(T(p[3])), grav(T(p[4])), Mt(T(p[1] + p[2])),
        k1(T(p[2] * p[3] / (p[1] + p[2]))) {}

  // temp, D, N and phi_acc of the dynamics at (x, u).
  __device__ void accel(const T (&x)[N], const T (&u)[M], T s, T c, T& temp, T& D, T& Nn,
                        T& phi_acc) const {
    const T om = x[3];
    temp = (u[0] + mp * lp * om * om * s) / Mt;
    D = lp * (T(4.0 / 3.0) - mp * c * c / Mt);
    Nn = grav * s - c * temp;
    phi_acc = Nn / D;
  }

  __device__ void f(const T (&x)[N], const T (&u)[M], T (&xn)[N]) const {
    const T s = sin(x[2]), c = cos(x[2]);
    T temp, D, Nn, phi_acc;
    accel(x, u, s, c, temp, D, Nn, phi_acc);
    const T acc = temp - k1 * phi_acc * c;
    xn[0] = x[0] + dt * x[1];
    xn[1] = x[1] + dt * acc;
    xn[2] = x[2] + dt * x[3];
    xn[3] = x[3] + dt * phi_acc;
  }

  __device__ void jac(const T (&x)[N], const T (&u)[M], T (&A)[N][N], T (&B)[N][M]) const {
    const T om = x[3];
    const T s = sin(x[2]), c = cos(x[2]);
    T temp, D, Nn, phi_acc;
    accel(x, u, s, c, temp, D, Nn, phi_acc);
    const T dtemp_dphi = k1 * om * om * c;
    const T dtemp_dom = T(2) * k1 * om * s;
    const T dtemp_dF = T(1) / Mt;
    const T dN_dphi = grav * c + s * temp - c * dtemp_dphi;
    const T dD_dphi = T(2) * lp * mp * c * s / Mt;
    const T dpa_dphi = (dN_dphi * D - Nn * dD_dphi) / (D * D);
    const T dpa_dom = -c * dtemp_dom / D;
    const T dpa_dF = -c * dtemp_dF / D;
    const T dacc_dphi = dtemp_dphi - k1 * (dpa_dphi * c - phi_acc * s);
    const T dacc_dom = dtemp_dom - k1 * c * dpa_dom;
    const T dacc_dF = dtemp_dF - k1 * c * dpa_dF;
    A[0][0] = T(1); A[0][1] = dt;   A[0][2] = T(0);           A[0][3] = T(0);
    A[1][0] = T(0); A[1][1] = T(1); A[1][2] = dt * dacc_dphi; A[1][3] = dt * dacc_dom;
    A[2][0] = T(0); A[2][1] = T(0); A[2][2] = T(1);           A[2][3] = dt;
    A[3][0] = T(0); A[3][1] = T(0); A[3][2] = dt * dpa_dphi;  A[3][3] = T(1) + dt * dpa_dom;
    B[0][0] = T(0);
    B[1][0] = dt * dacc_dF;
    B[2][0] = T(0);
    B[3][0] = dt * dpa_dF;
  }

  __device__ void quad(int, const T (&x)[N], const T (&u)[M], T& q, T (&qv)[N], T (&Q)[N][N],
                       T (&r)[M], T (&R)[M][M], T (&P)[M][N]) const {
    q = T(0.1) * (x[0] * x[0] + x[1] * x[1] + T(10) * x[2] * x[2] + x[3] * x[3]) +
        T(0.05) * u[0] * u[0];
    const T w[N] = {T(0.2), T(0.2), T(2), T(0.2)};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = w[i] * x[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? w[i] : T(0);
      P[0][i] = T(0);
    }
    r[0] = T(0.1) * u[0];
    R[0][0] = T(0.1);
  }

  __device__ void term(const T (&x)[N], T& q, T (&qv)[N], T (&Q)[N][N]) const {
    q = T(10) * (x[0] * x[0] + x[1] * x[1] + T(10) * x[2] * x[2] + x[3] * x[3]);
    const T w[N] = {T(20), T(20), T(200), T(20)};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = w[i] * x[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? w[i] : T(0);
    }
  }
};

// Small-angle quadrotor (n=12, m=4): state (position, velocity, roll/pitch/
// yaw, body rates), control (thrust offset, three torques); parameters
// (dt, grav, goal_x, goal_y, goal_z).  Only the acceleration rows are
// nonlinear; the dense blocks are written in full, as the Pallas tile model
// does (exploiting the sparsity is later work).  Its loops unroll in full
// and its functions inline: dx stays in registers and every block entry
// is one store at a fixed offset, whether the blocks are a thread's arrays
// (step.cu) or a team's shared memory (candidate.cu, where one lane calls
// the model).
template <typename T>
struct Quadrotor {
  static constexpr int N = 12;
  static constexpr int M = 4;
  T dt, dt20, grav, goal[3];

  __device__ explicit Quadrotor(const Params& p)
      : dt(T(p[0])), dt20(T(p[0] * 20.0)), grav(T(p[1])), goal{T(p[2]), T(p[3]), T(p[4])} {}

  __device__ __forceinline__ void f(const T (&x)[N], const T (&u)[M], T (&xn)[N]) const {
    const T sph = sin(x[6]), cph = cos(x[6]), sth = sin(x[7]), cth = cos(x[7]);
    const T thrust = grav + u[0];
    const T acc[3] = {thrust * sth, -thrust * sph * cth, thrust * cph * cth - grav};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      xn[i] = x[i] + dt * x[3 + i];
      xn[3 + i] = x[3 + i] + dt * acc[i];
      xn[6 + i] = x[6 + i] + dt * x[9 + i];
      xn[9 + i] = x[9 + i] + dt20 * u[1 + i];
    }
  }

  __device__ __forceinline__ void jac(const T (&x)[N], const T (&u)[M], T (&A)[N][N], T (&B)[N][M]) const {
    const T sph = sin(x[6]), cph = cos(x[6]), sth = sin(x[7]), cth = cos(x[7]);
    const T thrust = grav + u[0];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] = (i == j) ? T(1) : T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) B[i][j] = T(0);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // pos <- vel, att <- rate, rate <- 20·torque
      A[i][3 + i] = dt;
      A[6 + i][9 + i] = dt;
      B[9 + i][1 + i] = dt20;
    }
    // d acc / d(phi, theta), acc = thrust·(sinθ, −sinφ cosθ, cosφ cosθ) − (0, 0, g)
    A[3][7] = dt * thrust * cth;
    A[4][6] = -dt * thrust * cph * cth;
    A[4][7] = dt * thrust * sph * sth;
    A[5][6] = -dt * thrust * sph * cth;
    A[5][7] = -dt * thrust * cph * sth;
    B[3][0] = dt * sth;  // d acc / d u0: the thrust direction
    B[4][0] = -dt * sph * cth;
    B[5][0] = dt * cph * cth;
  }

  __device__ __forceinline__ void delta(const T (&x)[N], T (&dx)[N]) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) dx[i] = x[i] - goal[i];
#pragma unroll
    for (int i = 3; i < N; ++i) dx[i] = x[i];
  }

  __device__ __forceinline__ void quad(int, const T (&x)[N], const T (&u)[M], T& q, T (&qv)[N], T (&Q)[N][N],
                       T (&r)[M], T (&R)[M][M], T (&P)[M][N]) const {
    T dx[N];
    delta(x, dx);
    T sx = dx[0] * dx[0], su = u[0] * u[0];
#pragma unroll
    for (int i = 1; i < N; ++i) sx = sx + dx[i] * dx[i];
#pragma unroll
    for (int i = 1; i < M; ++i) su = su + u[i] * u[i];
    q = T(0.05) * sx + T(0.1) * su;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = T(0.1) * dx[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? T(0.1) : T(0);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      r[i] = T(0.2) * u[i];
#pragma unroll
      for (int j = 0; j < M; ++j) R[i][j] = (i == j) ? T(0.2) : T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = T(0);
    }
  }

  __device__ __forceinline__ void term(const T (&x)[N], T& q, T (&qv)[N], T (&Q)[N][N]) const {
    T dx[N];
    delta(x, dx);
    T sx = dx[0] * dx[0];
#pragma unroll
    for (int i = 1; i < N; ++i) sx = sx + dx[i] * dx[i];
    q = T(20) * sx;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = T(40) * dx[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? T(40) : T(0);
    }
  }
};

}  // namespace rq
