// Device tile models: closed-form dynamics, Jacobians and cost
// derivatives for the fused step and candidate kernels.
//
// Device counterparts of ratilqr_tpu/ops/tile_model.py
// (unicycle_tile_model :68, lqr_tile_model :285) and of the plain-torch
// mirrors in ratilqr_tpu_torch/ops/tile_model.py, formula for formula.
// A model holds its scalar parameters; the kernel is templated on it.
#pragma once

#include <math.h>

namespace rq {

// Model ids, shared with ratilqr_tpu_torch/ops/tile_model.py.
enum ModelId { kUnicycle = 0, kLqr = 1 };

// Unicycle (n=3, m=2): parameters (dt, goal_x, goal_y).
template <typename T>
struct Unicycle {
  static constexpr int N = 3;
  static constexpr int M = 2;
  T dt, gx, gy;

  __device__ explicit Unicycle(const double (&p)[4]) : dt(T(p[0])), gx(T(p[1])), gy(T(p[2])) {}

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
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = T(0.1) * dx[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? T(0.1) : T(0);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      r[i] = T(0.1) * u[i];
#pragma unroll
      for (int j = 0; j < M; ++j) R[i][j] = (i == j) ? T(0.1) : T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = T(0);
    }
  }

  __device__ void term(const T (&x)[N], T& q, T (&qv)[N], T (&Q)[N][N]) const {
    const T dx[N] = {x[0] - gx, x[1] - gy, x[2]};
    q = T(10) * (dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = T(20) * dx[i];
#pragma unroll
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

  __device__ explicit Lqr(const double (&p)[4])
      : hwx(T(0.5 * p[0])), wx(T(p[0])), wu(T(p[1])), twu(T(2.0 * p[1])),
        hwh(T(0.5 * p[2])), wh(T(p[2])) {}

  __device__ void f(const T (&x)[N], const T (&u)[M], T (&xn)[N]) const {
    xn[0] = x[0] + u[0];
    xn[1] = x[1] + u[1];
  }

  __device__ void jac(const T (&)[N], const T (&)[M], T (&A)[N][N], T (&B)[N][M]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        A[i][j] = (i == j) ? T(1) : T(0);
        B[i][j] = (i == j) ? T(1) : T(0);
      }
  }

  __device__ void quad(int, const T (&x)[N], const T (&u)[M], T& q, T (&qv)[N], T (&Q)[N][N],
                       T (&r)[M], T (&R)[M][M], T (&P)[M][N]) const {
    q = hwx * (x[0] * x[0] + x[1] * x[1]) + wu * (u[0] * u[0] + u[1] * u[1]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = wx * x[i];
      r[i] = twu * u[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Q[i][j] = (i == j) ? wx : T(0);
        R[i][j] = (i == j) ? twu : T(0);
        P[i][j] = T(0);
      }
    }
  }

  __device__ void term(const T (&x)[N], T& q, T (&qv)[N], T (&Q)[N][N]) const {
    q = hwh * (x[0] * x[0] + x[1] * x[1]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = wh * x[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Q[i][j] = (i == j) ? wh : T(0);
    }
  }
};

}  // namespace rq
