// Pointwise GLM losses l(z, y), dl/dz and d2l/dz2 in device code.
//
// They follow photon_ml_tpu_torch/ops/losses.py (the kernels' plain versions
// call those functions): labels with y > 0.5 count as positive, softplus
// returns z above 20 as F.softplus does, and Poisson uses expf so that the
// kernel overflows exactly where the plain version does.

#pragma once

#include <cuda_runtime.h>

namespace photon {

__device__ __forceinline__ float y01(float y) { return y > 0.5f ? 1.0f : 0.0f; }

__device__ __forceinline__ float ypm1(float y) { return y > 0.5f ? 1.0f : -1.0f; }

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// l = log(1 + exp(z)) - y*z, y in {0, 1}
struct Logistic {
  static __device__ __forceinline__ float loss(float z, float y) {
    const float softplus = z > 20.0f ? z : log1pf(expf(z));
    return softplus - y01(y) * z;
  }
  static __device__ __forceinline__ float dz(float z, float y) { return sigmoid(z) - y01(y); }
  static __device__ __forceinline__ float d2z(float z, float) {
    const float s = sigmoid(z);
    return s * (1.0f - s);
  }
};

// l = 0.5 * (z - y)^2
struct Squared {
  static __device__ __forceinline__ float loss(float z, float y) {
    const float d = z - y;
    return 0.5f * d * d;
  }
  static __device__ __forceinline__ float dz(float z, float y) { return z - y; }
  static __device__ __forceinline__ float d2z(float, float) { return 1.0f; }
};

// l = exp(z) - y*z
struct Poisson {
  static __device__ __forceinline__ float loss(float z, float y) { return expf(z) - y * z; }
  static __device__ __forceinline__ float dz(float z, float y) { return expf(z) - y; }
  static __device__ __forceinline__ float d2z(float z, float) { return expf(z); }
};

// Rennie's smoothed hinge, u = y*z with y in {-1, +1}:
//   0.5 - u (u <= 0);  0.5*(1-u)^2 (0 < u < 1);  0 (u >= 1).
// Not twice differentiable: the Hessian kernels refuse it.
struct SmoothedHinge {
  static __device__ __forceinline__ float loss(float z, float y) {
    const float u = ypm1(y) * z;
    if (u <= 0.0f) return 0.5f - u;
    return u < 1.0f ? 0.5f * (1.0f - u) * (1.0f - u) : 0.0f;
  }
  static __device__ __forceinline__ float dz(float z, float y) {
    const float ym = ypm1(y);
    const float u = ym * z;
    const float du = u < 0.0f ? -1.0f : (u < 1.0f ? u - 1.0f : 0.0f);
    return du * ym;
  }
};

// Codes shared with photon_ml_tpu_torch/kernels/__init__.py (LOSS_CODES).
enum LossCode { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

}  // namespace photon
