// The association-scoring body shared by the ranking kernels.
//
// Device twin of repro_torch/kernels/assoc_score.py:score_body, which in turn
// mirrors src/repro/kernels/assoc_score.py:score_body: conditional
// probability, PMI, Dunning's LLR G^2 and chi^2 over the 2x2 count table,
// and their linear combination. Every operation is written in the plain
// version's order, with libm's expf/logf/log1pf and IEEE division; the
// build passes -fmad=false so that no multiply-add is contracted. Together
// these make the kernel reproduce the plain torch version's rounding, which
// matters because LLR's sum of x*log(x) terms cancels and would amplify any
// reordering.
//
// The clamps use max_nan, not fmaxf: fmaxf returns the other operand when
// one is NaN, while the plain version's torch.clamp_min (and JAX's
// jnp.maximum) return NaN. A NaN or infinite marginal in a slot with
// c_ab > 0 therefore scores NaN here exactly where it does there.
#pragma once

namespace repro {

// max(a, b) that returns NaN when either operand is NaN (PTX max.NaN.f32,
// sm_80 and later); otherwise the same value as fmaxf.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float xlogx(float x) {
  return x > 0.0f ? x * logf(fmaxf(x, 1e-30f)) : 0.0f;
}

__device__ __forceinline__ float score_body(float w_ab, float c_ab, float w_a,
                                            float w_b, float c_a, float c_b,
                                            float total_w, float total_c,
                                            float c0, float c1, float c2,
                                            float c3) {
  const float eps = 1e-9f;
  w_a = max_nan(w_a, 0.0f);
  w_b = max_nan(w_b, 0.0f);
  float condprob = w_a > 0.0f ? w_ab / max_nan(w_a, eps) : 0.0f;
  float pmi = (w_ab > 0.0f && w_a > 0.0f && w_b > 0.0f)
                  ? logf(max_nan(w_ab * max_nan(total_w, eps), eps) /
                         max_nan(w_a * w_b, eps))
                  : 0.0f;
  const float k11 = c_ab;
  const float k12 = max_nan(c_a - c_ab, 0.0f);
  const float k21 = max_nan(c_b - c_ab, 0.0f);
  const float k22 = max_nan(total_c - c_a - c_b + c_ab, 0.0f);
  const float n = max_nan(k11 + k12 + k21 + k22, eps);
  const float r1 = k11 + k12, r2 = k21 + k22;
  const float q1 = k11 + k21, q2 = k12 + k22;
  float llr = 2.0f * (xlogx(k11) + xlogx(k12) + xlogx(k21) + xlogx(k22) -
                      xlogx(r1) - xlogx(r2) - xlogx(q1) - xlogx(q2) +
                      xlogx(n));
  llr = max_nan(llr, 0.0f);
  const float d = k11 * k22 - k12 * k21;
  float chi2 = n * (d * d) / max_nan(r1 * r2 * q1 * q2, eps);
  if (!(c_ab > 0.0f)) {
    condprob = 0.0f;
    pmi = 0.0f;
    llr = 0.0f;
    chi2 = 0.0f;
  }
  const float sig = 1.0f / (1.0f + expf(-pmi));
  return c0 * condprob + c1 * sig + c2 * log1pf(llr) + c3 * log1pf(chi2);
}

}  // namespace repro
