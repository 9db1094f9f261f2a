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
#pragma once

namespace repro {

__device__ __forceinline__ float xlogx(float x) {
  return x > 0.0f ? x * logf(fmaxf(x, 1e-30f)) : 0.0f;
}

__device__ __forceinline__ float score_body(float w_ab, float c_ab, float w_a,
                                            float w_b, float c_a, float c_b,
                                            float total_w, float total_c,
                                            float c0, float c1, float c2,
                                            float c3) {
  const float eps = 1e-9f;
  w_a = fmaxf(w_a, 0.0f);
  w_b = fmaxf(w_b, 0.0f);
  float condprob = w_a > 0.0f ? w_ab / fmaxf(w_a, eps) : 0.0f;
  float pmi = (w_ab > 0.0f && w_a > 0.0f && w_b > 0.0f)
                  ? logf(fmaxf(w_ab * fmaxf(total_w, eps), eps) /
                         fmaxf(w_a * w_b, eps))
                  : 0.0f;
  const float k11 = c_ab;
  const float k12 = fmaxf(c_a - c_ab, 0.0f);
  const float k21 = fmaxf(c_b - c_ab, 0.0f);
  const float k22 = fmaxf(total_c - c_a - c_b + c_ab, 0.0f);
  const float n = fmaxf(k11 + k12 + k21 + k22, eps);
  const float r1 = k11 + k12, r2 = k21 + k22;
  const float q1 = k11 + k21, q2 = k12 + k22;
  float llr = 2.0f * (xlogx(k11) + xlogx(k12) + xlogx(k21) + xlogx(k22) -
                      xlogx(r1) - xlogx(r2) - xlogx(q1) - xlogx(q2) +
                      xlogx(n));
  llr = fmaxf(llr, 0.0f);
  const float d = k11 * k22 - k12 * k21;
  float chi2 = n * (d * d) / fmaxf(r1 * r2 * q1 * q2, eps);
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
