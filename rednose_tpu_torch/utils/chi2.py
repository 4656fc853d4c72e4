"""Chi-square inverse CDF (percent-point function) without a scipy runtime dependency.

Port of rednose_tpu/utils/chi2.py (numpy only, copied unchanged).

The reference bakes Mahalanobis gate thresholds at codegen time from a
precomputed chi2 PPF lookup table (rednose/helpers/chi2_lookup.py:6-18,
chi2_lookup_table.npy) so that scipy is not needed at runtime. Here we go one
step further and compute the PPF directly with a self-contained implementation
of the regularized incomplete gamma function and its inverse, evaluated on the
host at filter-spec construction time (the thresholds are plain Python floats
handed to the kernels as arguments).

chi2.ppf(p, k) == 2 * gammaincinv(k / 2, p)
"""

from __future__ import annotations

import math

import numpy as np

_EPS = 1e-15
_MAX_ITERS = 200


def _gammainc_lower_series(a: float, x: float) -> float:
  """Regularized lower incomplete gamma P(a, x) by power series (x < a + 1)."""
  if x <= 0.0:
    return 0.0
  term = 1.0 / a
  total = term
  n = a
  for _ in range(_MAX_ITERS):
    n += 1.0
    term *= x / n
    total += term
    if abs(term) < abs(total) * _EPS:
      break
  log_prefactor = a * math.log(x) - x - math.lgamma(a)
  return total * math.exp(log_prefactor)


def _gammainc_upper_cf(a: float, x: float) -> float:
  """Regularized upper incomplete gamma Q(a, x) by continued fraction (x >= a + 1)."""
  tiny = 1e-300
  b = x + 1.0 - a
  c = 1.0 / tiny
  d = 1.0 / b
  h = d
  for i in range(1, _MAX_ITERS + 1):
    an = -i * (i - a)
    b += 2.0
    d = an * d + b
    if abs(d) < tiny:
      d = tiny
    c = b + an / c
    if abs(c) < tiny:
      c = tiny
    d = 1.0 / d
    delta = d * c
    h *= delta
    if abs(delta - 1.0) < _EPS:
      break
  log_prefactor = a * math.log(x) - x - math.lgamma(a)
  return h * math.exp(log_prefactor)


def gammainc(a: float, x: float) -> float:
  """Regularized lower incomplete gamma function P(a, x)."""
  if x < 0.0 or a <= 0.0:
    raise ValueError("gammainc requires x >= 0 and a > 0")
  if x == 0.0:
    return 0.0
  if x < a + 1.0:
    return _gammainc_lower_series(a, x)
  return 1.0 - _gammainc_upper_cf(a, x)


def gammaincinv(a: float, p: float) -> float:
  """Inverse of the regularized lower incomplete gamma: find x with P(a, x) = p."""
  if not 0.0 <= p < 1.0:
    raise ValueError("p must be in [0, 1)")
  if p == 0.0:
    return 0.0

  # Initial guess (Wilson-Hilferty approximation for chi2 with k = 2a dof).
  k = 2.0 * a
  z = _norm_ppf(p)
  wh = k * (1.0 - 2.0 / (9.0 * k) + z * math.sqrt(2.0 / (9.0 * k))) ** 3
  x = max(wh / 2.0, 1e-8)

  # Newton iterations with bisection safeguard.
  lo, hi = 0.0, None
  for _ in range(_MAX_ITERS):
    f = gammainc(a, x) - p
    if abs(f) < 1e-14:
      break
    if f > 0:
      hi = x if hi is None else min(hi, x)
    else:
      lo = max(lo, x)
    # P'(a, x) = x^(a-1) e^-x / Gamma(a)
    log_deriv = (a - 1.0) * math.log(x) - x - math.lgamma(a)
    deriv = math.exp(log_deriv)
    if deriv <= 0.0:
      x = (lo + hi) / 2.0 if hi is not None else x * 2.0
      continue
    step = f / deriv
    x_new = x - step
    if x_new <= lo or (hi is not None and x_new >= hi):
      x_new = (lo + hi) / 2.0 if hi is not None else (lo + x) / 2.0 + x
    if abs(x_new - x) < 1e-14 * max(1.0, x):
      x = x_new
      break
    x = x_new
  return x


def _norm_ppf(p: float) -> float:
  """Standard normal inverse CDF (Acklam-style rational approximation)."""
  if not 0.0 < p < 1.0:
    raise ValueError("p must be in (0, 1)")
  # Beasley-Springer-Moro coefficients.
  a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
       1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
  b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
       6.680131188771972e+01, -1.328068155288572e+01]
  c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
       -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
  d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
       3.754408661907416e+00]
  p_low, p_high = 0.02425, 1.0 - 0.02425
  if p < p_low:
    q = math.sqrt(-2.0 * math.log(p))
    return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0)
  if p <= p_high:
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0)
  q = math.sqrt(-2.0 * math.log(1.0 - p))
  return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
         ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0)


def chi2_ppf(p: float, dim: int) -> float:
  """Chi-square percent-point function: x such that chi2.cdf(x; dim) == p.

  Used to bake Mahalanobis outlier-gate thresholds into filter specs, mirroring
  the reference's codegen-time chi2_ppf(0.95, dz) (rednose/helpers/ekf_sym.py:144).
  """
  return 2.0 * gammaincinv(dim / 2.0, float(p))


def gen_chi2_ppf_lookup(max_dim: int = 200) -> np.ndarray:
  """Precompute a (max_dim, 98) table of chi2_ppf over p in {0.01..0.98}, dims 1..max_dim-1.

  Parity with the reference's gen_chi2_ppf_lookup (rednose/helpers/chi2_lookup.py:6).
  """
  table = np.zeros((max_dim, 98))
  for dim in range(1, max_dim):
    for i, p in enumerate(np.linspace(0.01, 0.98, 98)):
      table[dim, i] = chi2_ppf(p, dim)
  return table
