"""Batched masked polynomial fitting, evaluation and curve intersection.

Replaces the reference's per-label ``np.polyfit`` loops
(ref utils/util_cylinder.py:454-470 polynomial_fitting_row/col) and the
per-(row, col) ``scipy.optimize.root`` intersection solves
(ref utils/util_cylinder.py:1074-1151) with dense batched linear algebra:

  * polyfit: one weighted Vandermonde normal-equations solve, vmapped over
    all labels at once (O(R) scipy calls -> one (R, D+1, D+1) batched solve);
  * intersection: substituting y = f(x) into x = g(y) gives a scalar root
    problem h(x) = x - g(f(x)); a fixed-iteration Newton (with derivative via
    the chain rule on the polynomial coefficients) replaces MINPACK hybrd.
    For degree 1 (the plane path) Newton converges in one exact step.

Coefficients follow numpy ``polyfit`` convention: highest degree first.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.ops.linalg import mm, solve_spd


def polyval(coeffs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Horner evaluation; coeffs (..., D+1) highest-first, broadcasts over x."""
    out = jnp.zeros_like(x) + coeffs[..., 0]
    for i in range(1, coeffs.shape[-1]):
        out = out * x + coeffs[..., i]
    return out


def polyder(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Derivative coefficients, highest-first."""
    d = coeffs.shape[-1] - 1
    if d == 0:
        return jnp.zeros_like(coeffs[..., :1])
    powers = jnp.arange(d, 0, -1, dtype=coeffs.dtype)
    return coeffs[..., :-1] * powers


def masked_polyfit(
    x: jnp.ndarray, y: jnp.ndarray, w: jnp.ndarray, degree: int
) -> jnp.ndarray:
    """Weighted least-squares polyfit; x, y, w: (..., N) -> coeffs (..., D+1).

    Centering/scaling x to its masked mean/std keeps the Vandermonde normal
    equations well-conditioned in float32 for pixel-scale inputs; the returned
    coefficients are mapped back to the raw-x basis so they match np.polyfit.
    """
    dtype = x.dtype
    n = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)
    mu = jnp.sum(x * w, axis=-1, keepdims=True) / n
    var = jnp.sum(w * (x - mu) ** 2, axis=-1, keepdims=True) / n
    sigma = jnp.sqrt(jnp.maximum(var, 1e-12))
    xs = (x - mu) / sigma

    # Vandermonde in the scaled basis, highest degree first.
    cols = [xs ** d for d in range(degree, -1, -1)]
    a = jnp.stack(cols, axis=-1)  # (..., N, D+1)
    aw = a * w[..., None]
    ata = mm(jnp.swapaxes(aw, -1, -2), aw)
    atb = mm(jnp.swapaxes(aw, -1, -2), (y * w)[..., None])
    ata = ata + 1e-8 * jnp.eye(degree + 1, dtype=dtype)
    # SPD by construction (Gram + ridge); the unrolled Cholesky fuses into
    # one elementwise kernel in place of a batched LU.
    cs = solve_spd(ata, atb[..., 0])  # scaled-basis coeffs

    # Expand p((x - mu) / sigma) back to raw-x coefficients via binomials.
    # p(xs) = sum_k cs[k] * xs^(D-k); xs = (x - mu)/sigma.
    out = jnp.zeros_like(cs)
    for k in range(degree + 1):
        d = degree - k  # power of xs for coefficient cs[..., k]
        # ((x - mu)/sigma)^d = sigma^-d * sum_j C(d, j) x^j (-mu)^(d-j)
        for j in range(d + 1):
            comb = 1.0
            for t in range(j):
                comb = comb * (d - t) / (t + 1)
            term = cs[..., k] * comb * (-mu[..., 0]) ** (d - j) / sigma[..., 0] ** d
            out = out.at[..., degree - j].add(term)
    return out


def poly_domain(x: jnp.ndarray, w: jnp.ndarray, margin: float) -> jnp.ndarray:
    """Masked [min - margin, max + margin] domain per label (ref :497-499)."""
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    lo = jnp.min(jnp.where(w > 0, x, big), axis=-1) - margin
    hi = jnp.max(jnp.where(w > 0, x, -big), axis=-1) + margin
    return jnp.stack([lo, hi], axis=-1)


def poly_intersection(
    row_coeffs: jnp.ndarray,
    col_coeffs: jnp.ndarray,
    x0: jnp.ndarray,
    iters: int = 12,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve y = f(x) (row) and x = g(y) (col) jointly; broadcasts over grids.

    Newton on h(x) = x - g(f(x)), initialized at x0 (the reference uses the
    row-domain midpoint: ref utils/util_cylinder.py:1130).  Returns (x, y).
    """
    row_d = polyder(row_coeffs)
    col_d = polyder(col_coeffs)

    def body(_, x):
        y = polyval(row_coeffs, x)
        gx = polyval(col_coeffs, y)
        h = x - gx
        dh = 1.0 - polyval(col_d, y) * polyval(row_d, x)
        dh = jnp.where(jnp.abs(dh) < 1e-8, jnp.sign(dh) * 1e-8 + 1e-12, dh)
        x_new = x - h / dh
        # Keep divergent iterates finite; acceptance is checked by the caller.
        return jnp.where(jnp.isfinite(x_new), x_new, x)

    x = jax.lax.fori_loop(0, iters, body, x0)
    return x, polyval(row_coeffs, x)
