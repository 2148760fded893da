"""Small closed-form linear algebra used across the geometry chain.

The reference leans on MATLAB built-ins (pca, eig, cov, backslash) over tiny
matrices (ref utils/fitCylinderWPts3.m:7, utils/fitplane.m:12-15,
utils/estCurvatures.m:14-37).  Here these become closed-form 2x2 eigs and
batched 3x3 ``jnp.linalg.eigh`` over masked point sets -- everything vmaps.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-12


def mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Matmul at HIGHEST precision.

    A DEFAULT-precision f32 ``@`` may multiply in reduced precision: bf16
    on the first target accelerator, TF32 (10-bit mantissa) on an NVIDIA
    GPU.  In the geometry chain bf16 was measured to quantize rotation
    matrices by ~4e-3, projected pixels by ~1 px and to cost ~0.5 px of
    reprojection accuracy against the CPU path.  Every matmul here is tiny
    (<= a few x hundreds), so full-f32 HIGHEST is cheap -- use this for ALL
    numeric-quality matmuls; one-hot compactions set it at their call sites
    already (tests/test_precision.py walks the programs for stragglers).
    """
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def masked_mean(pts: jnp.ndarray, valid: jnp.ndarray, axis: int = -2) -> jnp.ndarray:
    """Mean of (..., N, D) points under a (..., N) mask."""
    w = valid.astype(pts.dtype)[..., None]
    n = jnp.sum(w, axis=axis)
    return jnp.sum(pts * w, axis=axis) / jnp.maximum(n, 1.0)


def masked_cov(pts: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Sample covariance (divisor n-1, matching MATLAB cov/pca) of masked points.

    pts: (..., N, D), valid: (..., N) -> (..., D, D).
    """
    w = valid.astype(pts.dtype)[..., None]
    n = jnp.sum(w, axis=-2, keepdims=True)
    mean = jnp.sum(pts * w, axis=-2, keepdims=True) / jnp.maximum(n, 1.0)
    d = (pts - mean) * w
    cov = mm(jnp.swapaxes(d, -1, -2), d)
    return cov / jnp.maximum(n[..., 0, :, None] - 1.0, 1.0)


def pca_components(pts: jnp.ndarray, valid: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Principal axes of masked (..., N, 3) points, descending variance.

    Returns (components (..., 3, 3) with columns = axes, variances (..., 3)),
    matching MATLAB ``pca`` column ordering (ref utils/fitCylinderWPts3.m:7:
    coeff(:, 3) is the least-variance direction).
    """
    cov = masked_cov(pts, valid)
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    order = jnp.flip(jnp.arange(pts.shape[-1]))
    return evecs[..., order], evals[..., order]


def eigh2x2(a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form eigendecomposition of symmetric [[a, b], [b, c]].

    Returns (eigenvalues (..., 2) ascending, eigenvectors (..., 2, 2) with
    columns matching the eigenvalues).  Used for Hessian ridge eigenvalues
    (replacing skimage hessian_matrix_eigvals, ref utils/util_cylinder.py:1734)
    and the shape-operator eig in curvature estimation
    (ref utils/estCurvatures.m:14).
    """
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    root = jnp.sqrt(half_diff * half_diff + b * b)
    lo = half_tr - root
    hi = half_tr + root
    # Eigenvector for `hi`: (b, hi - a) or (hi - c, b); pick the better-conditioned.
    v1 = jnp.stack([b, hi - a], axis=-1)
    v2 = jnp.stack([hi - c, b], axis=-1)
    use_v1 = jnp.abs(hi - a)[..., None] > jnp.abs(hi - c)[..., None]
    v_hi = jnp.where(use_v1, v1, v2)
    norm = jnp.linalg.norm(v_hi, axis=-1, keepdims=True)
    # Degenerate (b ~ 0, a ~ c): fall back to identity directions.
    v_hi = jnp.where(norm > 1e-20, v_hi / (norm + _EPS), jnp.stack(
        [jnp.ones_like(b), jnp.zeros_like(b)], axis=-1))
    v_lo = jnp.stack([-v_hi[..., 1], v_hi[..., 0]], axis=-1)
    evals = jnp.stack([lo, hi], axis=-1)
    evecs = jnp.stack([v_lo, v_hi], axis=-1)  # columns
    return evals, evecs


def _chol_solve(l, b):
    """Forward+back substitution with an unrolled factor (list-of-lists)."""
    p = len(l)
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x, axis=-1)


def solve_spd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD solve a @ x = b by an UNROLLED Cholesky (static small P).

    a: (..., P, P) symmetric positive definite, b: (..., P).  Replaces
    jnp.linalg.solve in the hot paths: XLA lowered batched LU on the first
    target accelerator to a latency-heavy multi-kernel loop, while this
    unrolls to ~P^2 scalar
    (batched) elementwise ops that fuse into ONE kernel -- measured the
    dominant cost of each LM iteration (ops/lm.py) and of the per-label
    Vandermonde solves (ops/polyfit.py).

    Numerical guards (both matter in f32 -- an unguarded f32 Cholesky lost
    ~3 digits vs LU on the worst-conditioned LM system of the bench set):
    - Jacobi equilibration: scale to unit diagonal (S A S) (S x') = S b,
      S = diag(a_jj^-1/2).  Gram matrices here mix columns with wildly
      different scales (e.g. curvature vs translation in LM); equilibration
      bounds the factor's internal dynamic range by the correlation
      structure, not the raw scales.
    - One step of iterative refinement against the ORIGINAL a (one extra
      fused matvec + resolve): recovers the residual the f32 factorization
      loses on ill-conditioned systems, matching batched-LU accuracy.
    Singular/indefinite inputs are clamped (sqrt of max(., tiny)), matching
    the ridge-regularized callers' expectations (finite garbage for
    masked-out systems, gated upstream).
    """
    p = a.shape[-1]
    tiny = jnp.asarray(1e-30, a.dtype)
    s_inv = 1.0 / jnp.sqrt(jnp.maximum(
        jnp.diagonal(a, axis1=-2, axis2=-1), tiny))  # (..., P)
    a_eq = a * s_inv[..., :, None] * s_inv[..., None, :]
    l = [[None] * p for _ in range(p)]
    for j in range(p):
        s = a_eq[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        d = jnp.sqrt(jnp.maximum(s, tiny))
        l[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, p):
            s = a_eq[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d

    def solve_eq(rhs):
        # Solve a x = rhs through the equilibrated factor: x = S x', with
        # (S A S) x' = S rhs.
        return _chol_solve(l, rhs * s_inv) * s_inv

    x = solve_eq(b)
    # Refinement: r = b - a x in the original scaling, then one resolve.
    # The matvec is elementwise-multiply + sum (NOT dot_general) so it is
    # exact f32 on every device -- a reduced-precision residual would
    # defeat the refinement.
    r = b - jnp.sum(a * x[..., None, :], axis=-1)
    return x + solve_eq(r)


def solve_normal_equations(
    a: jnp.ndarray, b: jnp.ndarray, w: jnp.ndarray, ridge: float = 1e-9
) -> jnp.ndarray:
    """Weighted least squares via normal equations: argmin ||w (A x - b)||.

    a: (..., N, P), b: (..., N), w: (..., N) weights (0/1 masks typically).
    Small P (<= 6 here) makes the (P, P) solve cheap and batched-friendly;
    ridge regularization keeps masked-out / degenerate systems finite.
    """
    aw = a * w[..., None]
    ata = mm(jnp.swapaxes(aw, -1, -2), aw)
    atb = mm(jnp.swapaxes(aw, -1, -2), (b * w)[..., None])
    p = a.shape[-1]
    ata = ata + ridge * jnp.eye(p, dtype=a.dtype)
    return solve_spd(ata, atb[..., 0])
