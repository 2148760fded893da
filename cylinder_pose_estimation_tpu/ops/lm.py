"""Generic fixed-iteration Levenberg-Marquardt for small parameter vectors.

Replaces the reference's derivative-free Nelder-Mead (``fminsearch`` with
TolFun/TolX 1e-5, <=1e5 evals: ref utils/fitCylinderWPts3.m:33-38,
utils/fitCylinderWPts3sAngs.m:77) with a damped Gauss-Newton loop:

  * the iteration count is STATIC (lax.fori_loop) so the solver jits once and
    vmaps over batches of problems -- exactly what Nelder-Mead cannot do;
  * residuals carry a weight vector, so masked (invalid) points contribute
    zero without dynamic shapes;
  * the 6-dof problems here are rank-deficient by construction (a cylinder's
    origin slides along its axis, its direction norm is free:
    ref utils/fitCylinderWPts3.m dist() is invariant to both) -- the LM
    damping term is what makes the normal equations solvable, standard LM.

Jacobians come from jacfwd over the residual vector: P <= 6 makes forward mode
optimal and keeps everything one fused XLA computation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.ops.linalg import mm, solve_spd


class LMResult(NamedTuple):
    params: jnp.ndarray   # (P,) final parameters
    cost0: jnp.ndarray    # () initial weighted SSE
    cost: jnp.ndarray     # () final weighted SSE
    n_accepted: jnp.ndarray  # () int32 accepted steps


def levenberg_marquardt(
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    params0: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    iters: int = 60,
    lambda0: float = 1e-3,
    lambda_up: float = 2.0,
    lambda_down: float = 3.0,
    jac_fn: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
) -> LMResult:
    """Minimize sum(w * r(p)^2) over p with a fixed number of LM steps.

    residual_fn maps (P,) -> (N,).  Rejected steps raise lambda and retry next
    iteration; accepted steps lower it.  All state lives in a fori_loop carry,
    so the whole solve is one jittable, vmappable expression.

    ``jac_fn``: optional closed-form Jacobian (P,) -> (N, P).  Default is
    jacfwd over residual_fn (P tangents ~ P+1 residual evaluations per
    step); an analytic form cuts the per-step cost to ~2 evaluations.
    """
    params0 = jnp.asarray(params0)
    dtype = params0.dtype
    r0 = residual_fn(params0)
    w = jnp.ones_like(r0) if weights is None else weights.astype(dtype)

    def cost_of(r):
        return jnp.sum(w * r * r)

    cost0 = cost_of(r0)
    p_dim = params0.shape[0]
    eye = jnp.eye(p_dim, dtype=dtype)

    def step(_, carry):
        # r is carried from the last accepted evaluation: residual_fn(p) is
        # deterministic, so re-evaluating it at an unchanged p is pure waste
        # (one of three residual evals per step, exact same iterates).
        p, r, cost, lam, n_acc = carry
        j = (jac_fn(p) if jac_fn is not None
             else jax.jacfwd(residual_fn)(p))  # (N, P)
        jw = j * w[:, None]
        jtj = mm(j.T, jw)
        jtr = mm(jw.T, r)
        # Marquardt scaling: damp by lam * diag(JtJ) (+ floor for zero columns).
        damp = lam * (jnp.diagonal(jtj) + 1e-12)
        # Unrolled Cholesky: jtj + damp*I is SPD by construction (PSD + the
        # positive Marquardt diagonal), and batched LU (jnp.linalg.solve)
        # was a latency-heavy multi-kernel loop on the first target
        # accelerator (see linalg.solve_spd).
        delta = solve_spd(jtj + damp * eye, -jtr)
        p_new = p + delta
        r_new = residual_fn(p_new)
        cost_new = cost_of(r_new)
        accept = (cost_new < cost) & jnp.all(jnp.isfinite(p_new))
        p = jnp.where(accept, p_new, p)
        r = jnp.where(accept, r_new, r)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.where(accept, lam / lambda_down, lam * lambda_up)
        lam = jnp.clip(lam, 1e-12, 1e12)
        n_acc = n_acc + accept.astype(jnp.int32)
        return (p, r, cost, lam, n_acc)

    # Derive the scalar carries from cost0 so they inherit its varying-axes
    # metadata under shard_map (a literal lambda0 would be 'unvarying' while
    # the body output varies over the mapped axis, breaking the fori_loop).
    init = (
        params0,
        r0,
        cost0,
        jnp.full_like(cost0, lambda0),
        jnp.zeros_like(cost0, dtype=jnp.int32),
    )
    p, _, cost, _, n_acc = jax.lax.fori_loop(0, iters, step, init)
    return LMResult(params=p, cost0=cost0, cost=cost, n_accepted=n_acc)
