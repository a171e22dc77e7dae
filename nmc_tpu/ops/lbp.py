"""Loopy Belief Propagation with convexification (backbone inference).

Jittable rewrite of the reference's LBP stack:
  * LoopyBeliefPropagation (/root/reference/NMC/nmc.py:168-228): dense tanh
    message passing. The reference's row loop computing
    h_msgs[i,:] = h[i] + sum_k u[k,i] - u[:,i] is a rank-1 broadcast; here
    the whole iteration is one fused jnp expression inside lax.while_loop,
    with the same relative-change convergence test.
  * atanh_saturated (/root/reference/NMC/nmc.py:230-255): clip to
    +-tanh(19.06) -+ eps before arctanh.
  * LBP_convexified (/root/reference/NMC/nmc.py:93-166): lambda-annealed
    soft clamp h_lambda = h + lambda * m_star * epsilon with geometric decay
    lambda <- lambda * reduction_factor, warm-started messages, and the
    reference's divergence policy (error at first lambda; otherwise reuse
    previous marginal and stop). The lambda ladder is data-independent, so
    it is precomputed in Python and each rung is one jitted LBP call.

Messages are [N, N] dense; every op maps to VPU elementwise work and row/col
reductions, which XLA fuses. For very large sparse N an edge-list variant
belongs in a follow-up (see SURVEY.md hard parts).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def atanh_saturated(x: jax.Array) -> jax.Array:
    """arctanh with the reference's saturation at +-tanh(19.06) -+ eps."""
    dtype = jnp.result_type(x)
    eps = jnp.finfo(dtype).eps
    sat = jnp.tanh(jnp.asarray(19.06, dtype))
    return jnp.arctanh(jnp.clip(x, -sat + eps, sat - eps))


class LBPResult(NamedTuple):
    magnetizations: jax.Array  # [N]
    correlations: jax.Array    # [N, N]
    h_tilde: jax.Array         # [N]
    J_tilde: jax.Array         # [N, N]
    iterations: jax.Array      # scalar int32: index of last iteration run
    h_msgs: jax.Array          # [N, N]
    u_msgs: jax.Array          # [N, N]
    belief: jax.Array = None   # [N] pre-tanh total field h + sum u:
    #   magnetizations = tanh(beta * belief). Thresholds finer than f32
    #   resolution (the reference uses 0.9999999 on f64 marginals,
    #   nmc.py:163) must be applied as |belief| >= atanh(t)/beta — in f32
    #   the tanh saturates to exactly 1.0 and cannot discriminate.


@functools.partial(jax.jit, static_argnames=("max_iterations",))
def loopy_belief_propagation(
    J: jax.Array,
    h: jax.Array,
    beta,
    h_msgs: jax.Array,
    u_msgs: jax.Array,
    tolerance,
    *,
    max_iterations: int,
) -> LBPResult:
    """One LBP solve; semantics match /root/reference/NMC/nmc.py:168-228.

    `iterations` reports the reference's loop variable at exit: it equals
    max_iterations - 1 iff the tolerance was never met (divergence signal
    consumed by lbp_convexified).
    """
    h = jnp.asarray(h).reshape(-1)
    beta = jnp.asarray(beta, J.dtype)
    # Dtype-aware tolerance floor: the reference's float64-eps default is
    # unreachable for the float32 relative-change plateau (rounding noise
    # sits at a few ulps), which would misreport convergence as divergence.
    # float64 keeps the raw tolerance so x64 parity runs are unchanged.
    eps = jnp.finfo(J.dtype).eps
    floor = eps if J.dtype == jnp.float64 else 4 * eps
    tol = jnp.maximum(jnp.asarray(tolerance, J.dtype), floor)
    tiny = jnp.finfo(J.dtype).tiny  # guards the 0/0 case at exact fixed points
    tanh_bJ = jnp.tanh(beta * J)
    eye = jnp.eye(J.shape[0], dtype=J.dtype)

    def step(state):
        h_m, u_m, it, _ = state
        # h_msgs[i, j] = h[i] + sum_k u[k, i] - u[j, i], zero diagonal
        col_in = h + jnp.sum(u_m, axis=0)            # [N]
        h_new = (col_in[:, None] - u_m.T) * (1.0 - eye)
        u_new = atanh_saturated(tanh_bJ * jnp.tanh(beta * h_new)) / beta
        u_change = jnp.max(jnp.abs(u_new - u_m)) / (
            jnp.max(jnp.abs(u_new) + jnp.abs(u_m)) + tiny)
        h_change = jnp.max(jnp.abs(h_new - h_m)) / (
            jnp.max(jnp.abs(h_new) + jnp.abs(h_m)) + tiny)
        converged = (u_change < tol) & (h_change < tol)
        return h_new, u_new, it + 1, converged

    def cond(state):
        _, _, it, converged = state
        return (it < max_iterations) & (~converged)

    h_f, u_f, it, converged = jax.lax.while_loop(
        cond, step, (h_msgs, u_msgs, jnp.int32(0), jnp.bool_(False))
    )

    belief = h + jnp.sum(u_f, axis=0)
    mag = jnp.tanh(beta * belief)
    th = jnp.tanh(beta * h_f)
    corr = (tanh_bJ + th * th.T) / (1.0 + tanh_bJ * th * th.T + 1e-10)
    corr = corr * (1.0 - eye)
    h_tilde = atanh_saturated(mag) / beta
    J_tilde = atanh_saturated(corr) / beta
    # Reference exposes the 0-based loop index at exit; a full
    # non-converged run leaves it at max_iterations - 1.
    iterations = jnp.where(converged, it - 1, max_iterations - 1)
    return LBPResult(mag, corr, h_tilde, J_tilde, iterations, h_f, u_f,
                     belief)


def lambda_ladder(lambda_start: float, lambda_end: float,
                  reduction_factor: float) -> List[float]:
    """The lambda values LBP_convexified visits (host-precomputed).

    Mirrors the while-loop at /root/reference/NMC/nmc.py:131-161 including
    the round(lambda, 6) == 0 early break.
    """
    if reduction_factor >= 1.0 or reduction_factor <= 0.0:
        raise ValueError("lambda_reduction_factor must be in (0, 1)")
    out = []
    lam = float(lambda_start)
    while lam >= lambda_end:
        out.append(lam)
        lam *= reduction_factor
        if round(lam, 6) == 0:
            break
    return out


class ConvexifiedLBPResult(NamedTuple):
    marginal: np.ndarray                 # final marginal used for clusters
    marginals_all: Dict[float, np.ndarray]
    mean_marginals_all: Dict[float, float]
    h_tilde_all: Dict[float, np.ndarray]
    J_tilde_all: Dict[float, np.ndarray]
    belief: np.ndarray = None            # final pre-tanh field h + sum u
    #   (same divergence-fallback rung as `marginal`); marginal ==
    #   tanh(global_beta * belief). Use for f32-safe thresholding.


def lbp_convexified(
    J: jax.Array,
    h: jax.Array,
    global_beta: float,
    m_star: jax.Array,
    epsilon: jax.Array,
    *,
    lambda_start: float,
    lambda_end: float,
    lambda_reduction_factor: float,
    tolerance: float,
    max_iterations: int,
    keep_history: bool = False,
) -> ConvexifiedLBPResult:
    """Lambda-annealed LBP soft-clamped at m_star.

    Faithful to /root/reference/NMC/nmc.py:93-166: messages warm-start as
    h_msgs = 0, u_msgs = J * m_star (row vector broadcast); each rung runs
    LBP on h + lambda * m_star * epsilon; divergence at the first rung
    raises, later divergence reuses the previous marginal and stops.
    """
    J = jnp.asarray(J)
    h = jnp.asarray(h).reshape(-1)
    m_star = jnp.asarray(m_star, J.dtype).reshape(-1)
    epsilon = jnp.asarray(epsilon, J.dtype).reshape(-1)

    h_msgs = jnp.zeros_like(J)
    u_msgs = J * m_star[None, :]

    marginals_all: Dict[float, np.ndarray] = {}
    mean_all: Dict[float, float] = {}
    h_tilde_all: Dict[float, np.ndarray] = {}
    J_tilde_all: Dict[float, np.ndarray] = {}

    ladder = lambda_ladder(lambda_start, lambda_end, lambda_reduction_factor)
    marginal_prev = None
    marginal = None
    belief_prev = None
    belief = None
    for i, lam in enumerate(ladder):
        h_lambda = h + lam * m_star * epsilon
        res = loopy_belief_propagation(
            J, h_lambda, global_beta, h_msgs, u_msgs, tolerance,
            max_iterations=max_iterations,
        )
        h_msgs, u_msgs = res.h_msgs, res.u_msgs
        diverged = int(res.iterations) == max_iterations - 1
        if diverged and i == 0:
            raise ValueError(
                "LBP diverged at initial lambda, please try a larger "
                "lambda_start or increase max_iterations or beta"
            )
        if diverged:
            marginal = marginal_prev
            belief = belief_prev
            stop = True
        else:
            marginal = np.asarray(res.magnetizations)
            marginal_prev = marginal
            belief = np.asarray(res.belief)
            belief_prev = belief
            stop = False

        marginals_all[lam] = marginal
        mean_all[lam] = float(np.mean(marginal))
        if keep_history:
            h_tilde_all[lam] = np.asarray(res.h_tilde)
            J_tilde_all[lam] = np.asarray(res.J_tilde)
        if stop:
            break

    return ConvexifiedLBPResult(
        marginal=np.asarray(marginal),
        marginals_all=marginals_all,
        mean_marginals_all=mean_all,
        h_tilde_all=h_tilde_all,
        J_tilde_all=J_tilde_all,
        belief=np.asarray(belief),
    )


def convexification_epsilon(J: np.ndarray, h: np.ndarray) -> np.ndarray:
    """epsilon_i = |h_i| + sum_j |J_ij| (/root/reference/NMC/nmc.py:353-354)."""
    return np.abs(np.asarray(h).reshape(-1)) + np.sum(np.abs(J), axis=1)


def lbp_convexified_batch(
    J: jax.Array,
    h: jax.Array,
    global_beta: float,
    m_stars: jax.Array,     # [R, N] one clamp state per chain
    epsilon: jax.Array,     # [N]
    *,
    lambda_start: float,
    lambda_end: float,
    lambda_reduction_factor: float,
    tolerance: float,
    max_iterations: int,
    return_belief: bool = False,
) -> np.ndarray:
    """Convexified LBP for a BATCH of chains (one vmapped LBP per rung).

    Semantics per chain match lbp_convexified: warm-started messages,
    geometric lambda ladder, divergence at rung 0 raises, later divergence
    freezes that chain's marginal at the previous rung. Returns final
    marginals [R, N] (plus final beliefs [R, N] when return_belief). One
    device dispatch per rung instead of R * num_rungs (the driver-visible
    win on high-latency links).
    """
    J = jnp.asarray(J)
    h = jnp.asarray(h).reshape(-1)
    m_stars = jnp.asarray(m_stars, J.dtype)
    epsilon = jnp.asarray(epsilon, J.dtype).reshape(-1)
    R, N = m_stars.shape

    vlbp = jax.vmap(
        functools.partial(loopy_belief_propagation,
                          max_iterations=max_iterations),
        in_axes=(None, 0, None, 0, 0, None))

    h_msgs = jnp.zeros((R, N, N), J.dtype)
    u_msgs = J[None, :, :] * m_stars[:, None, :]

    marginals = np.zeros((R, N))
    beliefs = np.zeros((R, N))
    prev = np.zeros((R, N))
    prev_b = np.zeros((R, N))
    frozen = np.zeros(R, dtype=bool)
    ladder = lambda_ladder(lambda_start, lambda_end, lambda_reduction_factor)
    for i, lam in enumerate(ladder):
        h_lambda = h[None, :] + lam * m_stars * epsilon[None, :]
        res = vlbp(J, h_lambda, global_beta, h_msgs, u_msgs, tolerance)
        h_msgs, u_msgs = res.h_msgs, res.u_msgs
        diverged = np.asarray(res.iterations) == max_iterations - 1
        if i == 0 and diverged.any():
            raise ValueError(
                "LBP diverged at initial lambda, please try a larger "
                "lambda_start or increase max_iterations or beta")
        mags = np.asarray(res.magnetizations)
        bels = np.asarray(res.belief)
        newly_frozen = diverged & ~frozen
        live = ~frozen
        marginals[live & ~diverged] = mags[live & ~diverged]
        marginals[newly_frozen] = prev[newly_frozen]
        beliefs[live & ~diverged] = bels[live & ~diverged]
        beliefs[newly_frozen] = prev_b[newly_frozen]
        frozen |= diverged
        prev = np.where(frozen[:, None], marginals, mags)
        prev_b = np.where(frozen[:, None], beliefs, bels)
        if frozen.all():
            break
    if return_belief:
        return marginals, beliefs
    return marginals
