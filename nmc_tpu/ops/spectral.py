"""Spectral ground-state search for planted / low-rank-structured Ising
instances.

Wishart-planted ensembles (Hamze et al., "Wishart planted ensemble"; the
reference ships them as `wishart_planting_N_*_alpha_*` folders, e.g.
/root/reference/NMC/examples/contrived_wishart_backbone/wishart_planting_N_50_alpha_0.20)
have a golf-course landscape: J = c(t t'-aligned low-rank part + bulk), the
planted state t is the unique ground state, and every 1-flip-stable state a
random start descends into sits ~1.5 % above it.  Measured on the shipped
N=50 α=0.20 folder: all three MCMC arms (PT / NMC / ICM, 32 replicas,
400k sweeps) stall at EXACTLY the same energy per instance — the same one
2000 independent greedy descents from random starts reach — while the
planted state is invisible to local moves.

Because W's columns are orthogonal to t, t lies in the top eigenspace of
J (the null space of W W'), so sign-rounding eigenvectors of J and greedy-
descending recovers the planted state almost always (47/50 of the shipped
N=50 instances; 48/50 with the 2-flip polish; sub-second per instance).
This module packages that as:

  * host search: `spectral_search(prob)` — eigh + rounding + 1-flip descent
    (+ optional 2-flip polish), numpy, exact f64;
  * device search: `spectral_candidates_device(J, h, ...)` — the same
    rounding/descent as a batched jittable program (candidates × spins
    matmuls, `lax.while_loop` until every candidate is 1-flip stable) for
    device-resident preconditioning at larger N;
  * MCMC seeding: campaign arms accept `init_state(key, m0=...)` where m0
    comes from `spectral_candidates`, so the coldest chains start inside
    the planted basin instead of the metastable sea.

This is an addition over the reference (which has no spectral component);
it is the natural accelerator answer to the wishart families the reference
itself ships as its hard examples.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp


# ----------------------------------------------------------------------
# Host (numpy, f64) implementation
# ----------------------------------------------------------------------

def greedy_descent(J: np.ndarray, s: np.ndarray,
                   h: Optional[np.ndarray] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Steepest 1-flip descent to a local minimum of
    E = -(1/2) s'Js - h's.  Returns (state, local field J s + h)."""
    s = np.array(s, dtype=np.float64, copy=True)
    f = J @ s if h is None else J @ s + h
    while True:
        dE = 2.0 * s * f            # flip i: E -> E + 2 s_i f_i
        i = int(np.argmin(dE))
        if dE[i] >= -1e-12:
            return s, f
        s[i] = -s[i]
        f = f + 2.0 * s[i] * J[:, i]


def two_flip_descent(J: np.ndarray, s: np.ndarray,
                     h: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Steepest 2-flip descent (each accepted pair is followed by 1-flip
    descent to stability).  O(n^2) per step — host polish for the
    candidates the 1-flip descent leaves near the target."""
    s, f = greedy_descent(J, s, h)
    n = s.shape[0]
    while True:
        d1 = 2.0 * s * f
        # flip {i, j}: dE = d1_i + d1_j - 4 J_ij s_i s_j
        M = d1[:, None] + d1[None, :] - 4.0 * J * np.outer(s, s)
        np.fill_diagonal(M, np.inf)
        i, j = np.unravel_index(int(np.argmin(M)), (n, n))
        if M[i, j] >= -1e-12:
            return s, f
        s[i] = -s[i]
        f = f + 2.0 * s[i] * J[:, i]
        s[j] = -s[j]
        f = f + 2.0 * s[j] * J[:, j]
        s, f = greedy_descent(J, s, h)


def _energy(J, h, s):
    return float(-(0.5 * s @ (J @ s) + (0.0 if h is None else h @ s)))


def batched_descent_host(J: np.ndarray, S: np.ndarray,
                         h: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized greedy 1-flip descent of a batch [C, n] (numpy analogue
    of `batched_descent_device`): every iteration flips the steepest
    improving spin of each not-yet-stable candidate, fields updated with
    one gathered-column rank-1 step."""
    S = np.array(S, dtype=np.float64)
    C, n = S.shape
    F = S @ J if h is None else S @ J + h[None, :]
    rows = np.arange(C)
    alive = np.ones(C, dtype=bool)
    while alive.any():
        dE = 2.0 * S * F
        i = np.argmin(dE, axis=1)
        improving = dE[rows, i] < -1e-12
        alive = alive & improving
        if not alive.any():
            break
        a = np.flatnonzero(alive)
        ia = i[a]
        S[a, ia] = -S[a, ia]
        F[a] += 2.0 * S[a, ia][:, None] * J[ia, :]
    return S


def auto_subspace_dim(w: np.ndarray, *, min_top_frac: float = 0.25) -> int:
    """Estimate the degenerate top-eigenspace dimension of a planted
    instance from its (ascending) eigenvalue spectrum: the largest gap in
    the lower part of the spectrum separates the M strongly-negative
    W'W directions from the near-degenerate null-space bulk.  Keeps at
    least `min_top_frac` of the spectrum on top."""
    w = np.asarray(w, dtype=np.float64)
    n = w.shape[0]
    gaps = np.diff(w)
    lo, hi = 0, n - max(2, int(n * min_top_frac))
    if hi <= lo:
        return max(2, n // 2)
    k = int(np.argmax(gaps[lo:hi])) + lo   # gap between w[k] and w[k+1]
    return n - k - 1                       # bottom group = indices 0..k


def difference_map_rounding(V: np.ndarray, *, num_starts: int = 512,
                            iters: int = 500, beta: float = 0.9,
                            snapshot_every: int = 20,
                            seed: int = 0) -> np.ndarray:
    """Difference-map (Douglas–Rachford-style) search for +-1 vectors
    near the column span of the orthonormal basis `V` [n, d]:

        PA(x) = V V' x            (projection onto the subspace)
        PB(y) = sign(y)           (projection onto the hypercube)
        x    <- x + beta * (PB(2 PA(x) - x) - PA(x))

    When the planted state is only NEAR the subspace (the Wishart
    float-coupling folders: removing diag(W'W) tilts the null space, so
    ||P t - t||^2/n ~ 1e-3 and no exact fixed point exists), the iterate
    orbits the near-intersection; the *pooled snapshots* of sign(PA(x))
    taken every `snapshot_every` steps pass through the planted basin.
    Returns the unique pooled +-1 snapshots [C', n] — descend them on the
    true J and keep the minimum.  Solves the shipped
    `wishart_planting_N_25_alpha_*` float folders (40/40 measured at
    C=512, iters=500) where plain eigenvector rounding gets 0/50 and
    400k-sweep PT/NMC/ICM all stall ~0.3 % above the planted energy."""
    n = V.shape[0]
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(num_starts, n))
    outs = []
    for it in range(iters):
        PA = (X @ V) @ V.T
        RB = np.sign(2.0 * PA - X)
        RB[RB == 0] = 1.0
        X = X + beta * (RB - PA)
        if it % snapshot_every == snapshot_every - 1:
            c = np.sign((X @ V) @ V.T)
            c[c == 0] = 1.0
            outs.append(c)
    if not outs:
        c = np.sign((X @ V) @ V.T)
        c[c == 0] = 1.0
        outs.append(c)
    return np.unique(np.concatenate(outs, axis=0), axis=0)


def spectral_candidates(J: np.ndarray, h: Optional[np.ndarray] = None,
                        *, top_k: Optional[int] = None,
                        num_subspace: int = 0,
                        subspace_dim: Optional[int] = None,
                        dm_starts: int = 0, dm_iters: int = 500,
                        dm_beta: float = 0.9, dm_dim: Optional[int] = None,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Sign-rounded eigenvectors of J (both signs when h breaks the Z2
    symmetry), greedy-descended in one batch, plus `num_subspace` rounded
    random samples from the top-`subspace_dim` eigenspace.  `top_k`
    restricts to the eigenvectors of the top_k LARGEST eigenvalues (the
    planted direction of a Wishart instance lives in the top n-M
    eigenspace, M = alpha*n); None = all n.  `dm_starts > 0` adds the
    pooled `difference_map_rounding` snapshots from that many random
    starts in the top-`dm_dim` eigenspace (`dm_dim=None` = the
    `auto_subspace_dim` spectral-gap estimate) — the fallback that cracks
    degenerate-eigenspace (float-coupling) planted folders invisible to
    single-eigenvector rounding.  Returns (states [C, n], energies [C])
    sorted ascending by energy."""
    J = np.asarray(J, dtype=np.float64)
    n = J.shape[0]
    w, v = np.linalg.eigh(J)
    vt = v.T[::-1]                       # rows = eigenvectors, top first
    if top_k is not None:
        vt = vt[:top_k]
    raw = [vt]
    if h is not None and np.any(h):
        raw.append(-vt)
    if num_subspace > 0:
        dim = subspace_dim if subspace_dim is not None else max(1, n // 2)
        V = v[:, n - dim:]
        rng = np.random.default_rng(seed)
        raw.append((V @ rng.normal(size=(dim, num_subspace))).T)
    X = np.concatenate(raw, axis=0)
    S = np.sign(X)
    S[S == 0] = 1.0
    if dm_starts > 0:
        d = int(dm_dim) if dm_dim else auto_subspace_dim(w)
        d = max(2, min(d, n - 1))
        S = np.concatenate([S, difference_map_rounding(
            v[:, n - d:], num_starts=dm_starts, iters=dm_iters,
            beta=dm_beta, seed=seed)], axis=0)
    S = batched_descent_host(J, S, h)
    energies = -(0.5 * np.einsum("cn,cn->c", S, S @ J)
                 + (S @ h if h is not None else 0.0))
    order = np.argsort(energies, kind="stable")
    return S[order], energies[order]


@dataclasses.dataclass
class SpectralResult:
    best_state: np.ndarray   # [n] +-1, f64
    best_energy: float
    states: np.ndarray       # [C, n] candidates, ascending energy
    energies: np.ndarray     # [C]


def spectral_search(prob, *, top_k: Optional[int] = None,
                    num_subspace: int = 0,
                    subspace_dim: Optional[int] = None,
                    dm_starts: int = 0, dm_iters: int = 500,
                    dm_beta: float = 0.9, dm_dim: Optional[int] = None,
                    polish: int = 0, seed: int = 0) -> SpectralResult:
    """Full host search on an `IsingProblem`: spectral candidates
    (+ optional difference-map pool, see `difference_map_rounding`), then
    an optional 2-flip polish of the `polish` lowest-energy candidates."""
    states, energies = spectral_candidates(
        prob.J, prob.h if np.any(prob.h) else None, top_k=top_k,
        num_subspace=num_subspace, subspace_dim=subspace_dim,
        dm_starts=dm_starts, dm_iters=dm_iters, dm_beta=dm_beta,
        dm_dim=dm_dim, seed=seed)
    h = prob.h if np.any(prob.h) else None
    if polish > 0:
        for c in range(min(polish, states.shape[0])):
            s, _ = two_flip_descent(prob.J, states[c], h)
            e = _energy(prob.J, h, s)
            if e < energies[c] - 1e-12:
                states[c], energies[c] = s, e
        order = np.argsort(energies, kind="stable")
        states, energies = states[order], energies[order]
    return SpectralResult(states[0], float(energies[0]), states, energies)


_HIGHEST = jax.lax.Precision.HIGHEST


# ----------------------------------------------------------------------
# Device (jax) implementation — batched rounding + descent as matmuls
# ----------------------------------------------------------------------

def batched_descent_device(J: jax.Array, S: jax.Array,
                           h: Optional[jax.Array] = None,
                           *, max_iters: Optional[int] = None) -> jax.Array:
    """Greedy 1-flip descent of a batch of states [C, n] to 1-flip
    stability, jittable.  Each iteration flips the steepest spin of every
    not-yet-stable candidate; the local fields are updated with one
    [C, n] x [n, n] matmul-free rank-1 step (gathered column), and the
    loop runs until all candidates are stable (bounded by `max_iters`,
    default 8n — descent over integer-scaled couplings terminates far
    earlier)."""
    C, n = S.shape
    dt = S.dtype
    Jd = J.astype(dt)
    hv = jnp.zeros((n,), dt) if h is None else h.astype(dt)
    max_iters = int(max_iters if max_iters is not None else 8 * n)

    def cond(carry):
        _, _, it, done = carry
        return jnp.logical_and(it < max_iters, jnp.logical_not(done.all()))

    def body(carry):
        S, F, it, done = carry
        dE = 2.0 * S * F                       # [C, n]
        i = jnp.argmin(dE, axis=1)             # [C]
        best = jnp.take_along_axis(dE, i[:, None], axis=1)[:, 0]
        flip = jnp.logical_and(best < -1e-6, jnp.logical_not(done))
        sgn = jnp.where(flip, -1.0, 1.0).astype(dt)          # [C]
        onehot = jax.nn.one_hot(i, n, dtype=dt)              # [C, n]
        S_new = S * (1.0 - (1.0 - sgn[:, None]) * onehot)
        # field update: F += 2 * s_new_i * J[:, i]  (rows gathered by
        # one-hot matmul, no dynamic gather; HIGHEST so a TF32 default
        # cannot round J and steer the descent)
        s_new_i = jnp.sum(S_new * onehot, axis=1)            # [C]
        F_new = F + 2.0 * (s_new_i * flip.astype(dt))[:, None] * (
            jnp.matmul(onehot, Jd, precision=_HIGHEST))
        done_new = jnp.logical_or(done, jnp.logical_not(flip))
        return S_new, F_new, it + 1, done_new

    F0 = jnp.matmul(S, Jd, precision=_HIGHEST) + hv[None, :]
    S_out, _, _, _ = jax.lax.while_loop(
        cond, body, (S, F0, jnp.int32(0), jnp.zeros((C,), bool)))
    return S_out


def difference_map_rounding_device(V: jax.Array, *, num_starts: int = 512,
                                   iters: int = 500, beta: float = 0.9,
                                   snapshot_every: int = 20,
                                   key: Optional[jax.Array] = None,
                                   dtype=jnp.float32) -> jax.Array:
    """Device analogue of `difference_map_rounding`: a `lax.scan` of
    snapshot blocks, each an inner scan of `snapshot_every` difference-map
    steps (two [C, n] x [n, d] matmuls per step, at default precision:
    a TF32 rounding only perturbs this heuristic pool, which
    `batched_descent_device` then descends exactly).  Returns the
    pooled +-1 snapshots [blocks * C, n] (not uniqued — descend them all
    with `batched_descent_device`; duplicates are harmless there)."""
    V = jnp.asarray(V, dtype)
    n = V.shape[0]
    if key is None:
        key = jax.random.PRNGKey(0)
    X0 = jax.random.normal(key, (num_starts, n), dtype)
    blocks = max(1, iters // snapshot_every)

    def dm_step(X, _):
        PA = (X @ V) @ V.T
        RB = jnp.sign(2.0 * PA - X)
        RB = jnp.where(RB == 0, 1.0, RB).astype(dtype)
        return X + beta * (RB - PA), None

    def block(X, _):
        X, _ = jax.lax.scan(dm_step, X, None, length=snapshot_every)
        PA = (X @ V) @ V.T
        snap = jnp.sign(PA) + (PA == 0).astype(dtype)
        return X, snap

    _, snaps = jax.lax.scan(block, X0, None, length=blocks)
    return snaps.reshape(blocks * num_starts, n)


def spectral_candidates_device(J: jax.Array,
                               h: Optional[jax.Array] = None,
                               *, num_subspace: int = 0,
                               subspace_dim: Optional[int] = None,
                               dm_starts: int = 0, dm_iters: int = 500,
                               dm_beta: float = 0.9,
                               dm_dim: Optional[int] = None,
                               key: Optional[jax.Array] = None,
                               dtype=jnp.float32,
                               ) -> Tuple[jax.Array, jax.Array]:
    """Device analogue of `spectral_candidates`: jnp.linalg.eigh +
    sign-rounding (+ optional `difference_map_rounding_device` pool) +
    `batched_descent_device`.  Returns (states [C, n], energies [C])
    sorted ascending.  `dm_dim` must be given explicitly here (static
    shape for jit; use `auto_subspace_dim` on host eigenvalues).  f32 by
    default — the descent only needs dE signs; re-verify winners in f64
    on the host as the campaign does for MCMC hits."""
    J = jnp.asarray(J, dtype)
    n = J.shape[0]
    w, v = jnp.linalg.eigh(J)
    cands = [jnp.sign(v.T) + (v.T == 0).astype(dtype)]
    if h is not None and bool(jnp.any(h)):
        cands.append(-cands[0])
    if key is None:
        key = jax.random.PRNGKey(0)
    if num_subspace > 0:
        key, sub = jax.random.split(key)
        dim = subspace_dim if subspace_dim is not None else max(1, n // 2)
        V = v[:, n - dim:]
        x = jax.random.normal(sub, (num_subspace, dim), dtype) @ V.T
        cands.append(jnp.sign(x) + (x == 0).astype(dtype))
    if dm_starts > 0:
        d = int(dm_dim) if dm_dim else max(1, n // 2)
        d = max(2, min(d, n - 1))
        key, sub = jax.random.split(key)
        cands.append(difference_map_rounding_device(
            v[:, n - d:], num_starts=dm_starts, iters=dm_iters,
            beta=dm_beta, key=sub, dtype=dtype))
    S = jnp.concatenate(cands, axis=0)
    S = batched_descent_device(J, S, h)
    hv = jnp.zeros((n,), dtype) if h is None else h.astype(dtype)
    E = -(0.5 * jnp.sum(S * jnp.matmul(S, J, precision=_HIGHEST), axis=1)
          + jnp.matmul(S, hv, precision=_HIGHEST))
    order = jnp.argsort(E)
    return S[order], E[order]
