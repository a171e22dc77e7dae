"""Scatter-free convexified LBP over a slotted edge layout.

The O(nnz) edge-message LBP (ops/lbp_jit.convexified_marginal_sparse)
spends its time in three scatter/gather ops per iteration (segment_sum,
S[src], u[rev]) — the same per-op cost class the Houdayer label
propagation avoided with its matmul rewrite
(ops/clusters.disagreement_labels_matmul). This module
applies the same cure to LBP:

  * edges live in a SLOTTED layout u[v, d] = the d-th incoming message
    of node v (D = max degree, dummy slots carry w=0 couplings whose
    messages are identically zero) — so `segment_sum` becomes
    `u.sum(axis=1)`, no scatter;
  * the neighbor gathers (S at each slot's source node, and each slot's
    reverse message) are STATIC index patterns over the blocked layout,
    expressed as one-hot matmuls (the NeighborPlanes construction of
    ops/clusters) — no data-dependent gather.

Exactness: unlike the integer labels of the Houdayer path (which use an
exact hi/lo byte split through default-precision bf16/TF32 matmuls),
LBP messages are arbitrary float32 — so every one-hot contraction here
runs at jax.lax.Precision.HIGHEST: full float32 (never TF32), so each
one-term selection (a 0/1 multiplier times one f32 operand, plus exact
zeros) is EXACT. The only deviation from the edge-list path is float summation
ORDER in the per-node reduction — tests compare with tolerance, and the
backend is opt-in until profiled on hardware.

Semantics match convexified_marginal_sparse (reference:
LBP_convexified + LoopyBeliefPropagation, /root/reference/NMC/nmc.py:
93-228, /root/reference/NPT/npt.py:129-264), including the per-λ-rung
divergence policy (a non-converged rung keeps the previous rung's
marginal, npt.py:181-183).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .lbp import atanh_saturated

_HI = lax.Precision.HIGHEST


class EdgeSlotPlanes(NamedTuple):
    """Host-precomputed static structure of one (union) topology.

    gather  [nB, K, nB]      f32 one-hot over block ids (stage 1)
    planes  [nB, D, B, K*B+1] bf16 one-hot slot->source rows (stage 2;
                             dummy slots point at the trailing sentinel
                             column, which callers fill with 0)
    rev     [n, D, D]        f32 one-hot: rev[v, d, d'] = 1 iff the
                             reverse of slot (v, d) is slot (nbr, d')
    slot_col [nB, D, B]      int32 (k*B + c) flattened lab_c position of
                             each slot's source (for w_slot extraction)
    n_pad, block_size, degree
    """
    gather: np.ndarray
    planes: np.ndarray
    rev: np.ndarray
    slot_col: np.ndarray
    n_pad: int
    block_size: int
    degree: int


def build_edge_slot_planes(col_idx: np.ndarray, adj_union: np.ndarray,
                           *, max_degree: int = 16) -> EdgeSlotPlanes:
    """Build the slotted-edge structure from union block-sparse tiles.

    col_idx: [nB, K] int32; adj_union: [nB, K, B, B] bool — True where ANY
    instance of the family has a coupling (absent edges of a particular
    instance simply carry w_slot=0 there). Symmetric topologies only
    (undirected graphs; every edge's reverse must exist).
    """
    col_idx = np.asarray(col_idx)
    adj = np.asarray(adj_union, bool)
    nB, K, B, _ = adj.shape
    n = nB * B
    deg = adj.sum(axis=(1, 3))                   # [nB, B]
    D = int(deg.max()) if deg.size else 0
    if D > max_degree:
        raise ValueError(
            f"max node degree {D} exceeds the edge-slot plane cap "
            f"{max_degree}; use the edge-list LBP for dense instances")
    D = max(D, 1)

    gather = np.zeros((nB, K, nB), np.float32)
    gather[np.arange(nB)[:, None], np.arange(K)[None, :], col_idx] = 1.0

    # neighbor lists in the SAME (k, c) scan order as
    # clusters.build_neighbor_planes
    nbr = np.full((n, D), -1, np.int64)          # global source node ids
    slot_col = np.zeros((nB, D, B), np.int32)    # k*B + c per slot
    planes = np.zeros((nB, D, B, K * B + 1), np.float32)
    planes[:, :, :, K * B] = 1.0
    for i in range(nB):
        for r in range(B):
            ks, cs = np.nonzero(adj[i, :, r, :])
            v = i * B + r
            for d, (k, c) in enumerate(zip(ks, cs)):
                planes[i, d, r, K * B] = 0.0
                planes[i, d, r, k * B + c] = 1.0
                slot_col[i, d, r] = k * B + c
                nbr[v, d] = col_idx[i, k] * B + c

    # reverse slots: slot (v, d) receives u -> v; its reverse (v -> u)
    # sits in u's slot list at the position d' with nbr[u, d'] == v
    rev = np.zeros((n, D, D), np.float32)
    for v in range(n):
        for d in range(D):
            u = nbr[v, d]
            if u < 0:
                continue
            dprime = np.nonzero(nbr[u] == v)[0]
            if dprime.size != 1:
                raise ValueError(
                    f"topology is not symmetric at edge {u}->{v}")
            rev[v, d, dprime[0]] = 1.0
    return EdgeSlotPlanes(gather, planes.astype(jnp.bfloat16), rev,
                          slot_col, n, B, D)


def w_slot_from_tiles(esp: EdgeSlotPlanes, J_tiles: np.ndarray) -> np.ndarray:
    """Per-instance slot couplings w[v, d] from the instance's union-layout
    tiles [nB, K, B, B] (zero where this instance lacks the union edge)."""
    J_tiles = np.asarray(J_tiles)
    nB, K, B, _ = J_tiles.shape
    D = esp.degree
    flat = J_tiles.transpose(0, 2, 1, 3).reshape(nB, B, K * B)  # [i, r, kc]
    w = np.zeros((nB, D, B), J_tiles.dtype)
    for d in range(D):
        w[:, d, :] = np.take_along_axis(
            flat, esp.slot_col[:, d, :, None].astype(np.int64),
            axis=2)[..., 0]
    # dummy slots (sentinel) may alias position 0; zero them explicitly
    dummy = np.asarray(esp.planes, np.float32)[:, :, :, K * B] > 0.5
    w[dummy] = 0.0
    return np.ascontiguousarray(
        w.transpose(0, 2, 1).reshape(esp.n_pad, D))   # [n, D]


def convexified_marginal_planes(esp, w_slot, h, epsilon, m_star, *, beta,
                                ladder, max_iterations, tolerance):
    """Convexified LBP belief logits for ONE chain over the slotted
    layout — drop-in for lbp_jit.convexified_marginal_sparse (same λ
    ladder, divergence policy, and return convention: belief LOGITS
    beta*(h_λ + Σ u)). All one-hot contractions at Precision.HIGHEST
    (exact one-term selections; see module docstring)."""
    n = esp.n_pad
    B = esp.block_size
    nB = n // B
    K = (esp.planes.shape[3] - 1) // B
    D = esp.degree
    beta = jnp.asarray(beta, h.dtype)
    G = jnp.asarray(esp.gather)
    P = jnp.asarray(esp.planes)
    R = jnp.asarray(esp.rev)
    w = jnp.asarray(w_slot, h.dtype)             # [n, D]
    tanh_bw = jnp.tanh(beta * w)

    def gather_rows(X):
        """X [n, F] -> X_nbr [n, D, F]: row of each slot's source node."""
        F = X.shape[1]
        X2 = X.reshape(nB, B, F)
        X_c = jnp.einsum("ikb,bcf->ikcf", G, X2, precision=_HI)
        ext = jnp.concatenate(
            [X_c.reshape(nB, K * B, F),
             jnp.zeros((nB, 1, F), X.dtype)], axis=1)
        X_nbr = jnp.einsum("idrq,iqf->idrf", P, ext, precision=_HI)
        return X_nbr.transpose(0, 2, 1, 3).reshape(n, D, F)

    def lbp(h_lambda, u0):
        def step(state):
            u, it, _ = state
            S = h_lambda + jnp.sum(u, axis=1)              # [n]
            X = jnp.concatenate([S[:, None], u], axis=1)   # [n, 1+D]
            X_nbr = gather_rows(X)                         # [n, D, 1+D]
            S_src = X_nbr[:, :, 0]                         # [n, D]
            u_rows = X_nbr[:, :, 1:]                       # [n, D, D]
            u_rev = jnp.einsum("vde,vde->vd", R, u_rows,
                               precision=_HI)
            h_msg = S_src - u_rev
            u_new = atanh_saturated(
                tanh_bw * jnp.tanh(beta * h_msg)) / beta
            ch = jnp.max(jnp.abs(u_new - u)) / (
                jnp.max(jnp.abs(u_new) + jnp.abs(u)) + 1e-30)
            return u_new, it + 1, ch < tolerance

        def cond(state):
            _, it, conv = state
            return (it < max_iterations) & (~conv)

        u, _, conv = lax.while_loop(
            cond, step, (u0, jnp.int32(0), jnp.bool_(False)))
        S = h_lambda + jnp.sum(u, axis=1)
        return beta * S, u, conv

    # u0[v, d] = w * m_star[v]: slot (v, d) receives at v, matching the
    # edge-list init u0[e] = w_e * m_star[dst[e]]
    u = w * m_star[:, None]
    marginal = jnp.zeros(n, h.dtype)
    have_prev = jnp.bool_(False)
    for lam in ladder:
        h_lambda = h + lam * m_star * epsilon
        mag, u, conv = lbp(h_lambda, u)
        marginal = jnp.where(conv | ~have_prev, mag, marginal)
        have_prev = have_prev | conv
    return marginal
