"""Sparse edge-list LBP agrees with the dense implementation."""

import jax.numpy as jnp
import numpy as np

from nmc_tpu.ops.lbp import (convexification_epsilon, lbp_convexified,
                             loopy_belief_propagation)
from nmc_tpu.ops.lbp_sparse import (EdgeGraph, sparse_lbp,
                                    sparse_lbp_convexified)


def sparse_instance(rng, n=30, degree=3):
    J = np.zeros((n, n))
    for i in range(n):
        nbrs = rng.choice(n, size=degree, replace=False)
        for j in nbrs:
            if i != j and J[i, j] == 0:
                w = rng.normal() * 0.4
                J[i, j] = J[j, i] = w
    h = rng.normal(size=n) * 0.3
    return J, h


def test_edge_graph_construction(rng):
    J, _ = sparse_instance(rng)
    g = EdgeGraph.from_dense(J)
    src, dst, w, rev = (np.asarray(g.src), np.asarray(g.dst),
                        np.asarray(g.weight), np.asarray(g.rev))
    assert g.num_edges == np.count_nonzero(J)
    np.testing.assert_allclose(w, J[src, dst])
    # reverse map really reverses
    np.testing.assert_array_equal(src[rev], dst)
    np.testing.assert_array_equal(dst[rev], src)


def test_sparse_matches_dense_lbp(rng):
    J, h = sparse_instance(rng)
    n = J.shape[0]
    beta = 0.8
    dense = loopy_belief_propagation(
        jnp.asarray(J), jnp.asarray(h), beta,
        jnp.zeros((n, n)), jnp.zeros((n, n)), 1e-10, max_iterations=300)
    g = EdgeGraph.from_dense(J)
    sparse = sparse_lbp(g.src, g.dst, g.weight, g.rev, jnp.asarray(h), beta,
                        jnp.zeros(g.num_edges), 1e-10,
                        max_iterations=300, num_nodes=n)
    np.testing.assert_allclose(np.asarray(sparse.magnetizations),
                               np.asarray(dense.magnetizations), atol=1e-7)
    np.testing.assert_allclose(np.asarray(sparse.h_tilde),
                               np.asarray(dense.h_tilde), atol=1e-6)


def test_sparse_convexified_matches_dense(rng):
    J, h = sparse_instance(rng)
    beta = 2.0
    eps = convexification_epsilon(J, h)
    m_star = np.sign(rng.normal(size=J.shape[0]))
    dense = lbp_convexified(
        jnp.asarray(J), jnp.asarray(h), beta, m_star, eps,
        lambda_start=2.0, lambda_end=0.01, lambda_reduction_factor=0.7,
        tolerance=1e-9, max_iterations=300)
    g = EdgeGraph.from_dense(J)
    sparse_marg = sparse_lbp_convexified(
        g, h, beta, m_star, eps,
        lambda_start=2.0, lambda_end=0.01, lambda_reduction_factor=0.7,
        tolerance=1e-9, max_iterations=300)
    np.testing.assert_allclose(sparse_marg, dense.marginal, atol=1e-6)


class TestLBPPlanes:
    """Scatter-free slotted-edge LBP (ops/lbp_planes) vs the edge-list
    path. The per-iteration math is bit-identical (verified during
    development); multi-rung outputs can differ when a rung sits exactly
    at the convergence margin (float summation ORDER differs — the
    divergence policy keeps a different rung), so the multi-rung
    assertion uses a convergent regime and the hard-β check is
    single-rung."""

    def _setup(self, limit=1):
        import jax.numpy as jnp
        from nmc_tpu.core.problem import block_problem, block_sparse_tiles
        from nmc_tpu.io.generators import chimera_graph
        from nmc_tpu.ops.lbp_planes import (build_edge_slot_planes,
                                            w_slot_from_tiles)
        # a seeded C_{4,4,4} (128 spins, the chimera128 family's topology)
        prob = chimera_graph(4, 4, seed=0, pm=False).normalized()[0]
        bl = block_problem(prob, block_size=128)
        Jb = bl.J_rows.reshape(bl.n_pad, bl.n_pad)
        col_idx, J_tiles = block_sparse_tiles(bl)
        esp = build_edge_slot_planes(col_idx, J_tiles != 0)
        w_slot = w_slot_from_tiles(esp, J_tiles)
        g = EdgeGraph.from_dense(Jb)
        return bl, esp, jnp.asarray(w_slot, jnp.float32), g

    def test_matches_sparse_convergent(self):
        import jax.numpy as jnp
        from nmc_tpu.ops.lbp_jit import convexified_marginal_sparse
        from nmc_tpu.ops.lbp_planes import convexified_marginal_planes
        bl, esp, w_slot, g = self._setup()
        rng = np.random.default_rng(5)
        n = bl.n_pad
        ladder = [3.0, 1.5, 0.75, 0.375, 0.1875, 0.09, 0.045, 0.01]
        for trial in range(3):
            h = jnp.asarray(rng.normal(size=n) * 0.3, jnp.float32)
            eps = jnp.asarray(np.abs(rng.normal(size=n)) * 0.5, jnp.float32)
            m_star = jnp.asarray(rng.choice([-1.0, 1.0], n), jnp.float32)
            ref = convexified_marginal_sparse(
                g, g.weight.astype(jnp.float32), h, eps, m_star,
                beta=0.8, ladder=ladder, max_iterations=60, tolerance=1e-7)
            got = convexified_marginal_planes(
                esp, w_slot, h, eps, m_star,
                beta=0.8, ladder=ladder, max_iterations=60, tolerance=1e-7)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       atol=1e-4, rtol=1e-4)

    def test_matches_sparse_single_rung_hard_beta(self):
        import jax.numpy as jnp
        from nmc_tpu.ops.lbp_jit import convexified_marginal_sparse
        from nmc_tpu.ops.lbp_planes import convexified_marginal_planes
        bl, esp, w_slot, g = self._setup()
        rng = np.random.default_rng(7)
        n = bl.n_pad
        h = jnp.asarray(rng.normal(size=n) * 0.3, jnp.float32)
        eps = jnp.asarray(np.abs(rng.normal(size=n)) * 0.5, jnp.float32)
        m_star = jnp.asarray(rng.choice([-1.0, 1.0], n), jnp.float32)
        for lam in (3.0, 0.75, 0.01):
            ref = convexified_marginal_sparse(
                g, g.weight.astype(jnp.float32), h, eps, m_star,
                beta=2.0, ladder=[lam], max_iterations=30, tolerance=1e-7)
            got = convexified_marginal_planes(
                esp, w_slot, h, eps, m_star,
                beta=2.0, ladder=[lam], max_iterations=30, tolerance=1e-7)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)

    def test_degree_cap_raises(self):
        import pytest
        from nmc_tpu.core.problem import block_problem, block_sparse_tiles
        from nmc_tpu.io.generators import random_sk
        from nmc_tpu.ops.lbp_planes import build_edge_slot_planes
        prob = random_sk(24, seed=2)
        bl = block_problem(prob, block_size=8)
        col_idx, J_tiles = block_sparse_tiles(bl)
        with pytest.raises(ValueError, match="degree"):
            build_edge_slot_planes(col_idx, J_tiles != 0)
