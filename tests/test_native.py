"""Native C++ cluster kernels: build, parity with Python/scipy paths."""

import numpy as np
import pytest

from nmc_tpu import native
from nmc_tpu.ops.clusters import (disagreement_clusters,
                                  disagreement_clusters_adj, find_clusters)

from conftest import random_sk

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def sparse_J(rng, n=40, degree=3):
    J = np.zeros((n, n))
    for i in range(n):
        for j in rng.choice(n, size=degree, replace=False):
            if i != j:
                w = rng.normal()
                J[i, j] = J[j, i] = w
    return J


def test_connected_components_parity(rng):
    J = sparse_J(rng)
    adj = native.CSRAdjacency(J)
    for _ in range(10):
        s1 = np.sign(rng.normal(size=40))
        s2 = np.sign(rng.normal(size=40))
        a = sorted(tuple(sorted(c.tolist())) for c in
                   disagreement_clusters_adj(adj, s1, s2))
        b = sorted(tuple(sorted(c.tolist())) for c in
                   disagreement_clusters(J, s1, s2))
        assert a == b


def test_connected_components_dense_parity(rng):
    J, _ = random_sk(rng, 20)
    adj = native.CSRAdjacency(J)
    s1 = np.sign(rng.normal(size=20))
    s2 = -s1  # everything disagrees -> one dense component
    comps = disagreement_clusters_adj(adj, s1, s2)
    assert len(comps) == 1 and comps[0].size == 20


def test_backbone_clusters_parity(rng):
    J = sparse_J(rng, n=30)
    adj = native.CSRAdjacency(J)
    for trial in range(5):
        mag = np.tanh(2.5 * rng.normal(size=30))
        ours = native.backbone_clusters(adj, mag, 0.6, 0.3, 0.01)
        ref = find_clusters(J, mag, 0.6, 0.3, 0.01)
        assert sorted(tuple(sorted(c.tolist())) for c in ours) == \
               sorted(tuple(sorted(c.tolist())) for c in ref)


def test_empty_active_set(rng):
    J = sparse_J(rng, n=10)
    adj = native.CSRAdjacency(J)
    s = np.ones(10)
    assert disagreement_clusters_adj(adj, s, s) == []


class TestDeviceLabels:
    """Exactness of the device label propagation (sparse and dense) vs
    host connected components, at chimera-512 scale (VERDICT round 1 #6)."""

    def _chimera_like(self, seed):
        from nmc_tpu.io.generators import chimera_graph
        return chimera_graph(8, 8, 4, seed=seed)   # N = 512

    def test_sparse_labels_match_host_components(self):
        import jax.numpy as jnp
        from nmc_tpu.ops.clusters import (disagreement_clusters,
                                          disagreement_labels_sparse)
        from nmc_tpu.ops.lbp_sparse import EdgeGraph
        prob = self._chimera_like(0)
        rng = np.random.default_rng(1)
        s1 = rng.choice([-1.0, 1.0], prob.n)
        # flip a contiguous-ish patch to build long disagreement chains
        s2 = s1.copy()
        flip = rng.random(prob.n) < 0.45
        s2[flip] = -s2[flip]
        g = EdgeGraph.from_dense(prob.J)
        labels = np.asarray(disagreement_labels_sparse(
            g.src, g.dst, jnp.asarray(s1, jnp.float32),
            jnp.asarray(s2, jnp.float32), num_nodes=prob.n))
        comps = disagreement_clusters(prob.J, s1, s2)
        # each host component must map to ONE device label == its min index
        seen = set()
        for c in comps:
            lab = set(labels[c].tolist())
            assert lab == {int(c.min())}, f"component split: {lab}"
            seen.update(lab)
        # agreeing spins labelled n
        agree = np.flatnonzero(s1 * s2 > 0)
        assert np.all(labels[agree] == prob.n)
        # number of distinct component labels matches
        assert len(seen) == len(comps)

    def test_dense_labels_match_sparse(self):
        import jax.numpy as jnp
        from nmc_tpu.ops.clusters import (disagreement_labels_device,
                                          disagreement_labels_sparse)
        from nmc_tpu.ops.lbp_sparse import EdgeGraph
        from nmc_tpu.io.generators import ea_2d as random_ea2d
        prob = random_ea2d(12, seed=3)   # N = 144, 4-regular: long paths
        rng = np.random.default_rng(4)
        s1 = rng.choice([-1.0, 1.0], prob.n)
        s2 = s1.copy()
        flip = rng.random(prob.n) < 0.5
        s2[flip] = -s2[flip]
        g = EdgeGraph.from_dense(prob.J)
        dense = np.asarray(disagreement_labels_device(
            jnp.asarray(prob.J, jnp.float32), jnp.asarray(s1, jnp.float32),
            jnp.asarray(s2, jnp.float32)))
        sparse = np.asarray(disagreement_labels_sparse(
            g.src, g.dst, jnp.asarray(s1, jnp.float32),
            jnp.asarray(s2, jnp.float32), num_nodes=prob.n))
        np.testing.assert_array_equal(dense, sparse)

    def test_blocked_labels_match_sparse(self):
        """The union-tile masked-min propagation (the EnsembleICM fast
        Houdayer path at streamed-kernel scale) reaches the same exact
        component-min labels as the edge-list segment_min path, in the
        blocked/padded index space — chimera-512 scale."""
        import jax.numpy as jnp
        from nmc_tpu.core.problem import block_problem, block_sparse_tiles
        from nmc_tpu.ops.clusters import (disagreement_labels_blocked,
                                          disagreement_labels_sparse)
        from nmc_tpu.ops.lbp_sparse import EdgeGraph
        prob = self._chimera_like(2)
        blocked = block_problem(prob, block_size=128)
        n_pad = blocked.n_pad
        Jb = blocked.J_rows.reshape(n_pad, n_pad)
        col_idx, J_tiles = block_sparse_tiles(blocked)
        rng = np.random.default_rng(7)
        s1 = rng.choice([-1.0, 1.0], n_pad)
        s2 = s1.copy()
        flip = rng.random(n_pad) < 0.45
        s2[flip] = -s2[flip]
        # padded spins agree (the engines keep them pinned to +1)
        s1[~blocked.active] = 1.0
        s2[~blocked.active] = 1.0
        g = EdgeGraph.from_dense(Jb)
        sparse = np.asarray(disagreement_labels_sparse(
            g.src, g.dst, jnp.asarray(s1, jnp.float32),
            jnp.asarray(s2, jnp.float32), num_nodes=n_pad))
        blk = np.asarray(disagreement_labels_blocked(
            jnp.asarray(col_idx), jnp.asarray(J_tiles != 0),
            jnp.asarray(s1, jnp.float32), jnp.asarray(s2, jnp.float32)))
        np.testing.assert_array_equal(blk, sparse)

    def test_matmul_labels_match_sparse(self):
        """The one-hot neighbor-plane matmul propagation (the EnsembleICM
        default Houdayer path on bounded-degree topologies) reaches the
        same exact component-min labels as the edge-list segment_min
        path, including the hi/lo byte split that keeps label values
        exact through bf16 planes and TF32 default-precision matmuls."""
        import jax.numpy as jnp
        from nmc_tpu.core.problem import block_problem, block_sparse_tiles
        from nmc_tpu.ops.clusters import (build_neighbor_planes,
                                          disagreement_labels_matmul,
                                          disagreement_labels_sparse)
        from nmc_tpu.ops.lbp_sparse import EdgeGraph
        prob = self._chimera_like(2)
        blocked = block_problem(prob, block_size=128)
        n_pad = blocked.n_pad
        Jb = blocked.J_rows.reshape(n_pad, n_pad)
        col_idx, J_tiles = block_sparse_tiles(blocked)
        planes = build_neighbor_planes(col_idx, J_tiles)
        g = EdgeGraph.from_dense(Jb)
        rng = np.random.default_rng(11)
        for dens in (0.1, 0.45, 0.9):
            s1 = rng.choice([-1.0, 1.0], n_pad)
            s2 = s1.copy()
            flip = rng.random(n_pad) < dens
            s2[flip] = -s2[flip]
            s1[~blocked.active] = 1.0
            s2[~blocked.active] = 1.0
            sparse = np.asarray(disagreement_labels_sparse(
                g.src, g.dst, jnp.asarray(s1, jnp.float32),
                jnp.asarray(s2, jnp.float32), num_nodes=n_pad))
            mm = np.asarray(disagreement_labels_matmul(
                planes, jnp.asarray(s1, jnp.float32),
                jnp.asarray(s2, jnp.float32)))
            np.testing.assert_array_equal(mm, sparse)

    def test_neighbor_planes_degree_cap(self):
        import pytest
        from nmc_tpu.core.problem import block_problem, block_sparse_tiles
        from nmc_tpu.io.generators import random_sk
        from nmc_tpu.ops.clusters import build_neighbor_planes
        prob = random_sk(24, seed=1)          # complete graph, degree 23
        blocked = block_problem(prob, block_size=8)
        col_idx, J_tiles = block_sparse_tiles(blocked)
        with pytest.raises(ValueError, match="degree"):
            build_neighbor_planes(col_idx, J_tiles)
        planes = build_neighbor_planes(col_idx, J_tiles, max_degree=32)
        assert planes.degree == 23
