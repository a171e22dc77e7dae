"""Backbone cluster extraction and Houdayer disagreement clusters.

Irregular, data-dependent-shape graph work stays OFF the jit hot path:
these run on the host (numpy/scipy) on tiny inputs pulled from device
(marginal vectors, spin states), exactly as SURVEY.md prescribes. A
fixed-iteration device-side label-propagation variant is provided for the
Houdayer move at large N.

Semantics match:
  * find_clusters (/root/reference/NMC/nmc.py:257-318): seeds are spins with
    |marginal| >= threshold_initial; each unclaimed seed starts a cluster
    together with its direct J-neighbors that are also seeds; then the
    threshold decays by threshold_step down to threshold_cutoff, each pass
    absorbing yet-unclaimed neighbors above the current threshold. (With the
    reference's shipped defaults the growth loop body never executes — that
    quirk is preserved since it follows from the same arithmetic.)
  * find_disagreement_clusters (/root/reference/NPT/apt_ICM.py:116-143):
    connected components of the J-adjacency subgraph induced on spins where
    s1_i * s2_i == -1.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

import jax
import jax.numpy as jnp


def find_clusters(
    J: np.ndarray,
    magnetizations: np.ndarray,
    threshold_initial: float,
    threshold_cutoff: float,
    threshold_step: float = 0.01,
) -> List[np.ndarray]:
    """Backbone clusters from LBP marginals (host-side).

    Returns a list of int index arrays (possibly overlapping the way the
    reference's are not — claimed spins are excluded exactly as there).
    """
    J = np.asarray(J.toarray() if hasattr(J, "toarray") else J)
    mag = np.asarray(magnetizations).reshape(-1)
    n = mag.shape[0]
    is_seed = np.abs(mag) >= threshold_initial
    claimed = np.zeros(n, dtype=bool)
    clusters: List[np.ndarray] = []

    for seed in np.flatnonzero(is_seed):
        if claimed[seed]:
            continue
        nbrs = J[seed] != 0
        grab = nbrs & is_seed & ~claimed
        grab[seed] = True
        members = np.flatnonzero(grab)
        # keep the seed first, like the reference's np.append(seed, common)
        members = np.concatenate(([seed], members[members != seed]))
        claimed[members] = True
        clusters.append(members)

    threshold = threshold_initial - threshold_step
    while threshold > threshold_cutoff:
        for i, cluster in enumerate(clusters):
            nbrs = np.any(J[cluster] != 0, axis=0) & ~claimed
            grow = np.flatnonzero(nbrs & (np.abs(mag) >= threshold))
            if grow.size:
                claimed[grow] = True
                clusters[i] = np.concatenate([cluster, grow])
        threshold -= threshold_step

    return clusters


def flatten_clusters(clusters: List[np.ndarray]) -> np.ndarray:
    """Concatenate cluster index arrays (/root/reference/NMC/nmc.py:373)."""
    if not clusters:
        return np.array([], dtype=np.int64)
    return np.concatenate(clusters).astype(np.int64)


def cluster_mask(n: int, clusters: List[np.ndarray] | np.ndarray) -> np.ndarray:
    """Boolean membership mask [n] from clusters or a flat index array."""
    mask = np.zeros(n, dtype=bool)
    flat = clusters if isinstance(clusters, np.ndarray) else flatten_clusters(clusters)
    mask[flat.astype(np.int64)] = True
    return mask


def backbone_mask_device(
    marginal: jax.Array,      # [..., N] LBP marginals (or beliefs, see logits)
    J_abs: jax.Array,         # [N, N] |J| (or any nonneg matrix with J's sparsity)
    threshold_initial: float,
    threshold_cutoff: float,
    threshold_step: float = 0.01,
    active: Optional[jax.Array] = None,
    *,
    logits: bool = False,
) -> jax.Array:
    """Device-side flat backbone mask with the reference's threshold-decay
    growth (/root/reference/NMC/nmc.py:299-316), batched over leading axes.

    The reference's pass at threshold t absorbs, for each cluster in turn,
    its yet-unclaimed neighbors with |marginal| >= t; absorbed spins only
    become absorption SOURCES on the next pass. On the flattened member
    set that is exactly ONE masked adjacency propagation per threshold
    rung: mask |= neighbor(mask) & (|m| >= t). The rung ladder
    (initial - step, ..., > cutoff) is static Python, so the whole growth
    unrolls inside jit. With the shipped defaults the ladder is empty and
    the mask reduces to pure thresholding — the same no-op quirk as the
    host path (SURVEY.md quirk 2). Flat-mask parity with
    find_clusters is tested at non-default cutoffs in tests/test_lbp.py.

    `logits=True`: `marginal` carries the belief LOGIT beta*(h + sum u)
    (the pre-tanh total field) instead of tanh of it, and each threshold
    t is mapped to atanh(t) in float64 on the host. The reference
    discriminates thresholds like 0.9999999 on float64 marginals
    (/root/reference/NMC/nmc.py:163,299); in float32 those marginals
    saturate to exactly 1.0 and the mask silently inflates (measured:
    74% vs the reference's 41% backbone on chimera512 at beta=13.63).
    |m| >= t  <=>  |logit| >= atanh(t), and atanh(0.9999999) = 8.38 is
    comfortably representable in f32 — full reference-f64 threshold
    semantics at f32 device speed.
    """
    if logits:
        def _thr(t):
            # static host-side f64; t may sit exactly at 1.0 from
            # user-specified ladders -> clamp inside atanh's domain
            return math.atanh(min(float(t), 1.0 - 1e-16))
    else:
        def _thr(t):
            return t
    mag = jnp.abs(marginal)
    mask = mag >= _thr(threshold_initial)
    if active is not None:
        mask = mask & active
    thr = threshold_initial - threshold_step
    while thr > threshold_cutoff:
        cand = mag >= _thr(thr)
        if active is not None:
            cand = cand & active
        # nonnegative sums tested against 0: exact at any matmul
        # precision (TF32 and bf16 keep f32's exponent range)
        nbr = jnp.matmul(mask.astype(J_abs.dtype), J_abs) > 0
        mask = mask | (nbr & cand)
        thr -= threshold_step
    return mask


def disagreement_clusters(
    J: np.ndarray, s1: np.ndarray, s2: np.ndarray
) -> List[np.ndarray]:
    """Houdayer clusters: connected components where s1*s2 == -1 (host).

    Same output set as the reference's BFS
    (/root/reference/NPT/apt_ICM.py:116-143), computed with
    scipy.sparse.csgraph.connected_components.
    """
    s1 = np.asarray(s1).reshape(-1)
    s2 = np.asarray(s2).reshape(-1)
    diff = np.flatnonzero(s1 * s2 == -1)
    if diff.size == 0:
        return []
    J = np.asarray(J.toarray() if hasattr(J, "toarray") else J)
    sub = csr_matrix((J[np.ix_(diff, diff)] != 0).astype(np.int8))
    ncomp, labels = connected_components(sub, directed=False)
    return [diff[labels == c] for c in range(ncomp)]


def disagreement_clusters_adj(adj, s1, s2) -> List[np.ndarray]:
    """Houdayer clusters over a prebuilt adjacency; uses the native C++
    union-find (nmc_tpu/native) when available, scipy otherwise. `adj` is a
    native.CSRAdjacency built ONCE per problem — the per-call cost is
    O(active nodes + incident edges) instead of re-densifying J."""
    from .. import native

    s1 = np.asarray(s1).reshape(-1)
    s2 = np.asarray(s2).reshape(-1)
    active = (s1 * s2) < 0
    if not active.any():
        return []
    if native.available():
        return native.connected_components_masked(adj, active)
    # scipy fallback
    diff = np.flatnonzero(active)
    J_mask = csr_matrix(
        (np.ones_like(adj.indices, dtype=np.int8),
         adj.indices, adj.indptr), shape=(adj.n, adj.n))
    sub = J_mask[diff][:, diff]
    ncomp, labels = connected_components(sub, directed=False)
    return [diff[labels == c] for c in range(ncomp)]


def _label_fixpoint(propagate, labels0, diff, n, max_iters, jump=True):
    """Run min-label propagation (+ optional pointer jumping) to a FIXED
    POINT.

    `propagate(labels) -> nbr_min` returns each node's minimum neighbor
    label over the active subgraph. Pointer jumping (labels[labels])
    halves label-chain lengths each step, so convergence is
    O(log diameter) rounds; the while_loop exits at the first unchanged
    round, making the result exact connected-component minima regardless
    of graph shape (fixes the silent truncation of the old fixed-64-iter
    scheme). `jump=False` skips the jumping gather — iterations then grow
    to the component eccentricity, which pays off when propagate is much
    cheaper than a data-dependent [n] gather (the matmul path)."""
    big = jnp.int32(n)

    def step(state):
        labels, _, it = state
        nbr_min = propagate(labels)
        new = jnp.where(diff, jnp.minimum(labels, nbr_min), big)
        if jump:
            # pointer jumping: follow the label's own label (component
            # minima only ever decrease, so this preserves exactness)
            safe = jnp.minimum(new, jnp.int32(n - 1))
            jumped = jnp.where(new < big, new[safe], big)
            new = jnp.minimum(new, jumped)
        changed = jnp.any(new != labels)
        return new, changed, it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    labels, _, _ = jax.lax.while_loop(
        cond, step, (labels0, jnp.bool_(True), jnp.int32(0)))
    return labels


def disagreement_labels_device(
    J: jax.Array, s1: jax.Array, s2: jax.Array,
    num_iters: Optional[int] = None,
) -> jax.Array:
    """Device-side min-label propagation over the disagreement subgraph
    (dense adjacency — small/medium N; see disagreement_labels_sparse for
    the edge-list variant that scales past dense [N, N] materialization).

    Returns labels [N]: spins agreeing get N; disagreeing spins get the
    minimum spin index of their disagreement component. Runs to a fixed
    point (exact); `num_iters` only caps the loop (None = N, the
    worst-case bound).
    """
    n = s1.shape[0]
    adj = (J != 0)
    diff = (s1 * s2) < 0
    idx = jnp.arange(n, dtype=jnp.int32)
    labels0 = jnp.where(diff, idx, jnp.int32(n))
    adj_diff = adj & diff[None, :] & diff[:, None]
    big = jnp.int32(n)

    def propagate(labels):
        return jnp.min(jnp.where(adj_diff, labels[None, :], big), axis=1)

    return _label_fixpoint(propagate, labels0, diff, n,
                           n if num_iters is None else num_iters)


def disagreement_labels_sparse(
    src: jax.Array, dst: jax.Array, s1: jax.Array, s2: jax.Array,
    *, num_nodes: int, num_iters: Optional[int] = None,
) -> jax.Array:
    """Edge-list variant of disagreement_labels_device: O(nnz) per round
    with segment-min reductions, no [N, N] materialization — the scalable
    path for the Houdayer move at large N
    (/root/reference/NPT/apt_ICM.py:116-143 semantics)."""
    n = num_nodes
    diff = (s1 * s2) < 0
    idx = jnp.arange(n, dtype=jnp.int32)
    labels0 = jnp.where(diff, idx, jnp.int32(n))
    edge_active = diff[src] & diff[dst]
    big = jnp.int32(n)

    def propagate(labels):
        cand = jnp.where(edge_active, labels[src], big)
        return jax.ops.segment_min(cand, dst, num_segments=n)

    return _label_fixpoint(propagate, labels0, diff, n,
                           n if num_iters is None else num_iters)


def disagreement_labels_blocked(
    col_idx: jax.Array, adj_tiles: jax.Array, s1: jax.Array, s2: jax.Array,
    *, num_iters: Optional[int] = None,
) -> jax.Array:
    """Block-sparse-tile variant of disagreement_labels_sparse: min-label
    propagation over the same [nB, K] union column-tile layout the
    ensembles build (parallel/ensemble_nmc._union_tiles).

    Each propagation step is one fused masked-min over the resident
    tiles — no segment_min scatter as in the edge-list path. Exact:
    identical fixed point to the sparse/dense
    variants (component-min labels), so _houdayer_from_labels draws the
    same move for the same key.

    col_idx:   [nB, K] int32 block-column ids (union pattern)
    adj_tiles: [nB, K, B, B] bool adjacency (row-block spin i adjacent to
               col-block spin j), e.g. `J_tiles != 0`
    """
    nB, K, B, _ = adj_tiles.shape
    n = nB * B
    assert s1.shape[0] == n, (s1.shape, adj_tiles.shape)
    diff = (s1 * s2) < 0
    idx = jnp.arange(n, dtype=jnp.int32)
    labels0 = jnp.where(diff, idx, jnp.int32(n))
    big = jnp.int32(n)
    diff_b = diff.reshape(nB, B)

    def propagate(labels):
        lab_c = labels.reshape(nB, B)[col_idx]       # [nB, K, B]
        dif_c = diff_b[col_idx]                      # [nB, K, B]
        cand = jnp.where(adj_tiles & dif_c[:, :, None, :],
                         lab_c[:, :, None, :], big)  # [nB, K, Brow, Bcol]
        return jnp.min(cand, axis=(1, 3)).reshape(n)

    return _label_fixpoint(propagate, labels0, diff, n,
                           n if num_iters is None else num_iters)


def houdayer_move_blocked(col_idx, adj_tiles, s1, s2, key, *,
                          num_iters: Optional[int] = None,
                          use_katzgraber: bool = True,
                          katzgraber_threshold: Optional[int] = None):
    """Houdayer move over union block-sparse tiles — same move semantics
    (and, for the same key, the same draw) as houdayer_move_sparse, with
    the label propagation running on fused tile masked-mins instead of
    segment_min scatters. The fast path for the batched ICM engines at
    streamed-kernel scale."""
    labels = disagreement_labels_blocked(col_idx, adj_tiles, s1, s2,
                                         num_iters=num_iters)
    return _houdayer_from_labels(labels, s1, s2, key,
                                 use_katzgraber=use_katzgraber,
                                 katzgraber_threshold=katzgraber_threshold)


class NeighborPlanes:
    """Host-precomputed one-hot operands for disagreement_labels_matmul.

    Encodes the (static) adjacency of one blocked instance as matmul
    operands so min-label propagation runs entirely as matmuls — no
    segment_min scatter, no data-dependent gather.

      gather [nB, K, nB]     one-hot over block ids: gather @ labels2d
                             pulls each row-block's K neighbor column
                             blocks ("lab_c"), exactly like
                             labels.reshape(nB, B)[col_idx] but as a
                             tiny matmul.
      planes [nB, D, B, K*B+1]  one-hot rows: plane d of row r in block
                             i points at the flattened lab_c position of
                             r's d-th neighbor, or at the trailing
                             sentinel column (value `big`) for d beyond
                             the row's degree.

    Exactness: the matmuls run at default precision, where a GPU may
    compute a float32 product in TF32 (11 significant bits: integers up
    to 2048 exact) and the planes are bfloat16 (8 significant bits:
    integers up to 256 exact). Label values reach n_pad, so the
    propagate step routes labels through an EXACT hi/lo byte split
    (labels = hi*256 + lo, both in [0, 256], exact in bfloat16 and in
    TF32); each one-hot row selects exactly one term, so the f32
    accumulation adds zeros to one exact value, and the recombined
    value <= n_pad is exact in f32. chip_smoke.py checks the labels
    bit-equal to the host components on the GPU at 4096 spins.
    Supports n_pad <= 65536.
    """

    def __init__(self, gather, planes, n_pad, block_size):
        self.gather = gather
        self.planes = planes
        self.n_pad = int(n_pad)
        self.block_size = int(block_size)

    @property
    def degree(self) -> int:
        return self.planes.shape[1]


def build_neighbor_planes(col_idx: np.ndarray, J_tiles: np.ndarray,
                          *, max_degree: Optional[int] = None,
                          degree: Optional[int] = None) -> NeighborPlanes:
    """Build NeighborPlanes from one instance's block-sparse tiles
    (core.problem.block_sparse_tiles / parallel.ensemble_nmc._union_tiles
    layout: col_idx [nB, K] int32, J_tiles [nB, K, B, B]).

    `max_degree` (default 16) bounds the one-hot plane count; a denser
    instance raises ValueError — callers fall back to the sparse path.
    `degree` forces the plane count (for stacking instances of different
    max degree in one batched engine).
    """
    col_idx = np.asarray(col_idx)
    J_tiles = np.asarray(J_tiles)
    nB, K, B, _ = J_tiles.shape
    n_pad = nB * B
    adj = J_tiles != 0                                   # [nB, K, B, B]
    deg = adj.sum(axis=(1, 3))                           # [nB, B]
    D = int(deg.max()) if deg.size else 0
    cap = 16 if max_degree is None else int(max_degree)
    if D > cap:
        raise ValueError(
            f"max node degree {D} exceeds the neighbor-plane cap {cap}; "
            f"use the sparse Houdayer path for dense instances")
    if degree is not None:
        if degree < D:
            raise ValueError(f"degree={degree} < instance max degree {D}")
        D = int(degree)
    D = max(D, 1)

    gather = np.zeros((nB, K, nB), np.float32)
    gather[np.arange(nB)[:, None], np.arange(K)[None, :], col_idx] = 1.0

    planes = np.zeros((nB, D, B, K * B + 1), np.float32)
    planes[:, :, :, K * B] = 1.0          # default: sentinel (big) column
    for i in range(nB):
        for r in range(B):
            ks, cs = np.nonzero(adj[i, :, r, :])
            for d, (k, c) in enumerate(zip(ks, cs)):
                planes[i, d, r, K * B] = 0.0
                planes[i, d, r, k * B + c] = 1.0
    return NeighborPlanes(gather.astype(np.float32),
                          planes.astype(jnp.bfloat16), n_pad, B)


def disagreement_labels_matmul(
    planes: NeighborPlanes, s1: jax.Array, s2: jax.Array,
    *, num_iters: Optional[int] = None,
) -> jax.Array:
    """Min-label propagation with every step expressed as two one-hot
    matmuls (gather of neighbor column blocks, then per-row neighbor
    selection) plus a D-way min — the matmul variant of
    disagreement_labels_sparse. Exact: identical fixed point (component-
    min labels), so _houdayer_from_labels draws the same move for the
    same key. Runs without pointer jumping — iterations are bounded by
    the component eccentricity, but each is far cheaper than a
    segment_min/gather step."""
    n = planes.n_pad
    B = planes.block_size
    nB = n // B
    K = (planes.planes.shape[3] - 1) // B
    if n > 65536:
        raise ValueError(f"hi/lo byte split supports n_pad <= 65536, "
                         f"got {n}")
    diff = (s1 * s2) < 0
    idx = jnp.arange(n, dtype=jnp.int32)
    labels0 = jnp.where(diff, idx, jnp.int32(n))
    G = jnp.asarray(planes.gather)
    P = jnp.asarray(planes.planes)
    big_hi = jnp.float32(n // 256)
    big_lo = jnp.float32(n % 256)

    def propagate(labels):
        lab2 = labels.reshape(nB, B)
        # exact hi/lo byte split: values in [0, 256], exact in bf16 and
        # TF32 at default precision (see NeighborPlanes docstring)
        hi = (lab2 // 256).astype(jnp.float32)
        lo = (lab2 % 256).astype(jnp.float32)
        ch = jnp.einsum("ikb,bc->ikc", G, hi)
        cl = jnp.einsum("ikb,bc->ikc", G, lo)
        eh = jnp.concatenate(
            [ch.reshape(nB, K * B), jnp.full((nB, 1), big_hi)], axis=1)
        el = jnp.concatenate(
            [cl.reshape(nB, K * B), jnp.full((nB, 1), big_lo)], axis=1)
        nh = jnp.einsum("idrq,iq->idr", P, eh,
                        preferred_element_type=jnp.float32)
        nl = jnp.einsum("idrq,iq->idr", P, el,
                        preferred_element_type=jnp.float32)
        nbr = nh * jnp.float32(256.0) + nl
        return jnp.min(nbr, axis=1).reshape(n).astype(jnp.int32)

    return _label_fixpoint(propagate, labels0, diff, n,
                           n if num_iters is None else num_iters,
                           jump=False)


def houdayer_move_matmul(planes, s1, s2, key, *,
                         num_iters: Optional[int] = None,
                         use_katzgraber: bool = True,
                         katzgraber_threshold: Optional[int] = None):
    """Houdayer move with the matmul label propagation — same move
    semantics (and, for the same key, the same draw) as
    houdayer_move_sparse. The fast path for the batched ICM engines on
    bounded-degree topologies (chimera/DCL); dense instances (wishart)
    stay on the sparse path via the build_neighbor_planes degree cap."""
    labels = disagreement_labels_matmul(planes, s1, s2,
                                        num_iters=num_iters)
    return _houdayer_from_labels(labels, s1, s2, key,
                                 use_katzgraber=use_katzgraber,
                                 katzgraber_threshold=katzgraber_threshold)


def houdayer_move_device(J, s1, s2, key, *, num_iters: Optional[int] = None,
                         use_katzgraber: bool = True,
                         katzgraber_threshold: Optional[int] = None):
    """One Houdayer move fully on device (jittable, vmappable over pairs).

    Finds disagreement components with min-label propagation, picks one
    cluster UNIFORMLY (the labels are component-min spin indices, so a
    random priority per index + argmin over component roots is uniform,
    matching the reference's random.choice over the cluster list,
    /root/reference/NPT/apt_ICM.py:233), exchanges it between partners —
    or flips all of s1 when the cluster exceeds N//2 spins (Katzgraber,
    apt_ICM.py:236-240). Exact: labels run to their fixed point.

    Returns (s1', s2', moved: bool, flipped: bool).
    """
    labels = disagreement_labels_device(J, s1, s2, num_iters=num_iters)
    return _houdayer_from_labels(labels, s1, s2, key,
                                 use_katzgraber=use_katzgraber,
                                 katzgraber_threshold=katzgraber_threshold)


def houdayer_move_sparse(src, dst, s1, s2, key, *,
                         num_iters: Optional[int] = None,
                         use_katzgraber: bool = True,
                         katzgraber_threshold: Optional[int] = None):
    """Houdayer move over an edge list (O(nnz) label propagation) — the
    large-N device path; same move semantics as houdayer_move_device."""
    labels = disagreement_labels_sparse(src, dst, s1, s2,
                                        num_nodes=s1.shape[0],
                                        num_iters=num_iters)
    return _houdayer_from_labels(labels, s1, s2, key,
                                 use_katzgraber=use_katzgraber,
                                 katzgraber_threshold=katzgraber_threshold)


def _houdayer_from_labels(labels, s1, s2, key, *, use_katzgraber: bool,
                          katzgraber_threshold: Optional[int]):
    n = s1.shape[0]
    any_diff = jnp.any(labels < n)
    is_root = labels == jnp.arange(n)          # component representatives
    g = jax.random.uniform(key, (n,))
    scores = jnp.where(is_root & (labels < n), g, jnp.inf)
    chosen = jnp.argmin(scores)                 # uniform over clusters
    in_cluster = labels == chosen
    size = jnp.sum(in_cluster)
    thresh = n // 2 if katzgraber_threshold is None else katzgraber_threshold
    big = use_katzgraber & (size > thresh)

    s1_swap = jnp.where(in_cluster, s2, s1)
    s2_swap = jnp.where(in_cluster, s1, s2)
    s1_new = jnp.where(any_diff, jnp.where(big, -s1, s1_swap), s1)
    s2_new = jnp.where(any_diff, jnp.where(big, s2, s2_swap), s2)
    moved = any_diff & ~big
    flipped = any_diff & big
    return s1_new, s2_new, moved, flipped
