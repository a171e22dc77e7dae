"""Induced-tree large-neighborhood descent for chimera graphs.

Monotone descent where each move jointly re-optimizes an *induced tree
of unit cells* — roughly half the lattice — EXACTLY by min-sum dynamic
programming over 256 states per cell, conditioned on the frozen
complement. This is the Hamze–de Freitas / Selby move class, the
strongest known classical local search on chimera topologies.

Why it exists here: `beam_chimera.refine_strips` conditions on
everything outside a contiguous *column band*, so a residual droplet
that snakes across rows and columns survives it in both orientations —
the round-4 window-10 pass found ZERO improving moves on every
1-2-quantum chimera2048 beam miss
(results/beam_device_chimera2048_brw10.jsonl). An induced CELL TREE has no
such shape constraint: comb-shaped trees (spine row + alternating-column
teeth, 8 symmetry variants) plus randomized maximal induced trees cover
droplets of any geometry with positive probability per round, and every
accepted move is an exact conditional optimum, so the descent is
monotone and (for fixed variants) deterministic.

Topology/index conventions follow `exact_chimera.chimera_layout`
(validated there): cell (r, c) occupies spins [(r*cols+c)*8, +8); the
first 4 spins are the V side (vertical inter-cell edges, equal k), the
last 4 the H side (horizontal edges); intra-cell couplings are the
K4,4 block between the sides. Reference instances this targets ship at
/root/reference/NMC/examples/Chimera_droplet_instances/ (truths in
groundstates_otn2d.txt, e.g. chimera2048_spinglass_power) and
/root/reference/NMC/examples/DCL_instances/ (same raster, padded by
`beam_chimera.pad_to_chimera_grid`).
"""
from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np

from .exact_chimera import _S16, chimera_layout

__all__ = ["comb_cells", "random_induced_tree", "tree_refine"]

def comb_cells(rows: int, cols: int, variant: int) -> Set[Tuple[int, int]]:
    """Comb-shaped maximal induced cell tree, 8 symmetry variants.

    variant bits: 0 = transpose (spine along a column instead of a
    row), 1 = spine at the far edge, 2 = teeth parity. A comb is an
    induced tree: spine cells are consecutive (tree edges), teeth hang
    off the spine every other line (tree edges), and teeth are two
    apart so no non-tree adjacency exists inside the set.
    """
    t = variant & 1
    far = (variant >> 1) & 1
    parity = (variant >> 2) & 1
    R, C = (cols, rows) if t else (rows, cols)
    spine = R - 1 if far else 0
    cells = {(spine, c) for c in range(C)}
    for c in range(parity, C, 2):
        for r in range(R):
            cells.add((r, c))
    if t:
        cells = {(c, r) for (r, c) in cells}
    return cells


def random_induced_tree(rows: int, cols: int,
                        rng: np.random.Generator) -> Set[Tuple[int, int]]:
    """Randomized greedy maximal induced tree of the cell grid.

    Grow from a random cell, repeatedly adding a random cell adjacent
    to EXACTLY one tree cell — each addition keeps the set both induced
    and acyclic; cells that become adjacent to two tree cells are
    excluded permanently (the set only grows). Complements the combs
    with irregular (diagonal/spiral) shapes.
    """
    def nbrs(r, c):
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rr, cc = r + dr, c + dc
            if 0 <= rr < rows and 0 <= cc < cols:
                yield rr, cc

    start = (int(rng.integers(rows)), int(rng.integers(cols)))
    S = {start}
    deg = np.zeros((rows, cols), np.int8)   # S-adjacency count per cell
    for rr, cc in nbrs(*start):
        deg[rr, cc] = 1
    cand = {(rr, cc) for rr, cc in nbrs(*start)}
    while cand:
        r, c = sorted(cand)[int(rng.integers(len(cand)))]
        cand.discard((r, c))
        if deg[r, c] != 1:
            continue
        S.add((r, c))
        for rr, cc in nbrs(r, c):
            deg[rr, cc] += 1
            if (rr, cc) not in S and deg[rr, cc] == 1:
                cand.add((rr, cc))
        cand = {x for x in cand if deg[x] == 1}
    return S


def _dp_pass(J, h, s, rows, cols, cells):
    """One exact conditional optimization of the induced cell tree.

    Returns a new full state equal to `s` outside `cells` and set to
    the exact min-energy configuration of the tree given that frozen
    complement. Min-sum DP: per-cell state is (V-nibble, H-nibble);
    tree edges carry 16x16 coupling tables on the side they join.
    """
    W = cols

    def base(r, c):
        return (r * W + c) * 8

    in_S = set(cells)
    order = sorted(in_S)
    idx = {rc: i for i, rc in enumerate(order)}
    n_cells = len(order)

    # tree structure: every grid adjacency inside S is a tree edge
    children = [[] for _ in range(n_cells)]
    parent = np.full(n_cells, -1, np.int64)
    root = 0
    seen = {order[0]}
    stack = [order[0]]
    while stack:
        r, c = stack.pop()
        i = idx[(r, c)]
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rc2 = (r + dr, c + dc)
            if rc2 in in_S and rc2 not in seen:
                seen.add(rc2)
                j = idx[rc2]
                parent[j] = i
                children[i].append(j)
                stack.append(rc2)
    if len(seen) != n_cells:
        raise ValueError("cell set is not connected")

    # per-cell belief tables B[i] : [16 V, 16 H]
    B = np.empty((n_cells, 16, 16))
    for (r, c) in order:
        b = base(r, c)
        i = idx[(r, c)]
        Jvh = J[b:b + 4, b + 4:b + 8]
        E = -(_S16 @ Jvh @ _S16.T)
        extV = h[b:b + 4].copy()
        extH = h[b + 4:b + 8].copy()
        # frozen inter-cell neighbors act as linear fields on one side
        if r > 0 and (r - 1, c) not in in_S:
            ju = np.diag(J[base(r - 1, c):base(r - 1, c) + 4, b:b + 4])
            extV += ju * s[base(r - 1, c):base(r - 1, c) + 4]
        if r < rows - 1 and (r + 1, c) not in in_S:
            jd = np.diag(J[b:b + 4, base(r + 1, c):base(r + 1, c) + 4])
            extV += jd * s[base(r + 1, c):base(r + 1, c) + 4]
        if c > 0 and (r, c - 1) not in in_S:
            jl = np.diag(J[base(r, c - 1) + 4:base(r, c - 1) + 8,
                           b + 4:b + 8])
            extH += jl * s[base(r, c - 1) + 4:base(r, c - 1) + 8]
        if c < cols - 1 and (r, c + 1) not in in_S:
            jr = np.diag(J[b + 4:b + 8,
                           base(r, c + 1) + 4:base(r, c + 1) + 8])
            extH += jr * s[base(r, c + 1) + 4:base(r, c + 1) + 8]
        E = E - (_S16 @ extV)[:, None] - (_S16 @ extH)[None, :]
        B[i] = E

    # bottom-up min-sum with argmin backtrack
    post = []                      # post-order (children before parents)
    stack = [root]
    visit = [root]
    while visit:
        i = visit.pop()
        post.append(i)
        visit.extend(children[i])
    post = post[::-1]

    # backtrack stores per (child) the chosen own-nibble given the
    # parent's nibble on the joining side, and the other-side argmin
    amin_own = [None] * n_cells    # [16 parent nibble] -> child nibble
    amin_other = [None] * n_cells  # [16 own nibble] -> other nibble
    edge_vert = np.zeros(n_cells, bool)
    for i in post:
        p = parent[i]
        if p < 0:
            continue
        (r, c) = order[i]
        (pr, pc) = order[p]
        if pr != r:                       # vertical edge: V sides join
            up, dn = ((p, i) if pr < r else (i, p))
            (ur, uc) = order[up]
            bu, bd = base(ur, uc), base(*order[dn])
            ju = np.diag(J[bu:bu + 4, bd:bd + 4])
            U = -(_S16 * ju) @ _S16.T     # [upV, downV]
            T = B[i].min(axis=1)          # over H -> [16 V]
            amin_other[i] = B[i].argmin(axis=1)
            # message to parent indexed by PARENT's V nibble
            M = (U + T[None, :]) if pr < r else (U.T + T[None, :])
            # row index = parent nibble, col = child nibble
            amin_own[i] = M.argmin(axis=1)
            B[p] += M.min(axis=1)[:, None]
            edge_vert[i] = True
        else:                             # horizontal edge: H sides join
            lf, rt = ((p, i) if pc < c else (i, p))
            bl, br = base(*order[lf]), base(*order[rt])
            jg = np.diag(J[bl + 4:bl + 8, br + 4:br + 8])
            G = -(_S16 * jg) @ _S16.T     # [leftH, rightH]
            T = B[i].min(axis=0)          # over V -> [16 H]
            amin_other[i] = B[i].argmin(axis=0)
            M = (G + T[None, :]) if pc < c else (G.T + T[None, :])
            amin_own[i] = M.argmin(axis=1)
            B[p] += M.min(axis=1)[None, :]
            edge_vert[i] = False

    # top-down assignment
    s_new = np.array(s, np.float64, copy=True)
    vh = np.empty((n_cells, 2), np.int64)
    iv, ih = np.unravel_index(int(B[root].argmin()), (16, 16))
    vh[root] = (iv, ih)
    pre = [root]
    while pre:
        p = pre.pop()
        for i in children[p]:
            if edge_vert[i]:
                own = int(amin_own[i][vh[p][0]])   # child V nibble
                other = int(amin_other[i][own])    # child H nibble
                vh[i] = (own, other)
            else:
                own = int(amin_own[i][vh[p][1]])   # child H nibble
                other = int(amin_other[i][own])    # child V nibble
                vh[i] = (other, own)
            pre.append(i)
    for (r, c) in order:
        i = idx[(r, c)]
        b = base(r, c)
        s_new[b:b + 4] = _S16[vh[i][0]]
        s_new[b + 4:b + 8] = _S16[vh[i][1]]
    return s_new


def tree_refine(prob, s, rows: Optional[int] = None,
                cols: Optional[int] = None, max_rounds: int = 200,
                extra_random: int = 24, stop_at: Optional[float] = None,
                seed: int = 0):
    """Monotone induced-tree descent from state `s`.

    Each round applies the 8 comb variants plus `extra_random`
    randomized maximal induced trees; every accepted move is the exact
    conditional optimum of ~half the lattice. Stops when a full round
    improves nothing, `max_rounds` elapse, or the energy reaches
    `stop_at`. Returns (energy, state, n_moves). Deterministic for a
    fixed seed.
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    rows, cols = chimera_layout(J, rows, cols)
    rng = np.random.default_rng(seed)
    s = np.where(np.asarray(s, np.float64) >= 0, 1.0, -1.0)
    e = float(prob.energy(s))
    n_moves = 0
    for _ in range(max_rounds):
        e_before = e
        sets = [comb_cells(rows, cols, v) for v in range(8)]
        sets += [random_induced_tree(rows, cols, rng)
                 for _ in range(extra_random)]
        for S in sets:
            s2 = _dp_pass(J, h, s, rows, cols, S)
            e2 = float(prob.energy(s2))
            if e2 < e - 1e-9:
                s, e = s2, e2
                n_moves += 1
            if stop_at is not None and e <= stop_at:
                return e, s, n_moves
        if e >= e_before - 1e-9:
            break
    return e, s, n_moves
