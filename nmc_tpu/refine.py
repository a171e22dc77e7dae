"""Deterministic post-search refinement tiers as a product component.

The induced-tree large-neighborhood descent (`tree_moves.tree_refine` —
Selby-style exact conditional optimization over maximal induced cell
trees, reference topology: the chimera/DCL grids under
/root/reference/NMC/examples/) converts near-miss states produced by
the beam tier (`beam_chimera_device`) or a campaign arm into exact
ground-state hits. This module packages it behind three surfaces:

* `tree_refine_state`  — one instance, one state (used by
  `portfolio_solve`'s `tree` stage and the CLI single-instance path);
* `refine_family`      — a benchmark family's remaining misses from the
  saved state pools (used by `python -m nmc_tpu refine`,
  `campaign --refine tree`, and scripts/run_tree_refine.py);
* row artifacts `results/tree_refine_<family>*.jsonl`, counted as the
  `tree` tier by scripts/coverage_report.py.

Descent moves are monotone and every accepted move is the exact
conditional ground state of the induced tree (~half the lattice), so a
"hit" here is as deterministic as the beam tier's: exact integer
arithmetic on the 1/q-snapped couplings, no sampling involved. The
iterated-local-search loop adds 2x2-cell-block kicks — the cycle shape
no induced tree can contain — and is the stochastic escape for states
whose residual droplet wraps a cell cycle.
"""
import json
import os
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["tree_refine_state", "refine_family", "grid_family_folders",
           "partition_crossover"]


def partition_crossover(prob, s_a, s_b):
    """Exact best recombination of two states (partition crossover).

    The disagreement set D = {i : s_a[i] != s_b[i]} splits into
    connected components of the J-subgraph induced on D. Any J edge
    whose endpoints BOTH disagree lies inside one component by
    construction, so no edge joins two distinct components and the
    energy is exactly separable across the per-component choice of
    parent. The returned offspring takes, per component, whichever
    parent is lower — the optimum of all 2^k recombinations, computed
    in O(n + nnz). Offspring energy <= min(E(s_a), E(s_b)) always.

    This is the deterministic, exactly-optimal counterpart of the
    Houdayer exchange move (`ops/clusters.py`): where ICM flips ONE
    disagreement cluster stochastically, this flips the optimal subset
    of all of them. Used to compose the beam tier's state with a
    campaign arm's best state per instance (reference truths:
    Chimera_droplet_instances/*/groundstates_otn2d.txt).

    Returns (energy_raw, offspring_state, n_components_taken).
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    a = np.where(np.asarray(s_a, np.float64).reshape(-1) >= 0, 1.0, -1.0)
    b = np.where(np.asarray(s_b, np.float64).reshape(-1) >= 0, 1.0, -1.0)
    d = a != b
    if not d.any():
        return float(prob.energy(a)), a, 0

    # label disagreement components (union-find over edges inside D)
    idx = np.flatnonzero(d)
    pos = -np.ones(a.size, np.int64)
    pos[idx] = np.arange(idx.size)
    parent = np.arange(idx.size)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ii, jj = np.nonzero(J[np.ix_(idx, idx)])
    for u, v in zip(ii, jj):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    labels = np.fromiter((find(k) for k in range(idx.size)), np.int64,
                         idx.size)

    # dE of flipping component C in a: 2 sum_{i in C} a_i phi_i
    #                                  - 2 sum_{i,j in C} J_ij a_i a_j
    phi = J @ a + h
    off = a.copy()
    taken = 0
    for lab in np.unique(labels):
        comp = idx[labels == lab]
        lin = 2.0 * float(np.sum(a[comp] * phi[comp]))
        quad = 2.0 * float(a[comp] @ J[np.ix_(comp, comp)] @ a[comp])
        if lin - quad < 0.0:
            off[comp] = b[comp]
            taken += 1
    return float(prob.energy(off)), off, taken


def grid_family_folders() -> Dict[str, str]:
    """The shipped grid-topology families the tree tier applies to."""
    from .campaign import FAMILIES
    return {fam: spec["folder"] for fam, spec in FAMILIES.items()
            if spec.get("kind") in ("chimera", "dcl")}


def _int_energy(Jq, hq, s) -> int:
    si = np.where(np.asarray(s) >= 0, 1, -1).astype(np.int64)
    return int(-(si @ Jq @ si) // 2 - hq @ si)


def tree_refine_state(prob, s0, *, target_raw: Optional[float] = None,
                      target_int: Optional[int] = None,
                      ils_seconds: float = 0.0, seed: int = 0,
                      extra_random: int = 24,
                      deadline: Optional[float] = None):
    """Induced-tree descent (+ optional ILS) from state `s0`.

    `prob` must be a chimera/DCL-grid instance (raises ValueError via
    `pad_to_chimera_grid` otherwise). Returns `(energy_raw, state,
    info)` where `state` has `prob.n` entries (padding stripped) and
    `info` records the exact integer energies, move/kick counts and the
    hit flag (None when no target was given). Descent is exact integer
    arithmetic on the 1/q-snapped couplings; `target_raw` is snapped to
    the same grid, so hit determination has no float fuzz.
    """
    from .beam_chimera import pad_to_chimera_grid
    from .beam_chimera_device import quantize_problem
    from .tree_moves import chimera_layout, tree_refine

    solve_prob, rows, cols, n_orig = pad_to_chimera_grid(prob)
    Jq, hq, q = quantize_problem(solve_prob)
    rows, cols = chimera_layout(np.asarray(solve_prob.J, np.float64),
                                rows, cols)
    s0_full = np.ones(solve_prob.n)
    s0 = np.asarray(s0, np.float64).reshape(-1)
    if s0.size not in (n_orig, solve_prob.n):
        raise ValueError(f"state has {s0.size} spins, instance has "
                         f"{n_orig} (padded {solve_prob.n})")
    s0_full[:s0.size] = np.where(s0 >= 0, 1.0, -1.0)

    if target_int is None and target_raw is not None:
        target_int = int(round(float(target_raw) * q))
    stop = (target_int / q) + 0.5 / q if target_int is not None else None

    e0_int = _int_energy(Jq, hq, s0_full)
    t0 = time.perf_counter()
    _, s, moves = tree_refine(solve_prob, s0_full, rows=rows, cols=cols,
                              stop_at=stop, seed=seed,
                              extra_random=extra_random)
    e_int = _int_energy(Jq, hq, s)

    ils_iters = 0
    if ils_seconds > 0 and target_int is not None and e_int > target_int:
        rng = np.random.default_rng(seed + 1)
        best_e, best_s = e_int, s.copy()
        t_ils = time.perf_counter()
        while (time.perf_counter() - t_ils < ils_seconds
               and best_e > target_int):
            if deadline is not None and time.time() > deadline:
                break
            ils_iters += 1
            sk = best_s.copy()
            r0 = int(rng.integers(max(rows - 1, 1)))
            c0 = int(rng.integers(max(cols - 1, 1)))
            for (r, c) in ((r0, c0), (r0 + 1, c0),
                           (r0, c0 + 1), (r0 + 1, c0 + 1)):
                b = (r * cols + c) * 8
                sk[b:b + 8] *= -1
            sk[rng.random(solve_prob.n) < 0.02] *= -1
            _, sk, _ = tree_refine(solve_prob, sk, rows=rows, cols=cols,
                                   stop_at=stop,
                                   seed=int(rng.integers(1 << 30)),
                                   extra_random=8, max_rounds=50)
            ek = _int_energy(Jq, hq, sk)
            if ek < best_e:
                best_e, best_s = ek, sk.copy()
                moves += 1
        e_int, s = best_e, best_s

    state = np.where(s[:n_orig] >= 0, 1.0, -1.0)
    e_raw = float(prob.energy(state[:prob.n]))
    info = dict(e_int_start=e0_int, e_int=e_int, q=q,
                target_int=target_int,
                hit=(None if target_int is None
                     else bool(e_int <= target_int)),
                moves=moves, ils_iters=ils_iters,
                seconds=round(time.perf_counter() - t0, 2))
    return e_raw, state[:prob.n], info


def _family_instances(family: str, folder: str):
    from .evaluation import chimera_folder_instances, dcl_folder_instances
    from .io.loaders import read_otn2d_groundstates
    if family.startswith("dcl"):
        return dcl_folder_instances(folder), {}
    gs_path = os.path.join(folder, "groundstates_otn2d.txt")
    truths = (read_otn2d_groundstates(gs_path)
              if os.path.exists(gs_path) else {})
    return chimera_folder_instances(folder), truths


def refine_family(family: str, *, only: Optional[Iterable[str]] = None,
                  skip_covered: bool = True, ils_seconds: float = 0.0,
                  extra_random: int = 24,
                  deadline: Optional[float] = None,
                  state_dirs: Optional[Sequence[str]] = None,
                  out: Optional[str] = None,
                  write_states: bool = True) -> Tuple[int, int]:
    """Run the tree tier over a family's remaining misses.

    For each instance not yet covered by any tier (unless
    `skip_covered=False`), loads the lowest-integer-energy saved state
    from `state_dirs` (default: the beam pool
    `results/beam_states/<family>` and the campaign best-state pool
    `results/best_states/<family>`), refines it, appends a row to
    `out` (default `results/tree_refine_<family>.jsonl`), and writes
    strictly-improved states back to the beam pool (tmp+rename) so
    every later seeded run starts lower. Returns (hits, attempted).
    """
    folders = grid_family_folders()
    if family not in folders:
        raise ValueError(f"unknown grid family {family!r}; "
                         f"choose from {sorted(folders)}")
    folder = folders[family]
    out = out or f"results/tree_refine_{family}.jsonl"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    done = set()
    if os.path.exists(out):
        with open(out) as f:
            done = {json.loads(line)["name"] for line in f if line.strip()}
    covered = set()
    if skip_covered:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "coverage_report", os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "scripts", "coverage_report.py"))
        if spec is not None and os.path.exists(spec.origin):
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            tiers = mod.scan_family(family)
            covered = set().union(*tiers.values()) if tiers else set()

    from .beam_chimera import pad_to_chimera_grid
    from .beam_chimera_device import quantize_problem

    only = set(only) if only is not None else None
    bdir = f"results/beam_states/{family}"
    cdir = f"results/best_states/{family}"
    state_dirs = list(state_dirs) if state_dirs else [bdir, cdir]

    it, truth_states = _family_instances(family, folder)
    hits = total = 0
    for name, prob, gs in it:
        if name in done or name in covered:
            continue
        if only is not None and name not in only:
            continue
        if deadline is not None and time.time() > deadline:
            print("DEADLINE reached, stopping cleanly", flush=True)
            break
        solve_prob, rows, cols, n_orig = pad_to_chimera_grid(prob)
        Jq, hq, q = quantize_problem(solve_prob)

        cands = []
        for d in state_dirs:
            p = os.path.join(d, name)
            if os.path.exists(p):
                s = np.ones(solve_prob.n)
                s[:n_orig] = np.sign(np.loadtxt(p).reshape(-1))
                cands.append((_int_energy(Jq, hq, s), s))
        if not cands:
            continue
        e0, s0 = min(cands, key=lambda t: t[0])

        target_int = None
        truth_spins = (truth_states[name][1] if name in truth_states
                       else np.zeros(0))
        if truth_spins.size == n_orig:
            st = np.ones(solve_prob.n, np.int64)
            st[:n_orig] = truth_spins
            target_int = _int_energy(Jq, hq, st)
        elif gs is not None:
            target_int = int(round(gs * q))

        _, state, info = tree_refine_state(
            prob, s0[:n_orig], target_int=target_int,
            ils_seconds=ils_seconds, seed=0, extra_random=extra_random,
            deadline=deadline)
        total += 1
        hits += bool(info["hit"])
        if write_states and info["e_int"] < e0:
            os.makedirs(bdir, exist_ok=True)
            tmp = os.path.join(bdir, name + ".tmp")
            np.savetxt(tmp, np.where(state >= 0, 1, -1).astype(np.int8),
                       fmt="%d")
            os.replace(tmp, os.path.join(bdir, name))
        rec = {"name": name, "family": family, "gs": gs,
               "stage": "tree_refine", **info}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"{name}: e_int={info['e_int']} (start {e0}) "
              f"target={target_int} hit={info['hit']} "
              f"moves={info['moves']} ils={info['ils_iters']} "
              f"({info['seconds']:.0f}s)", flush=True)
    print(f"SUMMARY {family} tree_refine: {hits}/{total} converted")
    return hits, total
