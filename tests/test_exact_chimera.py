"""Exact chimera DP (tropical transfer contraction): layout validation,
parity with the generic exact tiers on synthetic chimeras, and
re-derivation of a shipped tnac4o ground truth (the reference ships the
truths but no solver — groundstates_otn2d.txt is an external artifact;
nmc_tpu/exact_chimera.py makes the chimera128 family independently
checkable)."""

import os

import numpy as np
import pytest

CHIMERA128 = ("/root/reference/NMC/examples/Chimera_droplet_instances/"
              "chimera128_spinglass_power")


def synth_chimera(rows, cols, seed, fields=True):
    from nmc_tpu import IsingProblem
    rng = np.random.default_rng(seed)
    n = rows * cols * 8
    J = np.zeros((n, n))

    def base(r, c):
        return (r * cols + c) * 8

    for r in range(rows):
        for c in range(cols):
            b = base(r, c)
            J[b:b + 4, b + 4:b + 8] = rng.normal(size=(4, 4))
            if c + 1 < cols:
                nb = base(r, c + 1)
                J[b + 4:b + 8, nb + 4:nb + 8] += np.diag(rng.normal(size=4))
            if r + 1 < rows:
                nb = base(r + 1, c)
                J[b:b + 4, nb:nb + 4] += np.diag(rng.normal(size=4))
    h = rng.normal(size=n) if fields else np.zeros(n)
    return IsingProblem(J + J.T, h)


@pytest.mark.parametrize("rows,cols", [(1, 2), (2, 1), (2, 2), (1, 3)])
def test_dp_matches_mitm_host(rows, cols):
    """Parity with the meet-in-the-middle host tier on small chimeras
    (2x2 = 32 spins is the largest n the host tier reaches quickly)."""
    from nmc_tpu.exact import solve_exact_host
    from nmc_tpu.exact_chimera import solve_exact_chimera

    prob = synth_chimera(rows, cols, seed=rows * 10 + cols)
    e_dp, s_dp = solve_exact_chimera(prob, rows=rows, cols=cols)
    if prob.n <= 24:
        e_ref, _ = solve_exact_host(prob, block=1 << 14)
        assert abs(e_dp - e_ref) < 1e-9
    assert abs(float(prob.energy(s_dp)) - e_dp) < 1e-9


def test_dp_transpose_consistency():
    """4x4 (128 spins): solving the TRANSPOSED chimera (rows<->cols,
    V<->H sides swapped by index remap) contracts the graph in a
    different order — the minima must agree to fp precision, and both
    backtracked states must evaluate to them. A wrong boundary-retire
    step cannot survive both orders."""
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact_chimera import solve_exact_chimera

    prob = synth_chimera(4, 3, seed=11)
    rows, cols = 4, 3

    def remap(i):
        cell, k = i // 8, i % 8
        r, c = cell // cols, cell % cols
        return (c * rows + r) * 8 + (k + 4) % 8

    n = prob.n
    perm = np.array([remap(i) for i in range(n)])
    Jt = np.zeros_like(prob.J)
    Jt[np.ix_(perm, perm)] = prob.J
    ht = np.zeros_like(prob.h)
    ht[perm] = prob.h
    probt = IsingProblem(Jt, ht)

    e1, s1 = solve_exact_chimera(prob, rows=rows, cols=cols)
    e2, s2 = solve_exact_chimera(probt, rows=cols, cols=rows)
    assert abs(e1 - e2) < 1e-9
    assert abs(float(prob.energy(s1)) - e1) < 1e-9
    assert abs(float(probt.energy(s2)) - e2) < 1e-9


def test_layout_rejects_non_chimera(rng):
    from nmc_tpu.exact_chimera import chimera_layout

    J = rng.normal(size=(32, 32))
    J = 0.5 * (J + J.T)
    np.fill_diagonal(J, 0.0)
    with pytest.raises(ValueError):
        chimera_layout(J)
    with pytest.raises(ValueError):
        chimera_layout(np.zeros((12, 12)))          # n not divisible by 8


def test_shipped_chimera128_truth_rederived():
    """Re-derive a shipped tnac4o ground truth from scratch; the state's
    energy must reproduce groundstates_otn2d.txt's value to its print
    precision."""
    if not os.path.exists(CHIMERA128):
        pytest.skip("reference checkout not available")
    from nmc_tpu.evaluation import chimera_folder_instances
    from nmc_tpu.exact_chimera import solve_exact_chimera

    name, prob, gs = next(iter(chimera_folder_instances(CHIMERA128,
                                                        limit=1)))
    e, s = solve_exact_chimera(prob)
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert abs(e - gs) <= 2e-6 * abs(gs)
