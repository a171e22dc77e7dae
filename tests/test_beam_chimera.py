"""Beam boundary-DP chimera solver: exactness when the beam never
overflows, dominance-dedup validity at small beams, and orientation
remapping correctness. The large-family hit-rate evidence lives in
results/beam_*.jsonl (scripts/run_beam_chimera.py)."""

import os

import numpy as np
import pytest

from test_exact_chimera import synth_chimera

CHIMERA128 = ("/root/reference/NMC/examples/Chimera_droplet_instances/"
              "chimera128_spinglass_power")


@pytest.mark.parametrize("rows,cols", [(2, 2), (3, 2), (2, 3)])
def test_beam_exact_when_unpruned(rows, cols):
    """A beam wide enough to never prune is provably exact and must
    reproduce the dense DP's optimum."""
    from nmc_tpu.beam_chimera import solve_beam_chimera
    from nmc_tpu.exact_chimera import solve_exact_chimera

    prob = synth_chimera(rows, cols, seed=rows * 7 + cols)
    e_ref, _ = solve_exact_chimera(prob, rows=rows, cols=cols)
    cap = 16 ** (cols + 1)
    e, s, info = solve_beam_chimera(prob, rows=rows, cols=cols,
                                    beam=cap, expand_top=cap * 256)
    assert info["exact"]
    assert abs(e - e_ref) < 1e-9
    assert abs(float(prob.energy(s)) - e) < 1e-9


def test_beam_small_is_valid_upper_bound():
    """A tiny beam must still return a self-consistent state bounded
    below by the true optimum."""
    from nmc_tpu.beam_chimera import solve_beam_chimera
    from nmc_tpu.exact_chimera import solve_exact_chimera

    prob = synth_chimera(3, 3, seed=5)
    e_ref, _ = solve_exact_chimera(prob)
    e, s, info = solve_beam_chimera(prob, beam=64)
    assert not info["exact"]
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert e >= e_ref - 1e-9


def test_pad_partial_raster():
    """A chimera raster with the last cell(s) missing (the DCL shape)
    pads to the full rectangle without changing the optimum."""
    from nmc_tpu import IsingProblem
    from nmc_tpu.beam_chimera import (pad_to_chimera_grid,
                                      solve_beam_chimera)
    from nmc_tpu.exact_chimera import solve_exact_chimera

    full = synth_chimera(2, 3, seed=3)
    n = full.n - 8
    part = IsingProblem(np.asarray(full.J)[:n, :n].copy(),
                        np.asarray(full.h)[:n].copy())
    padded, rows, cols, n_orig = pad_to_chimera_grid(part)
    assert (rows, cols, n_orig) == (2, 3, n)
    e_ref, _ = solve_exact_chimera(padded, rows=rows, cols=cols)
    e, s, _ = solve_beam_chimera(padded, rows=rows, cols=cols, beam=4096,
                                 expand_top=4096 * 256)
    assert abs(e - e_ref) < 1e-9
    assert abs(float(part.energy(s[:n])) - e) < 1e-9


def test_refine_strips_reaches_exact():
    """Exact strip descent from a random state reaches the true optimum
    on a 4x4 synthetic (window-3 moves jointly optimize 96 spins)."""
    from nmc_tpu.beam_chimera import refine_strips
    from nmc_tpu.exact_chimera import solve_exact_chimera

    prob = synth_chimera(4, 4, seed=2)
    e_ref, _ = solve_exact_chimera(prob)
    rng = np.random.default_rng(0)
    e, s, n_moves = refine_strips(prob, np.sign(rng.standard_normal(prob.n)),
                                  window=3)
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert e <= e_ref + 1e-9
    assert n_moves >= 1


def test_refine_strips_fixed_point_at_optimum():
    from nmc_tpu.beam_chimera import refine_strips
    from nmc_tpu.exact_chimera import solve_exact_chimera

    prob = synth_chimera(3, 3, seed=8)
    e_ref, s_ref = solve_exact_chimera(prob)
    e, s, n_moves = refine_strips(prob, s_ref, window=3)
    assert n_moves == 0 and abs(e - e_ref) < 1e-9


def test_device_beam_parity_int_dp():
    """The jitted int32 device beam (CPU backend here; same program on
    the device) matches the dense exact DP on a rational-coupling chimera."""
    from nmc_tpu import IsingProblem
    from nmc_tpu.beam_chimera_device import (quantize_problem,
                                          solve_beam_chimera_device)
    from nmc_tpu.exact_chimera import solve_exact_chimera

    p0 = synth_chimera(3, 2, seed=4)
    prob = IsingProblem(np.round(np.asarray(p0.J) * 4) / 8,
                        np.round(np.asarray(p0.h) * 4) / 8)
    _, _, q = quantize_problem(prob)
    assert q == 8
    e_ref, _ = solve_exact_chimera(prob, rows=3, cols=2)
    e, s, info = solve_beam_chimera_device(prob, rows=3, cols=2, beam=4096)
    assert abs(e - e_ref) < 1e-9
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert info["e_int"] == int(round(e_ref * 8))


@pytest.mark.parametrize("split", [2, 4])
def test_device_beam_split_merge_matches_single_pass(split):
    """The two-pass sort-merge (split>1, the beam-2^17 path)
    keeps the same optimal energy and a valid state as the single-pass
    program, and still matches the dense exact DP when unpruned."""
    from nmc_tpu import IsingProblem
    from nmc_tpu.beam_chimera_device import solve_beam_chimera_device
    from nmc_tpu.exact_chimera import solve_exact_chimera

    p0 = synth_chimera(3, 2, seed=11)
    prob = IsingProblem(np.round(np.asarray(p0.J) * 4) / 8,
                        np.round(np.asarray(p0.h) * 4) / 8)
    e_ref, _ = solve_exact_chimera(prob, rows=3, cols=2)
    e1, s1, i1 = solve_beam_chimera_device(prob, rows=3, cols=2, beam=4096,
                                        split=1)
    e2, s2, i2 = solve_beam_chimera_device(prob, rows=3, cols=2, beam=4096,
                                        split=split)
    assert i1["split"] == 1 and i2["split"] == split
    assert abs(e1 - e_ref) < 1e-9 and abs(e2 - e_ref) < 1e-9
    assert i1["e_int"] == i2["e_int"]
    assert abs(float(prob.energy(s2)) - e2) < 1e-9


def test_device_beam_split_auto_policy():
    """split=None chunks so no sort exceeds 2^24 elements."""
    from nmc_tpu.beam_chimera_device import solve_beam_chimera_device
    from nmc_tpu import IsingProblem

    p0 = synth_chimera(2, 2, seed=12)
    prob = IsingProblem(np.round(np.asarray(p0.J) * 4) / 8,
                        np.round(np.asarray(p0.h) * 4) / 8)
    # tiny beams stay single-pass
    _, _, info = solve_beam_chimera_device(prob, rows=2, cols=2, beam=256)
    assert info["split"] == 1
    # the auto rule itself (no giant solve on CPU): 2^17*256 -> split 2
    M = 1 << 17
    split = 1
    while M * (256 // split) > (1 << 24):
        split *= 2
    assert split == 2
    M = 1 << 18
    split = 1
    while M * (256 // split) > (1 << 24):
        split *= 2
    assert split == 4


def test_device_beam_5decimal_print_rounding():
    """DCL files print k/7 couplings at FIVE decimals (0.14286), so the
    file-vs-snapped energy gap is ~2.9e-6/edge — larger than the
    6-decimal bound the verify assert originally assumed. The snapped
    problem is the TRUE instance; verify must accept the residual and
    the integer optimum must match the exact DP on the snapped problem."""
    from nmc_tpu import IsingProblem
    from nmc_tpu.beam_chimera_device import (quantize_problem,
                                          solve_beam_chimera_device)
    from nmc_tpu.exact_chimera import solve_exact_chimera

    p0 = synth_chimera(3, 2, seed=6)
    J7 = np.round(np.asarray(p0.J) * 3.5) / 7.0   # exact k/7 couplings
    h7 = np.round(np.asarray(p0.h) * 3.5) / 7.0
    prob = IsingProblem(np.round(J7, 5), np.round(h7, 5))  # file print
    Jq, hq, q = quantize_problem(prob)
    assert q == 7
    np.testing.assert_array_equal(Jq, np.round(J7 * 7))   # snap == truth
    e, s, info = solve_beam_chimera_device(prob, rows=3, cols=2, beam=4096)
    e_ref, _ = solve_exact_chimera(IsingProblem(J7, h7), rows=3, cols=2)
    assert info["e_int"] == int(round(e_ref * 7))
    assert abs(float(prob.energy(s)) - e) < 1e-9


def test_quantize_rejects_irrational():
    from nmc_tpu.beam_chimera_device import quantize_problem

    prob = synth_chimera(2, 2, seed=1)      # gaussian couplings
    with pytest.raises(ValueError):
        quantize_problem(prob, q_max=50)


@pytest.mark.skipif(not os.path.isdir(CHIMERA128),
                    reason="reference chimera128 not present")
def test_beam_cli(tmp_path):
    import json

    from nmc_tpu.cli import main

    inst = os.path.join(CHIMERA128, "001.txt")
    out = str(tmp_path / "beam.jsonl")
    state_f = str(tmp_path / "s.txt")
    rc = main(["beam", inst, "--beam", "8", "--no-refine",
               "--out", out, "--save-state", state_f])
    assert rc == 0
    rec = json.loads(open(out).readline())
    assert (rec["rows"], rec["cols"]) == (4, 4)
    assert rec["shipped_target"] == -210.933333
    assert rec["energy_raw"] >= rec["shipped_target"] - 1e-4
    s = np.loadtxt(state_f)
    assert s.shape == (128,) and set(np.unique(s)) <= {-1.0, 1.0}


def test_multi_orientation_remap():
    """Each orientation's returned state must evaluate to its reported
    energy in the ORIGINAL index space, and the best-of must be <= the
    identity orientation."""
    from nmc_tpu.beam_chimera import (solve_beam_chimera,
                                      solve_beam_chimera_multi)

    prob = synth_chimera(3, 2, seed=9)
    e_id, _, _ = solve_beam_chimera(prob, rows=3, cols=2, beam=128)
    e, s, info = solve_beam_chimera_multi(prob, rows=3, cols=2, beam=128)
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert e <= e_id + 1e-9
    assert 1 <= len(info["per_orientation"]) <= 4
