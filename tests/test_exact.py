"""Exact meet-in-the-middle solver: host vs brute force, device vs host,
f32-exactness guard, and ground-truth verification on a shipped reference
instance (the reference ships truths but no solver to produce them —
nmc_tpu/exact.py makes them independently checkable)."""

import itertools
import os

import numpy as np
import pytest

WISHART = ("/root/reference/NPT/examples/wishart_small/"
           "wishart_planting_N_22_alpha_0.50")


def _brute(prob):
    best, best_s = np.inf, None
    for bits in itertools.product((-1.0, 1.0), repeat=prob.n):
        s = np.array(bits)
        e = float(prob.energy(s))
        if e < best:
            best, best_s = e, s
    return best, best_s


def test_host_matches_brute_force(rng):
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_host

    J = rng.normal(size=(14, 14))
    J = 0.5 * (J + J.T)
    np.fill_diagonal(J, 0.0)
    h = rng.normal(size=14)
    prob = IsingProblem(J, h)             # h != 0: no symmetry shortcut
    e_b, _ = _brute(prob)
    e, s = solve_exact_host(prob)
    assert abs(e - e_b) < 1e-9
    assert abs(float(prob.energy(s)) - e) < 1e-9


def test_host_symmetry_path(rng):
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_host

    J = rng.normal(size=(15, 15))         # odd n, h = 0 -> pinned spin
    J = 0.5 * (J + J.T)
    np.fill_diagonal(J, 0.0)
    prob = IsingProblem(J, np.zeros(15))
    e_b, _ = _brute(prob)
    e, s = solve_exact_host(prob)
    assert abs(e - e_b) < 1e-9


def test_device_matches_host():
    from nmc_tpu.exact import solve_exact_device, solve_exact_host
    from nmc_tpu.io.generators import wishart_planted

    prob, t, gs = wishart_planted(20, 0.3, seed=11)
    e_h, _ = solve_exact_host(prob)
    e_d, s_d = solve_exact_device(prob, block_a=64, block_b=256)
    assert abs(e_d - e_h) < 1e-6 * abs(e_h)
    assert abs(float(prob.energy(s_d)) - e_d) < 1e-9
    # the planted state is a ground state: energies must agree
    assert e_d <= gs + 1e-9


def test_device_integer_exactness():
    """Integer couplings >> 256: the HIGHEST-precision matmul path must
    return the exact integer energy (the default bf16 passes would not)."""
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_device, solve_exact_host

    rng = np.random.default_rng(5)
    J = rng.integers(-20000, 20000, size=(18, 18)).astype(np.float64)
    J = np.triu(J, 1)
    J = J + J.T
    prob = IsingProblem(J, np.zeros(18))
    e_h, _ = solve_exact_host(prob)
    e_d, _ = solve_exact_device(prob, block_a=128, block_b=512)
    assert e_d == e_h                     # exact integers, bitwise equal


def test_f32_bound_guard():
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_device

    J = np.zeros((12, 12))
    J[0, 1] = J[1, 0] = 3e7               # blows the 2^24 budget
    prob = IsingProblem(J, np.zeros(12))
    with pytest.raises(ValueError, match="2\\^24"):
        solve_exact_device(prob)


@pytest.mark.skipif(not os.path.isdir(WISHART),
                    reason="reference wishart_small not present")
def test_reference_truth_verified_exactly():
    """Independently re-derive a shipped ground-truth energy: exact
    agreement with gs_energies.txt for wishart N=22."""
    from nmc_tpu.evaluation import wishart_folder_instances
    from nmc_tpu.exact import solve_exact_host

    name, prob, gs_raw = next(iter(wishart_folder_instances(WISHART,
                                                            limit=1)))
    e, s = solve_exact_host(prob)
    assert e == gs_raw                    # integers: bitwise equality


@pytest.mark.parametrize("block_a,block_b", [(48, 64), (1024, 1 << 15)])
def test_device_padded_grid_matches_host(rng, block_a, block_b):
    # block_a not dividing the A table pads it with +inf rows; the
    # default blocks clamp to the table
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_device, solve_exact_host

    J = np.round(10 * rng.normal(size=(15, 15)))
    J = np.triu(J, 1)
    J = J + J.T
    prob = IsingProblem(J, np.zeros(15))   # a=7, sym -> TA=64; pad to 96
    e_h, _ = solve_exact_host(prob)
    e_d, s_d = solve_exact_device(prob, block_a=block_a, block_b=block_b)
    assert e_d == e_h
    assert float(prob.energy(s_d)) == e_d


def _write_instance(tmp_path, prob):
    from nmc_tpu.io.writers import save_edgelist
    path = str(tmp_path / "inst.txt")
    save_edgelist(path, prob)
    return path


@pytest.mark.parametrize("n,tier", [(20, "host"), (32, "device")])
def test_exact_cli_auto_routes_by_size(tmp_path, capsys, n, tier):
    import json

    from nmc_tpu.cli import main
    from nmc_tpu.exact import solve_exact_host
    from nmc_tpu.io.generators import random_sk

    prob = random_sk(n, seed=n)
    rc = main(["exact", _write_instance(tmp_path, prob), "--kind",
               "wishart", "--block-a", "64", "--block-b", "256"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["backend"] == tier and rec["n"] == n
    if n <= 24:
        assert abs(rec["energy_raw"] - solve_exact_host(prob)[0]) < 1e-9


def test_exact_cli_auto_raises_past_limit(tmp_path):
    from nmc_tpu.cli import EXACT_DEVICE_MAX_N, main
    from nmc_tpu.io.generators import random_sk

    prob = random_sk(EXACT_DEVICE_MAX_N + 4, seed=1)
    with pytest.raises(SystemExit, match=f"n <= {EXACT_DEVICE_MAX_N}"):
        main(["exact", _write_instance(tmp_path, prob), "--kind",
              "wishart"])


def test_exact_cli_has_no_pallas_tier(tmp_path):
    from nmc_tpu.cli import main
    from nmc_tpu.io.generators import random_sk

    path = _write_instance(tmp_path, random_sk(12, seed=0))
    with pytest.raises(SystemExit):
        main(["exact", path, "--backend", "pallas"])


def test_enum_proves_optimality(rng):
    """Native branch-and-bound enumeration: beats-or-proves the
    incumbent with an exhausted tree == optimality proof; parity with
    the MITM host tier."""
    pytest.importorskip("scipy")
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_enum, solve_exact_host
    from nmc_tpu.native import load_enum_library

    if load_enum_library() is None:
        pytest.skip("native toolchain unavailable")
    J = np.round(50 * rng.normal(size=(20, 20)))
    J = np.triu(J, 1)
    J = J + J.T
    prob = IsingProblem(J, np.zeros(20))
    e_h, _ = solve_exact_host(prob)
    e, s, proved = solve_exact_enum(prob, dm_starts=32, dm_iters=100)
    assert proved
    assert e == e_h
    assert abs(float(prob.energy(s)) - e) < 1e-9


def test_enum_rejects_fields():
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_enum

    J = np.zeros((6, 6))
    J[0, 1] = J[1, 0] = 1.0
    with pytest.raises(ValueError, match="h = 0"):
        solve_exact_enum(IsingProblem(J, np.ones(6)))


WSMALL = "/root/reference/NPT/examples/wishart_small"


@pytest.mark.skipif(not os.path.isdir(WSMALL),
                    reason="reference wishart_small not present")
@pytest.mark.parametrize("folder", [
    "wishart_planting_N_8_alpha_1.00",
    "wishart_planting_N_16_alpha_0.50",
    "wishart_planting_N_24_alpha_0.50",
])
def test_shipped_truths_rederived_exactly(folder):
    """Loader + energy convention + shipped gs_energies.txt all agree
    with an independent exact enumeration (bitwise, integer energies)."""
    from nmc_tpu.evaluation import wishart_folder_instances
    from nmc_tpu.exact import solve_exact_host

    path = os.path.join(WSMALL, folder)
    if not os.path.isdir(path):
        pytest.skip(f"{folder} not shipped")
    for name, prob, gs_raw in wishart_folder_instances(path, limit=2):
        e, s = solve_exact_host(prob)
        assert e == gs_raw, name


def test_enum_f32_variant_matches(rng):
    from nmc_tpu import IsingProblem
    from nmc_tpu.exact import solve_exact_host
    from nmc_tpu.native import exact_enumerate, load_enum_library

    if load_enum_library() is None:
        pytest.skip("native toolchain unavailable")
    import scipy.linalg as sla

    J = np.round(40 * rng.normal(size=(18, 18)))
    J = np.triu(J, 1)
    J = J + J.T
    prob = IsingProblem(J, np.zeros(18))
    e_h, _ = solve_exact_host(prob)
    n = 18
    w, v = np.linalg.eigh(J)
    lmax = float(w[-1])
    c0 = -0.5 * lmax * n
    M = np.sqrt(np.maximum(lmax - w, 0.0))[:, None] * v.T
    _, _, piv = sla.qr(M, pivoting=True)
    order = piv[::-1].copy()
    _, R = sla.qr(M[:, order], mode="economic")
    A = np.abs(R)
    W = np.zeros_like(R)
    for k in range(n):
        W[k, k + 1:] = np.cumsum(A[k, k:-1])
    r2 = 2.0 * (e_h + 1.0 - c0)       # quantum of slack above the optimum
    for f32 in (False, True):
        found, z, br2, nodes, complete = exact_enumerate(
            R, W, r2, use_f32=f32)
        assert complete
        assert found
        s = np.empty(n)
        s[order] = z
        assert float(prob.energy(s)) == e_h, f"f32={f32}"


@pytest.mark.skipif(not os.path.isdir(WISHART),
                    reason="reference wishart_small not present")
def test_exact_cli(tmp_path):
    import json

    from nmc_tpu.cli import main

    inst = os.path.join(WISHART,
                        "wishart_planting_N_22_alpha_0.50_inst_1.txt")
    out = str(tmp_path / "exact.jsonl")
    state_f = str(tmp_path / "gs.txt")
    rc = main(["exact", inst, "--backend", "host", "--out", out,
               "--save-state", state_f])
    assert rc == 0
    rec = json.loads(open(out).readline())
    assert rec["backend"] == "host"
    assert rec["matches_shipped"] is True
    assert rec["energy_raw"] == rec["shipped_target"]
    s = np.loadtxt(state_f)
    assert s.shape == (22,)
