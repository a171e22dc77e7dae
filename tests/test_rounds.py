"""Round contracts of the three round engines (ShardedNPT, EnsembleNMC,
EnsembleICM) on the colored layout, through the sweep stage that
ops.sweeps.choose_sweep_impl picks:

* reported best energies match float64 re-evaluation of the best states;
* padding spins never move;
* the best ever is no worse than any carried state;
* frozen spins (NMC masks) never move inside a phase;
* plain parallel tempering samples the Boltzmann distribution.
"""

import jax
import numpy as np
import pytest

from nmc_tpu.core.problem import IsingProblem
from nmc_tpu.io.generators import ea_2d
from nmc_tpu.parallel import (EnsembleICM, EnsembleICMConfig, EnsembleNMC,
                              ShardedNPT, ShardedNPTConfig)

BETAS = np.geomspace(0.4, 3.0, 8)
DO_NMC = [False] * 5 + [True] * 3


def _npt_cfg(**kw):
    base = dict(sweeps_per_phase=5, num_cycles=2, num_swapping_pairs=2,
                global_beta=2.0, block_size=16, use_coloring=True,
                lbp_max_iterations=6, lambda_start=2.0,
                lambda_reduction_factor=0.25)
    base.update(kw)
    return ShardedNPTConfig(**base)


def _run(engine):
    """(problems, carried states [I, C, n], best e [I], best m [I, n],
    padding values of the carried blocked states)."""
    if engine == "sharded":
        prob = ea_2d(6, seed=0).normalized()[0]
        pt = ShardedNPT(prob, BETAS, DO_NMC, _npt_cfg())
        st = pt.init_state(jax.random.PRNGKey(0))
        st, _ = pt.run(st, 3)
        eb, mb = pt.best(st)
        pad = np.asarray(st.m)[:, ~pt.blocked.active]
        return ([prob], pt.states_by_temperature(st)[None], np.array([eb]),
                mb[None], pad)
    probs = [ea_2d(6, seed=s).normalized()[0] for s in range(2)]
    if engine == "ensemble_nmc":
        ens = EnsembleNMC(probs, BETAS, DO_NMC, _npt_cfg())
        carried_shape = (2, len(BETAS), -1)
    else:
        ens = EnsembleICM(probs, BETAS, EnsembleICMConfig(
            sweeps_per_round=6, num_subreplicas=2, block_size=16,
            use_coloring=True))
        carried_shape = (2, 2 * len(BETAS), -1)
    st = ens.init_state(jax.random.PRNGKey(1))
    st = ens.run_scanned(st, 3)
    eb, mb = ens.best(st)
    m = np.asarray(st.m).reshape(carried_shape)
    act = np.asarray(ens.active)
    return probs, m[..., np.asarray(ens.blocked0.inv_perm)], eb, mb, \
        m[..., ~act]


ENGINES = ["sharded", "ensemble_nmc", "ensemble_icm"]


@pytest.mark.parametrize("engine", ENGINES)
def test_round_best_energy_matches_f64(engine):
    probs, _, eb, mb, _ = _run(engine)
    for i, p in enumerate(probs):
        assert np.isfinite(eb[i])
        assert abs(float(p.energy(mb[i])) - eb[i]) < 1e-4 * max(
            1.0, abs(eb[i]))


@pytest.mark.parametrize("engine", ENGINES)
def test_round_padding_never_moves(engine):
    *_, pad = _run(engine)
    assert pad.size > 0
    assert np.all(pad == 1.0)


@pytest.mark.parametrize("engine", ENGINES)
def test_round_best_no_worse_than_carried(engine):
    probs, carried, eb, _, _ = _run(engine)
    for i, p in enumerate(probs):
        assert eb[i] <= p.energy(carried[i]).min() + 1e-4


@pytest.mark.parametrize("heated", [False, True])
def test_phase_frozen_masks(heated):
    """The NMC phase shape on the round engines' sweep stage: spins outside
    the update mask never move, heated or not."""
    from nmc_tpu.core.problem import block_problem, tile_columns
    from nmc_tpu.ops.coloring import color_groups
    from nmc_tpu.ops.sweeps import choose_sweep_impl, sweep_fn

    prob = ea_2d(6, seed=2).normalized()[0]
    b = block_problem(prob, block_size=16, groups=color_groups(prob.J))
    J = b.J_rows.reshape(b.n_pad, b.n_pad)
    fn = sweep_fn(choose_sweep_impl(colored=True, block_size=16,
                                    dtype=np.float32),
                  *tile_columns(J, 16))
    R = 8
    rng = np.random.default_rng(0)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0)
    m0 = np.where(b.active, m0, 1.0).astype(np.float32)
    cl = np.zeros((R, b.n_pad), bool)
    cl[:, : b.n_pad // 2] = True
    cl &= b.active
    beta_spin = np.where(cl, 0.05, 1.0).astype(np.float32) if heated \
        else np.ones((R, 1), np.float32)
    res = fn(J_rows=b.J_rows, J_diag=b.J_diag, h=b.h, m0=m0,
             phi0=(m0 @ J + b.h).astype(np.float32),
             key=jax.random.PRNGKey(3), beta_sweep=np.ones(6, np.float32),
             beta_spin=2.0 * beta_spin, update_mask=cl, num_sweeps=6,
             within_block="jacobi", block_order="fixed", record_m=False,
             precision="highest")
    m = np.asarray(res.m)
    np.testing.assert_array_equal(m[~cl], m0[~cl])
    assert (m[cl] != m0[cl]).any()


def test_round_boltzmann_plain_pt():
    """Plain PT slots (no NMC) at one temperature sample the Boltzmann
    distribution of an enumerable 2-colored ring through full rounds."""
    n = 4
    Jm = np.zeros((n, n))
    for i in range(n):
        j = (i + 1) % n
        Jm[i, j] = Jm[j, i] = 0.7 if i % 2 else -0.4
    prob = IsingProblem(Jm, np.full(n, 0.15))
    beta = 0.9
    R = 64
    pt = ShardedNPT(prob, np.full(R, beta), [False] * R,
                    _npt_cfg(sweeps_per_phase=2, num_cycles=1,
                             global_beta=beta))
    st = pt.init_state(jax.random.PRNGKey(5))
    counts = np.zeros(2 ** n)
    for it in range(60):
        st, _ = pt.round(st)
        if it >= 10:
            m = pt.states_by_temperature(st)
            idx = ((m + 1) / 2) @ (2 ** np.arange(n))
            counts += np.bincount(idx.astype(int), minlength=2 ** n)
    states = np.array([[1 if bits >> i & 1 else -1 for i in range(n)]
                       for bits in range(2 ** n)], float)
    w = np.exp(-beta * prob.energy(states))
    tv = 0.5 * np.abs(counts / counts.sum() - w / w.sum()).sum()
    assert tv < 0.06, f"total variation {tv}"
