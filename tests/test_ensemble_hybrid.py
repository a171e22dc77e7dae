"""Hybrid ICM+NMC arm: disagreement-seeded heated phases (EnsembleICM
hybrid_cold > 0).

The move engine of the reference's NMC (/root/reference/NMC/nmc.py:320-440
heat cluster / refreeze / full sweep) driven by the Houdayer disagreement
set of sub-replica pairs (/root/reference/NPT/apt_ICM.py:116-143) instead
of LBP backbones — the complementary-arm combination VERDICT round 3 asked
for (ICM dominates chimera, NMC dominates DCL/contrived)."""

import itertools

import jax
import numpy as np
import pytest

from nmc_tpu.io.generators import ea_2d, random_sk
from nmc_tpu.parallel import EnsembleICM, EnsembleICMConfig


def _hybrid_cfg(**kw):
    base = dict(sweeps_per_round=12, num_subreplicas=4,
                num_swapping_pairs=1, block_size=16,
                hybrid_cold=3, temp_x=10.0, num_cycles=2)
    base.update(kw)
    return EnsembleICMConfig(**base)


class TestHybridArm:
    def test_hybrid_masks_populated_and_invariants(self):
        probs = [random_sk(10, seed=s).normalized()[0] for s in range(2)]
        beta = np.geomspace(0.4, 3.0, 6)
        ens = EnsembleICM(probs, beta, _hybrid_cfg())
        state = ens.init_state(jax.random.PRNGKey(0))
        state = ens.run_scanned(state, 10)
        cl = np.asarray(state.cl)          # [I, S, R, n_pad]
        dn = np.asarray(state.dn)          # [I, S, R]
        act = np.asarray(ens.active)
        # chains not flagged for NMC phases carry empty masks
        assert not cl[~dn].any()
        # masks live on active spins only
        assert not cl[..., ~act].any()
        # early in a hot/cold ladder some pairs must still disagree
        assert dn.any(), "no hybrid chain ever activated in 10 rounds"
        # disagreement sets respect the max_heat_frac cut
        frac = cl.sum(-1) / act.sum()
        assert (frac[dn] > 0).all()
        assert (frac[dn] <= ens.cfg.max_heat_frac + 1e-9).all()

    def test_hybrid_finds_sk_ground_states(self):
        probs = [random_sk(10, seed=s).normalized()[0] for s in range(3)]
        gs = []
        for p in probs:
            states = np.array(list(itertools.product([-1, 1], repeat=10)),
                              float)
            gs.append(float(p.energy(states).min()))
        ens = EnsembleICM(probs, np.geomspace(0.4, 3.0, 6), _hybrid_cfg())
        state = ens.init_state(jax.random.PRNGKey(0))
        state = ens.run_scanned(state, 25)
        eb, mb = ens.best(state)
        for i, p in enumerate(probs):
            assert abs(float(p.energy(mb[i])) - eb[i]) < 1e-3
            assert eb[i] <= gs[i] + 1e-4, f"instance {i}: {eb[i]} vs {gs[i]}"
        assert int(np.asarray(state.icm_moves).sum()) > 0

    def test_hybrid_off_keeps_masks_empty(self):
        probs = [random_sk(10, seed=s).normalized()[0] for s in range(2)]
        cfg = _hybrid_cfg(hybrid_cold=0, num_cycles=1)
        ens = EnsembleICM(probs, np.geomspace(0.4, 3.0, 6), cfg)
        state = ens.init_state(jax.random.PRNGKey(0))
        state = ens.run_scanned(state, 5)
        assert not np.asarray(state.cl).any()
        assert not np.asarray(state.dn).any()

    def test_hybrid_deterministic(self):
        probs = [random_sk(10, seed=s).normalized()[0] for s in range(2)]
        beta = np.geomspace(0.4, 3.0, 6)
        res = []
        for _ in range(2):
            ens = EnsembleICM(probs, beta, _hybrid_cfg())
            state = ens.init_state(jax.random.PRNGKey(7))
            state = ens.run_scanned(state, 6)
            eb, _ = ens.best(state)
            res.append(np.asarray(eb))
        np.testing.assert_array_equal(res[0], res[1])

    def test_hybrid_cold_validation(self):
        probs = [random_sk(10, seed=0).normalized()[0]]
        with pytest.raises(ValueError, match="hybrid_cold"):
            EnsembleICM(probs, np.geomspace(0.4, 3.0, 6),
                        _hybrid_cfg(hybrid_cold=7))

    def test_hybrid_padded_spins_inert(self):
        # mixed sizes: smaller instance padded to the family max — padded
        # spins must stay +1 and outside every mask
        from nmc_tpu.parallel.ensemble_nmc import _pad_problem
        probs = [random_sk(12, seed=0).normalized()[0],
                 _pad_problem(random_sk(9, seed=1).normalized()[0], 12)]
        ens = EnsembleICM(probs, np.geomspace(0.4, 3.0, 6), _hybrid_cfg())
        state = ens.init_state(jax.random.PRNGKey(3))
        state = ens.run_scanned(state, 6)
        m = np.asarray(state.m)
        act = np.asarray(ens.active)
        assert (m[..., ~act] == 1.0).all()


class TestHybridKernelPath:
    def _ens(self):
        probs = [ea_2d(6, seed=s).normalized()[0] for s in range(4)]
        cfg = EnsembleICMConfig(sweeps_per_round=12, num_subreplicas=2,
                                num_swapping_pairs=2, use_coloring=True,
                                block_size=16,
                                hybrid_cold=2, temp_x=10.0, num_cycles=2)
        beta = np.geomspace(0.3, 4.0, 8)
        return probs, EnsembleICM(probs, beta, cfg)

    def test_hybrid_kernel_contract(self):
        # colored layout with heated cycles, through the sweep stage the
        # implementation choice picks (the XLA path on the CPU)
        probs, ens = self._ens()
        assert ens._cycles == 2
        state = ens.init_state(jax.random.PRNGKey(0))
        state = ens.run_scanned(state, 4)
        eb, mb = ens.best(state)
        assert eb.shape == (4,) and np.isfinite(eb).all()
        for i, p in enumerate(probs):
            assert abs(float(p.energy(mb[i])) - eb[i]) < 1e-3
        b2s = np.asarray(state.beta_to_slot)
        for i in range(4):
            for s in range(2):
                assert sorted(b2s[i, s].tolist()) == list(range(8))

    def test_hybrid_kernel_gate_sweeps_divisibility(self):
        from nmc_tpu.io.generators import ea_2d
        probs = [ea_2d(6, seed=0).normalized()[0]]
        cfg = EnsembleICMConfig(sweeps_per_round=9, num_subreplicas=2,
                                num_swapping_pairs=1, use_coloring=True,
                                block_size=16,
                                hybrid_cold=2, num_cycles=2)
        with pytest.raises(ValueError, match="3\\*num_cycles"):
            EnsembleICM(probs, np.geomspace(0.3, 4.0, 8), cfg)
