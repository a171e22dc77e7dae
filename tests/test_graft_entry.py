"""Multi-device dry run of every sharded path, on the conftest's virtual
CPU devices, plus a compile-and-run check of one sweep step.

Covers the replica-sharded NPT round (sweeps + LBP + NMC phases +
replica-exchange collective), the instance ensembles (EnsemblePT,
EnsembleNMC), spin(J)-axis sharding and the 2-D (replica, spin) mesh.
Reference-equivalent being validated: the process-pool replica
parallelism at /root/reference/NPT/npt.py:616-640.
"""

import jax
import numpy as np


def sweep_step():
    """A jittable sweep step on a 1024-spin SK instance, 64 replicas."""
    import jax.numpy as jnp

    from nmc_tpu.io.generators import random_sk
    from nmc_tpu.ops.engine import SweepEngine
    from nmc_tpu.ops.sweeps import run_sweeps

    prob = random_sk(1024, seed=0).normalized()[0]
    engine = SweepEngine(prob, block_size=128, precision="default")
    R = 64
    key = jax.random.PRNGKey(0)
    m0 = engine.init_states(key, R)
    phi0 = engine.fields(m0)
    beta_sweep = jnp.full((8,), 2.0, dtype=jnp.float32)
    beta_spin = jnp.ones((), dtype=jnp.float32)
    mask = jnp.broadcast_to(engine.active, (R, engine.n_pad))

    def fn(J_rows, J_diag, h, m, phi, key, beta_sweep, beta_spin, mask):
        res = run_sweeps(
            J_rows, J_diag, h, m, phi, key, beta_sweep, beta_spin, mask,
            num_sweeps=8, within_block="sequential", block_order="fixed",
            record_m=False, precision="default",
        )
        return res.m, res.e_best

    example_args = (engine.J_rows, engine.J_diag, engine.h, m0, phi0,
                    jax.random.PRNGKey(1), beta_sweep, beta_spin, mask)
    return fn, example_args


def dryrun_multichip(n_devices: int) -> None:
    assert len(jax.devices()) >= n_devices, (
        f"need {n_devices} devices, have {len(jax.devices())}")
    devices = np.array(jax.devices()[:n_devices])

    from jax.sharding import Mesh

    from nmc_tpu.io.generators import random_sk
    from nmc_tpu.parallel import (EnsembleConfig, EnsemblePT, ShardedNPT,
                                  ShardedNPTConfig)

    # --- replica-sharded NPT: full training step (sweeps + LBP + NMC
    # phases + replica-exchange collective) over a 'replica' mesh axis ----
    mesh_r = Mesh(devices, ("replica",))
    prob = random_sk(48, seed=0).normalized()[0]
    R = 2 * n_devices
    beta_list = np.linspace(0.3, 3.0, R)
    doNMC = [False] * (R - max(R // 4, 1)) + [True] * max(R // 4, 1)
    cfg = ShardedNPTConfig(sweeps_per_phase=4, num_cycles=1,
                           num_swapping_pairs=max(R // 4, 1),
                           global_beta=2.0, block_size=16,
                           lbp_max_iterations=8, lambda_start=2.0,
                           lambda_reduction_factor=0.25)
    pt = ShardedNPT(prob, beta_list, doNMC, cfg, mesh=mesh_r)
    state = pt.init_state(jax.random.PRNGKey(0))
    state, metrics = pt.round(state)
    jax.block_until_ready(state.m)
    e = np.asarray(metrics.slot_energies)
    assert e.shape == (R,) and np.isfinite(e).all()
    perm_ok = np.array_equal(
        np.asarray(state.slot_to_beta)[np.asarray(state.beta_to_slot)],
        np.arange(R))
    assert perm_ok, "replica-exchange label permutation corrupted"

    # --- instance-ensemble step over an 'instance' mesh axis -------------
    mesh_i = Mesh(devices, ("instance",))
    problems = [random_sk(32, seed=s).normalized()[0]
                for s in range(n_devices)]
    ens = EnsemblePT(problems, np.linspace(0.5, 2.5, 4),
                     EnsembleConfig(num_replicas=4, sweeps_per_round=4,
                                    num_swapping_pairs=1, block_size=16),
                     mesh=mesh_i)
    est = ens.init_state(jax.random.PRNGKey(1))
    est = ens.round(est)
    jax.block_until_ready(est.m)
    assert np.isfinite(np.asarray(est.best_e)).all()

    # --- spin(J)-axis sharding: coupling matrix split over a 'spin' axis --
    from jax.sharding import Mesh as _Mesh

    from nmc_tpu.io.generators import ea_2d
    from nmc_tpu.parallel import SpinShardedConfig, SpinShardedSweeper

    mesh_s = _Mesh(devices, ("spin",))
    sprob = ea_2d(8, seed=1)
    sw = SpinShardedSweeper(sprob, SpinShardedConfig(block_size=8),
                            mesh=mesh_s)
    sstate = sw.init_state(jax.random.PRNGKey(2), 8)
    sstate, se = sw.sweeps(sstate, 4, beta=1.0)
    jax.block_until_ready(sstate.m)
    assert np.isfinite(np.asarray(se)).all()

    # --- 2-D (replica, spin) mesh: tempering ladder + PT swap round at
    # spin-sharded scale ------------------------------------------------
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh_2d = _Mesh(devices.reshape(2, n_devices // 2),
                        ("replica", "spin"))
        sw2 = SpinShardedSweeper(sprob, SpinShardedConfig(block_size=8),
                                 mesh=mesh_2d, replica_axis="replica")
        st2 = sw2.init_state(jax.random.PRNGKey(4), 8)
        st2, _ = sw2.sweeps(st2, 3, beta=2.0, anneal=True)
        st2, e2 = sw2.swap_round(st2, 3, np.geomspace(0.3, 3.0, 8),
                                 num_swapping_pairs=2)
        jax.block_until_ready(st2.m)
        assert np.isfinite(np.asarray(e2)).all()
        assert sorted(np.asarray(st2.beta_to_slot).tolist()) == list(range(8))

    # --- batched-instance NMC ensemble (campaign engine) ----------------
    from nmc_tpu.parallel import EnsembleNMC
    nprobs = [random_sk(24, seed=s).normalized()[0] for s in range(n_devices)]
    encfg = ShardedNPTConfig(sweeps_per_phase=3, num_cycles=1,
                             num_swapping_pairs=1, block_size=8,
                             lbp_mode="dense", lbp_max_iterations=6,
                             lambda_start=2.0, lambda_reduction_factor=0.25)
    enmc = EnsembleNMC(nprobs, np.linspace(0.4, 2.5, 6),
                       [False] * 4 + [True] * 2, encfg,
                       mesh=Mesh(devices, ("instance",)))
    enst = enmc.init_state(jax.random.PRNGKey(5))
    enst = enmc.run_scanned(enst, 2)
    ebn, _ = enmc.best(enst)
    assert np.isfinite(ebn).all()


def test_dryrun_multichip_8_devices():
    """Every sharded path on an 8-device mesh."""
    dryrun_multichip(8)  # raises on any regression


def test_dryrun_multichip_2_devices():
    """Replica counts derived from the device count hold on 2 devices."""
    dryrun_multichip(2)


def test_entry_compiles_and_runs():
    fn, args = sweep_step()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    m, e_best = out
    assert m.shape[0] == 64  # R replicas
    assert np.isfinite(np.asarray(e_best)).all()
