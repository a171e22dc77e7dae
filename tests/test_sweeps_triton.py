"""Colored-sweep Pallas kernel (ops/sweeps_triton.py) in interpret mode,
the implementation choice (ops.sweeps.choose_sweep_impl) and the kernel's
counter-based PRNG. The compiled kernel runs on the GPU in chip_smoke.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmc_tpu.core.problem import IsingProblem, block_problem, tile_columns
from nmc_tpu.io.generators import chimera_graph, ea_2d
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.sweeps import choose_sweep_impl, run_sweeps, sweep_fn
from nmc_tpu.ops.sweeps_triton import (hash_uniform, seed_words,
                                       triton_colored_sweeps)


def _setup(prob, R, block_size, seed=0):
    b = block_problem(prob, block_size=block_size,
                      groups=color_groups(prob.J))
    assert b.colored
    J = b.J_rows.reshape(b.n_pad, b.n_pad)
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0)
    m0 = np.where(b.active, m0, 1.0).astype(np.float32)
    phi0 = (m0 @ J + b.h).astype(np.float32)
    return b, J, m0, phi0


def _kernel(b, J, m0, phi0, seed, beta, num_sweeps, beta_spin=1.0,
            mask=None, r_tile=16):
    col, cnt = tile_columns(J, b.block_size)
    mask = b.active if mask is None else mask
    return triton_colored_sweeps(
        J, col, cnt, b.h, m0, phi0, seed, beta, beta_spin, mask,
        num_sweeps=num_sweeps, block_size=b.block_size, r_tile=r_tile,
        interpret=True)


# (instance, replicas, block_size, r_tile): dense 2-color lattice, sparse
# chimera tiles, replica counts below / across / not a multiple of r_tile
SHAPES = [
    ("ea2d", 4, 16, 16),
    ("ea2d", 37, 16, 16),
    ("chimera", 20, 16, 32),
    ("chimera", 16, 32, 16),
]


def _prob(kind):
    if kind == "ea2d":
        return ea_2d(6, seed=1, pm=False)
    return chimera_graph(3, 3, seed=2, pm=False)


@pytest.mark.parametrize("kind,R,B,r_tile", SHAPES)
def test_kernel_invariants_f64(kind, R, B, r_tile):
    """Padding fixed, spins +-1, phi and every energy match float64."""
    b, J, m0, phi0 = _setup(_prob(kind), R, B)
    res = _kernel(b, J, m0, phi0, seed_words(jax.random.PRNGKey(3)),
                  np.linspace(0.5, 2.0, 6).astype(np.float32), 6,
                  r_tile=r_tile)
    m = np.asarray(res.m, np.float64)
    J64 = J.astype(np.float64)
    assert res.m.shape == (R, b.n_pad) and res.energies.shape == (6, R)
    assert set(np.unique(m)) <= {-1.0, 1.0}
    assert np.all(m[:, ~b.active] == 1.0)
    np.testing.assert_allclose(np.asarray(res.phi), m @ J64 + b.h,
                               atol=1e-5)
    e64 = -(0.5 * np.sum(m * (m @ J64), 1) + m @ b.h)
    np.testing.assert_allclose(np.asarray(res.energies[-1]), e64,
                               rtol=1e-6, atol=1e-5)
    mb = np.asarray(res.m_best, np.float64)
    eb64 = -(0.5 * np.sum(mb * (mb @ J64), 1) + mb @ b.h)
    np.testing.assert_allclose(np.asarray(res.e_best), eb64,
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.e_best),
                               np.asarray(res.energies).min(0))


@pytest.mark.parametrize("per_chain", [False, True])
def test_kernel_frozen_and_heated_spins(per_chain):
    """Masked spins never move; a per-spin beta multiplier of 0 makes a
    spin a fair coin while the rest follow the field."""
    R = 24
    b, J, m0, phi0 = _setup(_prob("ea2d"), R, 16, seed=5)
    frozen = np.zeros(b.n_pad, bool)
    frozen[:16] = True
    mask = b.active & ~frozen
    if per_chain:
        mask = np.broadcast_to(mask, (R, b.n_pad)).copy()
        mask[::2] = b.active        # even chains are free everywhere
    bs = np.ones((R, b.n_pad), np.float32)
    bs[:, 16:32] = 0.0              # infinitely hot block
    res = _kernel(b, J, m0, phi0, seed_words(jax.random.PRNGKey(1)), 50.0,
                  8, beta_spin=bs, mask=mask)
    m = np.asarray(res.m)
    held = slice(1, None, 2) if per_chain else slice(None)
    np.testing.assert_array_equal(m[held, :16], m0[held, :16])
    if per_chain:
        assert (m[::2, :16] != m0[::2, :16]).any()
    assert np.all(m[:, ~b.active] == 1.0)
    hot = m[:, 16:32][:, b.active[16:32]]
    assert 0.2 < (hot > 0).mean() < 0.8


def _replay(b, J, m0, phi0, seed, beta, num_sweeps):
    """The kernel's algorithm in plain jnp with the same hash draws."""
    m, phi = jnp.asarray(m0), jnp.asarray(phi0)
    B, R = b.block_size, m0.shape[0]
    rows = jnp.arange(R)[:, None]
    for t in range(num_sweeps):
        for blk in range(b.num_blocks):
            cols = slice(blk * B, (blk + 1) * B)
            u = hash_uniform(seed[0], seed[1], t, rows,
                             jnp.arange(blk * B, (blk + 1) * B)[None, :],
                             b.n_pad)
            p_up = 0.5 * (1.0 + jnp.tanh(beta * phi[:, cols]))
            new = jnp.where(u < p_up, 1.0, -1.0)
            new = jnp.where(b.active[cols], new, m[:, cols])
            dm = new - m[:, cols]
            m = m.at[:, cols].set(new)
            phi = phi + jnp.matmul(dm, jnp.asarray(J[cols]),
                                   precision="highest")
    return np.asarray(m), np.asarray(phi)


@pytest.mark.parametrize("kind,R", [("ea2d", 5), ("chimera", 18)])
def test_hash_prng_bit_equal_to_jnp_twin(kind, R):
    """Replaying the draws with the module's jnp `hash_uniform` reproduces
    the kernel's states bit for bit."""
    b, J, m0, phi0 = _setup(_prob(kind), R, 16, seed=2)
    seed = np.asarray(seed_words(jax.random.PRNGKey(11)))
    res = _kernel(b, J, m0, phi0, seed, 1.3, 3)
    m_ref, phi_ref = _replay(b, J, m0, phi0, seed, 1.3, 3)
    np.testing.assert_array_equal(np.asarray(res.m), m_ref)
    np.testing.assert_allclose(np.asarray(res.phi), phi_ref, atol=1e-5)


def test_hash_uniform_distribution():
    u = np.asarray(hash_uniform(np.uint32(7), np.uint32(9), 3,
                                jnp.arange(256)[:, None],
                                jnp.arange(512)[None, :], 512))
    assert u.min() >= 0.0 and u.max() < 1.0
    assert np.all(u * 2 ** 24 == np.round(u * 2 ** 24))     # 24-bit grid
    assert abs(u.mean() - 0.5) < 0.005
    hist = np.histogram(u, bins=16, range=(0, 1))[0] / u.size
    assert np.abs(hist - 1 / 16).max() < 0.005
    # neighbouring sweeps, replicas and spins draw independently
    v = np.asarray(hash_uniform(np.uint32(7), np.uint32(9), 4,
                                jnp.arange(256)[:, None],
                                jnp.arange(512)[None, :], 512))
    assert abs(np.corrcoef(u.ravel(), v.ravel())[0, 1]) < 0.01
    assert abs(np.corrcoef(u[:, :-1].ravel(), u[:, 1:].ravel())[0, 1]) < 0.01


def test_kernel_boltzmann_enumerated():
    """The kernel samples the Boltzmann distribution of an enumerable
    2-colored ring with fields (total variation < 0.05)."""
    rng = np.random.default_rng(0)
    n = 4
    J = np.zeros((n, n))
    for i in range(n):
        j = (i + 1) % n
        J[i, j] = J[j, i] = rng.normal()
    prob = IsingProblem(J, 0.3 * rng.normal(size=n))
    beta = 0.8
    states = np.array(list(itertools.product([-1, 1], repeat=n)), float)
    p = np.exp(-beta * prob.energy(states))
    p /= p.sum()
    sidx = (((states + 1) / 2) @ (2 ** np.arange(n)[::-1])).astype(int)

    b, Jb, m, phi = _setup(prob, R=96, block_size=16, seed=4)
    counts = np.zeros(16)
    for it in range(25):
        res = _kernel(b, Jb, m, phi, seed_words(jax.random.PRNGKey(50 + it)),
                      beta, 4)
        m, phi = np.asarray(res.m), np.asarray(res.phi)
        if it >= 5:
            orig = m[:, b.inv_perm]
            idx = (((orig + 1) / 2) @ (2 ** np.arange(n)[::-1])).astype(int)
            counts += np.bincount(idx, minlength=16)
    counts /= counts.sum()
    target = np.zeros(16)
    target[sidx] = p
    assert np.abs(counts - target).sum() / 2 < 0.05


def test_sweep_fn_binds_the_layout_tiles():
    """sweep_fn hands the round engines a run_sweeps-signature callable:
    run_sweeps itself, or the kernel adapter with the tiles bound."""
    from nmc_tpu.ops.sweeps_triton import triton_sweeps
    b, J, _, _ = _setup(_prob("chimera"), 16, 16)
    col, cnt = tile_columns(J, 16)
    f = sweep_fn("triton", col, cnt)
    assert f.func is triton_sweeps
    assert f.keywords["col_idx"] is col and f.keywords["counts"] is cnt
    assert sweep_fn("xla") is run_sweeps


IMPL_CASES = [
    # (backend, platform, colored, block, record_m, expected)
    ("auto", "gpu", True, 128, False, "triton"),
    ("auto", "cpu", True, 128, False, "xla"),
    ("auto", "gpu", False, 128, False, "xla"),
    ("auto", "gpu", True, 128, True, "xla"),
    ("auto", "gpu", True, 24, False, "xla"),
    ("xla", "gpu", True, 128, False, "xla"),
    ("triton", "gpu", True, 64, False, "triton"),
]


@pytest.mark.parametrize("backend,platform,colored,block,record,want",
                         IMPL_CASES)
def test_choose_sweep_impl(backend, platform, colored, block, record, want):
    assert choose_sweep_impl(backend, colored=colored, block_size=block,
                             dtype=jnp.float32, record_m=record,
                             platform=platform) == want


@pytest.mark.parametrize("platform,colored,dtype,match", [
    ("cpu", True, jnp.float32, "GPU"),
    ("gpu", False, jnp.float32, "colored"),
    ("gpu", True, jnp.float64, "float32"),
])
def test_choose_sweep_impl_explicit_triton_raises(platform, colored, dtype,
                                                  match):
    with pytest.raises(ValueError, match=match):
        choose_sweep_impl("triton", colored=colored, block_size=128,
                          dtype=dtype, platform=platform)


def test_choose_sweep_impl_rejects_unknown_backend():
    with pytest.raises(ValueError, match="auto\\|xla\\|triton"):
        choose_sweep_impl("pallas", colored=True, block_size=128,
                          dtype=jnp.float32, platform="gpu")


def test_engine_explicit_triton_raises_off_gpu():
    from nmc_tpu.ops.engine import SweepEngine
    prob = ea_2d(4, seed=3)
    with pytest.raises(ValueError, match="GPU"):
        SweepEngine(prob, block_size=16, use_coloring=True,
                    backend="triton")
    eng = SweepEngine(prob, block_size=16, use_coloring=True)
    assert eng.impl == "xla"
    m0 = eng.from_blocked(eng.init_states(jax.random.PRNGKey(0), 2))
    res = eng.run(m0, jax.random.PRNGKey(1), num_sweeps=2, beta=1.0)
    assert np.isfinite(np.asarray(res.e_best)).all()


def test_tile_columns_matches_block_sparse_tiles():
    from nmc_tpu.core.problem import block_sparse_tiles
    prob = chimera_graph(3, 3, seed=0)
    b = block_problem(prob, block_size=16, groups=color_groups(prob.J))
    col, cnt = tile_columns(b.J_rows.reshape(b.n_pad, b.n_pad), 16)
    col2, tiles = block_sparse_tiles(b)
    np.testing.assert_array_equal(col, col2)
    np.testing.assert_array_equal(
        cnt, np.any(tiles != 0, axis=(2, 3)).sum(1))
    assert (cnt < b.num_blocks).all()     # sparse: not every column tile


@pytest.mark.gpu
def test_compiled_kernel_matches_interpret():
    """The compiled kernel draws what the interpreter draws."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton route compiles only there")
    b, J, m0, phi0 = _setup(_prob("chimera"), 40, 16, seed=3)
    seed = seed_words(jax.random.PRNGKey(4))
    col, cnt = tile_columns(J, 16)
    args = (J, col, cnt, b.h, m0, phi0, seed, 1.1, 1.0, b.active)
    kw = dict(num_sweeps=5, block_size=16)
    res_c = triton_colored_sweeps(*args, **kw)
    res_i = triton_colored_sweeps(*args, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(res_c.m), np.asarray(res_i.m))
    np.testing.assert_allclose(np.asarray(res_c.energies),
                               np.asarray(res_i.energies), atol=1e-4)
