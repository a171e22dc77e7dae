"""Blocked heat-bath Gibbs sweep engine (jittable, XLA).

The reference's MCMC kernel (/root/reference/NMC/nmc.py:28-91 and three
duplicates) performs a strictly sequential random-scan Gibbs sweep and
recomputes the FULL local-field vector J@m + h per spin update — O(N*nnz)
work per sweep. This engine replaces it with a blocked scheme:

  * Local fields phi = J@m + h are cached and updated incrementally.
  * Spins are processed in blocks of `block_size` (default 128).
    Within a block the update is either
      - 'sequential': exact heat-bath Gibbs via the classic delayed-update
        trick — a running intra-block correction is maintained with rank-1
        outer products, so spin i sees every earlier flip in its block; or
      - 'jacobi': all block spins at once, which is EXACT Gibbs whenever the
        block is an independent set (graph-colored blocks, ops/coloring.py)
        and an approximation otherwise.
    After each block, phi += dm @ J[block, :] — one matmul per block,
    R*N^2 MACs per full sweep in total (the optimal dense cost).
  * Replicas / chains ride the leading batch axis R; the same compiled
    kernel serves NMC phases, NPT replicas, APT chains and ICM sub-replicas.
  * Heating and freezing are expressed as a per-spin effective-beta vector
    and an update mask instead of the reference's J/h copies and +-10000
    freeze biases (/root/reference/NMC/nmc.py:377-406): scaling row
    J[c, :] /= temp_x is identical to sampling spin c at beta/temp_x, and a
    +-10000*m bias makes the flip probability exactly keep-current in
    float64, i.e. a masked (non-)update.
  * Per-sweep energies come free from phi: E = -0.5 * m.(phi + h)
    (core/energy.py), replacing the reference's per-sweep quadratic forms
    (/root/reference/NMC/nmc.py:386-387).
  * The per-replica argmin-energy state is tracked as a running best inside
    the scan, so restart-from-best (/root/reference/NMC/nmc.py:394-395)
    never needs the full sweep history in memory.

The heat-bath update rule itself matches /root/reference/NMC/nmc.py:87:
m_k <- +1 with probability (1 + tanh(beta_k * phi_k)) / 2.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.energy import energy_from_fields


class SweepResult(NamedTuple):
    m: jax.Array          # [R, n_pad] final states
    phi: jax.Array        # [R, n_pad] final local fields (J@m + h)
    m_best: jax.Array     # [R, n_pad] per-replica argmin-energy state seen
    e_best: jax.Array     # [R] its energy
    energies: jax.Array   # [T, R] post-sweep energies
    M: Optional[jax.Array]  # [T, R, n_pad] recorded states (None unless record_m)


def heat_bath_update(x, beta_eff, u, m_old, mask):
    """One heat-bath draw: P(m=+1) = (1 + tanh(beta*x)) / 2, masked."""
    p_up = 0.5 * (1.0 + jnp.tanh(beta_eff * x))
    m_new = jnp.where(u < p_up, 1.0, -1.0).astype(m_old.dtype)
    return jnp.where(mask, m_new, m_old)


@functools.partial(
    jax.jit,
    static_argnames=("num_sweeps", "within_block", "block_order", "record_m",
                     "precision"),
)
def run_sweeps(
    J_rows,        # [nB, B, n_pad]
    J_diag,        # [nB, B, B]
    h,             # [n_pad]
    m0,            # [R, n_pad] in {-1, +1}
    phi0,          # [R, n_pad] cached local fields for m0
    key,           # PRNG key
    beta_sweep,    # [T] per-sweep inverse temperature (anneal ramps live here)
    beta_spin,     # broadcastable to [R, n_pad]; multiplies beta_sweep (heating)
    update_mask,   # broadcastable to [R, n_pad] bool; False = frozen / padding
    sparse_tiles=None,  # optional (col_idx [nB,K], J_tiles [nB,K,B,B]):
                        # block-sparse phi update (sparse topologies)
    *,
    num_sweeps: int,
    within_block: str = "sequential",
    block_order: str = "fixed",
    record_m: bool = False,
    precision: str = "highest",
) -> SweepResult:
    """Run `num_sweeps` Gibbs sweeps for a batch of replicas."""
    nB, B, n_pad = J_rows.shape
    R = m0.shape[0]
    dtype = m0.dtype

    beta_sweep = jnp.broadcast_to(jnp.asarray(beta_sweep, dtype), (num_sweeps,))
    beta_spin = jnp.broadcast_to(jnp.asarray(beta_spin, dtype), (R, n_pad))
    update_mask = jnp.broadcast_to(update_mask, (R, n_pad))
    h = h.astype(dtype)

    def block_update(m, phi, u, beta_t, bidx):
        start = bidx * B
        xb = lax.dynamic_slice_in_dim(phi, start, B, axis=1)
        mb = lax.dynamic_slice_in_dim(m, start, B, axis=1)
        ub = lax.dynamic_slice_in_dim(u, start, B, axis=1)
        betab = beta_t * lax.dynamic_slice_in_dim(beta_spin, start, B, axis=1)
        maskb = lax.dynamic_slice_in_dim(update_mask, start, B, axis=1)

        if within_block == "jacobi":
            mb_new = heat_bath_update(xb, betab, ub, mb, maskb)
        elif within_block == "sequential":
            Jbb = J_diag[bidx]  # [B, B]

            def spin_step(i, carry):
                mb_c, corr = carry
                x_i = (lax.dynamic_slice_in_dim(xb, i, 1, axis=1)
                       + lax.dynamic_slice_in_dim(corr, i, 1, axis=1))  # [R,1]
                u_i = lax.dynamic_slice_in_dim(ub, i, 1, axis=1)
                b_i = lax.dynamic_slice_in_dim(betab, i, 1, axis=1)
                k_i = lax.dynamic_slice_in_dim(maskb, i, 1, axis=1)
                old_i = lax.dynamic_slice_in_dim(mb_c, i, 1, axis=1)
                new_i = heat_bath_update(x_i, b_i, u_i, old_i, k_i)
                d_i = new_i - old_i                        # [R,1]
                Jrow = lax.dynamic_slice_in_dim(Jbb, i, 1, axis=0)  # [1,B]
                corr = corr + d_i * Jrow
                mb_c = lax.dynamic_update_slice_in_dim(mb_c, new_i, i, axis=1)
                return mb_c, corr

            mb_new, _ = lax.fori_loop(
                0, B, spin_step, (mb, jnp.zeros_like(xb))
            )
        else:
            raise ValueError(f"unknown within_block={within_block!r}")

        dm = mb_new - mb  # [R, B]
        if sparse_tiles is not None:
            col_idx, J_tiles = sparse_tiles
            K = col_idx.shape[1]
            # unrolled so XLA keeps the dynamic-update-slices in place
            for k in range(K):
                j = col_idx[bidx, k]
                tgt = lax.dynamic_slice_in_dim(phi, j * B, B, axis=1)
                tgt = tgt + jnp.matmul(dm, J_tiles[bidx, k],
                                       precision=precision)
                phi = lax.dynamic_update_slice_in_dim(phi, tgt, j * B, axis=1)
        else:
            phi = phi + jnp.matmul(dm, J_rows[bidx], precision=precision)
        m = lax.dynamic_update_slice_in_dim(m, mb_new, start, axis=1)
        return m, phi

    def one_sweep(carry, xs):
        m, phi, m_best, e_best = carry
        beta_t, key_t = xs
        u_key, perm_key = jax.random.split(key_t)
        u = jax.random.uniform(u_key, (R, n_pad), dtype=dtype)

        if block_order == "random":
            border = jax.random.permutation(perm_key, nB)
        else:
            border = None

        def body(b, mp):
            m_c, phi_c = mp
            bidx = border[b] if border is not None else b
            return block_update(m_c, phi_c, u, beta_t, bidx)

        m, phi = lax.fori_loop(0, nB, body, (m, phi))

        e = energy_from_fields(h, m, phi)  # [R]
        better = e < e_best
        m_best = jnp.where(better[:, None], m, m_best)
        e_best = jnp.where(better, e, e_best)
        ys = (e, m) if record_m else (e,)
        return (m, phi, m_best, e_best), ys

    # best-so-far covers SWEPT states only, matching the reference's
    # argmin over the phase's sweep history (/root/reference/NMC/nmc.py:394)
    e_inf = jnp.full((R,), jnp.inf, dtype=dtype)
    keys = jax.random.split(key, num_sweeps)
    carry0 = (m0, phi0, m0, e_inf)
    (m, phi, m_best, e_best), ys = lax.scan(
        one_sweep, carry0, (beta_sweep, keys)
    )
    if record_m:
        energies, M = ys
    else:
        (energies,), M = ys, None
    return SweepResult(m=m, phi=phi, m_best=m_best, e_best=e_best,
                       energies=energies, M=M)


def anneal_schedule(num_sweeps: int, beta: float, initial_beta: float,
                    sweeps_per_beta: int, dtype=jnp.float32) -> jax.Array:
    """Per-sweep beta ramp, bit-matching the reference's annealing loop.

    The reference (/root/reference/NMC/nmc.py:56-69) builds
    beta_vals = linspace(initial_beta, beta, num_sweeps // sweeps_per_beta)
    and advances beta_idx BEFORE using it on sweep 0, so beta_vals[0]
    (= initial_beta) is never used when num_betas > 1, and the final level
    is held for the remaining sweeps. Reproduced exactly.
    """
    num_betas = max(num_sweeps // sweeps_per_beta, 1)
    beta_vals = jnp.linspace(initial_beta, beta, num_betas, dtype=dtype)
    # index used on sweep jj: idx(jj) = min(jj // sweeps_per_beta + 1, num_betas - 1)
    jj = jnp.arange(num_sweeps)
    idx = jnp.minimum(jj // sweeps_per_beta + 1, num_betas - 1)
    return beta_vals[idx]


def choose_sweep_impl(backend: str = "auto", *, colored: bool,
                      block_size: int, dtype, block_order: str = "fixed",
                      record_m: bool = False,
                      platform: Optional[str] = None) -> str:
    """The one choice of sweep implementation: 'triton' (the Pallas kernel
    of ops/sweeps_triton.py) or 'xla' (run_sweeps).

    `backend` is 'auto' (the kernel wherever it covers the request), 'xla'
    or 'triton' (raises when the kernel cannot run the request here)."""
    if backend not in ("auto", "xla", "triton"):
        raise ValueError(f"backend must be auto|xla|triton, got {backend!r}")
    if backend == "xla":
        return "xla"
    platform = platform or jax.default_backend()
    fails = []
    if platform != "gpu":
        fails.append(f"a GPU (platform is {platform!r})")
    if not colored:
        fails.append("a colored layout (use_coloring=True)")
    if block_order != "fixed":
        fails.append("block_order='fixed'")
    if record_m:
        fails.append("record_m=False")
    if jnp.dtype(dtype) != jnp.float32:
        fails.append(f"float32 (got {jnp.dtype(dtype).name})")
    if block_size < 16 or block_size & (block_size - 1):
        fails.append(f"a power-of-two block_size >= 16 (got {block_size})")
    if not fails:
        return "triton"
    if backend == "triton":
        raise ValueError("the triton sweep kernel needs " + "; ".join(fails))
    return "xla"


def layout_sweeps(blocked, dtype):
    """The run_sweeps-compatible callable for instances sharing one blocked
    layout (a family: the kernel walks the union of their couplings)."""
    b0 = blocked[0]
    impl = choose_sweep_impl(colored=b0.colored, block_size=b0.block_size,
                             dtype=dtype)
    if impl == "xla":
        return run_sweeps
    from ..core.problem import tile_columns
    pattern = sum(np.abs(b.J_rows.reshape(b0.n_pad, b0.n_pad))
                  for b in blocked)
    return sweep_fn(impl, *tile_columns(pattern, b0.block_size))


def sweep_fn(impl: str, col_idx=None, counts=None):
    """A run_sweeps-compatible callable for `impl` (choose_sweep_impl).
    The kernel needs the layout's nonzero column tiles
    (core.problem.tile_columns)."""
    if impl == "xla":
        return run_sweeps
    from .sweeps_triton import triton_sweeps
    return functools.partial(triton_sweeps, col_idx=col_idx, counts=counts)
