"""Pallas kernel (Triton route): multi-sweep colored-block heat-bath Gibbs.

Kernel scope: the COLORED (block-Jacobi) sweep, which is exact heat-bath
Gibbs when each spin block is an independent set (graph-colored layouts
from ops/coloring.py — Chimera/EA/DCL-style sparse topologies, BASELINE
config 4). Everything else runs on the XLA engine (ops/sweeps.py), which
issues a GEMM plus slice/update fusions per color block per sweep.

Layout of the kernel:
  * grid: one program per replica tile of `r_tile` chains (a power of
    two >= 16, the smallest `tl.dot` height). Sweeps and color blocks loop
    INSIDE the program, so one `engine.run` is one launch.
  * state: the tile's m and phi live in the output buffers (device memory;
    at the benchmark shapes the whole state and the touched J tiles stay
    in L2). A CTA barrier separates color blocks, because the next block
    reads phi columns that other threads of the program just wrote.
  * update: block b runs heat-bath on its [r_tile, B] slice, then
    phi[:, c] += dm @ J[b, c] over the nonzero column tiles c of row block
    b only (core.problem.tile_columns), so sparse topologies pay for
    their couplings and not for n_pad.
  * random numbers: a counter-based hash of (two seed words, sweep, global
    replica, spin) gives 24-bit uniforms. `hash_uniform` is plain jnp and
    runs unchanged inside the kernel and outside it, so tests replay the
    kernel's draws exactly.
  * precision: Triton's f32 dot defaults to TF32; `precision="highest"`
    lowers to an IEEE f32 dot, which keeps the sampled Hamiltonian the
    loaded instance.
  * tiling: r_tile 16 with 8 warps measured fastest on an H100 at both
    benchmark shapes; fewer warps or taller tiles spill registers.

Heat-bath rule matches /root/reference/NMC/nmc.py:87.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .sweeps import SweepResult

_GOLDEN = 0x9E3779B9
_NUM_WARPS = 8      # see the module docstring, "tiling"


def _mix32(x):
    """lowbias32 integer finalizer: a uint32 -> uint32 bijection."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def hash_uniform(seed0, seed1, t, row, col, n_pad):
    """Uniform [0, 1) draws with 24 random bits for (sweep t, replica row,
    spin col). seed0/seed1/t are scalars; row/col broadcast against each
    other. Same jnp code in the kernel and in the tests."""
    t = jnp.asarray(t).astype(jnp.uint32)
    k = _mix32(jnp.asarray(seed1, jnp.uint32)
               ^ _mix32(jnp.asarray(seed0, jnp.uint32)
                        + t * jnp.uint32(_GOLDEN)))
    c = (jnp.asarray(row).astype(jnp.uint32) * jnp.uint32(n_pad)
         + jnp.asarray(col).astype(jnp.uint32))
    bits = _mix32(_mix32(c ^ k) + k)
    top = lax.bitcast_convert_type(bits >> 8, jnp.int32)
    return top.astype(jnp.float32) * jnp.float32(2.0 ** -24)


def seed_words(key) -> jax.Array:
    """Two uint32 seed words from a PRNG key."""
    return jax.random.bits(key, (2,), jnp.uint32)


def _prec(p):
    if isinstance(p, lax.Precision):
        return p
    return {"default": lax.Precision.DEFAULT,
            "high": lax.Precision.HIGH,
            "highest": lax.Precision.HIGHEST}[str(p)]


def _kernel(num_sweeps, nB, K, B, RT, n_pad, precision, barrier,
            seed_ref, beta_ref, cnt_ref, col_ref, J_ref, h_ref, bs_ref,
            mask_ref, m0_ref, phi0_ref,
            m_ref, phi_ref, mbest_ref, ebest_ref, e_ref):
    g = pl.program_id(0)
    r0 = pl.multiple_of(g * RT, RT)
    rows = pl.ds(r0, RT)
    row_id = r0 + lax.broadcasted_iota(jnp.int32, (RT, 1), 0)
    seed0, seed1 = seed_ref[0], seed_ref[1]
    bs_rows = pl.ds(0, 1) if bs_ref.shape[0] == 1 else rows
    mask_rows = pl.ds(0, 1) if mask_ref.shape[0] == 1 else rows

    def sync():
        if barrier:
            plgpu.debug_barrier()

    def init(b, c):
        cols = pl.ds(pl.multiple_of(b * B, B), B)
        m = m0_ref[rows, cols]
        m_ref[rows, cols] = m
        mbest_ref[rows, cols] = m
        phi_ref[rows, cols] = phi0_ref[rows, cols]
        return c

    lax.fori_loop(0, nB, init, 0)
    sync()

    def sweep(t, ebest):
        beta_t = beta_ref[t]

        def block(b, c):
            s = pl.multiple_of(b * B, B)
            cols = pl.ds(s, B)
            x = phi_ref[rows, cols]
            mb = m_ref[rows, cols]
            betab = beta_t * bs_ref[bs_rows, cols]
            keep = mask_ref[mask_rows, cols] > 0
            col_id = s + lax.broadcasted_iota(jnp.int32, (1, B), 1)
            u = hash_uniform(seed0, seed1, t, row_id, col_id, n_pad)
            p_up = 0.5 * (1.0 + jnp.tanh(betab * x))
            new = jnp.where(u < p_up, 1.0, -1.0).astype(jnp.float32)
            new = jnp.where(keep, new, mb)
            dm = new - mb
            m_ref[rows, cols] = new

            def tile(k, c2):
                c0 = pl.multiple_of(col_ref[b * K + k] * B, B)
                tcols = pl.ds(c0, B)
                upd = jnp.dot(dm, J_ref[cols, tcols], precision=precision,
                              preferred_element_type=jnp.float32)
                phi_ref[rows, tcols] = phi_ref[rows, tcols] + upd
                return c2

            lax.fori_loop(0, cnt_ref[b], tile, 0)
            sync()
            return c

        lax.fori_loop(0, nB, block, 0)

        def energy(b, acc):
            cols = pl.ds(pl.multiple_of(b * B, B), B)
            m = m_ref[rows, cols]
            return acc + jnp.sum(m * (phi_ref[rows, cols]
                                      + h_ref[pl.ds(0, 1), cols]), axis=1)

        e = -0.5 * lax.fori_loop(0, nB, energy,
                                 jnp.zeros((RT,), jnp.float32))
        e_ref[t, rows] = e
        better = (e < ebest)[:, None]

        def keep_best(b, c):
            cols = pl.ds(pl.multiple_of(b * B, B), B)
            mbest_ref[rows, cols] = jnp.where(better, m_ref[rows, cols],
                                              mbest_ref[rows, cols])
            return c

        lax.fori_loop(0, nB, keep_best, 0)
        sync()
        return jnp.where(e < ebest, e, ebest)

    ebest = lax.fori_loop(0, num_sweeps, sweep,
                          jnp.full((RT,), jnp.inf, jnp.float32))
    ebest_ref[rows] = ebest


@functools.partial(
    jax.jit,
    static_argnames=("num_sweeps", "block_size", "r_tile", "precision",
                     "interpret"),
)
def triton_colored_sweeps(
    J,            # [n_pad, n_pad] float32, colored layout (zero diag blocks)
    col_idx,      # [nB, K] int32 nonzero column tiles per row block
    counts,       # [nB] int32 number of valid entries of col_idx rows
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad] cached local fields for m0
    seed,         # [2] uint32 (seed_words)
    beta_sweep,   # scalar | [T]
    beta_spin,    # broadcastable to [R, n_pad]
    update_mask,  # broadcastable to [R, n_pad] bool; False = frozen
    *,
    num_sweeps: int,
    block_size: int = 128,
    r_tile: int = 16,
    precision: str = "highest",
    interpret: bool = False,
) -> SweepResult:
    """Colored multi-sweep heat-bath kernel; same results contract as
    ops.sweeps.run_sweeps(within_block='jacobi', block_order='fixed')."""
    n_pad = J.shape[0]
    B = block_size
    R = m0.shape[0]
    if n_pad % B or B < 16 or B & (B - 1):
        raise ValueError(f"block_size={B} must be a power of two >= 16 "
                         f"dividing n_pad={n_pad}")
    if r_tile < 16 or r_tile & (r_tile - 1):
        raise ValueError(f"r_tile={r_tile} must be a power of two >= 16")
    nB, K = col_idx.shape
    R_pad = -(-R // r_tile) * r_tile
    pad = R_pad - R

    def rows_of(x, fill):
        # [1, n_pad] when replica-uniform, else [R_pad, n_pad]
        x = jnp.asarray(x, jnp.float32)
        x = x.reshape((1,) * max(0, 2 - x.ndim) + x.shape)
        if x.shape[0] == 1:
            return jnp.broadcast_to(x, (1, n_pad))
        x = jnp.broadcast_to(x, (R, n_pad))
        return jnp.pad(x, ((0, pad), (0, 0)), constant_values=fill)

    bs = rows_of(beta_spin, 1.0)
    mask = rows_of(jnp.asarray(update_mask, jnp.float32), 0.0)
    m0p = jnp.pad(jnp.asarray(m0, jnp.float32), ((0, pad), (0, 0)),
                  constant_values=1.0)
    phi0p = jnp.pad(jnp.asarray(phi0, jnp.float32), ((0, pad), (0, 0)))

    kern = functools.partial(_kernel, num_sweeps, nB, K, B, r_tile, n_pad,
                             _prec(precision), not interpret)
    state = jax.ShapeDtypeStruct((R_pad, n_pad), jnp.float32)
    m, phi, m_best, e_best, energies = pl.pallas_call(
        kern,
        grid=(R_pad // r_tile,),
        out_shape=(state, state, state,
                   jax.ShapeDtypeStruct((R_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((num_sweeps, R_pad), jnp.float32)),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="colored_sweeps",
    )(
        jnp.asarray(seed, jnp.uint32).reshape(2),
        jnp.broadcast_to(jnp.asarray(beta_sweep, jnp.float32),
                         (num_sweeps,)),
        jnp.asarray(counts, jnp.int32),
        jnp.asarray(col_idx, jnp.int32).reshape(-1),
        jnp.asarray(J, jnp.float32),
        jnp.asarray(h, jnp.float32).reshape(1, n_pad),
        bs, mask, m0p, phi0p,
    )
    return SweepResult(m=m[:R], phi=phi[:R], m_best=m_best[:R],
                       e_best=e_best[:R], energies=energies[:, :R], M=None)


def triton_sweeps(J_rows, J_diag, h, m0, phi0, key, beta_sweep, beta_spin,
                  update_mask, sparse_tiles=None, *, num_sweeps: int,
                  within_block: str = "jacobi", block_order: str = "fixed",
                  record_m: bool = False, precision: str = "highest",
                  col_idx, counts) -> SweepResult:
    """ops.sweeps.run_sweeps signature on top of the kernel (the column
    tiles come bound by ops.sweeps.sweep_fn)."""
    del J_diag, sparse_tiles, within_block, block_order, record_m
    nB, B, n_pad = J_rows.shape
    return triton_colored_sweeps(
        J_rows.reshape(n_pad, n_pad), col_idx, counts, h, m0, phi0,
        seed_words(key), beta_sweep, beta_spin, update_mask,
        num_sweeps=num_sweeps, block_size=B, precision=precision)
