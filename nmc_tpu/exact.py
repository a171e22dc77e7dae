"""Exact ground states by meet-in-the-middle enumeration as matmuls.

Split the spins into halves A|B. With SA = all +-1 assignments of A
(2^a rows) and SB of B (2^b rows),

    E(sA, sB) = EA(sA) + EB(sB) + sA . J_AB . sB

so the full 2^n energy table is a rank-(a) matmul `SA @ J_AB @ SB^T`
plus broadcast row/column energies — exactly the shape a matrix unit
wants. The minimum over the table is the EXACT ground
state; no sampling, no tolerance. The reference has no exact solver —
its quality anchors are externally shipped ground truths; this module
lets the framework *verify* (and extend) those truths independently up
to n≈40 (the device tier).

Global spin-flip symmetry (E(-s) = E(s) for h = 0) pins the first A
spin to +1, halving the table.

Exactness in f32: every energy is an integer-weighted +-1 sum bounded
by `sum|J| + sum|h|`; if that bound is < 2^24, f32 arithmetic is exact.
Matmuls run at `Precision.HIGHEST`: a default-precision f32 matmul may
run in TF32 (10 mantissa bits), which corrupts integers > 2^11 — same
lesson as the matmul Houdayer label propagation, ops/clusters.py.

Tiers:
- `solve_exact_host`  — numpy, n <= ~34 (wall grows 2x per spin).
- `solve_exact_device`— jit + lax.scan over A-blocks x B-tiles; the
  energy table tiles stream through device memory (fine to n≈40).
- `solve_exact_chimera` (exact_chimera.py) — chimera layouts beyond.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["solve_exact_host", "solve_exact_device", "solve_exact_enum", "exact_energy_bound", "signs_table"]


def exact_energy_bound(J, h=None) -> float:
    """Upper bound on |any partial energy sum| — f32 is exact below 2^24."""
    b = 0.5 * float(np.abs(J).sum())
    if h is not None:
        b += float(np.abs(h).sum())
    return b


def signs_table(k: int, offset: int = 0, count: Optional[int] = None,
                dtype=np.float32) -> np.ndarray:
    """[count, k] +-1 rows: row r encodes integer (offset + r), bit j ->
    spin j (LSB first; bit set -> -1)."""
    if count is None:
        count = 1 << k
    r = np.arange(offset, offset + count, dtype=np.int64)
    bits = (r[:, None] >> np.arange(k)[None, :]) & 1
    return (1.0 - 2.0 * bits).astype(dtype)


def _split(J, h):
    n = J.shape[0]
    a = n // 2            # A: first a spins (streamed), B: resident
    return a, n - a


def _half_energies(Jhh, hh, S):
    """E_half(s) = -1/2 s.Jhh.s - hh.s for every row of S."""
    return (-0.5 * np.einsum("ri,ij,rj->r", S, Jhh, S) - S @ hh)


def solve_exact_host(prob, *, symmetry: Optional[bool] = None,
                     block: int = 4096) -> Tuple[float, np.ndarray]:
    """Exact ground state by blocked meet-in-the-middle on the host.

    Returns (energy, state) in raw units; energy is the true global
    minimum of E(s) = -1/2 s.J.s - h.s over {+-1}^n.
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    n = J.shape[0]
    if n > 34:
        raise ValueError(f"solve_exact_host is O(2^n): n={n} > 34 "
                         "(use solve_exact_device)")
    a, b = _split(J, h)
    if symmetry is None:
        symmetry = not np.any(h)
    JA, JB, JX = J[:a, :a], J[a:, a:], J[a:, :a]   # JX: [b, a]
    hA, hB = h[:a], h[a:]

    SB = signs_table(b, dtype=np.float64)
    EB = _half_energies(JB, hB, SB)
    CB = SB @ JX                                    # [2^b, a]

    total_a = 1 << (a - 1 if symmetry else a)       # s_0 pinned to +1
    best = (np.inf, 0, 0)
    for off in range(0, total_a, block):
        cnt = min(block, total_a - off)
        # pinned bit: enumerate the remaining a-1 bits, prepend +1
        if symmetry:
            SA = np.concatenate(
                [np.ones((cnt, 1)), signs_table(a - 1, off, cnt,
                                                np.float64)], axis=1)
        else:
            SA = signs_table(a, off, cnt, np.float64)
        EA = _half_energies(JA, hA, SA)
        # E table tile: [cnt, 2^b]; cross term = -SA . JX^T . SB^T
        T = EA[:, None] + EB[None, :] - SA @ CB.T
        i = np.unravel_index(np.argmin(T), T.shape)
        if T[i] < best[0]:
            best = (float(T[i]), off + int(i[0]), int(i[1]))
    e, ra, rb = best
    if symmetry:
        sA = np.concatenate([[1.0], signs_table(a - 1, ra, 1,
                                                np.float64)[0]])
    else:
        sA = signs_table(a, ra, 1, np.float64)[0]
    sB = signs_table(b, rb, 1, np.float64)[0]
    s = np.concatenate([sA, sB])
    assert abs(float(prob.energy(s)) - e) < 1e-6 * max(1.0, abs(e))
    return e, s


def _b_tables(J, h, a, b, block=1 << 18, dtype=np.float32):
    """EB [2^b] and CBT [a, 2^b], built in blocks so the f64 sign tables
    never exceed `block` rows. Default f32 storage is exact for integer
    values < 2^24; the int8-plane path passes dtype=f64 so values up to
    its 2^29 window survive the stopover (f32 would drop low bits)."""
    JB, JX, hB = J[a:, a:], J[a:, :a], h[a:]
    EB = np.empty(1 << b, dtype)
    CBT = np.empty((a, 1 << b), dtype)
    for off in range(0, 1 << b, block):
        cnt = min(block, (1 << b) - off)
        SB = signs_table(b, off, cnt, np.float64)
        EB[off:off + cnt] = _half_energies(JB, hB, SB)
        CBT[:, off:off + cnt] = (SB @ JX).T
    return EB, CBT


def solve_exact_device(prob, *, symmetry: Optional[bool] = None,
                       block_a: int = 1024, block_b: int = 1 << 15,
                       verify: bool = True) -> Tuple[float, np.ndarray]:
    """Exact ground state on the accelerator: the B-side tables (EB,
    CBT = SB.JX^T) live in device memory; a double lax.scan streams (A-block x
    B-tile) energy tiles, each one Precision.HIGHEST matmul with an
    immediate min/argmin epilogue.

    Practical to n≈40 (each energy tile makes a device-memory round
    trip). f32 exactness is guarded via `exact_energy_bound` < 2^24.
    Indices are i32 (fine to n=64: each half-table index < 2^31).
    """
    import jax
    import jax.numpy as jnp

    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    n = J.shape[0]
    if exact_energy_bound(J, h) >= float(1 << 24):
        raise ValueError("coupling magnitudes too large for exact f32 "
                         "meet-in-the-middle (bound >= 2^24); rescale or "
                         "use the host path")
    a, b = _split(J, h)
    if symmetry is None:
        symmetry = not np.any(h)
    abits = a - 1 if symmetry else a
    total_a = 1 << abits
    block_a = min(block_a, total_a)
    block_b = min(block_b, 1 << b)
    num_a = (total_a + block_a - 1) // block_a
    num_b = (1 << b) // block_b

    EB_h, CBT_h = _b_tables(J, h, a, b)
    EB = jnp.asarray(EB_h)
    CBT = jnp.asarray(CBT_h)
    JA32 = jnp.asarray(J[:a, :a], jnp.float32)
    hA32 = jnp.asarray(h[:a], jnp.float32)

    def a_signs(off):                         # traced [block_a, a] +-1 f32
        r = off + jnp.arange(block_a, dtype=jnp.int32)
        bits = (r[:, None] >> jnp.arange(abits, dtype=jnp.int32)) & 1
        S = 1.0 - 2.0 * bits.astype(jnp.float32)
        if symmetry:
            S = jnp.concatenate([jnp.ones((block_a, 1), jnp.float32), S],
                                axis=1)
        return S

    @jax.jit
    def scan_all():
        def a_step(carry, off):
            SA = a_signs(off)
            EA = (-0.5 * jnp.einsum(
                "ri,ij,rj->r", SA, JA32, SA,
                precision=jax.lax.Precision.HIGHEST)
                  - jnp.dot(SA, hA32, precision=jax.lax.Precision.HIGHEST))
            valid = (off + jnp.arange(block_a, dtype=jnp.int32)) < total_a
            EA = jnp.where(valid, EA, jnp.float32(jnp.inf))

            def b_step(c, jb):
                boff = jb * block_b
                ebt = jax.lax.dynamic_slice(EB, (boff,), (block_b,))
                cbt = jax.lax.dynamic_slice(
                    CBT, (jnp.int32(0), boff), (a, block_b))
                T = (EA[:, None] + ebt[None, :]
                     - jnp.dot(SA, cbt,
                               precision=jax.lax.Precision.HIGHEST))
                flat = jnp.argmin(T).astype(jnp.int32)
                ia = flat // jnp.int32(block_b)
                ib = flat % jnp.int32(block_b)
                e = T[ia, ib]
                best_e, best_ra, best_rb = c
                better = e < best_e
                return ((jnp.where(better, e, best_e),
                         jnp.where(better, off + ia, best_ra),
                         jnp.where(better, boff + ib, best_rb)), None)

            carry, _ = jax.lax.scan(b_step, carry,
                                    jnp.arange(num_b, dtype=jnp.int32))
            return carry, None

        offs = jnp.arange(num_a, dtype=jnp.int32) * block_a
        init = (jnp.float32(jnp.inf), jnp.int32(0), jnp.int32(0))
        (e, ra, rb), _ = jax.lax.scan(a_step, init, offs)
        return e, ra, rb

    e, ra, rb = jax.device_get(scan_all())
    if symmetry:
        sA = np.concatenate([[1.0], signs_table(abits, int(ra), 1,
                                                np.float64)[0]])
    else:
        sA = signs_table(a, int(ra), 1, np.float64)[0]
    sB = signs_table(b, int(rb), 1, np.float64)[0]
    s = np.concatenate([sA, sB])
    e64 = float(prob.energy(s))            # f64 re-verification on host
    if verify:
        assert abs(e64 - float(e)) <= 1e-3 * max(1.0, abs(e64)), \
            f"device/host energy mismatch: {e} vs {e64}"
    return e64, s


def solve_exact_enum(prob, *, incumbent: Optional[np.ndarray] = None,
                     max_nodes: int = 0,
                     dm_starts: int = 512, dm_iters: int = 800,
                     seed: int = 0):
    """Exact ground state (with PROOF) by native branch-and-bound
    enumeration — the CPU-side tier, no accelerator needed.

    E(s) = c0 + 1/2 ||M s||^2 exactly, with M = diag(sqrt(lmax - w)) V^T
    from the eigendecomposition of J (the h != 0 case is not supported —
    fold fields via an ancilla spin upstream if needed). A QR of M (heavy
    pivot columns enumerated first) turns accumulated row norms into
    exact bounds; the native DFS (native/enum.cpp) beats-or-proves the
    incumbent. Returns (energy, state, proved): `proved` means the tree
    was exhausted, so `energy` is the true global minimum.

    Unlike the meet-in-the-middle tiers the cost is instance-dependent
    (golf-course landscapes with big spectral gaps prune ferociously);
    `max_nodes` caps the search (0 = unbounded), returning proved=False
    when hit.
    """
    import scipy.linalg as sla

    from .native import exact_enumerate
    from .ops.spectral import batched_descent_host, spectral_search

    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    if np.any(h):
        raise ValueError("solve_exact_enum requires h = 0 (spin-flip "
                         "symmetric form); fold fields into an ancilla "
                         "spin first")
    n = J.shape[0]
    w, v = np.linalg.eigh(J)
    lmax = float(w[-1])
    c0 = -0.5 * lmax * n
    M = np.sqrt(np.maximum(lmax - w, 0.0))[:, None] * v.T

    if incumbent is None:
        r = spectral_search(prob, dm_starts=dm_starts, dm_iters=dm_iters,
                            polish=8, seed=seed)
        incumbent = r.best_state
    incumbent = np.where(np.asarray(incumbent, np.float64) >= 0, 1., -1.)
    e_inc = float(prob.energy(incumbent))

    # heavy pivots first in enumeration order (R diagonal increasing)
    _, _, piv = sla.qr(M, pivoting=True)
    order = piv[::-1].copy()
    _, R = sla.qr(M[:, order], mode="economic")
    A = np.abs(R)
    W = np.zeros_like(R)
    for k in range(n):
        W[k, k + 1:] = np.cumsum(A[k, k:-1])

    r2 = 2.0 * (e_inc - c0)
    found, z, best_r2, nodes, complete = exact_enumerate(
        R, W, r2, max_nodes=max_nodes)
    if found:
        s = np.empty(n)
        s[order] = z
        e = float(prob.energy(s))
        # enumeration improved the incumbent; exhausted tree = proof
        return e, s, complete
    return e_inc, incumbent, complete
