"""Instance-ensemble NMC-PT: many instances x full NPT rounds, one program.

The reference benchmarks instance FAMILIES (50-100 edge-list files per
folder) by launching one Python process per instance. On an accelerator a
single chimera-512-sized NPT ladder uses a sliver of one device; the right
shape is
a leading `instance` axis batched (vmap) and/or sharded (mesh) on top of
the full swap-round body — sweeps, convexified-LBP backbone extraction,
heated/frozen NMC phases, and label-permutation replica exchange all run
for EVERY instance in ONE jitted scan. Zero cross-instance communication,
so it scales linearly over devices and hosts.

Requirements: instances must share the topology family (same spin count;
the coupling-pattern of instance 0 decides the coloring/blocking applied
to all — true for the reference's chimera/DCL/wishart folders).

This is the campaign engine behind scripts/campaign.py: per-instance
ground-state targets are checked host-side between scanned chunks, giving
per-instance time-to-solution from a single run.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import IsingProblem, block_problem
from ..ops.clusters import backbone_mask_device
from ..ops.lbp import lambda_ladder
from ..ops.lbp_jit import (convexified_marginal_dense,
                           convexified_marginal_sparse)
from ..ops.sweeps import layout_sweeps
from .sharded_pt import ShardedNPTConfig
from .swaps import metropolis_label_swap


class EnsembleNMCState(NamedTuple):
    m: jax.Array             # [I, R, n_pad]
    beta_to_slot: jax.Array  # [I, R]
    slot_to_beta: jax.Array  # [I, R]
    key: jax.Array
    round_index: jax.Array
    m_best: jax.Array        # [I, n_pad] best-ever state per instance
    e_best: jax.Array        # [I] best-ever energy per instance
    cl: jax.Array            # [I, R, n_pad] carried backbone masks
    do_nmc_slot: jax.Array   # [I, R] slots running NMC phases (frozen
                             # between cluster refreshes)


class EnsembleNMC:
    """Batched-instance NPT with NMC phases (single- or multi-device)."""

    def __init__(
        self,
        problems: Sequence[IsingProblem],
        beta_list: Sequence[float],
        doNMC: Sequence[bool],
        cfg: ShardedNPTConfig = ShardedNPTConfig(),
        mesh: Optional[Mesh] = None,
        axis_name: str = "instance",
    ):
        ns = {p.n for p in problems}
        if len(ns) != 1:
            # families like DCL ship instances whose max spin index varies
            # (removed couplers can isolate trailing spins): pad everything
            # to the family max — padded spins are free (zero couplings/h)
            # and contribute nothing to the energy
            n_max = max(ns)
            problems = [p if p.n == n_max else _pad_problem(p, n_max)
                        for p in problems]
        self.I = len(problems)
        self.axis = axis_name
        beta_list = np.asarray(beta_list, dtype=np.float64)
        self.R = beta_list.shape[0]
        self.doNMC = np.asarray(doNMC, dtype=bool)
        self.any_nmc = bool(self.doNMC.any())

        dtype = jnp.dtype(cfg.dtype)
        np_dtype = np.dtype(dtype.name)
        self._J_union = None
        groups = None
        if cfg.use_coloring:
            from ..ops.coloring import color_groups
            # color the UNION graph: instances are subgraphs of the family
            # topology, but any single instance may miss edges another one
            # has — a union coloring is valid for every member
            J_union = np.zeros_like(np.asarray(problems[0].J))
            for p in problems:
                J_union += np.abs(np.asarray(p.J))
            groups = color_groups(J_union)
        blocked = [block_problem(p, block_size=cfg.block_size, groups=groups,
                                 dtype=np_dtype) for p in problems]
        if blocked[0].colored:
            cfg = dataclasses.replace(cfg, within_block="jacobi")
        self.cfg = cfg
        self.blocked0 = blocked[0]
        self.n_pad = blocked[0].n_pad

        if mesh is None:
            devs = jax.devices()
            n_use = len(devs)
            while self.I % n_use:   # largest device count dividing I
                n_use -= 1
            mesh = Mesh(np.array(devs[:n_use]), (axis_name,))
        self.mesh = mesh
        n_dev = mesh.shape[axis_name]
        if self.I % n_dev != 0:
            raise ValueError(
                f"{self.I} instances must divide over {n_dev} devices")
        inst = NamedSharding(mesh, P(axis_name))

        self.J_rows = jax.device_put(
            jnp.stack([jnp.asarray(b.J_rows) for b in blocked]), inst)
        self.J_diag = jax.device_put(
            jnp.stack([jnp.asarray(b.J_diag) for b in blocked]), inst)
        self.h = jax.device_put(
            jnp.stack([jnp.asarray(b.h) for b in blocked]), inst)
        eps = np.stack([np.abs(b.h)
                        + np.abs(b.J_rows.reshape(b.n_pad, b.n_pad)).sum(1)
                        for b in blocked])
        self.epsilon = jax.device_put(jnp.asarray(eps, dtype), inst)
        self.active = jnp.asarray(blocked[0].active)
        self.beta_list = jnp.asarray(beta_list, dtype)
        self.do_nmc_by_beta = jnp.asarray(self.doNMC)
        self.ladder = tuple(lambda_ladder(cfg.lambda_start, cfg.lambda_end,
                                          cfg.lambda_reduction_factor))
        self._scan_jit = {}

        # sparse (edge-message) LBP over the UNION topology: one edge list
        # for the family, per-instance edge weights (absent edges carry
        # J=0 -> tanh(beta*0)=0 messages, a no-op). O(nnz) per iteration
        # instead of the dense [n_pad, n_pad] message matrices.
        self.edge_graph = None
        self.edge_w = None
        self.edge_slots = None
        if self.any_nmc and cfg.lbp_mode in ("planes", "auto"):
            # scatter-free slotted-edge LBP (ops/lbp_planes): the union
            # topology's static gathers become one-hot matmuls at
            # Precision.HIGHEST; per-instance couplings live in w[n, D]
            # slots. DEFAULT under 'auto' for bounded-degree families:
            # explicit 'planes' RAISES past
            # the degree cap (no-silent-fallback policy); 'auto' falls
            # through to the edge-list/dense routing below.
            from ..ops.lbp_planes import (build_edge_slot_planes,
                                          w_slot_from_tiles)
            col_idx_u, J_tiles_u = _union_tiles(blocked)
            try:
                esp = build_edge_slot_planes(
                    col_idx_u, np.any(J_tiles_u != 0, axis=0))
            except ValueError:
                if cfg.lbp_mode == "planes":
                    raise
                esp = None
            if esp is not None:
                self.edge_slots = esp
                w = np.stack([w_slot_from_tiles(esp, J_tiles_u[i])
                              for i in range(self.I)])
                self.edge_w = jax.device_put(jnp.asarray(w, dtype), inst)
        if (self.any_nmc and self.edge_slots is None
                and cfg.lbp_mode != "dense"):
            from ..ops.lbp_sparse import EdgeGraph
            J_sq = [np.asarray(b.J_rows).reshape(self.n_pad, self.n_pad)
                    for b in blocked]
            J_un = np.zeros((self.n_pad, self.n_pad))
            for Ji in J_sq:
                J_un += np.abs(Ji)
            density = (J_un != 0).mean()
            if cfg.lbp_mode == "sparse" or density < 0.05:
                g = EdgeGraph.from_dense(J_un)
                self.edge_graph = g
                si, di = np.asarray(g.src), np.asarray(g.dst)
                w = np.stack([Ji[si, di] for Ji in J_sq])
                self.edge_w = jax.device_put(jnp.asarray(w, dtype), inst)

        # the sweep stage goes through the one implementation choice
        # (ops.sweeps.choose_sweep_impl) over the family's union tiles
        self._sweeps = layout_sweeps(blocked, dtype)

    # ------------------------------------------------------------------
    def init_state(self, key, m0=None) -> EnsembleNMCState:
        """Random +-1 start.  `m0` (optional, [I, C, n] ORIGINAL spin
        order, ascending energy) seeds the C coldest chains — see
        EnsemblePT.init_state."""
        k_m, key = jax.random.split(key)
        u = jax.random.uniform(k_m, (self.I, self.R, self.n_pad),
                               dtype=self.h.dtype)
        m = jnp.where(u < 0.5, -1.0, 1.0).astype(self.h.dtype)
        if m0 is not None:
            m0 = self.blocked0.to_blocked(np.asarray(m0), fill=1.0)
            m0 = jnp.asarray(m0, self.h.dtype)
            C = m0.shape[1]
            if C > self.R:
                raise ValueError(f"m0 has {C} seeds > {self.R} replicas")
            m = m.at[:, self.R - C:, :].set(m0[:, ::-1, :])
        m = jnp.where(self.active, m, 1.0)
        inst = NamedSharding(self.mesh, P(self.axis))
        ids = jnp.broadcast_to(jnp.arange(self.R, dtype=jnp.int32),
                               (self.I, self.R))
        return EnsembleNMCState(
            m=jax.device_put(m, inst),
            beta_to_slot=ids, slot_to_beta=ids, key=key,
            round_index=jnp.int32(0),
            m_best=jax.device_put(jnp.ones((self.I, self.n_pad),
                                           self.h.dtype), inst),
            e_best=jax.device_put(jnp.full((self.I,), jnp.inf, self.h.dtype),
                                  inst),
            cl=jax.device_put(jnp.zeros((self.I, self.R, self.n_pad), bool),
                              inst),
            do_nmc_slot=jnp.broadcast_to(self.do_nmc_by_beta,
                                         (self.I, self.R)),
        )

    # ------------------------------------------------------------------
    def _lbp_marginal(self, J_full, h, epsilon, m_star):
        """Convexified LBP for one chain of one instance (dense, in-jit);
        vmapped over slots and instances by the round body. Shared body:
        ops/lbp_jit.convexified_marginal_dense
        (/root/reference/NMC/nmc.py:93-228)."""
        cfg = self.cfg
        return convexified_marginal_dense(
            J_full, h, epsilon, m_star,
            beta=cfg.global_beta, ladder=self.ladder,
            max_iterations=cfg.lbp_max_iterations,
            tolerance=cfg.lbp_tolerance)

    # ------------------------------------------------------------------
    def _lbp_marginal_sparse(self, w_e, h, epsilon, m_star):
        """Edge-message convexified LBP for one chain of one instance over
        the family's union edge list (per-instance weights w_e). Shared
        body: ops/lbp_jit.convexified_marginal_sparse; O(nnz)/iter."""
        cfg = self.cfg
        return convexified_marginal_sparse(
            self.edge_graph, w_e, h, epsilon, m_star,
            beta=cfg.global_beta, ladder=self.ladder,
            max_iterations=cfg.lbp_max_iterations,
            tolerance=cfg.lbp_tolerance)

    # ------------------------------------------------------------------
    def _lbp_marginal_planes(self, w_slot, h, epsilon, m_star):
        """Slotted-edge convexified LBP for one chain of one instance
        (per-instance slot couplings w_slot [n, D]). Shared body:
        ops/lbp_planes.convexified_marginal_planes — scatter-free, every
        static gather a one-hot matmul."""
        from ..ops.lbp_planes import convexified_marginal_planes
        cfg = self.cfg
        return convexified_marginal_planes(
            self.edge_slots, w_slot, h, epsilon, m_star,
            beta=cfg.global_beta, ladder=self.ladder,
            max_iterations=cfg.lbp_max_iterations,
            tolerance=cfg.lbp_tolerance)

    # ------------------------------------------------------------------
    def _build_round(self):
        cfg = self.cfg
        R, n_pad = self.R, self.n_pad
        dtype = self.h.dtype

        def extract_clusters(J_rows, w_e, h, epsilon, m, s2b):
            """Backbone masks for the k slots currently holding NMC labels
            (one instance). LBP only for those k states; masks scattered
            back by slot."""
            J_full = J_rows.reshape(n_pad, n_pad)
            act = jnp.broadcast_to(self.active, (R, n_pad))
            do_nmc = self.do_nmc_by_beta[s2b]
            k = int(self.doNMC.sum())
            nmc_slots = jnp.argsort(do_nmc)[-k:]          # [k]
            m_nmc = m[nmc_slots]                          # [k, n_pad]
            if self.edge_slots is not None:
                marg = jax.vmap(
                    lambda ms: self._lbp_marginal_planes(w_e, h, epsilon,
                                                         ms)
                )(m_nmc)
            elif self.edge_graph is not None:
                marg = jax.vmap(
                    lambda ms: self._lbp_marginal_sparse(w_e, h, epsilon,
                                                         ms)
                )(m_nmc)
            else:
                marg = jax.vmap(
                    lambda ms: self._lbp_marginal(J_full, h, epsilon, ms)
                )(m_nmc)
            cl_k = backbone_mask_device(
                marg, jnp.abs(J_full), cfg.threshold_initial,
                cfg.threshold_cutoff, cfg.threshold_step,
                active=act[:k], logits=True)
            cl = jnp.zeros((R, n_pad), bool).at[nmc_slots].set(cl_k) & act
            return cl, do_nmc

        def one_instance(J_rows, J_diag, h, epsilon,
                         m, b2s, s2b, mb, eb, cl, do_nmc,
                         key, round_index):
            J_full = J_rows.reshape(n_pad, n_pad)
            k_dev = jax.random.fold_in(key, round_index)
            k_swap = jax.random.fold_in(k_dev, jnp.uint32(0xD00D))

            # NMC slots sample at global_beta (the reference quirk,
            # npt.py:126); plain slots at their CURRENT label's beta. The
            # NMC-slot set is frozen between cluster refreshes (the
            # backbone belongs to the chain's state, not its label).
            beta_local = self.beta_list[s2b]
            base_row = jnp.where(do_nmc, jnp.asarray(cfg.global_beta, dtype),
                                 beta_local.astype(dtype))[:, None]
            act = jnp.broadcast_to(self.active, (R, n_pad))

            def phase(mm, kk, beta_spin, mask):
                phi = jnp.matmul(mm, J_full, precision=cfg.precision) + h
                return self._sweeps(
                    J_rows, J_diag, h, mm, phi, kk,
                    jnp.ones((cfg.sweeps_per_phase,), dtype), beta_spin,
                    mask, num_sweeps=cfg.sweeps_per_phase,
                    within_block=cfg.within_block, block_order="fixed",
                    record_m=False, precision=cfg.precision)

            def track(res, mb, eb):
                r = jnp.argmin(res.e_best)
                imp = res.e_best[r] < eb
                return (jnp.where(imp, res.m_best[r], mb),
                        jnp.where(imp, res.e_best[r], eb))

            for cycle in range(cfg.num_cycles):
                k_dev, kc, knc, kall = jax.random.split(k_dev, 4)
                heat = jnp.where(do_nmc[:, None] & cl,
                                 jnp.asarray(1.0 / cfg.temp_x, dtype), 1.0)
                res = phase(m, kc, base_row * heat,
                            jnp.where(do_nmc[:, None], cl & act, act))
                m = jnp.where(do_nmc[:, None], res.m_best, res.m)
                mb, eb = track(res, mb, eb)

                res = phase(m, knc, base_row,
                            jnp.where(do_nmc[:, None], (~cl) & act, act))
                m = jnp.where(do_nmc[:, None], res.m_best, res.m)
                mb, eb = track(res, mb, eb)

                if cycle % cfg.full_update_frequency == 0:
                    res = phase(m, kall, base_row, act)
                    m = jnp.where(do_nmc[:, None], res.m_best, res.m)
                    mb, eb = track(res, mb, eb)

            # carried-state energies for the swap test (see sharded_pt)
            phi_c = jnp.matmul(m, J_full, precision=cfg.precision)
            e_carried = -(0.5 * jnp.sum(m * phi_c, axis=-1)
                          + jnp.sum(m * h, axis=-1))
            swap = metropolis_label_swap(
                k_swap, b2s, self.beta_list.astype(jnp.float32),
                e_carried.astype(jnp.float32),
                num_pairs=cfg.num_swapping_pairs)
            return m, swap.beta_to_slot, swap.slot_to_beta, mb, eb

        def _refresh(J_rows, ew, h, epsilon, state: EnsembleNMCState):
            if self.any_nmc:
                # refresh backbone masks every lbp_every rounds — the
                # predicate is unbatched, so the cond stays a real branch
                # (LBP cost only paid on refresh rounds). `ew` arrives as
                # a jit ARG: the instance-sharded edge weights must not
                # be closed over in multi-process meshes.
                refresh = (state.round_index % cfg.lbp_every) == 0
                return jax.lax.cond(
                    refresh,
                    lambda: jax.vmap(extract_clusters)(
                        J_rows, ew, h, epsilon, state.m,
                        state.slot_to_beta),
                    lambda: (state.cl, state.do_nmc_slot))
            return state.cl, state.do_nmc_slot

        def _round(J_rows, J_diag, h, epsilon, ew,
                   state: EnsembleNMCState):
            cl, do_nmc = _refresh(J_rows, ew, h, epsilon, state)
            keys = jax.vmap(lambda i: jax.random.fold_in(state.key, i))(
                jnp.arange(self.I))
            m, b2s, s2b, mb, eb = jax.vmap(
                one_instance,
                in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None)
            )(J_rows, J_diag, h, epsilon, state.m,
              state.beta_to_slot, state.slot_to_beta,
              state.m_best, state.e_best, cl, do_nmc,
              keys, state.round_index)
            return EnsembleNMCState(
                m=m, beta_to_slot=b2s, slot_to_beta=s2b, key=state.key,
                round_index=state.round_index + 1, m_best=mb, e_best=eb,
                cl=cl, do_nmc_slot=do_nmc)

        return _round

    # ------------------------------------------------------------------
    def run_scanned(self, state: EnsembleNMCState, num_rounds: int):
        """num_rounds full ensemble rounds in ONE dispatch."""
        if num_rounds not in self._scan_jit:
            round_fn = self._build_round()

            def scanned(J_rows, J_diag, h, eps, ew, state0):
                def body(s, _):
                    return round_fn(J_rows, J_diag, h, eps, ew, s), None
                s, _ = jax.lax.scan(body, state0, None, length=num_rounds)
                return s

            self._scan_jit[num_rounds] = jax.jit(scanned)
        ew = (self.edge_w if self.edge_w is not None else
              jnp.zeros((self.I, 1), self.h.dtype))
        return self._scan_jit[num_rounds](self.J_rows, self.J_diag, self.h,
                                          self.epsilon, ew, state)

    def best(self, state: EnsembleNMCState):
        """([I] best f32 energies, [I, n] best states, original order)."""
        from .distributed import host_gather
        eb = host_gather(state.e_best)
        mb = host_gather(state.m_best)[:, np.asarray(self.blocked0.inv_perm)]
        return eb, mb


def _union_tiles(blocked):
    """Block-sparse tiles over the UNION sparsity pattern of a family:
    one [nB, K] column-tile index table valid for every instance (tiles a
    given instance lacks are zero there), per-instance [nB, K, B, B] tile
    stacks. Mirrors core.problem.block_sparse_tiles for a single instance."""
    nB, B = blocked[0].num_blocks, blocked[0].block_size
    nz_sets = [set() for _ in range(nB)]
    for bl in blocked:
        for b in range(nB):
            tiles = bl.J_rows[b].reshape(B, nB, B)
            nz = np.flatnonzero(np.any(tiles != 0, axis=(0, 2)))
            nz_sets[b].update(nz.tolist())
    K = max((len(s) for s in nz_sets), default=1) or 1
    col_idx = np.zeros((nB, K), np.int32)
    J_tiles = np.zeros((len(blocked), nB, K, B, B),
                       blocked[0].J_rows.dtype)
    for b, sset in enumerate(nz_sets):
        for k, j in enumerate(sorted(sset)):
            col_idx[b, k] = j
            for i, bl in enumerate(blocked):
                J_tiles[i, b, k] = bl.J_rows[b][:, j * B:(j + 1) * B]
    return col_idx, J_tiles


def _pad_problem(p: IsingProblem, n: int) -> IsingProblem:
    J = np.zeros((n, n))
    J[:p.n, :p.n] = np.asarray(p.J)
    h = np.zeros(n)
    h[:p.n] = np.asarray(p.h).reshape(-1)
    return IsingProblem(J, h, name=p.name)
