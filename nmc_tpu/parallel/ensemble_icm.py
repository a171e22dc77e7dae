"""Instance-ensemble APT+ICM: the Houdayer baseline at campaign scale.

Batched analogue of models/apt_icm.py (the reference's serial
num_replicas x 10 sub-replica double loop, /root/reference/NPT/apt_ICM.py:
197-246): every (instance, replica, sub-replica) chain is one batch lane,
and each round — Gibbs sweeps, random same-temperature sub-replica pairing,
device Houdayer cluster exchanges with Katzgraber's big-cluster flip, and
per-sub-replica Metropolis label swaps — runs fully in-jit for ALL
instances at once (lax.scan over rounds, zero cross-instance traffic).

The Houdayer move uses the exact fixed-point label propagation — by
default the matmul path over one-hot neighbor planes
(ops/clusters.houdayer_move_matmul) when the family's max degree allows
it, else the edge-list segment_min path (houdayer_move_sparse) over
per-instance edge lists padded to a common length (dummy edges connect
padded always-agreeing spins, so they can never activate). The blocked
union-tile masked-min variant stays as an explicit opt-in
(houdayer="blocked"). All variants reach the same fixed point, so the
trajectory is backend-invariant. The move feeds back into the chains
(the physically
intended ICM; the reference's record-only quirk, apt_ICM.py:243-246, is a
faithfulness concern for models/apt_icm.py, not for this solver arm).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import IsingProblem, block_problem
from ..ops.clusters import houdayer_move_blocked, houdayer_move_sparse
from ..ops.sweeps import layout_sweeps
from .swaps import metropolis_label_swap


@dataclasses.dataclass
class EnsembleICMConfig:
    sweeps_per_round: int = 32
    num_subreplicas: int = 10        # reference hardcodes 10 (apt_ICM.py:177)
    use_katzgraber: bool = True
    num_swapping_pairs: int = 1
    block_size: int = 128
    use_coloring: bool = False
    within_block: str = "sequential"
    precision: str = "highest"
    dtype: str = "float32"
    houdayer: str = "auto"       # label-propagation backend for the
                                 # exchange move: 'auto' (the matmul
                                 # path via one-hot neighbor planes when
                                 # the family's max degree allows it,
                                 # else edge-list segment_min),
                                 # 'matmul' (force;
                                 # raises if the degree cap fails),
                                 # 'blocked' (tile masked-min), 'sparse'
                                 # (edge-list segment_min). All four are
                                 # exact fixed points: same key -> same
                                 # move, trajectory-invariant.
    # --- hybrid ICM+NMC arm: disagreement-seeded heated phases ---------
    # hybrid_cold > 0 turns the sweep stage of the hybrid_cold COLDEST
    # temperatures' paired chains into NMC-style cycles (heat cluster at
    # temp_x, refreeze, full sweep) whose cluster mask is the Houdayer
    # DISAGREEMENT SET of the sub-replica pair (s1 != s2) — the move
    # engine of /root/reference/NMC/nmc.py:320-440 driven by the cluster
    # source of /root/reference/NPT/apt_ICM.py:116-143 instead of LBP
    # backbones. Masks refresh each round from the post-sweep pair states
    # and apply in the NEXT round's sweep stage (carried, like
    # EnsembleNMC's lbp_every masks).
    hybrid_cold: int = 0
    temp_x: float = 20.0
    num_cycles: int = 1          # NMC cycles per round when hybrid is on
    max_heat_frac: float = 0.5   # skip heating when the disagreement set
                                 # exceeds this fraction of active spins
                                 # (mirrors the Katzgraber big-cluster cut)


class EnsembleICMState(NamedTuple):
    m: jax.Array             # [I, S, R, n_pad] chains (slot-major per sub)
    beta_to_slot: jax.Array  # [I, S, R] label perm per (instance, sub)
    slot_to_beta: jax.Array  # [I, S, R]
    key: jax.Array
    round_index: jax.Array
    m_best: jax.Array        # [I, n_pad]
    e_best: jax.Array        # [I]
    icm_moves: jax.Array     # [I] cumulative cluster exchanges
    icm_flips: jax.Array     # [I] cumulative Katzgraber flips
    cl: jax.Array            # [I, S, R, n_pad] carried disagreement masks
    dn: jax.Array            # [I, S, R] chains running heated NMC phases


class EnsembleICM:
    def __init__(
        self,
        problems: Sequence[IsingProblem],
        beta_list: Sequence[float],
        cfg: EnsembleICMConfig = EnsembleICMConfig(),
        mesh: Optional[Mesh] = None,
        axis_name: str = "instance",
    ):
        from .ensemble_nmc import _pad_problem
        ns = {p.n for p in problems}
        if len(ns) != 1:
            n_max = max(ns)
            problems = [p if p.n == n_max else _pad_problem(p, n_max)
                        for p in problems]
        self.I = len(problems)
        self.axis = axis_name
        beta_list = np.asarray(beta_list, dtype=np.float64)
        self.R = beta_list.shape[0]
        self.S = cfg.num_subreplicas

        dtype = jnp.dtype(cfg.dtype)
        np_dtype = np.dtype(dtype.name)
        groups = None
        if cfg.use_coloring:
            from ..ops.coloring import color_groups
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
        if not 0 <= cfg.hybrid_cold <= self.R:
            raise ValueError(f"hybrid_cold={cfg.hybrid_cold} must be in "
                             f"[0, R={self.R}]")
        self._cycles = cfg.num_cycles if cfg.hybrid_cold > 0 else 1
        if cfg.hybrid_cold > 0 and cfg.sweeps_per_round % (3 * self._cycles):
            # with hybrid on the sweep stage splits the round into 3
            # phases per cycle — a non-divisible budget would silently
            # floor (or zero) the sweep count. Pure ICM runs one unsplit
            # sweep call.
            raise ValueError(
                f"sweeps_per_round={cfg.sweeps_per_round} must be a "
                f"multiple of 3*num_cycles={3 * self._cycles} when "
                f"hybrid_cold > 0")
        # the hybrid_cold COLDEST temperatures (largest beta) get heated
        # phases; a static bool-by-temperature vector
        cold_t = np.zeros(self.R, bool)
        if cfg.hybrid_cold > 0:
            cold_t[np.argsort(beta_list)[-cfg.hybrid_cold:]] = True
        self.cold_t = jnp.asarray(cold_t)

        if mesh is None:
            devs = jax.devices()
            n_use = len(devs)
            while self.I % n_use:
                n_use -= 1
            mesh = Mesh(np.array(devs[:n_use]), (axis_name,))
        self.mesh = mesh
        inst = NamedSharding(mesh, P(axis_name))

        self.J_rows = jax.device_put(
            jnp.stack([jnp.asarray(b.J_rows) for b in blocked]), inst)
        self.J_diag = jax.device_put(
            jnp.stack([jnp.asarray(b.J_diag) for b in blocked]), inst)
        self.h = jax.device_put(
            jnp.stack([jnp.asarray(b.h) for b in blocked]), inst)
        self.active = jnp.asarray(blocked[0].active)
        self.beta_list = jnp.asarray(beta_list, dtype)

        # per-instance edge lists in the BLOCKED layout, padded to a common
        # length with dummy self-edges on a padded (always +1) spin
        srcs, dsts = [], []
        for b in blocked:
            Jb = b.J_rows.reshape(b.n_pad, b.n_pad)
            iu, ju = np.nonzero(np.triu(Jb, 1))
            srcs.append(np.concatenate([iu, ju]))
            dsts.append(np.concatenate([ju, iu]))
        E_max = max(s.shape[0] for s in srcs)
        pad_node = self.n_pad - 1   # padded spin (active mask False there)
        src = np.full((self.I, E_max), pad_node, np.int32)
        dst = np.full((self.I, E_max), pad_node, np.int32)
        for i, (s_, d_) in enumerate(zip(srcs, dsts)):
            src[i, :s_.shape[0]] = s_
            dst[i, :d_.shape[0]] = d_
        self.src = jax.device_put(jnp.asarray(src), inst)
        self.dst = jax.device_put(jnp.asarray(dst), inst)
        self._scan_jit = {}

        from .ensemble_nmc import _union_tiles
        if cfg.houdayer not in ("auto", "matmul", "blocked", "sparse"):
            raise ValueError(f"houdayer must be auto|matmul|blocked|"
                             f"sparse, got {cfg.houdayer!r}")
        # max node degree across instances (from the real, pre-padding
        # edge lists): gates the matmul neighbor-plane path
        deg_max = 0
        for d_ in dsts:
            if d_.shape[0]:
                deg_max = max(deg_max, int(np.bincount(
                    d_, minlength=self.n_pad).max()))
        matmul_ok = 0 < deg_max <= 16 and self.n_pad <= 65536
        if cfg.houdayer == "matmul" and not matmul_ok:
            raise ValueError(
                f"houdayer='matmul' needs max node degree <= 16 and "
                f"n_pad <= 65536 (got degree {deg_max}, n_pad "
                f"{self.n_pad}); use 'sparse' for dense instances")
        want_planes = (cfg.houdayer == "matmul"
                       or (cfg.houdayer == "auto" and matmul_ok))
        self._houd_tiles = None   # (col_idx, J_tiles) for the blocked
        #                           Houdayer label propagation
        self._houd_planes = None  # (gather [nB,K,nB] f32 shared,
        #                           planes [I,nB,D,B,K*B+1] bf16) for the
        #                           matmul label propagation
        if cfg.houdayer == "blocked" or want_planes:
            col_idx, J_tiles = _union_tiles(blocked)
            tiles = (jnp.asarray(col_idx),
                     jax.device_put(jnp.asarray(J_tiles), inst))
            if cfg.houdayer == "blocked":
                # explicit opt-in only; 'auto' prefers the matmul planes
                self._houd_tiles = tiles
            if want_planes:
                from ..ops.clusters import build_neighbor_planes
                pls = [build_neighbor_planes(col_idx, J_tiles[i],
                                             degree=deg_max)
                       for i in range(self.I)]
                self._houd_planes = (
                    jnp.asarray(pls[0].gather),
                    jax.device_put(jnp.asarray(
                        np.stack([np.asarray(p.planes) for p in pls])),
                        inst))
        # the sweep stage goes through the one implementation choice
        # (ops.sweeps.choose_sweep_impl) over the family's union tiles
        self._sweeps = layout_sweeps(blocked, dtype)

    # ------------------------------------------------------------------
    def init_state(self, key, m0=None) -> EnsembleICMState:
        """Random +-1 start.  `m0` (optional, [I, C, n] ORIGINAL spin
        order, ascending energy) seeds the C coldest chains of
        SUBREPLICA 0 only — subreplica 1 stays random so the Houdayer
        pairs start with non-empty disagreement sets."""
        k_m, key = jax.random.split(key)
        I, S, R, n_pad = self.I, self.S, self.R, self.n_pad
        u = jax.random.uniform(k_m, (I, S, R, n_pad), dtype=self.h.dtype)
        m = jnp.where(u < 0.5, -1.0, 1.0).astype(self.h.dtype)
        if m0 is not None:
            m0 = self.blocked0.to_blocked(np.asarray(m0), fill=1.0)
            m0 = jnp.asarray(m0, self.h.dtype)
            C = m0.shape[1]
            if C > R:
                raise ValueError(f"m0 has {C} seeds > {R} replicas")
            m = m.at[:, 0, R - C:, :].set(m0[:, ::-1, :])
        m = jnp.where(self.active, m, 1.0)
        inst = NamedSharding(self.mesh, P(self.axis))
        ids = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32), (I, S, R))
        z = jnp.zeros((I,), jnp.int32)
        return EnsembleICMState(
            m=jax.device_put(m, inst), beta_to_slot=ids, slot_to_beta=ids,
            key=key, round_index=jnp.int32(0),
            m_best=jax.device_put(jnp.ones((I, n_pad), self.h.dtype), inst),
            e_best=jax.device_put(jnp.full((I,), jnp.inf, self.h.dtype),
                                  inst),
            icm_moves=z, icm_flips=z,
            # pure ICM carries dummy [I,1,1,1] masks: full-size zeros in
            # the scan carry would only inflate the per-round program
            cl=jax.device_put(
                jnp.zeros((I, S, R, n_pad) if self.cfg.hybrid_cold > 0
                          else (I, 1, 1, 1), bool), inst),
            dn=jax.device_put(
                jnp.zeros((I, S, R) if self.cfg.hybrid_cold > 0
                          else (I, 1, 1), bool), inst))

    # ------------------------------------------------------------------
    def _build_round(self):
        cfg = self.cfg
        R, S, n_pad = self.R, self.S, self.n_pad
        dtype = self.h.dtype

        def sweep_stage(J_rows, J_diag, h, m, s2b, mb, eb, cl, dn, key,
                        round_index):
            """Sweep stage for ONE instance (vmapped). With
            hybrid_cold=0 this is one plain sweep call; with hybrid
            on it mirrors EnsembleNMC's heat/refreeze/full cycle, with
            the carried disagreement masks as clusters and each chain's
            OWN label temperature as base (no global_beta quirk: hybrid
            chains stay honest PT chains)."""
            J_full = J_rows.reshape(n_pad, n_pad)
            k = jax.random.fold_in(key, round_index)
            k_sw, _ = jax.random.split(k)
            act = jnp.broadcast_to(self.active, (S * R, n_pad))
            beta_chain = self.beta_list[s2b].astype(dtype)  # [S, R]
            flat = m.reshape(S * R, n_pad)

            def track(res, mb, eb):
                r_best = jnp.argmin(res.e_best)
                imp = res.e_best[r_best] < eb
                return (jnp.where(imp, res.m_best[r_best], mb),
                        jnp.where(imp, res.e_best[r_best], eb))

            if cfg.hybrid_cold == 0:
                phi = jnp.matmul(flat, J_full, precision=cfg.precision) + h
                res = self._sweeps(
                    J_rows, J_diag, h, flat, phi, k_sw,
                    jnp.ones((cfg.sweeps_per_round,), dtype),
                    beta_chain.reshape(S * R, 1), act,
                    num_sweeps=cfg.sweeps_per_round,
                    within_block=cfg.within_block, block_order="fixed",
                    record_m=False, precision=cfg.precision)
                mb, eb = track(res, mb, eb)
                return res.m.reshape(S, R, n_pad), mb, eb

            base = beta_chain.reshape(S * R, 1)
            clf = cl.reshape(S * R, n_pad)
            dnf = dn.reshape(S * R, 1)
            spp = cfg.sweeps_per_round // (3 * self._cycles)

            def phase(mm, kk, beta_spin, mask):
                phi = jnp.matmul(mm, J_full, precision=cfg.precision) + h
                return self._sweeps(
                    J_rows, J_diag, h, mm, phi, kk,
                    jnp.ones((spp,), dtype), beta_spin, mask,
                    num_sweeps=spp, within_block=cfg.within_block,
                    block_order="fixed", record_m=False,
                    precision=cfg.precision)

            heat = jnp.where(dnf & clf,
                             jnp.asarray(1.0 / cfg.temp_x, dtype), 1.0)
            for cycle in range(self._cycles):
                k_sw, kc, knc, kall = jax.random.split(k_sw, 4)
                res = phase(flat, kc, base * heat,
                            jnp.where(dnf, clf & act, act))
                flat = jnp.where(dnf, res.m_best, res.m)
                mb, eb = track(res, mb, eb)
                res = phase(flat, knc, base,
                            jnp.where(dnf, (~clf) & act, act))
                flat = jnp.where(dnf, res.m_best, res.m)
                mb, eb = track(res, mb, eb)
                res = phase(flat, kall, base, act)
                flat = jnp.where(dnf, res.m_best, res.m)
                mb, eb = track(res, mb, eb)
            return flat.reshape(S, R, n_pad), mb, eb

        houd_tiles = self._houd_tiles
        houd_col_idx = None if houd_tiles is None else houd_tiles[0]
        houd_planes = self._houd_planes
        houd_gather = None if houd_planes is None else houd_planes[0]

        def one_instance(J_rows, J_diag, h, src, dst, houd_J, houd_P,
                         m, b2s, s2b, mb, eb, moves, flips,
                         key, round_index):
            J_full = J_rows.reshape(n_pad, n_pad)
            k = jax.random.fold_in(key, round_index)
            _, k_pair, k_icm, k_swap = jax.random.split(k, 4)

            if houd_planes is not None:
                # matmul label propagation over one-hot neighbor planes —
                # no segment_min scatter, no data-dependent gather;
                # identical labels and — same key — identical move to the
                # sparse path (ops/clusters.NeighborPlanes)
                from ..ops.clusters import (NeighborPlanes,
                                            houdayer_move_matmul)
                pl = NeighborPlanes(houd_gather, houd_P, n_pad,
                                    cfg.block_size)

                def houd(a, b, kk):
                    return houdayer_move_matmul(
                        pl, a, b, kk,
                        use_katzgraber=cfg.use_katzgraber)
            elif houd_tiles is None:
                def houd(a, b, kk):
                    return houdayer_move_sparse(
                        src, dst, a, b, kk,
                        use_katzgraber=cfg.use_katzgraber)
            else:
                # blocked-tile label propagation: fused masked-min over
                # the union tiles instead of per-edge segment_min
                # scatters; identical labels and — same key — identical
                # move to the sparse path
                adj = houd_J != 0                     # [nB, K, B, B]

                def houd(a, b, kk):
                    return houdayer_move_blocked(
                        houd_col_idx, adj, a, b, kk,
                        use_katzgraber=cfg.use_katzgraber)

            # --- Houdayer: random same-TEMPERATURE sub-replica pairing ---
            # temperature t's chain in sub s is slot b2s[s, t]
            perm = jax.random.permutation(k_pair, S)        # shared pairing
            Pn = S // 2
            sj, sk = perm[0:2 * Pn:2], perm[1:2 * Pn:2]     # [Pn] each
            # gather states: [Pn, R, n_pad]
            slot_j = b2s[sj]                                # [Pn, R]
            slot_k = b2s[sk]
            s1 = m[sj[:, None], slot_j]                     # [P, R, n_pad]
            s2 = m[sk[:, None], slot_k]
            keys = jax.random.split(k_icm, Pn * R).reshape(Pn, R, 2)
            s1n, s2n, moved, flipped = jax.vmap(jax.vmap(houd))(
                s1, s2, keys)
            m = m.at[sj[:, None], slot_j].set(s1n)
            m = m.at[sk[:, None], slot_k].set(s2n)
            # the Katzgraber big-cluster branch flips the WHOLE state
            # (clusters._houdayer_from_labels), padded spins included —
            # energy-inert (zero couplings) but re-pin them to +1 to keep
            # the padded-spin invariant every other stage relies on
            m = jnp.where(self.active, m, jnp.ones((), dtype))
            moves = moves + jnp.sum(moved).astype(jnp.int32)
            flips = flips + jnp.sum(flipped).astype(jnp.int32)

            # --- hybrid: disagreement sets -> next round's NMC masks ----
            # the POST-move disagreement set (s1n != s2n) marks exactly
            # the pair's unresolved degrees of freedom (the union of all
            # Houdayer clusters). Post-move, not pre-move: the exchange
            # branch permutes values WITHIN the set (same region), but
            # the Katzgraber big-cluster branch flips all of s1 — there
            # the true disagreement becomes the COMPLEMENT of the
            # pre-move set, and a pre-move mask would heat exactly the
            # resolved spins
            if cfg.hybrid_cold > 0:
                cl_new = jnp.zeros((S, R, n_pad), bool)
                dn_new = jnp.zeros((S, R), bool)
                diff = (s1n != s2n) & self.active           # [P, R, n_pad]
                n_act = jnp.sum(self.active)
                frac = jnp.sum(diff, axis=-1) / n_act       # [P, R]
                ok = ((frac > 0) & (frac <= cfg.max_heat_frac)
                      & self.cold_t[None, :])               # [P, R]
                mask = diff & ok[:, :, None]
                cl_new = cl_new.at[sj[:, None], slot_j].set(mask)
                cl_new = cl_new.at[sk[:, None], slot_k].set(mask)
                dn_new = dn_new.at[sj[:, None], slot_j].set(ok)
                dn_new = dn_new.at[sk[:, None], slot_k].set(ok)
            else:
                # dummy carries (see init_state)
                cl_new = jnp.zeros((1, 1, 1), bool)
                dn_new = jnp.zeros((1, 1), bool)

            # --- energies of carried states + per-sub label swaps --------
            flat = m.reshape(S * R, n_pad)
            phi = jnp.matmul(flat, J_full, precision=cfg.precision)
            e = -(0.5 * jnp.sum(flat * phi, axis=-1)
                  + jnp.sum(flat * h, axis=-1)).reshape(S, R)
            e_min = jnp.min(e)
            r_min = jnp.argmin(e.reshape(-1))
            imp = e_min < eb
            mb = jnp.where(imp, flat[r_min], mb)
            eb = jnp.where(imp, e_min, eb)

            swap_keys = jax.random.split(k_swap, S)
            swaps = jax.vmap(lambda kk, bb, ee: metropolis_label_swap(
                kk, bb, self.beta_list.astype(jnp.float32),
                ee.astype(jnp.float32),
                num_pairs=cfg.num_swapping_pairs))(swap_keys, b2s, e)
            return (m, swaps.beta_to_slot, swaps.slot_to_beta,
                    mb, eb, moves, flips, cl_new, dn_new)

        def _round(J_rows, J_diag, h, src, dst, houd_J, houd_P,
                   state: EnsembleICMState):
            keys = jax.vmap(lambda i: jax.random.fold_in(state.key, i))(
                jnp.arange(self.I))
            m, mb, eb = jax.vmap(
                sweep_stage,
                in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None)
            )(J_rows, J_diag, h, state.m, state.slot_to_beta,
              state.m_best, state.e_best, state.cl, state.dn,
              keys, state.round_index)
            m, b2s, s2b, mb, eb, moves, flips, cl, dn = jax.vmap(
                one_instance,
                in_axes=(0,) * 7 + (0, 0, 0, 0, 0, 0, 0, 0, None)
            )(J_rows, J_diag, h, src, dst, houd_J, houd_P, m,
              state.beta_to_slot, state.slot_to_beta,
              mb, eb, state.icm_moves, state.icm_flips,
              keys, state.round_index)
            return EnsembleICMState(
                m=m, beta_to_slot=b2s, slot_to_beta=s2b, key=state.key,
                round_index=state.round_index + 1, m_best=mb, e_best=eb,
                icm_moves=moves, icm_flips=flips, cl=cl, dn=dn)

        return _round

    def _houd_J_operand(self):
        """Blocked-tile operand, or a tiny dummy — passed as a jit ARG
        (instance-sharded global arrays must not be closed over in
        multi-process meshes)."""
        if self._houd_tiles is None:
            return jnp.zeros((self.I, 1, 1, 1, 1), self.h.dtype)
        return self._houd_tiles[1]

    def _houd_P_operand(self):
        if self._houd_planes is None:
            return jnp.zeros((self.I, 1, 1, 1, 1), jnp.bfloat16)
        return self._houd_planes[1]

    def run_scanned(self, state: EnsembleICMState, num_rounds: int):
        if num_rounds not in self._scan_jit:
            round_fn = self._build_round()

            def scanned(J_rows, J_diag, h, src, dst, houd_J, houd_P,
                        state0):
                def body(s, _):
                    return round_fn(J_rows, J_diag, h, src, dst,
                                    houd_J, houd_P, s), None
                s, _ = jax.lax.scan(body, state0, None, length=num_rounds)
                return s

            self._scan_jit[num_rounds] = jax.jit(scanned)
        return self._scan_jit[num_rounds](self.J_rows, self.J_diag, self.h,
                                          self.src, self.dst,
                                          self._houd_J_operand(),
                                          self._houd_P_operand(), state)

    def best(self, state: EnsembleICMState):
        from .distributed import host_gather
        eb = host_gather(state.e_best)
        mb = host_gather(state.m_best)[:, np.asarray(self.blocked0.inv_perm)]
        return eb, mb
