"""Jittable replica-exchange machinery (device-side, SPMD-safe).

The reference performs swaps on the driver host: sequential random selection
of non-overlapping adjacent pairs (/root/reference/NPT/npt.py:514-533), then
Metropolis accepts that COPY full spin states between replica slots
(npt.py:677-678). On an accelerator both are wrong-shaped: state copies
are O(N) device-memory and interconnect traffic, and host round-trips
break the jit step.

Here replicas never move. A permutation pair (beta_to_slot, slot_to_beta)
maps temperature indices <-> chain slots; a swap exchanges the two LABELS.
Selection reproduces the reference's sequential non-overlapping draw with a
fixed trip count (Gumbel-max over the shrinking availability mask), and the
Metropolis rule is min(1, exp(dB * dE)) exactly as npt.py:671. Because every
device computes the (tiny, replicated) label update from the same PRNG key,
the permutation stays consistent across a sharded mesh with zero state
traffic — only an all_gather of R scalars (energies) is needed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("num_replicas", "num_pairs"))
def select_pairs_device(key, *, num_replicas: int, num_pairs: int) -> jax.Array:
    """Sequentially draw `num_pairs` non-overlapping adjacent pairs.

    Returns pair base indices b (the pair is (b, b+1) over temperature
    indices 0..R-1), or -1 where no non-overlapping pair remained (the
    reference raises in that case, /root/reference/NPT/npt.py:526; here the
    invalid picks are masked out so the step stays jittable).
    """
    P = num_replicas - 1

    def body(carry, k):
        avail = carry
        g = jax.random.gumbel(k, (P,))
        scores = jnp.where(avail, g, -jnp.inf)
        idx = jnp.argmax(scores)
        valid = jnp.any(avail)
        pick = jnp.where(valid, idx, -1)
        # pairs overlapping (idx, idx+1) are idx-1, idx, idx+1
        offs = idx + jnp.array([-1, 0, 1])
        offs = jnp.clip(offs, 0, P - 1)
        avail = jnp.where(valid, avail.at[offs].set(False), avail)
        return avail, pick

    keys = jax.random.split(key, num_pairs)
    _, picks = jax.lax.scan(body, jnp.ones(P, bool), keys)
    return picks


class SwapResult(NamedTuple):
    beta_to_slot: jax.Array   # [R] temperature index -> chain slot
    slot_to_beta: jax.Array   # [R] chain slot -> temperature index
    accepted: jax.Array       # [num_pairs] bool (False for invalid picks)
    pairs: jax.Array          # [num_pairs] pair base temperature indices


@functools.partial(jax.jit, static_argnames=("num_pairs",))
def metropolis_label_swap(
    key,
    beta_to_slot: jax.Array,   # [R]
    beta_list: jax.Array,      # [R] sorted temperatures (by index)
    slot_energies: jax.Array,  # [R] energy of each chain slot's state
    *,
    num_pairs: int,
) -> SwapResult:
    """One swap round over temperature labels.

    accept iff u < min(1, exp((beta[b+1]-beta[b]) * (E[slot(b+1)]-E[slot(b)])))
    — the reference's rule (/root/reference/NPT/npt.py:657-678) with states
    held fixed and labels exchanged.
    """
    R = beta_to_slot.shape[0]
    k_sel, k_acc = jax.random.split(key)
    picks = select_pairs_device(k_sel, num_replicas=R, num_pairs=num_pairs)
    us = jax.random.uniform(k_acc, (num_pairs,))

    def body(b2s, xs):
        b, u = xs
        valid = b >= 0
        bc = jnp.clip(b, 0, R - 2)
        s_lo = b2s[bc]
        s_hi = b2s[bc + 1]
        dB = beta_list[bc + 1] - beta_list[bc]
        dE = slot_energies[s_hi] - slot_energies[s_lo]
        accept = valid & (u < jnp.minimum(1.0, jnp.exp(dB * dE)))
        new_lo = jnp.where(accept, s_hi, s_lo)
        new_hi = jnp.where(accept, s_lo, s_hi)
        b2s = b2s.at[bc].set(new_lo).at[bc + 1].set(new_hi)
        return b2s, accept

    beta_to_slot, accepted = jax.lax.scan(body, beta_to_slot, (picks, us))
    slot_to_beta = jnp.zeros(R, beta_to_slot.dtype).at[beta_to_slot].set(
        jnp.arange(R, dtype=beta_to_slot.dtype))
    return SwapResult(beta_to_slot=beta_to_slot, slot_to_beta=slot_to_beta,
                      accepted=accepted, pairs=picks)
