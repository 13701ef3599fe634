"""Lossy hash-table k-mer depth counter — HASHTCounter, on device.

The reference's HASHTCounter (used for -M read-depth and -I
informative-kmer filters; sizes 2e8 at rkmh.cpp:739-742, 8e8 at 2516,
1e7 at 1187/1597) is a fixed array indexed by ``hash % size`` with
collision-tolerant counts.  Here it is a device-resident int32 table
updated with one scatter-add per batch — the *lossy modulo semantics are
replicated exactly* (including hash 0 landing in slot 0, as rkmh
increments invalid-kmer zeros too, rkmh.cpp:330-337), so -M/-I output
parity holds.  Unlike the reference's racy unsynchronized increments
(rkmh.cpp:333-335 "under testing"), scatter-add is deterministic.

A power-of-two size turns the modulo into a mask; rkmh's decimal sizes
are supported unchanged via u64 remainder.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def make_table(size: int):
    return jnp.zeros((size,), dtype=jnp.int32)


def _slots(hashes, size: int):
    if size & (size - 1) == 0:  # power of two: mask
        return (hashes & np.uint64(size - 1)).astype(jnp.int32)
    return (hashes % np.uint64(size)).astype(jnp.int32)


@partial(jax.jit, donate_argnums=(0,))
def counter_add(table, hashes, mask):
    """table[h % size] += 1 for every masked-in hash. Donated in-place."""
    size = table.shape[0]
    idx = _slots(hashes.reshape(-1), size)
    inc = mask.reshape(-1).astype(jnp.int32)
    return table.at[idx].add(inc)


@jax.jit
def counter_get(table, hashes):
    """Gather counts for a hash tensor (collision-lossy, like the ref)."""
    size = table.shape[0]
    return table[_slots(hashes, size)]


class HashCounter:
    """Convenience stateful wrapper over the functional table ops."""

    def __init__(self, size: int):
        self.size = int(size)
        self.table = make_table(self.size)

    def add(self, hashes, mask=None):
        if mask is None:
            mask = jnp.ones(hashes.shape, dtype=bool)
        self.table = counter_add(self.table, hashes, mask)
        return self

    def get(self, hashes):
        return counter_get(self.table, hashes)

    def to_numpy(self):
        return np.asarray(self.table)
