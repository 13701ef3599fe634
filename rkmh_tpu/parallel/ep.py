"""Sharded k-mer depth counters — the expert-parallel analog.

SURVEY.md §2.4: this workload has no MoE, but its nearest EP analog is
sharding the HASHTCounter table across chips so giant counters
(rkmh uses up to 8e8 slots, rkmh.cpp:2516 — 3.2 GB of int32) don't
replicate per device.

Scheme (exact, deterministic; device d owns the contiguous slot range
[d*S/D, (d+1)*S/D) of the logical ``hash % S`` table):

* **build/accumulate**: each device scatter-adds its local read-shard's
  hashes into a transient full-size table; one ``psum_scatter`` (sum)
  folds the contributions into each device's shard, which accumulates
  into the running shard — so per-batch incremental use matches
  ops.counter.counter_add exactly.
* **lookup**: queried *hashes* are all_gathered (traffic proportional to
  the query, not the table), each device answers the slots it owns, and
  a ``psum`` merges the per-device partial counts; every device then
  keeps its own query-shard's rows.

The transient full table bounds the build step to tables that fit HBM
once per device; for rkmh's sizes (<= 8e8 i32 = 3.2 GB) that holds on
any card with >= 8 GB of device memory, and steady-state memory is
size/D per device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rkmh_tpu.ops.counter import _slots


def _check(size: int, ndev: int):
    assert size % ndev == 0, f"counter size {size} not divisible by {ndev} dp shards"


def sharded_counter_init(mesh: Mesh, size: int):
    """Zero table [size] sharded over dp (the accumulate input)."""
    _check(size, mesh.shape["dp"])
    sharding = jax.sharding.NamedSharding(mesh, P("dp"))
    return jax.device_put(jnp.zeros((size,), jnp.int32), sharding)


def sharded_counter_add_fn(mesh: Mesh, size: int):
    """Jitted accumulate: (table shard, hashes [B, W], mask) -> updated
    table, with reads dp-sharded.  Matches ops.counter.counter_add
    semantics per batch (call per read batch, like HashCounter.add)."""
    ndev = mesh.shape["dp"]
    _check(size, ndev)

    def local(shard, hashes, mask):
        full = jnp.zeros((size,), jnp.int32)
        idx = _slots(hashes.reshape(-1), size)
        full = full.at[idx].add(mask.reshape(-1).astype(jnp.int32))
        delta = jax.lax.psum_scatter(full, "dp", scatter_dimension=0, tiled=True)
        return shard + delta  # [size / ndev]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp")),
        out_specs=P("dp"),
    )
    return jax.jit(fn)


def counter_get_local(shard, hashes, size: int, shard_size: int):
    """Per-device body of the sharded lookup, reusable inside any
    shard_map that has a ``dp`` axis (e.g. the fused -M classify step,
    mesh.sharded_classify_depth_table_fn): all_gather the queried hashes
    over dp, answer the slots this device owns, psum-merge the partial
    counts, keep this device's own query rows."""
    B_local = hashes.shape[0]
    allq = jax.lax.all_gather(hashes, "dp", axis=0, tiled=True)  # [B, ...]
    slots = _slots(allq, size)
    d = jax.lax.axis_index("dp")
    local_idx = slots - d * shard_size
    mine = (local_idx >= 0) & (local_idx < shard_size)
    vals = jnp.where(
        mine, shard[jnp.clip(local_idx, 0, shard_size - 1)], jnp.int32(0)
    )
    counts_all = jax.lax.psum(vals, "dp")
    return jax.lax.dynamic_slice_in_dim(counts_all, d * B_local, B_local, 0)


def sharded_counter_get_fn(mesh: Mesh, size: int):
    """Jitted lookup: table (dp-sharded) x hashes (dp-sharded reads) ->
    counts per hash (dp-sharded like the hashes).

    Queried hashes all_gather across devices (query-proportional
    traffic); each device answers its owned slot range; partial counts
    psum-merge and every device keeps its own query rows.
    """
    ndev = mesh.shape["dp"]
    _check(size, ndev)
    shard_size = size // ndev

    def local(shard, hashes):
        return counter_get_local(shard, hashes, size, shard_size)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=P("dp"),
    )
    return jax.jit(fn)


def sharded_counter_add_codes_fn(mesh: Mesh, size: int, ks: tuple):
    """Accumulate straight from packed codes: (table shard, codes [B, L],
    lens [B]) -> updated shard, hashing + window masking INSIDE the
    shard_map so the -M counting pass runs data-parallel end to end
    (no single-device hashing stage).  Works on a (dp, tp) mesh too:
    the shard/codes replicate over tp and every tp column computes the
    identical update."""
    ndev = mesh.shape["dp"]
    _check(size, ndev)

    from rkmh_tpu.ops.hashing import multi_k_window_hashes, window_mask

    def local(shard, codes, lens):
        hashes = multi_k_window_hashes(codes, list(ks))
        mask = window_mask(lens, codes.shape[-1], list(ks))
        full = jnp.zeros((size,), jnp.int32)
        idx = _slots(hashes.reshape(-1), size)
        full = full.at[idx].add(mask.reshape(-1).astype(jnp.int32))
        delta = jax.lax.psum_scatter(full, "dp", scatter_dimension=0, tiled=True)
        return shard + delta  # [size / ndev]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp"), P("dp", None), P("dp")),
        out_specs=P("dp"),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_counter_build_fn(mesh: Mesh, size: int):
    """One-shot build from a single batch (init + add fused); kept for
    convenience and the driver dryrun."""
    add = sharded_counter_add_fn(mesh, size)

    def build(hashes, mask):
        return add(sharded_counter_init(mesh, size), hashes, mask)

    return build
