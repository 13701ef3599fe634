"""Batched sorted-sketch intersection counting — the classify hot loop.

The reference walks `numreads x numrefs` pairs of sorted sketch arrays with
a two-pointer merge (mkmh hash_intersection_size, rkmh.cpp:867-870).  A
sequential merge is hostile to a vector machine, so the device formulation
counts, for every read-sketch element, how many times its value occurs in
the reference sketch, using two vectorized binary searches over the sorted
reference row — O(s log s) of pure gather/compare per pair, batched over
the whole [B, R] grid.

Duplicate semantics are preserved exactly: std::set_intersection counts
min(multiplicity_a, multiplicity_b) per value.  That equals

    sum_i [ occ_a(i) < count_b(value_i) ]

where occ_a(i) is element i's index within its run of equal values — so a
value appearing ca times in A and cb times in B contributes min(ca, cb).
(Duplicates are real: rkmh sketches are sorted arrays, not sets — repeated
k-mers in a genome can occupy several bottom-s slots.)

References are processed in chunks sized to bound peak memory; the batch
axis shards cleanly under a Mesh (data parallel), and the reference axis
can shard too (tensor parallel) with a psum-argmax merge in classify.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rkmh_tpu.ops.sketch import SENTINEL


def occ_ranks(sorted_rows):
    """Index-within-run-of-equal-values for each element of sorted rows."""
    s = sorted_rows.shape[-1]
    iota = jnp.arange(s, dtype=jnp.int32)
    iota = jnp.broadcast_to(iota, sorted_rows.shape)
    new_run = jnp.concatenate(
        [
            jnp.ones(sorted_rows.shape[:-1] + (1,), dtype=bool),
            sorted_rows[..., 1:] != sorted_rows[..., :-1],
        ],
        axis=-1,
    )
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(new_run, iota, 0), axis=-1
    )
    return iota - run_start


def _ref_chunk(B: int, s: int, target_bytes: int = 1 << 26) -> int:
    per_ref = max(B * s * 8, 1)
    return max(1, min(64, target_bytes // per_ref))


def _chunked_ref_map(per_ref, ref_sk, B: int, s: int):
    """Apply per_ref: [t] -> [B] over every ref row with bounded memory and
    bounded compile size: a rolled lax.map over chunks of vmapped rows.
    Rows added for padding are all-SENTINEL and count 0 (sliced off)."""
    R, t = ref_sk.shape
    chunk = _ref_chunk(B, s)
    if R <= chunk:
        return jax.vmap(per_ref)(ref_sk)  # [R, B]
    Rpad = ((R + chunk - 1) // chunk) * chunk
    if Rpad != R:
        pad = jnp.full((Rpad - R, t), SENTINEL, dtype=ref_sk.dtype)
        ref_sk = jnp.concatenate([ref_sk, pad], axis=0)
    grouped = ref_sk.reshape(Rpad // chunk, chunk, t)
    out = jax.lax.map(jax.vmap(per_ref), grouped)  # [nc, chunk, B]
    return out.reshape(Rpad, -1)[:R]


def intersection_counts(read_sk, read_lens, ref_sk, ref_lens=None):
    """[B, s] sorted read sketches vs [R, t] sorted ref sketches -> [B, R]
    int32 intersection sizes (min-multiplicity, zeros/sentinels excluded).

    `read_lens` masks sentinel padding on the read side; the reference-side
    sentinel tail can never match because queries are < SENTINEL.
    `ref_lens` is accepted for API symmetry (sentinel layout makes it
    unnecessary).
    """
    B, s = read_sk.shape
    occ = occ_ranks(read_sk)
    qmask = (jnp.arange(s, dtype=jnp.int32)[None, :] < read_lens[:, None]) & (
        read_sk != SENTINEL
    )

    def per_ref(ref_row):
        left = jnp.searchsorted(ref_row, read_sk, side="left")
        right = jnp.searchsorted(ref_row, read_sk, side="right")
        cb = (right - left).astype(jnp.int32)
        hit = (occ < cb) & qmask
        return jnp.sum(hit, axis=-1, dtype=jnp.int32)  # [B]

    return _chunked_ref_map(per_ref, ref_sk, B, s).T  # [B, R]


def distinct_intersection_counts(read_sorted, read_lens, ref_sorted, ref_lens=None):
    """Distinct-shared-value counts (set semantics) — hpv16's type-level
    comparator (mkmh hash_set_intersection_size, rkmh.cpp:2673): number of
    distinct hash values present in both arrays."""
    B, s = read_sorted.shape
    R = ref_sorted.shape[0]
    occ = occ_ranks(read_sorted)
    qmask = (
        (jnp.arange(s, dtype=jnp.int32)[None, :] < read_lens[:, None])
        & (read_sorted != SENTINEL)
        & (occ == 0)  # one query per distinct value
    )

    def per_ref(ref_row):
        left = jnp.searchsorted(ref_row, read_sorted, side="left")
        right = jnp.searchsorted(ref_row, read_sorted, side="right")
        hit = (right > left) & qmask
        return jnp.sum(hit, axis=-1, dtype=jnp.int32)

    return _chunked_ref_map(per_ref, ref_sorted, B, s).T


def sort_hashes_padded(hashes, mask):
    """Sort window hashes ascending with masked-out entries sent to
    SENTINEL; returns (sorted [B, W], valid counts [B]).  Used where rkmh
    sorts a full hash array rather than sketching (hpv16, rkmh.cpp:2666).
    NOTE: unlike sketches, zeros (invalid k-mers) are KEPT — rkmh sorts the
    raw array and set-intersects it including zeros."""
    x = jnp.where(mask, hashes, SENTINEL)
    x = jnp.sort(x, axis=-1)
    lens = jnp.sum(mask, axis=-1).astype(jnp.int32)
    return x, lens
