"""Classification engine: hash -> sketch -> compare -> argmax, fully on
device, replicating rkmh's exact scan/filter semantics.

Two argmax flavors exist in the reference:

* stream/classify (rkmh.cpp:874-889): running max starts at -1, strict
  `>` updates (first reference wins ties), and `diff` is the margin of the
  final update — max_shared minus the running max just before it, i.e.
  max(-1, max(counts[:argmax])).  Filters: diff_filter = diff > min_diff
  (pass), depth_filter = sketch_len <= min_matches (fail tag),
  match_filter = max_shared < min_matches (fail tag).
* filter (equiv.hpp:324-353 classify_and_count_diff_filter): running max
  starts at 0 (a read matching nothing keeps sample="", i.e. best_idx =
  -1), prev_best likewise starts 0, pass condition
  (max_shared - prev_best) > min_diff.

Both are closed-form vectorizable: argmax is jnp.argmax (first-index
tie-break matches the strict-> scan), and the "previous best" is the max
over counts left of the argmax with the appropriate initial value.
"""

from __future__ import annotations

from functools import partial, wraps

import numpy as np
import jax
import jax.numpy as jnp

from rkmh_tpu.ops.hashing import multi_k_window_hashes
from rkmh_tpu.ops.sketch import bottom_s_sketch
from rkmh_tpu.ops.intersect import intersection_counts


def prev_best_before_argmax(counts, init: int):
    """max(init, max(counts[:, :argmax])) per row, argmax = first max."""
    best = jnp.argmax(counts, axis=-1)
    R = counts.shape[-1]
    iota = jnp.arange(R, dtype=jnp.int32)
    before = jnp.where(iota[None, :] < best[:, None], counts, init)
    pm = jnp.max(before, axis=-1, initial=init)
    return best, pm


def argmax_stream(counts, min_diff: int, min_matches: int, sketch_lens):
    """rkmh stream semantics -> (best_idx, max_shared, pass/fail flags)."""
    max_shared = jnp.max(counts, axis=-1)
    best, pm = prev_best_before_argmax(counts, init=-1)
    diff = max_shared - pm
    diff_ok = diff > min_diff                      # True = no FAIL:DIFF
    depth_fail = sketch_lens <= min_matches        # FAIL:DEPTH tag
    match_fail = max_shared < min_matches          # FAIL:MATCHES tag
    return best, max_shared, diff_ok, depth_fail, match_fail


def argmax_filter(counts, min_diff: int, min_matches: int, sketch_lens, ref_lens):
    """rkmh filter semantics (equiv.hpp:324-353) ->
    (best_idx or -1, shared, total_union, keep, depth_fail, match_fail, diff_ok).

    total_union = min(read_sketch_len, best_ref_sketch_len), set only when
    some count exceeded 0 (equiv.hpp:347); 0 otherwise.
    """
    max_shared = jnp.max(counts, axis=-1)
    best_raw, pm = prev_best_before_argmax(counts, init=0)
    updated = max_shared > 0
    best = jnp.where(updated, best_raw, -1)
    shared = jnp.where(updated, max_shared, 0)
    tu = jnp.where(
        updated,
        jnp.minimum(sketch_lens, ref_lens[jnp.clip(best_raw, 0, None)]),
        0,
    )
    diff_ok = (shared - jnp.where(updated, pm, 0)) > min_diff
    depth_fail = sketch_lens <= 0                  # rkmh.cpp:1292/1394
    match_fail = shared < min_matches              # rkmh.cpp:1293/1395
    keep = (~depth_fail) & (~match_fail) & diff_ok
    return best, shared, tu, keep, depth_fail, match_fail, diff_ok


@partial(jax.jit, static_argnames=("ks", "sketch_size"))
def sketch_batch(codes, ks: tuple, sketch_size: int):
    """codes [B, L] -> (sorted bottom-s sketches [B, s], lens [B])."""
    hashes = multi_k_window_hashes(codes, list(ks))
    return bottom_s_sketch(hashes, sketch_size)


@partial(jax.jit, static_argnames=("ks", "sketch_size", "min_diff", "min_matches"))
def classify_batch(
    codes,
    ref_sk,
    ref_lens,
    ks: tuple,
    sketch_size: int,
    min_diff: int = 0,
    min_matches: int = -1,
):
    """End-to-end stream/classify step for one read batch.

    Returns (best_idx, max_shared, sketch_lens, diff_ok, depth_fail,
    match_fail) — everything the output formatter needs (rkmh.cpp:892).
    """
    sk, sk_lens = sketch_batch(codes, ks, sketch_size)
    counts = intersection_counts(sk, sk_lens, ref_sk, ref_lens)
    best, max_shared, diff_ok, depth_fail, match_fail = argmax_stream(
        counts, min_diff, min_matches, sk_lens
    )
    return best, max_shared, sk_lens, diff_ok, depth_fail, match_fail


@partial(jax.jit, static_argnames=("ks", "sketch_size", "min_diff", "min_matches"))
def filter_batch(
    codes,
    ref_sk,
    ref_lens,
    ks: tuple,
    sketch_size: int,
    min_diff: int = 0,
    min_matches: int = -1,
):
    """Filter-command step (no -M): full argmax_filter tuple."""
    sk, sk_lens = sketch_batch(codes, ks, sketch_size)
    counts = intersection_counts(sk, sk_lens, ref_sk, ref_lens)
    return argmax_filter(counts, min_diff, min_matches, sk_lens, ref_lens)


@partial(jax.jit, static_argnames=("min_diff", "min_matches"))
def filter_sketches(sk, sk_lens, ref_sk, ref_lens, min_diff: int, min_matches: int):
    """Filter-semantics classify of pre-built sketches (-M path, -i path)."""
    counts = intersection_counts(sk, sk_lens, ref_sk, ref_lens)
    return argmax_filter(counts, min_diff, min_matches, sk_lens, ref_lens)


def build_ref_sketches(ref_codes, ks: tuple, sketch_size: int):
    """Reference panel -> sorted bottom-s sketch matrix (built once,
    replicated across chips; ~R*s*8 bytes, e.g. 182*4000*8 = 5.8 MB)."""
    return sketch_batch(ref_codes, tuple(ks), sketch_size)


# ---------------------------------------------------------------------------
# -M / -I depth-filtered variants (HASHTCounter-backed)
# ---------------------------------------------------------------------------

from rkmh_tpu.ops.counter import counter_get  # noqa: E402
from rkmh_tpu.ops.hashing import window_mask  # noqa: E402
from rkmh_tpu.ops.sketch import (  # noqa: E402
    mask_by_frequency,
    mask_by_frequency_range,
)


@partial(jax.jit, static_argnames=("ks",))
def hash_batch_with_mask(codes, lengths, ks: tuple):
    """Window hashes plus true-window mask (for counter population)."""
    hashes = multi_k_window_hashes(codes, list(ks))
    mask = window_mask(lengths, codes.shape[-1], list(ks))
    return hashes, mask


@partial(jax.jit, static_argnames=("ks", "sketch_size", "min_occ"))
def sketch_batch_depth_filtered(
    codes, lengths, table, ks: tuple, sketch_size: int, min_occ: int
):
    """stream -M read path (rkmh.cpp:903-917): hash, zero out hashes whose
    counted depth < min_occ, then bottom-s sketch."""
    hashes = multi_k_window_hashes(codes, list(ks))
    counts = counter_get(table, hashes)
    hashes = mask_by_frequency(hashes, counts, min_occ)
    return bottom_s_sketch(hashes, sketch_size)


@partial(jax.jit, static_argnames=("ks", "sketch_size", "max_occ"))
def sketch_batch_informative(
    codes, table, ks: tuple, sketch_size: int, max_occ: int
):
    """stream -I reference path (rkmh.cpp:829-837
    minhashes_frequency_filter bounds (0, max_samples)): keep hashes whose
    occurrence count <= max_occ, then bottom-s sketch."""
    hashes = multi_k_window_hashes(codes, list(ks))
    counts = counter_get(table, hashes)
    hashes = mask_by_frequency_range(hashes, counts, 0, max_occ)
    return bottom_s_sketch(hashes, sketch_size)


@partial(jax.jit, static_argnames=("min_diff", "min_matches"))
def classify_sketches(sk, sk_lens, ref_sk, ref_lens, min_diff: int, min_matches: int):
    """Classify pre-built read sketches (used by the -M/-I paths)."""
    counts = intersection_counts(sk, sk_lens, ref_sk, ref_lens)
    return argmax_stream(counts, min_diff, min_matches, sk_lens)


# ---------------------------------------------------------------------------
# Panel-table fast path (ops/lookup.py): the production classify kernel.
# Bit-identical to the searchsorted path, with one row gather per sketch
# element instead of a binary search per (read, ref) pair.
# ---------------------------------------------------------------------------

from rkmh_tpu.ops.lookup import lookup_intersection_counts  # noqa: E402


@partial(jax.jit, static_argnames=("ks", "sketch_size", "num_refs", "min_diff", "min_matches"))
def classify_batch_table(
    codes, table,
    ks: tuple, sketch_size: int, num_refs: int,
    min_diff: int = 0, min_matches: int = -1,
):
    sk, sk_lens = sketch_batch(codes, ks, sketch_size)
    counts = lookup_intersection_counts(sk, sk_lens, (table,), num_refs)
    best, max_shared, diff_ok, depth_fail, match_fail = argmax_stream(
        counts, min_diff, min_matches, sk_lens
    )
    return best, max_shared, sk_lens, diff_ok, depth_fail, match_fail


@partial(jax.jit, static_argnames=("num_refs", "min_diff", "min_matches"))
def classify_sketches_table(
    sk, sk_lens, table,
    num_refs: int, min_diff: int, min_matches: int,
):
    counts = lookup_intersection_counts(sk, sk_lens, (table,), num_refs)
    return argmax_stream(counts, min_diff, min_matches, sk_lens)


@partial(jax.jit, static_argnames=("num_refs", "min_diff", "min_matches"))
def classify_sketches_table_packed(
    sk, sk_lens, table,
    num_refs: int, min_diff: int, min_matches: int,
):
    """classify_sketches_table with the result packed into ONE int64
    [3, B] array (best, shared, flag bits diff_ok|depth<<1|match<<2):
    one device->host fetch per batch instead of five.
    """
    counts = lookup_intersection_counts(sk, sk_lens, (table,), num_refs)
    best, shared, diff_ok, depth_fail, match_fail = argmax_stream(
        counts, min_diff, min_matches, sk_lens
    )
    flags = (
        diff_ok.astype(jnp.int64)
        | (depth_fail.astype(jnp.int64) << 1)
        | (match_fail.astype(jnp.int64) << 2)
    )
    return jnp.stack([best.astype(jnp.int64), shared.astype(jnp.int64), flags])


def accel_branches() -> bool:
    """The one switch for the accelerator-only branches of the classify
    step: the sort-free occurrence rank (_table_counts_from_codes) and the
    2-bit packed input wire (pack4_ok).  Both are bit-identical to the
    CPU forms; a single CPU core is faster with the row sort and gains
    nothing from a smaller host->device copy, so CPU backends skip them.

    The classify wrappers below resolve it at call time, outside the
    trace, into a static `accel` argument — so the choice is part of the
    compile-cache key, and tests drive the accelerator branches on the
    CPU by passing accel=True or by patching this function."""
    return jax.default_backend() != "cpu"


def _resolve_accel(jitted):
    """Wrap a jitted step whose static `accel` argument defaults to
    accel_branches() at call time."""

    @wraps(jitted)
    def call(*args, accel=None, **kwargs):
        return jitted(*args, accel=accel_branches() if accel is None else accel,
                      **kwargs)

    return call


@_resolve_accel
@partial(jax.jit, static_argnames=(
    "ks", "sketch_size", "num_refs", "min_diff", "min_matches", "accel"))
def classify_codes_table_packed(
    codes, table,
    ks: tuple, sketch_size: int,
    num_refs: int, min_diff: int, min_matches: int, accel: bool,
):
    """Whole stream step (hash -> sketch -> lookup -> argmax -> pack) as
    ONE jit: one dispatch per batch instead of two, and XLA fuses across
    the stage boundary."""
    counts, sk_lens = _table_counts_from_codes(
        codes, table, ks, sketch_size, num_refs, accel)
    best, shared, diff_ok, depth_fail, match_fail = argmax_stream(
        counts, min_diff, min_matches, sk_lens
    )
    flags = (
        diff_ok.astype(jnp.int64)
        | (depth_fail.astype(jnp.int64) << 1)
        | (match_fail.astype(jnp.int64) << 2)
    )
    return jnp.stack([best.astype(jnp.int64), shared.astype(jnp.int64), flags])


# ---------------------------------------------------------------------------
# 2-reads-per-int64 result packing: one u32 word per read (best 16b |
# shared 13b | diff_ok<<29 | depth<<30 | match<<31), two words per int64,
# is 4 B/read of device->host traffic instead of the [3, B] int64
# layout's 24 B/read.  Requires num_refs < 2^16 and shared (<= sketch
# len) < 2^13; callers fall back to the [3, B] layout outside that
# envelope.
# ---------------------------------------------------------------------------


def pack2_supported(num_refs: int, sketch_size: int) -> bool:
    return num_refs <= 0xFFFF and sketch_size <= 0x1FFF


# Short-read fast path: when every window hash fits in the sketch
# (W <= s — e.g. zika 150 bp reads at s=1000), bottom-s selection is the
# identity, so the row sort only serves to compute duplicate ranks.  The
# ranks come from a fused O(W^2) prefix-equality count instead (XLA fuses
# the [B, W, W] compare into the reduce; bit-identical).  Guarded to
# small W so the quadratic term can't blow up on long reads, which need
# real bottom-s selection anyway.  Not yet re-measured against the sort
# on the GPU (ROADMAP Queue 1, item 5).
NOSORT_MAX_W = 256


def use_nosort(W: int, sketch_size: int, accel: bool) -> bool:
    """Whether a step with W windows per read takes the sort-free rank."""
    return accel and W <= sketch_size and W <= NOSORT_MAX_W


def _table_counts_from_codes(codes, table, ks, sketch_size, num_refs, accel):
    """(counts [B, R], sketch_lens [B]) for a code batch, choosing the
    sort-free short-read path when shapes allow (trace-time decision)."""
    from rkmh_tpu.ops.lookup import lookup_intersection_counts_masked

    hashes = multi_k_window_hashes(codes, list(ks))
    W = hashes.shape[-1]
    if use_nosort(W, sketch_size, accel):
        valid = hashes != np.uint64(0)
        lower = np.tril(np.ones((W, W), dtype=bool), k=-1)
        eq = hashes[:, None, :] == hashes[:, :, None]
        occ = jnp.sum(eq & lower[None], axis=-1).astype(jnp.uint32)
        sk_lens = jnp.sum(valid, axis=-1).astype(jnp.int32)
        counts = lookup_intersection_counts_masked(
            hashes, valid, occ, (table,), num_refs
        )
        return counts, sk_lens
    sk, sk_lens = bottom_s_sketch(hashes, sketch_size)
    counts = lookup_intersection_counts(sk, sk_lens, (table,), num_refs)
    return counts, sk_lens


def _pack2(best, shared, diff_ok, depth_fail, match_fail):
    word = (
        best.astype(jnp.uint32)
        | (shared.astype(jnp.uint32) << jnp.uint32(16))
        | (diff_ok.astype(jnp.uint32) << jnp.uint32(29))
        | (depth_fail.astype(jnp.uint32) << jnp.uint32(30))
        | (match_fail.astype(jnp.uint32) << jnp.uint32(31))
    )
    n = word.shape[0]
    if n % 2:
        word = jnp.pad(word, (0, 1))
    w2 = word.reshape(-1, 2).astype(jnp.uint64)
    return jax.lax.bitcast_convert_type(
        w2[:, 0] | (w2[:, 1] << jnp.uint64(32)), jnp.int64
    )


def unpack2_host(arr_i64, n: int):
    """Host: [ceil(n/2)] int64 -> [3, n] int64 (best, shared, flag bits
    diff_ok | depth<<1 | match<<2), matching the [3, B] layout."""
    w = np.asarray(arr_i64).view(np.uint64)
    words = np.empty(2 * len(w), np.uint32)
    words[0::2] = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words[1::2] = (w >> np.uint64(32)).astype(np.uint32)
    words = words[:n]
    out = np.empty((3, n), np.int64)
    out[0] = words & 0xFFFF
    out[1] = (words >> 16) & 0x1FFF
    out[2] = words >> 29
    return out


@_resolve_accel
@partial(jax.jit, static_argnames=(
    "ks", "sketch_size", "num_refs", "min_diff", "min_matches", "accel"))
def classify_codes_table_packed2(
    codes, table,
    ks: tuple, sketch_size: int,
    num_refs: int, min_diff: int, min_matches: int, accel: bool,
):
    """classify_codes_table_packed with the 2-reads-per-int64 wire format."""
    counts, sk_lens = _table_counts_from_codes(
        codes, table, ks, sketch_size, num_refs, accel)
    return _pack2(*argmax_stream(counts, min_diff, min_matches, sk_lens))


def unpack_codes4(packed, vbits, L: int):
    """Device-side inverse of io.packing.pack_codes4: [B, L/4] + [B, L/8]
    -> [B, L] uint8 codes (invalid/pad restored as 255).  Pure
    shift/stack/reshape — fuses into whatever consumes the codes."""
    B = packed.shape[0]
    nibs = jnp.stack(
        [(packed >> np.uint8(2 * j)) & np.uint8(3) for j in range(4)], axis=-1
    ).reshape(B, L)
    bits = jnp.stack(
        [(vbits >> np.uint8(j)) & np.uint8(1) for j in range(8)], axis=-1
    ).reshape(B, L)
    return jnp.where(bits == 1, nibs, np.uint8(255))


def pack4_ok(L: int) -> bool:
    """Ship codes 2-bit packed when there is a host->device copy to save
    (accel_branches) and the row width divides into whole bytes."""
    return L % 8 == 0 and accel_branches()


@_resolve_accel
@partial(jax.jit, static_argnames=(
    "L", "ks", "sketch_size", "num_refs", "min_diff", "min_matches", "accel"))
def classify_packed4_table_packed2(
    packed, vbits, L: int, table,
    ks: tuple, sketch_size: int,
    num_refs: int, min_diff: int, min_matches: int, accel: bool,
):
    """classify_codes_table_packed2 fed by the 2-bit packed wire format
    (see io.packing.pack_codes4): 0.375 B per base instead of 1."""
    codes = unpack_codes4(packed, vbits, L)
    counts, sk_lens = _table_counts_from_codes(
        codes, table, ks, sketch_size, num_refs, accel)
    return _pack2(*argmax_stream(counts, min_diff, min_matches, sk_lens))


@partial(jax.jit, static_argnames=("L", "ks"))
def hash_packed4_with_mask(packed, vbits, lengths, L: int, ks: tuple):
    """hash_batch_with_mask over the packed wire format."""
    codes = unpack_codes4(packed, vbits, L)
    hashes = multi_k_window_hashes(codes, list(ks))
    mask = window_mask(lengths, L, list(ks))
    return hashes, mask


@partial(jax.jit, static_argnames=("L", "ks", "sketch_size"))
def sketch_packed4(packed, vbits, L: int, ks: tuple, sketch_size: int):
    """sketch_batch over the packed wire format (filter's classify pass)."""
    codes = unpack_codes4(packed, vbits, L)
    hashes = multi_k_window_hashes(codes, list(ks))
    return bottom_s_sketch(hashes, sketch_size)


@partial(jax.jit, static_argnames=("L", "ks", "num_types", "num_uniq", "min_occ"))
def hpv16_packed4_batch(
    packed, vbits, L: int,
    type_table, uniq_table,
    ks: tuple, num_types: int, num_uniq: int,
    counter_table=None, min_occ: int = 0,
):
    """hpv16_batch over the packed wire format (long nanopore reads ship
    2.7x less H2D)."""
    codes = unpack_codes4(packed, vbits, L)
    hashes = multi_k_window_hashes(codes, list(ks))
    if counter_table is not None:
        counts = counter_get(counter_table, hashes)
        hashes = mask_by_frequency(hashes, counts, min_occ)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    tc = lookup_intersection_counts(full, lens, (type_table,), num_types)
    uc = lookup_intersection_counts(full, lens, (uniq_table,), num_uniq)
    best = jnp.argmax(tc, axis=-1)
    max_shared = jnp.max(tc, axis=-1)
    return jnp.concatenate(
        [
            best.astype(jnp.int64)[:, None],
            max_shared.astype(jnp.int64)[:, None],
            uc.astype(jnp.int64),
        ],
        axis=1,
    )


@partial(jax.jit, static_argnames=("L", "ks", "sketch_size", "min_occ"))
def sketch_packed4_depth_filtered(
    packed, vbits, lengths, table, L: int, ks: tuple, sketch_size: int, min_occ: int
):
    """sketch_batch_depth_filtered over the packed wire format (-M path)."""
    codes = unpack_codes4(packed, vbits, L)
    hashes = multi_k_window_hashes(codes, list(ks))
    counts = counter_get(table, hashes)
    hashes = mask_by_frequency(hashes, counts, min_occ)
    return bottom_s_sketch(hashes, sketch_size)


@partial(jax.jit, static_argnames=("num_refs", "min_diff", "min_matches"))
def classify_sketches_table_packed2(
    sk, sk_lens, table,
    num_refs: int, min_diff: int, min_matches: int,
):
    """classify_sketches_table_packed (-M/-I path) in the packed2 format."""
    counts = lookup_intersection_counts(sk, sk_lens, (table,), num_refs)
    return _pack2(*argmax_stream(counts, min_diff, min_matches, sk_lens))


@partial(jax.jit, static_argnames=("num_refs", "min_diff", "min_matches"))
def filter_sketches_table(
    sk, sk_lens, table, ref_lens,
    num_refs: int, min_diff: int, min_matches: int,
):
    counts = lookup_intersection_counts(sk, sk_lens, (table,), num_refs)
    return argmax_filter(counts, min_diff, min_matches, sk_lens, ref_lens)


# ---------------------------------------------------------------------------
# hpv16 tiered classifier batches (rkmh.cpp:2656-2718)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("ks", "num_types", "num_uniq", "min_occ"))
def hpv16_batch(
    codes,
    type_table, uniq_table,
    ks: tuple, num_types: int, num_uniq: int,
    counter_table=None, min_occ: int = 0,
):
    """One read batch -> packed int64 [B, 2+U] (best, max_shared, uniq
    counts) — one D2H fetch per batch.

    The read's *full* sorted nonzero hash array (not a sketch) intersects
    each type's full hash set and each lineage/sublineage unique-kmer
    table — set semantics, the hash_set_intersection_size /
    sort_by_similarity comparators of rkmh.cpp:2673/2688, via the
    occ-0-only bucket tables of ops.lookup.build_set_table.  With -M,
    hashes below min_occ depth are zeroed first (mask_by_frequency,
    rkmh.cpp:2663) and so drop out of every intersection.
    """
    hashes = multi_k_window_hashes(codes, list(ks))
    if counter_table is not None:
        counts = counter_get(counter_table, hashes)
        hashes = mask_by_frequency(hashes, counts, min_occ)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    tc = lookup_intersection_counts(full, lens, (type_table,), num_types)
    uc = lookup_intersection_counts(full, lens, (uniq_table,), num_uniq)
    best = jnp.argmax(tc, axis=-1)          # first max == strict-> scan, init -1
    max_shared = jnp.max(tc, axis=-1)
    # pack into ONE int64 array [B, 2+U] — a single D2H fetch per batch
    return jnp.concatenate(
        [
            best.astype(jnp.int64)[:, None],
            max_shared.astype(jnp.int64)[:, None],
            uc.astype(jnp.int64),
        ],
        axis=1,
    )


# ---------------------------------------------------------------------------
# Split-dispatch hpv16 step.  The set-table row gather runs as its OWN
# dispatch, so XLA compiles it as a standalone gather instead of
# streaming the wide rows through the fused compare chain.  The split
# was chosen on the system's earlier accelerator and is not yet
# re-measured on the GPU (ROADMAP Queue 1, item 4).  Bit-identical to
# hpv16_batch — pure reorganization.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("ks", "nb_type", "nb_uniq", "min_occ"))
def hpv16_split_stage1(codes, ks: tuple, nb_type: int, nb_uniq: int,
                       counter_table=None, min_occ: int = 0):
    """hash (+ -M depth mask) -> full sorted hash array -> occ ranks +
    bucket indices for BOTH tables.  Returns (lo, hi, occ, qmask,
    bidx_type, bidx_uniq)."""
    from rkmh_tpu.ops.intersect import occ_ranks
    from rkmh_tpu.ops.lookup import bucket_indices
    from rkmh_tpu.ops.sketch import SENTINEL

    hashes = multi_k_window_hashes(codes, list(ks))
    if counter_table is not None:
        counts = counter_get(counter_table, hashes)
        hashes = mask_by_frequency(hashes, counts, min_occ)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    occ = occ_ranks(full).astype(jnp.uint32)
    qmask = (
        jnp.arange(full.shape[1], dtype=jnp.int32)[None, :] < lens[:, None]
    ) & (full != SENTINEL)
    lo = full.astype(jnp.uint32)
    hi = (full >> np.uint64(32)).astype(jnp.uint32)
    # raw bucket indices even for invalid slots: `hit` requires qmask, so
    # their rows never contribute, and pinning them to one bucket would
    # only concentrate the gather on a single row
    return (lo, hi, occ, qmask,
            bucket_indices(lo, hi, occ, nb_type),
            bucket_indices(lo, hi, occ, nb_uniq))


@partial(jax.jit, static_argnames=("L", "ks", "nb_type", "nb_uniq", "min_occ"))
def hpv16_split_stage1_packed4(packed, vbits, L: int, ks: tuple,
                               nb_type: int, nb_uniq: int,
                               counter_table=None, min_occ: int = 0):
    """hpv16_split_stage1 over the 2-bit packed wire format."""
    codes = unpack_codes4(packed, vbits, L)
    return hpv16_split_stage1.__wrapped__(
        codes, ks, nb_type, nb_uniq, counter_table, min_occ)


@jax.jit
def hpv16_split_gather(table, bidx):
    """A bare row gather — its own dispatch so XLA compiles it as a
    standalone kCustom gather fusion."""
    return table[bidx]


@partial(jax.jit, static_argnames=("num_types", "num_uniq"))
def hpv16_split_finish(rows_t, rows_u, lo, hi, occ, qmask,
                       num_types: int, num_uniq: int):
    """Compare tails over both pre-gathered row sets + argmax + int64
    packing (same layout as hpv16_batch)."""
    from rkmh_tpu.ops.lookup import counts_from_rows

    tc = counts_from_rows(rows_t, lo, hi, occ, qmask, num_types)
    uc = counts_from_rows(rows_u, lo, hi, occ, qmask, num_uniq)
    best = jnp.argmax(tc, axis=-1)
    max_shared = jnp.max(tc, axis=-1)
    return jnp.concatenate(
        [
            best.astype(jnp.int64)[:, None],
            max_shared.astype(jnp.int64)[:, None],
            uc.astype(jnp.int64),
        ],
        axis=1,
    )


def hpv16_batch_split(codes, type_table, uniq_table, ks: tuple,
                      num_types: int, num_uniq: int,
                      counter_table=None, min_occ: int = 0):
    """4-dispatch hpv16 step; result-identical to hpv16_batch."""
    lo, hi, occ, qmask, bidx_t, bidx_u = hpv16_split_stage1(
        codes, ks=ks, nb_type=type_table.shape[0],
        nb_uniq=uniq_table.shape[0],
        counter_table=counter_table, min_occ=min_occ)
    rows_t = hpv16_split_gather(type_table, bidx_t)
    rows_u = hpv16_split_gather(uniq_table, bidx_u)
    return hpv16_split_finish(rows_t, rows_u, lo, hi, occ, qmask,
                              num_types=num_types, num_uniq=num_uniq)


def hpv16_packed4_batch_split(packed, vbits, L: int, type_table, uniq_table,
                              ks: tuple, num_types: int, num_uniq: int,
                              counter_table=None, min_occ: int = 0):
    """4-dispatch hpv16 step over the packed wire format."""
    lo, hi, occ, qmask, bidx_t, bidx_u = hpv16_split_stage1_packed4(
        packed, vbits, L=L, ks=ks, nb_type=type_table.shape[0],
        nb_uniq=uniq_table.shape[0],
        counter_table=counter_table, min_occ=min_occ)
    rows_t = hpv16_split_gather(type_table, bidx_t)
    rows_u = hpv16_split_gather(uniq_table, bidx_u)
    return hpv16_split_finish(rows_t, rows_u, lo, hi, occ, qmask,
                              num_types=num_types, num_uniq=num_uniq)


# ---------------------------------------------------------------------------
# Combined-table hpv16 step.  The split step above pays for TWO set-table
# row gathers per element.  Merging both tables into ONE bucket table
# whose mask spans types + uniq groups (Wm=7 at 182+14 refs) halves the
# gather-row count for ~11% more row bytes: one 320 B-row gather
# replaces a 288 B-row and a narrow one.  tc/uc split back by bit range
# in the finish (type bits 0..T-1, group bits T..).  Result-identical to
# hpv16_batch over separate tables.
#
# The probe is also COMPACTED: stage1's full-row sort leaves every valid
# element in the prefix [0, lens_i), so slicing to a host-computed bound
# Wc >= max_i(valid windows of read i) drops the all-pad tail columns
# that padded-to-bucket-max short reads would otherwise probe (only
# occ==0 distinct valid elements can hit a set table; pad slots never
# do).  Wc is static (grid-rounded by the caller to bound recompiles);
# correctness needs only Wc >= max row valid count, which the
# window-count formula guarantees (zeros/-M masking only shrink a row's
# valid prefix).  Wc is the BATCH max, so one bucket-filling read makes
# Wc = W; compaction can only shrink the probe, never grow it.
# ---------------------------------------------------------------------------


def hpv16_compact_width(lens, L: int, ks: tuple, grid: int = 8) -> int:
    """Host-side compact probe width for a batch: max over reads of the
    multi-k window count sum_k max(len-k+1, 0), rounded UP to W/grid
    quanta (<= `grid` compiled shapes per padded length L).  Every row's
    valid-hash count is <= its window count, so slicing the sorted rows
    to this width loses nothing."""
    W = sum(max(L - k + 1, 0) for k in ks)
    lens = np.asarray(lens)
    need = 0
    for k in ks:
        need += int(np.max(np.maximum(lens - (k - 1), 0), initial=0))
    if need >= W:
        return W
    q = max(1, -(-W // grid))
    return min(W, max(q, -(-need // q) * q))


@partial(jax.jit, static_argnames=("ks", "nb", "Wc", "min_occ"))
def hpv16_comb_stage1(codes, ks: tuple, nb: int, Wc: int,
                      counter_table=None, min_occ: int = 0):
    """hash (+ -M depth mask) -> full sorted hash array, compacted to the
    first Wc columns -> occ ranks + combined-table bucket indices.
    Returns (lo, hi, occ, qmask, bidx) of width Wc."""
    from rkmh_tpu.ops.intersect import occ_ranks
    from rkmh_tpu.ops.lookup import bucket_indices
    from rkmh_tpu.ops.sketch import SENTINEL

    hashes = multi_k_window_hashes(codes, list(ks))
    if counter_table is not None:
        counts = counter_get(counter_table, hashes)
        hashes = mask_by_frequency(hashes, counts, min_occ)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    full = full[:, :Wc]  # sorted rows: valid prefix [0, lens_i) <= Wc
    occ = occ_ranks(full).astype(jnp.uint32)
    qmask = (
        jnp.arange(Wc, dtype=jnp.int32)[None, :] < lens[:, None]
    ) & (full != SENTINEL)
    lo = full.astype(jnp.uint32)
    hi = (full >> np.uint64(32)).astype(jnp.uint32)
    # raw bucket indices even for invalid slots (see hpv16_split_stage1)
    return lo, hi, occ, qmask, bucket_indices(lo, hi, occ, nb)


@partial(jax.jit, static_argnames=("L", "ks", "nb", "Wc", "min_occ"))
def hpv16_comb_stage1_packed4(packed, vbits, L: int, ks: tuple,
                              nb: int, Wc: int,
                              counter_table=None, min_occ: int = 0):
    """hpv16_comb_stage1 over the 2-bit packed wire format."""
    codes = unpack_codes4(packed, vbits, L)
    return hpv16_comb_stage1.__wrapped__(
        codes, ks, nb, Wc, counter_table, min_occ)


@partial(jax.jit, static_argnames=("num_types", "num_uniq"))
def hpv16_comb_finish(rows, lo, hi, occ, qmask,
                      num_types: int, num_uniq: int):
    """Compare tail over the pre-gathered combined rows; counts split
    back into type/uniq ranges by bit position, then the same argmax +
    int64 packing as hpv16_batch."""
    from rkmh_tpu.ops.lookup import counts_from_rows

    counts = counts_from_rows(rows, lo, hi, occ, qmask, num_types + num_uniq)
    tc = counts[:, :num_types]
    uc = counts[:, num_types:]
    best = jnp.argmax(tc, axis=-1)
    max_shared = jnp.max(tc, axis=-1)
    return jnp.concatenate(
        [
            best.astype(jnp.int64)[:, None],
            max_shared.astype(jnp.int64)[:, None],
            uc.astype(jnp.int64),
        ],
        axis=1,
    )


def hpv16_batch_comb(codes, comb_table, ks: tuple,
                     num_types: int, num_uniq: int, Wc: int,
                     counter_table=None, min_occ: int = 0):
    """3-dispatch combined-table hpv16 step; result-identical to
    hpv16_batch over separate type/uniq tables."""
    lo, hi, occ, qmask, bidx = hpv16_comb_stage1(
        codes, ks=ks, nb=comb_table.shape[0], Wc=Wc,
        counter_table=counter_table, min_occ=min_occ)
    rows = hpv16_split_gather(comb_table, bidx)
    return hpv16_comb_finish(rows, lo, hi, occ, qmask,
                             num_types=num_types, num_uniq=num_uniq)


def hpv16_packed4_batch_comb(packed, vbits, L: int, comb_table, ks: tuple,
                             num_types: int, num_uniq: int, Wc: int,
                             counter_table=None, min_occ: int = 0):
    """3-dispatch combined-table hpv16 step over the packed wire format."""
    lo, hi, occ, qmask, bidx = hpv16_comb_stage1_packed4(
        packed, vbits, L=L, ks=ks, nb=comb_table.shape[0], Wc=Wc,
        counter_table=counter_table, min_occ=min_occ)
    rows = hpv16_split_gather(comb_table, bidx)
    return hpv16_comb_finish(rows, lo, hi, occ, qmask,
                             num_types=num_types, num_uniq=num_uniq)


# ---------------------------------------------------------------------------
# Sorted-panel hpv16 step: the over-budget fallback.  When the combined
# panel would produce a bucket table past RKMH_TPU_SET_TABLE_MAX_MB
# (a refpath override with a much larger genome panel), the driver
# builds ops.lookup.build_sorted_panel's ~10x-smaller (keys, masks)
# pair instead and probes it here by searchsorted (log2 U steps per
# element vs the bucket table's one gather).  Result-identical.
# ---------------------------------------------------------------------------


def _hpv16_sorted_core(hashes, keys, masks, Wc: int,
                       num_types: int, num_uniq: int,
                       counter_table, min_occ: int):
    from rkmh_tpu.ops.intersect import occ_ranks
    from rkmh_tpu.ops.lookup import sorted_panel_counts_masked
    from rkmh_tpu.ops.sketch import SENTINEL

    if counter_table is not None:
        counts = counter_get(counter_table, hashes)
        hashes = mask_by_frequency(hashes, counts, min_occ)
    full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
    full = full[:, :Wc]
    occ = occ_ranks(full)
    qmask = (
        (jnp.arange(Wc, dtype=jnp.int32)[None, :] < lens[:, None])
        & (full != SENTINEL)
        & (occ == 0)          # set semantics: first occurrence only
    )
    counts = sorted_panel_counts_masked(
        full, qmask, keys, masks, num_types + num_uniq)
    tc = counts[:, :num_types]
    uc = counts[:, num_types:]
    best = jnp.argmax(tc, axis=-1)
    max_shared = jnp.max(tc, axis=-1)
    return jnp.concatenate(
        [
            best.astype(jnp.int64)[:, None],
            max_shared.astype(jnp.int64)[:, None],
            uc.astype(jnp.int64),
        ],
        axis=1,
    )


@partial(jax.jit, static_argnames=("ks", "num_types", "num_uniq", "Wc",
                                   "min_occ"))
def hpv16_sorted_batch(codes, keys, masks, ks: tuple,
                       num_types: int, num_uniq: int, Wc: int,
                       counter_table=None, min_occ: int = 0):
    """Combined-panel hpv16 step over a sorted-key panel (see above)."""
    hashes = multi_k_window_hashes(codes, list(ks))
    return _hpv16_sorted_core(hashes, keys, masks, Wc, num_types, num_uniq,
                              counter_table, min_occ)


@partial(jax.jit, static_argnames=("L", "ks", "num_types", "num_uniq", "Wc",
                                   "min_occ"))
def hpv16_sorted_packed4_batch(packed, vbits, L: int, keys, masks, ks: tuple,
                               num_types: int, num_uniq: int, Wc: int,
                               counter_table=None, min_occ: int = 0):
    """hpv16_sorted_batch over the 2-bit packed wire format."""
    codes = unpack_codes4(packed, vbits, L)
    hashes = multi_k_window_hashes(codes, list(ks))
    return _hpv16_sorted_core(hashes, keys, masks, Wc, num_types, num_uniq,
                              counter_table, min_occ)


@partial(jax.jit, static_argnames=("num_refs", "min_diff", "min_matches"))
def filter_sketches_table_packed(
    sk, sk_lens, table, ref_lens,
    num_refs: int, min_diff: int, min_matches: int,
):
    """filter_sketches_table packed into ONE int64 [5, B] array
    (best, shared, total_union, keep, flag bits depth|match<<1|diff_ok<<2)
    — a single D2H fetch per batch (see classify_sketches_table_packed)."""
    counts = lookup_intersection_counts(sk, sk_lens, (table,), num_refs)
    best, shared, tu, keep, depth_fail, match_fail, diff_ok = argmax_filter(
        counts, min_diff, min_matches, sk_lens, ref_lens
    )
    flags = (
        depth_fail.astype(jnp.int64)
        | (match_fail.astype(jnp.int64) << 1)
        | (diff_ok.astype(jnp.int64) << 2)
    )
    return jnp.stack([
        best.astype(jnp.int64), shared.astype(jnp.int64),
        tu.astype(jnp.int64), keep.astype(jnp.int64), flags,
    ])


@partial(jax.jit, static_argnames=("ks",))
def distinct_hash_mask(codes, lengths, ks: tuple):
    """(sorted window hashes, first-occurrence-within-row mask).

    Used by filter -I, which counts each hash once per reference *sample*
    (set semantics — rkmh.cpp:340-357 builds a std::set per ref before
    incrementing).  Zeros are included, as the reference's set contains
    the 0 sentinel too.
    """
    from rkmh_tpu.ops.intersect import occ_ranks, sort_hashes_padded

    hashes = multi_k_window_hashes(codes, list(ks))
    wmask = window_mask(lengths, codes.shape[-1], list(ks))
    x, _ = sort_hashes_padded(hashes, wmask)
    occ = occ_ranks(x)
    from rkmh_tpu.ops.sketch import SENTINEL as _S

    return x, (occ == 0) & (x != _S)
