"""Panel lookup table: single-gather sketch intersection.

The classify hot loop needs, for every read-sketch element, the set of
references whose sketch contains that (value, occurrence) pair.  Binary
search per (read, ref) pair (ops/intersect.py) costs O(B*s*R*log t)
serialized scalar gathers.  This module replaces it
with a **host-built bucketized hash table queried with ONE contiguous
row-gather per element**:

* every (hash, occ) pair present in any reference sketch becomes one
  entry whose payload is a bitmask over references (bit r set iff ref
  r's sketch holds >= occ+1 copies of the hash);
* entries land in power-of-two buckets of SLOTS entries via a
  mult-shift mix of both 32-bit hash halves; the builder doubles the
  bucket count on overflow (load factor ~0.25, so overflow is rare);
* a bucket row is laid out slot-major as u32 lanes
  [hi*S | lo*S | occ*S | mask_w*S ...] so one gather of a 4*S*(3+Wm)
  byte row fetches every candidate, and the slot compare + mask select
  runs vectorized — no second probe, no scattered loads.  Row gather
  traffic and compare width scale with SLOTS, so SLOTS is the main
  throughput knob of the probe.

Duplicate semantics stay exact (SURVEY §7 "hard parts"): a value with
multiplicity ca in the read and cb in ref r contributes min(ca, cb)
because the read's element #occ matches iff cb > occ.  Keys store the
full 64-bit hash plus the occurrence index, so matches are exact — no
false positives beyond murmur collisions the reference itself has.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from rkmh_tpu.ops.sketch import SENTINEL
from rkmh_tpu.utils import next_pow2

# Slots per bucket.  The probe gathers one 4*S*(3+Wm)-byte row per
# element, so the slot width directly scales the probe's bytes.  Fewer
# slots -> smaller rows but more buckets (the builder doubles the bucket
# count until nothing overflows, and smaller buckets need
# proportionally lower load to avoid overflow).  Builders pick the
# smallest S whose predicted table stays under a size budget
# (pick_slots), and queries derive S from the table shape.  The policy
# was tuned on the system's earlier accelerator and is not yet
# re-measured on the GPU (ROADMAP Queue 1, item 4).  RKMH_TPU_SLOTS
# forces a width everywhere; SLOTS below is the fallback for
# forced-shape builds (tensor-parallel shards) and empty tables.
_FORCED_SLOTS = __import__("os").environ.get("RKMH_TPU_SLOTS")
if _FORCED_SLOTS is not None:
    try:
        _forced_val = int(_FORCED_SLOTS)
    except ValueError:
        raise ValueError(
            f"RKMH_TPU_SLOTS={_FORCED_SLOTS!r}: must be a positive integer "
            "slot count (e.g. 2, 4, 8); unset it to auto-pick per panel"
        ) from None
    if _forced_val < 1:
        raise ValueError(
            f"RKMH_TPU_SLOTS={_FORCED_SLOTS!r}: must be >= 1; unset it to "
            "auto-pick per panel"
        )
    SLOTS = _forced_val
else:
    SLOTS = 4
_BUDGET_MB = int(__import__("os").environ.get("RKMH_TPU_TABLE_BUDGET_MB", "64"))

def predicted_buckets(n_entries: int, slots: int) -> int:
    """Bucket count at which a random drop of n entries overflows nowhere
    (expected overflowing buckets < 0.5, Poisson occupancy model).

    Doubling from the naive 25%-load start converges here anyway — this
    predicts the endpoint so builders (a) can size-budget slot widths and
    (b) start device builds at the right shape instead of paying one
    XLA recompile per doubling step."""
    import math

    n = max(n_entries, 1)
    nb = max(2, next_pow2((4 * n + slots - 1) // slots))
    while True:
        lam = n / nb
        # P(Poisson(lam) > slots)
        tail = 1.0 - math.exp(-lam) * sum(
            lam**i / math.factorial(i) for i in range(slots + 1)
        )
        if nb * tail < 0.5 or nb >= 1 << 30:
            return nb
        nb *= 2


def pick_slots(n_entries: int, mask_words: int, forced: int | None = None,
               policy: str = "narrow") -> int:
    """Slot width for a new table.

    policy="narrow" (classify panels): smallest S whose predicted table
    fits the size budget — the classify probe fuses the gather with its
    consumers, where cost tracks ROW BYTES.

    policy="compact" (set tables, split-gather probes): the S in
    {2, 3, 4} with the fewest predicted table BYTES — a standalone
    gather costs about the same per row until the table outgrows
    locality, so total size wins.  When even the best candidate busts
    the budget (the hundreds-of-MB hpv16 panels), min-bytes again
    decides between S=8 and S=12: wider rows cost more per gathered row,
    narrower ones more buckets.  Both policies were tuned on the
    system's earlier accelerator (ROADMAP Queue 1, item 4)."""
    if forced:
        return forced
    if _FORCED_SLOTS:
        return SLOTS
    budget = _BUDGET_MB * (1 << 20)
    if policy == "compact":
        best, best_bytes = None, None
        for s in (2, 3, 4):
            nb = predicted_buckets(n_entries, s)
            size = 4 * s * (3 + mask_words) * nb
            if best_bytes is None or size < best_bytes:
                best, best_bytes = s, size
        if best_bytes <= budget:
            return best
        return min(
            (8, 12),
            key=lambda s: 4 * s * (3 + mask_words)
            * predicted_buckets(n_entries, s),
        )
    for s in (2, 4):
        nb = predicted_buckets(n_entries, s)
        if 4 * s * (3 + mask_words) * nb <= budget:
            return s
    return 8


def projected_table_bytes(n_entries: int, num_refs: int,
                          policy: str = "compact") -> int:
    """Predicted byte size of a bucket table for n entries over num_refs
    — what the auto-picked (slots, buckets) geometry will allocate.
    Drivers use it to decide bucket table vs the sorted-panel fallback
    BEFORE paying for the device build."""
    wm = max(1, (num_refs + 31) // 32)
    s = pick_slots(n_entries, wm, policy=policy)
    return 4 * s * (3 + wm) * predicted_buckets(max(n_entries, 1), s)


def table_slots(width: int, num_refs: int) -> int:
    """Slot width of a table row, derived from its lane count.

    width = S * (3 + Wm) with Wm = ceil(num_refs/32); every query path
    derives S this way so tables built at any width interoperate."""
    wm = max(1, (num_refs + 31) // 32)
    s, rem = divmod(width, 3 + wm)
    if rem or s < 1:
        raise ValueError(
            f"table width {width} is not S*(3+{wm}) for num_refs={num_refs}")
    return s


_EMPTY_OCC = np.uint32(0xFFFFFFFF)
_MIX = 0x85EBCA77
_MUL = 0x9E3779B1


@dataclass
class PanelTable:
    """Host-built, device-queried (hash, occ) -> ref-bitmask bucket table.

    table: [NB, SLOTS*(3+Wm)] uint32, slot-major lanes (see module doc).
    """

    table: np.ndarray
    num_refs: int
    mask_words: int

    @property
    def num_buckets(self) -> int:
        return self.table.shape[0]

    def device_arrays(self):
        return (jnp.asarray(self.table),)


def _collect_entries(ref_sk: np.ndarray, ref_lens, R: int, Wm: int):
    """(hash, occ) -> bitmask entries as parallel numpy arrays."""
    hs, occs, rids = [], [], []
    for r in range(ref_sk.shape[0]):
        row = ref_sk[r]
        if ref_lens is not None:
            row = row[: int(np.asarray(ref_lens)[r])]
        row = row[row != SENTINEL]
        if row.size == 0:
            continue
        # occurrence rank within the sorted row
        occ = np.arange(row.size) - np.searchsorted(row, row, side="left")
        hs.append(row)
        occs.append(occ)
        rids.append(np.full(row.size, r, dtype=np.int64))
    if not hs:
        return None
    h = np.concatenate(hs).astype(np.uint64)
    o = np.concatenate(occs).astype(np.uint32)
    rid = np.concatenate(rids)

    # unique (hash, occ) pairs; build masks by OR-ing ref bits
    pair = np.stack([h, o.astype(np.uint64)], axis=1)
    uniq, inv = np.unique(pair, axis=0, return_inverse=True)
    masks = np.zeros((len(uniq), Wm), dtype=np.uint32)
    np.bitwise_or.at(
        masks, (inv, rid // 32), (np.uint32(1) << (rid % 32).astype(np.uint32))
    )
    return uniq[:, 0], uniq[:, 1].astype(np.uint32), masks


def _bucket_of(lo: np.ndarray, hi: np.ndarray, occ: np.ndarray, nb: int):
    """Mult-shift mix of both halves + occ; must match the device version."""
    x = (lo ^ (hi * np.uint32(_MIX)) ^ (occ * np.uint32(_MIX))) * np.uint32(_MUL)
    return (x >> np.uint32(32 - int(np.log2(nb)))).astype(np.int64)


def build_panel_table(ref_sk: np.ndarray, ref_lens=None, num_refs: int | None = None,
                      num_buckets: int | None = None,
                      slots: int | None = None,
                      policy: str = "narrow") -> PanelTable:
    """Build the bucket table from a sorted sketch matrix [R, t] uint64
    (SENTINEL-padded rows, as produced by bottom_s_sketch).

    num_buckets / slots force the table geometry — used to give every
    tensor-parallel shard an identically-shaped table.  By default the
    slot width is auto-picked per panel size (pick_slots).
    """
    ref_sk = np.asarray(ref_sk, dtype=np.uint64)
    R = ref_sk.shape[0] if num_refs is None else num_refs
    Wm = max(1, (R + 31) // 32)

    ents = _collect_entries(ref_sk, ref_lens, R, Wm)
    if ents is None:
        S = pick_slots(0, Wm, slots, policy)
        nb0 = num_buckets or 1
        empty = np.zeros((nb0, S * (3 + Wm)), dtype=np.uint32)
        empty[:, 2 * S : 3 * S] = _EMPTY_OCC
        return PanelTable(empty, R, Wm)
    h, occ, masks = ents
    n = len(h)
    S = pick_slots(n, Wm, slots, policy)
    lo = h.astype(np.uint32)
    hi = (h >> np.uint64(32)).astype(np.uint32)

    # predicted_buckets returns the converged bucket count (small slot
    # widths run intentionally sparse); the loop below still doubles in
    # the rare realizations that overflow anyway
    nb = num_buckets or predicted_buckets(n, S)
    while True:
        b = _bucket_of(lo, hi, occ, nb)
        order = np.argsort(b, kind="stable")
        bs = b[order]
        # slot index within each bucket = rank within equal-b run
        starts = np.searchsorted(bs, bs, side="left")
        slot = np.arange(n) - starts
        if slot.max(initial=0) < S:
            # the query path compares only (lo, occ) per slot and verifies
            # hi on the selected entry — so no bucket may hold two entries
            # with equal (lo, occ).  Collision odds are ~n^2/(nb*2^32);
            # rebuild sparser in the astronomically rare case.
            trip = np.stack([bs, lo[order].astype(np.int64), occ[order].astype(np.int64)], 1)
            uniq_rows = np.unique(trip, axis=0)
            if len(uniq_rows) == n:
                break
        nb *= 2  # a bucket overflowed (or (lo,occ) collided): rebuild sparser

    width = S * (3 + Wm)
    table = np.zeros((nb, width), dtype=np.uint32)
    table[:, 2 * S : 3 * S] = _EMPTY_OCC
    bo, so = bs, slot
    table[bo, so] = hi[order]
    table[bo, S + so] = lo[order]
    table[bo, 2 * S + so] = occ[order]
    for w in range(Wm):
        table[bo, (3 + w) * S + so] = masks[order, w]
    return PanelTable(table, R, Wm)


def lookup_intersection_counts_masked(read_sk, qmask, occ, table_arrays,
                                      num_refs: int):
    """[B, s] read hash arrays (ANY order) + validity mask + per-element
    duplicate ranks -> [B, R] intersection counts via the bucket table.

    Order-free core of lookup_intersection_counts: the table probe only
    needs each element's value and its occurrence rank, so callers that
    already know the ranks (e.g. the sort-free short-read path) skip the
    row sort entirely."""
    lo = read_sk.astype(jnp.uint32)
    hi = (read_sk >> np.uint64(32)).astype(jnp.uint32)
    return lookup_intersection_counts_masked_pair(
        lo, hi, qmask, occ, table_arrays, num_refs
    )


def bucket_indices(lo, hi, occ, nb: int):
    """The (lo, hi, occ) -> bucket mult-shift mix, device side — must
    match _bucket_of."""
    occ = occ.astype(jnp.uint32)
    shift = np.uint32(32 - int(np.log2(nb)))
    x = (lo ^ (hi * np.uint32(_MIX)) ^ (occ * np.uint32(_MIX))) * np.uint32(_MUL)
    return (x >> shift).astype(jnp.int32)


def lookup_intersection_counts_masked_pair(lo, hi, qmask, occ, table_arrays,
                                           num_refs: int):
    """lookup_intersection_counts_masked with the hash halves supplied as
    u32 arrays.  Composition of bucket_indices -> gather ->
    counts_from_rows, fused in one program (right for the small classify
    panels; the hpv16-scale tables split the gather into its own
    dispatch — classify/engine.hpv16_split_*)."""
    (table,) = table_arrays
    bidx = bucket_indices(lo, hi, occ, table.shape[0])
    # invalid slots keep their raw bucket index: `hit` requires qmask, so
    # those rows never contribute
    rows = table[bidx]                                     # [B, s, width]
    return counts_from_rows(rows, lo, hi, occ, qmask, num_refs)


def counts_from_rows(rows, lo, hi, occ, qmask, num_refs: int):
    """The probe's compare + mask-popcount tail over PRE-GATHERED bucket
    rows — split out so callers can run the gather in its own dispatch
    (engine.hpv16_split_*)."""
    S = table_slots(rows.shape[-1], num_refs)
    Wm = rows.shape[-1] // S - 3
    occ = occ.astype(jnp.uint32)
    hi_e = rows[..., 0:S]
    lo_e = rows[..., S : 2 * S]
    occ_e = rows[..., 2 * S : 3 * S]
    # slot match on (lo, occ) only — the builder guarantees uniqueness of
    # (lo, occ) within a bucket, and hi is verified on the selected entry
    # (fewer VPU compare lanes than a 3-way per-slot compare)
    hit = (
        (lo_e == lo[..., None])
        & (occ_e == occ[..., None])
        & qmask[..., None]
    )                                                      # [B, s, S]
    zero = np.uint32(0)
    sel_hi = jnp.max(jnp.where(hit, hi_e, zero), axis=-1)  # [B, s]
    ok = sel_hi == hi                                      # kills hi mismatches

    from rkmh_tpu.ops.popcount import vertical_popcounts

    counts = []
    for w in range(Wm):
        mw = rows[..., (3 + w) * S : (4 + w) * S]
        # at most one slot matches: OR-select its mask word
        sel = jnp.max(jnp.where(hit, mw, zero), axis=-1)   # [B, s]
        sel = jnp.where(ok, sel, zero)
        # all 32 per-ref counts of this word at once (adder tree, ~5
        # ops/element instead of 2 ops per ref per element)
        counts.append(vertical_popcounts(sel, min(32, num_refs - 32 * w)))
    return jnp.concatenate(counts, axis=-1)  # [B, R]


def lookup_intersection_counts(read_sk, read_lens, table_arrays, num_refs: int):
    """[B, s] sorted read sketches -> [B, R] intersection counts, exactly
    matching intersect.intersection_counts, via the bucket table."""
    from rkmh_tpu.ops.intersect import occ_ranks

    B, s = read_sk.shape
    occ = occ_ranks(read_sk).astype(jnp.uint32)
    qmask = (jnp.arange(s, dtype=jnp.int32)[None, :] < read_lens[:, None]) & (
        read_sk != SENTINEL
    )
    return lookup_intersection_counts_masked(
        read_sk, qmask, occ, table_arrays, num_refs
    )


def build_set_table(ref_hash_rows: list, num_refs: int | None = None) -> PanelTable:
    """Per-ref *distinct* hash arrays -> bucket table with occ=0 entries.

    The hpv16 comparators are set intersections (hash_set_intersection_size
    / sort_by_similarity, rkmh.cpp:2673/2688): only each hash's first
    occurrence can match (duplicate query elements carry occ>0 and miss),
    so querying with a full sorted read array yields distinct counts.
    """
    rows = []
    maxlen = 1
    cleaned = []
    for row in ref_hash_rows:
        row = np.unique(np.asarray(row, dtype=np.uint64))
        row = row[row != 0]
        cleaned.append(row)
        maxlen = max(maxlen, len(row))
    R = num_refs if num_refs is not None else len(cleaned)
    mat = np.full((len(cleaned), maxlen), SENTINEL, dtype=np.uint64)
    lens = np.zeros(len(cleaned), dtype=np.int32)
    for i, row in enumerate(cleaned):
        mat[i, : len(row)] = row
        lens[i] = len(row)
    return build_panel_table(mat, lens, num_refs=R, policy="compact")


# ---------------------------------------------------------------------------
# Device-side set-table build (hpv16-scale panels)
# ---------------------------------------------------------------------------
# The 182-genome PAVE panel produces a bucket table of hundreds of MB;
# building it host-side would ship all of it host->device.  Here the
# whole build — dedup,
# mask OR, bucketing, slot ranking, scatter — runs on device from the
# window hashes that are already there.  Query-compatible with
# build_set_table's tables (same bucket function; slot order within a
# bucket may differ, which queries don't observe).


def _device_set_table(hashes, mask, nb: int, num_refs: int, occs=None,
                      slots: int = SLOTS):
    """hashes [R, W] u64 + validity mask (+ optional per-element occ
    ranks) -> (table [nb, slots*(3+Wm)] u32, max_rank for overflow).

    With occs=None every entry is occ=0 (set semantics — the hpv16
    comparators); with occs given (occ_ranks of per-row sorted sketch
    matrices) the full (hash, occ) multiset table is built, identical in
    query behavior to the host build_panel_table."""
    R, W = hashes.shape
    Wm = max(1, (num_refs + 31) // 32)
    N = R * W

    h = jnp.where(mask & (hashes != np.uint64(0)), hashes, SENTINEL).reshape(-1)
    rid = jnp.broadcast_to(
        jnp.arange(R, dtype=jnp.uint32)[:, None], (R, W)
    ).reshape(-1)
    oc = (
        jnp.zeros((N,), jnp.uint32) if occs is None
        else occs.reshape(-1).astype(jnp.uint32)
    )

    # sort by (hash, occ, rid); dedup triplets, then (hash, occ) segments
    hs, ocs, rids = jax.lax.sort((h, oc, rid), num_keys=3)
    prev_h = jnp.concatenate([hs[:1] ^ np.uint64(1), hs[:-1]])
    prev_o = jnp.concatenate([ocs[:1] ^ np.uint32(1), ocs[:-1]])
    prev_r = jnp.concatenate([rids[:1] ^ np.uint32(1), rids[:-1]])
    key_first = (hs != prev_h) | (ocs != prev_o)
    pair_first = key_first | (rids != prev_r)
    valid = hs != SENTINEL
    seg = jnp.cumsum(key_first.astype(jnp.int32)) - 1           # [N]
    n_unique = jnp.sum((key_first & valid).astype(jnp.int32))

    # per-entry mask words: scatter-add of distinct ref bits (add == or
    # because (hash, occ, rid) triplets are deduped)
    bit = jnp.where(
        pair_first & valid, np.uint32(1) << (rids % np.uint32(32)), np.uint32(0)
    ).astype(jnp.uint32)
    word = (rids // np.uint32(32)).astype(jnp.int32)
    maskbuf = jnp.zeros((N, Wm), jnp.uint32).at[seg, word].add(bit)

    # entry keys at segment slots
    ehash = jnp.zeros((N,), jnp.uint64).at[seg].max(jnp.where(key_first, hs, np.uint64(0)))
    eocc = jnp.zeros((N,), jnp.uint32).at[seg].max(jnp.where(key_first, ocs, np.uint32(0)))
    eidx = jnp.arange(N, dtype=jnp.int32)
    evalid = eidx < n_unique

    lo = ehash.astype(jnp.uint32)
    hi = (ehash >> np.uint64(32)).astype(jnp.uint32)
    shift = np.uint32(32 - int(np.log2(nb)))
    x = (lo ^ (hi * np.uint32(_MIX)) ^ (eocc * np.uint32(_MIX))) * np.uint32(_MUL)
    bidx = jnp.where(evalid, (x >> shift).astype(jnp.int32), nb)

    # rank within bucket: sort entries by (bucket, lo, occ) — the extra
    # keys let adjacent-duplicate detection enforce the (lo, occ)-unique-
    # per-bucket invariant the query's 2-lane compare relies on
    sb, sl, soc, shi, sm_i = jax.lax.sort(
        (bidx.astype(jnp.int32), lo, eocc, hi, eidx), num_keys=3
    )
    iota = jnp.arange(N, dtype=jnp.int32)
    run_first = jnp.concatenate([jnp.ones(1, bool), sb[1:] != sb[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(run_first, iota, 0)
    )
    rank = iota - run_start
    smask = maskbuf[sm_i]
    svalid = sb < nb
    collide = (
        ~run_first[1:] & (sl[1:] == sl[:-1]) & (soc[1:] == soc[:-1]) & svalid[1:]
    )
    # report overflow OR (lo, occ) collision via the same retry signal
    max_rank = jnp.maximum(
        jnp.max(jnp.where(svalid, rank, -1)),
        jnp.where(jnp.any(collide), slots, -1),
    )

    width = slots * (3 + Wm)
    table = jnp.zeros((nb + 1, width), jnp.uint32)
    table = table.at[:, 2 * slots : 3 * slots].set(_EMPTY_OCC)
    b_safe = jnp.where(svalid & (rank < slots), sb, nb)
    r_safe = jnp.clip(rank, 0, slots - 1)
    table = table.at[b_safe, r_safe].set(shi)
    table = table.at[b_safe, slots + r_safe].set(sl)
    table = table.at[b_safe, 2 * slots + r_safe].set(soc)
    for w in range(Wm):
        table = table.at[b_safe, (3 + w) * slots + r_safe].set(smask[:, w])
    return table[:nb], max_rank


_device_set_table_jit = jax.jit(
    _device_set_table, static_argnames=("nb", "num_refs", "slots")
)


@jax.jit
def _count_unique_keys(hashes, mask, occs=None):
    """Exact count of distinct (hash, occ) keys — sizes the bucket array
    identically to the host builder (entry-count overestimates would
    change the table shape and force downstream recompiles)."""
    N = hashes.size
    h = jnp.where(mask & (hashes != np.uint64(0)), hashes, SENTINEL).reshape(-1)
    oc = (
        jnp.zeros((N,), jnp.uint32) if occs is None
        else occs.reshape(-1).astype(jnp.uint32)
    )
    hs, ocs = jax.lax.sort((h, oc), num_keys=2)
    prev_h = jnp.concatenate([hs[:1] ^ np.uint64(1), hs[:-1]])
    prev_o = jnp.concatenate([ocs[:1] ^ np.uint32(1), ocs[:-1]])
    key_first = (hs != prev_h) | (ocs != prev_o)
    return jnp.sum((key_first & (hs != SENTINEL)).astype(jnp.int32))


def build_set_table_device(hashes, mask, num_refs: int, est_entries: int | None = None):
    """Device-resident set table from window hashes (see _device_set_table).

    Retries with doubled bucket counts on (rare) slot overflow; returns a
    device u32 array compatible with lookup_intersection_counts.
    """
    n = est_entries or int(_count_unique_keys(hashes, mask))
    S = pick_slots(n, max(1, (num_refs + 31) // 32), policy="compact")
    nb = predicted_buckets(n, S)
    while True:
        table, max_rank = _device_set_table_jit(hashes, mask, nb, num_refs,
                                                slots=S)
        if int(max_rank) < S:
            return table
        nb *= 2


def build_sharded_set_tables_device(hashes, mask, tp: int):
    """[R, W] window hashes/mask -> ([tp, NB, width] stacked set tables,
    refs_per_shard) for tensor-parallel set-intersection queries
    (parallel.mesh.ShardedHpv16Comb via place_tp_comb_table).

    Rows split into tp contiguous groups (R % tp == 0 — pad upstream
    with all-masked rows; pads at the END keep the first-reference
    tie-break exact after the tiled all_gather).  Every shard is forced
    to one (num_buckets, slots) geometry so shard_map can stack them.
    """
    R = hashes.shape[0]
    if R % tp:
        raise ValueError(f"{R} refs not divisible by tp {tp}")
    rps = R // tp
    wm = max(1, (rps + 31) // 32)
    groups = [(hashes[i * rps:(i + 1) * rps], mask[i * rps:(i + 1) * rps])
              for i in range(tp)]
    ns = [int(_count_unique_keys(h, m)) for h, m in groups]
    S = pick_slots(max(max(ns), 1), wm, policy="compact")
    nb = max(predicted_buckets(n, S) for n in ns)
    while True:
        tables = []
        for h, m in groups:
            t, max_rank = _device_set_table_jit(h, m, nb, rps, slots=S)
            if int(max_rank) >= S:  # rare bucket overflow: regrow ALL
                tables = None
                break
            tables.append(t)
        if tables is not None:
            return jnp.stack(tables), rps
        nb *= 2


def build_panel_table_device(ref_sk, ref_lens, num_refs: int | None = None):
    """Device-resident (hash, occ) panel table from sorted sketch matrices
    (bottom_s_sketch output) — the no-host-roundtrip equivalent of
    build_panel_table, query-identical."""
    from rkmh_tpu.ops.intersect import occ_ranks

    R, s = ref_sk.shape
    num_refs = R if num_refs is None else num_refs
    qmask = jnp.arange(s, dtype=jnp.int32)[None, :] < ref_lens[:, None]
    occs = occ_ranks(ref_sk)
    n = int(_count_unique_keys(ref_sk, qmask, occs))
    S = pick_slots(n, max(1, (num_refs + 31) // 32))
    nb = predicted_buckets(n, S)
    while True:
        table, max_rank = _device_set_table_jit(ref_sk, qmask, nb, num_refs,
                                                occs, slots=S)
        if int(max_rank) < S:
            return table
        nb *= 2


# ---------------------------------------------------------------------------
# Sorted-key panel: distinct-set membership for large full-hash panels
# ---------------------------------------------------------------------------
# The hpv16 type-level comparator intersects each read's *full* hash set
# with 182 reference hash *sets* (hash_set_intersection_size,
# rkmh.cpp:2669-2678) — ~1.4M distinct (hash, ref) pairs.  Keys here are
# deduplicated, so occ disambiguation is unnecessary: a sorted unique-key
# array + bitmask matrix builds in O(n log n) numpy and queries with one
# searchsorted (log2 U ~ 20 steps) per element.
#
# Production role: the OVER-BUDGET FALLBACK for hpv16-style set panels.
# The bucket table trades memory for one-gather probes (~600 MB at 182
# refs); its size grows with the bucket count, so a refpath override
# with a much larger panel can outgrow HBM.  The sorted panel is
# ~10x smaller (keys + masks only, no slot padding) at log2(U)
# searchsorted steps per element; commands/hpv16_cmd.build_tables
# switches to it when the projected bucket-table bytes exceed
# RKMH_TPU_SET_TABLE_MAX_MB (engine.hpv16_sorted_batch is the matching
# probe step, result-identical).


def build_sorted_panel(ref_hash_rows: list, num_refs: int | None = None):
    """Per-ref distinct hash arrays -> (sorted unique keys [U] u64,
    masks [U, Wm] u32).  Zeros (invalid k-mers) are excluded."""
    R = num_refs if num_refs is not None else len(ref_hash_rows)
    Wm = max(1, (R + 31) // 32)
    keys_all = []
    refs_all = []
    for r, row in enumerate(ref_hash_rows):
        row = np.unique(np.asarray(row, dtype=np.uint64))
        row = row[row != 0]
        keys_all.append(row)
        refs_all.append(np.full(len(row), r, dtype=np.int64))
    if not keys_all or sum(len(x) for x in keys_all) == 0:
        return np.zeros(1, dtype=np.uint64), np.zeros((1, Wm), dtype=np.uint32)
    keys_cat = np.concatenate(keys_all)
    refs_cat = np.concatenate(refs_all)
    uniq, inv = np.unique(keys_cat, return_inverse=True)
    masks = np.zeros((len(uniq), Wm), dtype=np.uint32)
    np.bitwise_or.at(
        masks, (inv, refs_cat // 32), (np.uint32(1) << (refs_cat % 32)).astype(np.uint32)
    )
    return uniq, masks


def sorted_panel_counts_masked(read_sk, qmask, keys, masks, num_refs: int):
    """The searchsorted probe core over a pre-built query mask: [B, s]
    hash arrays + bool mask (True = query this element) -> [B, R]
    distinct shared counts.  Callers enforce set semantics by masking
    duplicate occurrences out (occ > 0)."""
    pos = jnp.searchsorted(keys, read_sk)
    pos = jnp.clip(pos, 0, keys.shape[0] - 1)
    hit = (keys[pos] == read_sk) & qmask
    mw = jnp.where(hit[..., None], masks[pos], np.uint32(0))  # [B, s, Wm]
    from rkmh_tpu.ops.popcount import vertical_popcounts

    counts = [
        vertical_popcounts(mw[..., w], min(32, num_refs - 32 * w))
        for w in range((num_refs + 31) // 32)
    ]
    return jnp.concatenate(counts, axis=-1)


def sorted_panel_counts(read_sk, read_lens, keys, masks, num_refs: int):
    """[B, s] sorted read hash arrays -> [B, R] *distinct* shared counts.

    Duplicate read values are counted once (set semantics): only each
    value's first occurrence queries the panel.
    """
    from rkmh_tpu.ops.intersect import occ_ranks

    B, s = read_sk.shape
    occ = occ_ranks(read_sk)
    qmask = (
        (jnp.arange(s, dtype=jnp.int32)[None, :] < read_lens[:, None])
        & (read_sk != SENTINEL)
        & (occ == 0)
    )
    return sorted_panel_counts_masked(read_sk, qmask, keys, masks, num_refs)
