"""Device-mesh parallelism for the classify pipeline.

The reference's only parallelism is shared-memory OpenMP loops over reads
(rkmh.cpp:813-898).  Here scaling is a jax.sharding Mesh with two axes:

* ``dp`` — reads are data-parallel on the batch axis (the dominant axis;
  embarrassingly parallel, no collectives in the hot loop).
* ``tp`` — the reference panel can shard across chips for very large
  panels; per-shard intersection counts are merged with a tiled
  all_gather (counts are [B_local, R] int32 — tiny) before the exact
  rkmh argmax/diff scan, so tensor-parallel results are bit-identical to
  single-chip results.

Sequence parallelism (long-genome sketching) lives in parallel/sp.py;
sharded counter tables (the expert-parallel analog for giant -M/-I
counters) live in parallel/ep.py; multi-host init + read sharding in
parallel/distributed.py.  There is no pipeline parallelism: no layered
model to pipeline (SURVEY.md §2.4) — the host/device pipelining of the
command drain loops (commands/stream.py) is its closest analog.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P

from rkmh_tpu.classify.engine import argmax_stream
from rkmh_tpu.ops.hashing import multi_k_window_hashes
from rkmh_tpu.ops.sketch import bottom_s_sketch
from rkmh_tpu.ops.intersect import intersection_counts


def make_mesh(devices=None, dp: int | None = None, tp: int = 1) -> Mesh:
    """Build a (dp, tp) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def sharded_classify_fn(mesh: Mesh, ks: tuple, sketch_size: int,
                        min_diff: int = 0, min_matches: int = -1):
    """Build a jitted SPMD classify step over `mesh`.

    Inputs: codes [B, L] (B divisible by dp), ref_sk [R, s] / ref_lens [R]
    (R divisible by tp).  Outputs replicate the single-chip
    engine.classify_batch tuple, sharded on dp.
    """

    def local_step(codes, ref_sk, ref_lens):
        hashes = multi_k_window_hashes(codes, list(ks))
        sk, sk_lens = bottom_s_sketch(hashes, sketch_size)
        counts = intersection_counts(sk, sk_lens, ref_sk, ref_lens)  # [B/dp, R/tp]
        # merge the panel axis: tiled gather keeps original ref order,
        # so the first-reference tie-break stays exact.
        counts = jax.lax.all_gather(counts, "tp", axis=1, tiled=True)  # [B/dp, R]
        return argmax_stream(counts, min_diff, min_matches, sk_lens)

    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("dp", None), P("tp", None), P("tp")),
        out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
        # outputs are value-replicated over tp after the all_gather, which
        # the static varying-manual-axes check cannot infer
        check_vma=False,
    )
    return jax.jit(fn)


def build_sharded_tables(ref_sk, ref_lens, tp: int):
    """Split a panel row-wise into tp shard tables of identical shape.

    Each shard's bitmask covers only its R/tp local references (mask bit j
    = local ref j), so the all_gather'd per-shard counts concatenate back
    in original reference order.  Returns ([tp, NB, width] uint32 stacked
    tables, refs_per_shard).
    """
    from rkmh_tpu.ops.lookup import build_panel_table

    ref_sk = np.asarray(ref_sk)
    ref_lens = np.asarray(ref_lens)
    R = ref_sk.shape[0]
    assert R % tp == 0, f"num refs {R} not divisible by tp {tp}"
    rps = R // tp
    from rkmh_tpu.ops.lookup import table_slots

    parts = [
        build_panel_table(ref_sk[i * rps : (i + 1) * rps],
                          ref_lens[i * rps : (i + 1) * rps])
        for i in range(tp)
    ]
    # shard_map stacks the per-shard tables, so every shard must share
    # one geometry: force the max bucket count AND the max slot width
    # any shard auto-picked.  A rebuild pinned to num_buckets can still
    # double past the pin on a bucket overflow at the new bucketing, so
    # loop until the geometries actually agree (nb only grows).
    for _ in range(8):
        nb = max(p.num_buckets for p in parts)
        slots = max(table_slots(p.table.shape[1], rps) for p in parts)
        if all(p.num_buckets == nb
               and table_slots(p.table.shape[1], rps) == slots
               for p in parts):
            break
        parts = [
            p if p.num_buckets == nb and table_slots(p.table.shape[1], rps) == slots
            else build_panel_table(
                ref_sk[i * rps : (i + 1) * rps], ref_lens[i * rps : (i + 1) * rps],
                num_buckets=nb, slots=slots,
            )
            for i, p in enumerate(parts)
        ]
    return np.stack([p.table for p in parts]), rps


def _sharded_counts_step(mesh: Mesh, ks: tuple, sketch_size: int,
                         refs_per_shard: int, finish,
                         extra_in_specs: tuple, out_specs,
                         counter_size: int | None = None, min_occ: int = 0):
    """Shared skeleton of every SPMD classify/filter step:
    [optional dp-sharded depth mask (parallel/ep.py) ->] hash ->
    bottom-s -> tp-sharded table probe -> tiled all_gather ->
    ``finish(counts, sk_lens, *extra)``.

    The counter shard, when enabled, is the LAST positional input; it
    replicates over tp, so every tp column answers depth queries
    identically.  ``finish`` picks the argmax flavor + wire format.
    """
    from rkmh_tpu.ops.lookup import lookup_intersection_counts

    if counter_size is not None:
        from rkmh_tpu.ops.sketch import mask_by_frequency
        from rkmh_tpu.parallel.ep import counter_get_local

        ndev = mesh.shape["dp"]
        if counter_size % ndev:
            raise ValueError(
                f"counter size {counter_size} not divisible by dp {ndev}")
        shard_size = counter_size // ndev

    def local_step(codes, table, *extra):
        hashes = multi_k_window_hashes(codes, list(ks))          # [B/dp, W]
        if counter_size is not None:
            cshard = extra[-1]
            extra = extra[:-1]
            depths = counter_get_local(cshard, hashes, counter_size, shard_size)
            hashes = mask_by_frequency(hashes, depths, min_occ)
        sk, sk_lens = bottom_s_sketch(hashes, sketch_size)
        counts = lookup_intersection_counts(
            sk, sk_lens, (table[0],), refs_per_shard
        )  # [B/dp, R/tp]
        counts = jax.lax.all_gather(counts, "tp", axis=1, tiled=True)  # [B/dp, R]
        return finish(counts, sk_lens, *extra)

    in_specs = (P("dp", None), P("tp", None, None)) + extra_in_specs
    if counter_size is not None:
        in_specs = in_specs + (P("dp"),)
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_classify_table_fn(mesh: Mesh, ks: tuple, sketch_size: int,
                              refs_per_shard: int,
                              min_diff: int = 0, min_matches: int = -1,
                              counter_size: int | None = None,
                              min_occ: int = 0):
    """Production SPMD classify step: dp-sharded reads x tp-sharded panel
    bucket tables (ops/lookup fast path), bit-identical to single chip.

    Inputs: codes [B, L] (B % dp == 0), tables [tp, NB, width] uint32
    [, counter shard when counter_size is set — the stream -M fused
    path, matching the engine.sketch_batch_depth_filtered + classify
    two-pass of rkmh.cpp:903-948].
    """

    def finish(counts, sk_lens):
        return argmax_stream(counts, min_diff, min_matches, sk_lens)

    return _sharded_counts_step(
        mesh, ks, sketch_size, refs_per_shard, finish,
        extra_in_specs=(),
        out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
        counter_size=counter_size, min_occ=min_occ,
    )


def sharded_classify_depth_table_fn(mesh: Mesh, ks: tuple, sketch_size: int,
                                    refs_per_shard: int, counter_size: int,
                                    min_occ: int,
                                    min_diff: int = 0, min_matches: int = -1):
    """stream -M fused classify (see sharded_classify_table_fn)."""
    return sharded_classify_table_fn(
        mesh, ks, sketch_size, refs_per_shard, min_diff, min_matches,
        counter_size=counter_size, min_occ=min_occ,
    )


def sharded_filter_table_fn(mesh: Mesh, ks: tuple, sketch_size: int,
                            refs_per_shard: int,
                            min_diff: int = 0, min_matches: int = -1,
                            counter_size: int | None = None,
                            min_occ: int = 0):
    """SPMD `filter` classify step: dp-sharded reads x tp-sharded panel
    bucket tables, filter-flavor argmax (equiv.hpp:324-353 semantics via
    engine.argmax_filter), bit-identical to the single-device step.

    Inputs: codes [B, L] (B % dp == 0), tables [tp, NB, width] uint32,
    ref_lens [R] int32 (replicated — the union term indexes the GLOBAL
    best, so it must see every reference's sketch length)
    [, counter shard when counter_size is set — the filter -M fused
    path].  Returns the [5, B] int64 wire of
    engine.filter_sketches_table_packed.
    """
    import jax.numpy as jnp

    from rkmh_tpu.classify.engine import argmax_filter

    def finish(counts, sk_lens, ref_lens):
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

    return _sharded_counts_step(
        mesh, ks, sketch_size, refs_per_shard, finish,
        extra_in_specs=(P(None),),
        out_specs=P(None, "dp"),
        counter_size=counter_size, min_occ=min_occ,
    )


def sharded_filter_depth_table_fn(mesh: Mesh, ks: tuple, sketch_size: int,
                                  refs_per_shard: int, counter_size: int,
                                  min_occ: int,
                                  min_diff: int = 0, min_matches: int = -1):
    """filter -M fused step (see sharded_filter_table_fn)."""
    return sharded_filter_table_fn(
        mesh, ks, sketch_size, refs_per_shard, min_diff, min_matches,
        counter_size=counter_size, min_occ=min_occ,
    )


class ShardedHpv16Comb:
    """SPMD hpv16 step over the COMBINED-mask set table, with the same
    split-dispatch structure as single-device production
    (engine.hpv16_batch_comb).

    One bucket table spans types + uniq groups (mask bit r = type r for
    r < num_types, uniq group r-num_types after), tp-sharded by
    CONTIGUOUS REF RANGES: shard i's table covers refs
    [i*rps, (i+1)*rps) with its own ceil(rps/32)-word masks
    (lookup.build_sharded_set_tables_device forces one geometry across
    shards).  Padded refs sit at the very end, BEYOND
    num_types+num_uniq, so after the tiled all_gather the argmax never
    even sees them — the first-reference tie-break
    (rkmh.cpp:2669-2678) is exact by construction.

    Three dispatches per batch, mirroring the single-device split:

    1. ``stage1``  [shard_map]: hash -> (-M depth mask via the
       dp-sharded counter, parallel/ep.py) -> full row sort -> compact
       to Wc -> occ ranks / query mask / bucket indices.  Everything
       P("dp", ...): replicated over tp, no collective.
    2. ``gather``  [shard_map]: the bare per-shard row gather
       table[bidx] — out_spec P("dp", None, "tp") lays shard rows side
       by side on the lane axis, so no data moves between dispatches.
    3. ``finish``  [shard_map]: compare tail -> per-shard counts
       [B/dp, rps] -> tiled all_gather over tp -> tc/uc split by column
       range -> argmax -> the [B, 2+U] int64 wire of hpv16_batch_comb.

    Jitted fns are cached per (num_buckets, Wc) — Wc is the compact
    probe width (engine.hpv16_compact_width), grid-rounded by callers
    to bound recompiles; multi-host drains pass the full width W
    because Wc must be identical on every rank for the collective
    programs to agree, and rank-local batch lens differ.
    """

    def __init__(self, mesh: Mesh, ks: tuple, num_types: int,
                 num_uniq: int, rps: int,
                 counter_size: int | None = None, min_occ: int = 0):
        self.mesh = mesh
        self.ks = tuple(ks)
        self.num_types = num_types
        self.num_uniq = num_uniq
        self.rps = rps
        self.counter_size = counter_size
        self.min_occ = min_occ
        self._cache = {}
        if counter_size is not None:
            ndev = mesh.shape["dp"]
            if counter_size % ndev:
                raise ValueError(
                    f"counter size {counter_size} not divisible by dp {ndev}")
            self._shard_size = counter_size // ndev

    def _fns(self, nb: int, Wc: int):
        key = (nb, Wc)
        fns = self._cache.get(key)
        if fns is not None:
            return fns
        import jax.numpy as jnp

        from rkmh_tpu.ops.intersect import occ_ranks
        from rkmh_tpu.ops.lookup import bucket_indices, counts_from_rows
        from rkmh_tpu.ops.sketch import SENTINEL, mask_by_frequency
        from rkmh_tpu.parallel.ep import counter_get_local

        mesh, ks = self.mesh, self.ks
        counter_size, min_occ = self.counter_size, self.min_occ
        shard_size = getattr(self, "_shard_size", None)

        def stage1_local(codes, *extra):
            hashes = multi_k_window_hashes(codes, list(ks))
            if counter_size is not None:
                depths = counter_get_local(
                    extra[0], hashes, counter_size, shard_size)
                hashes = mask_by_frequency(hashes, depths, min_occ)
            full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
            full = full[:, :Wc]  # sorted rows: valid prefix <= Wc
            occ = occ_ranks(full).astype(jnp.uint32)
            qmask = (
                jnp.arange(Wc, dtype=jnp.int32)[None, :] < lens[:, None]
            ) & (full != SENTINEL)
            lo = full.astype(jnp.uint32)
            hi = (full >> np.uint64(32)).astype(jnp.uint32)
            return lo, hi, occ, qmask, bucket_indices(lo, hi, occ, nb)

        in1 = (P("dp", None),)
        if counter_size is not None:
            in1 = in1 + (P("dp"),)
        stage1 = jax.jit(jax.shard_map(
            stage1_local, mesh=mesh, in_specs=in1,
            out_specs=(P("dp", None),) * 5, check_vma=False))

        def gather_local(table, bidx):
            return table[0][bidx]  # bare gather: own kCustom fusion

        gather = jax.jit(jax.shard_map(
            gather_local, mesh=mesh,
            in_specs=(P("tp", None, None), P("dp", None)),
            out_specs=P("dp", None, "tp"), check_vma=False))

        rps = self.rps
        num_types, num_uniq = self.num_types, self.num_uniq

        def finish_local(rows, lo, hi, occ, qmask):
            counts = counts_from_rows(rows, lo, hi, occ, qmask, rps)
            counts = jax.lax.all_gather(
                counts, "tp", axis=1, tiled=True)  # [B/dp, tp*rps]
            tc = counts[:, :num_types]
            uc = counts[:, num_types:num_types + num_uniq]
            best = jnp.argmax(tc, axis=-1)
            max_shared = jnp.max(tc, axis=-1)
            return jnp.concatenate(
                [best.astype(jnp.int64)[:, None],
                 max_shared.astype(jnp.int64)[:, None],
                 uc.astype(jnp.int64)],
                axis=1,
            )

        finish = jax.jit(jax.shard_map(
            finish_local, mesh=mesh,
            in_specs=(P("dp", None, "tp"),) + (P("dp", None),) * 4,
            out_specs=P("dp", None), check_vma=False))
        fns = (stage1, gather, finish)
        self._cache[key] = fns
        return fns

    def __call__(self, codes, table_stack, Wc: int, counter_shard=None):
        stage1, gather, finish = self._fns(int(table_stack.shape[1]), Wc)
        extra = (counter_shard,) if counter_shard is not None else ()
        lo, hi, occ, qmask, bidx = stage1(codes, *extra)
        rows = gather(table_stack, bidx)
        return finish(rows, lo, hi, occ, qmask)


class ShardedHpv16Sorted:
    """dp-sharded hpv16 step over the SORTED-KEY combined panel — the
    over-budget fallback (RKMH_TPU_SET_TABLE_MAX_MB): the ~10x-smaller
    (keys, masks) pair replicates on the mesh and every tp column
    computes the identical counts (no per-shard table exists to split).
    Result-identical to engine.hpv16_sorted_batch."""

    def __init__(self, mesh: Mesh, ks: tuple, num_types: int,
                 num_uniq: int,
                 counter_size: int | None = None, min_occ: int = 0):
        self.mesh = mesh
        self.ks = tuple(ks)
        self.num_types = num_types
        self.num_uniq = num_uniq
        self.counter_size = counter_size
        self.min_occ = min_occ
        self._cache = {}
        if counter_size is not None:
            ndev = mesh.shape["dp"]
            if counter_size % ndev:
                raise ValueError(
                    f"counter size {counter_size} not divisible by dp {ndev}")
            self._shard_size = counter_size // ndev

    def _fn(self, Wc: int):
        fn = self._cache.get(Wc)
        if fn is not None:
            return fn
        import jax.numpy as jnp

        from rkmh_tpu.ops.intersect import occ_ranks
        from rkmh_tpu.ops.lookup import sorted_panel_counts_masked
        from rkmh_tpu.ops.sketch import SENTINEL, mask_by_frequency
        from rkmh_tpu.parallel.ep import counter_get_local

        mesh, ks = self.mesh, self.ks
        counter_size, min_occ = self.counter_size, self.min_occ
        shard_size = getattr(self, "_shard_size", None)
        num_types, num_uniq = self.num_types, self.num_uniq

        def local(codes, keys, masks, *extra):
            hashes = multi_k_window_hashes(codes, list(ks))
            if counter_size is not None:
                depths = counter_get_local(
                    extra[0], hashes, counter_size, shard_size)
                hashes = mask_by_frequency(hashes, depths, min_occ)
            full, lens = bottom_s_sketch(hashes, hashes.shape[-1])
            full = full[:, :Wc]
            occ = occ_ranks(full)
            qmask = (
                (jnp.arange(Wc, dtype=jnp.int32)[None, :] < lens[:, None])
                & (full != SENTINEL)
                & (occ == 0)  # set semantics: first occurrence only
            )
            counts = sorted_panel_counts_masked(
                full, qmask, keys, masks, num_types + num_uniq)
            tc = counts[:, :num_types]
            uc = counts[:, num_types:]
            best = jnp.argmax(tc, axis=-1)
            max_shared = jnp.max(tc, axis=-1)
            return jnp.concatenate(
                [best.astype(jnp.int64)[:, None],
                 max_shared.astype(jnp.int64)[:, None],
                 uc.astype(jnp.int64)],
                axis=1,
            )

        in_specs = (P("dp", None), P(None), P(None, None))
        if counter_size is not None:
            in_specs = in_specs + (P("dp"),)
        fn = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=in_specs,
            out_specs=P("dp", None), check_vma=False))
        self._cache[Wc] = fn
        return fn

    def __call__(self, codes, keys, masks, Wc: int, counter_shard=None):
        extra = (counter_shard,) if counter_shard is not None else ()
        return self._fn(Wc)(codes, keys, masks, *extra)


def place_tp_comb_table(mesh: Mesh, comb_hashes, comb_mask, tp: int):
    """Build + place the tp-sharded COMBINED hpv16 set table (the one
    recipe for single-host ``--devices [--tp]`` AND ``--dist-*``): pad
    the type+uniq window-hash rows to a tp multiple with all-masked
    rows, build one forced-geometry set table per contiguous ref range
    (lookup.build_sharded_set_tables_device) and place the stack
    P("tp", None, None).  Returns (placed stack, refs_per_shard).
    Pads sit at the END, beyond every real type/uniq column, so
    ShardedHpv16Comb's column split never sees them."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rkmh_tpu.ops.lookup import build_sharded_set_tables_device

    th, tm = comb_hashes, comb_mask
    pad_r = (-th.shape[0]) % tp
    if pad_r:
        th = jnp.concatenate(
            [th, jnp.zeros((pad_r, th.shape[1]), th.dtype)])
        tm = jnp.concatenate(
            [tm, jnp.zeros((pad_r, tm.shape[1]), bool)])
    stacked, rps = build_sharded_set_tables_device(th, tm, tp)
    placed = jax.device_put(
        stacked, NamedSharding(mesh, P("tp", None, None)))
    return placed, rps


def sharded_call_enum_fn(mesh: Mesh, k: int):
    """SPMD `call` mutation-enumeration: positions sharded over dp.

    Input: overlapping code slices [dp, Pl + k] (halo k, host-built),
    replicated read-depth hashmap.  Each device hashes its Pl windows,
    enumerates all SNP alts (Pl x k x 3) and gathers their depths; the
    global max rescue depth reduces with a pmax collective.  Returns
    ([dp*Pl] window depths, [dp*Pl, k, 3] alt depths, scalar max).
    """
    from rkmh_tpu.ops.hashing import kmer_window_hashes
    from rkmh_tpu.ops.hashmap import hashmap_get
    from rkmh_tpu.call_engine import ROT, _slice_stack
    import jax.numpy as jnp

    def local_step(codes_slice, *table):
        codes = codes_slice[0]                      # [Pl + k]
        Pl = codes.shape[0] - k
        wh = kmer_window_hashes(codes[None], k)[0][:Pl]      # [Pl]
        depth = hashmap_get(table, wh)
        win = _slice_stack(codes, 0, k, Pl)                  # [Pl, k]
        rot = jnp.asarray(ROT)
        alts = rot[jnp.minimum(win, 3)]                      # [Pl, k, 3]
        eye = jnp.eye(k, dtype=bool)
        alt_codes = jnp.where(
            eye[None, :, None, :], alts[:, :, :, None], win[:, None, None, :]
        )
        snp_hash = kmer_window_hashes(
            alt_codes.reshape(-1, k), k
        )[:, 0].reshape(Pl, k, 3)
        snp_depth = hashmap_get(table, snp_hash)
        gmax = jax.lax.pmax(jnp.max(snp_depth), "dp")
        return depth, snp_depth, gmax[None]

    def wrapper(codes_slices, table_arrays):
        fn = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P("dp", None),) + (P(None),) * len(table_arrays),
            out_specs=(P("dp"), P("dp", None, None), P("dp")),
            check_vma=False,
        )
        return fn(codes_slices, *table_arrays)

    return jax.jit(wrapper)


def sharded_call_scan_fn(mesh: Mesh, k: int, window_len: int):
    """SPMD `call` positional scan: the FULL call_scan_ref pipeline
    (depth, trailing-window average, SNP + 1bp-DEL mutation rescue)
    with reference positions sharded over dp.

    Each device owns Pl contiguous positions.  Inputs are host-built
    overlapping slices of ``[4] + genome`` ([dp, Pl + k + 1]: one
    leading byte so row j reaches ref[j-1] for the DEL (k+1)-mers, plus
    the usual k-halo), a replicated read-depth hashmap, and the true
    position count (for the global j index).  The trailing-window
    average needs the previous shard's last `window_len` depths — a
    single ppermute halo exchange (shard 0 receives zeros, which is
    exactly the empty-window prefix).  Requires Pl >= window_len so one
    neighbor's halo suffices; callers fall back below that.

    Returns call_scan_ref's dict with every array [dp*Pl, ...]-shaped
    (concatenated position order); rows past the true P are garbage the
    host slices off, exactly like the single-device path.
    """
    from rkmh_tpu.call_engine import ROT, _slice_stack
    from rkmh_tpu.ops.hashing import kmer_window_hashes
    from rkmh_tpu.ops.hashmap import hashmap_get
    import jax.numpy as jnp

    def local_step(slices, *table):
        padded = slices[0]                    # [Pl + k + 1]; padded[0] = ref[g-1]
        Pl = padded.shape[0] - k - 1
        d = jax.lax.axis_index("dp")
        jg = d * Pl + jnp.arange(Pl)          # global position index

        ref = padded[1:]                      # ref[g .. g+Pl+k-1]
        wh = kmer_window_hashes(ref[None], k)[0][:Pl]          # [Pl]
        depth = hashmap_get(table, wh)                         # [Pl] i32

        # trailing-window avg: previous shard's last w depths via ppermute
        w = window_len
        halo = jax.lax.ppermute(
            depth[-w:], "dp",
            [(i, i + 1) for i in range(mesh.shape["dp"] - 1)],
        )                                      # shard 0 gets zeros
        css = jnp.cumsum(
            jnp.concatenate([halo, depth]).astype(jnp.int64))
        jl = jnp.arange(Pl)
        wsize = jnp.minimum(jg + 1, w)
        hi = css[w + jl]
        lo_idx = w + jl - wsize
        lo = jnp.where(lo_idx >= 0, css[jnp.clip(lo_idx, 0, None)], 0)
        wsum = hi - lo
        avg = (wsum.astype(jnp.float64) / wsize.astype(jnp.float64)).astype(jnp.int32)

        site = depth.astype(jnp.float64) < 0.5 * avg.astype(jnp.float64)

        # SNP enumeration (identical math to call_scan_ref)
        win = _slice_stack(ref, 0, k, Pl)                      # [Pl, k]
        rot = jnp.asarray(ROT)
        safe = jnp.minimum(win, 3)
        alts = rot[safe]                                       # [Pl, k, 3]
        eye = jnp.eye(k, dtype=bool)
        alt_codes = jnp.where(
            eye[None, :, None, :], alts[:, :, :, None], win[:, None, None, :]
        )
        snp_hash = kmer_window_hashes(
            alt_codes.reshape(-1, k), k)[:, 0].reshape(Pl, k, 3)
        snp_depth = hashmap_get(table, snp_hash)
        avg_f = avg.astype(jnp.float64)
        snp_call = (
            site[:, None, None]
            & (snp_depth.astype(jnp.float64) >= 0.1 * avg_f[:, None, None])
            & (snp_depth > depth[:, None, None])
            & (win < 4)[:, :, None]
        )
        max_rescue = jnp.max(
            jnp.where(site[:, None, None], snp_depth, 0), axis=(1, 2))

        # DEL enumeration: dwin row j = padded[j .. j+k] = ref[g-1 .. g+k-1]
        dwin = _slice_stack(padded, 0, k + 1, Pl)              # [Pl, k+1]
        dels = []
        for ap in range(1, k + 1):
            dels.append(jnp.concatenate(
                [dwin[:, :ap], dwin[:, ap + 1:]], axis=-1))
        del_codes = jnp.stack(dels, axis=1)                    # [Pl, k, k]
        del_hash = kmer_window_hashes(
            del_codes.reshape(-1, k), k)[:, 0].reshape(Pl, k)
        del_depth = hashmap_get(table, del_hash)
        del_call = (
            site[:, None]
            & (del_depth.astype(jnp.float64) > 0.9 * avg_f[:, None])
            & (jg > 0)[:, None]
        )
        return (depth, avg, site, snp_depth, snp_call, max_rescue,
                del_depth, del_call)

    def wrapper(slices, table_arrays):
        fn = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P("dp", None),) + (P(None),) * len(table_arrays),
            out_specs=(P("dp"), P("dp"), P("dp"), P("dp", None, None),
                       P("dp", None, None), P("dp"), P("dp", None),
                       P("dp", None)),
            check_vma=False,
        )
        names = ("depth", "avg", "site", "snp_depth", "snp_call",
                 "max_rescue", "del_depth", "del_call")
        return dict(zip(names, fn(slices, *table_arrays)))

    return jax.jit(wrapper)


def shard_batch(mesh: Mesh, codes):
    """Place a host batch onto the mesh sharded along dp."""
    sharding = jax.sharding.NamedSharding(mesh, P("dp", None))
    return jax.device_put(codes, sharding)


def replicate(mesh: Mesh, x):
    sharding = jax.sharding.NamedSharding(mesh, P())
    return jax.device_put(x, sharding)
