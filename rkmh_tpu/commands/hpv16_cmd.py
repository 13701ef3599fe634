"""`hpv16` command — tiered HPV type / lineage / sublineage classifier.

Mirrors rkmh main_hpv16 (rkmh.cpp:2366-2723):

1. Type step: each read's full hash set vs the 182-genome PAVE panel
   (``refpath/all_pave_ref.fa``), argmax of distinct-set intersection
   (hash_set_intersection_size, rkmh.cpp:2669-2678; first ref wins ties).
2. Lineage/sublineage step: the 10 HPV16 sublineage genomes
   (``refpath/new_refs.fa``, keys A1..D3) are grouped by lineage letter
   (key[0]) and sublineage (key[:2]); each group's *unique* k-mer table is
   its hash set minus the union of all other groups (iterated
   set_difference, rkmh.cpp:2558-2653).  Reads are ranked against both
   table families by similarity = |∩| / hashnum (sort_by_similarity),
   descending, ties keeping map order (A,B,C,D / A1..D3).
3. Output per read (rkmh.cpp:2681-2715):
   ``read\\ttype\\tshared/hashnum\\tlin:sim;..\\tsublin:sim;..\\t
   lin_count;..\\tsublin_count;..`` with C++ default double formatting
   (6 significant digits).

Side effects preserved: the lineage-unique table stats go to stderr and
``lineage_specific_hashes.<k>.tst`` is written to CWD (rkmh.cpp:2600-2612;
hashes tab-separated with a trailing tab — we write them sorted, where
the reference's unordered_set order is arbitrary).

Semantics notes (mkmh not vendored, SURVEY.md §2.3): set intersections
exclude the 0 invalid-kmer sentinel; refs are hashed with kmer_sizes[0]
while reads use all -k sizes, exactly as the reference does
(rkmh.cpp:2546 vs 2661); sketch_size is accepted but the type_minhashes
it would build are dead in the reference's live path (rkmh.cpp:2547 built,
never read) so no sketching happens here either.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from rkmh_tpu.classify import engine
from rkmh_tpu.commands.common import load_packed, packed_batches, log
from rkmh_tpu.ops.counter import HashCounter


@dataclass
class Hpv16Config:
    read_files: list = field(default_factory=list)
    refpath: str = "data"
    ks: tuple = ()
    sketch_size: int = 4000        # parsed for parity; dead in the live path
    min_kmer_occ: int = 0          # -M (>0 enables read-depth masking)
    min_matches: int = -1          # parsed, unused (reference too)
    min_diff: int = 0              # parsed, unused (reference too)
    counter_size: int = 800_000_000  # rkmh.cpp:2516
    batch_size: int = 512
    tst_file: bool = True          # write lineage_specific_hashes.<k>.tst
    chunk_reads: int = 0           # streaming window; 0 = default
    out_file: str = ""             # -o: write here instead of stdout
    resume: bool = False           # --resume: continue an interrupted -o run
    devices: int = 0               # --devices: dp-shard reads over N devices
    tp: int = 1                    # --tp: type-panel shards (devices = dp*tp)
    dist_coordinator: str = ""     # --dist-coordinator host:port (multi-host)
    dist_procs: int = 0            # --dist-procs: process count (multi-host)
    dist_rank: int = -1            # --dist-rank: this process's id


def _fmt_double(x: float) -> str:
    """C++ `cout << double` default formatting: 6 significant digits."""
    return f"{x:.6g}"


def _group_unique_keep(hashes, mask, rows_g, rows_other):
    """Device: keep-mask for the hashes of group `rows_g` that appear in
    NO row of `rows_other` — one iterated std::set_difference step of
    rkmh.cpp:2575-2590, as a sort + searchsorted membership test."""
    from rkmh_tpu.ops.sketch import SENTINEL

    g_h = hashes[rows_g]
    g_m = mask[rows_g] & (g_h != np.uint64(0))
    oth = jnp.where(mask[rows_other], hashes[rows_other], SENTINEL).reshape(-1)
    oth = jnp.sort(oth)
    pos = jnp.clip(jnp.searchsorted(oth, g_h), 0, oth.shape[0] - 1)
    present = oth[pos] == g_h
    return g_h, g_m & ~present


_group_unique_keep_jit = jax.jit(_group_unique_keep)


def _family_unique(hashes, mask, groups):
    """Per-group unique-hash rows for one family (lineage or sublineage),
    entirely on device: group g keeps the hashes found in none of the
    other groups (the reference's iterated set_difference,
    rkmh.cpp:2558-2653).  Returns ([G, Lmax] u64 SENTINEL-padded rows,
    [G, Lmax] keep masks) ready for the set-table builder."""
    from rkmh_tpu.ops.sketch import SENTINEL

    R, W = hashes.shape
    parts = []
    for g, rows_g in enumerate(groups):
        rows_other = np.asarray(
            [r for gg, rs in enumerate(groups) if gg != g for r in rs],
            dtype=np.int32,
        )
        rows_g = np.asarray(rows_g, dtype=np.int32)
        if rows_other.size == 0:
            # single-group family: nothing to subtract (the reference's
            # set_difference loop body never runs)
            g_h = hashes[rows_g]
            keep = mask[rows_g] & (g_h != np.uint64(0))
        else:
            g_h, keep = _group_unique_keep_jit(hashes, mask, rows_g, rows_other)
        parts.append((g_h.reshape(-1), keep.reshape(-1)))
    Lmax = max(p[0].shape[0] for p in parts)
    G = len(groups)
    out_h = jnp.full((G, Lmax), SENTINEL, dtype=jnp.uint64)
    out_m = jnp.zeros((G, Lmax), dtype=bool)
    for g, (h, m) in enumerate(parts):
        out_h = out_h.at[g, : h.shape[0]].set(h)
        out_m = out_m.at[g, : m.shape[0]].set(m)
    return out_h, out_m


def run(cfg: Hpv16Config, out=None) -> int:
    import os

    if (cfg.dist_procs > 1 or cfg.dist_coordinator
            or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        from rkmh_tpu.commands.dist_stream import run_distributed_hpv16

        return run_distributed_hpv16(cfg, out)

    # failure recovery: hpv16 emits exactly one line per read, so the
    # partial output is its own checkpoint (line-counted resume, same as
    # stream; see commands.recovery)
    from rkmh_tpu.commands.recovery import count_complete_lines

    resume_skip = 0
    close_out = False
    if cfg.resume and not cfg.out_file:
        log("hpv16 --resume requires -o <file> (resume state is the "
            "partial output itself); refusing to reclassify to stdout")
        return 1
    if out is None and cfg.out_file:
        if cfg.resume and os.path.exists(cfg.out_file):
            resume_skip = count_complete_lines(cfg.out_file)
            log(f"Resuming: {resume_skip} reads already classified in "
                f"{cfg.out_file}")
            out = open(cfg.out_file, "a")
        else:
            out = open(cfg.out_file, "w")
        close_out = True
    out = out or sys.stdout
    try:
        return _run(cfg, out, resume_skip)
    finally:
        if close_out:
            out.close()


class Hpv16Tables:
    """Everything the read loop needs: device set tables + name maps.
    Deterministic for a given (refpath, k) — multi-host runs build it
    identically on every host."""

    __slots__ = ("type_names", "comb_table", "comb_sorted",
                 "comb_hashes", "comb_mask", "lin_names", "sublin_names")

    @property
    def n_lin(self):
        return len(self.lin_names)

    @property
    def n_sub(self):
        return len(self.sublin_names)


def build_tables(cfg: Hpv16Config, ks: tuple,
                 tp_shards: int = 0) -> Hpv16Tables:
    """Type panel + lineage/sublineage unique-kmer set tables (device
    built; rkmh.cpp:2544-2653), with the .tst side-effect file and the
    stderr stats.

    Every path consumes the COMBINED representation: ONE bucket table
    whose mask spans types + uniq groups — the probe runs one wide row
    gather per element instead of a 288 B-row and a narrow one.

    tp_shards=0 (single device) builds tb.comb_table (or tb.comb_sorted
    past the RKMH_TPU_SET_TABLE_MAX_MB budget).  tp_shards>=1 (the
    sharded/dist drivers) leaves the window-hash rows in
    tb.comb_hashes/comb_mask for parallel.mesh.place_tp_comb_table
    (the caller holds the mesh), falling back to tb.comb_sorted on the
    same budget.
    """
    k0 = ks[0]
    tb = Hpv16Tables()

    type_recs = load_packed([f"{cfg.refpath}/all_pave_ref.fa"])
    sub_recs = load_packed([f"{cfg.refpath}/new_refs.fa"])

    # type panel: full distinct hash sets at kmer_sizes[0] (rkmh.cpp:2546),
    # built entirely on device — the ~600 MB bucket table never crosses
    # the host wire (ops.lookup.build_set_table_device)
    type_names = list(type_recs.names)
    th, tm = engine.hash_batch_with_mask(
        type_recs.codes, jnp.asarray(type_recs.lens), (k0,)
    )

    # sublineage hash sets at kmer_sizes[0] (rkmh.cpp:2553) and the
    # lineage/sublineage unique-kmer tables (iterated set_difference,
    # rkmh.cpp:2558-2653) — built ENTIRELY on device: hash once, group
    # membership masks + searchsorted differences + set-table scatter,
    # no per-record host loop (scales to panels far beyond 10 genomes)
    sub_names_all = list(sub_recs.names)
    lin_names = sorted({n[0] for n in sub_names_all})            # map<char,..>
    sublin_names = sorted({n[:2] for n in sub_names_all})        # map<string,..>
    sh, sm = engine.hash_batch_with_mask(
        sub_recs.codes, jnp.asarray(sub_recs.lens), (k0,)
    )
    lin_groups = [
        [i for i, n in enumerate(sub_names_all) if n[0] == ln] for ln in lin_names
    ]
    sublin_groups = [
        [i for i, n in enumerate(sub_names_all) if n[:2] == sn] for sn in sublin_names
    ]
    lin_h, lin_keep = _family_unique(sh, sm, lin_groups)
    sub_h, sub_keep = _family_unique(sh, sm, sublin_groups)
    n_lin, n_sub = len(lin_names), len(sublin_names)

    from rkmh_tpu.ops.lookup import build_set_table_device as _bstd

    Lmax = max(lin_h.shape[1], sub_h.shape[1])

    def _pad(a, fill):
        return jnp.pad(a, ((0, 0), (0, Lmax - a.shape[1])),
                       constant_values=fill)

    comb_h = jnp.concatenate([_pad(lin_h, 0), _pad(sub_h, 0)])
    comb_m = jnp.concatenate([_pad(lin_keep, False), _pad(sub_keep, False)])
    comb_table = None
    comb_sorted = None
    tb.comb_hashes = tb.comb_mask = None

    # ONE table over all 182+14 "refs": rows = type hash sets then
    # uniq-group rows, padded to a common window width.  Ref bit r is
    # a type for r < len(type_names) and uniq group r-182 after —
    # counts split back by column range in engine.hpv16_comb_finish /
    # mesh.ShardedHpv16Comb.
    Wall = max(th.shape[1], comb_h.shape[1])

    def _padw(a, fill):
        return jnp.pad(a, ((0, 0), (0, Wall - a.shape[1])),
                       constant_values=fill)

    all_h = jnp.concatenate([_padw(th, 0), _padw(comb_h, 0)])
    all_m = jnp.concatenate([_padw(tm, False), _padw(comb_m, False)])
    n_all = len(type_names) + n_lin + n_sub

    # memory guard: a refpath override with a much larger panel can
    # outgrow the bucket table's HBM appetite — fall back to the
    # ~10x-smaller sorted-key panel (ops.lookup.build_sorted_panel,
    # probed by engine.hpv16_sorted_batch / mesh.ShardedHpv16Sorted,
    # result-identical)
    import os as _os

    from rkmh_tpu.ops.lookup import (
        _count_unique_keys, build_sorted_panel, projected_table_bytes,
    )

    cap_mb = int(_os.environ.get("RKMH_TPU_SET_TABLE_MAX_MB", "2048"))
    n_entries = int(_count_unique_keys(all_h, all_m))
    if projected_table_bytes(n_entries, n_all) > cap_mb << 20:
        from rkmh_tpu.utils import to_host

        ah, am = to_host((all_h, all_m))
        rows = [ah[i][am[i]] for i in range(n_all)]
        keys, masks = build_sorted_panel(rows, num_refs=n_all)
        comb_sorted = (jnp.asarray(keys), jnp.asarray(masks))
        log(f"hpv16 panel: projected bucket table exceeds "
            f"RKMH_TPU_SET_TABLE_MAX_MB={cap_mb}; using the sorted-key "
            f"panel ({keys.nbytes + masks.nbytes >> 20} MB)")
    elif tp_shards >= 1:
        # sharded/dist: the caller builds + places the tp stack from the
        # window-hash rows (it holds the mesh — place_tp_comb_table)
        tb.comb_hashes, tb.comb_mask = all_h, all_m
    else:
        comb_table = _bstd(all_h, all_m, num_refs=n_all,
                           est_entries=n_entries)
        log(f"hpv16 panel: combined set table {comb_table.nbytes} bytes "
            f"({n_entries} keys over {n_all} refs)")

    # the .tst side-effect file + stderr stats need the distinct values on
    # host — ONE grouped fetch (int64 fast path), then per-row np.unique
    from rkmh_tpu.utils import to_host

    ch, cm = to_host((comb_h, comb_m))
    uniq_rows = [np.unique(ch[i][cm[i]]) for i in range(n_lin + n_sub)]
    lin_uniqs, sublin_uniqs = uniq_rows[:n_lin], uniq_rows[n_lin:]

    if cfg.tst_file:
        with open(f"lineage_specific_hashes.{k0}.tst", "w") as fh:
            for ln, uniq in zip(lin_names, lin_uniqs):
                fh.write(ln + "\t" + "".join(f"{h}\t" for h in uniq.tolist()) + "\n")
    log("Lineage specific kmer table created:")
    for ln, uniq in zip(lin_names, lin_uniqs):
        log(f"\t{ln}\t{len(uniq)}")
    log("Sublineage specific kmer table created:")
    for sn, uniq in zip(sublin_names, sublin_uniqs):
        log(f"\t{sn}\t{len(uniq)}")

    tb.type_names = type_names
    tb.comb_table = comb_table
    tb.comb_sorted = comb_sorted
    tb.lin_names = lin_names
    tb.sublin_names = sublin_names
    return tb


def make_sharded_hpv16_step(mesh, tb: Hpv16Tables, ks: tuple, tp: int,
                            counter_size: int | None, min_occ: int):
    """The ONE sharded hpv16 step recipe — single-host ``--devices
    [--tp]`` and multi-host ``--dist-*`` both ride it, so the
    padding/tie-break rules can never diverge: the combined type+uniq
    table tp-stacked by contiguous ref ranges with the split-dispatch
    probe (mesh.ShardedHpv16Comb), or the replicated sorted panel past
    the table budget (tb.comb_sorted -> mesh.ShardedHpv16Sorted).

    Returns ``step(codes, Wc, counter_shard_or_None) -> [B, 2+U]``
    int64 in the hpv16_batch_comb wire layout."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rkmh_tpu.parallel.mesh import (
        ShardedHpv16Comb, ShardedHpv16Sorted, place_tp_comb_table,
    )

    num_types = len(tb.type_names)
    num_uniq = tb.n_lin + tb.n_sub
    repl = NamedSharding(mesh, P())
    if tb.comb_sorted is not None:
        keys_g = jax.device_put(tb.comb_sorted[0], repl)
        masks_g = jax.device_put(tb.comb_sorted[1], repl)
        probe = ShardedHpv16Sorted(
            mesh, ks, num_types, num_uniq, counter_size, min_occ)

        def step(codes, Wc, counter_shard=None):
            return probe(codes, keys_g, masks_g, Wc, counter_shard)

        return step

    table_g, rps = place_tp_comb_table(
        mesh, tb.comb_hashes, tb.comb_mask, tp)
    probe = ShardedHpv16Comb(
        mesh, ks, num_types, num_uniq, rps, counter_size, min_occ)

    def step(codes, Wc, counter_shard=None):
        return probe(codes, table_g, Wc, counter_shard)

    return step


def format_read_lines(tb: Hpv16Tables, ks: tuple, row_names, lens, packed):
    """Per-read output lines (rkmh.cpp:2681-2715) from the fetched
    [n, 2+U] packed result; lens/packed may carry trailing pad rows."""
    n_lin, n_sub = tb.n_lin, tb.n_sub
    best_np = packed[:, 0]
    shared_np = packed[:, 1]
    uc_np = packed[:, 2:]
    hashnum = np.zeros(len(lens), dtype=np.int64)
    for k_ in ks:
        hashnum += np.maximum(np.asarray(lens).astype(np.int64) - (k_ - 1), 0)

    lines = []
    for i, name in enumerate(row_names):
        hn = int(hashnum[i])
        lin_ints = uc_np[i, :n_lin]
        sub_ints = uc_np[i, n_lin:]
        lin_sims = lin_ints / hn if hn else np.zeros_like(lin_ints, dtype=float)
        sub_sims = sub_ints / hn if hn else np.zeros_like(sub_ints, dtype=float)
        lin_order = sorted(range(n_lin), key=lambda x: -lin_sims[x])
        sub_order = sorted(range(n_sub), key=lambda x: -sub_sims[x])
        parts = [
            name,
            tb.type_names[int(best_np[i])],
            f"{int(shared_np[i])}/{hn}",
            "".join(f"{tb.lin_names[x]}:{_fmt_double(lin_sims[x])};"
                    for x in lin_order),
            "".join(f"{tb.sublin_names[x]}:{_fmt_double(sub_sims[x])};"
                    for x in sub_order),
            "".join(f"{int(lin_ints[x])};" for x in lin_order),
            "".join(f"{int(sub_ints[x])};" for x in sub_order),
        ]
        lines.append("\t".join(parts) + "\n")
    return lines


def _run(cfg: Hpv16Config, out, resume_skip: int = 0) -> int:
    from rkmh_tpu.commands.common import resolve_batch_size

    cfg.batch_size = resolve_batch_size(cfg.batch_size)
    if not cfg.ks:
        log("NO KMER SIZE PROVIDED. USING A DEFAULT KMER SIZE OF 16")
        ks = (16,)
    else:
        ks = tuple(cfg.ks)

    from rkmh_tpu.commands.common import (
        ChunkState,
        ChunkedPipeline,
        iter_packed_chunks,
        resolve_chunk_reads,
        two_pass_chunks,
    )

    chunk_reads = resolve_chunk_reads(cfg.chunk_reads)

    # --devices decision first: with -M the counter itself shards over
    # the dp axis (parallel/ep.py), so the counting pass needs the mesh —
    # and the table builder needs to know (single-device builds the ONE
    # combined type+uniq table itself; the sharded step places a
    # tp-stack of it via mesh.place_tp_comb_table)
    use_sharded = False
    mesh = None
    dp = max(cfg.devices // max(cfg.tp, 1), 1)
    if cfg.devices > 1:
        reason = None
        n_vis = len(jax.devices())
        if cfg.tp < 1 or cfg.devices % cfg.tp:
            reason = f"--devices {cfg.devices} is not divisible by --tp {cfg.tp}"
        elif cfg.devices > n_vis:
            reason = f"--devices {cfg.devices} > {n_vis} visible device(s)"
        elif cfg.min_kmer_occ > 0 and cfg.counter_size % dp:
            reason = (f"-M counter size {cfg.counter_size} is not divisible "
                      f"by the {dp} dp shards")
        if reason is not None:
            log(f"hpv16 --devices ignored ({reason}); running single-device")
        else:
            from rkmh_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(jax.devices()[: cfg.devices],
                             dp=dp, tp=cfg.tp)
            use_sharded = True

    tb = build_tables(cfg, ks, tp_shards=cfg.tp if use_sharded else 0)
    type_names, lin_names, sublin_names = (
        tb.type_names, tb.lin_names, tb.sublin_names)
    n_lin, n_sub = tb.n_lin, tb.n_sub

    def _pad_dp(codes, lens=None):
        pad = (-codes.shape[0]) % dp
        if pad:
            codes = np.concatenate([
                codes, np.full((pad, codes.shape[1]), 4, dtype=codes.dtype)])
        if lens is None:
            return codes, None
        lens = np.asarray(lens, dtype=np.int32)
        if pad:
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        return codes, lens

    classify_chunks = None
    counter_table = None
    sharded_counter = None
    if cfg.min_kmer_occ > 0:
        # -M: every read k-mer occurrence into the big lossy counter
        # (rkmh.cpp:2513-2530; size 8e8); chunked first pass, plain files
        # re-read for the classify pass (constant memory) and stdin/FIFO
        # inputs buffered so the second pass still sees every read
        pass1, pass2 = two_pass_chunks(cfg.read_files, chunk_reads)
        if use_sharded:
            from rkmh_tpu.parallel.ep import (
                sharded_counter_add_codes_fn, sharded_counter_init,
            )

            sharded_counter = sharded_counter_init(mesh, cfg.counter_size)
            add = sharded_counter_add_codes_fn(mesh, cfg.counter_size, ks)
            for chunk in pass1:
                for s, e, codes, lens in packed_batches(chunk, cfg.batch_size):
                    codes, lens = _pad_dp(codes, lens)
                    sharded_counter = add(sharded_counter, codes, lens)
        else:
            hc = HashCounter(cfg.counter_size)
            for chunk in pass1:
                for s, e, codes, lens in packed_batches(chunk, cfg.batch_size):
                    hashes, mask = engine.hash_batch_with_mask(codes, lens, ks)
                    hc.add(hashes, mask)
            counter_table = hc.table
        classify_chunks = pass2()
    if classify_chunks is None:
        classify_chunks = iter_packed_chunks(cfg.read_files, chunk_reads)
    if resume_skip:
        # the -M counter pass above still covered ALL reads (global
        # depths must match the uninterrupted run exactly)
        from rkmh_tpu.commands.recovery import skip_reads

        classify_chunks = skip_reads(classify_chunks, resume_skip)

    class _Chunk(ChunkState):
        __slots__ = ("names", "lines")

        def __init__(self, names):
            super().__init__(len(names))
            self.names = names
            self.lines = [None] * len(names)

    def fmt_rows(st, rows, lens, packed):
        lines = format_read_lines(
            tb, ks, [st.names[r] for r in rows], lens, packed)
        for ridx, line in zip(rows, lines):
            st.lines[ridx] = line
        st.filled += len(rows)

    # --devices N: dp-shard the read batch over N local devices, with
    # the COMBINED type+uniq table tp-sharded by contiguous ref ranges
    # (tp=1 places the whole table once — unplaced it would re-broadcast
    # every batch) and, with -M, the depth counter dp-sharded.  Same
    # split-dispatch structure as single-device production
    # (mesh.ShardedHpv16Comb); bit-identical to the single-device step
    # (__graft_entry__.dryrun_multichip asserts it).
    sharded_step = None
    if use_sharded:
        csize = cfg.counter_size if sharded_counter is not None else None
        hstep = make_sharded_hpv16_step(
            mesh, tb, ks, cfg.tp, csize, cfg.min_kmer_occ)

        def sharded_step(codes, lens):
            # pad rows are all-invalid reads; fmt_rows only walks the
            # real `rows`, so they fall off unread
            codes, _ = _pad_dp(codes)
            Wc = engine.hpv16_compact_width(lens, codes.shape[1], ks)
            return hstep(codes, Wc, sharded_counter)

    def device_step(codes, lens):
        if sharded_step is not None:
            return sharded_step(codes, lens)
        # single-device: ONE combined type+uniq table, probe compacted to
        # the batch's max valid-window count (engine.hpv16_compact_width;
        # it can only shrink the probe)
        Wc = engine.hpv16_compact_width(lens, codes.shape[1], ks)
        if tb.comb_sorted is not None:
            # over-budget fallback: sorted-key panel, searchsorted probe
            keys, masks = tb.comb_sorted
            if engine.pack4_ok(codes.shape[1]):
                from rkmh_tpu.io.packing import pack_codes4

                pk, vb = pack_codes4(codes)
                return engine.hpv16_sorted_packed4_batch(
                    pk, vb, codes.shape[1], keys, masks,
                    ks, len(type_names), n_lin + n_sub, Wc,
                    counter_table=counter_table, min_occ=cfg.min_kmer_occ,
                )
            return engine.hpv16_sorted_batch(
                codes, keys, masks,
                ks, len(type_names), n_lin + n_sub, Wc,
                counter_table=counter_table, min_occ=cfg.min_kmer_occ,
            )
        if engine.pack4_ok(codes.shape[1]):
            from rkmh_tpu.io.packing import pack_codes4

            pk, vb = pack_codes4(codes)
            return engine.hpv16_packed4_batch_comb(
                pk, vb, codes.shape[1], tb.comb_table,
                ks, len(type_names), n_lin + n_sub, Wc,
                counter_table=counter_table, min_occ=cfg.min_kmer_occ,
            )
        return engine.hpv16_batch_comb(
            codes, tb.comb_table,
            ks, len(type_names), n_lin + n_sub, Wc,
            counter_table=counter_table, min_occ=cfg.min_kmer_occ,
        )

    # chunked input + length-bucketed + pipelined + group-fetched
    # (commands.common.ChunkedPipeline): each chunk's lines emit in input
    # order the moment its batches return — constant memory in read count
    pipeline = ChunkedPipeline(
        on_result=lambda st, meta, arr: fmt_rows(st, meta[0], meta[1], arr),
        emit=lambda st: out.write("".join(st.lines)),
    )
    pipeline.run(
        classify_chunks,
        make_state=lambda chunk: _Chunk(chunk.names),
        dispatch=lambda st, rows, codes, lens: (
            (rows, lens), device_step(codes, lens)),
        batch_size=cfg.batch_size,
    )
    return 0
