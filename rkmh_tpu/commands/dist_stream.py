"""Multi-host `stream` (--dist-procs/--dist-rank/--dist-coordinator).

The reference is one OpenMP process (SURVEY.md §2.4); this is the CLI
surface for the jax.distributed recipe in parallel/distributed.py: every
host runs the SAME command, the global mesh spans all hosts' devices,
and the classify step is the identical shard_map program the
single-host --devices path uses (parallel/mesh.py) — so output is
bit-identical to a single-process run over the merged shards.

Multi-host SPMD requires LOCKSTEP dispatch: every process must execute
the same sequence of global programs with the same global shapes.  The
drain loop therefore runs on a fixed global geometry instead of the
single-host pipeline's length-bucketed chunks:

* one counting pre-pass (host-local parse, no device work) agrees on
  the global read count N and padded length L — every host parses the
  same input files, so no collective is needed to agree;
* reads are packed into global batches of a fixed size B (B % dp == 0);
  batch b row r is owned by the host whose local devices hold that dp
  shard (process-contiguous blocks of Bl = B/H rows, asserted at
  startup), and each host materializes ONLY its own rows via
  jax.make_array_from_process_local_data — cross-host traffic is the
  panel broadcast plus the tp all_gather, which stays host-local when
  tp divides the local device count (enforced);
* every host dispatches every batch (including trailing batches where
  it owns no real rows — pad rows classify to garbage nobody reads);
* with -M, a first lockstep pass accumulates the dp-sharded global
  depth counter (parallel/ep.py psum_scatter build — the counter truly
  spans hosts) and the classify pass fuses the sharded lookup, exactly
  like single-host `--devices ... -M`.

Each host writes its own rows (in increasing global order) to
`<out>.<rank>`; `merge_outputs` (exposed as `rkmh-tpu-dist-merge`)
round-robins the per-rank block stripes back into single-process order.
"""

from __future__ import annotations

import os
import sys
from collections import deque

import numpy as np

from rkmh_tpu.commands.common import (
    iter_packed_chunks,
    log,
    resolve_chunk_reads,
)
from rkmh_tpu.io.packing import PAD_CODE, bucket_length


def _rereadable_inputs(read_files) -> bool:
    """Multi-host drains read the input MULTIPLE times (count pre-pass,
    optional -M pass, classify pass); stdin/FIFO/file-like sources would
    be drained by the first pass, so only plain paths qualify."""
    from rkmh_tpu.commands.common import _is_fifo

    if not read_files:
        return False
    return all(
        isinstance(p, (str, bytes)) and p not in ("-", b"-")
        and not _is_fifo(p)
        for p in read_files
    )


def _scan_input(read_files, chunk_reads):
    """Host-local counting pre-pass: (total records, max read length,
    per-file input index).  Parse only — no device work; every host sees
    the same files, so all hosts agree without a collective.  The first
    run parses (native C parser, GB/s) and writes cached index entries
    (io/input_index.py); later runs — and the -M/classify passes via
    `_iter_owned_batches(index=...)` — answer from the index instead
    of reparsing.  index is None when any file is unindexable (gzip,
    python parser fallback, RKMH_TPU_INPUT_INDEX=0)."""
    from rkmh_tpu.io.input_index import scan_or_index

    n, maxlen, index = scan_or_index(read_files, chunk_reads)
    if any(e is None for e in index):
        index = None
    return n, maxlen, index


def _owned_block(b: int, B: int, Bl: int, rank: int) -> tuple[int, int]:
    """Global row range [lo, hi) of batch b owned by this process."""
    lo = b * B + rank * Bl
    return lo, lo + Bl


def _owned_lines(b: int, B: int, Bl: int, rank: int, N: int) -> int:
    """REAL rows (= output lines for one-line-per-read drains) this rank
    owns in batch b; the tail past N is padding nobody emits."""
    lo, hi = _owned_block(b, B, Bl, rank)
    return max(0, min(hi, N) - lo)


def _allmin(value: int, H: int) -> int:
    """The minimum of a per-rank int across all processes (H=1: itself).
    Every rank must call this at the same point — it is a collective."""
    if H <= 1:
        return int(value)
    from jax.experimental import multihost_utils

    return int(multihost_utils.process_allgather(np.int64(value)).min())


def _resume_watermark(skip_lines: int, N: int, B: int, Bl: int, rank: int,
                      H: int) -> tuple[int, int]:
    """Turn each rank's resumed line count into a GLOBAL dispatch
    watermark: (start_batch, residual line skip).

    Collectives need every rank in lockstep, so a batch's dispatch can
    only be skipped when EVERY rank has fully emitted it — start_batch
    is the min over ranks of each rank's count of complete leading
    batches (derived from its stripe's line count and the geometry; no
    extra sidecar).  Ranks whose stripes run past the watermark keep the
    old skip behavior for the overhang: they re-dispatch those batches
    (their peers need the collective) but skip re-emitting the lines.
    Restarted device work is therefore ∝ the batches NO rank finished.
    Must be called by every rank (it contains a collective)."""
    n_batches = -(-N // B) if N else 0
    w, acc = 0, 0
    while w < n_batches:
        lb = _owned_lines(w, B, Bl, rank, N)
        if acc + lb > skip_lines:
            break
        acc += lb
        w += 1
    start = _allmin(w, H)
    lines_before = sum(_owned_lines(b, B, Bl, rank, N) for b in range(start))
    return start, skip_lines - lines_before


def _counter_ckpt_path(out_file: str, rank: int) -> str:
    return f"{out_file}.mctr.{rank}.npz"


def _counter_fingerprint(read_files, ks, size: int, dp: int, H: int,
                         rank: int) -> str:
    """The -M counter's value depends only on (inputs, ks, size); the
    SHARD a rank holds also depends on (dp, H, rank).  Any mismatch
    invalidates the checkpoint."""
    import json

    from rkmh_tpu.io.input_index import _fingerprint

    try:
        files = [(os.fspath(p), *_fingerprint(p)) for p in read_files]
    except (OSError, TypeError):
        return ""  # unfingerprintable input: never save/load
    return json.dumps({"v": 1, "files": files, "ks": list(ks),
                       "size": size, "dp": dp, "H": H, "rank": rank})


def _local_counter_rows(counter, size: int, H: int, rank: int):
    """This rank's contiguous [size/H] block of the P('dp')-sharded
    global counter (process-major enumeration is asserted at setup)."""
    lo0 = rank * (size // H)
    rows = np.empty(size // H, np.int32)
    for sh in counter.addressable_shards:
        sl = sh.index[0]
        rows[(sl.start or 0) - lo0 : (sl.stop or size) - lo0] = np.asarray(sh.data)
    return rows


def _save_counter_ckpt(counter, out_file: str, fp: str, size: int,
                       H: int, rank: int):
    """Best-effort atomic write of this rank's counter shard — lets a
    --resume restart skip the whole -M pass (disable with
    RKMH_TPU_MCTR_CKPT=0)."""
    if not fp or os.environ.get("RKMH_TPU_MCTR_CKPT", "1") == "0":
        return
    path = _counter_ckpt_path(out_file, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, fp=np.frombuffer(fp.encode(), np.uint8),
                                rows=_local_counter_rows(counter, size, H,
                                                         rank))
        os.replace(tmp, path)
    except OSError as e:
        log(f"dist rank {rank}: -M counter checkpoint skipped ({e})")
        try:
            os.remove(tmp)
        except OSError:
            pass


def _load_counter_ckpt(mesh, out_file: str, fp: str, size: int, H: int,
                       rank: int):
    """The checkpointed counter (global, P('dp')-sharded) or None.
    Every rank must agree (a collective decides): one rank missing its
    shard forces the full -M pass everywhere — the pass itself is
    collective, so a partial reload cannot work."""
    have = 0
    if fp and os.environ.get("RKMH_TPU_MCTR_CKPT", "1") != "0":
        try:
            with np.load(_counter_ckpt_path(out_file, rank)) as z:
                if bytes(z["fp"]).decode() == fp:
                    rows = z["rows"].astype(np.int32)
                    if rows.shape == (size // H,):
                        have = 1
        except (OSError, KeyError, ValueError):
            have = 0
    if not _allmin(have, H):
        return None
    from jax.sharding import NamedSharding, PartitionSpec as P

    # re-read under the validated fingerprint (kept out of the collective)
    with np.load(_counter_ckpt_path(out_file, rank)) as z:
        rows = z["rows"].astype(np.int32)
    return put_local(rows, (size,), NamedSharding(mesh, P("dp")))


def _iter_owned_batches(read_files, chunk_reads, N, B, Bl, rank, L,
                        with_records: bool = False, index=None,
                        start_batch: int = 0):
    """Yield (batch_index, codes [Bl, L], lens [Bl], names [Bl]) for every
    global batch, in order — including trailing batches with no owned
    real rows (lockstep requires dispatching them anyway).  Rows this
    host does not own are never encoded; unfilled rows are all-PAD.
    with_records adds a 5th element: per-row (name, seq, qual) tuples
    (None for unowned rows) — the filter drain re-emits passing reads.

    With a complete input index (per-file (offs, lens) from _scan_input)
    the iterator SEEKS to each batch's owned block and parses only the
    ~Bl records this rank owns — O(N/H) parse work per pass instead of
    the full-reparse fallback below.  start_batch>0 (the --resume
    watermark) suppresses the first batches: the indexed path never
    touches their bytes; the fallback still parses them (it has no way
    to skip bytes) but does not yield them, so their DEVICE work is
    skipped either way."""
    if index is not None:
        yield from _iter_owned_batches_indexed(
            read_files, index, N, B, Bl, rank, L, with_records, start_batch)
        return
    n_batches = -(-N // B) if N else 0

    def fresh():
        bufs = [np.full((Bl, L), PAD_CODE, np.uint8),
                np.zeros(Bl, np.int32), [None] * Bl]
        if with_records:
            bufs.append([None] * Bl)
        return bufs

    b = 0
    bufs = fresh()
    r = 0  # global row index of the chunk's first record
    for chunk in iter_packed_chunks(read_files, chunk_reads):
        ccodes = np.asarray(chunk.codes)
        clens = np.asarray(chunk.lens)
        cnames = None
        n = len(chunk)
        pos = 0  # offset within this chunk
        while pos < n:
            g = r + pos
            while b < g // B:  # batches strictly before g are complete
                if b >= start_batch:
                    yield (b, *bufs)
                b += 1
                bufs = fresh()
            lo, hi = _owned_block(b, B, Bl, rank)
            seg_end = min(r + n, (b + 1) * B)  # chunk rows inside batch b
            s, e = max(g, lo), min(seg_end, hi)
            if s < e:
                if cnames is None:
                    cnames = chunk.names
                w = ccodes.shape[1]
                bufs[0][s - lo : e - lo, :w] = ccodes[s - r : e - r]
                bufs[1][s - lo : e - lo] = clens[s - r : e - r]
                bufs[2][s - lo : e - lo] = cnames[s - r : e - r]
                if with_records:
                    seqs = chunk.seqs[s - r : e - r]
                    quals = chunk.quals[s - r : e - r]
                    bufs[3][s - lo : e - lo] = [
                        (nm, sq, ql) for nm, sq, ql in
                        zip(cnames[s - r : e - r], seqs, quals)
                    ]
            pos = seg_end - r
        r += n
    while b < n_batches:
        if b >= start_batch:
            yield (b, *bufs)
        b += 1
        bufs = fresh()


def _iter_owned_batches_indexed(read_files, index, N, B, Bl, rank, L,
                                with_records: bool = False,
                                start_batch: int = 0):
    """The `_iter_owned_batches` fast path: with a complete `.idx` input
    index, each global batch's owned block is a known (file, record
    range), so this host SEEKS the native stream to its block start and
    parses exactly the ~Bl records it owns — O(N/H) parse bytes per
    pass instead of O(N), and start_batch>0 (the --resume watermark)
    skips straight past completed batches without touching their bytes.
    Yields exactly what the full-reparse path yields (tests pin
    equality batch by batch)."""
    from rkmh_tpu.io.native import FastxStream

    if isinstance(read_files, (str, bytes)) or not isinstance(
            read_files, (list, tuple)):
        read_files = [read_files]
    n_batches = -(-N // B) if N else 0
    bases = [0]  # global record index of each file's first record
    for offs, flens in index:
        bases.append(bases[-1] + len(flens))
    streams: list = [None] * len(read_files)
    at_rec = [0] * len(read_files)  # record index each stream is parked at
    try:
        for b in range(start_batch, n_batches):
            codes = np.full((Bl, L), PAD_CODE, np.uint8)
            lens = np.zeros(Bl, np.int32)
            names: list = [None] * Bl
            recs: list = [None] * Bl
            lo, hi = _owned_block(b, B, Bl, rank)
            hi = min(hi, N)
            for f, (offs, _flens) in enumerate(index):
                s, e = max(lo, bases[f]), min(hi, bases[f + 1])
                if s >= e:
                    continue
                ls, le = s - bases[f], e - bases[f]
                if streams[f] is None:
                    streams[f] = FastxStream(read_files[f])
                    at_rec[f] = 0
                if at_rec[f] != ls:  # already parked there when sequential
                    streams[f].seek(int(offs[ls]))
                chunk = streams[f].next_chunk(le - ls)
                if chunk is None or len(chunk) != le - ls:
                    from rkmh_tpu.io.input_index import index_path

                    raise RuntimeError(
                        f"{read_files[f]} changed under its input index "
                        f"(wanted records [{ls}, {le}) at offset "
                        f"{int(offs[ls])}, got "
                        f"{0 if chunk is None else len(chunk)}) — delete "
                        f"{index_path(read_files[f])} and rerun")
                at_rec[f] = le
                w = chunk.codes.shape[1]
                codes[s - lo : e - lo, :w] = chunk.codes
                lens[s - lo : e - lo] = chunk.lens
                cnames = chunk.names
                names[s - lo : e - lo] = cnames
                if with_records:
                    recs[s - lo : e - lo] = [
                        (nm, sq, ql) for nm, sq, ql in
                        zip(cnames, chunk.seqs, chunk.quals)
                    ]
            if with_records:
                yield b, codes, lens, names, recs
            else:
                yield b, codes, lens, names
    finally:
        for st in streams:
            if st is not None:
                st.close()


def _assert_process_contiguous(sharding, B: int, Bl: int, rank: int):
    """The row→host mapping above assumes process p's local devices hold
    rows [p*Bl, (p+1)*Bl) of a P('dp')-sharded [B, ...] array.  True for
    process-major device enumeration (the JAX default); raise (not a
    bare assert — it must survive python -O) rather than silently
    misroute reads."""
    import jax

    idx_map = sharding.devices_indices_map((B,))
    mine = sorted({
        (sl[0].start or 0, sl[0].stop if sl[0].stop is not None else B)
        for d, sl in idx_map.items()
        if d.process_index == jax.process_index()
    })  # set: tp replicas repeat each dp row block
    got = (mine[0][0], mine[-1][1])
    gaps = [m for m, nxt in zip(mine, mine[1:]) if m[1] != nxt[0]]
    if got != (rank * Bl, rank * Bl + Bl) or gaps:
        raise RuntimeError(
            f"process {rank} owns rows {mine}, expected the contiguous "
            f"block ({rank * Bl}, {rank * Bl + Bl}) — device enumeration "
            "is not process-major on this topology; refusing to misroute "
            "reads")


def put_local(local_rows, shape, sharding):
    """This process's rows -> its shard of a global array."""
    import jax

    return jax.make_array_from_process_local_data(
        sharding, local_rows, shape)


def _write_meta(out_file: str, B: int, H: int, fmt: str = "stream",
                extra: dict | None = None):
    """Record the stripe geometry next to the rank files so
    rkmh-tpu-dist-merge never has to be handed the (internally rounded)
    global batch size by hand.  fmt 'stream' = fixed one-line-per-read
    stripes; 'filter' = variable records with per-batch counts in the
    rank .idx sidecars; 'call' adds devices/refs_total/reference via
    `extra`.  Every rank writes identical content, so the same-host
    last-writer race is benign."""
    import json
    import os

    path = f"{out_file}.dist.json"
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"global_batch": B, "procs": H, "format": fmt,
                   **(extra or {})}, fh)
    os.replace(tmp, path)  # atomic: a killed rank never leaves torn JSON


def _dist_counter_pass(mesh, cfg, ks, chunk_reads, N, B, Bl, rank, L,
                       codes_sharding, index=None):
    """-M lockstep global counter pass (dp-sharded, spans hosts;
    rkmh counts every read k-mer occurrence before classifying).
    Shared by the stream/filter setup and the hpv16 drain."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rkmh_tpu.parallel.ep import (
        sharded_counter_add_codes_fn, sharded_counter_init,
    )

    counter = sharded_counter_init(mesh, cfg.counter_size)
    add = sharded_counter_add_codes_fn(mesh, cfg.counter_size, ks)
    lens_sharding = NamedSharding(mesh, P("dp"))
    for b, codes, lens, names in _iter_owned_batches(
            cfg.read_files, chunk_reads, N, B, Bl, rank, L, index=index):
        counter = add(counter,
                      put_local(codes, (B, L), codes_sharding),
                      put_local(lens, (B,), lens_sharding))
    return counter


def _counter_pass_ckpt(mesh, cfg, ks, chunk_reads, N, B, Bl, rank, H, L,
                       codes_sharding, dp, index=None):
    """The -M counter pass with a per-rank shard checkpoint next to the
    output: --resume restores the finished counter instead of re-running
    the whole counting pass (the pass spans ALL reads — no watermark can
    shrink it, only skipping it entirely helps).  Contains collectives;
    every rank must reach it in lockstep."""
    fp = (_counter_fingerprint(cfg.read_files, ks, cfg.counter_size, dp,
                               H, rank) if cfg.out_file else "")
    if cfg.resume and cfg.out_file:
        counter = _load_counter_ckpt(mesh, cfg.out_file, fp,
                                     cfg.counter_size, H, rank)
        if counter is not None:
            log(f"dist rank {rank}: -M counter restored from "
                f"{_counter_ckpt_path(cfg.out_file, rank)}; counting pass "
                "skipped")
            return counter
    counter = _dist_counter_pass(mesh, cfg, ks, chunk_reads, N, B, Bl,
                                 rank, L, codes_sharding, index=index)
    if cfg.out_file:
        _save_counter_ckpt(counter, cfg.out_file, fp, cfg.counter_size,
                           H, rank)
    return counter


class _DistCtx:
    """Shared state of a lockstep classify-family distributed run."""

    __slots__ = ("H", "rank", "mesh", "codes_sharding", "tables_g",
                 "ref_lens_g", "rps", "B", "Bl", "L", "N", "ks",
                 "counter", "chunk_reads", "panel", "index")


def _setup_classify_dist(cfg, cmd: str):
    """Init + geometry + panel + mesh/tables + input scan + optional -M
    counter pass, shared by the stream and filter drains.  Returns a
    _DistCtx, or None after logging the refusal reason."""
    import jax

    from rkmh_tpu.parallel.distributed import initialize

    if getattr(cfg, "in_stream", False):
        log(f"{cmd} --dist-* cannot combine with -i (stdin is host-local "
            "and multi-host batches run in lockstep)")
        return None
    if cfg.resume and not cfg.out_file:
        log(f"{cmd} --dist-* --resume requires -o <file> (resume state is "
            "each rank's partial stripe); refusing to reclassify to stdout")
        return None
    if not _rereadable_inputs(cfg.read_files):
        log(f"{cmd} --dist-* requires re-readable -f files on every host "
            "(the counting pre-pass and the classify pass each read the "
            "input; stdin/FIFOs would be consumed by the first)")
        return None

    initialize(cfg.dist_coordinator or None,
               cfg.dist_procs or None,
               cfg.dist_rank if cfg.dist_rank >= 0 else None)
    H = jax.process_count()
    rank = jax.process_index()

    ndev = jax.device_count()
    n_local = len(jax.local_devices())
    tp = cfg.tp
    if tp < 1 or ndev % tp or n_local % tp:
        log(f"{cmd} --dist-*: --tp {tp} must divide the {n_local} local "
            f"devices (panel all_gather must ride intra-host links)")
        return None
    dp = ndev // tp
    if cfg.min_kmer_occ >= 0 and cfg.counter_size % dp:
        log(f"{cmd} --dist-*: -M counter size {cfg.counter_size} is not "
            f"divisible by the {dp} dp shards")
        return None

    from rkmh_tpu.commands.common import resolve_batch_size

    ctx = _DistCtx()
    ctx.H, ctx.rank = H, rank
    B = resolve_batch_size(cfg.batch_size)
    ctx.B = B = -(-B // (dp * H)) * (dp * H)  # % dp == 0 and % H == 0
    ctx.Bl = B // H
    ctx.chunk_reads = resolve_chunk_reads(cfg.chunk_reads)

    ctx.ks = tuple(cfg.ks) if cfg.ks else (16,)
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")

    # panel: every host builds the identical panel from the same files
    if cfg.ref_sketches:
        from rkmh_tpu.io.sketch_json import load_sketches, panel_from_sketches

        with open(cfg.ref_sketches) as fh:
            panel = panel_from_sketches(load_sketches(fh), cfg.sketch_size)
    else:
        from rkmh_tpu.commands.common import build_ref_panel_from_files

        kwargs = dict(max_samples=cfg.max_samples,
                      counter_size=cfg.counter_size)
        if cmd == "filter":  # filter -I counts once per sample
            kwargs["distinct_counter"] = True
        panel = build_ref_panel_from_files(
            cfg.ref_files, ctx.ks, cfg.sketch_size, **kwargs)
    ctx.panel = panel
    if panel.num_refs % tp:
        log(f"{cmd} --dist-*: --tp {tp} does not divide {panel.num_refs} "
            "references")
        return None

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rkmh_tpu.parallel.mesh import build_sharded_tables, make_mesh
    from rkmh_tpu.utils import to_host

    ctx.mesh = make_mesh(jax.devices(), dp=dp, tp=tp)
    ctx.codes_sharding = NamedSharding(ctx.mesh, P("dp", None))
    _assert_process_contiguous(
        NamedSharding(ctx.mesh, P("dp")), B, ctx.Bl, rank)

    sk_np, lens_np = to_host((panel.sketches, panel.lens))
    tables, ctx.rps = build_sharded_tables(
        np.asarray(sk_np), np.asarray(lens_np), tp)
    ctx.tables_g = jax.device_put(
        jnp.asarray(tables), NamedSharding(ctx.mesh, P("tp", None, None)))
    ctx.ref_lens_g = jax.device_put(
        np.asarray(lens_np), NamedSharding(ctx.mesh, P()))

    ctx.N, maxlen, ctx.index = _scan_input(cfg.read_files, ctx.chunk_reads)
    ctx.L = bucket_length(max(maxlen, 1))
    log(f"dist rank {rank}/{H}: {ctx.N} reads, pad {ctx.L}, global batch "
        f"{B} ({ctx.Bl} rows/host), mesh dp={dp} tp={tp}"
        f"{', indexed' if ctx.index is not None else ''}")

    ctx.counter = None
    if cfg.min_kmer_occ >= 0:
        ctx.counter = _counter_pass_ckpt(
            ctx.mesh, cfg, ctx.ks, ctx.chunk_reads, ctx.N, B, ctx.Bl,
            rank, H, ctx.L, ctx.codes_sharding, dp, index=ctx.index)
    return ctx


def _load_meta(out_file: str):
    """The .dist.json geometry sidecar, or None (absent/corrupt —
    callers decide whether that is fatal)."""
    import json

    try:
        with open(f"{out_file}.dist.json") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _check_resume_geometry(cfg, B: int, H: int, stripe_exists: bool):
    """--resume only makes sense against stripes written with the SAME
    geometry — a changed global batch or rank count silently remaps read
    ownership, so a missing/corrupt/mismatched sidecar is fatal when a
    stripe exists (the skip counts would drop or duplicate the wrong
    reads).  No stripe and no sidecar = a fresh start, which --resume
    permits (matching the single-host commands)."""
    meta = _load_meta(cfg.out_file)
    if meta is None:
        if stripe_exists:
            raise RuntimeError(
                f"--resume needs the {cfg.out_file}.dist.json sidecar of "
                "the interrupted run to verify the stripe geometry, and "
                "it is missing or unreadable — rerun without --resume")
        return
    if (meta.get("global_batch"), meta.get("procs")) != (B, H):
        raise RuntimeError(
            f"--resume geometry mismatch: {cfg.out_file}.dist.json records "
            f"global_batch={meta.get('global_batch')} procs="
            f"{meta.get('procs')} but this run would use {B}/{H} — rerun "
            "with the original --batch-size/--dist-procs or without "
            "--resume")


def _open_rank_out(cfg, out, rank: int, H: int, B: int, fmt: str):
    """(out stream, close flag, resume_skip lines); rank files get the
    geometry sidecar.  With --resume, dispatch restarts at the
    `_resume_watermark` batch (the last one EVERY rank fully emitted —
    collectives need all ranks in lockstep, so no rank can skip further
    alone); each rank additionally skips re-emitting overhang lines its
    stripe already holds — idempotent, byte-identical to an
    uninterrupted run.  The filter/search drains manage their own skip
    via their .idx checkpoints, so their resume_skip is always 0 (no
    wasted stripe scan here)."""
    import os

    if out is not None:
        return out, False, 0
    if cfg.out_file:
        from rkmh_tpu.commands.recovery import count_complete_lines

        path = f"{cfg.out_file}.{rank}" if H > 1 else cfg.out_file
        skip = 0
        if cfg.resume:
            _check_resume_geometry(cfg, B, H, os.path.exists(path))
        if cfg.resume and os.path.exists(path):
            if fmt not in ("filter", "search"):  # those ride idx sidecars
                skip = count_complete_lines(path)
                log(f"dist rank {rank}: resuming, {skip} lines already "
                    f"landed in {path}")
            fh = open(path, "a")
        else:
            fh = open(path, "w")
        # (re)write after validation — idempotent, atomic
        _write_meta(cfg.out_file, B, H, fmt)
        return fh, True, skip
    return sys.stdout, False, 0


def _fetch_mine_cols(res, n_rows: int, B: int, Bl: int, rank: int):
    """This host's [n_rows, Bl] columns of an [n_rows, B] packed result
    sharded P(None, 'dp')."""
    cols = np.empty((n_rows, Bl), np.int64)
    for sh in res.addressable_shards:
        sl = sh.index[1]
        lo = sl.start or 0
        cols[:, lo - rank * Bl : (sl.stop or B) - rank * Bl] = \
            np.asarray(sh.data)
    return cols


def run_distributed(cfg, out=None) -> int:
    """stream --dist-*: entry from stream.run."""
    import jax
    import jax.numpy as jnp

    ctx = _setup_classify_dist(cfg, "stream")
    if ctx is None:
        return 1
    B, Bl, rank = ctx.B, ctx.Bl, ctx.rank

    from rkmh_tpu.parallel.mesh import sharded_classify_table_fn

    fn = sharded_classify_table_fn(
        ctx.mesh, ctx.ks, cfg.sketch_size, ctx.rps,
        cfg.min_diff, cfg.min_matches,
        counter_size=cfg.counter_size if ctx.counter is not None else None,
        min_occ=cfg.min_kmer_occ)
    extra = (ctx.counter,) if ctx.counter is not None else ()

    @jax.jit
    def packed(codes, tables, *extra):
        best, shared, diff_ok, depth_fail, match_fail = fn(
            codes, tables, *extra)
        flags = (
            diff_ok.astype(jnp.int64)
            | (depth_fail.astype(jnp.int64) << 1)
            | (match_fail.astype(jnp.int64) << 2)
        )
        return jnp.stack([best.astype(jnp.int64),
                          shared.astype(jnp.int64), flags])

    out, close_out, skip = _open_rank_out(cfg, out, rank, ctx.H, B, "stream")
    start_batch = 0
    if cfg.resume:  # collective — every rank calls it (skip may be 0)
        start_batch, skip = _resume_watermark(
            skip, ctx.N, B, Bl, rank, ctx.H)
        if start_batch:
            log(f"dist rank {rank}: watermark — dispatch resumes at "
                f"batch {start_batch} ({skip} overhang lines to skip)")

    from rkmh_tpu.commands.stream import format_lines_host

    def emit(names, res):
        nonlocal skip
        arr = _fetch_mine_cols(res, 3, B, Bl, rank)
        real = [i for i, nm in enumerate(names) if nm is not None]
        if skip:  # --resume: these rows' lines already landed
            drop = min(skip, len(real))
            real = real[drop:]
            skip -= drop
        if not real:
            return
        out.write(format_lines_host(
            ctx.panel.keys, [names[i] for i in real], arr[:, real],
            cfg.sketch_size))

    pending: deque = deque()
    try:
        for b, codes, lens, names in _iter_owned_batches(
                cfg.read_files, ctx.chunk_reads, ctx.N, B, Bl, rank, ctx.L,
                index=ctx.index, start_batch=start_batch):
            pending.append(
                (names, packed(put_local(codes, (B, ctx.L),
                                         ctx.codes_sharding),
                               ctx.tables_g, *extra)))
            if len(pending) > 3:
                emit(*pending.popleft())
        while pending:
            emit(*pending.popleft())
    finally:
        if close_out:
            out.close()
    return 0


def _truncate_to_lines(path: str, n_lines: int) -> int:
    """Truncate a text file to exactly its first n_lines lines; returns
    the count actually kept (fewer = the file was SHORTER than asked —
    callers treat an idx that claims more than the stripe holds as a
    corrupt checkpoint and restart the rank)."""
    with open(path, "r+b") as fh:
        off = 0
        kept = 0
        for _ in range(n_lines):
            line = fh.readline()
            if not line or not line.endswith(b"\n"):
                break
            off += len(line)
            kept += 1
        fh.truncate(off)
    return kept


def run_distributed_filter(cfg, out=None) -> int:
    """filter --dist-*: the keep-and-re-emit drain over the cross-host
    mesh.  filter emits a VARIABLE number of records per stripe block,
    so each rank also writes `<out>.<rank>.idx` (one passing-record
    count per global batch, flushed after the records it covers); the
    merge reads the counts instead of assuming fixed-width stripes.

    --resume: the idx sidecar doubles as the checkpoint — a rank
    truncates its stripe to the records the (torn-tail-truncated) idx
    covers, re-dispatches every batch (lockstep), and skips re-emitting
    the covered ones.  Records are flushed before their idx line, so
    the idx never points past the stripe.
    """
    import os

    ctx = _setup_classify_dist(cfg, "filter")
    if ctx is None:
        return 1
    B, Bl, rank = ctx.B, ctx.Bl, ctx.rank

    from rkmh_tpu.parallel.mesh import sharded_filter_table_fn

    sfn = sharded_filter_table_fn(
        ctx.mesh, ctx.ks, cfg.sketch_size, ctx.rps,
        cfg.min_diff, cfg.min_matches,
        counter_size=cfg.counter_size if ctx.counter is not None else None,
        min_occ=cfg.min_kmer_occ)
    extra = (ctx.counter,) if ctx.counter is not None else ()

    # --resume pre-step: reconcile stripe + idx BEFORE _open_rank_out
    # opens the stripe for append
    resume_batches = 0
    path = (f"{cfg.out_file}.{rank}" if ctx.H > 1 else cfg.out_file) \
        if cfg.out_file else None
    idx_path = f"{path}.idx" if path else None
    if cfg.resume and path:
        # geometry must hold BEFORE touching the stripe — the idx counts
        # only mean anything under the original batch/rank layout
        _check_resume_geometry(cfg, B, ctx.H, os.path.exists(path))
    if cfg.resume and path and os.path.exists(path):
        from rkmh_tpu.commands.recovery import count_complete_lines

        if idx_path and os.path.exists(idx_path):
            count_complete_lines(idx_path)  # truncate a torn idx tail
            with open(idx_path) as fh:
                counts = [int(x) for x in fh.read().split()]
            resume_batches = len(counts)
            kept = _truncate_to_lines(path, sum(counts) * 4)
            if kept < sum(counts) * 4:
                # the idx claims records the stripe does not hold (a
                # lost stripe tail): the checkpoint is corrupt — restart
                # this rank rather than resume around a hole
                log(f"dist rank {rank}: stripe holds {kept} lines but "
                    f"{idx_path} covers {sum(counts) * 4}; restarting "
                    "this rank's stripe from scratch")
                os.remove(path)
                os.remove(idx_path)
                resume_batches = 0
            else:
                log(f"dist rank {rank}: resuming, {resume_batches} "
                    f"batches ({sum(counts)} records) already landed in "
                    f"{path}")
        else:
            log(f"dist rank {rank}: --resume without {idx_path}; "
                "restarting this rank's stripe from scratch")
            os.remove(path)

    # collective — every rank calls it (its resume_batches may be 0);
    # dispatch restarts at the last batch EVERY rank checkpointed, and
    # ranks with longer idx files skip re-emitting their overhang
    start_batch = _allmin(resume_batches, ctx.H) if cfg.resume else 0
    if start_batch:
        log(f"dist rank {rank}: watermark — dispatch resumes at batch "
            f"{start_batch}")

    out, close_out, _skip0 = _open_rank_out(cfg, out, rank, ctx.H, B, "filter")
    idx_fh = open(idx_path, "a" if resume_batches else "w") if idx_path else None
    batches_done = start_batch

    def emit(recs, res):
        nonlocal batches_done
        if batches_done < resume_batches:
            batches_done += 1  # --resume: this batch's records already landed
            return
        arr = _fetch_mine_cols(res, 5, B, Bl, rank)
        keep = arr[3]
        wrote = 0
        for i, rec in enumerate(recs):
            if rec is None or not keep[i]:
                continue
            name, seq, qual = rec
            qual = qual if qual is not None else b"I" * len(seq)
            out.write(f">{name}\n{seq.decode()}\n+\n{qual.decode()}\n")
            wrote += 1
        batches_done += 1
        if idx_fh is not None:
            out.flush()  # the idx line must never point past the stripe
            idx_fh.write(f"{wrote}\n")
            idx_fh.flush()

    pending: deque = deque()
    try:
        for b, codes, lens, names, recs in _iter_owned_batches(
                cfg.read_files, ctx.chunk_reads, ctx.N, B, Bl, rank, ctx.L,
                with_records=True, index=ctx.index, start_batch=start_batch):
            pending.append(
                (recs, sfn(put_local(codes, (B, ctx.L), ctx.codes_sharding),
                           ctx.tables_g, ctx.ref_lens_g, *extra)))
            if len(pending) > 3:
                emit(*pending.popleft())
        while pending:
            emit(*pending.popleft())
    finally:
        if idx_fh is not None:
            idx_fh.close()
        if close_out:
            out.close()
    return 0


def run_distributed_hpv16(cfg, out=None) -> int:
    """hpv16 --dist-*: the tiered classifier over a cross-host mesh.

    Same lockstep global-batch recipe as run_distributed; the set tables
    are built identically on every host (deterministic from refpath+k).
    With --tp the ~600 MB PAVE type table shards over the tp axis of the
    GLOBAL (dp, tp) mesh instead of replicating per host — same memory
    class as single-host ``--devices --tp`` — with the per-shard counts
    all_gather riding intra-host links (tp must divide the local device
    count).  hpv16 emits exactly one line per read, so the same stripe
    files + rkmh-tpu-dist-merge reassembly applies.
    """
    import jax

    from rkmh_tpu.parallel.distributed import initialize

    if cfg.resume and not cfg.out_file:
        log("hpv16 --dist-* --resume requires -o <file> (resume state is "
            "each rank's partial stripe); refusing to reclassify to stdout")
        return 1
    if not _rereadable_inputs(cfg.read_files):
        log("hpv16 --dist-* requires re-readable -f files on every host "
            "(the counting pre-pass and the classify pass each read the "
            "input; stdin/FIFOs would be consumed by the first)")
        return 1

    initialize(cfg.dist_coordinator or None,
               cfg.dist_procs or None,
               cfg.dist_rank if cfg.dist_rank >= 0 else None)
    H = jax.process_count()
    rank = jax.process_index()
    ndev = jax.device_count()
    n_local = len(jax.local_devices())
    tp = max(getattr(cfg, "tp", 1), 1)
    if ndev % tp or n_local % tp:
        log(f"hpv16 --dist-*: --tp {tp} must divide the {n_local} local "
            f"devices (the type-counts all_gather must ride intra-host "
            "links)")
        return 1
    dp = ndev // tp
    if cfg.min_kmer_occ > 0 and cfg.counter_size % dp:
        log(f"hpv16 --dist-*: -M counter size {cfg.counter_size} is not "
            f"divisible by the {dp} dp shards")
        return 1

    from rkmh_tpu.commands.common import resolve_batch_size

    B = resolve_batch_size(cfg.batch_size)
    B = -(-B // (dp * H)) * (dp * H)  # % dp == 0 and % H == 0
    Bl = B // H
    chunk_reads = resolve_chunk_reads(cfg.chunk_reads)

    from rkmh_tpu.commands.hpv16_cmd import (
        build_tables, format_read_lines, make_sharded_hpv16_step,
    )

    if not cfg.ks:
        log("NO KMER SIZE PROVIDED. USING A DEFAULT KMER SIZE OF 16")
        ks = (16,)
    else:
        ks = tuple(cfg.ks)
    tb = build_tables(cfg, ks, tp_shards=tp)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from rkmh_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices(), dp=dp, tp=tp)
    codes_sharding = NamedSharding(mesh, P("dp", None))
    _assert_process_contiguous(NamedSharding(mesh, P("dp")), B, Bl, rank)

    N, maxlen, index = _scan_input(cfg.read_files, chunk_reads)
    L = bucket_length(max(maxlen, 1))
    log(f"dist rank {rank}/{H}: {N} reads, pad {L}, global batch {B} "
        f"({Bl} rows/host), mesh dp={dp} tp={tp}"
        f"{', indexed' if index is not None else ''}")

    # -M: rkmh.cpp:2513-2530 counts every read k-mer occurrence
    counter = None
    if cfg.min_kmer_occ > 0:
        counter = _counter_pass_ckpt(
            mesh, cfg, ks, chunk_reads, N, B, Bl, rank, H, L,
            codes_sharding, dp, index=index)

    # the same combined-table split-dispatch step as single-host
    # --devices (hpv16_cmd.make_sharded_hpv16_step).  The probe width is
    # the FULL window count: compaction needs the global batch's max
    # valid-window count, but each rank only sees its own rows' lens —
    # a rank-local Wc would give different collective programs.
    step = make_sharded_hpv16_step(
        mesh, tb, ks, tp,
        cfg.counter_size if counter is not None else None,
        cfg.min_kmer_occ)
    W_full = sum(max(L - k + 1, 0) for k in ks)

    out, close_out, skip = _open_rank_out(cfg, out, rank, H, B, "stream")
    start_batch = 0
    if cfg.resume:  # collective — every rank calls it (skip may be 0)
        start_batch, skip = _resume_watermark(skip, N, B, Bl, rank, H)
        if start_batch:
            log(f"dist rank {rank}: watermark — dispatch resumes at "
                f"batch {start_batch} ({skip} overhang lines to skip)")

    U = tb.n_lin + tb.n_sub

    def fetch_mine(res):
        """This host's [Bl, 2+U] rows of the [B, 2+U] packed result."""
        rows = np.empty((Bl, 2 + U), np.int64)
        for sh in res.addressable_shards:
            sl = sh.index[0]
            lo = sl.start or 0
            rows[lo - rank * Bl : (sl.stop or B) - rank * Bl] = \
                np.asarray(sh.data)
        return rows

    def emit(names, lens, res):
        nonlocal skip
        arr = fetch_mine(res)
        real = [i for i, nm in enumerate(names) if nm is not None]
        if skip:  # --resume: these rows' lines already landed
            drop = min(skip, len(real))
            real = real[drop:]
            skip -= drop
        if not real:
            return
        out.write("".join(format_read_lines(
            tb, ks, [names[i] for i in real], lens[real], arr[real])))

    pending: deque = deque()
    try:
        for b, codes, lens, names in _iter_owned_batches(
                cfg.read_files, chunk_reads, N, B, Bl, rank, L,
                index=index, start_batch=start_batch):
            pending.append(
                (names, lens.copy(),
                 step(put_local(codes, (B, L), codes_sharding),
                      W_full, counter)))
            if len(pending) > 3:
                emit(*pending.popleft())
        while pending:
            emit(*pending.popleft())
    finally:
        if close_out:
            out.close()
    return 0


# ---------------------------------------------------------------------------
# hash / count / search --dist-* (round 4): the last cells of the
# {command x dist} matrix.  None of these needs a collective in the hot
# step (hash/search are per-read maps; count's collective lives in
# parallel/ep.py), so the drains are the lockstep skeleton with a plain
# jit over the dp-sharded global batch.
# ---------------------------------------------------------------------------


class _MapDistCtx:
    """Geometry of a lockstep map-style drain (no panel, no tp)."""

    __slots__ = ("H", "rank", "mesh", "codes_sharding", "lens_sharding",
                 "B", "Bl", "L", "N", "ks", "chunk_reads", "index")


def _setup_map_dist(cfg, cmd: str, default_k: int = 16):
    """Init + geometry + input scan for the hash/count/search drains.
    Returns a _MapDistCtx, or None after logging the refusal reason."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rkmh_tpu.parallel.distributed import initialize
    from rkmh_tpu.parallel.mesh import make_mesh

    if not _rereadable_inputs(cfg.read_files):
        log(f"{cmd} --dist-* requires re-readable -f files on every host "
            "(the counting pre-pass and the work pass each read the input; "
            "stdin/FIFOs would be consumed by the first)")
        return None

    initialize(cfg.dist_coordinator or None,
               cfg.dist_procs or None,
               cfg.dist_rank if cfg.dist_rank >= 0 else None)
    ctx = _MapDistCtx()
    ctx.H = jax.process_count()
    ctx.rank = jax.process_index()
    dp = jax.device_count()

    from rkmh_tpu.commands.common import resolve_batch_size

    B = resolve_batch_size(cfg.batch_size)
    ctx.B = B = -(-B // (dp * ctx.H)) * (dp * ctx.H)
    ctx.Bl = B // ctx.H
    ctx.chunk_reads = resolve_chunk_reads(cfg.chunk_reads)
    ctx.ks = tuple(cfg.ks) if cfg.ks else (default_k,)
    if not cfg.ks:
        log(f"Using default kmer size of {default_k}.")

    ctx.mesh = make_mesh(jax.devices(), dp=dp, tp=1)
    ctx.codes_sharding = NamedSharding(ctx.mesh, P("dp", None))
    ctx.lens_sharding = NamedSharding(ctx.mesh, P("dp"))
    _assert_process_contiguous(
        NamedSharding(ctx.mesh, P("dp")), B, ctx.Bl, ctx.rank)

    ctx.N, maxlen, ctx.index = _scan_input(cfg.read_files, ctx.chunk_reads)
    ctx.L = bucket_length(max(maxlen, 1))
    log(f"dist rank {ctx.rank}/{ctx.H}: {ctx.N} reads, pad {ctx.L}, "
        f"global batch {B} ({ctx.Bl} rows/host), mesh dp={dp}"
        f"{', indexed' if ctx.index is not None else ''}")
    return ctx


def _fetch_mine_rows(res, B: int, Bl: int, rank: int):
    """This host's [Bl, ...] rows of a [B, ...] result sharded P('dp', ...)."""
    rows = np.empty((Bl,) + res.shape[1:], res.dtype)
    for sh in res.addressable_shards:
        sl = sh.index[0]
        lo = sl.start or 0
        rows[lo - rank * Bl : (sl.stop or B) - rank * Bl] = np.asarray(sh.data)
    return rows


def run_distributed_hash(cfg, out=None) -> int:
    """hash --dist-*: per-read hash/sketch/wabbit lines over a cross-host
    mesh.  The step is a pure per-read map (no collective), so the drain
    is the lockstep skeleton + a jit over the dp-sharded batch; exactly
    one output line per read, so the fixed 'stream' stripes apply.

    -K is refused (kmerize is host-only — nothing to distribute; run it
    single-host) and so is --json/-o-prefix (the dump schema collects
    every record globally; hash the stripes to JSON per rank instead)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from rkmh_tpu.classify import engine
    from rkmh_tpu.commands.hash_cmd import _multiset_counts, _wabbit_line

    if cfg.output_kmers:
        log("hash --dist-* cannot combine with -K (kmerize is host-only; "
            "run it single-host)")
        return 1
    if cfg.json_out or cfg.sourmash_out or cfg.out_prefix:
        log("hash --dist-* cannot combine with --json/--sourmash/-o (the "
            "JSON dump collects every record; dump per-rank stripes "
            "instead)")
        return 1

    ctx = _setup_map_dist(cfg, "hash")
    if ctx is None:
        return 1
    B, Bl, rank, ks = ctx.B, ctx.Bl, ctx.rank, ctx.ks

    # i64 bitcasts: u64 leaves the device on the fast wire path
    @partial(jax.jit, static_argnames=("ks", "s"))
    def sketch_step(codes, ks, s):
        sk, sk_lens = engine.sketch_batch.__wrapped__(codes, ks, s)
        return jax.lax.bitcast_convert_type(sk, jnp.int64), sk_lens

    @partial(jax.jit, static_argnames=("ks",))
    def hash_step(codes, lens, ks):
        h, m = engine.hash_batch_with_mask.__wrapped__(codes, lens, ks)
        return jax.lax.bitcast_convert_type(h, jnp.int64), m

    out, close_out, skip = _open_rank_out(cfg, out, rank, ctx.H, B, "stream")
    start_batch = 0
    if getattr(cfg, "resume", False):  # collective — every rank calls it
        start_batch, skip = _resume_watermark(
            skip, ctx.N, B, Bl, rank, ctx.H)
        if start_batch:
            log(f"dist rank {rank}: watermark — dispatch resumes at "
                f"batch {start_batch} ({skip} overhang lines to skip)")

    def emit(names, res):
        nonlocal skip
        a, b = res
        va = _fetch_mine_rows(a, B, Bl, rank).view(np.uint64)
        vb = _fetch_mine_rows(b, B, Bl, rank)
        real = [i for i, nm in enumerate(names) if nm is not None]
        if skip:  # --resume: these rows' lines already landed
            drop = min(skip, len(real))
            real = real[drop:]
            skip -= drop
        if not real:
            return
        if cfg.sketch_size > 0:
            for i in real:
                mins = va[i, : vb[i]].tolist()
                if cfg.wabbitize:
                    counts = (_multiset_counts(mins)
                              if cfg.output_counts else None)
                    out.write(_wabbit_line(names[i], mins, ks,
                                           cfg.sketch_size, counts))
                else:
                    out.write(f"{names[i]}\t{' '.join(map(str, mins))}\n")
            return
        if not cfg.wabbitize:
            from rkmh_tpu.io.native import format_hash_lines_block

            blk = format_hash_lines_block(
                va[real], vb[real], [names[i] for i in real])
            if blk is not None:
                out.write(blk.decode())
                return
        for i in real:
            vals = va[i][vb[i]].tolist()
            if cfg.wabbitize:
                mins = sorted(v for v in vals if v != 0)
                counts = _multiset_counts(mins) if cfg.output_counts else None
                out.write(_wabbit_line(names[i], mins, ks,
                                       cfg.sketch_size, counts))
            else:
                out.write(f"{names[i]}\t{' '.join(map(str, vals))}\n")

    pending: deque = deque()
    try:
        for b, codes, lens, names in _iter_owned_batches(
                cfg.read_files, ctx.chunk_reads, ctx.N, B, Bl, rank, ctx.L,
                index=ctx.index, start_batch=start_batch):
            cg = put_local(codes, (B, ctx.L), ctx.codes_sharding)
            if cfg.sketch_size > 0:
                res = sketch_step(cg, ks, cfg.sketch_size)
            else:
                lg = put_local(lens, (B,), ctx.lens_sharding)
                res = hash_step(cg, lg, ks)
            pending.append((names, res))
            if len(pending) > 3:
                emit(*pending.popleft())
        while pending:
            emit(*pending.popleft())
    finally:
        if close_out:
            out.close()
    return 0


def run_distributed_count(cfg, out=None) -> int:
    """count --dist-*: the lossy depth counter built dp-sharded across
    hosts (parallel/ep.py psum_scatter — the one genuinely collective
    step of the map family), then all_gathered so every rank holds the
    full table; scatter-adds commute, so the table is bit-identical to
    a single-process run.  Only rank 0 emits (-o npz / --dump lines) —
    the output is one global table, not per-read stripes."""
    import sys as _sys

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    ctx = _setup_map_dist(cfg, "count")
    if ctx is None:
        return 1
    B, Bl, rank, ks = ctx.B, ctx.Bl, ctx.rank, ctx.ks

    dp = ctx.mesh.shape["dp"]
    if cfg.counter_size % dp:
        log(f"count --dist-*: counter size {cfg.counter_size} is not "
            f"divisible by the {dp} dp shards")
        return 1

    from rkmh_tpu.parallel.ep import (
        sharded_counter_add_codes_fn, sharded_counter_init,
    )

    counter = sharded_counter_init(ctx.mesh, cfg.counter_size)
    add = sharded_counter_add_codes_fn(ctx.mesh, cfg.counter_size, ks)
    total_kmers = 0
    total_reads = 0
    for b, codes, lens, names in _iter_owned_batches(
            cfg.read_files, ctx.chunk_reads, ctx.N, B, Bl, rank, ctx.L,
            index=ctx.index):
        counter = add(counter,
                      put_local(codes, (B, ctx.L), ctx.codes_sharding),
                      put_local(lens, (B,), ctx.lens_sharding))
        # summary totals over the GLOBAL batch: lens of unowned rows are 0
        # here, so every rank sums its own block and the log line uses the
        # global window-count formula on owned rows only; reads counted
        # from owned names
        total_reads += sum(1 for nm in names if nm is not None)
        total_kmers += int(
            sum(np.maximum(lens.astype(np.int64) - (k - 1), 0).sum()
                for k in ks))

    gather = jax.jit(lambda t: t,
                     out_shardings=NamedSharding(ctx.mesh, P()))
    table = np.asarray(gather(counter))
    occupied = int((table > 0).sum())
    log(f"dist rank {rank}: counted {total_kmers} kmers from "
        f"{total_reads} owned reads; global {cfg.counter_size}-slot table "
        f"has {occupied} slots occupied.")

    if rank == 0:
        out = out or _sys.stdout
        if cfg.out_file:
            np.savez_compressed(cfg.out_file, table=table,
                                size=cfg.counter_size, ks=np.asarray(ks))
            log(f"Saved counter table to {cfg.out_file}")
        if cfg.dump:
            (nz,) = np.nonzero(table)
            for slot in nz:
                out.write(f"{slot}\t{int(table[slot])}\n")
    return 0


def run_distributed_search(cfg, out=None) -> int:
    """search --dist-*: reference-kmer membership over a cross-host mesh.
    Every rank hashes the same reference token files (host-side, tiny);
    the read step is a per-read map (searchsorted vs the replicated key
    array).  Reads shorter than k emit NOTHING (reference behavior), so
    stripes are variable-length: each rank writes a `<out>.<rank>.idx`
    per-batch line-count sidecar, merged like filter's (fmt 'search',
    one line per record).  --resume rides the idx checkpoint exactly
    like filter's, composed with the all-rank batch watermark."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rkmh_tpu.commands.search_cmd import load_ref_kmers
    from rkmh_tpu.ops.hashing import kmer_window_hashes

    ctx = _setup_map_dist(cfg, "search")
    if ctx is None:
        return 1
    B, Bl, rank = ctx.B, ctx.Bl, ctx.rank
    k = ctx.ks[0]  # reference kmerizes with kmer[0] only (rkmh.cpp:2228)

    ref_hashes = load_ref_kmers(cfg.ref_files)
    log(f"Loaded {len(ref_hashes)} reference kmers.")
    ref_g = jax.device_put(ref_hashes, NamedSharding(ctx.mesh, P()))

    @partial(jax.jit, static_argnames=("k", "have_refs"))
    def step(codes, refs, k, have_refs):
        wh = kmer_window_hashes(codes, k)
        if have_refs:
            pos = jnp.clip(jnp.searchsorted(refs, wh), 0, refs.shape[0] - 1)
            return (refs[pos] == wh) & (wh != np.uint64(0))
        return jnp.zeros(wh.shape, dtype=bool)

    # --resume pre-step: the idx sidecar is the checkpoint (filter's
    # recipe, 1 line per record) — reconcile BEFORE the stripe opens
    # for append, then agree on the all-rank dispatch watermark
    resume_batches = 0
    path = (f"{cfg.out_file}.{rank}" if ctx.H > 1 else cfg.out_file) \
        if cfg.out_file else None
    idx_path = f"{path}.idx" if path else None
    if cfg.resume and path:
        _check_resume_geometry(cfg, B, ctx.H, os.path.exists(path))
    if cfg.resume and path and os.path.exists(path):
        from rkmh_tpu.commands.recovery import count_complete_lines

        if idx_path and os.path.exists(idx_path):
            count_complete_lines(idx_path)  # truncate a torn idx tail
            with open(idx_path) as fh:
                counts = [int(x) for x in fh.read().split()]
            resume_batches = len(counts)
            kept = _truncate_to_lines(path, sum(counts))
            if kept < sum(counts):
                # idx claims lines the stripe lost: corrupt checkpoint —
                # restart this rank rather than resume around a hole
                log(f"dist rank {rank}: stripe holds {kept} lines but "
                    f"{idx_path} covers {sum(counts)}; restarting this "
                    "rank's stripe from scratch")
                os.remove(path)
                os.remove(idx_path)
                resume_batches = 0
            else:
                log(f"dist rank {rank}: resuming, {resume_batches} "
                    f"batches ({sum(counts)} lines) already landed in "
                    f"{path}")
        else:
            log(f"dist rank {rank}: --resume without {idx_path}; "
                "restarting this rank's stripe from scratch")
            os.remove(path)
    start_batch = _allmin(resume_batches, ctx.H) if cfg.resume else 0
    if start_batch:
        log(f"dist rank {rank}: watermark — dispatch resumes at batch "
            f"{start_batch}")

    out, close_out, _skip0 = _open_rank_out(cfg, out, rank, ctx.H, B, "search")
    idx_fh = (open(idx_path, "a" if resume_batches else "w")
              if idx_path else None)
    batches_done = start_batch

    def emit(recs, res):
        nonlocal batches_done
        if batches_done < resume_batches:
            batches_done += 1  # --resume: this batch's lines already landed
            return
        found = _fetch_mine_rows(res, B, Bl, rank)
        wrote = 0
        for i, rec in enumerate(recs):
            if rec is None:
                continue
            name, seq, _qual = rec
            nwin = len(seq) - k + 1
            if nwin <= 0:
                continue  # reference emits nothing for reads shorter than k
            idx = np.nonzero(found[i, :nwin])[0]
            mers = ",".join(seq[j : j + k].decode() for j in idx)
            out.write(f"{name}\t{mers}\n")
            wrote += 1
        batches_done += 1
        if idx_fh is not None:
            out.flush()  # the idx line must never point past the stripe
            idx_fh.write(f"{wrote}\n")
            idx_fh.flush()

    pending: deque = deque()
    try:
        for b, codes, lens, names, recs in _iter_owned_batches(
                cfg.read_files, ctx.chunk_reads, ctx.N, B, Bl, rank, ctx.L,
                with_records=True, index=ctx.index, start_batch=start_batch):
            pending.append(
                (recs, step(put_local(codes, (B, ctx.L), ctx.codes_sharding),
                            ref_g, k, bool(ref_hashes.size))))
            if len(pending) > 3:
                emit(*pending.popleft())
        while pending:
            emit(*pending.popleft())
    finally:
        if idx_fh is not None:
            idx_fh.close()
        if close_out:
            out.close()
    return 0


def merge_outputs(rank_files, batch_size: int, out=None) -> int:
    """Interleave per-rank stripe files back into single-process order.

    Each rank file holds blocks of batch_size/H lines in increasing
    global order; round-robin one block per rank until all files drain.
    """
    out = out or sys.stdout
    H = len(rank_files)
    Bl = batch_size // H
    fhs = [open(p) for p in rank_files]
    try:
        while True:
            got = 0
            for fh in fhs:
                for _ in range(Bl):
                    line = fh.readline()
                    if not line:
                        break
                    out.write(line)
                    got += 1
            if not got:
                return 0
    finally:
        for fh in fhs:
            fh.close()


def merge_outputs_filter(rank_files, lines_per_record: int = 4,
                         out=None) -> int:
    """Merge filter --dist-* stripes: the per-batch passing-record counts
    live in each rank's `<file>.idx` sidecar (one int per global batch),
    so blocks of variable size reassemble in single-process order."""
    out = out or sys.stdout
    fhs = [open(p) for p in rank_files]
    idx = [open(f"{p}.idx") for p in rank_files]
    try:
        batch = 0
        while True:
            counts = [i.readline() for i in idx]
            if not any(counts):
                return 0
            if not all(counts):
                # one rank's idx ended early: its run was interrupted
                # before its peers' — refusing beats emitting a merge
                # that looks complete but silently misses its blocks
                short = [rank_files[j] for j, c in enumerate(counts) if not c]
                raise RuntimeError(
                    f"rank idx files disagree at batch {batch}: "
                    f"{short} ended early — the interrupted rank(s) must "
                    "be rerun with --resume before merging")
            for fh, c in zip(fhs, counts):
                for _ in range(int(c) * lines_per_record):
                    out.write(fh.readline())
            batch += 1
    finally:
        for fh in fhs + idx:
            fh.close()


def run_distributed_call(cfg, out=None) -> int:
    """call --dist-*: the positional scan sharded across a cross-host
    mesh (reference: single-host OpenMP only, rkmh.cpp:1766-1883).

    Each host builds the SAME read depth map (global state — the scan
    probes arbitrary hashes, so it must be whole on every device; the
    build is device-hashing-bound and deterministic), then every
    reference's position axis shards over the global dp mesh
    (mesh.sharded_call_scan_fn, ppermute window halos riding the mesh).
    Rank r aggregates only its own position stripe into per-ref partial
    sections (<out>.<rank>); `rkmh-tpu-dist-merge` merges the partials —
    aggregation commutes (count sum, depth maxes), so the merged VCF is
    byte-identical to single-process.  --resume: ranks re-dispatch every
    scan (collectives need lockstep) but skip re-appending sections
    already in their stripe.
    """
    import jax

    from rkmh_tpu.commands.call_cmd import (
        CallAggregator, build_depth_map, extract_records, load_partials,
    )
    from rkmh_tpu.parallel.distributed import initialize

    if cfg.show_depth:
        log("call --dist-* does not support -d/--show-depth (per-position "
            "dump is a debugging surface; run it single-host)")
        return 1
    if not cfg.out_file:
        log("call --dist-* requires -o <file> (per-rank partials merge "
            "with rkmh-tpu-dist-merge)")
        return 1
    if not _rereadable_inputs(cfg.read_files):
        log("call --dist-* requires re-readable -f files on every host")
        return 1
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")
        ks = (16,)
    elif len(cfg.ks) > 1:
        log("Only a single kmer size may be used for calling.")
        return 1
    else:
        ks = tuple(cfg.ks)
    k = ks[0]

    initialize(cfg.dist_coordinator or None,
               cfg.dist_procs or None,
               cfg.dist_rank if cfg.dist_rank >= 0 else None)
    H = jax.process_count()
    rank = jax.process_index()
    ndev = jax.device_count()
    n_local = len(jax.local_devices())

    from rkmh_tpu.commands.common import (
        load_packed, load_records, resolve_batch_size,
    )
    from rkmh_tpu.io.packing import bucket_length, encode_seqs
    from rkmh_tpu.parallel.mesh import make_mesh, sharded_call_scan_fn
    from rkmh_tpu.utils import to_host
    from rkmh_tpu import call_engine

    batch = resolve_batch_size(cfg.batch_size)
    refs = load_records(cfg.ref_files)
    reads = load_packed(cfg.read_files)
    if not refs or not len(reads):
        log("call requires at least one reference and one read file.")
        return 1
    table = build_depth_map(reads, ks, batch)
    if len(refs) > 1:
        log("WARNING: more than one ref provided. VCF will not be correct")

    mesh = make_mesh(jax.devices(), dp=ndev, tp=1)
    scan = sharded_call_scan_fn(mesh, k, cfg.window_len)
    from jax.sharding import NamedSharding, PartitionSpec as P

    slices_sh = NamedSharding(mesh, P("dp", None))
    # stripe math below assumes process-major device enumeration
    _assert_process_contiguous(
        NamedSharding(mesh, P("dp")), ndev, ndev // H, rank)

    import json
    import os

    path = f"{cfg.out_file}.{rank}"
    done_refs: list[str] = []
    refs_total = sum(1 for r in refs if len(r.seq) >= k)
    if cfg.resume:
        # validate BEFORE load_partials truncates the stripe or the
        # sidecar is overwritten: the stripe's position ownership
        # depends on (procs, total devices) — a changed geometry would
        # silently remap rows and the merged VCF would double-count or
        # drop positions
        meta = _load_meta(cfg.out_file)
        if meta is None:
            if os.path.exists(path):
                raise RuntimeError(
                    f"--resume needs the {cfg.out_file}.dist.json sidecar "
                    "of the interrupted run to verify the stripe geometry, "
                    "and it is missing or unreadable — rerun without "
                    "--resume")
        elif (meta.get("procs"), meta.get("devices")) != (H, ndev):
            raise RuntimeError(
                f"--resume geometry mismatch: {cfg.out_file}.dist.json "
                f"records procs={meta.get('procs')} devices="
                f"{meta.get('devices')} but this run would use {H}/{ndev} "
                "— rerun with the original process/device layout or "
                "without --resume")
        done_refs, _ = load_partials(path, truncate=True)
        if done_refs:
            log(f"dist rank {rank}: resuming, {len(done_refs)} ref "
                f"section(s) already in {path}")
        fh = open(path, "a")
    else:
        fh = open(path, "w")
    _write_meta(cfg.out_file, 0, H, "call",
                extra={"reference": cfg.ref_files[0], "devices": ndev,
                       "refs_total": refs_total})

    done_iter = iter(done_refs)
    pending_done = next(done_iter, None)
    log(f"dist rank {rank}/{H}: {len(refs)} ref(s), mesh dp={ndev} "
        f"({n_local} local)")

    try:
        for ref in refs:
            if len(ref.seq) < k:
                continue
            P_ = len(ref.seq) - k + 1
            Pl = -(-P_ // ndev)
            if Pl >= cfg.window_len:
                codes, _ = encode_seqs([ref.seq], pad_to=ndev * Pl + k)
                padded = np.concatenate([np.full(1, 4, np.uint8), codes[0]])
                slices = np.stack([
                    padded[d * Pl : d * Pl + Pl + k + 1] for d in range(ndev)
                ])
                res = scan(jax.device_put(slices, slices_sh), table)
                # this host's contiguous stripe of the [ndev*Pl] rows
                row_lo = rank * (ndev // H) * Pl
                row_hi = (rank + 1) * (ndev // H) * Pl
                mine = {}
                for name, arr in res.items():
                    buf = None
                    for sh in arr.addressable_shards:
                        sl = sh.index[0]
                        lo = sl.start or 0
                        data = np.asarray(sh.data)
                        if buf is None:
                            buf = np.zeros((row_hi - row_lo,) + data.shape[1:],
                                           data.dtype)
                        buf[lo - row_lo : lo - row_lo + data.shape[0]] = data
                    mine[name] = buf
                j_lo, j_hi, row_off = row_lo, row_hi, row_lo
            else:
                # short genome: identical single-device scan everywhere;
                # rank 0 owns all positions, others emit empty sections
                L = bucket_length(len(ref.seq))
                codes, _ = encode_seqs([ref.seq], pad_to=L)
                res = call_engine.call_scan_ref(
                    codes[0], table, k, cfg.window_len)
                mine = to_host(res)
                j_lo, j_hi, row_off = 0, (P_ if rank == 0 else 0), 0

            if pending_done is not None and pending_done == ref.name:
                pending_done = next(done_iter, None)
                continue  # section already checkpointed (still scanned:
                          # the collectives above need every rank)
            ref_agg = CallAggregator()
            extract_records(ref.name, codes[0], mine, P_, k, ref_agg.record,
                            j_lo=j_lo, j_hi=j_hi, row_off=row_off)
            lines = ref_agg.dump_lines()
            fh.writelines(lines)
            fh.write(json.dumps({"ref_done": ref.name, "n": len(lines)}) + "\n")
            fh.flush()
    finally:
        fh.close()
    return 0


def merge_outputs_call(rank_files, reference: str, out=None,
                       refs_total: int | None = None) -> int:
    """Merge call --dist-* per-rank partial aggregates into the final
    VCF (header + std::map-sorted records, byte-identical to
    single-process).

    Refuses incomplete inputs instead of silently emitting a VCF with
    missing position stripes: every rank must hold the SAME ref-section
    sequence (a rank killed mid-drain holds a prefix), and when the
    sidecar recorded refs_total (it does since round 3), each rank must
    hold exactly that many sections."""
    from rkmh_tpu.commands.call_cmd import (
        CallAggregator, load_partials, vcf_header,
    )

    out = out or sys.stdout
    agg = CallAggregator()
    first: tuple[str, list] | None = None
    for p in rank_files:
        done, part = load_partials(p)
        if refs_total is not None and len(done) != refs_total:
            raise RuntimeError(
                f"{p} holds {len(done)}/{refs_total} complete ref "
                "section(s) — that rank's drain ended early; rerun it "
                "with --resume before merging")
        if first is None:
            first = (p, done)
        elif done != first[1]:
            raise RuntimeError(
                f"rank stripes disagree: {p} holds {len(done)} complete "
                f"ref section(s) vs {len(first[1])} in {first[0]} — a "
                "rank ended early; rerun it with --resume before merging")
        agg.merge_from(part)
    out.write(vcf_header(reference))
    agg.emit_vcf_records(out)
    return 0


def merge_main(argv=None) -> int:
    """console entry: rkmh-tpu-dist-merge out.0 out.1 ...

    The stripe geometry (and format: fixed one-line-per-read stripes vs
    filter's variable records) comes from the <out>.dist.json sidecar
    the run writes next to the rank files; -b overrides the global
    batch explicitly (stream format only).
    """
    import argparse
    import re

    ap = argparse.ArgumentParser(
        description="Merge rkmh-tpu stream/filter/hpv16 --dist-* per-rank "
                    "outputs into single-process order.")
    ap.add_argument("-b", "--batch-size", type=int, default=0,
                    help="override the GLOBAL batch size (default: read it "
                         "from the <out>.dist.json sidecar)")
    ap.add_argument("rank_files", nargs="+",
                    help="per-rank outputs in rank order (out.0 out.1 ...)")
    args = ap.parse_args(argv)
    B, fmt = args.batch_size, "stream"
    base = re.sub(r"\.\d+$", "", args.rank_files[0])
    meta_path = f"{base}.dist.json"
    meta = _load_meta(base)  # None on absent OR corrupt sidecar
    if meta is not None and B:
        # explicit -b bypasses the sidecar geometry but keeps its format
        fmt = meta.get("format", "stream")
    elif meta is not None:
        fmt = meta.get("format", "stream")
        if meta.get("procs") != len(args.rank_files):
            ap.error(f"{meta_path} records {meta.get('procs')} ranks but "
                     f"{len(args.rank_files)} files were given")
        if not B:
            B = int(meta["global_batch"])
    import os

    if meta is None and all(os.path.exists(f"{p}.idx")
                            for p in args.rank_files):
        fmt = "filter"  # sidecar lost, but the idx files identify the format
    if fmt == "search":  # variable 1-line records with idx sidecars
        return merge_outputs_filter(args.rank_files, lines_per_record=1)
    if fmt == "filter":
        return merge_outputs_filter(args.rank_files)
    if fmt == "call":
        if meta is None or "reference" not in meta:
            ap.error(f"call merge needs the {meta_path} sidecar (it holds "
                     "the ##reference header path)")
        return merge_outputs_call(args.rank_files, meta["reference"],
                                  refs_total=meta.get("refs_total"))
    if not B:
        ap.error(f"no {meta_path} sidecar next to the rank files; "
                 "pass -b <global batch> explicitly")
    return merge_outputs(args.rank_files, B)


if __name__ == "__main__":
    raise SystemExit(merge_main())
