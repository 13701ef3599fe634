"""Shared command plumbing: reference-panel building and read batching."""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from rkmh_tpu.io.fastx import SeqRecord, read_fastx
from rkmh_tpu.io.packing import encode_seqs, bucket_length
from rkmh_tpu.classify import engine
from rkmh_tpu.ops.counter import HashCounter

DEFAULT_KMER = 16        # rkmh.cpp:728-731
DEFAULT_SKETCH = 1000    # rkmh.cpp:592
DEFAULT_BATCH = 2048


def resolve_batch_size(requested: int) -> int:
    """--batch-size 0 = auto: large dispatches on accelerators (per-batch
    host overheads — dispatch, fetch — amortize over more reads), modest
    on CPU.  16k is not yet tuned on the GPU (ROADMAP Queue 1, item 9)."""
    if requested and requested > 0:
        return requested
    import jax

    try:
        return 16384 if jax.default_backend() != "cpu" else DEFAULT_BATCH
    except Exception:
        return DEFAULT_BATCH


def log(msg: str):
    print(msg, file=sys.stderr)


@dataclass
class RefPanel:
    keys: list[str]
    sketches: jnp.ndarray  # [R, s] sorted uint64, SENTINEL-padded
    lens: jnp.ndarray      # [R] int32
    table: tuple           # device arrays of the ops.lookup cuckoo table

    @property
    def num_refs(self) -> int:
        return len(self.keys)


def build_ref_panel(
    ref_packed,
    ks: tuple,
    sketch_size: int,
    max_samples: int | None = None,
    counter_size: int = 200_000_000,
    distinct_counter: bool = False,
) -> RefPanel:
    """Hash+sketch a reference panel and build its lookup table.

    ref_packed: a PackedReads/PyPacked (codes/lens/names).  With
    max_samples set, replicates the -I informative filter: count
    reference k-mer occurrences in a HASHTCounter (every occurrence for
    stream, rkmh.cpp:828-837; once per sample when distinct_counter=True,
    for filter, rkmh.cpp:340-357), then sketch only hashes occurring
    <= max_samples times.
    """
    codes, lens = ref_packed.codes, ref_packed.lens
    if max_samples is None:
        sk, sk_lens = engine.sketch_batch(codes, tuple(ks), sketch_size)
    else:
        hc = HashCounter(counter_size)
        if distinct_counter:
            x, first = engine.distinct_hash_mask(codes, lens, tuple(ks))
            hc.add(x, first)
        else:
            hashes, mask = engine.hash_batch_with_mask(codes, lens, tuple(ks))
            hc.add(hashes, mask)
        sk, sk_lens = engine.sketch_batch_informative(
            codes, hc.table, tuple(ks), sketch_size, max_samples
        )
    # Small panels build host-side (one small fetch; numpy build is fast
    # and dodges per-bucket-count device compiles).  Big panels (hpv16-
    # scale) build on device so the multi-hundred-MB table never crosses
    # host->device.  The path decision uses the R*s upper bound, which
    # needs no device program.
    table = _panel_table_arrays(sk, sk_lens)
    return RefPanel(list(ref_packed.names), sk, sk_lens, table)


def _panel_table_arrays(sk, sk_lens, sk_np=None, lens_np=None):
    """Lookup-table device arrays for a sketch matrix, small panels built
    host-side and big ones on device (shared by the build and cache-hit
    paths so the threshold/recipe can never diverge)."""
    from rkmh_tpu.utils import to_host

    if sk.size < 2_000_000:
        from rkmh_tpu.ops.lookup import build_panel_table

        if sk_np is None:
            sk_np, lens_np = to_host((sk, sk_lens))
        return build_panel_table(sk_np, lens_np).device_arrays()
    from rkmh_tpu.ops.lookup import build_panel_table_device

    return (build_panel_table_device(sk, sk_lens),)


_PANEL_CACHE_VERSION = 2  # v2: pickle-free payload, length-framed key


def _panel_cache_path(ref_files, ks, sketch_size, max_samples, counter_size,
                      distinct_counter) -> str | None:
    """Content-addressed cache file for a built reference panel, or None
    when caching is disabled (RKMH_TPU_PANEL_CACHE=0) or the refs are not
    plain files."""
    import hashlib
    import os

    env = os.environ.get("RKMH_TPU_PANEL_CACHE", "")
    if env == "0":
        return None
    cache_dir = env or os.path.join(
        os.path.expanduser("~"), ".cache", "rkmh_tpu", "panels"
    )
    h = hashlib.sha256()
    h.update(repr((
        _PANEL_CACHE_VERSION, tuple(ks), sketch_size, max_samples,
        counter_size if max_samples is not None else None, distinct_counter,
    )).encode())
    try:
        for p in ref_files:
            if p in ("-", b"-"):
                return None
            with open(p, "rb") as fh:
                data = fh.read()
            # length-framed: different file splits of identical
            # concatenated bytes must not collide onto one key
            h.update(len(data).to_bytes(8, "little"))
            h.update(data)
    except OSError:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    return os.path.join(cache_dir, h.hexdigest()[:32] + ".npz")


def build_ref_panel_from_files(
    ref_files,
    ks: tuple,
    sketch_size: int,
    max_samples: int | None = None,
    counter_size: int = 200_000_000,
    distinct_counter: bool = False,
) -> RefPanel:
    """build_ref_panel with a content-addressed on-disk sketch cache.

    Reference panels are hashed once and reused forever — the capability
    rkmh's JSON dump/load stubs gesture at (rkmh.cpp:552-561), automatic:
    the cache key digests the ref file bytes and every sketching
    parameter, the payload is the sketch matrix + names.  On a hit no
    reference hashing (and none of its device programs) runs at all.
    Disable with RKMH_TPU_PANEL_CACHE=0; point it at a directory to move
    the cache.
    """
    from rkmh_tpu.utils import to_host

    path = _panel_cache_path(ref_files, ks, sketch_size, max_samples,
                             counter_size, distinct_counter)
    if path is not None and os.path.exists(path):
        try:
            # no allow_pickle: names travel as a fixed-width unicode
            # array, so a planted/corrupt cache file cannot execute code
            # and a torn one just falls back to a rebuild
            z = np.load(path)
            sk_np = z["sk"]
            lens_np = z["lens"].astype(np.int32)
            names = [str(x) for x in z["names"]]
        except Exception as e:  # corrupt entry: rebuild and overwrite
            log(f"panel cache entry unreadable ({e!r}); rebuilding")
        else:
            sk_dev = jnp.asarray(sk_np)
            lens_dev = jnp.asarray(lens_np)
            table = _panel_table_arrays(sk_dev, lens_dev, sk_np, lens_np)
            return RefPanel(names, sk_dev, lens_dev, table)

    panel = build_ref_panel(
        load_packed(ref_files), ks, sketch_size,
        max_samples=max_samples, counter_size=counter_size,
        distinct_counter=distinct_counter,
    )
    if path is not None:
        sk_np, lens_np = to_host((panel.sketches, panel.lens))
        # unique tmp + atomic replace: concurrent cold-start runs must
        # not interleave writes or observe partial files
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                np.savez_compressed(
                    fh, sk=np.asarray(sk_np), lens=np.asarray(lens_np),
                    names=np.asarray([str(k) for k in panel.keys]),
                )
            os.replace(tmp, path)
        except OSError as e:
            log(f"panel cache write skipped ({e})")
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return panel


def load_records(paths) -> list[SeqRecord]:
    recs = read_fastx(paths)
    return recs


class PyPacked:
    """Python-parser fallback with the native PackedReads interface."""

    def __init__(self, records: list[SeqRecord], granularity: int = 128):
        self.codes, self.lens = encode_seqs(
            [r.seq for r in records], granularity=granularity
        )
        self.names = [r.name for r in records]
        self.seqs = [r.seq for r in records]
        self.quals = [r.qual for r in records]
        self.rec_offs = None  # no byte offsets: python path can't index

    def __len__(self):
        return len(self.names)


def load_packed(paths, granularity: int = 128):
    """Parse files straight into device-ready [N, L] code tensors.

    Uses the native C++ parser+packer (io/native, the kseq/KSEQ_Reader
    equivalent) when available, the Python parser otherwise.  Multiple
    files concatenate in order, padded to a common row length.
    """
    from rkmh_tpu.io.native import read_fastx_packed

    if isinstance(paths, (str, bytes)) or not isinstance(paths, (list, tuple)):
        paths = [paths]  # single path OR single file-like source
    parts = []
    for p in paths:
        pk = None
        if isinstance(p, (str, bytes)) and p not in ("-", b"-"):
            try:
                pk = read_fastx_packed(p, granularity)
            except OSError:
                pk = None
        if pk is None:
            # file-like sources must be wrapped: bare read_fastx(obj) would
            # iterate the object's lines as if they were paths
            pk = PyPacked(
                read_fastx(p if isinstance(p, (str, bytes)) else [p]),
                granularity,
            )
        parts.append(pk)
    if len(parts) == 1:
        return parts[0]

    L = max(p.codes.shape[1] for p in parts)
    N = sum(len(p) for p in parts)
    codes = np.full((N, L), 255, dtype=np.uint8)
    lens = np.zeros((N,), dtype=np.int32)
    names, seqs, quals = [], [], []
    at = 0
    for p in parts:
        n = len(p)
        codes[at : at + n, : p.codes.shape[1]] = p.codes
        lens[at : at + n] = p.lens
        names.extend(p.names)
        seqs.extend(p.seqs)
        quals.extend(p.quals)
        at += n
    merged = PyPacked.__new__(PyPacked)
    merged.codes, merged.lens = codes, lens
    merged.names, merged.seqs, merged.quals = names, seqs, quals
    return merged


DEFAULT_CHUNK_READS = 65536

# results fetched per grouped device_get; 2x this stays in flight (not
# yet tuned on the GPU: ROADMAP Queue 1, item 9)
FETCH_GROUP = 24


def resolve_chunk_reads(requested: int | None = None) -> int:
    """Streaming window size (reads per parsed chunk).  0/None = default;
    RKMH_TPU_CHUNK_READS overrides (tests force tiny windows with it)."""
    import os

    if requested and requested > 0:
        return requested
    env = os.environ.get("RKMH_TPU_CHUNK_READS", "")
    if env.isdigit() and int(env) > 0:
        return int(env)
    return DEFAULT_CHUNK_READS


def iter_packed_chunks(paths, chunk_reads: int, granularity: int = 128):
    """Yield device-ready PackedReads/PyPacked chunks of <= chunk_reads
    records — the constant-memory input path (KSEQ_Reader equivalent,
    rkmh.cpp:950-959): only one parsed chunk is resident at a time.

    Files are consumed in order (chunks never span files, matching
    load_packed's concatenation order).  Native streaming parser when
    available; Python iter_batches fallback otherwise (also the '-'
    stdin path).
    """
    from rkmh_tpu.io.fastx import iter_batches
    from rkmh_tpu.io.native import FastxStream

    if isinstance(paths, (str, bytes)) or not isinstance(paths, (list, tuple)):
        paths = [paths]  # single path OR single file-like source
    for p in paths:
        stream = None
        if isinstance(p, (str, bytes)) and p not in ("-", b"-"):
            try:
                stream = FastxStream(p)
            except OSError:
                stream = None
        if stream is not None:
            with stream:
                while True:
                    chunk = stream.next_chunk(chunk_reads, granularity)
                    if chunk is None:
                        break
                    yield chunk
        else:
            for recs in iter_batches(p, chunk_reads):
                yield PyPacked(recs, granularity)


def _is_fifo(path) -> bool:
    import stat as _stat

    try:
        import os

        return _stat.S_ISFIFO(os.stat(path).st_mode)
    except OSError:
        return False


def two_pass_chunks(paths, chunk_reads: int, granularity: int = 128):
    """(first_pass_iterable, second_pass_factory) over packed chunks.

    The -M commands read their input twice (counter pass, then classify
    pass).  Plain file paths re-read from disk — constant memory.  Stdin
    and FIFOs can only be read once, so their chunks are buffered in
    memory for the second pass (the reference buffers ALL input always,
    rkmh.cpp:783-788 — this is strictly no worse).
    """
    if isinstance(paths, (str, bytes)) or not isinstance(paths, (list, tuple)):
        paths = [paths]  # single path OR single file-like source
    rewindable = all(
        isinstance(p, (str, bytes)) and p not in ("-", b"-") and not _is_fifo(p)
        for p in paths
    )
    if rewindable:
        return (
            iter_packed_chunks(paths, chunk_reads, granularity),
            lambda: iter_packed_chunks(paths, chunk_reads, granularity),
        )
    chunks = list(iter_packed_chunks(paths, chunk_reads, granularity))
    return iter(chunks), lambda: iter(chunks)


class ChunkState:
    """Book-keeping base for a chunk moving through ChunkedPipeline:
    complete once all its batches were dispatched AND their results
    landed."""

    __slots__ = ("n", "filled", "dispatched")

    def __init__(self, n: int):
        self.n = n
        self.filled = 0
        self.dispatched = False

    @property
    def complete(self) -> bool:
        return self.dispatched and self.filled == self.n


class ChunkedPipeline:
    """Shared pipelined dispatch -> grouped-fetch -> in-order-emit loop
    for the chunked commands (stream/filter/hpv16).

    Dispatches are asynchronous; up to 2*group batches stay in flight and
    results are fetched in groups (one device_get per group).
    Chunks are emitted in input order the moment they complete, so peak
    residency is the in-flight window plus ~2 chunks — constant in the
    input size.

    on_result(state, meta, host_array): record one batch's fetched result
        into its chunk state and advance state.filled.
    emit(state): write one completed chunk's output.
    """

    def __init__(self, on_result, emit, group: int = FETCH_GROUP):
        from collections import deque

        from rkmh_tpu.commands.recovery import fail_after_chunks

        self.on_result = on_result
        self.emit = emit
        self.group = group
        self.pending = deque()   # (state, meta, device_result)
        self.emit_q = deque()    # chunk states in input order
        self.peak_buffered = 0
        self.emitted = 0
        self._fail_after = fail_after_chunks()

    def _drain(self):
        while self.emit_q and self.emit_q[0].complete:
            self.emit(self.emit_q.popleft())
            self.emitted += 1
            if self._fail_after and self.emitted >= self._fail_after:
                from rkmh_tpu.commands.recovery import InjectedFailure

                raise InjectedFailure(
                    f"RKMH_TPU_FAIL_AFTER_CHUNKS={self._fail_after} tripped"
                )

    def _flush(self, n: int):
        from rkmh_tpu.utils import to_host

        group = [self.pending.popleft() for _ in range(min(n, len(self.pending)))]
        if not group:
            return
        fetched = to_host([res for *_, res in group])
        for (st, meta, _), arr in zip(group, fetched):
            self.on_result(st, meta, arr)
        buffered = sum(s.filled for s in self.emit_q)
        if buffered > self.peak_buffered:
            self.peak_buffered = buffered
        self._drain()

    def run(self, chunk_iter, make_state, dispatch, batch_size: int):
        """Drive chunks end to end; dispatch(codes, lens) -> (meta,
        device_result) pairs come from bucketed batches of each chunk."""
        for chunk in chunk_iter:
            st = make_state(chunk)
            self.emit_q.append(st)
            for rows, codes, lens in bucketed_batches(chunk, batch_size):
                self.pending.append((st, *dispatch(st, rows, codes, lens)))
                if len(self.pending) > 2 * self.group:
                    self._flush(self.group)
            st.dispatched = True
        while self.pending:
            self._flush(len(self.pending))
        self._drain()


def packed_batches(packed, batch_size: int):
    """Yield (start, stop, codes [B, L], lens [B]) row slices with fixed
    batch shapes.  Short batches pad rows to the next power of two
    (capped at batch_size, same rule as bucketed_batches): the pad ships
    host->device as raw codes and comes back in per-read outputs, so a
    25-read file padded to a 16384-row auto batch would upload ~120 MB of
    nothing.  Compiled shapes stay logarithmic in batch_size."""
    from rkmh_tpu.observability import count

    N = len(packed)
    for s in range(0, N, batch_size):
        e = min(s + batch_size, N)
        codes = packed.codes[s:e]
        lens = packed.lens[s:e]
        count("reads", e - s)
        count("bp", int(lens.sum()))
        target = 8
        while target < e - s:
            target *= 2
        target = min(target, batch_size)
        if e - s < target:
            pad = target - (e - s)
            codes = np.concatenate(
                [codes, np.full((pad, codes.shape[1]), 255, np.uint8)]
            )
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        yield s, e, codes, lens


def fetch_rows(arrs, n: int, grid: int = 256):
    """to_host of the first ~n rows of per-read batch outputs.

    packed_batches pads the LAST batch to the fixed batch shape, so
    fetching whole outputs ships the pad too — for wide per-read arrays
    that dwarfs the real data (a 25-read `hash` batch padded to 16384
    rows would fetch ~1 GB of padding).  n rounds up to a 256 grid so at most a
    handful of tiny slice programs ever compile."""
    from rkmh_tpu.utils import to_host

    B = arrs[0].shape[0]
    m = min(B, -(-n // grid) * grid)
    if m >= B:
        return to_host(tuple(arrs))
    return to_host(tuple(a[:m] for a in arrs))


def bucketed_batches(packed, batch_size: int, max_buckets: int = 4):
    """Yield (rows [B] global indices, codes [B, Lb], lens [B]) grouped by
    padded-length bucket (io.packing.length_buckets, grid_length grid).

    For length-spread inputs (nanopore: 1.6-7.4 kb in minION25.fq) this
    bounds padding waste to the bucket grid instead of padding every read
    to the global max — up to ~2x less hashing work — at the cost of
    <= max_buckets * 2 compiled programs and out-of-order batch emission
    (callers reorder via the returned row indices).  Short uniform reads
    land on the fine 32-grid (z1.fq: L=160, not 256), which shrinks the
    dominant per-window table gather AND the packed H2D bytes.
    """
    from rkmh_tpu.io.packing import length_buckets
    from rkmh_tpu.observability import count

    N = len(packed)
    if N == 0:
        return
    uniq, bidx = length_buckets(packed.lens, max_buckets)
    for b, Lb in enumerate(uniq):
        sel = np.nonzero(bidx == b)[0]
        Lb = int(Lb)
        for off in range(0, len(sel), batch_size):
            rows = sel[off : off + batch_size]
            codes = packed.codes[rows][:, :Lb]
            lens = packed.lens[rows]
            count("reads", len(rows))
            count("bp", int(lens.sum()))
            # pad rows to the next power of two (capped at batch_size):
            # small inputs don't hash a full batch of padding, and the
            # number of compiled shapes stays logarithmic
            target = 8
            while target < len(rows):
                target *= 2
            target = min(target, batch_size)
            if len(rows) < target:
                pad = target - len(rows)
                codes = np.concatenate(
                    [codes, np.full((pad, Lb), 255, np.uint8)]
                )
                lens = np.concatenate([lens, np.zeros(pad, np.int32)])
            yield rows, codes, lens


def batch_iter(records: list[SeqRecord], batch_size: int, pad_to: int | None = None):
    """Yield (records_chunk, codes, lens) with a fixed padded length across
    the whole input (one compiled program); last chunk keeps its own size
    only if smaller (at most 2 compiled batch shapes)."""
    if not records:
        return
    if pad_to is None:
        pad_to = bucket_length(max(len(r.seq) for r in records))
    for i in range(0, len(records), batch_size):
        chunk = records[i : i + batch_size]
        seqs = [r.seq for r in chunk]
        if len(chunk) < batch_size:
            seqs = seqs + [b""] * (batch_size - len(chunk))  # pad rows
        codes, lens = encode_seqs(seqs, pad_to=pad_to)
        yield chunk, codes, lens


def sharded_geometry_reason(devices: int, tp: int, num_refs: int,
                            n_visible: int, min_kmer_occ: int = -1,
                            counter_size: int = 0) -> str | None:
    """Why a --devices geometry cannot apply (None = it can).  Shared by
    every command driver so fallback rules never diverge."""
    if tp < 1 or devices % tp:
        return f"--devices {devices} is not divisible by --tp {tp}"
    if devices > n_visible:
        return f"--devices {devices} > {n_visible} visible device(s)"
    if min_kmer_occ >= 0 and counter_size % (devices // tp):
        return (f"-M counter size {counter_size} is not divisible by "
                f"the {devices // tp} dp shards")
    if num_refs % tp:
        return f"--tp {tp} does not divide {num_refs} references"
    return None


class ShardedCtx:
    """Shared --devices machinery for the classify-family commands: a
    (dp, tp) device mesh, tp-sharded panel bucket tables, an optional
    dp-sharded -M depth counter (parallel/ep.py), and batch-row padding.
    Command drivers wrap it with their own packed SPMD step
    (parallel.mesh.sharded_*_table_fn flavors) — stream/classify use the
    [3, B] wire, filter the [5, B] wire.
    """

    def __init__(self, panel, ks, devices: int, tp: int,
                 counter_size: int, batch_size: int):
        import jax

        from rkmh_tpu.parallel.mesh import build_sharded_tables, make_mesh
        from rkmh_tpu.utils import to_host

        self.ks = ks
        self.devices, self.tp = devices, tp
        self.dp = devices // tp
        self.counter_size = counter_size
        self.batch_size = batch_size
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = make_mesh(jax.devices()[:devices], dp=self.dp, tp=tp)
        sk_np, lens_np = to_host((panel.sketches, panel.lens))
        self.ref_lens_np = np.asarray(lens_np)
        tables, self.rps = build_sharded_tables(
            np.asarray(sk_np), self.ref_lens_np, tp)
        # place the panel shards on the mesh ONCE — a plain jnp array
        # lands on the default device and would be resharded on every
        # dispatch (the whole table, each batch)
        self.tables = jax.device_put(
            tables, NamedSharding(self.mesh, P("tp", None, None)))
        self.ref_lens = jax.device_put(
            self.ref_lens_np, NamedSharding(self.mesh, P()))
        self.counter = None  # set by build_counter for the -M path

    def pad_rows(self, codes, lens=None):
        """Pad the batch to a dp multiple with all-invalid reads (code 4,
        length 0); consumers index only the real rows."""
        pad = (-codes.shape[0]) % self.dp
        if pad:
            codes = np.concatenate([
                codes, np.full((pad, codes.shape[1]), 4, dtype=codes.dtype),
            ])
            if lens is not None:
                lens = np.concatenate([
                    np.asarray(lens), np.zeros(pad, dtype=np.int32)])
        return codes, lens

    def build_counter(self, pass1_chunks):
        """-M first pass (rkmh.cpp:903-910) as a dp-sharded counter:
        hashing + window masking run inside the shard_map and the lossy
        table accumulates psum_scatter'd shards — content is bit-equal
        to the single-device HashCounter (addition commutes)."""
        from rkmh_tpu.parallel.ep import (
            sharded_counter_add_codes_fn, sharded_counter_init,
        )

        table = sharded_counter_init(self.mesh, self.counter_size)
        add = sharded_counter_add_codes_fn(self.mesh, self.counter_size, self.ks)
        for chunk in pass1_chunks:
            for rows, codes, lens in bucketed_batches(chunk, self.batch_size):
                codes, lens = self.pad_rows(codes, lens)
                table = add(table, codes, lens)
        self.counter = table


class DpCtx:
    """--devices surface for the panel-less per-read commands
    (hash / count / search): a dp-only mesh plus input-sharding helpers.

    The device steps stay the ordinary single-device jits — with
    row-sharded inputs GSPMD partitions the per-read work across the
    mesh (hashing, sketching and membership tests touch no cross-read
    axis), and results fetch in row order, so the text output is
    byte-identical to single-device.  `count`'s scatter-add runs on a
    replicated table, which GSPMD reduces with a psum; integer addition
    commutes, so the lossy table is bit-equal too.  The reference has no
    analog (hash/count/search are single-host OpenMP loops,
    rkmh.cpp:2058-2341); hashing throughput is a published reference
    metric (README.md:148), which is why `hash` gets the mesh surface.
    """

    def __init__(self, devices: int):
        import jax

        from jax.sharding import NamedSharding, PartitionSpec as P
        from rkmh_tpu.parallel.mesh import make_mesh

        self.devices = devices
        self.mesh = make_mesh(jax.devices()[:devices], dp=devices, tp=1)
        self._rows = NamedSharding(self.mesh, P("dp", None))
        self._vec = NamedSharding(self.mesh, P("dp"))

    @classmethod
    def maybe(cls, devices: int):
        """DpCtx when the geometry applies, None (with the same logged
        fallback as the classify-family drivers) when it can't — so
        `hash --devices 16` on an 8-device host degrades gracefully
        instead of crashing in make_mesh."""
        if not devices or devices <= 1:
            return None
        import jax

        reason = sharded_geometry_reason(
            devices, 1, 1, len(jax.devices()))
        if reason is not None:
            log(f"--devices ignored ({reason}); running single-device")
            return None
        return cls(devices)

    def round_batch(self, batch_size: int) -> int:
        """packed_batches pads every batch to the fixed batch size, so a
        dp-divisible batch size is the only padding dp needs."""
        return -(-batch_size // self.devices) * self.devices

    def put(self, codes, lens=None):
        """Place a batch row-sharded; rows pad to a dp multiple (all-
        invalid reads, which hash to nothing) — packed_batches shrinks
        small batches to powers of two, which dp=3/5/6/7 can't split."""
        import jax

        codes = np.asarray(codes)
        pad = (-codes.shape[0]) % self.devices
        if pad:
            codes = np.concatenate(
                [codes, np.full((pad, codes.shape[1]), 255, np.uint8)])
        codes = jax.device_put(codes, self._rows)
        if lens is None:
            return codes
        lens = np.asarray(lens, np.int32)
        if pad:
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        return codes, jax.device_put(lens, self._vec)
