"""`stream` / `classify` command — per-read MinHash classification.

Byte-identical output to the reference's hot loop (rkmh.cpp:891-893):

    ref \t read \t max_shared \t sketch_size[FAIL:DEPTH] \t [FAIL:MATCHES] \t [FAIL:DIFF]

with rkmh's exact argmax/diff semantics (scan max starting at -1, strict
>, first-reference tie-break; see classify.engine.argmax_stream).  The
deprecated `classify` subcommand forwards here just like rkmh.cpp:2744-47.

-M (min k-mer depth) and -I (max samples / informative k-mers) use the
device HashCounter with rkmh's lossy-modulo table sizes (2e8,
rkmh.cpp:739-742) by default.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from rkmh_tpu.classify import engine
from rkmh_tpu.commands.common import (
    DEFAULT_BATCH,
    DEFAULT_KMER,
    DEFAULT_SKETCH,
    ShardedCtx as _ShardedCtx,
    load_packed,
    bucketed_batches,
    iter_packed_chunks,
    resolve_chunk_reads,
    log,
)
from rkmh_tpu.ops.counter import HashCounter

from rkmh_tpu.commands.common import FETCH_GROUP  # single tuning home

# peak count of simultaneously buffered (formatted-but-unwritten) output
# lines in the last run() — observability for the constant-memory claim
last_peak_buffered_lines = 0


@dataclass
class StreamConfig:
    ref_files: list = field(default_factory=list)
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    sketch_size: int = DEFAULT_SKETCH
    min_kmer_occ: int = -1       # -M; <0 disables
    min_matches: int = -1        # -N
    min_diff: int = 0            # -D
    max_samples: int | None = None  # -I; None disables
    counter_size: int = 200_000_000  # rkmh.cpp:739-742
    batch_size: int = DEFAULT_BATCH
    threads: int = 1             # accepted for CLI parity; unused
    ref_sketches: str = ""       # JSON panel dump (hash -o) to load
    chunk_reads: int = 0         # streaming window; 0 = default (65536)
    out_file: str = ""           # -o: write here instead of stdout
    resume: bool = False         # --resume: continue an interrupted -o run
    in_stream: bool = False      # -i: classify STDIN, flushed per batch
    devices: int = 0             # --devices: SPMD over N local devices
    tp: int = 1                  # --tp: panel shards (devices = dp * tp)
    dist_coordinator: str = ""   # --dist-coordinator host:port (multi-host)
    dist_procs: int = 0          # --dist-procs: process count (multi-host)
    dist_rank: int = -1          # --dist-rank: this process's id


# the 8 possible "\t<sketch>[FAIL:DEPTH]\t[FAIL:MATCHES]\t[FAIL:DIFF]\n"
# line tails, indexed by flag bits diff_ok | depth_fail<<1 | match_fail<<2
def _tail_table(sketch_size: int):
    tails = []
    for f in range(8):
        diff_ok, depth, match = f & 1, f & 2, f & 4
        tails.append(
            f"\t{sketch_size}{'FAIL:DEPTH' if depth else ''}\t"
            f"{'FAIL:MATCHES' if match else ''}\t"
            f"{'' if diff_ok else 'FAIL:DIFF'}\n"
        )
    return tails


def format_lines_host(ref_keys, names, arr, sketch_size, as_list=False):
    """Format an already-fetched [3, B] packed result array."""
    best, shared, flags = (a.tolist() for a in arr)
    tails = _tail_table(sketch_size)
    lines = [
        f"{ref_keys[b]}\t{n}\t{c}{tails[f]}"
        for b, n, c, f in zip(best, names, shared, flags)
    ]
    return lines if as_list else "".join(lines)


def format_lines_packed(ref_keys, names, packed, sketch_size, as_list=False):
    """Format from the [3, B] int64 packed result (one D2H fetch).

    Byte-identical to the reference line layout (rkmh.cpp:891-893); the
    hot pieces (int->str, tail variants) are precomputed/bulk-converted.
    as_list returns the per-read lines (for bucket-reordered emission).
    """
    from rkmh_tpu.utils import to_host

    return format_lines_host(ref_keys, names, to_host(packed), sketch_size, as_list)


class _NativeFormatCtx:
    """Precomputed ref-key / tail blobs for the native block formatter."""

    __slots__ = ("ref_blob", "ref_offs", "tails_blob", "tail_offs")

    def __init__(self, ref_keys, sketch_size: int):
        keys = [k.encode() for k in ref_keys]
        self.ref_blob = b"".join(keys)
        self.ref_offs = np.cumsum([0] + [len(k) for k in keys], dtype=np.int64)
        tails = [t.encode() for t in _tail_table(sketch_size)]
        self.tails_blob = b"".join(tails)
        self.tail_offs = np.cumsum([0] + [len(t) for t in tails], dtype=np.int64)

    def format_block(self, arr, row_ids, chunk) -> bytes | None:
        """One formatted byte block for a fetched [3, n] result, reading
        names straight from the native parser's blob (no per-read Python
        string).  None when the chunk lacks blobs (PyPacked fallback)."""
        blob = getattr(chunk, "_names_blob", None)
        if blob is None:
            return None
        from rkmh_tpu.io.native import format_lines_block

        return format_lines_block(
            arr, row_ids, blob, chunk._name_offs,
            self.ref_blob, self.ref_offs, self.tails_blob, self.tail_offs,
        )


from rkmh_tpu.commands.common import ChunkState as _BaseChunkState


class _NamesOnly:
    """The slice of a parsed chunk the formatter needs: name blob +
    offsets (native fast path) and the lazy names list (fallback).

    Holding this instead of the full PackedReads lets the chunk's code
    tensors and seq/qual blobs free as soon as its batches are
    dispatched — the pipeline window spans ~dozens of batches, and
    keeping whole chunks alive that long tripled peak RSS.
    """

    __slots__ = ("_names_blob", "_name_offs", "_src", "_names")

    def __init__(self, chunk):
        self._names_blob = getattr(chunk, "_names_blob", None)
        self._name_offs = getattr(chunk, "_name_offs", None)
        self._src = None if self._names_blob is not None else chunk.names
        self._names = None

    @property
    def names(self):
        if self._src is not None:
            return self._src
        if self._names is None:
            o = self._name_offs
            b = self._names_blob
            self._names = [
                b[o[i] : o[i + 1]].decode() for i in range(len(o) - 1)
            ]
        return self._names


class _ChunkState(_BaseChunkState):
    """Per-input-chunk output buffer: results land out of (bucket) order
    and the chunk is written the moment every row has arrived.

    Parts are either (start_row:int, text_block) — the native formatter's
    contiguous-rows fast path — or (rows:list, lines:list) from the
    per-line fallback; render() reassembles input order either way.
    """

    __slots__ = ("chunk", "parts")

    def __init__(self, chunk):
        super().__init__(len(chunk))
        self.chunk = _NamesOnly(chunk)
        self.parts = []

    def render(self) -> str:
        if all(isinstance(key, int) for key, _ in self.parts):
            return "".join(
                text for _, text in sorted(self.parts, key=lambda p: p[0])
            )
        lines = [None] * self.n
        for key, payload in self.parts:
            if isinstance(key, int):
                seg = payload.split("\n")
                seg.pop()  # trailing empty piece
                for j, s in enumerate(seg):
                    lines[key + j] = s + "\n"
            else:
                for i, line in zip(key, payload):
                    lines[i] = line
        return "".join(lines)


# shared failure-recovery machinery (commands.recovery): line-counted
# resume fits stream because it emits exactly one line per read
from rkmh_tpu.commands.recovery import (
    count_complete_lines as _count_complete_lines,
    skip_reads as _skip_reads,
)


def _make_plain_step(panel, ks, cfg: StreamConfig, pack2: bool):
    """The no-counter classify step (hash -> sketch -> probe -> argmax ->
    pack) as one closure: whole step in one jit (one dispatch per batch)."""

    def step(codes, lens):
        L = codes.shape[1]
        if pack2 and engine.pack4_ok(L):
            from rkmh_tpu.io.packing import pack_codes4

            pk, vb = pack_codes4(codes)
            return engine.classify_packed4_table_packed2(
                pk, vb, L, *panel.table, ks=ks, sketch_size=cfg.sketch_size,
                num_refs=panel.num_refs, min_diff=cfg.min_diff,
                min_matches=cfg.min_matches,
            )
        elif pack2:
            fn, args = engine.classify_codes_table_packed2, (codes,)
        else:
            fn, args = engine.classify_codes_table_packed, (codes,)
        return fn(
            *args, *panel.table, ks=ks, sketch_size=cfg.sketch_size,
            num_refs=panel.num_refs, min_diff=cfg.min_diff,
            min_matches=cfg.min_matches,
        )

    return step


class _ShardedClassify(_ShardedCtx):
    """--devices N [--tp T]: the classify step as one SPMD program over a
    (dp, tp) mesh of local devices (parallel/mesh.py) — reads dp-sharded,
    the panel table tp-sharded (tiled all_gather merge before the exact
    argmax scan), and with -M the depth counter dp-sharded
    (parallel/ep.py; commands.common.ShardedCtx).  Bit-identical to the
    single-device step (tests/test_parallel.py, tests/test_stream_e2e.py);
    results use the [3, B] int64 wire.

    The reference's scaling story is one OpenMP thread pool
    (rkmh.cpp:813-898); this is its mesh equivalent at the CLI surface.
    """

    def __init__(self, panel, ks, cfg: StreamConfig):
        super().__init__(panel, ks, cfg.devices, cfg.tp,
                         cfg.counter_size, cfg.batch_size)
        self.cfg = cfg

    def make_step(self):
        import jax
        import jax.numpy as jnp

        from rkmh_tpu.parallel.mesh import sharded_classify_table_fn

        cfg, ks = self.cfg, self.ks
        use_counter = self.counter is not None
        fn = sharded_classify_table_fn(
            self.mesh, ks, cfg.sketch_size, self.rps,
            cfg.min_diff, cfg.min_matches,
            counter_size=cfg.counter_size if use_counter else None,
            min_occ=cfg.min_kmer_occ)
        extra = (self.counter,) if use_counter else ()

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

        def step(codes, lens):
            codes, _ = self.pad_rows(codes)
            return packed(codes, self.tables, *extra)

        return step


def _validate_devices(cfg: StreamConfig, num_refs: int) -> str | None:
    """Reason --devices cannot apply (None = it can)."""
    import jax

    from rkmh_tpu.commands.common import sharded_geometry_reason

    if cfg.devices <= 1:
        return "unset"
    return sharded_geometry_reason(
        cfg.devices, cfg.tp, num_refs, len(jax.devices()),
        cfg.min_kmer_occ, cfg.counter_size)


# -i liveness knobs: how long the consumer waits for new input before it
# (a) emits an already-dispatched batch's results, (b) dispatches a
# partial batch.  (b) is longer so a fast-but-bursty producer still fills
# whole batches (each distinct batch shape is one XLA compile).
_STDIN_DRAIN_IDLE_S = 0.05
_STDIN_FLUSH_IDLE_S = 0.25


def _run_stdin(cfg: StreamConfig, out, panel, ks, pack2: bool, step, stdin) -> int:
    """stream -i: low-latency STDIN classification.

    The reference parses -i for stream but the path is dead (rkmh.cpp:
    608/710 — filter -i at 1329-1414 is its only live streaming mode);
    here it works: a reader thread feeds records into a bounded queue
    (the KSEQ_Reader-producer / omp-task-consumer split), the consumer
    assembles batches, keeps them pipelined on device, and writes+flushes
    each batch's lines the moment its results land — same byte format as
    file mode.  Liveness on a never-EOF source (``tail -f``): when input
    stalls, in-flight results are drained and a partial batch is
    dispatched rather than held until EOF.  Parse errors in the reader
    thread propagate to the caller (no silent truncation).  Batch shapes
    are padded to powers of two on both axes so an arbitrary-length
    stream compiles O(log) programs, not one per length.
    """
    import queue as _queue
    import threading
    from collections import deque

    from rkmh_tpu import observability
    from rkmh_tpu.io.fastx import iter_fastx
    from rkmh_tpu.io.packing import encode_seqs
    from rkmh_tpu.utils import next_pow2, to_host

    global last_peak_buffered_lines
    last_peak_buffered_lines = 0

    src = stdin if stdin is not None else "-"
    _EOF = object()
    q: _queue.Queue = _queue.Queue(maxsize=4 * cfg.batch_size)

    def _reader():
        try:
            for rec in iter_fastx(src):
                q.put(rec)
            q.put(_EOF)
        except BaseException as e:  # propagate parse/IO errors, don't EOF
            q.put(e)

    threading.Thread(target=_reader, daemon=True).start()

    def emit(chunk, res):
        arr = to_host(res)
        if pack2:
            arr = engine.unpack2_host(arr, len(chunk))
        out.write(format_lines_host(
            panel.keys, [r.name for r in chunk],
            arr[:, : len(chunk)], cfg.sketch_size,
        ))
        if hasattr(out, "flush"):
            out.flush()
        observability.count("reads", len(chunk))
        observability.count("bp", sum(len(r.seq) for r in chunk))

    def dispatch(batch):
        # power-of-two padding on both axes bounds the set of compiled
        # shapes; pad rows are empty reads whose results are sliced off
        maxlen = max(len(r.seq) for r in batch)
        pad_len = max(128, next_pow2(maxlen))
        n_pad = min(next_pow2(len(batch)), cfg.batch_size)
        seqs = [r.seq for r in batch] + [b""] * (n_pad - len(batch))
        codes, lens = encode_seqs(seqs, pad_to=pad_len)
        pending.append((batch, step(codes, lens)))
        global last_peak_buffered_lines
        last_peak_buffered_lines = max(
            last_peak_buffered_lines, sum(len(c) for c, _ in pending)
        )

    _IDLE = object()

    def _get(timeout):
        try:
            return q.get(timeout=timeout)
        except _queue.Empty:
            return _IDLE

    pending: deque = deque()
    batch: list = []
    err = None
    while True:
        rec = _get(_STDIN_DRAIN_IDLE_S) if (pending or batch) else q.get()
        if rec is _IDLE:
            # input idle: first surface finished work, then (after the
            # longer threshold) dispatch the partial batch
            if pending:
                emit(*pending.popleft())
                continue
            rec = _get(_STDIN_FLUSH_IDLE_S)  # batch is non-empty here
            if rec is _IDLE:
                dispatch(batch)
                batch = []
                continue
        if rec is _EOF:
            break
        if isinstance(rec, BaseException):
            err = rec
            break
        batch.append(rec)
        if len(batch) >= cfg.batch_size:
            dispatch(batch)
            batch = []
            if len(pending) > 2:
                emit(*pending.popleft())
    if batch and err is None:
        dispatch(batch)
    while pending:
        emit(*pending.popleft())
    if err is not None:
        raise err
    return 0


def run(cfg: StreamConfig, out=None, stdin=None) -> int:
    import os

    if (cfg.dist_procs > 1 or cfg.dist_coordinator
            or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        # multi-host (flags OR the standard JAX_* env vars — initialize()
        # reads both): lockstep global-batch drain over the cross-host
        # mesh (commands.dist_stream); bit-identical to a single-process
        # run after rkmh-tpu-dist-merge
        from rkmh_tpu.commands.dist_stream import run_distributed

        return run_distributed(cfg, out)

    resume_skip = 0
    close_out = False
    if cfg.resume and not cfg.out_file:
        log("stream --resume requires -o <file> (resume state is the "
            "partial output itself); refusing to reclassify to stdout")
        return 1
    if cfg.resume and cfg.in_stream:
        log("stream --resume cannot combine with -i: a stream is not "
            "re-readable, so skipped reads cannot be matched up")
        return 1
    if out is None and cfg.out_file:
        if cfg.resume and os.path.exists(cfg.out_file):
            # failure recovery: per-read output is deterministic, so an
            # interrupted run restarts by skipping the reads whose lines
            # already landed and appending (idempotent; rkmh has no
            # analog — it restarts from scratch)
            resume_skip = _count_complete_lines(cfg.out_file)
            log(f"Resuming: {resume_skip} reads already classified in "
                f"{cfg.out_file}")
            out = open(cfg.out_file, "a")
        else:
            out = open(cfg.out_file, "w")
        close_out = True
    out = out or sys.stdout
    try:
        return _run(cfg, out, resume_skip, stdin)
    finally:
        if close_out:
            out.close()


def _run(cfg: StreamConfig, out, resume_skip: int = 0, stdin=None) -> int:
    from rkmh_tpu.commands.common import resolve_batch_size

    cfg.batch_size = resolve_batch_size(cfg.batch_size)
    chunk_reads = resolve_chunk_reads(cfg.chunk_reads)
    ks = tuple(cfg.ks) if cfg.ks else (DEFAULT_KMER,)
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")

    in_stream = cfg.in_stream
    if in_stream and cfg.read_files:
        # reference parity: -i is dead in rkmh, so `stream -f reads.fq -i`
        # always classified the files — keep that meaning rather than
        # silently blocking on stdin
        log("stream -i ignored: -f inputs were given (rkmh classified the "
            "files here too — its -i is dead); classifying the files")
        in_stream = False
    if in_stream and cfg.min_kmer_occ >= 0:
        # -M needs a global depth pass over ALL reads before any can be
        # classified — incompatible with per-batch emission.  Fall back
        # to the buffered two-pass path over the same stream source
        # (exactly what the reference always does: it buffers the whole
        # input, rkmh.cpp:783-788).
        log("stream -i with -M: global depth counting buffers the stream "
            "(two passes); output is emitted after EOF.")
        cfg.read_files = [stdin if stdin is not None else "-"]
        in_stream = False

    if cfg.ref_sketches:
        from rkmh_tpu.io.sketch_json import load_sketches, panel_from_sketches

        with open(cfg.ref_sketches) as fh:
            panel = panel_from_sketches(load_sketches(fh), cfg.sketch_size)
    else:
        from rkmh_tpu.commands.common import build_ref_panel_from_files

        panel = build_ref_panel_from_files(
            cfg.ref_files,
            ks,
            cfg.sketch_size,
            max_samples=cfg.max_samples,
            counter_size=cfg.counter_size,
        )

    from rkmh_tpu.commands.common import ChunkedPipeline, two_pass_chunks

    sharded_reason = _validate_devices(cfg, panel.num_refs)
    if cfg.devices > 1 and sharded_reason not in (None, "unset"):
        log(f"stream --devices ignored ({sharded_reason}); "
            "running single-device")
    use_sharded = cfg.devices > 1 and sharded_reason is None
    sharded = _ShardedClassify(panel, ks, cfg) if use_sharded else None

    classify_chunks = None
    read_counter = None
    if cfg.min_kmer_occ >= 0:
        # first pass: global read-kmer depth (rkmh.cpp:903-910).  Plain
        # files are consumed in bounded chunks and re-read for the
        # classify pass — constant memory; stdin/FIFO inputs are buffered
        # (the only way to read them twice; see two_pass_chunks).
        # The classify pass re-hashes every read (as the reference does,
        # rkmh.cpp:911-917): caching pass-1 hashes instead would take an
        # [N, W] u64 cache of ~10 kB/read and break the constant-memory
        # guarantee.
        pass1, pass2 = two_pass_chunks(cfg.read_files, chunk_reads)
        if sharded is not None:
            # --devices: the counter itself shards over the dp axis
            # (parallel/ep.py) and the depth lookup fuses into the
            # sharded classify step
            sharded.build_counter(pass1)
        else:
            read_counter = HashCounter(cfg.counter_size)
            for chunk in pass1:
                for rows, codes, lens in bucketed_batches(chunk, cfg.batch_size):
                    if engine.pack4_ok(codes.shape[1]):
                        from rkmh_tpu.io.packing import pack_codes4

                        pk, vb = pack_codes4(codes)
                        hashes, mask = engine.hash_packed4_with_mask(
                            pk, vb, lens, codes.shape[1], ks
                        )
                    else:
                        hashes, mask = engine.hash_batch_with_mask(codes, lens, ks)
                    read_counter.add(hashes, mask)
        classify_chunks = pass2()
    if classify_chunks is None:
        classify_chunks = iter_packed_chunks(cfg.read_files, chunk_reads)
    if resume_skip:
        # note: the -M counter pass above still covers ALL reads (global
        # depths must match the uninterrupted run exactly)
        classify_chunks = _skip_reads(classify_chunks, resume_skip)

    # 4-byte-per-read result wire format when the panel fits it (see
    # engine pack2 notes); the [3, B] int64 layout is the general
    # fallback.  Input codes ship 2-bit packed on accelerators where the
    # chosen program consumes them (engine.pack4_ok).
    pack2 = (engine.pack2_supported(panel.num_refs, cfg.sketch_size)
             and not use_sharded)
    plain_step = (sharded.make_step() if sharded is not None
                  else _make_plain_step(panel, ks, cfg, pack2))

    if in_stream:
        return _run_stdin(cfg, out, panel, ks, pack2, plain_step, stdin)

    def device_step(codes, lens):
        L = codes.shape[1]
        if read_counter is not None:
            if engine.pack4_ok(L):
                from rkmh_tpu.io.packing import pack_codes4

                pk, vb = pack_codes4(codes)
                sk, sk_lens = engine.sketch_packed4_depth_filtered(
                    pk, vb, lens, read_counter.table, L, ks,
                    cfg.sketch_size, cfg.min_kmer_occ,
                )
            else:
                sk, sk_lens = engine.sketch_batch_depth_filtered(
                    codes, lens, read_counter.table, ks, cfg.sketch_size,
                    cfg.min_kmer_occ,
                )
            fn = (engine.classify_sketches_table_packed2 if pack2
                  else engine.classify_sketches_table_packed)
            return fn(
                sk, sk_lens, *panel.table,
                num_refs=panel.num_refs, min_diff=cfg.min_diff,
                min_matches=cfg.min_matches,
            )
        return plain_step(codes, lens)

    # Constant-memory pipelined drain (commands.common.ChunkedPipeline):
    # bounded parsed chunks, async dispatches kept in flight, grouped
    # fetches, per-chunk in-order emission — peak residency is the
    # in-flight window plus <= ~2 chunks of lines, independent of file
    # size (unlike the reference, which holds all parsed reads in RAM;
    # rkmh.cpp:783-788).
    fmt_ctx = _NativeFormatCtx(panel.keys, cfg.sketch_size)

    def on_result(st, rows, arr):
        if pack2:
            # arr may carry pad rows (batches round up to a power of
            # two and pack 2 reads per int64); unpack the real ones
            arr = engine.unpack2_host(arr, len(rows))
        # contiguous-rows batches (the common single-length-bucket
        # case) format as one native block — no per-read Python work
        blk = None
        if len(rows) and rows[-1] - rows[0] == len(rows) - 1:
            blk = fmt_ctx.format_block(arr[:, : len(rows)], rows, st.chunk)
        if blk is not None:
            st.parts.append((int(rows[0]), blk.decode()))
        else:
            batch_names = [st.chunk.names[i] for i in rows]
            lines = format_lines_host(
                panel.keys, batch_names, arr, cfg.sketch_size, as_list=True
            )
            st.parts.append((list(rows), lines))
        st.filled += len(rows)

    pipeline = ChunkedPipeline(
        on_result=on_result,
        emit=lambda st: out.write(st.render()),
        group=FETCH_GROUP,
    )
    pipeline.run(
        classify_chunks,
        make_state=_ChunkState,
        dispatch=lambda st, rows, codes, lens: (rows, device_step(codes, lens)),
        batch_size=cfg.batch_size,
    )
    global last_peak_buffered_lines
    last_peak_buffered_lines = pipeline.peak_buffered
    return 0
