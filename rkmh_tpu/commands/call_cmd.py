"""`call` command — alignment-free variant calling, VCF output.

Mirrors rkmh main_call (rkmh.cpp:1455-1904) with the enumeration kernel
in call_engine.py.  Flow: hash all reads -> exact hash->depth map
(ops/hashmap) -> per reference: positional depth, trailing-window
average, low-depth sites, SNP/DEL mutation rescue -> aggregate into VCF
records keyed and sorted exactly like the reference's std::map<string>
(lexicographic over "ref\\tpos\\t.\\tREF\\tALT" — so positions sort as
strings, 10 < 2, matching rkmh's output order).

Header quirks preserved byte-for-byte (rkmh.cpp:1740-1747): INFO declares
ID=KD but records emit KC=; the RD and OD INFO lines are concatenated on
one line (missing endl in the reference).

One deliberate improvement: the reference's -d/--show-depth path builds
its per-position "j\\tavg\\tdepth\\trescue" lines in a stringstream it
never prints (SURVEY.md §8 Q7-adjacent dead path); we actually emit them.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from rkmh_tpu import call_engine
from rkmh_tpu.classify import engine
from rkmh_tpu.commands.common import (
    bucketed_batches, load_packed, load_records, log,
)
from rkmh_tpu.io.packing import bucket_length, encode_seqs
from rkmh_tpu.ops.hashmap import depth_map_from_hashes
from rkmh_tpu.utils import to_host

_BASE = "ACGT"


@dataclass
class CallConfig:
    ref_files: list = field(default_factory=list)
    read_files: list = field(default_factory=list)
    ks: tuple = ()
    window_len: int = 100
    show_depth: bool = False
    batch_size: int = 2048
    devices: int = 0     # --devices: shard the positional scan over N devices
    out_file: str = ""   # -o: write the VCF here (required for --resume)
    resume: bool = False  # skip refs whose partials are checkpointed
    # --dist-*: shard the positional scan across hosts (dist_stream)
    dist_coordinator: str = ""
    dist_procs: int = 0
    dist_rank: int = -1


def _code_char(c: int) -> str:
    return _BASE[c] if c < 4 else "N"


class CallAggregator:
    """The reference's four per-key maps (rkmh.cpp:1818-1830) plus a
    JSON-lines partial format for checkpoint/resume and multi-host
    merging.  Aggregation commutes (count sum, depth maxes), so partial
    sections from disjoint position stripes merge exactly."""

    def __init__(self):
        self.count: dict[str, int] = {}
        self.max_depth: dict[str, int] = {}
        self.avg_depth: dict[str, int] = {}
        self.orig_depth: dict[str, int] = {}

    def record(self, key: str, alt_depth: int, avg_d: int, depth: int):
        self.count[key] = self.count.get(key, 0) + 1
        self.avg_depth[key] = max(avg_d, self.avg_depth.get(key, 0))
        self.orig_depth[key] = max(depth, self.orig_depth.get(key, 0))
        if alt_depth > self.max_depth.get(key, 0):
            self.max_depth[key] = alt_depth

    def merge_entry(self, e: dict):
        k = e["key"]
        self.count[k] = self.count.get(k, 0) + int(e["c"])
        self.max_depth[k] = max(int(e["m"]), self.max_depth.get(k, 0))
        self.avg_depth[k] = max(int(e["a"]), self.avg_depth.get(k, 0))
        self.orig_depth[k] = max(int(e["o"]), self.orig_depth.get(k, 0))

    def dump_lines(self) -> list[str]:
        """One JSON line per key; merge_entry of every line into a fresh
        aggregator reproduces this one exactly."""
        import json

        return [
            json.dumps({
                "key": k, "c": c,
                "m": self.max_depth.get(k, 0),
                "a": self.avg_depth.get(k, 0),
                "o": self.orig_depth.get(k, 0),
            }) + "\n"
            for k, c in self.count.items()
        ]

    def merge_from(self, other: "CallAggregator"):
        for k, c in other.count.items():
            self.merge_entry({
                "key": k, "c": c, "m": other.max_depth.get(k, 0),
                "a": other.avg_depth.get(k, 0),
                "o": other.orig_depth.get(k, 0),
            })

    def emit_vcf_records(self, out):
        for key in sorted(self.count):  # std::map iteration order
            out.write(
                f"{key}\t99\tPASS\tKC={self.count[key]};"
                f"MD={self.max_depth.get(key, 0)};"
                f"RD={self.avg_depth.get(key, 0)};"
                f"OD={self.orig_depth.get(key, 0)}\n"
            )


def vcf_header(ref_file: str) -> str:
    """Header quirks preserved: KD vs KC, RD+OD on one line
    (rkmh.cpp:1740-1747)."""
    return (
        "##fileformat=VCF4.2\n##source=rkmh\n"
        f"##reference={ref_file}\n"
        '##INFO=<ID=KD,Number=1,Type=Integer,Description="Number of times call for specific kmer appears">\n'
        '##INFO=<ID=MD,Number=1,Type=Integer,Description="Maximum depth found for the rescue kmer.">\n'
        '##INFO=<ID=RD,Number=1,Type=Integer,Description="Average depth in region">'
        '##INFO=<ID=OD,Number=1,Type=Integer,Description="Depth of original kmer at site before modification.">\n'
    )


def extract_records(ref_name, codes_row, res, P: int, k: int, record,
                    j_lo: int = 0, j_hi: int | None = None,
                    row_off: int = 0):
    """Walk one (stripe of a) scan result and feed the aggregator.

    res arrays are indexed [j - row_off]; only global positions j in
    [j_lo, min(j_hi, P)) are recorded — dist ranks pass their stripe
    bounds, single-process passes the defaults."""
    j_hi = P if j_hi is None else min(j_hi, P)
    if j_hi <= j_lo:
        return
    row = codes_row
    win = np.lib.stride_tricks.sliding_window_view(row, k)[:P]
    dpad = np.concatenate([np.full(1, 4, np.uint8), row])
    dwin = np.lib.stride_tricks.sliding_window_view(dpad, k + 1)[:P]

    sl = slice(j_lo - row_off, j_hi - row_off)
    depth = res["depth"][sl]
    avg = res["avg"][sl]
    snp_call = res["snp_call"][sl]
    snp_depth = res["snp_depth"][sl]
    del_call = res["del_call"][sl]
    del_depth = res["del_depth"][sl]

    for j, ap, b in zip(*np.nonzero(snp_call)):
        jg = int(j) + j_lo
        orig = _code_char(int(win[jg, ap]))
        alt = _code_char(int(call_engine.ROT[int(win[jg, ap]), b]))
        pos = jg + int(ap) + 1
        key = f"{ref_name}\t{pos}\t.\t{orig}\t{alt}"
        record(key, int(snp_depth[j, ap, b]), int(avg[j]), int(depth[j]))

    for j, api in zip(*np.nonzero(del_call)):
        jg = int(j) + j_lo
        ap = int(api) + 1               # reference loops alt_pos in [1, k]
        orig = _code_char(int(dwin[jg, ap]))
        pos = jg + ap + 1
        key = f"{ref_name}\t{pos}\t.\t{orig}\t-"
        record(key, int(del_depth[j, api]), int(avg[j]), int(depth[j]))


def build_depth_map(reads, ks: tuple, batch_size: int):
    """Exact hash->depth map over every read k-mer occurrence, zeros
    included (rkmh.cpp:1616-1623)."""
    all_h, all_m = [], []
    for rows, codes, lens in bucketed_batches(reads, batch_size):
        hashes, mask = engine.hash_batch_with_mask(codes, lens, ks)
        h_np, m_np = to_host((hashes, mask))
        all_h.append(h_np[: len(rows)])
        all_m.append(m_np[: len(rows)])
    return depth_map_from_hashes(
        np.concatenate([h.ravel() for h in all_h]),
        np.concatenate([m.ravel() for m in all_m]),
    ).device_arrays()


def load_partials(path: str, truncate: bool = False):
    """(complete-ref names in order, merged aggregator) from a partial
    JSON-lines file; sections without a ref_done marker are dropped
    (crash mid-section), and with truncate=True the file is cut back to
    its complete prefix so appended sections parse on the NEXT resume."""
    import json
    import os

    done: list[str] = []
    agg = CallAggregator()
    if not os.path.exists(path):
        return done, agg
    pending: list[dict] = []
    good_end = 0
    pos = 0
    with open(path, "rb") as fh:
        for raw in fh:
            pos += len(raw)
            try:
                e = json.loads(raw)
            except json.JSONDecodeError:
                break  # truncated tail (crash mid-write)
            if "ref_done" in e:
                if e.get("n") != len(pending):
                    break  # inconsistent section; treat as truncated
                for p in pending:
                    agg.merge_entry(p)
                pending = []
                done.append(e["ref_done"])
                good_end = pos
            else:
                pending.append(e)
    if truncate and os.path.getsize(path) != good_end:
        with open(path, "r+b") as fh:
            fh.truncate(good_end)
    return done, agg


def run(cfg: CallConfig, out=None) -> int:
    out = out or sys.stdout
    if cfg.dist_procs or cfg.dist_coordinator or cfg.dist_rank >= 0:
        from rkmh_tpu.commands.dist_stream import run_distributed_call

        return run_distributed_call(cfg, out=None if out is sys.stdout else out)
    from rkmh_tpu.commands.common import resolve_batch_size

    cfg.batch_size = resolve_batch_size(cfg.batch_size)
    if not cfg.ks:
        log("No kmer size(s) provided. Will use a default kmer size of 16.")
        ks = (16,)
    elif len(cfg.ks) > 1:
        log("Only a single kmer size may be used for calling.")
        return 1
    else:
        ks = tuple(cfg.ks)
    k = ks[0]

    if cfg.resume and not cfg.out_file:
        log("call --resume requires -o <file> (resume state is the "
            ".progress sidecar next to it)")
        return 1

    if not cfg.ref_files or not cfg.read_files:
        log("call requires at least one reference and one read file.")
        return 1
    log("Parsing sequences...")
    refs = load_records(cfg.ref_files)
    reads = load_packed(cfg.read_files)
    if not refs or not len(reads):
        log("call requires at least one reference and one read file.")
        return 1

    # read depth map: every k-mer occurrence, zeros included
    # (rkmh.cpp:1616-23).  bucketed_batches pads row counts to powers of
    # two instead of the full batch size — full-batch padding would turn
    # 25 nanopore reads into a 16384x7409 batch (~1 GB of padding hashed
    # and fetched).
    table = build_depth_map(reads, ks, cfg.batch_size)

    if len(refs) > 1:
        log("WARNING: more than one ref provided. VCF will not be correct")

    output_vcf = not cfg.show_depth

    # --resume: per-ref partial aggregates checkpoint into a .progress
    # sidecar; completed refs skip their scan entirely and their
    # sections merge back (aggregation commutes, so the final VCF is
    # byte-identical to an uninterrupted run)
    agg = CallAggregator()
    done_refs: list[str] = []
    progress_fh = None
    if cfg.out_file and output_vcf:
        ppath = f"{cfg.out_file}.progress"
        if cfg.resume:
            done_refs, agg = load_partials(ppath, truncate=True)
            if done_refs:
                log(f"call --resume: {len(done_refs)} reference(s) already "
                    f"scanned in {ppath}")
            progress_fh = open(ppath, "a")
        else:
            progress_fh = open(ppath, "w")

    done_iter = iter(done_refs)
    pending_done = next(done_iter, None)

    # --devices N: the positional scan (depth + windowed average + SNP/DEL
    # enumeration) shards reference positions over a dp mesh
    # (mesh.sharded_call_scan_fn: k-halo code slices, a window_len depth
    # halo via ppermute).  Bit-identical to call_scan_ref; genomes whose
    # per-device span would be shorter than the depth window fall back.
    scan_sharded = None
    if cfg.devices > 1:
        import jax

        n_vis = len(jax.devices())
        if cfg.devices > n_vis:
            log(f"call --devices ignored (--devices {cfg.devices} > {n_vis} "
                "visible device(s)); running single-device")
        else:
            from rkmh_tpu.parallel.mesh import make_mesh, sharded_call_scan_fn

            mesh = make_mesh(jax.devices()[: cfg.devices],
                             dp=cfg.devices, tp=1)
            scan_sharded = sharded_call_scan_fn(mesh, k, cfg.window_len)

    import json

    from rkmh_tpu.commands.recovery import InjectedFailure, fail_after_chunks

    scanned = 0
    for ref in refs:
        if len(ref.seq) < k:
            continue
        if pending_done is not None and pending_done == ref.name:
            pending_done = next(done_iter, None)
            continue  # --resume: this ref's section is already merged
        P = len(ref.seq) - k + 1
        Pl = -(-P // cfg.devices) if scan_sharded is not None else 0
        if scan_sharded is not None and Pl >= cfg.window_len:
            n = cfg.devices
            codes, _ = encode_seqs([ref.seq], pad_to=n * Pl + k)
            padded = np.concatenate(
                [np.full(1, 4, np.uint8), codes[0]])  # row j reaches ref[j-1]
            slices = np.stack([
                padded[d * Pl : d * Pl + Pl + k + 1] for d in range(n)
            ])
            res = scan_sharded(slices, table)
        else:
            if scan_sharded is not None:
                log(f"call --devices: {ref.name} spans only {P} positions "
                    f"(< window {cfg.window_len} per device); single-device")
            L = bucket_length(len(ref.seq))
            codes, _ = encode_seqs([ref.seq], pad_to=L)
            res = call_engine.call_scan_ref(codes[0], table, k, cfg.window_len)
        res = to_host(res)

        if cfg.show_depth:
            depth = res["depth"][:P]
            avg = res["avg"][:P]
            rescue = res["max_rescue"][:P]
            shown = np.where(rescue > 0, rescue, depth)
            for j in range(P):
                out.write(f"{j}\t{avg[j]}\t{depth[j]}\t{shown[j]}\n")
            continue

        ref_agg = CallAggregator()
        extract_records(ref.name, codes[0], res, P, k, ref_agg.record)
        if progress_fh is not None:
            lines = ref_agg.dump_lines()
            progress_fh.writelines(lines)
            progress_fh.write(
                json.dumps({"ref_done": ref.name, "n": len(lines)}) + "\n")
            progress_fh.flush()
        agg.merge_from(ref_agg)
        # fault injection: RKMH_TPU_FAIL_AFTER_CHUNKS here counts
        # scanned refs (the call checkpoint granularity)
        scanned += 1
        if fail_after_chunks() and scanned >= fail_after_chunks():
            raise InjectedFailure(f"injected failure after {scanned} refs")

    if progress_fh is not None:
        progress_fh.close()

    if output_vcf:
        dest = open(cfg.out_file, "w") if cfg.out_file else out
        try:
            dest.write(vcf_header(cfg.ref_files[0]))
            agg.emit_vcf_records(dest)
        finally:
            if cfg.out_file:
                dest.close()
    return 0
