"""rkmh-compatible command line: rkmh-tpu {classify|stream|filter|hash|count|search|call|hpv16}.

Flag names and defaults mirror the reference's getopt tables
(rkmh.cpp:626-647 stream, 1037-1056 filter, 1479-1490 call, 1963-1979
hash, 2148-2156 search, 2284-2290 count, 2392-2405 hpv16) so existing
rkmh invocations work unchanged.  Accelerator knobs (--batch-size,
--counter-size, --devices) are additive.
"""

from __future__ import annotations

import argparse
import sys


def _common_classify_flags(p):
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch-size", type=int, default=1000)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-M", "--min-kmer-occurence", type=int, default=-1, dest="min_kmer_occ")
    p.add_argument("-N", "--min-matches", type=int, default=-1, dest="min_matches")
    p.add_argument("-D", "--min-diff", type=int, default=0, dest="min_diff")
    p.add_argument("-I", "--max-samples", type=int, default=None, dest="max_samples")
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device dispatch; 0 = auto (16384 on an accelerator, 2048 on CPU)")
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads parsed per streaming window (constant-memory input); "
                        "0 = auto (65536)")
    p.add_argument("--counter-size", type=int, default=200_000_000)
    p.add_argument("--ref-sketches", default="",
                   help="load pre-hashed reference sketches from a JSON dump "
                        "(rkmh hash -o schema) instead of hashing -r files; "
                        "implements what rkmh's load_hashes stubs (rkmh.cpp:552-561)")
    # rkmh parses these (rkmh.cpp:639-642, 659-669) but the paths behind
    # them are dead (744-769 commented out); accepted so rkmh argv works.
    # -R is made LIVE as an alias of --ref-sketches (the capability -R was
    # meant to select); -F/-p/-q warn and are ignored, -d was unhandled
    # even by the reference's switch.
    p.add_argument("-R", "--pre-references", default="", dest="pre_references",
                   help="alias of --ref-sketches (rkmh's -R is parsed but dead)")
    p.add_argument("-F", "--pre-reads", action="append", default=[],
                   dest="pre_reads", help=argparse.SUPPRESS)
    p.add_argument("-p", "--read-kmer-map-file", default="",
                   dest="read_kmer_map_file", help=argparse.SUPPRESS)
    p.add_argument("-q", "--ref-kmer-map-file", default="",
                   dest="ref_kmer_map_file", help=argparse.SUPPRESS)
    p.add_argument("-d", action="store_true", dest="dead_d",
                   help=argparse.SUPPRESS)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="rkmh-tpu",
        description="GPU-accelerated MinHash read classification (rkmh capabilities).",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    _orig_add_parser = sub.add_parser

    def _add_parser(*a, **kw):  # every command gets the observability flags
        p = _orig_add_parser(*a, **kw)
        p.add_argument("--metrics", action="store_true",
                       help="emit one JSON metrics line (reads/s, bp/s, timers) to stderr; "
                            "RKMH_TPU_PROFILE=<dir> additionally captures a device trace")
        return p

    sub.add_parser = _add_parser

    for name in ("classify", "stream"):
        p = sub.add_parser(name)
        _common_classify_flags(p)
        p.add_argument("-S", "--ref-sketch", type=int, default=None,
                       help="parsed for parity; unused by the reference too (rkmh.cpp:697-700)")
        p.add_argument("-i", "--in-stream", action="store_true", dest="in_stream")
        p.add_argument("-z", "--output-reads", action="store_true")
        p.add_argument("-m", "--merge-sketch", action="store_true")
        p.add_argument("-o", "--output", default="", dest="out_file",
                       help="write classification lines here instead of stdout")
        p.add_argument("--resume", action="store_true",
                       help="continue an interrupted -o run: skip reads whose "
                            "lines already landed, append the rest (idempotent)")
        p.add_argument("--devices", type=int, default=0,
                       help="classify as one SPMD program over N local "
                            "devices (reads data-parallel); 0 = single device")
        p.add_argument("--tp", type=int, default=1,
                       help="shard the reference panel over this many of the "
                            "--devices (devices = dp x tp); counts merge with "
                            "an all_gather, output stays byte-identical")
        p.add_argument("--dist-coordinator", default="", dest="dist_coordinator",
                       help="multi-host: coordinator host:port (every host "
                            "runs the same command; see also "
                            "JAX_COORDINATOR_ADDRESS)")
        p.add_argument("--dist-procs", type=int, default=0, dest="dist_procs",
                       help="multi-host: total process count")
        p.add_argument("--dist-rank", type=int, default=-1, dest="dist_rank",
                       help="multi-host: this process's id (0-based); each "
                            "rank writes <out>.<rank>, merge with "
                            "rkmh-tpu-dist-merge")

    p = sub.add_parser("filter")
    _common_classify_flags(p)
    p.set_defaults(counter_size=10_000_000)  # rkmh.cpp:1187-1188
    p.add_argument("-S", "--ref-sketch", type=int, default=None)
    p.add_argument("-i", "--in-stream", action="store_true", dest="in_stream")
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write passing records here instead of stdout "
                        "(maintains a .progress sidecar for --resume)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted -o run from its .progress "
                        "sidecar: truncate the torn tail, skip the reads "
                        "already covered, append the rest (idempotent)")
    p.add_argument("--devices", type=int, default=0,
                   help="classify as one SPMD program over N local "
                        "devices (reads data-parallel); 0 = single device")
    p.add_argument("--tp", type=int, default=1,
                   help="shard the reference panel over this many of the "
                        "--devices (devices = dp x tp); counts merge with "
                        "an all_gather, output stays byte-identical")
    p.add_argument("--dist-coordinator", default="", dest="dist_coordinator",
                   help="multi-host: coordinator host:port")
    p.add_argument("--dist-procs", type=int, default=0, dest="dist_procs",
                   help="multi-host: total process count")
    p.add_argument("--dist-rank", type=int, default=-1, dest="dist_rank",
                   help="multi-host: this process's id; each rank writes "
                        "<out>.<rank> (+ .idx), merge with "
                        "rkmh-tpu-dist-merge")

    p = sub.add_parser("hash")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch-size", type=int, default=0)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-K", "--output-kmers", action="store_true")
    p.add_argument("-w", "--wabbitize", action="store_true")
    p.add_argument("-c", "--count", action="store_true", dest="output_counts")
    p.add_argument("-M", "--min-kmer-occurence", type=int, default=0, dest="min_kmer_occ")
    p.add_argument("-I", "--max-samples", type=int, default=None, dest="max_samples")
    p.add_argument("-m", "--merge-sample", action="store_true", dest="merge_sample",
                   help=argparse.SUPPRESS)  # parsed but dead in rkmh (2040-2111)
    p.add_argument("-T", action="store_true", dest="traditional_minhash",
                   help=argparse.SUPPRESS)  # parsed but dead in rkmh
    p.add_argument("-o", "--out-prefix", default="")
    p.add_argument("--json", action="store_true", help="emit Mash/sourmash-style JSON sketches")
    p.add_argument("--sourmash", action="store_true",
                   help="emit sourmash_signature JSON (sourmash's on-disk "
                        ".sig format; single -k sketches only)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device dispatch; 0 = auto (16384 on an accelerator, 2048 on CPU)")
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads parsed per streaming window; 0 = auto (65536)")
    p.add_argument("--devices", type=int, default=0,
                   help="dp-shard hashing over N local devices; 0 = single")
    p.add_argument("--out", default="", dest="out_file",
                   help="write hash/sketch lines here (per-rank stripes "
                        "with --dist-*; -o stays the JSON prefix)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted --out run (dist: batch "
                        "watermark, see stream --resume)")
    p.add_argument("--dist-coordinator", default="", dest="dist_coordinator",
                   help="multi-host: coordinator host:port")
    p.add_argument("--dist-procs", type=int, default=0, dest="dist_procs",
                   help="multi-host: total process count")
    p.add_argument("--dist-rank", type=int, default=-1, dest="dist_rank",
                   help="multi-host: this process's id; each rank writes "
                        "<out>.<rank>, merge with rkmh-tpu-dist-merge")

    p = sub.add_parser("count")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--counter-size", type=int, default=640_000)  # rkmh.cpp:2322
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device dispatch; 0 = auto (16384 on an accelerator, 2048 on CPU)")
    p.add_argument("-o", "--out-file", default="", help="save counter table (npz)")
    p.add_argument("--dump", action="store_true", help="print occupied slots")
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads parsed per streaming window; 0 = auto (65536)")
    p.add_argument("--devices", type=int, default=0,
                   help="dp-shard hashing over N local devices; 0 = single")
    p.add_argument("--dist-coordinator", default="", dest="dist_coordinator",
                   help="multi-host: coordinator host:port")
    p.add_argument("--dist-procs", type=int, default=0, dest="dist_procs",
                   help="multi-host: total process count")
    p.add_argument("--dist-rank", type=int, default=-1, dest="dist_rank",
                   help="multi-host: this process's id; the global counter "
                        "table spans hosts, rank 0 emits")

    p = sub.add_parser("search")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device dispatch; 0 = auto (16384 on an accelerator, 2048 on CPU)")
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads parsed per streaming window; 0 = auto (65536)")
    p.add_argument("--devices", type=int, default=0,
                   help="dp-shard hashing over N local devices; 0 = single")
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write match lines here (per-rank stripes with "
                        "--dist-*)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted dist -o run (idx batch "
                        "checkpoint, see filter --resume)")
    p.add_argument("--dist-coordinator", default="", dest="dist_coordinator",
                   help="multi-host: coordinator host:port")
    p.add_argument("--dist-procs", type=int, default=0, dest="dist_procs",
                   help="multi-host: total process count")
    p.add_argument("--dist-rank", type=int, default=-1, dest="dist_rank",
                   help="multi-host: this process's id; each rank writes "
                        "<out>.<rank> + .idx, merge with rkmh-tpu-dist-merge")

    p = sub.add_parser("call")
    p.add_argument("-r", "--reference", action="append", default=[], dest="refs")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch", type=int, default=1000)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-w", "--window-len", type=int, default=100)
    p.add_argument("-d", "--show-depth", action="store_true")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the positional scan over N local devices "
                        "(reference positions data-parallel); 0 = single")
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write the VCF here (required for --resume / --dist-*)")
    p.add_argument("--resume", action="store_true",
                   help="skip references whose partial aggregates are "
                        "already checkpointed in <out>.progress")
    p.add_argument("--dist-coordinator", default="",
                   help="host:port of rank 0 (multi-host positional scan)")
    p.add_argument("--dist-procs", type=int, default=0)
    p.add_argument("--dist-rank", type=int, default=-1)

    p = sub.add_parser("hpv16")
    p.add_argument("-f", "--fasta", action="append", default=[], dest="reads")
    p.add_argument("-R", "--refpath", default="data")
    p.add_argument("-k", "--kmer", action="append", type=int, default=[], dest="ks")
    p.add_argument("-s", "--sketch", type=int, default=4000)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-M", "--min-kmer-occurence", type=int, default=0, dest="min_kmer_occ")
    p.add_argument("-N", "--min-matches", type=int, default=-1, dest="min_matches")
    p.add_argument("-D", "--min-diff", type=int, default=0, dest="min_diff")
    p.add_argument("--counter-size", type=int, default=800_000_000)  # rkmh.cpp:2516
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device dispatch; 0 = auto")
    p.add_argument("--chunk-reads", type=int, default=0,
                   help="reads parsed per streaming window; 0 = auto (65536)")
    p.add_argument("-o", "--output", default="", dest="out_file",
                   help="write classification lines here instead of stdout")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted -o run: skip reads whose "
                        "lines already landed, append the rest (idempotent)")
    p.add_argument("--devices", type=int, default=0,
                   help="classify reads data-parallel over N local devices "
                        "(set tables replicated); 0 = single device")
    p.add_argument("--tp", type=int, default=1,
                   help="shard the 182-genome type set table over this many "
                        "of the --devices (devices = dp x tp); distinct "
                        "counts merge with an all_gather, output stays "
                        "byte-identical")
    p.add_argument("--dist-coordinator", default="", dest="dist_coordinator",
                   help="multi-host: coordinator host:port")
    p.add_argument("--dist-procs", type=int, default=0, dest="dist_procs",
                   help="multi-host: total process count")
    p.add_argument("--dist-rank", type=int, default=-1, dest="dist_rank",
                   help="multi-host: this process's id; each rank writes "
                        "<out>.<rank>, merge with rkmh-tpu-dist-merge")

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from rkmh_tpu.observability import observed_run

    try:
        with observed_run(args.command, enabled=getattr(args, "metrics", False) or None):
            return _dispatch(args)
    except (FileNotFoundError, IsADirectoryError, PermissionError) as e:
        # bad input paths exit cleanly like the reference's exit(1)
        # (rkmh.cpp:1585-1594), not with a traceback
        print(f"rkmh-tpu {args.command}: {e.strerror}: {e.filename}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # e.g. `rkmh-tpu ... | head`


def _resolve_dead_classify_flags(args):
    """rkmh-parity flags shared by stream/filter: -R becomes live
    (pre-hashed references), -F/-p/-q warn like the other dead flags."""
    if args.pre_references:
        if args.ref_sketches:
            print("warning: both -R and --ref-sketches given; using "
                  "--ref-sketches.", file=sys.stderr)
        else:
            args.ref_sketches = args.pre_references
    for val, name in ((args.pre_reads, "-F"),
                      (args.read_kmer_map_file, "-p"),
                      (args.ref_kmer_map_file, "-q")):
        if val:
            print(f"warning: {name} is parsed but dead in rkmh too "
                  f"(rkmh.cpp:744-769 commented out); ignored.",
                  file=sys.stderr)


def _dispatch(args) -> int:
    if args.command in ("classify", "stream"):
        if args.command == "classify":
            print("classify is an alias of stream in rkmh; running stream.", file=sys.stderr)
        for flag, name in (("output_reads", "-z"), ("merge_sketch", "-m")):
            if getattr(args, flag, False):
                print(
                    f"warning: stream {name} is parsed but dead in rkmh too "
                    f"(rkmh.cpp:608-714); ignored.",
                    file=sys.stderr,
                )
        _resolve_dead_classify_flags(args)
        from rkmh_tpu.commands.stream import StreamConfig, run

        return run(
            StreamConfig(
                ref_files=args.refs,
                read_files=args.reads,
                ks=tuple(args.ks),
                sketch_size=args.sketch_size,
                min_kmer_occ=args.min_kmer_occ,
                min_matches=args.min_matches,
                min_diff=args.min_diff,
                max_samples=args.max_samples,
                counter_size=args.counter_size,
                batch_size=args.batch_size,
                ref_sketches=args.ref_sketches,
                chunk_reads=args.chunk_reads,
                out_file=args.out_file,
                resume=args.resume,
                in_stream=args.in_stream,
                devices=args.devices,
                tp=args.tp,
                dist_coordinator=args.dist_coordinator,
                dist_procs=args.dist_procs,
                dist_rank=args.dist_rank,
            )
        )
    if args.command == "filter":
        _resolve_dead_classify_flags(args)
        from rkmh_tpu.commands.filter_cmd import FilterConfig, run

        return run(
            FilterConfig(
                ref_files=args.refs,
                read_files=args.reads,
                ks=tuple(args.ks),
                sketch_size=args.sketch_size,
                min_kmer_occ=args.min_kmer_occ,
                min_matches=args.min_matches,
                min_diff=args.min_diff,
                max_samples=args.max_samples,
                in_stream=args.in_stream,
                counter_size=args.counter_size,
                batch_size=args.batch_size,
                ref_sketches=args.ref_sketches,
                chunk_reads=args.chunk_reads,
                out_file=args.out_file,
                resume=args.resume,
                devices=args.devices,
                tp=args.tp,
                dist_coordinator=args.dist_coordinator,
                dist_procs=args.dist_procs,
                dist_rank=args.dist_rank,
            )
        )
    if args.command == "hash":
        if args.min_kmer_occ or args.max_samples is not None:
            print(
                "warning: hash -M/-I are dead in rkmh (empty branch, "
                "rkmh.cpp:2109-2111); use stream/filter for depth filters.",
                file=sys.stderr,
            )
        for flag, name in (("merge_sample", "-m"), ("traditional_minhash", "-T")):
            if getattr(args, flag, False):
                print(f"warning: hash {name} is parsed but dead in rkmh too "
                      f"(rkmh.cpp:2040-2111); ignored.", file=sys.stderr)
        from rkmh_tpu.commands.hash_cmd import HashConfig, run

        return run(
            HashConfig(
                read_files=args.reads + args.refs,
                ks=tuple(args.ks),
                sketch_size=args.sketch_size,
                output_kmers=args.output_kmers,
                wabbitize=args.wabbitize,
                output_counts=args.output_counts,
                json_out=args.json,
                sourmash_out=args.sourmash,
                out_prefix=args.out_prefix,
                batch_size=args.batch_size,
                chunk_reads=args.chunk_reads,
                devices=args.devices,
                out_file=args.out_file,
                resume=args.resume,
                dist_coordinator=args.dist_coordinator,
                dist_procs=args.dist_procs,
                dist_rank=args.dist_rank,
            )
        )
    if args.command == "count":
        from rkmh_tpu.commands.count_cmd import CountConfig, run

        return run(
            CountConfig(
                read_files=args.reads,
                ks=tuple(args.ks),
                counter_size=args.counter_size,
                batch_size=args.batch_size,
                out_file=args.out_file,
                dump=args.dump,
                chunk_reads=args.chunk_reads,
                devices=args.devices,
                dist_coordinator=args.dist_coordinator,
                dist_procs=args.dist_procs,
                dist_rank=args.dist_rank,
            )
        )
    if args.command == "search":
        from rkmh_tpu.commands.search_cmd import SearchConfig, run

        return run(
            SearchConfig(ref_files=args.refs, read_files=args.reads,
                         ks=tuple(args.ks), batch_size=args.batch_size,
                         chunk_reads=args.chunk_reads,
                         devices=args.devices, out_file=args.out_file,
                         resume=args.resume,
                         dist_coordinator=args.dist_coordinator,
                         dist_procs=args.dist_procs,
                         dist_rank=args.dist_rank)
        )
    if args.command == "call":
        from rkmh_tpu.commands.call_cmd import CallConfig, run

        return run(
            CallConfig(
                ref_files=args.refs,
                read_files=args.reads,
                ks=tuple(args.ks),
                window_len=args.window_len,
                show_depth=args.show_depth,
                devices=args.devices,
                out_file=args.out_file,
                resume=args.resume,
                dist_coordinator=args.dist_coordinator,
                dist_procs=args.dist_procs,
                dist_rank=args.dist_rank,
            )
        )
    if args.command == "hpv16":
        if args.min_matches != -1 or args.min_diff:
            print("warning: hpv16 -N/-D are parsed but dead in rkmh too "
                  "(declared rkmh.cpp:2371-2372, never read); ignored.",
                  file=sys.stderr)
        from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

        return run(
            Hpv16Config(
                read_files=args.reads,
                refpath=args.refpath,
                ks=tuple(args.ks),
                sketch_size=args.sketch,
                min_kmer_occ=args.min_kmer_occ,
                counter_size=args.counter_size,
                batch_size=args.batch_size,
                chunk_reads=args.chunk_reads,
                out_file=args.out_file,
                resume=args.resume,
                devices=args.devices,
                tp=args.tp,
                dist_coordinator=args.dist_coordinator,
                dist_procs=args.dist_procs,
                dist_rank=args.dist_rank,
            )
        )
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
