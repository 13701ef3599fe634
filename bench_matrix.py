"""Benchmark matrix: all five canonical BASELINE.md configs, end to end.

Unlike bench.py (the driver's single headline metric: steady-state
classify throughput), this measures whole-command wall time — parse,
panel build, classify, output — for each canonical config, twice each
(the second run reuses the persistent compile cache; report the best).
One JSON line per config.

Rows print AS EACH CONFIG COMPLETES (a timed-out run still yields every
finished row), and section names as argv select a subset:

Run: python bench_matrix.py [zika hpv16 filter streamMI sustained hash call]
     JAX_PLATFORMS=cpu python bench_matrix.py
"""

import io
import json
import sys
import time

DATA = "/root/reference/data"


def timed(fn, repeats=2):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import rkmh_tpu  # noqa: F401
    import jax

    platform = jax.devices()[0].platform

    from rkmh_tpu.commands.stream import StreamConfig, run as stream_run
    from rkmh_tpu.commands.filter_cmd import FilterConfig, run as filter_run
    from rkmh_tpu.commands.call_cmd import CallConfig, run as call_run
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run as hpv16_run

    only = set(sys.argv[1:])

    def want(section):
        return not only or section in only

    def record(config, seconds, reads, note=""):
        print(json.dumps({
            "config": config,
            "seconds": round(seconds, 3),
            "reads_per_sec": round(reads / seconds, 1) if seconds else None,
            "platform": platform,
            **({"note": note} if note else {}),
        }), flush=True)

    # 1. zika classify (BASELINE config 1)
    if want("zika"):
        dt = timed(lambda: stream_run(
            StreamConfig(ref_files=[f"{DATA}/zika.refs.fa"],
                         read_files=[f"{DATA}/z1.fq"], ks=(12,),
                         sketch_size=1000),
            out=io.StringIO()))
        record("classify zika k=12 s=1000 (60 refs x 1000 reads)", dt, 1000)

    # 2. hpv16 k=18 s=4000 on real minION reads (BASELINE config 2)
    import os, tempfile
    if want("hpv16"):
        with tempfile.TemporaryDirectory() as td:
            cwd = os.getcwd()
            os.chdir(td)  # the .tst side-effect file lands here
            try:
                dt = timed(lambda: hpv16_run(
                    Hpv16Config(read_files=[f"{DATA}/minION25.fq"],
                                refpath=DATA,
                                ks=(18,), sketch_size=4000),
                    out=io.StringIO()))
            finally:
                os.chdir(cwd)
        record("hpv16 k=18 s=4000 (182-type panel, 25 minION reads)", dt, 25)

    # 3. filter on minION25.fq (BASELINE config 3)
    if want("filter"):
        dt = timed(lambda: filter_run(
            FilterConfig(ref_files=[f"{DATA}/hpv_16.fa"],
                         read_files=[f"{DATA}/minION25.fq"], ks=(16,),
                         sketch_size=1000, min_matches=25), out=io.StringIO()))
        record("filter minION25 vs hpv_16.fa k=16 N=25", dt, 25)

    # 4. stream -M/-I constant-memory counters (BASELINE config 4)
    if want("streamMI"):
        dt = timed(lambda: stream_run(
            StreamConfig(ref_files=[f"{DATA}/zika.refs.fa"],
                         read_files=[f"{DATA}/z1.fq"], ks=(12,),
                         sketch_size=1000,
                         min_kmer_occ=2, max_samples=40,
                         counter_size=1 << 22),
            out=io.StringIO()))
        record("stream -M 2 -I 40 zika k=12 s=1000", dt, 1000)

    # 2b. hpv16 sustained: minION25 tiled 128x (3200 reads, ~14.3 Mbp) —
    # the 25-read config above is fixed-overhead-dominated; this one
    # measures steady-state Mbp/s (poster baseline: 1.5 Mbp/s classify).
    # First-ever run compiles several batch-shape programs (cached
    # thereafter).
    if want("sustained"):
        tile = 512 if platform != "cpu" else 8
        with tempfile.NamedTemporaryFile("w", suffix=".fq",
                                         delete=False) as tf:
            src = open(f"{DATA}/minION25.fq").read()
            for _ in range(tile):
                tf.write(src)
            tiled = tf.name
        bp = sum(len(l.strip()) for i, l in enumerate(open(tiled))
                 if i % 4 == 1)
        try:
            with tempfile.TemporaryDirectory() as td:
                cwd = os.getcwd()
                os.chdir(td)
                try:
                    dt = timed(lambda: hpv16_run(
                        Hpv16Config(read_files=[tiled], refpath=DATA,
                                    ks=(18,), sketch_size=4000),
                        out=io.StringIO()))
                finally:
                    os.chdir(cwd)
        finally:
            os.unlink(tiled)
        print(json.dumps({
            "config": f"hpv16 sustained k=18 s=4000 ({25 * tile} minION reads)",
            "seconds": round(dt, 3),
            "mbp_per_sec": round(bp / dt / 1e6, 1),
            "platform": platform,
            "note": "poster claims 1.5 Mbp/s sustained classify",
        }), flush=True)

    # 6. hash throughput, sustained (reference publishes >400 reads/s,
    # 2.5 Mbp/s hashing on this data, README.md:148): minION25 tiled so
    # the measurement is not one RTT-bound 25-read dispatch
    from rkmh_tpu.commands.hash_cmd import HashConfig, run as hash_run
    if want("hash"):
        htile = 32 if platform != "cpu" else 4
        mbp = sum(len(l.strip()) for i, l in
                  enumerate(open(f"{DATA}/minION25.fq")) if i % 4 == 1) / 1e6
        with tempfile.NamedTemporaryFile("w", suffix=".fq",
                                         delete=False) as tf:
            src = open(f"{DATA}/minION25.fq").read()
            for _ in range(htile):
                tf.write(src)
            htiled = tf.name
        try:
            dt = timed(lambda: hash_run(
                HashConfig(read_files=[htiled], ks=(16,)), out=io.StringIO()))
        finally:
            os.unlink(htiled)
        print(json.dumps({
            "config": f"hash {25 * htile} minION reads k=16 (full hash dump)",
            "seconds": round(dt, 3),
            "reads_per_sec": round(25 * htile / dt, 1),
            "mbp_per_sec": round(mbp * htile / dt, 1),
            "platform": platform,
            "note": "ref claims >400 reads/s, 2.5 Mbp/s (README.md:148); "
                    "the full dump moves ~8 B/bp of hashes device->host",
        }), flush=True)

    # 5. call on hpv_16.fa + minION reads (BASELINE config 5)
    if want("call"):
        dt = timed(lambda: call_run(
            CallConfig(ref_files=[f"{DATA}/hpv_16.fa"],
                       read_files=[f"{DATA}/minION25.fq"], ks=(16,),
                       window_len=100), out=io.StringIO()))
        record("call hpv_16.fa + 25 minION reads k=16 w=100", dt, 25,
               note="ref claims ~10s/1100 reads (README.md:111)")


if __name__ == "__main__":
    main()
